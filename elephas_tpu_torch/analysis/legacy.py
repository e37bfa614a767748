"""The eight lint domains over the port's tree (counterpart of
``elephas_tpu/analysis/legacy.py``).

The functional API (``lint_file``/``lint_package``/``lint_pickle_*``/
``lint_resilience_*``/``lint_metric_*``/``lint_kind_*``/
``lint_route_*``/``lint_pool_*`` + the vocab loaders and
:class:`Violation`) is the reference's. Every scanner internally reports
pragma-escaped hits too, so the registry's dead-pragma rule can audit
escapes, and the :class:`~elephas_tpu_torch.analysis.core.Rule`
adapters at the bottom expose each domain to the shared CLI.

Rule semantics (see each scanner's docstring):

1.  host-sync      — no blocking device→host conversions in serving/
                     outside ``host_sync.py`` (``# host-ok``): ``int(``,
                     ``float(``, ``.item``, ``.tolist``, ``np.asarray``,
                     ``np.array``, and torch's syncs ``.cpu``,
                     ``.numpy``, ``.synchronize`` (``torch.cuda.
                     synchronize`` and a stream's or event's) in place
                     of JAX's ``block_until_ready``/``device_get``
2.  serving-clock  — no raw ``time.*()`` calls in serving/ (same pragma)
3.  ps-pickle      — no pickle outside ``parameter/wire.py``
                     (``# pickle-ok``)
4.  resilience-clock — no raw clock/sleep calls in resilience/
                     (``# clock-ok``)
5.  metric-naming  — counters end ``_total``, histograms ``_seconds``,
                     no f-string names (``# metric-ok``)
6.  kind-vocab     — flight kinds / alert rule names from the
                     registered tables (``# kind-ok``)
7.  route-vocab    — opsd routes from ``obs.opsd.ROUTES``
                     (``# route-ok``)
8.  pool-boundary  — no rebinding of the tensors the captured decode
                     graph holds, outside ``kv_pool.py`` (``# pool-ok``)

The port has no donation, so the reference's ``._cache``/``._pad``
boundary has no counterpart. What the port's pool must keep private is
the ADDRESS of every tensor its captured CUDA graphs read: the K/V
lists and column vector of ``pool.cache`` (``keys``, ``values``,
``index``), ``pool.pad``, and the paged block table's ``buffer`` (and
the ``cache``/``table`` objects that hold them). Reading them, or
writing into them in place, is how the engine works; ASSIGNING one of
those attributes outside ``kv_pool.py`` rebinds a tensor the graph
will never read, so the next replay computes on stale state with no
error. The rule flags every store to (or ``del`` of) an attribute of
that name in serving/ outside the pool module.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, NamedTuple, Optional, Tuple

from elephas_tpu_torch.analysis.core import (PACKAGE, ROOT_SCRIPTS,
                                             SCRIPTS_PREFIX, Finding, Repo,
                                             Rule)

PRAGMA = "host-ok"
SANCTIONED = "host_sync.py"
PICKLE_PRAGMA = "pickle-ok"
PICKLE_SANCTIONED = "wire.py"
CLOCK_PRAGMA = "clock-ok"
METRIC_PRAGMA = "metric-ok"
KIND_PRAGMA = "kind-ok"
ROUTE_PRAGMA = "route-ok"
POOL_PRAGMA = "pool-ok"
POOL_SANCTIONED = "kv_pool.py"
#: The pool attributes whose tensors the captured decode graph holds.
_POOL_GRAPH_HELD = ("cache", "pad", "table", "buffer", "keys", "values",
                    "index")
_NUMPY_NAMES = ("np", "numpy")
#: attribute calls that read a device value on the host or wait for the
#: device: ``.item()``/``.tolist()`` as in the reference, and torch's
#: ``.cpu()``/``.numpy()``/``.synchronize()`` in place of JAX's
#: ``block_until_ready``/``device_get``.
_SYNC_ATTRS = ("item", "tolist", "cpu", "numpy", "synchronize")
_CLOCK_ATTRS = ("time", "perf_counter", "monotonic")
_PICKLE_ATTRS = ("dumps", "loads", "dump", "load")
_METRIC_SUFFIX = {"counter": "_total", "histogram": "_seconds"}


class Violation(NamedTuple):
    path: str
    lineno: int
    call: str
    line: str
    domain: str = "serving"

    def __str__(self):
        if self.domain == "route":
            return (
                f"{self.path}:{self.lineno}: unregistered route "
                f"{self.call} — opsd routes come from obs.opsd.ROUTES "
                f"(grow the table so /meta, 404 bodies, and the fleet "
                f"poller stay in sync; `# {ROUTE_PRAGMA}` for test-local "
                f"throwaway routes)\n    {self.line.strip()}"
            )
        if self.domain == "kind":
            return (
                f"{self.path}:{self.lineno}: unregistered {self.call} — "
                f"FlightRecorder kinds come from obs.flight.KINDS and "
                f"alert rule names from obs.alerts.RULE_NAMES (grow the "
                f"table, never invent the string inline; `# {KIND_PRAGMA}` "
                f"for deliberate local vocab)\n    {self.line.strip()}"
            )
        if self.domain == "metric":
            return (
                f"{self.path}:{self.lineno}: metric name {self.call} "
                f"violates naming (counters end `_total`, histograms end "
                f"`_seconds`; an f-string name bakes a dimension into it — "
                f"use labelnames=; `# {METRIC_PRAGMA}` for deliberate "
                f"foreign names)\n    {self.line.strip()}"
            )
        if self.domain == "pool":
            return (
                f"{self.path}:{self.lineno}: graph-held pool tensor "
                f"{self.call} rebound outside kv_pool.py — the captured "
                f"decode graph keeps reading the old address (write in "
                f"place with copy_, or go through `pool.swap()`; "
                f"`# {POOL_PRAGMA}` only for an object that is not the "
                f"pool's)\n    {self.line.strip()}"
            )
        if self.domain == "resilience":
            what = "raw sleep" if self.call == "time.sleep" \
                else "raw clock call"
            return (
                f"{self.path}:{self.lineno}: {what} `{self.call}` in "
                f"resilience code bypasses the injected clock/sleep hooks "
                f"(thread a `clock=`/`sleep=` parameter so chaos tests run "
                f"on fake time; `# {CLOCK_PRAGMA}` only for timing outside "
                f"every detector/injector path)\n    {self.line.strip()}"
            )
        if self.call.startswith("pickle."):
            return (
                f"{self.path}:{self.lineno}: direct `{self.call}` outside "
                f"wire.py reintroduces per-request pickling on the PS hot "
                f"path (route through wire.encode_pickle/decode_pickle; "
                f"`# {PICKLE_PRAGMA}` only for data that never crosses the "
                f"wire)\n    {self.line.strip()}"
            )
        if self.call.startswith("time."):
            return (
                f"{self.path}:{self.lineno}: raw clock call `{self.call}` "
                f"bypasses the injected serving clock (read `self.clock()`; "
                f"`# {PRAGMA}` only for timing outside the scheduled path)"
                f"\n    {self.line.strip()}"
            )
        return (
            f"{self.path}:{self.lineno}: blocking host sync `{self.call}` "
            f"outside host_sync.py (add `# {PRAGMA}` only if the value "
            f"never touched the device)\n    {self.line.strip()}"
        )


# Internally every scanner returns (violation, suppressed) pairs; the
# public lint_* functions keep the historical unsuppressed-only shape.
_Scanned = List[Tuple[Violation, bool]]


def _unsuppressed(pairs: _Scanned) -> List[Violation]:
    return [v for v, suppressed in pairs if not suppressed]


def _call_name(node: ast.Call) -> str | None:
    """The lint-relevant name of a call, or None if it's not watched."""
    fn = node.func
    if isinstance(fn, ast.Name) and fn.id in ("int", "float"):
        return fn.id
    if isinstance(fn, ast.Attribute):
        if fn.attr in _SYNC_ATTRS:
            return f".{fn.attr}"
        if fn.attr in ("asarray", "array") and isinstance(fn.value, ast.Name) \
                and fn.value.id in _NUMPY_NAMES:
            return f"{fn.value.id}.{fn.attr}"
        if fn.attr in _CLOCK_ATTRS and isinstance(fn.value, ast.Name) \
                and fn.value.id == "time":
            return f"time.{fn.attr}"
    return None


def _scan_serving(path: Path) -> _Scanned:
    source = path.read_text()
    lines = source.splitlines()
    tree = ast.parse(source, filename=str(path))
    out: _Scanned = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name is None:
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        out.append((Violation(str(path), node.lineno, name, line),
                    PRAGMA in line))
    return out


def lint_file(path: Path) -> List[Violation]:
    return _unsuppressed(_scan_serving(path))


def lint_package(root: Path) -> List[Violation]:
    """Lint every module in the serving package — recursively, so
    subpackages (``serving/fleet/``) inherit the blocking-read and
    clock-call bans — except the sanctioned sync point itself."""
    out = []
    for path in sorted(root.rglob("*.py")):
        if path.name == SANCTIONED:
            continue
        out.extend(lint_file(path))
    return out


def _pickle_call_name(node: ast.Call) -> str | None:
    """``pickle.dumps``-style attribute calls; bare ``loads(...)`` from a
    ``from pickle import loads`` is caught too (module-qualified name is
    synthesized so the message stays uniform)."""
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in _PICKLE_ATTRS \
            and isinstance(fn.value, ast.Name) \
            and fn.value.id in ("pickle", "cPickle"):
        return f"pickle.{fn.attr}"
    return None


def _scan_pickle(path: Path) -> _Scanned:
    source = path.read_text()
    lines = source.splitlines()
    tree = ast.parse(source, filename=str(path))
    imported = set()  # names bound by `from pickle import dumps as d`
    out: _Scanned = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "pickle":
            for alias in node.names:
                if alias.name in _PICKLE_ATTRS:
                    imported.add(alias.asname or alias.name)
        if not isinstance(node, ast.Call):
            continue
        name = _pickle_call_name(node)
        if name is None and isinstance(node.func, ast.Name) \
                and node.func.id in imported:
            name = f"pickle.{node.func.id}"
        if name is None:
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        out.append((Violation(str(path), node.lineno, name, line),
                    PICKLE_PRAGMA in line))
    return out


def lint_pickle_file(path: Path) -> List[Violation]:
    return _unsuppressed(_scan_pickle(path))


def lint_pickle_package(root: Path) -> List[Violation]:
    """Lint every module in the parameter package except the sanctioned
    codec home itself."""
    out = []
    for path in sorted(root.glob("*.py")):
        if path.name == PICKLE_SANCTIONED:
            continue
        out.extend(lint_pickle_file(path))
    return out


def _resilience_call_name(node: ast.Call) -> str | None:
    """``time.<clock>()`` AND ``time.sleep()`` — the resilience domain
    bans both (everything there takes ``clock=``/``sleep=`` hooks)."""
    fn = node.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name) \
            and fn.value.id == "time" \
            and fn.attr in _CLOCK_ATTRS + ("sleep",):
        return f"time.{fn.attr}"
    return None


def _scan_resilience(path: Path) -> _Scanned:
    source = path.read_text()
    lines = source.splitlines()
    tree = ast.parse(source, filename=str(path))
    out: _Scanned = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _resilience_call_name(node)
        if name is None:
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        out.append((Violation(str(path), node.lineno, name, line,
                              domain="resilience"), CLOCK_PRAGMA in line))
    return out


def lint_resilience_file(path: Path) -> List[Violation]:
    return _unsuppressed(_scan_resilience(path))


def lint_resilience_package(root: Path) -> List[Violation]:
    """Lint every module in the resilience package — no sanctioned file:
    real wall time enters ONLY through default-argument values."""
    out = []
    for path in sorted(root.glob("*.py")):
        out.extend(lint_resilience_file(path))
    return out


def _metric_call_name(node: ast.Call) -> str | None:
    """``<anything>.counter("…")`` / ``.histogram("…")`` with a judgeable
    first argument: a string literal that breaks the suffix convention,
    or any f-string (a baked dimension). Variable names pass — their
    literal is linted where it's defined."""
    fn = node.func
    if not (isinstance(fn, ast.Attribute) and fn.attr in _METRIC_SUFFIX
            and node.args):
        return None
    arg = node.args[0]
    if isinstance(arg, ast.JoinedStr):
        return f"<f-string> in .{fn.attr}()"
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
            and not arg.value.endswith(_METRIC_SUFFIX[fn.attr]):
        return f"`{arg.value}` in .{fn.attr}()"
    return None


def _scan_metric(path: Path) -> _Scanned:
    source = path.read_text()
    lines = source.splitlines()
    tree = ast.parse(source, filename=str(path))
    out: _Scanned = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _metric_call_name(node)
        if name is None:
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        out.append((Violation(str(path), node.lineno, name, line,
                              domain="metric"), METRIC_PRAGMA in line))
    return out


def lint_metric_file(path: Path) -> List[Violation]:
    return _unsuppressed(_scan_metric(path))


def lint_metric_package(root: Path) -> List[Violation]:
    """Lint EVERY module of the package tree — metric names are a
    process-global namespace, so no file is exempt."""
    out = []
    for path in sorted(root.rglob("*.py")):
        out.extend(lint_metric_file(path))
    return out


def port_scripts(repo_root: Path) -> Tuple[Path, ...]:
    """The port's harness files: ``scripts/torch_*.py`` and the
    repo-root scripts (``chip_smoke.py``) — ``Repo.scripts_files``'s
    scope, for the functional API's ``extra_roots``."""
    found = sorted((repo_root / "scripts").glob(f"{SCRIPTS_PREFIX}*.py"))
    found += [repo_root / name for name in ROOT_SCRIPTS
              if (repo_root / name).is_file()]
    return tuple(found)


def _extra_paths(root: Path) -> List[Path]:
    """An ``extra_roots`` entry: a directory's ``*.py``, or one file."""
    return [root] if root.is_file() else sorted(root.glob("*.py"))


def load_registered_vocab(pkg_root: Path):
    """``(KINDS, RULE_NAMES)`` read straight from the defining modules'
    ASTs — pure-literal tuples by construction, so ``literal_eval``
    suffices and the lint never has to import the package (which would
    drag in torch)."""
    out = {}
    for fname, const in (("flight.py", "KINDS"), ("alerts.py", "RULE_NAMES")):
        tree = ast.parse((pkg_root / "obs" / fname).read_text())
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == const
                    for t in node.targets):
                out[const] = tuple(ast.literal_eval(node.value))
    return out["KINDS"], out["RULE_NAMES"]


def _kind_call_names(node: ast.Call, kinds, rule_names) -> List[str]:
    """Unregistered-vocabulary findings for one call. A positional
    string to ``.note(…)`` is uniquely a FlightRecorder kind (span
    ``note`` is kwargs-only); ``AlertRule(…)`` is judged on its name
    (first positional) and ``kind=`` keyword. Strings that arrive
    through variables pass — the literal is linted at its definition."""
    fn = node.func
    found = []

    def judge(arg, vocab, where):
        if isinstance(arg, ast.JoinedStr):
            found.append(f"<f-string> {where}")
        elif isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                and arg.value not in vocab:
            found.append(f"`{arg.value}` {where}")

    if isinstance(fn, ast.Attribute) and fn.attr == "note" and node.args:
        judge(node.args[0], kinds, "kind in .note()")
    callee = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)
    if callee == "AlertRule":
        if node.args:
            judge(node.args[0], rule_names, "rule name in AlertRule()")
        for kw in node.keywords:
            if kw.arg == "kind":
                judge(kw.value, kinds, "kind in AlertRule()")
    return found


def _scan_kind(path: Path, kinds, rule_names) -> _Scanned:
    source = path.read_text()
    lines = source.splitlines()
    tree = ast.parse(source, filename=str(path))
    out: _Scanned = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        names = _kind_call_names(node, kinds, rule_names)
        if not names:
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        for name in names:
            out.append((Violation(str(path), node.lineno, name, line,
                                  domain="kind"), KIND_PRAGMA in line))
    return out


def lint_kind_file(path: Path, kinds, rule_names) -> List[Violation]:
    return _unsuppressed(_scan_kind(path, kinds, rule_names))


def lint_kind_package(pkg_root: Path,
                      extra_roots: Tuple[Path, ...] = ()) -> List[Violation]:
    """Lint the whole package tree plus any extra roots (directories or
    files: ``port_scripts``) — the vocabulary is process-global, so no
    file is exempt."""
    kinds, rule_names = load_registered_vocab(pkg_root)
    out = []
    paths = sorted(pkg_root.rglob("*.py"))
    for root in extra_roots:
        paths.extend(_extra_paths(root))
    for path in paths:
        out.extend(lint_kind_file(path, kinds, rule_names))
    return out


def load_route_vocab(pkg_root: Path) -> Tuple[str, ...]:
    """``ROUTES`` read straight from ``obs/opsd.py``'s AST — a
    pure-literal tuple by construction, so ``literal_eval`` suffices and
    the lint never imports the package."""
    tree = ast.parse((pkg_root / "obs" / "opsd.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "ROUTES"
                for t in node.targets):
            return tuple(ast.literal_eval(node.value))
    raise RuntimeError("obs/opsd.py has no literal ROUTES table")


def _route_call_names(node: ast.Call, routes) -> List[str]:
    """Unregistered-route findings for one call: a string literal (or
    f-string) as the first argument of ``add_route``/``_add_route``.
    Paths through variables pass — linted at the literal's definition."""
    fn = node.func
    callee = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)
    if callee not in ("add_route", "_add_route") or not node.args:
        return []
    arg = node.args[0]
    if isinstance(arg, ast.JoinedStr):
        return [f"<f-string> in {callee}()"]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
            and arg.value not in routes:
        return [f"`{arg.value}` in {callee}()"]
    return []


def _scan_route(path: Path, routes) -> _Scanned:
    source = path.read_text()
    lines = source.splitlines()
    tree = ast.parse(source, filename=str(path))
    out: _Scanned = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        names = _route_call_names(node, routes)
        if not names:
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        for name in names:
            out.append((Violation(str(path), node.lineno, name, line,
                                  domain="route"), ROUTE_PRAGMA in line))
    return out


def lint_route_file(path: Path, routes) -> List[Violation]:
    return _unsuppressed(_scan_route(path, routes))


def lint_route_package(pkg_root: Path,
                       extra_roots: Tuple[Path, ...] = ()) -> List[Violation]:
    """Lint the whole package tree plus any extra roots (directories or
    files: ``port_scripts``) — the route table is what every fleet
    poller keys on, so no file is exempt."""
    routes = load_route_vocab(pkg_root)
    out = []
    paths = sorted(pkg_root.rglob("*.py"))
    for root in extra_roots:
        paths.extend(_extra_paths(root))
    for path in paths:
        out.extend(lint_route_file(path, routes))
    return out


def _scan_pool(path: Path) -> _Scanned:
    """Stores to (and ``del`` of) the graph-held pool attributes. Reads
    and in-place writes (``pool.pad.copy_(…)``) are the engine's normal
    use and pass."""
    source = path.read_text()
    lines = source.splitlines()
    tree = ast.parse(source, filename=str(path))
    out: _Scanned = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Attribute)
                and node.attr in _POOL_GRAPH_HELD
                and isinstance(node.ctx, (ast.Store, ast.Del))):
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        out.append((Violation(str(path), node.lineno, f"`.{node.attr}`",
                              line, domain="pool"), POOL_PRAGMA in line))
    return out


def lint_pool_file(path: Path) -> List[Violation]:
    return _unsuppressed(_scan_pool(path))


def lint_pool_package(root: Path) -> List[Violation]:
    """Lint the serving package tree except the pool module itself —
    the only file allowed to rebind the graph-held tensors."""
    out = []
    for path in sorted(root.rglob("*.py")):
        if path.name == POOL_SANCTIONED:
            continue
        out.extend(lint_pool_file(path))
    return out


def main(argv: List[str] | None = None,
         repo_root: Optional[Path] = None) -> List[Violation]:
    """Historical CLI: serving lint by default; with no args, every
    legacy domain. (``python -m elephas_tpu_torch.analysis`` runs every
    rule.)"""
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if repo_root is None:
        repo_root = Path(__file__).resolve().parents[2]
    pkg_root = repo_root / PACKAGE
    scripts = port_scripts(repo_root)
    root = Path(args[0]) if args else (pkg_root / "serving")
    violations = lint_package(root)
    if not args:
        violations.extend(lint_pool_package(pkg_root / "serving"))
        violations.extend(lint_pickle_package(pkg_root / "parameter"))
        violations.extend(lint_resilience_package(pkg_root / "resilience"))
        violations.extend(lint_metric_package(pkg_root))
        violations.extend(lint_kind_package(pkg_root, extra_roots=scripts))
        violations.extend(lint_route_package(pkg_root, extra_roots=scripts))
    for v in violations:
        print(v)
    if not violations:
        print(f"lint_blocking: {root} clean")
    return violations


# -- Rule adapters: the legacy domains on the shared registry ----------------


def _domain_of(v: Violation) -> str:
    if v.domain != "serving":
        return v.domain
    return "serving-clock" if v.call.startswith("time.") else "host-sync"


class _LegacyRule(Rule):
    """Adapter base: runs one legacy scanner over its historical scope
    and converts (Violation, suppressed) pairs to Findings."""

    def _convert(self, repo: Repo, pairs: _Scanned) -> List[Finding]:
        out = []
        for v, suppressed in pairs:
            try:
                rel = str(Path(v.path).relative_to(repo.root))
            except ValueError:
                rel = v.path
            out.append(Finding(
                rule=self.name, path=rel, lineno=v.lineno, ident=v.call,
                line=v.line, message=str(v).split("\n")[0].split(": ", 1)[1],
                suppressed=suppressed,
            ))
        return out


class HostSyncRule(_LegacyRule):
    name = "host-sync"
    pragma = PRAGMA
    describe = ("serving/: no blocking device->host conversion outside "
                "host_sync.py")

    def scope(self, repo: Repo):
        return repo.walk(repo.pkg / "serving", exclude=(SANCTIONED,))

    def run(self, repo: Repo) -> List[Finding]:
        out = []
        for sf in self.scope(repo):
            pairs = [(v, s) for v, s in _scan_serving(sf.path)
                     if not v.call.startswith("time.")]
            out.extend(self._convert(repo, pairs))
        return out


class ServingClockRule(_LegacyRule):
    name = "serving-clock"
    pragma = PRAGMA
    describe = "serving/: read the injected clock, never raw time.*()"

    def scope(self, repo: Repo):
        return repo.walk(repo.pkg / "serving", exclude=(SANCTIONED,))

    def run(self, repo: Repo) -> List[Finding]:
        out = []
        for sf in self.scope(repo):
            pairs = [(v, s) for v, s in _scan_serving(sf.path)
                     if v.call.startswith("time.")]
            out.extend(self._convert(repo, pairs))
        return out


class PicklePathRule(_LegacyRule):
    name = "ps-pickle"
    pragma = PICKLE_PRAGMA
    describe = "parameter/: pickle only inside wire.py"

    def scope(self, repo: Repo):
        return repo.walk(repo.pkg / "parameter", recursive=False,
                         exclude=(PICKLE_SANCTIONED,))

    def run(self, repo: Repo) -> List[Finding]:
        out = []
        for sf in self.scope(repo):
            out.extend(self._convert(repo, _scan_pickle(sf.path)))
        return out


class ResilienceClockRule(_LegacyRule):
    name = "resilience-clock"
    pragma = CLOCK_PRAGMA
    describe = "resilience/: injected clock=/sleep= hooks only"

    def scope(self, repo: Repo):
        return repo.walk(repo.pkg / "resilience", recursive=False)

    def run(self, repo: Repo) -> List[Finding]:
        out = []
        for sf in self.scope(repo):
            out.extend(self._convert(repo, _scan_resilience(sf.path)))
        return out


class MetricNamingRule(_LegacyRule):
    name = "metric-naming"
    pragma = METRIC_PRAGMA
    describe = "package: counters end _total, histograms _seconds, no f-names"

    def scope(self, repo: Repo):
        return repo.package_files()

    def run(self, repo: Repo) -> List[Finding]:
        out = []
        for sf in self.scope(repo):
            out.extend(self._convert(repo, _scan_metric(sf.path)))
        return out


class KindVocabRule(_LegacyRule):
    name = "kind-vocab"
    pragma = KIND_PRAGMA
    describe = "package+scripts: flight kinds / alert names from the tables"

    def scope(self, repo: Repo):
        return repo.package_files() + repo.scripts_files()

    def run(self, repo: Repo) -> List[Finding]:
        try:
            kinds, rule_names = load_registered_vocab(repo.pkg)
        except (FileNotFoundError, KeyError):
            return []          # synthetic repos without obs/ vocab tables
        out = []
        for sf in self.scope(repo):
            out.extend(self._convert(
                repo, _scan_kind(sf.path, kinds, rule_names)))
        return out


class RouteVocabRule(_LegacyRule):
    name = "route-vocab"
    pragma = ROUTE_PRAGMA
    describe = "package+scripts: opsd routes from obs.opsd.ROUTES"

    def scope(self, repo: Repo):
        return repo.package_files() + repo.scripts_files()

    def run(self, repo: Repo) -> List[Finding]:
        try:
            routes = load_route_vocab(repo.pkg)
        except (FileNotFoundError, RuntimeError):
            return []
        out = []
        for sf in self.scope(repo):
            out.extend(self._convert(repo, _scan_route(sf.path, routes)))
        return out


class PoolBoundaryRule(_LegacyRule):
    name = "pool-boundary"
    pragma = POOL_PRAGMA
    describe = "serving/: graph-held pool tensors rebound only in kv_pool.py"

    def scope(self, repo: Repo):
        return repo.walk(repo.pkg / "serving", exclude=(POOL_SANCTIONED,))

    def run(self, repo: Repo) -> List[Finding]:
        out = []
        for sf in self.scope(repo):
            out.extend(self._convert(repo, _scan_pool(sf.path)))
        return out


LEGACY_RULES = (
    HostSyncRule(),
    ServingClockRule(),
    PicklePathRule(),
    ResilienceClockRule(),
    MetricNamingRule(),
    KindVocabRule(),
    RouteVocabRule(),
    PoolBoundaryRule(),
)
