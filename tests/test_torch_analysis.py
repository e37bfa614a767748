"""The port's static analyzer (``elephas_tpu_torch/analysis``) against the
JAX package's (``tests/test_analysis.py``'s checks, each a case per
package).

Three layers: (1) the same synthetic sources through both analyzers —
the JAX package's under ``elephas_tpu/``, the port's under
``elephas_tpu_torch/`` with the imports rewritten — must-fire cases that
fire in both, with equal findings; (2) the JAX analyzer over a copy of
the port's real tree renamed to ``elephas_tpu`` gives the port
analyzer's lock graph and findings (every rule whose vocabulary the port
keeps); (3) the port's tree is clean, its ``ANALYSIS_TORCH.json`` fresh,
and the repaired fault holds: no ``InferenceEngine._step_lock``
self-edge. Each report of a real tree is built once for the module.
"""

import json
import shutil
import textwrap
from pathlib import Path

import pytest

import elephas_tpu.analysis as jax_analysis
import elephas_tpu.analysis.cli as jax_cli
import elephas_tpu.analysis.locks as jax_locks
import elephas_tpu_torch.analysis as port_analysis
import elephas_tpu_torch.analysis.cli as port_cli
import elephas_tpu_torch.analysis.locks as port_locks
from elephas_tpu.analysis.core import Repo as JaxRepo
from elephas_tpu_torch.analysis.core import Repo as PortRepo

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("jax", "port")
ANALYSIS = {"jax": jax_analysis, "port": port_analysis}
CLI = {"jax": jax_cli, "port": port_cli}
LOCKS = {"jax": jax_locks, "port": port_locks}
REPO = {"jax": JaxRepo, "port": PortRepo}
PKG_DIR = {"jax": "elephas_tpu", "port": "elephas_tpu_torch"}
#: Rules whose vocabulary the port keeps (host-sync swaps JAX's syncs
#: for torch's, pool-boundary guards other names; dead-pragma reads both).
KEPT = ("serving-clock", "ps-pickle", "resilience-clock", "metric-naming", "kind-vocab",
        "route-vocab", "lock-order", "lock-blocking")
RULE_NAMES = ("host-sync", "serving-clock", "ps-pickle", "resilience-clock", "metric-naming",
              "kind-vocab", "route-vocab", "pool-boundary", "lock-order", "lock-blocking",
              "dead-pragma")


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


def synth(tmp_path: Path, files: dict, pkg: str):
    """Materialize ``{relpath: source}`` under ``pkg``'s synthetic package,
    imports of the JAX package rewritten to the port's for the port."""
    for rel, src in files.items():
        src = textwrap.dedent(src)
        if pkg == "port":
            src = src.replace("elephas_tpu.", "elephas_tpu_torch.")
        p = tmp_path / PKG_DIR[pkg] / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return REPO[pkg](tmp_path)


def run_rule(repo, name: str, pkg: str):
    return ANALYSIS[pkg].run_rules(repo)[name]


def key(finding, pkg):
    """A finding as compared across packages: its path relative to the
    package directory."""
    path = finding.path
    prefix = PKG_DIR[pkg] + "/"
    if path.startswith(prefix):
        path = "<pkg>/" + path[len(prefix):]
    return (finding.rule, path, finding.lineno, finding.ident, finding.suppressed)


# -- registry --------------------------------------------------------------------------------


def test_registry_names_unique_and_complete(pkg):
    names = [r.name for r in ANALYSIS[pkg].build_rules()]
    assert len(names) == len(set(names))
    assert tuple(names) == RULE_NAMES  # dead-pragma audits the others: last


def test_list_rules_cli(pkg, capsys):
    assert CLI[pkg].main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "lock-order" in out and "# lock-ok" in out
    assert [line.split()[0] for line in out.splitlines()] == list(RULE_NAMES)


# -- synthetic must-fire cases, both packages ----------------------------------------------


CYCLE_FILES = {
    "alpha.py": """
        import threading

        from elephas_tpu.beta import B


        class A:
            def __init__(self):
                self._lock = threading.Lock()
                self.b = B()

            def one(self):
                with self._lock:
                    self.b.poke()
    """,
    "beta.py": """
        import threading


        class B:
            def __init__(self):
                self._lock = threading.Lock()
                self.a = None

            def poke(self):
                with self._lock:
                    pass

            def two(self):
                with self._lock:
                    self.a.one()
    """,
}
PRAGMA_CYCLE = {**CYCLE_FILES, "beta.py": CYCLE_FILES["beta.py"].replace(
    "self.a.one()", "self.a.one()  # lock-ok: callback, lock released")}
GAMMA = {"gamma.py": """
    import threading


    class G:
        def __init__(self):
            self._lock = threading.Lock()

        def outer(self):
            with self._lock:
                self.inner()

        def inner(self):
            with self._lock:
                pass
"""}
DELTA = {"delta.py": """
    import threading


    class D:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def probe(self):
            with self._a:
                got = self._b.acquire(blocking=False)
                if got:
                    self._b.release()
"""}
EPSILON = {"epsilon.py": """
    from elephas_tpu.utils.locksan import make_lock


    class E:
        def __init__(self):
            self._lock = make_lock("Wrong.name")
"""}
ZETA = {"zeta.py": """
    import os
    import threading
    import time


    class Z:
        def __init__(self):
            self._lock = threading.Lock()
            self._fh = None

        def save(self):
            with self._lock:
                self._fh.flush()
                os.fsync(self._fh.fileno())

        def nap(self):
            with self._lock:
                time.sleep(0.5)
"""}
ETA = {"eta.py": """
    import threading


    class H:
        def __init__(self):
            self._lock = threading.Lock()
            self._sock = None

        def _io(self):
            self._sock.sendall(b"x")

        def locked_io(self):
            with self._lock:
                self._io()
"""}
THETA = {"theta.py": """
    import threading


    class T:
        def __init__(self):
            self._lock = threading.Lock()
            self._sock = None

        def _io(self):
            self._sock.sendall(b"x")  # lock-ok: lock exists for this

        def locked_io(self):
            with self._lock:
                self._io()
"""}
IOTA = {"iota.py": """
    import threading


    class W:
        def __init__(self):
            self._cond = threading.Condition(threading.Lock())

        def wait_for_it(self):
            with self._cond:
                self._cond.wait()
"""}
KAPPA = {"kappa.py": """
    import threading


    class K:
        def __init__(self):
            self._lock = threading.Lock()

        def fine(self):
            with self._lock:
                x = 1  # lock-ok: nothing blocking here anymore
                return x
"""}
LAM = {"lam.py": """
    import os
    import threading


    class L:
        def __init__(self):
            self._lock = threading.Lock()
            self._fh = None

        def save(self):
            with self._lock:
                os.fsync(self._fh.fileno())  # lock-ok: durability
"""}
MU = {"mu.py": """
    import threading

    #: table of things; grow it, don't inline (``# lock-ok`` escapes)
    TABLE = ("a", "b")


    class M:
        def __init__(self):
            self._lock = threading.Lock()
"""}
NU = {"nu.py": """
    X = 1  # host-ok
"""}
# The legacy domains that keep the reference's vocabulary, in their scopes.
LEGACY = {
    "serving/clocky.py": """
        import time

        def f(clock=time.monotonic):
            a = time.time()
            b = time.perf_counter()  # host-ok: module-load stamp
            return a, b
    """,
    "parameter/client.py": """
        import pickle
        from pickle import loads as from_wire

        def f(tree, buf):
            a = pickle.dumps(tree)
            b = from_wire(buf)
            c = pickle.loads(buf)  # pickle-ok: local checkpoint
            return a, b, c
    """,
    "parameter/wire.py": """
        import pickle

        def enc(o):
            return pickle.dumps(o)
    """,
    "resilience/waity.py": """
        import time

        def f(sleep=time.sleep):
            time.sleep(0.1)
            return time.monotonic()  # clock-ok: artifact stamp
    """,
    "obs/names.py": """
        def f(reg, program):
            a = reg.counter("push_count")
            b = reg.counter(f"retrace_total::{program}")
            c = reg.histogram("latency_ms")  # metric-ok: external schema
            d = reg.counter("ok_total")
            return a, b, c, d
    """,
}
CASES = {"cycle": CYCLE_FILES, "pragma_cycle": PRAGMA_CYCLE, "gamma": GAMMA, "delta": DELTA,
         "epsilon": EPSILON, "zeta": ZETA, "eta": ETA, "theta": THETA, "iota": IOTA,
         "kappa": KAPPA, "lam": LAM, "mu": MU, "nu": NU, "legacy": LEGACY}


@pytest.mark.parametrize("case", sorted(CASES))
def test_synthetic_findings_equal_across_packages(tmp_path, case):
    """Every synthetic tree gives both analyzers the same findings (rule,
    path within the package, line, identifier, suppressed) for each rule
    whose vocabulary the port keeps, and the same lock graph."""
    found = {}
    for p in PACKAGES:
        repo = synth(tmp_path / p, CASES[case], p)
        by_rule = ANALYSIS[p].run_rules(repo)
        graph = LOCKS[p].get_analysis(repo).export()
        found[p] = ({rule: sorted(key(f, p) for f in by_rule[rule]) for rule in KEPT},
                    [(e["src"], e["dst"], e["lineno"]) for e in graph["edges"]],
                    sorted(d["key"] for d in graph["locks"]))
    assert found["port"] == found["jax"]
    if case == "legacy":
        rules = found["port"][0]
        assert [f[3] for f in rules["serving-clock"]] == ["time.time", "time.perf_counter"]
        assert [f[3] for f in rules["ps-pickle"]] == [
            "pickle.dumps", "pickle.from_wire", "pickle.loads"]
        assert [f[4] for f in rules["resilience-clock"]] == [False, True]
        assert len(rules["metric-naming"]) == 3


def test_lock_cycle_must_fire(tmp_path, pkg):
    repo = synth(tmp_path, CYCLE_FILES, pkg)
    found = ANALYSIS[pkg].violations(run_rule(repo, "lock-order", pkg))
    assert found, "seeded lock cycle did not fire"
    assert "A._lock" in found[0].message and "B._lock" in found[0].message
    assert found[0].chain and any("alpha.py" in step for step in found[0].chain)


def test_lock_cycle_cli_exits_nonzero(tmp_path, pkg):
    synth(tmp_path, CYCLE_FILES, pkg)
    assert CLI[pkg].main(["--root", str(tmp_path)]) == 1


def test_lock_ok_pragma_breaks_the_cycle(tmp_path, pkg):
    found = run_rule(synth(tmp_path, PRAGMA_CYCLE, pkg), "lock-order", pkg)
    assert ANALYSIS[pkg].violations(found) == []
    assert ANALYSIS[pkg].suppressions(found), "pragma'd edge must be ledgered"


def test_self_deadlock_cycle(tmp_path, pkg):
    found = ANALYSIS[pkg].violations(run_rule(synth(tmp_path, GAMMA, pkg), "lock-order", pkg))
    assert found and "re-acquired" in found[0].message


def test_nonblocking_acquire_adds_no_edge(tmp_path, pkg):
    repo = synth(tmp_path, DELTA, pkg)
    la = LOCKS[pkg].get_analysis(repo)
    assert ("D._a", "D._b") not in {(e.src, e.dst) for e in la.edges()}
    assert ANALYSIS[pkg].violations(run_rule(repo, "lock-order", pkg)) == []


def test_make_lock_name_drift_fires(tmp_path, pkg):
    found = ANALYSIS[pkg].violations(run_rule(synth(tmp_path, EPSILON, pkg), "lock-order", pkg))
    assert found and "E._lock" in found[0].message


def test_fsync_under_lock_must_fire(tmp_path, pkg):
    found = ANALYSIS[pkg].violations(run_rule(synth(tmp_path, ZETA, pkg), "lock-blocking", pkg))
    assert {".flush", "os.fsync", "time.sleep"} <= {f.ident for f in found}
    assert all("Z._lock" in f.message for f in found)


def test_interprocedural_send_under_lock(tmp_path, pkg):
    found = ANALYSIS[pkg].violations(run_rule(synth(tmp_path, ETA, pkg), "lock-blocking", pkg))
    assert found and found[0].chain and "H._io" in found[0].message


def test_pragma_on_blocking_site_stops_propagation(tmp_path, pkg):
    found = run_rule(synth(tmp_path, THETA, pkg), "lock-blocking", pkg)
    assert ANALYSIS[pkg].violations(found) == []
    assert ANALYSIS[pkg].suppressions(found), "sanctioned site must be ledgered"


def test_condition_wait_on_own_lock_is_fine(tmp_path, pkg):
    found = run_rule(synth(tmp_path, IOTA, pkg), "lock-blocking", pkg)
    assert ANALYSIS[pkg].violations(found) == []


def test_dead_lock_ok_pragma_fires(tmp_path, pkg):
    found = ANALYSIS[pkg].violations(run_rule(synth(tmp_path, KAPPA, pkg), "dead-pragma", pkg))
    assert found and found[0].ident == "lock-ok"


def test_live_pragma_not_flagged(tmp_path, pkg):
    by_rule = ANALYSIS[pkg].run_rules(synth(tmp_path, LAM, pkg))
    assert ANALYSIS[pkg].violations(by_rule["dead-pragma"]) == []
    assert ANALYSIS[pkg].suppressions(by_rule["lock-blocking"])


def test_doc_mention_of_pragma_is_not_an_escape(tmp_path, pkg):
    found = run_rule(synth(tmp_path, MU, pkg), "dead-pragma", pkg)
    assert ANALYSIS[pkg].violations(found) == []


def test_pragma_outside_rule_scope_not_audited(tmp_path, pkg):
    found = run_rule(synth(tmp_path, NU, pkg), "dead-pragma", pkg)
    assert ANALYSIS[pkg].violations(found) == []


def test_report_json_shape(tmp_path, pkg):
    synth(tmp_path, CYCLE_FILES, pkg)
    report = CLI[pkg].build_report(tmp_path)
    assert {"root", "rules", "rows", "violations", "suppressions", "lock_graph"} <= set(report)
    assert report["rows"][-1]["section"] == "total"
    assert {"rule", "path", "lineno", "ident", "message", "suppressed"} <= set(
        report["violations"][0])
    locks = {d["key"] for d in report["lock_graph"]["locks"]}
    assert "A._lock" in locks and "B._lock" in locks
    json.loads(json.dumps(report))


def test_write_artifact(tmp_path, pkg, capsys):
    synth(tmp_path, {"ok.py": "X = 1\n"}, pkg)
    out = tmp_path / "out.json"
    assert CLI[pkg].main(["--root", str(tmp_path), "--write", str(out)]) == 0
    assert json.loads(out.read_text())["rows"][-1]["violations"] == 0
    assert "clean" in capsys.readouterr().out


def test_port_scope_is_the_port_and_its_harness(tmp_path):
    """The port's repo view walks ``elephas_tpu_torch/``, and as scripts
    only ``scripts/torch_*.py`` and ``chip_smoke.py``."""
    (tmp_path / "scripts").mkdir()
    for name in ("torch_a.py", "lint_blocking.py", "bench.py"):
        (tmp_path / "scripts" / name).write_text("X = 1\n")
    (tmp_path / "chip_smoke.py").write_text("X = 1\n")
    repo = synth(tmp_path, {"ok.py": "X = 1\n"}, "port")
    assert repo.pkg == tmp_path / "elephas_tpu_torch"
    assert sorted(sf.rel for sf in repo.scripts_files()) == ["chip_smoke.py",
                                                             "scripts/torch_a.py"]


# -- the real trees ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_report():
    return port_analysis.build_report(ROOT)


@pytest.fixture(scope="module")
def renamed_report(tmp_path_factory):
    """The JAX analyzer over a copy of the port renamed to ``elephas_tpu``;
    the port's harness goes to its ``scripts/``."""
    tmp = tmp_path_factory.mktemp("renamed")
    (tmp / "scripts").mkdir()
    for src in (ROOT / "elephas_tpu_torch").rglob("*.py"):
        if "__pycache__" in src.parts:
            continue
        dst = tmp / "elephas_tpu" / src.relative_to(ROOT / "elephas_tpu_torch")
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(src.read_text().replace("elephas_tpu_torch", "elephas_tpu"))
    for src in [*(ROOT / "scripts").glob("torch_*.py"), ROOT / "chip_smoke.py"]:
        shutil.copyfile(src, tmp / "scripts" / src.name)
    return jax_analysis.build_report(tmp)


def _real_path(path):
    """A path of the renamed copy as the port's tree names it."""
    if path.startswith("elephas_tpu/"):
        return "elephas_tpu_torch/" + path[len("elephas_tpu/"):]
    if path == "scripts/chip_smoke.py":
        return "chip_smoke.py"
    return path


def test_the_jax_analyzer_sees_the_port_as_the_port_analyzer_does(port_report, renamed_report):
    """The lock graph (locks and edges with their sites) and every finding
    of each rule whose vocabulary the port keeps are equal."""
    def graph(report, mapped):
        g = report["lock_graph"]
        fix = _real_path if mapped else (lambda p: p)
        return ([(d["key"], d["kind"], fix(d["path"]), d["lineno"]) for d in g["locks"]],
                [(e["src"], e["dst"], fix(e["path"]), e["lineno"]) for e in g["edges"]])

    def findings(report, mapped):
        fix = _real_path if mapped else (lambda p: p)
        return sorted((f["rule"], fix(f["path"]), f["lineno"], f["ident"], f["suppressed"])
                      for f in report["violations"] + report["suppressions"]
                      if f["rule"] in KEPT)

    assert graph(port_report, False) == graph(renamed_report, True)
    assert findings(port_report, False) == findings(renamed_report, True)
    assert len(port_report["lock_graph"]["edges"]) == 11


def test_repo_is_clean(port_report):
    assert port_report["violations"] == [], port_report["violations"]
    total = port_report["rows"][-1]
    assert total["lock_cycles"] == 0
    assert total["locks"] > 20 and total["lock_edges"] >= 5 and total["suppressions"] > 0


def test_committed_analysis_json_is_fresh(port_report):
    """ANALYSIS_TORCH.json is gated as ``bench_gate.py --analysis`` gates
    the reference's ANALYSIS.json, and its lock graph is today's."""
    import scripts.bench_gate as bg

    committed = json.loads((ROOT / "ANALYSIS_TORCH.json").read_text())
    bad = [c for c in bg.compare(committed["rows"], port_report["rows"], "analysis")
           if not c["ok"]]
    assert not bad, bad
    assert committed["lock_graph"] == port_report["lock_graph"]
    assert committed["root"] == port_report["root"] == "."


def test_known_order_edges_present(port_report):
    """The buffer's write lock before its version guard, never after; the
    same edges as the reference's own tree."""
    edges = {(e["src"], e["dst"]) for e in port_report["lock_graph"]["edges"]}
    assert ("ParameterBuffer._lock", "ParameterBuffer._version_guard") in edges
    assert ("ParameterBuffer._version_guard", "ParameterBuffer._lock") not in edges
    reference = json.loads((ROOT / "ANALYSIS.json").read_text())
    assert edges == {(e["src"], e["dst"]) for e in reference["lock_graph"]["edges"]}


def test_no_step_lock_self_edge(port_report):
    """The repaired re-entry: the subscriber hook, which runs under the
    engine's step lock, installs through ``install_weights_held``, which
    never takes it, so the graph holds no self-edge on it, and no pragma
    sits on an ``install_weights`` line."""
    edges = {(e["src"], e["dst"]) for e in port_report["lock_graph"]["edges"]}
    assert ("InferenceEngine._step_lock", "InferenceEngine._step_lock") not in edges
    assert all(e["src"] != e["dst"] for e in port_report["lock_graph"]["edges"])
    for path in ("elephas_tpu_torch/serving/engine.py", "elephas_tpu_torch/rollout/subscriber.py"):
        for line in (ROOT / path).read_text().splitlines():
            assert not ("install" in line and "lock-ok" in line), line
