"""The port's eight lint domains (``elephas_tpu_torch/analysis/legacy.py``)
against the JAX package's (``scripts/lint_blocking.py`` over
``elephas_tpu/analysis/legacy.py``): ``tests/test_lint_blocking.py``'s
checks, each a case per package, on each package's own tree.

The port keeps six domains' vocabulary as it is. ``host-sync`` swaps
JAX's ``block_until_ready``/``device_get`` for torch's ``.cpu()``,
``.numpy()`` and ``.synchronize()``; ``pool-boundary`` guards the
tensors the captured decode graph holds (no rebinding outside
``kv_pool.py``) instead of the donated ``._cache``/``._pad``.
"""

import textwrap
from pathlib import Path

import pytest

import elephas_tpu_torch.analysis.legacy as port_lint
import scripts.lint_blocking as jax_lint

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("jax", "port")
LINT = {"jax": jax_lint, "port": port_lint}
PKG_ROOT = {"jax": ROOT / "elephas_tpu", "port": ROOT / "elephas_tpu_torch"}
#: Each package's harness: the JAX package's scripts/, the port's own files.
SCRIPTS = {"jax": (ROOT / "scripts",), "port": port_lint.port_scripts(ROOT)}


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


@pytest.fixture
def lint(pkg):
    return LINT[pkg]


def write(tmp_path, name, src):
    path = tmp_path / name
    path.write_text(textwrap.dedent(src))
    return path


# -- host-sync and serving-clock -------------------------------------------------------------


def test_serving_package_is_clean(pkg, lint):
    root = PKG_ROOT[pkg] / "serving"
    assert root.is_dir()
    violations = lint.lint_package(root)
    assert violations == [], "\n".join(str(v) for v in violations)


def test_lint_catches_each_conversion(tmp_path, pkg, lint):
    """The shared conversions, and each package's own device syncs (the
    port's every torch sync fires in the port's lint)."""
    bad = write(tmp_path, "bad.py", """
        import numpy as np
        import jax
        import torch

        def f(x, stream):
            a = int(x[0])
            b = float(x.sum())
            c = x.item()
            d = x.tolist()
            e = np.asarray(x)
            g = np.array(x)
            h = jax.device_get(x)
            jax.block_until_ready(x)
            x.block_until_ready()
            i = x.cpu()
            j = x.numpy()
            torch.cuda.synchronize()
            stream.synchronize()
            return a, b, c, d, e, g, h, i, j
    """)
    shared = {"int", "float", ".item", ".tolist", "np.asarray", "np.array"}
    own = {"jax": {"device_get", ".block_until_ready"},
           "port": {".cpu", ".numpy", ".synchronize"}}[pkg]
    assert {v.call for v in lint.lint_file(bad)} == shared | own
    if pkg == "port":
        assert [v.call for v in lint.lint_file(bad)].count(".synchronize") == 2


def test_pragma_exempts_a_line(tmp_path, lint):
    ok = write(tmp_path, "ok.py", "def f(xs):\n"
                                  "    return [int(x) for x in xs]  # host-ok: caller ints\n")
    assert lint.lint_file(ok) == []


def test_lint_catches_raw_clock_calls(tmp_path, lint):
    bad = write(tmp_path, "clocky.py", """
        import time

        def f(self):
            a = time.time()
            b = time.perf_counter()
            c = time.monotonic()
            return a, b, c
    """)
    assert {v.call for v in lint.lint_file(bad)} == {
        "time.time", "time.perf_counter", "time.monotonic"}
    assert "injected serving clock" in str(lint.lint_file(bad)[0])


def test_clock_reference_is_not_a_call(tmp_path, lint):
    ok = write(tmp_path, "defaults.py", """
        import time

        def make(clock=time.monotonic):
            fallback = time.monotonic
            time.sleep(0)
            return clock, fallback
    """)
    assert lint.lint_file(ok) == []


def test_pragma_exempts_a_clock_line(tmp_path, lint):
    ok = write(tmp_path, "ok_clock.py", "import time\n"
                                        "def f():\n"
                                        "    return time.monotonic()  # host-ok: load stamp\n")
    assert lint.lint_file(ok) == []


def test_host_sync_module_is_sanctioned(tmp_path, lint):
    pkg_dir = tmp_path / "serving"
    pkg_dir.mkdir()
    (pkg_dir / "host_sync.py").write_text("def fetch(x):\n    return x.cpu().numpy()\n")
    (pkg_dir / "other.py").write_text("def f(x):\n    return int(x)\n")
    violations = lint.lint_package(pkg_dir)
    assert len(violations) == 1 and violations[0].path.endswith("other.py")


def test_lint_package_recurses_into_subpackages(tmp_path, lint):
    sub = tmp_path / "serving" / "fleet"
    sub.mkdir(parents=True)
    (tmp_path / "serving" / "top.py").write_text("def f(x):\n    return x\n")
    (sub / "deep.py").write_text("def f(x):\n    return int(x)\n")
    violations = lint.lint_package(tmp_path / "serving")
    assert len(violations) == 1 and violations[0].path.endswith("deep.py")


# -- ps-pickle ---------------------------------------------------------------------------------


def test_parameter_package_has_no_stray_pickle(pkg, lint):
    violations = lint.lint_pickle_package(PKG_ROOT[pkg] / "parameter")
    assert violations == [], "\n".join(str(v) for v in violations)


def test_pickle_lint_catches_each_form(tmp_path, lint):
    bad = write(tmp_path, "bad_pickle.py", """
        import pickle
        from pickle import loads as from_wire

        def f(tree, buf):
            a = pickle.dumps(tree)
            b = pickle.loads(buf)
            pickle.dump(tree, open("/dev/null", "wb"))
            c = pickle.load(open("/dev/null", "rb"))
            d = from_wire(buf)
            return a, b, c, d
    """)
    assert sorted(v.call for v in lint.lint_pickle_file(bad)) == [
        "pickle.dump", "pickle.dumps", "pickle.from_wire", "pickle.load", "pickle.loads"]
    assert "wire.encode_pickle" in str(lint.lint_pickle_file(bad)[0])


def test_pickle_lint_ignores_unrelated_names(tmp_path, lint):
    ok = write(tmp_path, "ok_pickle.py", """
        import json
        import pickle

        def f(buf, cache):
            a = json.loads(buf)
            b = cache.dumps()
            c = pickle.loads(buf)  # pickle-ok: local checkpoint, not wire
            return a, b, c
    """)
    assert lint.lint_pickle_file(ok) == []


def test_pickle_sanctioned_module_is_wire(tmp_path, lint):
    pkg_dir = tmp_path / "parameter"
    pkg_dir.mkdir()
    (pkg_dir / "wire.py").write_text("import pickle\ndef enc(o):\n    return pickle.dumps(o)\n")
    (pkg_dir / "client.py").write_text("import pickle\ndef dec(b):\n"
                                       "    return pickle.loads(b)\n")
    violations = lint.lint_pickle_package(pkg_dir)
    assert len(violations) == 1 and violations[0].path.endswith("client.py")


# -- resilience-clock --------------------------------------------------------------------------


def test_resilience_package_uses_injected_clocks(pkg, lint):
    violations = lint.lint_resilience_package(PKG_ROOT[pkg] / "resilience")
    assert violations == [], "\n".join(str(v) for v in violations)


def test_resilience_lint_catches_sleep_and_clocks(tmp_path, lint):
    bad = write(tmp_path, "waity.py", """
        import time

        def f(self):
            time.sleep(0.1)
            a = time.monotonic()
            b = time.time()
            c = time.perf_counter()
            return a, b, c
    """)
    assert {v.call for v in lint.lint_resilience_file(bad)} == {
        "time.sleep", "time.monotonic", "time.time", "time.perf_counter"}
    by_call = {v.call: str(v) for v in lint.lint_resilience_file(bad)}
    assert "raw sleep" in by_call["time.sleep"]
    assert "injected clock/sleep" in by_call["time.monotonic"]


def test_resilience_lint_allows_default_values_and_pragma(tmp_path, lint):
    ok = write(tmp_path, "hooks.py", """
        import time

        def make(clock=time.monotonic, sleep=time.sleep):
            stamp = time.time()  # clock-ok: one-shot artifact timestamp
            return clock, sleep, stamp
    """)
    assert lint.lint_resilience_file(ok) == []


# -- metric-naming -----------------------------------------------------------------------------


def test_obs_metric_names_conform(pkg, lint):
    violations = lint.lint_metric_package(PKG_ROOT[pkg])
    assert violations == [], "\n".join(str(v) for v in violations)


def test_metric_lint_catches_each_form(tmp_path, lint):
    bad = write(tmp_path, "bad_metrics.py", """
        def f(reg, program):
            a = reg.counter("push_count")
            b = reg.counter(f"retrace_total::{program}")
            c = reg.histogram("latency_ms")
            return a, b, c
    """)
    assert sorted(v.call for v in lint.lint_metric_file(bad)) == [
        "<f-string> in .counter()", "`latency_ms` in .histogram()", "`push_count` in .counter()"]
    assert "labelnames=" in str(lint.lint_metric_file(bad)[0])


def test_metric_lint_passes_sanctioned_shapes(tmp_path, lint):
    ok = write(tmp_path, "ok_metrics.py", """
        def f(reg, name):
            a = reg.counter("ps_push_retry_total", labelnames=("worker",))
            b = reg.histogram("train_epoch_seconds")
            c = reg.counter(name)
            d = reg.gauge("queue_depth")
            e = reg.counter("legacy_bridge_count")  # metric-ok: external schema
            return a, b, c, d, e
    """)
    assert lint.lint_metric_file(ok) == []


# -- kind-vocab and route-vocab ----------------------------------------------------------------


def test_kind_vocabulary_is_registered(pkg, lint):
    violations = lint.lint_kind_package(PKG_ROOT[pkg], extra_roots=SCRIPTS[pkg])
    assert violations == [], "\n".join(str(v) for v in violations)


def test_kind_lint_catches_each_form(tmp_path, pkg, lint):
    bad = write(tmp_path, "bad_kinds.py", """
        def f(flight, name):
            flight.note("totally_new_thing", "warn")
            flight.note(f"kind_{name}", "warn")
            AlertRule("my_rule", "m", ">", 1.0, kind="slo_breach")
            AlertRule("staleness_p95_high", "m", ">", 1.0, kind="made_up")
    """)
    kinds, rule_names = lint.load_registered_vocab(PKG_ROOT[pkg])
    assert sorted(v.call for v in lint.lint_kind_file(bad, kinds, rule_names)) == [
        "<f-string> kind in .note()", "`made_up` kind in AlertRule()",
        "`my_rule` rule name in AlertRule()", "`totally_new_thing` kind in .note()"]
    msg = str(lint.lint_kind_file(bad, kinds, rule_names)[0])
    assert "obs.flight.KINDS" in msg and "RULE_NAMES" in msg


def test_kind_lint_passes_sanctioned_shapes(tmp_path, pkg, lint):
    ok = write(tmp_path, "ok_kinds.py", """
        def f(flight, span, kind):
            flight.note("slo_breach", "warn", rule="staleness_p95_high")
            flight.note(kind, "warn")
            span.note(worker="w0", staleness=3)
            AlertRule("worker_lag_high", "m", ">", 32.0,
                      kind="worker_lagging")
            flight.note("test_only", "info")  # kind-ok: local test vocab
    """)
    assert lint.lint_kind_file(ok, *lint.load_registered_vocab(PKG_ROOT[pkg])) == []


def test_registered_vocab_matches_runtime_tables(pkg, lint):
    """The AST-read tables equal the importable constants, and the port's
    equal the JAX package's."""
    if pkg == "jax":
        from elephas_tpu import obs
    else:
        from elephas_tpu_torch import obs
    kinds, rule_names = lint.load_registered_vocab(PKG_ROOT[pkg])
    assert (kinds, rule_names) == (obs.KINDS, obs.RULE_NAMES)
    assert (kinds, rule_names) == jax_lint.load_registered_vocab(PKG_ROOT["jax"])


def test_route_vocab_matches_runtime_table(pkg, lint):
    if pkg == "jax":
        from elephas_tpu.obs import opsd
    else:
        from elephas_tpu_torch.obs import opsd
    assert lint.load_route_vocab(PKG_ROOT[pkg]) == opsd.ROUTES
    assert opsd.ROUTES == jax_lint.load_route_vocab(PKG_ROOT["jax"])


def test_package_and_scripts_route_registrations_conform(pkg, lint):
    assert lint.lint_route_package(PKG_ROOT[pkg], extra_roots=SCRIPTS[pkg]) == []


def test_route_lint_catches_each_form(tmp_path, pkg, lint):
    bad = write(tmp_path, "bad_routes.py", """
        def mount(self, srv, name):
            self._add_route("/metrics", self._h_metrics)   # registered
            self._add_route("/secret", self._h_secret)     # not in ROUTES
            srv.add_route("/debug", handler)               # not in ROUTES
            srv.add_route(f"/worker/{name}", handler)      # dynamic path
            srv.add_route(name, handler)                   # variable: passes
    """)
    violations = lint.lint_route_file(bad, lint.load_route_vocab(PKG_ROOT[pkg]))
    assert [v.call for v in violations] == [
        "`/secret` in _add_route()", "`/debug` in add_route()", "<f-string> in add_route()"]
    assert all(v.domain == "route" for v in violations)
    assert "obs.opsd.ROUTES" in str(violations[0])


def test_route_pragma_exempts_a_line(tmp_path, pkg, lint):
    ok = write(tmp_path, "ok_routes.py", """
        def mount(srv):
            srv.add_route("/test-hook", handler)  # route-ok: test-local
            srv.add_route("/fleet", handler)
    """)
    assert lint.lint_route_file(ok, lint.load_route_vocab(PKG_ROOT[pkg])) == []


def test_route_vocab_load_fails_loudly_without_table(tmp_path, lint):
    (tmp_path / "obs").mkdir()
    (tmp_path / "obs" / "opsd.py").write_text("SOMETHING_ELSE = 1\n")
    with pytest.raises(RuntimeError, match="ROUTES"):
        lint.load_route_vocab(tmp_path)


def test_fleet_vocab_entries_are_registered(pkg, lint):
    kinds, _ = lint.load_registered_vocab(PKG_ROOT[pkg])
    assert {"replica_drain", "replica_restart", "fleet_scale"} <= set(kinds)
    assert "/replicas" in lint.load_route_vocab(PKG_ROOT[pkg])


def test_paged_vocab_entries_are_registered(pkg, lint):
    kinds, _ = lint.load_registered_vocab(PKG_ROOT[pkg])
    assert "prefix_evict" in set(kinds)
    kv_pool = PKG_ROOT[pkg] / "serving" / "kv_pool.py"
    src = kv_pool.read_text()
    for name in ("serving_prefix_cache_hit_total", "serving_prefix_cache_lookup_total",
                 "serving_kv_blocks_free"):
        assert name in src
    assert lint.lint_metric_file(kv_pool) == []
    assert lint.lint_kind_file(kv_pool, *lint.load_registered_vocab(PKG_ROOT[pkg])) == []


# -- pool-boundary -----------------------------------------------------------------------------


def test_pool_lint_serving_is_clean(pkg, lint):
    violations = lint.lint_pool_package(PKG_ROOT[pkg] / "serving")
    assert violations == [], "\n".join(str(v) for v in violations)


def test_pool_lint_catches_reads_and_writes(tmp_path, pkg, lint):
    """The JAX package: any touch of the donated ``._cache``/``._pad``.
    The port: every rebinding (store or ``del``) of a graph-held pool
    tensor, never a read or an in-place write."""
    bad = write(tmp_path, "bad_pool.py", """
        def f(pool, tree, t):
            stale = pool._cache
            pad = pool._pad
            pool._cache = tree
            pool.pad = t
            pool.cache.index = t
            pool.table.buffer = t
            pool.cache.keys[0] = t
            del pool.cache.values
            pool.pad.copy_(t)
            live = pool.cache.index
            return stale, pad, live
    """)
    calls = sorted(v.call for v in lint.lint_pool_file(bad))
    if pkg == "jax":
        assert calls == ["`._cache`", "`._cache`", "`._pad`"]
        msg = str(lint.lint_pool_file(bad)[0])
        assert "pool.swap()" in msg and "pool-ok" in msg
    else:
        assert calls == ["`.buffer`", "`.index`", "`.pad`", "`.values`"]
        msg = str(lint.lint_pool_file(bad)[0])
        assert "pool.swap()" in msg and "pool-ok" in msg and "captured" in msg


def test_pool_lint_pragma_and_sanctioned_module(tmp_path, pkg, lint):
    pkg_dir = tmp_path / "serving"
    pkg_dir.mkdir()
    touch = {"jax": ("return self._cache", "return pool._cache  # pool-ok: never donated"),
             "port": ("self.pad = new", "pool.pad = new  # pool-ok: not the pool's")}[pkg]
    (pkg_dir / "kv_pool.py").write_text(f"class P:\n    def f(self, new):\n        {touch[0]}\n")
    (pkg_dir / "other.py").write_text(f"def f(pool, new):\n    {touch[1]}\n")
    assert lint.lint_pool_package(pkg_dir) == []


# -- the CLI ----------------------------------------------------------------------------------


def test_cli_reports_clean(pkg, lint, capsys):
    assert lint.main([]) == []
    assert "clean" in capsys.readouterr().out


def test_port_scripts_are_the_port_harness():
    names = [p.name for p in port_lint.port_scripts(ROOT)]
    assert "chip_smoke.py" in names and all(
        n.startswith("torch_") for n in names if n != "chip_smoke.py")
    assert "lint_blocking.py" not in names and len(names) > 1
