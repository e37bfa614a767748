"""Asynchronous and hogwild training across processes (the port's
counterpart of the async rows of ``tests/test_multihost.py``).

Two gloo ranks on the CPU (``tests/test_torch_dist_worker.py``, a
``file://`` store, ``GLOO_SOCKET_IFNAME=lo``), two worker threads each,
one parameter server on rank 0 that both ranks' workers dial. Every rank
must end with the same weights, history, validation, predictions and
evaluation; the server's accounting must be exact (its version is the
pushes of both ranks, its weights the start minus the float64 sum of
their deltas); a client without the job's key is refused; autotune is
decided by rank 0; a killed peer surfaces as the teardown barrier's
``TimeoutError``; and the fits a group cannot run are refused with the
JAX package's messages.
"""

import inspect
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "test_torch_dist_worker.py"
EPOCHS = 2
SUM_LIMIT = 1e-6  # chip_smoke.ASYNC_SUM_LIMIT: float32 subtractions of a few pushes

FITS = {
    "async_socket": {"mode": "asynchronous", "ps_mode": "socket"},
    "async_http": {"mode": "asynchronous", "ps_mode": "http"},
    "hogwild_socket": {"mode": "hogwild", "ps_mode": "socket"},
    "hogwild_http": {"mode": "hogwild", "ps_mode": "http"},
    "hogwild_http_streamed": {"mode": "hogwild", "ps_mode": "http", "stream_batches": 3},
}


def _spawn(tmp_path, jobs, env_extra=(), expect_codes=(0, 0), timeout=240):
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"store": str(tmp_path / "store"), "world": 2,
                                  "jobs": jobs}))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo", "ELEPHAS_PS_BIND": "127.0.0.1", **dict(env_extra)}
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(config), str(r)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT)
             for r in range(2)]
    try:
        codes = tuple(p.wait(timeout=timeout) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    assert codes == tuple(expect_codes), [(tmp_path / f"rank{r}.log").read_text()[-3000:]
                                          for r in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("async_multiproc")
    jobs = [{"kind": "async_fit", "epochs": EPOCHS, "out": str(tmp / name), **spec}
            for name, spec in FITS.items()]
    jobs.append({"kind": "async_fit", "mode": "hogwild", "ps_mode": "http", "epochs": 1,
                 "autotune": True, "out": str(tmp / "autotune")})
    jobs.append({"kind": "async_refusals", "out": str(tmp / "refusals")})
    _spawn(tmp, jobs)

    def load(name):
        return [torch.load(f"{tmp / name}.rank{r}", weights_only=False) for r in range(2)]

    return {name: load(name) for name in [*FITS, "autotune", "refusals"]}


@pytest.mark.parametrize("case", list(FITS))
def test_every_rank_ends_with_the_same_model_and_answers(runs, case):
    r0, r1 = runs[case]
    assert r0["weights"].keys() == r1["weights"].keys()
    for name in r0["weights"]:
        assert torch.equal(r0["weights"][name], r1["weights"][name]), name
    assert r0["history"] == r1["history"]
    for key in ("val_loss", "val_acc", "val_stale"):
        assert len(r0["history"][key]) == EPOCHS
    assert r0["history"]["val_stale"] == [0.0] * EPOCHS
    np.testing.assert_array_equal(r0["predict"], r1["predict"])
    assert r0["predict"].shape == (128, 3) and np.isfinite(r0["predict"]).all()
    assert r0["evaluate"] == r1["evaluate"]
    assert r0["history"]["loss"][-1] < r0["history"]["loss"][0]


def _relative(got, want, norm):
    diff = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    return (diff / sum(float(np.sum(norm[k] ** 2)) for k in norm)) ** 0.5


@pytest.mark.parametrize("case", list(FITS))
def test_parameter_server_accounting_is_exact(runs, case):
    """Every push reaches the server and counts in its version. Under
    the lock every one applies: the final weights are the start minus
    the float64 sum of both ranks' deltas. Under hogwild a racing apply
    can drop whole deltas (``parameter/buffer.py``): the final weights
    are the start minus exactly the deltas the final tree holds, as many
    as the buffer says were applied."""
    r0, r1 = runs[case]
    # 2 ranks x 2 workers, one push per worker and epoch.
    assert r0["pushes"] == r1["pushes"] == 2 * EPOCHS
    assert r0["version"] == r0["pushes"] + r1["pushes"]
    start, final = r0["start"], r0["final"]
    pushed = {k: r0["sums"].get(k, 0.0) + r1["sums"].get(k, 0.0) for k in start}
    assert _relative(r0["received"], pushed, start) <= 1e-12
    assert r0["survivors"] == r0["applied"]
    survivors = {k: r0["survivor_sums"].get(k, 0.0) for k in start}
    assert _relative(final, {k: start[k] - survivors[k] for k in start}, start) <= SUM_LIMIT
    if FITS[case]["mode"] == "asynchronous":
        assert r0["applied"] == r0["version"]
        assert _relative(final, {k: start[k] - pushed[k] for k in start}, start) <= SUM_LIMIT
    else:
        assert 1 <= r0["applied"] <= r0["version"]


def _jax_history(per_worker_by_rank, epochs):
    """``elephas_tpu/engine/async_engine.py``'s job-wide train history:
    each host's per-epoch means over its workers, allgathered and weighted
    by its worker count; ``worker_retries`` the job-wide count."""
    keys = sorted(next(iter(per_worker_by_rank[0].values()))[0].keys())
    counts, all_means = [], []
    for per_worker in per_worker_by_rank:
        worker_histories = list(per_worker.values())
        all_means.append(np.array(
            [[np.mean([m[e][k] for m in worker_histories]) for k in keys]
             for e in range(epochs)], dtype=np.float64))
        counts.append(len(worker_histories))
    counts = np.asarray(counts, dtype=np.float64)
    local_means = (np.asarray(all_means) * counts[:, None, None]).sum(axis=0) / counts.sum()
    history = {k: [float(local_means[e, i]) for e in range(epochs)]
               for i, k in enumerate(keys)}
    history["worker_retries"] = [int(round(v * float(counts.sum())))
                                 for v in history.pop("_retries")]
    return history


@pytest.mark.parametrize("case", list(FITS))
def test_history_is_the_worker_count_weighted_mean(runs, case):
    r0, r1 = runs[case]
    assert sorted(r0["per_worker"]) == [0, 1] and sorted(r1["per_worker"]) == [2, 3]
    want = _jax_history([r0["per_worker"], r1["per_worker"]], EPOCHS)
    got = {k: v for k, v in r0["history"].items() if not k.startswith("val_")}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)


def test_job_mean_weights_unequal_ranks_as_the_jax_formula(monkeypatch):
    """Three ranks of 1, 2 and 3 workers, through ``job_mean``'s
    allgather (stubbed with the other ranks' payloads)."""
    from elephas_tpu_torch.engine import async_engine

    rng = np.random.default_rng(3)
    keys = ["_retries", "acc", "loss"]
    per_rank = [{w: [{k: float(rng.random()) for k in keys} for _ in range(4)]
                 for w in range(n)} for n in (1, 2, 3)]
    payloads = []
    for per_worker in per_rank:
        local = np.mean(np.asarray([[[m[e][k] for k in keys] for e in range(4)]
                                    for m in per_worker.values()]), axis=0)
        payloads.append(json.dumps({"count": len(per_worker),
                                    "means": local.tolist()}).encode())
    monkeypatch.setattr(async_engine.distributed, "allgather_bytes", lambda b: payloads)
    mine = [[[m[e][k] for k in keys] for e in range(4)] for m in per_rank[1].values()]
    means, total = async_engine.job_mean(mine, True)
    want = _jax_history(per_rank, 4)
    assert total == 6
    for i, k in enumerate(keys[1:], start=1):
        np.testing.assert_allclose(means[:, i], want[k], rtol=1e-12)


def test_workers_cover_every_partition_once(runs):
    r0, r1 = runs["async_socket"]
    assert r0["workers"] == [0, 1] and r1["workers"] == [2, 3]
    assert r0["n_global_workers"] == r1["n_global_workers"] == 4


@pytest.mark.parametrize("case", list(FITS))
def test_a_client_without_the_job_key_is_refused(runs, case):
    r0, _ = runs[case]
    assert r0["unauthenticated"] and r0["unauthenticated"][0] != "answered"


def test_autotune_is_decided_by_rank0_for_the_job(runs):
    r0, r1 = runs["autotune"]
    assert r0["timed"] == 1 and r1["timed"] == 0
    assert r0["autotune"] == r1["autotune"]
    assert r0["autotune"]["winner"] in ("default", "eager_again")
    assert set(r0["autotune"]["ms_per_2batch"]) == {"default", "eager_again"}
    assert r0["history"]["compile_autotune"] == r1["history"]["compile_autotune"]


def _jax_messages():
    from elephas_tpu.engine import async_engine

    # Adjacent string literals joined, as Python joins them.
    return re.sub(r'"\s*\n\s*"', "", inspect.getsource(async_engine))


@pytest.mark.parametrize("name", ["local", "ps_shards", "elastic",
                                  "checkpoint_host0_only=False"])
def test_group_refusals_carry_the_jax_messages(runs, name):
    r0, r1 = runs["refusals"]
    assert r0[name] == r1[name]
    assert isinstance(r0[name], str) and r0[name] in _jax_messages()


def test_a_host0_only_checkpoint_is_written_by_rank0_alone(runs):
    r0, r1 = runs["refusals"]
    assert r0["checkpoint_host0_only=True"] == ["1"]
    assert r1["checkpoint_host0_only=True"] == []


def test_peer_death_surfaces_as_a_barrier_timeout(tmp_path):
    _spawn(tmp_path, [{"kind": "async_death", "ps_mode": "http", "epochs": 30,
                       "out": str(tmp_path / "death")}],
           env_extra={"ELEPHAS_BARRIER_TIMEOUT": "6"}, expect_codes=(0, -9))
    out = torch.load(f"{tmp_path / 'death'}.rank0", weights_only=False)
    assert out["error"] == "TimeoutError", out
    assert "elephas:pushes_done" in out["message"] and "peer host likely died" in out["message"]
    assert out["server_stopped"]
    assert out["seconds"] < 6 + 40
