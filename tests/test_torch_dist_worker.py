"""One rank of the port's multi-process parity runs (``test_torch_fit.py``,
``test_torch_hyperparam.py``); a script, not a test module: it holds no
tests.

    python tests/test_torch_dist_worker.py CONFIG.json RANK

Joins a gloo group on the CPU (``file://`` store, world size and rank
from the arguments), then runs each job of the config. A fit job runs
``SparkModel(mode="synchronous").fit`` (with the job's
``stream_batches`` and ``autotune`` where given), ``evaluate`` and
``predict`` and, on rank 0 (on every rank with ``"all_ranks"``), saves
the history, the final weights, the recorded autotune choice, and the
evaluation and predictions on all rows but the last two, with
``torch.save``. An autotune job (``"kind": "autotune"``) calls
``decide_autotune`` with a different outcome on each rank, then fits a
``SyncTrainer(autotune=True)`` whose two injected candidates time
faster on different ranks, and saves what every rank adopted. A
``"search_devices"`` job runs ``HyperParamModel(None)`` on a faked host
of several cards and saves the devices and slots each rank took. A search
job (``"kind": "search"``) runs ``HyperParamModel(device="cpu",
num_workers=...).minimize`` with ``search_objective``, a ``SyncTrainer``
fit per trial, and saves, from every rank, its trials, the winner it
returns and the winner's weights. The sequence-parallel jobs
(``test_torch_seq_parallel.py``) run on a mesh of the whole world: an
``"seq_attention"`` job runs ring attention (dense, flash on the plain
hop versions, and flash through stand-in kernels that count their
launches) and Ulysses attention, causal and full, forward and backward,
and saves the global output, this rank's shard of the gradients and the
launches; a ``"seq_trainer"`` job fits ``SeqParallelTrainer`` on a data ×
seq mesh with validation, a ragged evaluation three ways and a resumed
fit, and saves the histories, evaluations and weights; a
``"distributed"`` job (world joined through
``parallel.distributed.initialize``) saves what the control-plane
collectives of ``parallel/distributed.py`` return. The tensor-parallel
jobs (``test_torch_tensor_parallel.py``, ``test_torch_serving_tp.py``):
a ``"tp_train"`` job trains a model sharded over the mesh's model axis
(dp x tp through ``make_train_step_tp``, or sp x tp through
``seq_parallel``) and saves each step's metrics and stand-in kernel
launches, the local shapes, the replicated parameters, the gathered
state, the mesh's groups and, with a checkpoint directory, a save
restored into a fresh sharded state and one more step of each; a
``"tp_serving"`` job serves prompts from a sharded ``InferenceEngine``
(rank 0 serves, the others follow) and, on rank 0, from the unsharded
engine too. The asynchronous jobs (``test_torch_async_multiproc.py``):
an ``"async_fit"`` job runs ``SparkModel(mode="asynchronous"|"hogwild")``
over a wire server on rank 0 with 2 CPU workers a rank and saves the
weights, the history, the per-worker epoch metrics, every push's delta
summed in float64, rank 0's buffer version, the deltas its final tree
holds (``chip_smoke.ApplyChain``) and what an unauthenticated client got
from the live server, the post-fit ``predict``/``evaluate``
and the autotune choice (``"autotune"``: two injected eager candidates,
and whether this rank timed them); an ``"async_refusals"`` job saves
the errors of the fits a group refuses; an ``"async_death"`` job kills
rank 1 after its first push and saves what rank 0's fit raised.
Imports the port only, no JAX.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def _run(job, rank):
    import elephas_tpu_torch as et
    from elephas_tpu_torch.engine import sync
    from elephas_tpu_torch.models import get_model

    data = np.load(job["data"])
    x, y = data["x"], data["y"]
    if job.get("perms"):
        perms = np.load(job["perms"])  # (epochs, shards, rows): the JAX package's orders

        def table(seed, epoch, shard, n):
            return torch.as_tensor(perms[epoch, shard][:n])

        sync.shard_permutation = table
    module = get_model(job["model"], device="cpu", **job["kwargs"])
    compiled = et.CompiledModel(module, torch.load(job["weights"]), optimizer=job["optimizer"],
                               loss=job["loss"], metrics=["acc"])
    model = et.SparkModel(compiled, mode="synchronous", frequency=job["frequency"],
                          num_workers=dist.get_world_size(),
                          autotune=job.get("autotune", False))
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=job["epochs"],
                        batch_size=job["batch_size"],
                        stream_batches=job.get("stream_batches"))
    result = {"history": history, "weights": model.get_weights(),
              "autotune": model.last_autotune,
              "evaluate": model.evaluate(x[:-2], y[:-2], batch_size=job["eval_batch"]),
              "predict": model.predict(x[:-2], batch_size=job["eval_batch"])}
    if job.get("all_ranks"):
        torch.save(result, f"{job['out']}.rank{rank}")
    elif rank == 0:
        torch.save(result, job["out"])


def _autotune(job, rank):
    """``decide_autotune`` adopts rank 0's outcome on every rank, for a
    given outcome and for a fit's A/B whose candidates time faster on
    different ranks."""
    import time

    import elephas_tpu_torch as et
    from elephas_tpu_torch.data.rdd import ShardedDataset
    from elephas_tpu_torch.engine import sync
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh()
    local = (f"winner{rank}", {"rank": rank}, {f"winner{rank}": float(rank)})
    decided = sync.decide_autotune(local, mesh)
    # Rank 0 finds "fast" faster, every other rank "slow".
    slow_here = "slow" if rank == 0 else "fast"
    real_build = sync.build_train_step

    def build(compiled, options=None, pmean_axis=None):
        step = real_build(compiled, None, pmean_axis=pmean_axis)
        if options != {"label": slow_here}:
            return step

        def slow(state, x, y):
            time.sleep(0.003)
            return step(state, x, y)

        return slow

    real_candidates = sync.autotune_candidates
    sync.build_train_step = build
    sync.autotune_candidates = lambda device=None: [("slow", {"label": "slow"}),
                                                    ("fast", {"label": "fast"})]
    try:
        data = np.load(job["data"])
        compiled = et.compile_model(
            get_model("mlp", device="cpu", features=(8,), num_classes=4),
            optimizer={"name": "sgd", "learning_rate": 0.1}, loss="categorical_crossentropy",
            metrics=["acc"], input_shape=(data["x"].shape[1],))
        # 'epoch': no collective inside a step, so each rank's timings are its own.
        trainer = sync.SyncTrainer(compiled, mesh, frequency="epoch", autotune=True)
        trainer.fit(ShardedDataset(data["x"], data["y"], mesh.size), epochs=1, batch_size=8)
    finally:
        sync.build_train_step, sync.autotune_candidates = real_build, real_candidates
    torch.save({"decided": decided, "choice": trainer.autotune_choice},
               f"{job['out']}.rank{rank}")


SEARCH_SPACE = {"lr": ("loguniform", 1e-4, 1e-1), "width": ("choice", [4, 8, 16])}


def search_space():
    from elephas_tpu_torch.hyperparam import hp

    _, lo, hi = SEARCH_SPACE["lr"]
    return {"lr": hp.loguniform(np.log(lo), np.log(hi)),
            "width": hp.choice(SEARCH_SPACE["width"][1])}


def search_data():
    """Seeded Gaussian blobs, 3 classes in 4 dimensions: 128 training
    rows and 32 held out."""
    rng = np.random.default_rng(5)
    centers = rng.normal(scale=3.0, size=(3, 4))
    labels = rng.integers(0, 3, size=160)
    x = (centers[labels] + rng.normal(size=(160, 4))).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[labels]
    return x[:128], y[:128], x[128:], y[128:]


def search_objective(sample, data):
    """A seeded ``mlp_masked`` on the trial's device, trained one epoch
    by a ``SyncTrainer`` on this process's own mesh; the loss is the
    held-out loss, and the winner carries the trained model for the
    ranks that did not hold it to rebuild."""
    import elephas_tpu_torch as et
    from elephas_tpu_torch.data.rdd import ShardedDataset
    from elephas_tpu_torch.engine.sync import SyncTrainer
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel.mesh import build_mesh

    x, y, xv, yv = data
    width = int(sample["width"])
    model = et.compile_model(
        get_model("mlp_masked", features=(16,), active=(width,), num_classes=3,
                  device=et.current_trial_device()),
        optimizer={"name": "adam", "learning_rate": sample["lr"], "injected": True},
        loss="categorical_crossentropy", metrics=["acc"], input_shape=(4,),
        seed=int(1e6 * sample["lr"]))
    trainer = SyncTrainer(model, build_mesh(num_data=1), frequency="batch")
    state, _ = trainer.fit(ShardedDataset(x, y, 1), epochs=1, batch_size=32)
    val = trainer.evaluate_state(state, xv, yv)
    rank = dist.get_rank() if dist.is_initialized() else 0
    return {"loss": float(val["loss"]), "model": model, "built_by_rank": rank}


def _search(job, rank):
    from elephas_tpu_torch.hyperparam import HyperParamModel

    search = HyperParamModel(None, num_workers=job["workers"], device="cpu")
    best = search.minimize(search_objective, search_data, max_evals=job["max_evals"],
                           space=search_space(), seed=job["seed"], algo=job["algo"])
    torch.save({"rank": rank,
                "trials": [(t["worker"], t["trial"], t["sample"], t["loss"])
                           for t in search.trials],
                "best": {k: v for k, v in best.items() if k != "model"},
                "best_weights": best["model"].get_weights(),
                "best_model_is_live": best["model"] is search.best_model()
                and best["built_by_rank"] == rank},
               f"{job['out']}.rank{rank}")


def _search_devices(job, rank):
    """``HyperParamModel(None)`` inside the group, on a faked host of
    ``job["cards"]`` cards whose current card is this rank's: saves the
    devices it takes and the slots of its trials."""
    import contextlib

    from elephas_tpu_torch.hyperparam import HyperParamModel, hp

    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: job["cards"]
    torch.cuda.current_device = lambda: rank
    torch.cuda.device = lambda device: contextlib.nullcontext()  # no card to pin
    search = HyperParamModel(None)
    search.minimize(lambda sample, data: {"loss": float(sample["x"])}, lambda: None,
                    max_evals=job["max_evals"], space={"x": hp.uniform(0, 1)}, seed=0)
    torch.save({"devices": search.devices, "slots": [t["worker"] for t in search.trials]},
               f"{job['out']}.rank{rank}")


def _shard(t, rank, n):
    local = t.shape[2] // n
    return t[:, :, rank * local:(rank + 1) * local]


def fake_kernels(launches):
    """``(owner, name, stand-in)`` patches that put K1-K3 in place on the
    CPU: every input is taken as a kernel input, and each stand-in counts
    its launch in ``launches`` and computes what its kernel computes, in
    the kernels' layout (zero-padded head_dim, the caller's scale), with
    the plain arithmetic."""
    from elephas_tpu_torch.ops import attention as ops
    from elephas_tpu_torch.ops import attention_cuda
    from elephas_tpu_torch.parallel import ring_attention as ra

    def fwd(q, k, v, causal, scale=None):
        launches["flash_fwd"] += 1
        return ops.blockwise_reference(q, k, v, causal, scale=scale)

    def grads(q, k, v, do, lse, delta, causal, scale=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        dtype = q.dtype
        q, k, v, do = (t.float() for t in (q, k, v, do))
        p = torch.exp(scale * q @ k.transpose(-1, -2) - lse[..., None])
        if causal:
            p = p.tril()
        ds = p * (do @ v.transpose(-1, -2) - delta[..., None])
        return tuple(g.to(dtype) for g in (scale * ds @ k, scale * ds.transpose(-1, -2) @ q,
                                           p.transpose(-1, -2) @ do))

    def dq(*args):
        launches["flash_dq"] += 1
        return grads(*args)[0]

    def dkv(*args):
        launches["flash_dkv"] += 1
        return grads(*args)[1:]

    return [(attention_cuda, "flash_fwd", fwd), (attention_cuda, "flash_bwd_dq", dq),
            (attention_cuda, "flash_bwd_dkv", dkv), (ops, "use_kernels", lambda *a: True),
            (ra, "use_kernels", lambda *a: True)]


def _seq_attention(job, rank):
    """Ring and Ulysses attention on a seq mesh of the whole world, on the
    job's global q, k, v and output gradient: each case's global output,
    this rank's shard of dq, dk, dv, and its stand-in kernel launches."""
    from elephas_tpu_torch.parallel import collectives
    from elephas_tpu_torch.parallel.mesh import build_mesh
    from elephas_tpu_torch.parallel.ring_attention import ring_self_attention
    from elephas_tpu_torch.parallel.ulysses import ulysses_self_attention

    n = dist.get_world_size()
    mesh = build_mesh(num_data=1, num_seq=n)
    data = np.load(job["data"])
    q, k, v, do = (torch.from_numpy(data[name]) for name in ("q", "k", "v", "do"))
    launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

    def run(fn):
        before = dict(launches)
        collectives.reset_staged()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        (out * do).sum().backward()
        return {"out": out.detach(), "grads": [_shard(t.grad, rank, n) for t in leaves],
                "launches": {name: launches[name] - before[name] for name in launches},
                "staged_bytes": collectives.staged_bytes}

    results = {}
    for causal in (True, False):
        for impl in ("dense", "flash"):
            results[f"ring-{impl}-{causal}"] = run(
                lambda *t: ring_self_attention(mesh, *t, causal=causal, impl=impl))
        results[f"ulysses-plain-{causal}"] = run(
            lambda *t: ulysses_self_attention(mesh, *t, causal=causal))
    patches = fake_kernels(launches)
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, value in patches:
        setattr(owner, name, value)
    try:
        for causal in (True, False):
            results[f"ring-kernels-{causal}"] = run(
                lambda *t: ring_self_attention(mesh, *t, causal=causal))
            results[f"ulysses-kernels-{causal}"] = run(
                lambda *t: ulysses_self_attention(mesh, *t, causal=causal))
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)
    torch.save(results, f"{job['out']}.rank{rank}")


def _seq_trainer(job, rank):
    """``SeqParallelTrainer`` on a data x seq mesh, per attention: a fit
    with validation, a ragged set evaluated in chunks, whole and at batch
    1, and the same fit in two halves (the second resumed), which must
    follow the straight fit's batch order."""
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel.mesh import build_mesh
    from elephas_tpu_torch.parallel.seq_parallel import SeqParallelTrainer

    mesh = build_mesh(num_data=job["num_data"], num_seq=job["num_seq"])
    data = np.load(job["data"])
    weights = torch.load(job["weights"])
    fit = dict(batch_size=job["batch_size"], seed=job["seed"])
    results = {"mesh": {"data": (mesh.size, mesh.rank), "seq": (mesh.seq_size, mesh.seq_rank),
                        "seq_group": dist.get_process_group_ranks(mesh.seq_group),
                        "data_group": dist.get_process_group_ranks(mesh.group)}}
    for attention in job["attentions"]:
        def compiled():
            return CompiledModel(
                get_model("transformer_lm", device="cpu", attention=attention,
                          **job["kwargs"]),
                weights, optimizer=job["optimizer"],
                loss="sparse_categorical_crossentropy", metrics=[])

        model = compiled()
        trainer = SeqParallelTrainer(model, mesh)
        seen = []
        state, history = trainer.fit(data["tokens"], epochs=job["epochs"],
                                     validation_tokens=data["val"],
                                     val_batch_size=job["val_batch_size"],
                                     callbacks=[lambda e, s, m: seen.append((e, m["loss"]))],
                                     **fit)
        ragged = {str(bs): trainer.evaluate(state, data["ragged"], batch_size=bs)
                  for bs in (job["batch_size"], len(data["ragged"]), 1)}
        twin = compiled()
        halves = SeqParallelTrainer(twin, mesh)
        mid, first = halves.fit(data["tokens"], epochs=1, validation_tokens=data["small_val"],
                                **fit)
        resumed, _ = halves.fit(data["tokens"], epochs=job["epochs"] - 1, initial_state=mid,
                                **fit)
        results[attention] = {"history": history, "step": state.step, "ragged": ragged,
                              "callbacks": seen,
                              "weights": model.get_weights(),
                              "resumed_weights": twin.get_weights(),
                              "resumed_step": resumed.step, "small_val": first}
    torch.save(results, f"{job['out']}.rank{rank}")


def _distributed(job, rank):
    """What ``parallel/distributed.py`` returns in a world of processes."""
    from elephas_tpu_torch.parallel import distributed

    out = {"is_host0": distributed.is_host0(), "total_chips": distributed.total_chips(),
           "host_count": distributed.host_count(),
           "broadcast": distributed.broadcast_from_host0(f"host{rank}:4000"),
           "broadcast_bytes": distributed.broadcast_bytes_from_host0(
               bytes([rank + 1]) * (1000 + rank)),
           "allgather": distributed.allgather_bytes(f"r{rank}".encode() * (rank + 1)),
           "ps_address": distributed.parameter_server_address(4100)}
    if distributed.is_host0():
        try:  # refused before any collective: the other ranks do not join
            distributed.broadcast_from_host0("x" * 65)
        except ValueError as exc:
            out["too_long"] = str(exc)
    distributed.sync_global("elephas:test")
    try:
        distributed.sync_global(f"barrier-{rank}")
    except RuntimeError as exc:
        out["mismatch"] = str(exc)
    torch.save(out, f"{job['out']}.rank{rank}")


def _tp_rules(job):
    from elephas_tpu_torch.parallel.tensor_parallel import P

    if job.get("rules") is None:
        return None
    return tuple((pattern, P(*spec)) for pattern, spec in job["rules"])


def _tp_train(job, rank):
    """A model sharded over the model axis, trained ``steps`` steps on
    the job's global batch: dp x tp through ``make_train_step_tp``, or sp
    x tp (``num_seq`` above 1) through ``seq_parallel``."""
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.checkpoint import CheckpointManager
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel import collectives
    from elephas_tpu_torch.parallel import tensor_parallel as tp
    from elephas_tpu_torch.parallel.mesh import build_mesh
    from elephas_tpu_torch.parallel.seq_parallel import (
        init_lm_state,
        make_lm_train_step,
        shard_lm_batch,
    )

    mesh = build_mesh(num_data=job["num_data"], num_seq=job["num_seq"],
                      num_model=job["num_model"])
    data = np.load(job["data"])
    weights = torch.load(job["weights"])
    rules = _tp_rules(job)

    def compiled():
        return CompiledModel(get_model(job["model"], device="cpu", **job["kwargs"]), weights,
                             optimizer=job["optimizer"], loss=job["loss"],
                             metrics=job["metrics"])

    def trained(model):
        if job["num_seq"] > 1:
            step = make_lm_train_step(model, mesh)
            state = init_lm_state(model, mesh, rules=rules)
            x, y = shard_lm_batch(mesh, data["x"], data["y"])
            return state, lambda s: step(s, x, y)
        step = tp.make_train_step_tp(model, mesh, rules)
        state = tp.init_state_tp(model, mesh, rules=rules)
        return state, lambda s: step(s, data["x"], data["y"])

    launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    patches = fake_kernels(launches) if job.get("kernels") else []
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, value in patches:
        setattr(owner, name, value)
    model = compiled()
    state, run = trained(model)
    metrics, counts = [], []
    collectives.reset_tp_bytes()
    for _ in range(job["steps"]):
        before = dict(launches)
        state, m = run(state)
        metrics.append({k: float(v) for k, v in m.items()})
        counts.append({k: launches[k] - before[k] for k in launches})
    info = tp.tensor_parallel_of(model.module)
    local = {k: v.clone() for k, v in model.module.state_dict().items()}
    result = {
        "metrics": metrics, "launches": counts, "tp_bytes": collectives.tp_bytes,
        "shapes": {k: tuple(v.shape) for k, v in local.items()},
        "sharded": sorted(info.layout),
        "replicated": {k: v for k, v in local.items() if k not in info.layout},
        "full": {k: v.clone() for k, v in info.full_state(model.module.state_dict()).items()},
        "groups": {axis: dist.get_process_group_ranks(group) if group is not None else None
                   for axis, group in (("data", mesh.group), ("seq", mesh.seq_group),
                                       ("model", mesh.model_group))},
        "coords": (mesh.rank, mesh.seq_rank, mesh.model_rank),
    }
    if job.get("checkpoint"):
        manager = CheckpointManager(job["checkpoint"], keep=2)
        manager.save(state, block=True)
        manager.close()
        dist.barrier()  # rank 0 has written
        twin = compiled()
        fresh, run_twin = trained(twin)
        restored = CheckpointManager(job["checkpoint"]).restore(fresh)
        result["restored_step"] = restored.step
        result["restored_equal"] = all(torch.equal(v, local[k])
                                       for k, v in twin.module.state_dict().items())
        _, m_on = run(state)
        _, m_back = run_twin(restored)
        result["resumed"] = (float(m_on["loss"]), float(m_back["loss"]))
        result["resumed_equal"] = all(
            torch.equal(v, twin.module.state_dict()[k])
            for k, v in model.module.state_dict().items())
    for owner, name, value in saved:
        setattr(owner, name, value)
    torch.save(result, f"{job['out']}.rank{rank}")


def _tp_serving(job, rank):
    """The prompts served by an engine sharded over the whole world (rank
    0 serves, the others follow), per pool layout; rank 0 also serves them
    from the unsharded engine. The paged engine then installs the job's
    second weights (rank 0 sends them) and serves the prompts again."""
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel.mesh import build_mesh
    from elephas_tpu_torch.serving import InferenceEngine

    def compiled():  # a fresh model each time: an unsharded engine installs into its own
        return CompiledModel(get_model("transformer_lm", device="cpu", **job["kwargs"]),
                             torch.load(job["weights"]), optimizer="adam",
                             loss="sparse_categorical_crossentropy", metrics=[])

    mesh = build_mesh(num_data=1, num_model=dist.get_world_size())
    result = {}
    for paged in (True, False):
        engine = InferenceEngine(compiled(), paged=paged, **job["engine"])
        engine.shard_serving(mesh)
        key = "paged" if paged else "contiguous"
        result[f"{key}_kv_heads"] = [tuple(k.shape) for k in engine.pool.cache.keys]
        if rank != 0:
            engine.follow()
            result[f"{key}_version"] = engine.model_version
            continue

        def serve(engine):
            ids = [engine.submit(p, max_new_tokens=job["new_tokens"]) for p in job["prompts"]]
            return [engine.result(i, timeout_s=240).tokens for i in ids]

        result[key] = serve(engine)
        result[f"{key}_stats"] = engine.stats()
        if paged:
            engine.install_weights(torch.load(job["installed"]), version=7)
            result["installed"] = serve(engine)
            result[f"{key}_version"] = engine.model_version
        engine.close()
        plain = InferenceEngine(compiled(), paged=paged, **job["engine"])
        result[f"{key}_plain"] = serve(plain)
        if paged:
            plain.install_weights(torch.load(job["installed"]))
            result["installed_plain"] = serve(plain)
    torch.save(result, f"{job['out']}.rank{rank}")


def _async_data():
    rng = np.random.default_rng(0)
    dim, nc, n = 12, 3, 512
    centers = rng.normal(scale=3.0, size=(nc, dim))
    labels = rng.integers(0, nc, size=n)
    x = (centers[labels] + rng.normal(size=(n, dim))).astype(np.float32)
    return x, np.eye(nc, dtype=np.float32)[labels]


def _async_model():
    import elephas_tpu_torch as et
    from elephas_tpu_torch.models import get_model

    return et.compile_model(get_model("mlp", device="cpu", features=(24,), num_classes=3),
                            optimizer={"name": "adam", "learning_rate": 0.01},
                            loss="categorical_crossentropy", metrics=["acc"],
                            input_shape=(12,), seed=0)


def _summing_pushes(sums, counts):
    """Patch the wire clients' push to sum every delta in float64."""
    import threading

    from elephas_tpu_torch.parameter import client as client_mod

    lock = threading.Lock()
    for cls in (client_mod.HttpClient, client_mod.SocketClient):
        real = cls.update_parameters

        def push(self, delta, _real=real):
            host = client_mod.to_host(delta)
            flat = {f"{g}/{n}": t.double().numpy() for g in host for n, t in host[g].items()}
            _real(self, host)
            with lock:
                for name, value in flat.items():
                    sums[name] = sums.get(name, 0.0) + value
                counts[0] += 1

        cls.update_parameters = push


def _async_fit(job, rank):
    import elephas_tpu_torch as et
    from elephas_tpu_torch.engine import async_engine
    from elephas_tpu_torch.parameter.client import make_client

    x, y = _async_data()
    sums, pushes = {}, [0]
    _summing_pushes(sums, pushes)
    # The server's applies chained tree by tree (chip_smoke.ApplyChain).
    from chip_smoke import ApplyChain

    chain = ApplyChain() if rank == 0 else None
    servers, per_worker = [], {}
    real_make_server, real_run_worker = async_engine.make_server, async_engine.AsyncTrainer._run_worker

    def make_server(*args, **kwargs):
        servers.append(real_make_server(*args, **kwargs))
        return servers[-1]

    def run_worker(self, index, *args, **kwargs):
        per_worker[index] = real_run_worker(self, index, *args, **kwargs)
        return per_worker[index]

    async_engine.make_server = make_server
    async_engine.AsyncTrainer._run_worker = run_worker
    timed = [0]
    if job.get("autotune"):
        real_ab = async_engine.autotune_compile_options
        async_engine.autotune_candidates = lambda device=None: [("default", None),
                                                                ("eager_again", None)]

        def ab(*args, **kwargs):
            timed[0] += 1
            return real_ab(*args, **kwargs)

        async_engine.autotune_compile_options = ab
    unauthenticated = []

    def probe(epoch, state, metrics):
        """Rank 0's epoch fire, with the server live: a client without
        the job's key must be refused."""
        if unauthenticated or not servers:
            return
        server = servers[-1]
        client = make_client(job["ps_mode"], f"127.0.0.1:{server.port}")
        client.timeout = 5.0
        try:
            client.get_parameters()
            unauthenticated.append("answered")
        except Exception as exc:
            unauthenticated.append(type(exc).__name__)
        finally:
            if hasattr(client, "close"):
                client.close()

    net = _async_model()
    start = {f"{g}/{n}": t.detach().double().numpy().copy()
             for g, tree in (("params", dict(net.module.named_parameters())),
                             ("batch_stats", dict(net.module.named_buffers())))
             for n, t in tree.items()}
    model = et.SparkModel(net, mode=job["mode"], frequency="epoch",
                          parameter_server_mode=job["ps_mode"], port=0,
                          mesh=["cpu"] * 2, autotune=job.get("autotune", False))
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=job["epochs"], batch_size=16,
                        validation_data=(x[:96], y[:96]),
                        stream_batches=job.get("stream_batches"), callbacks=[probe])
    final = {f"{g}/{n}": t.detach().double().numpy()
             for g, tree in (("params", dict(net.module.named_parameters())),
                             ("batch_stats", dict(net.module.named_buffers())))
             for n, t in tree.items()}
    result = {"weights": model.get_weights(), "history": history, "per_worker": per_worker,
              "sums": sums, "pushes": pushes[0], "start": start, "final": final,
              "version": servers[-1].buffer.version if servers else None,
              "applied": servers[-1].buffer._head[1] if servers else None,
              "unauthenticated": unauthenticated, "timed": timed[0],
              "autotune": model.last_autotune,
              "n_global_workers": model.async_trainer.n_global_workers,
              "workers": [g for g, _ in model.async_trainer.workers],
              "predict": model.predict(x[:128], batch_size=32),
              "evaluate": model.evaluate(x[:96], y[:96], batch_size=32)}
    if chain is not None:
        survivors, result["survivors"] = chain.final(servers[-1].buffer)
        full = {k.split("/", 1)[1]: k for k in start}  # the chain keys by name
        result["survivor_sums"] = {full[k]: v for k, v in survivors.items()}
        result["received"] = {full[k]: v for k, v in chain.received.items()}
    async_engine.make_server, async_engine.AsyncTrainer._run_worker = real_make_server, real_run_worker
    torch.save(result, f"{job['out']}.rank{rank}")


def _async_refusals(job, rank):
    import tempfile

    import elephas_tpu_torch as et
    from elephas_tpu_torch.checkpoint.checkpoint import CheckpointManager
    from elephas_tpu_torch.engine.async_engine import AsyncTrainer

    x, y = _async_data()
    errors = {}
    cases = {
        "local": dict(parameter_server_mode="local"),
        "ps_shards": dict(parameter_server_mode="socket", ps_shards=2),
        "elastic": dict(parameter_server_mode="socket", elastic=True),
    }
    for name, kwargs in cases.items():
        trainer = AsyncTrainer(_async_model(), ["cpu"] * 2, port=0, **kwargs)
        try:
            trainer.fit(et.data.rdd.ShardedDataset(x, y, 2), epochs=1, batch_size=16)
        except ValueError as exc:
            errors[name] = str(exc)
    with tempfile.TemporaryDirectory() as d:
        for host0_only in (False, True):
            trainer = AsyncTrainer(_async_model(), ["cpu"] * 2, port=0,
                                   parameter_server_mode="http")
            manager = CheckpointManager(d, host0_only=host0_only)
            try:
                trainer.fit(et.data.rdd.ShardedDataset(x, y, 2), epochs=1, batch_size=16,
                            callbacks=[manager.callback()])
                manager.wait()
                errors[f"checkpoint_host0_only={host0_only}"] = sorted(os.listdir(d))
            except ValueError as exc:
                errors[f"checkpoint_host0_only={host0_only}"] = str(exc)
    torch.save(errors, f"{job['out']}.rank{rank}")


def _async_death(job, rank):
    import signal
    import time

    import elephas_tpu_torch as et
    from elephas_tpu_torch.engine import async_engine

    x, y = _async_data()
    servers, real_make_server = [], async_engine.make_server

    def make_server(*args, **kwargs):
        servers.append(real_make_server(*args, **kwargs))
        return servers[-1]

    async_engine.make_server = make_server
    if rank == 1:
        from elephas_tpu_torch.parameter import client as client_mod

        for cls in (client_mod.HttpClient, client_mod.SocketClient):
            real = cls.update_parameters

            def push(self, delta, _real=real):
                _real(self, delta)
                os.kill(os.getpid(), signal.SIGKILL)  # dies after its first push

            cls.update_parameters = push
    model = et.SparkModel(_async_model(), mode="asynchronous", frequency="epoch",
                          parameter_server_mode=job["ps_mode"], port=0, mesh=["cpu"] * 2)
    t0 = time.monotonic()
    try:
        model.fit(et.to_simple_rdd(None, x, y), epochs=job["epochs"], batch_size=16)
        out = {"error": None}
    except Exception as exc:
        out = {"error": type(exc).__name__, "message": str(exc)}
    out.update(seconds=time.monotonic() - t0,
               server_stopped=bool(servers) and servers[-1]._server is None)
    torch.save(out, f"{job['out']}.rank{rank}")
    os._exit(0)  # the group has a dead member: skip its teardown


def main(config_path, rank):
    with open(config_path) as f:
        config = json.load(f)
    if config.get("init") == "initialize":
        from elephas_tpu_torch.parallel import distributed

        distributed.initialize(f"file://{config['store']}", config["world"], rank,
                               heartbeat_timeout=120, backend="gloo")
    else:
        dist.init_process_group("gloo", init_method=f"file://{config['store']}",
                                world_size=config["world"], rank=rank)
    try:
        for job in config["jobs"]:
            {"search": _search, "autotune": _autotune,
             "search_devices": _search_devices, "seq_attention": _seq_attention,
             "seq_trainer": _seq_trainer, "tp_train": _tp_train,
             "tp_serving": _tp_serving, "async_fit": _async_fit,
             "async_refusals": _async_refusals, "async_death": _async_death,
             "distributed": _distributed}.get(job.get("kind"), _run)(job, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
