"""Parity of the port's sequence parallelism (``elephas_tpu_torch.parallel``:
``ring_attention``, ``ulysses``, ``seq_parallel``, ``distributed``) with
the JAX package's, on the CPU.

The JAX side runs on the virtual CPU devices (a seq mesh of 4, a data 2 x
seq 2 mesh); the port runs the same meshes as gloo processes
(``tests/test_torch_dist_worker.py``, spawned once per world here and
read by every test): a world of 4 for the attention and the trainer, a
world of 2, joined through ``parallel.distributed.initialize``, for the
control-plane collectives. Inputs come from NumPy seeds; the trainer
starts both packages from the flax init (``convert.from_flax_params``).

Limits: attention outputs and dq/dk/dv within 1e-5; the trainer's loss
and val_loss history within 1e-5, its weights within 1e-4 of each
tensor's norm, the key third of each qkv bias left out (its exact
gradient is 0, so Adam moves it by lr * sign(rounding noise), on each
side its own; ``test_torch_train.py::_assert_params``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.parallel import distributed as jax_distributed
from elephas_tpu.parallel.mesh import build_mesh as jax_build_mesh
from elephas_tpu.parallel.ring_attention import ring_self_attention as jax_ring
from elephas_tpu.parallel.seq_parallel import SeqParallelTrainer as JaxSeqParallelTrainer
from elephas_tpu.parallel.ulysses import ulysses_self_attention as jax_ulysses
from elephas_tpu_torch.api import CompiledModel
from elephas_tpu_torch.convert import from_flax_params
from elephas_tpu_torch.engine import step as port_step
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.models import transformer as port_transformer
from elephas_tpu_torch.ops import attention as ops
from elephas_tpu_torch.parallel import collectives
from elephas_tpu_torch.parallel import distributed
from elephas_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    bind_mesh,
    build_mesh,
)
from elephas_tpu_torch.parallel.seq_parallel import SeqParallelTrainer, shard_lm_batch
from elephas_tpu_torch.parallel.ulysses import ulysses_attention

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "test_torch_dist_worker.py"
N = 4                                   # the seq mesh of the attention runs
ATTN_SHAPE = (2, 4, 32, 8)              # (batch, heads, seq, head_dim), global
LM = dict(vocab_size=128, d_model=64, num_heads=4, num_layers=2, max_seq_len=64)
SEQ = LM["max_seq_len"]
ADAM = {"name": "adam", "learning_rate": 1e-2}
FIT = dict(epochs=2, batch_size=8, val_batch_size=4, seed=3)
ATTENTIONS = ("ring", "auto")           # 'auto' is Ulysses at 4 heads over seq 2
TOL = 1e-5


class _World:
    """``jobs`` in ``world`` gloo processes, started at once and read
    when a test first needs them."""

    def __init__(self, tmp, world, jobs, init=None, timeout=300):
        self.tmp, self.world, self.jobs, self.timeout = tmp, world, jobs, timeout
        config = tmp / "config.json"
        config.write_text(json.dumps({"store": str(tmp / "store"), "world": world,
                                      "jobs": jobs, "init": init}))
        env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
               "GLOO_SOCKET_IFNAME": "lo"}
        self.logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
        self.procs = [subprocess.Popen([sys.executable, str(WORKER), str(config), str(r)],
                                       env=env, stdout=self.logs[r],
                                       stderr=subprocess.STDOUT, cwd=ROOT)
                      for r in range(world)]
        self._results = None

    def results(self):
        """Per job, the list of every rank's saved results."""
        if self._results is None:
            try:
                codes = [p.wait(timeout=self.timeout) for p in self.procs]
            finally:
                self.close()
            assert codes == [0] * self.world, [
                (self.tmp / f"rank{r}.log").read_text()[-3000:] for r in range(self.world)]
            self._results = [[torch.load(f"{job['out']}.rank{r}", weights_only=False)
                              for r in range(self.world)] for job in self.jobs]
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for f in self.logs:
            f.close()


def _attention_inputs():
    rng = np.random.default_rng(0)
    return {name: rng.standard_normal(ATTN_SHAPE).astype(np.float32)
            for name in ("q", "k", "v", "do")}


def _lm_data():
    rng = np.random.default_rng(11)
    return {"tokens": rng.integers(0, LM["vocab_size"], (16, SEQ + 1)),
            "val": rng.integers(0, LM["vocab_size"], (6, SEQ + 1)),
            "ragged": rng.integers(0, LM["vocab_size"], (10, SEQ + 1)),
            "small_val": rng.integers(0, LM["vocab_size"], (4, SEQ + 1))}


@pytest.fixture(scope="module")
def flax_params():
    jm = JaxCompiledModel(jax_get_model("transformer_lm", **LM), None, input_shape=(SEQ,),
                          input_dtype=jnp.int32, seed=0)
    return jax.device_get(jm.params)


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory, flax_params):
    """The port's two spawned worlds, started before any JAX reference is
    computed so that both run at once."""
    tmp = tmp_path_factory.mktemp("seq_parallel")
    np.savez(tmp / "attention.npz", **_attention_inputs())
    np.savez(tmp / "lm.npz", **{k: v.astype(np.int64) for k, v in _lm_data().items()})
    module = get_model("transformer_lm", device="cpu", **LM)
    torch.save(from_flax_params(flax_params, module), tmp / "lm.pt")
    for name in ("four", "two"):
        (tmp / name).mkdir()
    four = _World(tmp / "four", N, [
        {"kind": "seq_attention", "data": str(tmp / "attention.npz"),
         "out": str(tmp / "attention.out")},
        {"kind": "seq_trainer", "data": str(tmp / "lm.npz"), "weights": str(tmp / "lm.pt"),
         "num_data": 2, "num_seq": 2, "attentions": list(ATTENTIONS), "kwargs": LM,
         "optimizer": ADAM, "epochs": FIT["epochs"], "batch_size": FIT["batch_size"],
         "val_batch_size": FIT["val_batch_size"], "seed": FIT["seed"],
         "out": str(tmp / "trainer.out")}])
    two = _World(tmp / "two", 2, [{"kind": "distributed", "out": str(tmp / "dist.out")}],
                 init="initialize")
    yield {"four": four, "two": two}
    four.close()
    two.close()


@pytest.fixture(scope="module")
def attention_runs(worlds):
    return worlds["four"].results()[0]


@pytest.fixture(scope="module")
def trainer_runs(worlds):
    return worlds["four"].results()[1]


@pytest.fixture(scope="module")
def dist_runs(worlds):
    return worlds["two"].results()[0]


# -- ring and Ulysses attention against the JAX package -----------------------------


@pytest.fixture(scope="module")
def jax_attention():
    """The JAX package's outputs and dq/dk/dv on a seq mesh of 4, by
    (layout, causal): ring 'dense' and 'flash' (its off-TPU pair kernels),
    and Ulysses."""
    data = {k: jnp.asarray(v) for k, v in _attention_inputs().items()}
    mesh = jax_build_mesh(num_data=1, num_seq=N)
    out = {}
    for causal in (True, False):
        for name, fn in (("ring-dense", lambda *t: jax_ring(mesh, *t, causal=causal,
                                                              impl="dense")),
                         ("ring-flash", lambda *t: jax_ring(mesh, *t, causal=causal,
                                                              impl="flash")),
                         ("ulysses", lambda *t: jax_ulysses(mesh, *t, causal=causal))):
            def loss(q, k, v):
                o = fn(q, k, v)
                return (o * data["do"]).sum(), o

            (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
                data["q"], data["k"], data["v"])
            out[f"{name}-{causal}"] = {"out": np.asarray(o),
                                       "grads": [np.asarray(g) for g in grads]}
    return out


def _assert_attention(ranks, want):
    for rank in ranks:  # every rank holds the global output
        np.testing.assert_allclose(rank["out"].numpy(), want["out"], atol=TOL, rtol=TOL)
    for i, name in enumerate(("dq", "dk", "dv")):
        got = torch.cat([rank["grads"][i] for rank in ranks], dim=2).numpy()
        np.testing.assert_allclose(got, want["grads"][i], atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl,reference", [("dense", "ring-dense"), ("flash", "ring-flash"),
                                            ("kernels", "ring-flash")])
def test_ring_attention_matches_jax(jax_attention, attention_runs, impl, reference, causal):
    """The dense ring, the flash ring on the plain hop versions, and the
    flash ring through stand-ins of K1-K3 (every input taken as a kernel
    input, head_dim 8 padded to 32 at the scale of 8) against JAX's ring."""
    _assert_attention([r[f"ring-{impl}-{causal}"] for r in attention_runs],
                      jax_attention[f"{reference}-{causal}"])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_ulysses_attention_matches_jax(jax_attention, attention_runs, route, causal):
    _assert_attention([r[f"ulysses-{route}-{causal}"] for r in attention_runs],
                      jax_attention[f"ulysses-{causal}"])


@pytest.mark.parametrize("causal", [True, False])
def test_ring_hop_schedule_launches(attention_runs, causal):
    """Rank r launches K1, K2 and K3 once for each hop it folds: 1 + r
    causal (its own shard and the r earlier ones; later owners launch
    nothing), n full; the plain paths launch none."""
    for rank, run in enumerate(attention_runs):
        want = 1 + rank if causal else N
        assert run[f"ring-kernels-{causal}"]["launches"] == {
            "flash_fwd": want, "flash_dq": want, "flash_dkv": want}
        for plain in ("ring-dense", "ring-flash", "ulysses-plain"):
            assert set(run[f"{plain}-{causal}"]["launches"].values()) == {0}


def test_ulysses_launches_one_of_each_kernel_a_rank(attention_runs):
    for run in attention_runs:
        for causal in (True, False):
            assert run[f"ulysses-kernels-{causal}"]["launches"] == {
                "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}


def test_ulysses_indivisible_heads_raises():
    q = torch.zeros((1, 6, 8, 4))
    with bind_mesh(Mesh(seq_size=4)), pytest.raises(ValueError, match=r"num_heads \(6\)"):
        ulysses_attention(q, q, q)


def test_ulysses_on_one_rank_is_flash_attention():
    q, k, v, _ = (torch.from_numpy(a) for a in _attention_inputs().values())
    with bind_mesh(build_mesh(num_data=1)):
        got = ulysses_attention(q, k, v)
    assert torch.equal(got, ops.flash_attention(q, k, v))


def test_pack_keeps_every_tensor_aligned_and_bitwise():
    parts = (torch.arange(5, dtype=torch.bfloat16), torch.randn(3, 7),
             torch.arange(3, dtype=torch.int64))
    message = collectives._pack(parts)
    assert message.numel() % 16 == 0
    for got, want in zip(collectives._unpack(message, parts), parts):
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert got.data_ptr() % 16 == 0


def test_cpu_exchanges_stage_nothing(attention_runs):
    """Only CUDA tensors of a gloo group go through the host: the ring's
    hops of CPU tensors stage no byte."""
    for run in attention_runs:
        for case in run.values():
            assert case["staged_bytes"] == 0


# -- the model's wiring ------------------------------------------------------------


@pytest.mark.parametrize("heads,picked", [(6, "ring"), (4, "ulysses")])
def test_auto_attention_picks_the_layout_from_the_mesh(monkeypatch, heads, picked):
    """'auto' inside a bound mesh of seq 4: Ulysses where the heads divide
    4, the ring where they do not; 'flash' outside one (the JAX package's
    ``test_auto_attention_picks_*``)."""
    calls = []

    def layout(name):
        def attend(q, k, v, causal=True):
            calls.append(name)
            return q

        return attend

    monkeypatch.setattr(port_transformer, "ring_attention", layout("ring"))
    monkeypatch.setattr(port_transformer, "ulysses_attention", layout("ulysses"))
    module = get_model("transformer_lm", device="cpu", attention="auto", vocab_size=32,
                       d_model=4 * heads, num_heads=heads, num_layers=1, max_seq_len=32)
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    with bind_mesh(Mesh(seq_size=4, seq_rank=1)):
        module(tokens)
        # This rank's shard reads the positional table at global positions.
        assert torch.equal(module._positions(8), module.pos_embed[8:16])
    assert calls == [picked]
    module(tokens)
    assert calls == [picked]  # outside the mesh: flash, no layout called


def test_make_train_step_averages_over_named_axes(flax_params):
    """``pmean_axis=(DATA_AXIS, SEQ_AXIS)`` or ``(DATA_AXIS, MODEL_AXIS)``
    in a bound one-process mesh is the plain step; an axis the mesh does
    not have raises."""
    tokens = torch.from_numpy(_lm_data()["tokens"][:2])

    def run(axis):
        module = get_model("transformer_lm", device="cpu", **LM)
        compiled = CompiledModel(module, from_flax_params(flax_params, module),
                                 optimizer=ADAM, loss="sparse_categorical_crossentropy",
                                 metrics=[])
        state = port_step.init_train_state(compiled)
        with bind_mesh(Mesh()):
            _, metrics = port_step.make_train_step(compiled, pmean_axis=axis)(
                state, tokens[:, :-1], tokens[:, 1:])
        return float(metrics["loss"]), compiled.get_weights()

    plain, joint = run(None), run((DATA_AXIS, SEQ_AXIS))
    assert plain[0] == joint[0]
    assert all(torch.equal(v, joint[1][k]) for k, v in plain[1].items())
    # The model axis (tensor parallelism) is an axis like the others now.
    model = run((DATA_AXIS, MODEL_AXIS))
    assert plain[0] == model[0]
    assert all(torch.equal(v, model[1][k]) for k, v in plain[1].items())
    with pytest.raises(ValueError, match="unknown mesh axes"):
        port_step.make_train_step(None, pmean_axis=("rows",))


@pytest.mark.parametrize("make", [port_step.make_train_step, port_step.make_eval_step])
def test_seq_axis_outside_a_bound_mesh_raises(flax_params, make):
    """Averaging over the seq axis outside a bound mesh raises, as
    ``lax.pmean`` does on an unbound axis name, instead of averaging
    nothing and leaving each rank on its own; the data axis alone still
    means every process."""
    tokens = torch.from_numpy(_lm_data()["tokens"][:2])
    module = get_model("transformer_lm", device="cpu", **LM)
    compiled = CompiledModel(module, from_flax_params(flax_params, module), optimizer=ADAM,
                             loss="sparse_categorical_crossentropy", metrics=[])
    state = port_step.init_train_state(compiled)
    args = (state, tokens[:, :-1], tokens[:, 1:])
    with pytest.raises(NameError, match="unbound axis name: seq"):
        make(compiled, pmean_axis=(DATA_AXIS, SEQ_AXIS))(*args)
    make(compiled, pmean_axis=DATA_AXIS)(*args)


def test_model_axis_and_rules_are_left_out():
    """Ported since: a model axis needs a world of its size (the
    tensor-parallel tests run it), rules on a mesh whose model axis is 1
    shard nothing, and a model axis above 1 shards the module by them."""
    with pytest.raises(ValueError, match="needs a world of 2"):
        build_mesh(num_data=1, num_model=2)
    model = CompiledModel(get_model("transformer_lm", device="cpu", **LM),
                          loss="sparse_categorical_crossentropy", metrics=[])
    assert SeqParallelTrainer(model, Mesh(), rules=[]).rules == []
    assert getattr(model.module, "_tensor_parallel", None) is None
    with pytest.raises(ValueError, match="shard NO parameter"):
        SeqParallelTrainer(model, Mesh(model_size=2), rules=[])


def test_shard_lm_batch_takes_this_ranks_block():
    tokens = np.arange(8 * 12).reshape(8, 12)
    x, y = shard_lm_batch(Mesh(size=2, rank=1, seq_size=3, seq_rank=2), tokens, -tokens)
    assert x.dtype == torch.int64
    assert torch.equal(x, torch.as_tensor(tokens[4:8, 8:12]))
    assert torch.equal(y, -x)


# -- the trainer against the JAX package ----------------------------------------------


@pytest.fixture(scope="module")
def jax_fits(flax_params):
    """JAX's SeqParallelTrainer on a data 2 x seq 2 mesh, per attention:
    the fit with validation and the ragged evaluations."""
    data = {k: v.astype(np.int32) for k, v in _lm_data().items()}
    out = {}
    for attention in ATTENTIONS:
        jm = JaxCompiledModel(jax_get_model("transformer_lm", attention=attention, **LM),
                              flax_params, optimizer=ADAM,
                              loss="sparse_categorical_crossentropy", metrics=[],
                              input_shape=(SEQ,), input_dtype=jnp.int32, seed=0)
        trainer = JaxSeqParallelTrainer(jm, jax_build_mesh(num_data=2, num_seq=2))
        state, history = trainer.fit(data["tokens"], validation_tokens=data["val"], **FIT)
        out[attention] = {
            "history": history, "params": jax.device_get(state.params),
            "ragged": {bs: trainer.evaluate(state, data["ragged"], batch_size=bs)
                       for bs in (FIT["batch_size"], len(data["ragged"]))}}
    return out


def _assert_weights(port, jax_params):
    module = get_model("transformer_lm", device="cpu", **LM)
    want = from_flax_params(jax_params, module)
    for name, value in port.items():
        got, ref = value.numpy(), want[name].numpy()
        if name.endswith("attn.qkv.bias"):
            third = slice(len(got) // 3, 2 * len(got) // 3)
            got, ref = np.delete(got, third), np.delete(ref, third)
        assert np.linalg.norm(got - ref) <= 1e-4 * np.linalg.norm(ref), name


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_trainer_fit_matches_jax(jax_fits, trainer_runs, attention):
    want = jax_fits[attention]
    for run in trainer_runs:
        got = run[attention]
        assert got["history"].keys() == want["history"].keys() == {"loss", "val_loss"}
        for key in ("loss", "val_loss"):
            np.testing.assert_allclose(got["history"][key], want["history"][key],
                                       rtol=TOL, atol=TOL, err_msg=key)
        assert got["step"] == FIT["epochs"] * 2
        # The callbacks see each epoch once, with the epoch's mean loss.
        assert got["callbacks"] == list(enumerate(got["history"]["loss"]))
        _assert_weights(got["weights"], want["params"])
    first = trainer_runs[0][attention]["weights"]
    for run in trainer_runs[1:]:  # replicated: every rank holds the same weights
        assert all(torch.equal(v, run[attention]["weights"][k]) for k, v in first.items())


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_trainer_resume_continues_the_shuffle(trainer_runs, attention):
    """A 1+1-epoch resumed fit follows the straight 2-epoch fit's batch
    order: equal weights to the bit."""
    for run in trainer_runs:
        got = run[attention]
        assert got["resumed_step"] == got["step"]
        assert all(torch.equal(v, got["resumed_weights"][k]) for k, v in got["weights"].items())


@pytest.mark.parametrize("attention", ATTENTIONS)
def test_trainer_small_and_ragged_validation(jax_fits, trainer_runs, attention):
    """A validation set under batch_size does not abort the fit; a ragged
    set evaluates the same in chunks, whole and at batch 1 (clamped up to
    the data axis), and as the JAX package's."""
    want = jax_fits[attention]["ragged"]
    for run in trainer_runs:
        got = run[attention]
        assert len(got["small_val"]["val_loss"]) == 1
        whole = got["ragged"]["10"]["loss"]
        for bs in ("8", "1"):
            np.testing.assert_allclose(got["ragged"][bs]["loss"], whole, rtol=TOL)
        for bs, metrics in want.items():
            np.testing.assert_allclose(got["ragged"][str(bs)]["loss"], metrics["loss"],
                                       rtol=TOL)


def test_trainer_validates_divisibility():
    trainer = SeqParallelTrainer(CompiledModel(
        get_model("transformer_lm", device="cpu", **LM), loss="sparse_categorical_crossentropy",
        metrics=[]), Mesh(size=2, seq_size=4))
    tokens = np.zeros((8, SEQ + 1), dtype=np.int64)
    with pytest.raises(ValueError, match="divide by the data-axis"):
        trainer.fit(tokens, batch_size=3)
    with pytest.raises(ValueError, match="divide"):
        trainer.fit(np.zeros((8, 31), dtype=np.int64), batch_size=2)
    with pytest.raises(ValueError, match="rows < batch_size"):
        trainer.fit(tokens, batch_size=16)


def test_mesh_lays_ranks_out_as_jax(trainer_runs):
    """Rank = d * S + s on a data 2 x seq 2 mesh, as the JAX package's
    ``devices.reshape(num_data, num_seq, num_model)``: the seq group is
    one data index's ranks, the data group one seq index's."""
    grid = np.arange(N).reshape(2, 2, 1)
    for rank, run in enumerate(trainer_runs):
        d, s, _ = np.argwhere(grid == rank)[0]
        assert run["mesh"] == {"data": (2, d), "seq": (2, s),
                               "seq_group": grid[d, :, 0].tolist(),
                               "data_group": grid[:, s, 0].tolist()}


# -- parallel/distributed.py ---------------------------------------------------------


def test_distributed_is_a_no_op_in_one_process():
    """Alone, every call returns what the JAX package's returns in one
    process."""
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.is_host0() == jax_distributed.is_host0() is True
    assert distributed.host_count() == jax_distributed.host_count() == 1
    assert distributed.broadcast_from_host0("a:1") == jax_distributed.broadcast_from_host0("a:1")
    payload = bytes(range(256)) * 3
    assert distributed.broadcast_bytes_from_host0(payload) == payload
    assert distributed.allgather_bytes(payload) == jax_distributed.allgather_bytes(payload)
    distributed.sync_global("x")
    assert distributed.parameter_server_address(4100) == \
        jax_distributed.parameter_server_address(4100)
    assert distributed.total_chips() == 1


def test_distributed_world_of_two(dist_runs):
    """Process 0's strings and bytes reach every process; every process
    gathers every process's bytes in rank order; a barrier reached under
    different tags raises on every process; process 0 refuses an address
    longer than the frame."""
    for rank, got in enumerate(dist_runs):
        assert got["is_host0"] == (rank == 0)
        assert got["total_chips"] == 2 and got["host_count"] == 1
        assert got["broadcast"] == "host0:4000"
        assert got["broadcast_bytes"] == b"\x01" * 1000
        assert got["allgather"] == [b"r0", b"r1r1"]
        assert got["ps_address"] == dist_runs[0]["ps_address"]
        assert got["ps_address"].endswith(":4100")
        assert "different barriers" in got["mismatch"]
    assert "payload too long" in dist_runs[0]["too_long"]
    assert "too_long" not in dist_runs[1]
