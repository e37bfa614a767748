"""Parity of the port's tensor parallelism (``elephas_tpu_torch.parallel.
tensor_parallel``, the model axis of ``parallel.mesh``, sp x tp in
``seq_parallel``, tensor-parallel checkpoints) with the JAX package's, on
the CPU.

The JAX side runs on the virtual CPU devices; the port runs the same
meshes as gloo processes (``tests/test_torch_dist_worker.py``, spawned
once per world here and read by every test): a world of 2 (model 2: the
LM through stand-ins of K1-K3 that count their launches, a checkpoint,
and the MLP and masked MLP under a user's rules) and a world of 4 (data 2 x model 2, and
data 1 x seq 2 x model 2 with the ring). Both packages start from the
flax init (``convert.from_flax_params``).

Limits: first-step and later losses within 1e-5 (relative); parameters
after 3 Adam steps within 1e-5, the key third of each qkv bias within
lr-sized noise (``test_torch_train.py::_assert_params``); replicated
parameters bitwise equal across the model ranks.
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
from jax.sharding import PartitionSpec as JaxP

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.parallel import seq_parallel as jax_seq_parallel
from elephas_tpu.parallel import tensor_parallel as jax_tp
from elephas_tpu.parallel.mesh import build_mesh as jax_build_mesh
from elephas_tpu_torch.api import CompiledModel
from elephas_tpu_torch.checkpoint import CheckpointManager
from elephas_tpu_torch.convert import from_flax_params
from elephas_tpu_torch.engine.step import init_train_state
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parallel import tensor_parallel as tp
from elephas_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    build_mesh,
)
from tests.test_torch_train import _assert_params

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "test_torch_dist_worker.py"
LM = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, max_seq_len=32)
SPTP = dict(vocab_size=64, d_model=16, num_heads=2, num_layers=1, max_seq_len=16)
MLP = dict(features=(32,), num_classes=4)
# 20 live units of 32: over model 2, rank 1's half holds 4 live ones
MLPS = {"mlp": MLP, "mlp_masked": dict(MLP, active=(20,))}
MLP_RULES = ((r".*Dense_0/kernel$", (None, MODEL_AXIS)),   # column-parallel
             (r".*Dense_0/bias$", (MODEL_AXIS,)),
             (r".*Dense_1/kernel$", (MODEL_AXIS, None)))   # row-parallel
ADAM = {"name": "adam", "learning_rate": 1e-3}
SGD = {"name": "sgd", "learning_rate": 0.1}
STEPS = 3
TOL = 1e-5
NOISE = 2 * STEPS * ADAM["learning_rate"]
# the dp x tp runs of the LM: name -> (world, (data, seq, model))
RUNS = {"model2": ("two", (1, 1, 2)), "data2_model2": ("four", (2, 1, 2))}


def _jax_lm(config, attention="dense", params=None):
    return JaxCompiledModel(jax_get_model("transformer_lm", attention=attention, **config),
                            params, optimizer=ADAM, loss="sparse_categorical_crossentropy",
                            metrics=[], input_shape=(config["max_seq_len"],),
                            input_dtype=jnp.int32, seed=0)


def _jax_mlp(params=None, model="mlp", batch_stats=None):
    return JaxCompiledModel(jax_get_model(model, **MLPS[model]), params, optimizer=SGD,
                            loss="categorical_crossentropy", metrics=["acc"],
                            input_shape=(16,), seed=0, batch_stats=batch_stats)


def _tokens(config, rows, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, config["vocab_size"], (rows, config["max_seq_len"] + 1))
    return tokens[:, :-1], tokens[:, 1:]


def _mlp_data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    return x, np.eye(4, dtype=np.float32)[rng.integers(0, 4, size=8)]


def _rules(table):
    return tuple((pattern, JaxP(*spec)) for pattern, spec in table)


class _World:
    """``jobs`` in ``world`` gloo processes, started at once and read
    when a test first needs them."""

    def __init__(self, tmp, world, jobs, timeout=300):
        self.tmp, self.world, self.jobs, self.timeout = tmp, world, jobs, timeout
        config = tmp / "config.json"
        config.write_text(json.dumps({"store": str(tmp / "store"), "world": world,
                                      "jobs": jobs}))
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


@pytest.fixture(scope="module")
def flax():
    return {"lm": jax.device_get(_jax_lm(LM).params),
            "sptp": jax.device_get(_jax_lm(SPTP).params),
            **{model: jax.device_get(_jax_mlp(model=model).params) for model in MLPS},
            "mask": jax.device_get(_jax_mlp(model="mlp_masked").batch_stats)}


def _lm_job(tmp, name, mesh, config, weights, data, **extra):
    return {"kind": "tp_train", "model": "transformer_lm", "kwargs": config,
            "weights": str(weights), "data": str(data), "num_data": mesh[0],
            "num_seq": mesh[1], "num_model": mesh[2], "optimizer": ADAM,
            "loss": "sparse_categorical_crossentropy", "metrics": ["acc"], "steps": STEPS,
            "out": str(tmp / f"{name}.out"), **extra}


@pytest.fixture(scope="module", autouse=True)
def worlds(tmp_path_factory, flax):
    """The port's two spawned worlds, started before any JAX reference is
    computed so that they run at once."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    files = {}
    for name, config, module in (("lm", LM, get_model("transformer_lm", device="cpu", **LM)),
                                 ("sptp", SPTP,
                                  get_model("transformer_lm", device="cpu", **SPTP))):
        torch.save(from_flax_params(flax[name], module), tmp / f"{name}.pt")
        x, y = _tokens(config, 8 if name == "lm" else 4, 1)
        np.savez(tmp / f"{name}.npz", x=x, y=y)
        files[name] = (tmp / f"{name}.pt", tmp / f"{name}.npz")
    for model, kwargs in MLPS.items():
        mlp = get_model(model, device="cpu", **kwargs)
        mlp(torch.zeros((1, 16)))  # the lazy first layer takes its shape
        stats = flax["mask"] if model == "mlp_masked" else None
        torch.save(from_flax_params(flax[model], mlp, stats), tmp / f"{model}.pt")
    x, y = _mlp_data()
    np.savez(tmp / "mlp.npz", x=x, y=y)
    for name in ("two", "four"):
        (tmp / name).mkdir()
    two = _World(tmp / "two", 2, [
        _lm_job(tmp / "two", "model2", RUNS["model2"][1], {**LM, "attention": "flash"},
                *files["lm"], kernels=True, checkpoint=str(tmp / "two" / "ckpt")),
        *({"kind": "tp_train", "model": model, "kwargs": kwargs,
           "weights": str(tmp / f"{model}.pt"), "data": str(tmp / "mlp.npz"), "num_data": 1,
           "num_seq": 1, "num_model": 2, "optimizer": SGD, "loss": "categorical_crossentropy",
           "metrics": ["acc"], "steps": 5, "rules": [list(r) for r in MLP_RULES],
           "out": str(tmp / "two" / f"{model}.out")} for model, kwargs in MLPS.items())])
    four = _World(tmp / "four", 4, [
        _lm_job(tmp / "four", "data2_model2", RUNS["data2_model2"][1],
                {**LM, "attention": "flash"}, *files["lm"], kernels=True),
        _lm_job(tmp / "four", "sptp", (1, 2, 2), {**SPTP, "attention": "ring"},
                *files["sptp"])])
    yield {"two": two, "four": four, "tmp": tmp}
    two.close()
    four.close()


@pytest.fixture(scope="module")
def runs(worlds):
    two, four = worlds["two"].results(), worlds["four"].results()
    return {"model2": two[0], "mlp": two[1], "mlp_masked": two[2], "data2_model2": four[0],
            "sptp": four[1]}


# -- the rule tables and their torch layout ---------------------------------------


def test_lm_rules_equal_the_jax_table():
    assert len(tp.LM_RULES) == len(jax_tp.LM_RULES)
    for (pattern, spec), (want_pattern, want_spec) in zip(tp.LM_RULES, jax_tp.LM_RULES):
        assert pattern == want_pattern and tuple(spec) == tuple(want_spec)
    assert tp._LM_RULES is tp.LM_RULES


def _flat_specs(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat_specs(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = tuple(value)
    return out


@pytest.mark.parametrize("kind", ["lm", "mlp"])
def test_specs_of_every_leaf_match_jax(flax, kind):
    """The port's specs over its module's flax paths equal JAX's
    ``lm_param_specs``/``param_specs`` over the flax tree, leaf for leaf."""
    if kind == "lm":
        module = get_model("transformer_lm", device="cpu", **LM)
        got, want = tp.lm_param_specs(module), jax_tp.lm_param_specs(flax["lm"])
    else:
        module = get_model("mlp", device="cpu", **MLP)
        module(torch.zeros((1, 16)))
        got = tp.param_specs(module, tp_rules())
        want = jax_tp.param_specs(flax["mlp"], _rules(MLP_RULES))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec) for path, spec in
            jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, JaxP))[0]}
    assert _flat_specs(got) == want
    # The flax tree itself gives the same specs.
    assert _flat_specs(tp.param_specs(flax[kind], None if kind == "lm" else tp_rules())) == want


def tp_rules():
    return tuple((pattern, tp.P(*spec)) for pattern, spec in MLP_RULES)


def test_torch_layout_of_the_lm():
    """Column-parallel kernels on torch dim 0, row-parallel on dim 1, the
    qkv weight and bias by heads of their (3, H, hd) view, the embedding
    by vocabulary rows; nothing else sharded."""
    module = get_model("transformer_lm", device="cpu", **LM)
    heads = (3, LM["num_heads"], LM["d_model"] // LM["num_heads"])
    want = {"tok_embed.weight": tp.Shard(0), "lm_head.weight": tp.Shard(0),
            "lm_head.bias": tp.Shard(0)}
    for i in range(LM["num_layers"]):
        want.update({f"blocks.{i}.attn.qkv.weight": tp.Shard(0, heads),
                     f"blocks.{i}.attn.qkv.bias": tp.Shard(0, heads),
                     f"blocks.{i}.attn.out.weight": tp.Shard(1),
                     f"blocks.{i}.fc1.weight": tp.Shard(0), f"blocks.{i}.fc1.bias": tp.Shard(0),
                     f"blocks.{i}.fc2.weight": tp.Shard(1)})
    assert tp.resolve_layout(module) == want


@pytest.mark.parametrize("rank", [0, 1])
def test_qkv_shard_is_the_heads_of_the_flax_kernel(flax, rank):
    """A rank's qkv rows are ``weight.view(3, H, hd, d)[:, heads]`` — the
    flax kernel's heads (d, 3, H, hd)[:, :, heads] — not a third of 3d
    rows; every shard holds its H/M heads and V/M vocabulary rows."""
    module = get_model("transformer_lm", device="cpu", **LM)
    module.load_state_dict(from_flax_params(flax["lm"], module))
    tp.shard_module(module, Mesh(model_size=2, model_rank=rank))
    h, hd, d = LM["num_heads"] // 2, LM["d_model"] // LM["num_heads"], LM["d_model"]
    kernel = flax["lm"]["Block_0"]["SelfAttention_0"]["qkv"]["kernel"]  # (d, 3, H, hd)
    want = kernel[:, :, rank * h:(rank + 1) * h].reshape(d, -1).T
    np.testing.assert_array_equal(module.blocks[0].attn.qkv.weight.detach().numpy(), want)
    bias = flax["lm"]["Block_0"]["SelfAttention_0"]["qkv"]["bias"]
    np.testing.assert_array_equal(module.blocks[0].attn.qkv.bias.detach().numpy(),
                                  bias[:, rank * h:(rank + 1) * h].reshape(-1))
    assert module.local_heads == module.blocks[0].attn.local_heads == h
    rows = LM["vocab_size"] // 2
    np.testing.assert_array_equal(module.tok_embed.weight.detach().numpy(),
                                  flax["lm"]["tok_embed"]["embedding"][rank * rows:
                                                                       (rank + 1) * rows])
    assert module.blocks[0].attn.out.weight.shape == (d, h * hd)


def test_rules_sharding_nothing_fail_loud(flax):
    """The LM's table matches nothing on an MLP: the builders refuse it
    unless the caller opts in to replication."""
    model = CompiledModel(get_model("mlp", device="cpu", **MLP), optimizer=SGD,
                          loss="categorical_crossentropy", metrics=[], input_shape=(16,))
    mesh = Mesh(model_size=2)
    with pytest.raises(ValueError, match="shard NO parameter"):
        tp.make_train_step_tp(model, mesh)
    with pytest.raises(ValueError, match="shard NO parameter"):
        tp.init_state_tp(model, mesh)
    specs = tp.param_specs(flax["mlp"], allow_replicated=True)
    assert set(_flat_specs(specs).values()) == {()}


@pytest.mark.parametrize("path,spec", [
    (r".*LayerNorm_0/scale$", (MODEL_AXIS,)),
    (r".*tok_embed/embedding$", (None, MODEL_AXIS)),
    (r".*/qkv/kernel$", (None, MODEL_AXIS, None, None)),
    (r".*/Dense_0/kernel$", (None, DATA_AXIS)),
    (r".*/Dense_0/kernel$", (None, MODEL_AXIS)),  # its bias replicated
])
def test_specs_with_no_torch_layout_raise(path, spec):
    module = get_model("transformer_lm", device="cpu", **LM)
    with pytest.raises(ValueError, match="Block_|tok_embed|fc1|LayerNorm"):
        tp.shard_module(module, Mesh(model_size=2), ((path, tp.P(*spec)),))


def test_keras_param_rules_names_item_3():
    """Item 3's Keras bridge is ported: rules over Keras variable paths
    become rules over the bridge's ``v{i}`` keys, the table the JAX
    package's ``keras_param_rules`` gives for the same variables."""
    from types import SimpleNamespace

    from elephas_tpu.parallel import tensor_parallel as jax_tp

    paths = ("sequential/dense/kernel", "sequential/dense/bias", "sequential/dense_1/kernel")
    model = SimpleNamespace(trainable_variables=[SimpleNamespace(path=p) for p in paths])
    rules = ((r".*/dense/kernel$", (None, MODEL_AXIS)), (r".*/dense_1/kernel$", (MODEL_AXIS, None)))
    got = tp.keras_param_rules(model, tuple((pat, tp.P(*spec)) for pat, spec in rules))
    assert got == ((r"^v0$", tp.P(None, MODEL_AXIS)), (r"^v2$", tp.P(MODEL_AXIS, None)))
    want = jax_tp.keras_param_rules(model, tuple((pat, JaxP(*spec)) for pat, spec in rules))
    assert [(k, tuple(v)) for k, v in got] == [(k, tuple(v)) for k, v in want]


def test_decode_cache_specs_shard_heads_of_both_pools():
    from elephas_tpu_torch.models.transformer import make_decode_cache, make_paged_decode_cache

    module = get_model("transformer_lm", device="cpu", **LM)
    for cache in (make_decode_cache(module, 3, 16), make_paged_decode_cache(module, 3, 6, 4)):
        specs = tp.decode_cache_specs(cache)
        assert specs.keys == specs.values == [tp.P(None, MODEL_AXIS, None, None)] * 2
        assert specs.index == tp.P()


# -- the mesh ------------------------------------------------------------------------


def test_model_axis_of_one_process():
    """A model axis needs a world of its size; ``over`` drops axes of size
    1 and counts the rest in mesh order, and refuses a pair of axes it
    holds no group for."""
    with pytest.raises(ValueError, match="needs a world of 2"):
        build_mesh(num_data=1, num_model=2)
    mesh = Mesh(size=2, rank=1, seq_size=3, seq_rank=2, model_size=2, model_rank=1)
    assert (mesh.over(MODEL_AXIS).size, mesh.over(MODEL_AXIS).rank) == (2, 1)
    whole = mesh.over((DATA_AXIS, SEQ_AXIS, MODEL_AXIS))
    assert (whole.size, whole.rank) == (12, (1 * 3 + 2) * 2 + 1)
    with pytest.raises(ValueError, match="no group over data x model"):
        mesh.over((DATA_AXIS, MODEL_AXIS))
    assert Mesh(model_size=2).over((DATA_AXIS, SEQ_AXIS)).size == 1


def test_mesh_lays_ranks_out_as_jax(runs):
    """Rank = d * S * M + s * M + m, as the JAX package's
    ``devices.reshape(num_data, num_seq, num_model)``; each axis's group
    is the ranks that share the other coordinates."""
    for name, shape in (("data2_model2", (2, 1, 2)), ("sptp", (1, 2, 2))):
        grid = np.arange(4).reshape(shape)
        for rank, run in enumerate(runs[name]):
            d, s, m = np.argwhere(grid == rank)[0]
            assert run["coords"] == (d, s, m)
            want = {"data": grid[:, s, m].tolist(), "seq": grid[d, :, m].tolist(),
                    "model": grid[d, s, :].tolist()}
            assert run["groups"] == {k: (v if len(v) > 1 else None) for k, v in want.items()}


# -- training against the JAX package ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(flax):
    """JAX's ``make_lm_train_step_tp`` on each run's mesh (3 steps on the
    same batch), its MLP under the user rules (5 steps), and its sp x tp
    ring step on data 1 x seq 2 x model 2."""
    out = {}
    x, y = _tokens(LM, 8, 1)
    for name, (_, (data, _, model)) in RUNS.items():
        jm = _jax_lm(LM, "flash", flax["lm"])
        mesh = jax_build_mesh(num_data=data, num_model=model)
        step = jax_tp.make_lm_train_step_tp(jm, mesh)
        state = jax_tp.init_lm_state_tp(jm, mesh)
        losses = []
        for _ in range(STEPS):
            state, metrics = step(state, x.astype(np.int32), y.astype(np.int32))
            losses.append(float(metrics["loss"]))
        out[name] = {"losses": losses, "params": jax.device_get(state.params)}
    for model in MLPS:
        jm = _jax_mlp(flax[model], model, flax["mask"] if model == "mlp_masked" else None)
        mesh = jax_build_mesh(num_data=1, num_model=2)
        step = jax_tp.make_train_step_tp(jm, mesh, rules=_rules(MLP_RULES))
        state = jax_tp.init_state_tp(jm, mesh, rules=_rules(MLP_RULES))
        xm, ym = _mlp_data()
        losses = []
        for _ in range(5):
            state, metrics = step(state, xm, ym)
            losses.append(float(metrics["loss"]))
        out[model] = {"losses": losses, "params": jax.device_get(state.params)}
    jm = _jax_lm(SPTP, "ring", flax["sptp"])
    mesh = jax_build_mesh(num_data=1, num_seq=2, num_model=2)
    step = jax_seq_parallel.make_lm_train_step(jm, mesh)
    state = jax_seq_parallel.init_lm_state(jm, mesh)
    xs, ys = _tokens(SPTP, 4, 1)
    xs, ys = jax_seq_parallel.shard_lm_batch(mesh, xs.astype(np.int32), ys.astype(np.int32))
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, xs, ys)
        losses.append(float(metrics["loss"]))
    out["sptp"] = {"losses": losses, "params": jax.device_get(state.params)}
    return out


def _port_full(config, full, model="transformer_lm"):
    module = get_model(model, device="cpu", **config)
    if model == "mlp":
        module(torch.zeros((1, 16)))
    return CompiledModel(module, full, optimizer=ADAM, loss="sparse_categorical_crossentropy",
                         metrics=[])


@pytest.mark.parametrize("name", ["model2", "data2_model2", "sptp"])
def test_losses_match_jax(jax_runs, runs, name):
    """Each step's loss on every rank: the first at 1e-5 of JAX's
    tensor-parallel step, and so are the later ones."""
    for run in runs[name]:
        got = [m["loss"] for m in run["metrics"]]
        np.testing.assert_allclose(got, jax_runs[name]["losses"], rtol=TOL)


@pytest.mark.parametrize("name", ["model2", "data2_model2", "sptp"])
def test_gathered_params_match_jax(jax_runs, runs, name):
    config = SPTP if name == "sptp" else LM
    for run in runs[name]:
        _assert_params(_port_full(config, run["full"]), jax_runs[name]["params"], atol=TOL,
                       noise_atol=NOISE)


@pytest.mark.parametrize("name,model", [("model2", 2), ("data2_model2", 2), ("sptp", 2)])
def test_shards_hold_their_heads(runs, name, model):
    config = SPTP if name == "sptp" else LM
    hd = config["d_model"] // config["num_heads"]
    h = config["num_heads"] // model
    for run in runs[name]:
        shapes = run["shapes"]
        assert shapes["blocks.0.attn.qkv.weight"] == (3 * h * hd, config["d_model"])
        assert shapes["blocks.0.attn.qkv.bias"] == (3 * h * hd,)
        assert shapes["blocks.0.attn.out.weight"] == (config["d_model"], h * hd)
        assert shapes["blocks.0.fc1.weight"] == (4 * config["d_model"] // model,
                                                 config["d_model"])
        assert shapes["tok_embed.weight"] == (config["vocab_size"] // model, config["d_model"])
        assert shapes["lm_head.weight"] == (config["vocab_size"] // model, config["d_model"])
        assert shapes["blocks.0.ln1.weight"] == (config["d_model"],)


@pytest.mark.parametrize("name", ["model2", "data2_model2", "sptp", "mlp", "mlp_masked"])
def test_replicated_params_bitwise_equal_across_ranks(runs, name):
    """Replicated parameters get the same gradient on every model rank and
    are never reduced over the model group: after the steps they are equal
    to the bit on every rank."""
    first = runs[name][0]["replicated"]
    assert first
    for run in runs[name][1:]:
        assert run["replicated"].keys() == first.keys()
        assert all(torch.equal(v, first[k]) for k, v in run["replicated"].items())


@pytest.mark.parametrize("name", ["model2", "data2_model2"])
def test_kernel_launches_on_local_heads(runs, name):
    """Each rank runs K1-K3 once a layer a step on its own heads (stand-ins
    of the kernels, which count their launches): over M = 2 ranks that is
    2 a layer, as the single-process step's one."""
    for run in runs[name]:
        assert run["launches"] == [{k: LM["num_layers"] for k in
                                    ("flash_fwd", "flash_dq", "flash_dkv")}] * STEPS
        assert run["tp_bytes"] > 0


@pytest.mark.parametrize("model", list(MLPS))
def test_mlp_user_rules_match_jax(flax, jax_runs, runs, model):
    """A user's column/row table on the MLP (the JAX package's
    ``test_tp_user_rules_shard_custom_model``): losses and gathered
    parameters as JAX's, the Dense_0 kernel sharded; a masked MLP's mask
    sharded with the units it masks."""
    masked = model == "mlp_masked"
    for run in runs[model]:
        np.testing.assert_allclose([m["loss"] for m in run["metrics"]],
                                   jax_runs[model]["losses"], rtol=TOL)
        assert run["metrics"][-1]["loss"] < run["metrics"][0]["loss"]
        assert run["shapes"]["hidden.0.weight"] == (16, 16)
        assert run["sharded"] == ["hidden.0.bias", "hidden.0.weight",
                                  *(["mask_0"] if masked else []), "out.weight"]
        if masked:
            assert run["shapes"]["mask_0"] == (16,)
        module = get_model(model, device="cpu", **MLPS[model])
        module(torch.zeros((1, 16)))
        want = from_flax_params(jax_runs[model]["params"], module,
                                flax["mask"] if masked else None)
        assert run["full"].keys() == want.keys()
        for key, value in run["full"].items():
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), atol=TOL)


def test_checkpoint_tp_to_tp(runs):
    """Saved under model 2 (gathered, rank 0 writes), restored into a
    fresh sharded state on each rank: the same shards and step, and one
    more step of each lands on the same bits."""
    for run in runs["model2"]:
        assert run["restored_step"] == STEPS
        assert run["restored_equal"] and run["resumed_equal"]
        assert run["resumed"][0] == run["resumed"][1]


def test_checkpoint_tp_to_single_process(worlds, runs):
    """The tensor-parallel snapshot restores into one unsharded process:
    its weights are the gathered state, and its Adam slots step it as the
    sharded run stepped."""
    full = runs["model2"][0]["full"]
    model = _port_full(LM, {k: torch.zeros_like(v) for k, v in full.items()})
    state = CheckpointManager(str(worlds["tmp"] / "two" / "ckpt")).restore(
        init_train_state(model))
    assert state.step == STEPS
    for key, value in model.module.state_dict().items():
        assert torch.equal(value, full[key]), key
    slots = state.optimizer.state[model.module.blocks[0].attn.qkv.weight]
    assert slots["mu"].shape == (3 * LM["d_model"], LM["d_model"])


def test_sptp_first_loss_equals_the_unsharded_dense_loss(flax, runs):
    """The JAX package's ``test_sptp_composed_step_matches_single_device``:
    the composed ring step's first loss is the unsharded dense model's."""
    x, y = _tokens(SPTP, 4, 1)
    jm = _jax_lm(SPTP, "dense", flax["sptp"])
    logits = jm.apply_eval(jm.params, {}, jnp.asarray(x, jnp.int32))
    logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32)))
    ref = float(-np.mean(np.take_along_axis(logp, y[..., None], axis=-1)))
    for run in runs["sptp"]:
        np.testing.assert_allclose(run["metrics"][0]["loss"], ref, rtol=1e-4)
