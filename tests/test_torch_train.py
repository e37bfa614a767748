"""Parity of the port's LM training (``elephas_tpu_torch.engine``) with the
JAX package's on the CPU: train steps, epoch scanner, eval and predict
steps, resuming a JAX run in the port, and the weight bridge back.

Small model, same weights on both sides (flax init, converted by
``from_flax_params``). The JAX side jits ``make_train_step`` as its own
tests do; ``attention="flash"`` takes its blockwise path and XLA VJP
there, and the port's plain versions here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.engine import step as jax_step
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu_torch.api import CompiledModel
from elephas_tpu_torch.convert import from_flax_params, from_optax_state, to_flax_params
from elephas_tpu_torch.engine import step as port_step
from elephas_tpu_torch.engine.state import TrainState
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.models.transformer import generate

VOCAB = 97
SMALL = dict(vocab_size=VOCAB, d_model=32, num_heads=4, num_layers=2, max_seq_len=64)
OPTIMIZERS = {"adam": {"name": "adam", "learning_rate": 1e-3},
              "momentum": {"name": "momentum", "learning_rate": 0.05},
              "momentum_decay": {"name": "momentum", "learning_rate": {
                  "schedule": "exponential_decay", "init_value": 0.05,
                  "transition_steps": 1, "decay_rate": 0.5}}}


def _jax(attention="dense", optimizer="adam", params=None, dtype="float32", **model):
    return JaxCompiledModel(
        jax_get_model("transformer_lm", attention=attention, dtype=dtype, **{**SMALL, **model}),
        params,
        optimizer=OPTIMIZERS.get(optimizer, optimizer),
        loss="sparse_categorical_crossentropy",
        metrics=["acc"],
        input_shape=(16,),
        input_dtype=jnp.int32,
        seed=0,
    )


def _port(params, attention="dense", optimizer="adam", dtype="float32", **model):
    module = get_model("transformer_lm", attention=attention, dtype=dtype, device="cpu",
                       **{**SMALL, **model})
    return CompiledModel(module, from_flax_params(params, module),
                         optimizer=OPTIMIZERS.get(optimizer, optimizer),
                         loss="sparse_categorical_crossentropy", metrics=["acc"])


@pytest.fixture(scope="module")
def flax_params():
    return jax.device_get(_jax().params)


def _batch(seed, shape=(4, 33)):
    tokens = np.random.default_rng(seed).integers(0, VOCAB, shape).astype(np.int32)
    return tokens[..., :-1], tokens[..., 1:]


def _assert_params(port, jax_params, atol, noise_atol=None):
    """Every parameter within ``atol``, except where ``noise_atol`` is set:
    the key third of each qkv bias then within ``noise_atol``. Its exact
    gradient is 0 (softmax ignores the shift q.b_k shared by all of a
    query's scores), so Adam moves it by lr * sign(rounding noise), on
    each side its own."""
    want = from_flax_params(jax.device_get(jax_params), port.module)
    for name, value in port.module.state_dict().items():
        got, ref = value.numpy(), want[name].numpy()
        if noise_atol is not None and name.endswith("attn.qkv.bias"):
            third = slice(len(got) // 3, 2 * len(got) // 3)
            np.testing.assert_allclose(got[third], ref[third], atol=noise_atol,
                                       err_msg=name)
            got, ref = np.delete(got, third), np.delete(ref, third)
        np.testing.assert_allclose(got, ref, atol=atol, err_msg=name)


def _assert_updates(port, jax_params, init_params, rtol):
    """Each parameter's change from ``init_params`` within ``rtol`` of the
    JAX run's change, by norm: ||dP_port - dP_jax|| <= rtol * ||dP_jax||.
    A step that updates nothing, or updates along other gradients, is 1 or
    more off. The key third of each qkv bias is left out (see
    ``_assert_params``)."""
    want = from_flax_params(jax.device_get(jax_params), port.module)
    init = from_flax_params(init_params, port.module)
    for name, value in port.module.state_dict().items():
        got, ref, start = value.numpy(), want[name].numpy(), init[name].numpy()
        if name.endswith("attn.qkv.bias"):
            third = slice(len(got) // 3, 2 * len(got) // 3)
            got, ref, start = (np.delete(a, third) for a in (got, ref, start))
        moved = np.linalg.norm(ref - start)
        assert moved > 0, name
        assert np.linalg.norm((got - start) - (ref - start)) <= rtol * moved, name


def _noise_atol(optimizer, steps):
    """How far two Adam runs can drift on a parameter whose gradient is
    only rounding noise: lr per step each way."""
    return 2 * steps * OPTIMIZERS["adam"]["learning_rate"] if "adam" in optimizer else None


def _run_both(flax_params, attention, optimizer, dtype, steps=3):
    x, y = _batch(0)
    jm = _jax(attention, optimizer, flax_params, dtype)
    step = jax.jit(jax_step.make_train_step(jm))
    state = jax_step.init_train_state(jm)
    pm = _port(flax_params, attention, optimizer, dtype)
    pstep = port_step.make_train_step(pm)
    pstate = port_step.init_train_state(pm)
    pairs = []
    for _ in range(steps):
        state, metrics = step(state, x, y)
        pstate, pmetrics = pstep(pstate, torch.from_numpy(x), torch.from_numpy(y))
        pairs.append((jax.device_get(metrics), pmetrics))
    assert pstate.step == steps
    return state, pm, pairs


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_train_steps_match_jax(flax_params, attention, optimizer):
    """Three float32 steps: per-step loss and acc, then every parameter."""
    state, pm, pairs = _run_both(flax_params, attention, optimizer, "float32")
    for want, got in pairs:
        assert got["loss"].dim() == 0 and got["loss"].dtype == torch.float32
        for key in ("loss", "acc"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5)
    _assert_params(pm, state.params, atol=1e-5, noise_atol=_noise_atol(optimizer, 3))


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_bf16_train_steps_track_jax(flax_params, attention, optimizer):
    """bf16 models round at other places in the two frameworks, so the
    check is looser than in float32: each step's loss within 1e-2 (the
    loss falls by about 0.47 over the three steps; the frameworks differ
    by at most 2.3e-3), and each parameter's change within a norm-relative
    ``rtol`` of the JAX run's. Adam's first updates are nearly
    lr * sign(g), which a rounding difference flips where a gradient is
    near 0: its changes differ by 0.14 at most, so its rtol is 0.3;
    momentum's differ by 0.021, and its rtol is 0.05."""
    state, pm, pairs = _run_both(flax_params, attention, optimizer, "bfloat16")
    for want, got in pairs:
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=1e-2)
    for value in pm.module.state_dict().values():
        assert value.dtype == torch.float32  # bf16 compute, float32 parameters
    _assert_updates(pm, state.params, flax_params,
                    rtol={"adam": 0.3, "momentum": 0.05}[optimizer])


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "momentum", "momentum_decay"])
def test_resume_jax_run_in_port(flax_params, optimizer):
    """Two JAX steps, then params and optimizer state carried across: one
    more step on each side agrees. The update count comes from adam's
    state or the schedule's; plain momentum keeps none."""
    x, y = _batch(1)
    jm = _jax("dense", optimizer, flax_params)
    step = jax.jit(jax_step.make_train_step(jm))
    state = jax_step.init_train_state(jm)
    for _ in range(2):
        state, _ = step(state, x, y)
    pm = _port(jax.device_get(state.params), "dense", optimizer)
    pstate = TrainState.create(from_optax_state(jax.device_get(state.opt_state), pm), step=2)
    assert all(group["count"] == (0 if optimizer == "momentum" else 2)
               for group in pstate.optimizer.param_groups)
    state, metrics = step(state, x, y)
    pstate, pmetrics = port_step.make_train_step(pm)(pstate, torch.from_numpy(x),
                                                      torch.from_numpy(y))
    np.testing.assert_allclose(float(pmetrics["loss"]), float(metrics["loss"]), rtol=1e-5)
    _assert_params(pm, state.params, atol=1e-5, noise_atol=_noise_atol(optimizer, 3))


def test_from_optax_state_rejects_other_optimizers(flax_params):
    jm = _jax("dense", "rmsprop", flax_params)
    pm = _port(flax_params, "dense", "rmsprop")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        from_optax_state(jax.device_get(jm.init_opt_state()), pm)


def test_to_flax_params_round_trips(flax_params):
    module = get_model("transformer_lm", device="cpu", **SMALL)
    state = from_flax_params(flax_params, module)
    back = to_flax_params(state, module)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(flax_params)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(flax_params)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError):
        to_flax_params({k: v for k, v in state.items() if k != "lm_head.bias"}, module)


def test_port_trained_weights_run_in_jax(flax_params):
    """Weights trained in the port go back to the JAX package."""
    x, y = _batch(2)
    pm = _port(flax_params, "flash")
    step, state = port_step.make_train_step(pm), port_step.init_train_state(pm)
    for _ in range(2):
        state, _ = step(state, torch.from_numpy(x), torch.from_numpy(y))
    params = to_flax_params(pm.module.state_dict(), pm.module)
    want = np.asarray(_jax().apply_eval(params, {}, x))
    np.testing.assert_allclose(pm.apply_eval(torch.from_numpy(x)).numpy(), want, atol=1e-4)


def test_epoch_scanner_eval_and_predict_match_jax(flax_params):
    xs, ys = _batch(3, shape=(3, 2, 17))
    jm = _jax("flash", "adam", flax_params)
    scan = jax.jit(jax_step.make_epoch_scanner(jax_step.make_train_step(jm)))
    state, metrics = scan(jax_step.init_train_state(jm), xs, ys)
    pm = _port(flax_params, "flash", "adam")
    scan_epoch = port_step.make_epoch_scanner(port_step.make_train_step(pm))
    pstate, pmetrics = scan_epoch(port_step.init_train_state(pm), torch.from_numpy(xs),
                                  torch.from_numpy(ys))
    assert pstate.step == 3
    for key in ("loss", "acc"):
        np.testing.assert_allclose(float(pmetrics[key]), float(metrics[key]), rtol=1e-5)
    _assert_params(pm, state.params, atol=1e-5, noise_atol=_noise_atol("adam", 3))

    x, y = _batch(4)
    want = jax_step.make_eval_step(jm)(state, x, y)
    got = port_step.make_eval_step(pm)(pstate, torch.from_numpy(x), torch.from_numpy(y))
    for key in ("loss", "acc"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5)
    np.testing.assert_allclose(
        port_step.make_predict_step(pm)(pstate, torch.from_numpy(x)).numpy(),
        np.asarray(jax_step.make_predict_step(jm)(state, x)), atol=1e-4)


def test_weighted_mean_over_chunks_matches_jax():
    spans = [(0, 3), (3, 10), (10, 12)]

    def chunk(start, stop):
        return {"loss": torch.tensor(float(start + stop)), "acc": stop / 12}

    want = jax_step.weighted_mean_over_chunks(spans, chunk, 12)
    assert port_step.weighted_mean_over_chunks(spans, chunk, 12) == pytest.approx(want)


def test_pmean_axis_not_ported(flax_params):
    """Only the data axis is ported (``test_torch_fit.py`` drives it); the
    sequence axis raises until LM parallelism is ported."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_step.make_train_step(_port(flax_params), pmean_axis="seq")


def test_clone_copies_module_and_optimizer(flax_params):
    pm = _port(flax_params, "dense", "adam")
    twin = pm.clone()
    assert twin.module is not pm.module
    assert twin.optimizer_config == pm.optimizer_config
    for name, value in twin.module.state_dict().items():
        assert torch.equal(value, pm.module.state_dict()[name])
    with torch.no_grad():
        twin.module.lm_head.bias += 1.0
    assert not torch.equal(twin.module.lm_head.bias, pm.module.lm_head.bias)


def test_generate_follows_learned_recurrence():
    """The recurrence test of the JAX package's ``tests/test_generate.py``
    in the port: train on token[i] = token[i-1] + token[i-2] (mod vocab),
    then greedy ``generate`` from training-row prefixes follows it."""
    vocab, seq = 64, 32
    module = get_model("transformer_lm", vocab_size=vocab, d_model=32, num_heads=4,
                       num_layers=2, max_seq_len=seq, device="cpu")
    compiled = CompiledModel(module, optimizer={"name": "adam", "learning_rate": 3e-3},
                             loss="sparse_categorical_crossentropy", metrics=[], seed=0)
    rng = np.random.default_rng(1)
    base = rng.integers(0, vocab, size=(16, seq + 1)).astype(np.int64)
    for i in range(2, seq + 1):
        base[:, i] = (base[:, i - 1] + base[:, i - 2]) % vocab
    step, state = port_step.make_train_step(compiled), port_step.init_train_state(compiled)
    x, t = torch.from_numpy(base[:, :-1]), torch.from_numpy(base[:, 1:])
    for _ in range(60):
        state, metrics = step(state, x, t)
    assert float(metrics["loss"]) < 1.0

    prompt = base[:3, :4].copy()
    out = generate(compiled, prompt, max_new_tokens=12)
    assert out.shape == (3, 16)
    assert np.array_equal(out[:, :4], prompt)
    hits = [int(row[i] == (row[i - 1] + row[i - 2]) % vocab)
            for row in out for i in range(4, len(row))]
    assert sum(hits) / len(hits) > 0.7, f"{sum(hits)}/{len(hits)} follow the recurrence"
