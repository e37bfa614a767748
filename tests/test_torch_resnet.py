"""Parity of the port's ResNet-18 (``elephas_tpu_torch.models.resnet``) and
its weight layouts with the JAX package's, on the CPU.

Width 8 on 8 x 32 x 32 x 3 images (and an odd 7 x 7 size, and the
ImageNet stem), weights from the flax init converted by
``from_flax_params``. Forwards, losses and the new batch statistics are
held against the JAX package in float32. Gradients and the parameters
after one momentum step are held against the same JAX code run in
float64 (``jax.enable_x64``): on this input XLA's float32 gradients on
the CPU sit up to a few percent of a gradient's max from its own float64
ones in the early layers, which the port's float32 gradients are not, so
the float32 JAX run cannot be the oracle at 1e-4.
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
from elephas_tpu_torch.convert import from_flax_params, to_flax_batch_stats, to_flax_params
from elephas_tpu_torch.engine import step as port_step
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.models.resnet import same_padding

WIDTH = 8
MOMENTUM = {"name": "momentum", "learning_rate": 0.1}


def _batch(size, seed=0, n=8):
    rng = np.random.default_rng(seed)
    x = rng.random((n, size, size, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _jax(size, **kw):
    """The JAX package's model, initialised as ``CompiledModel`` does from
    ``input_shape`` (seed 0), through one jitted ``init``."""
    module = jax_get_model("resnet18", width=WIDTH, **kw)
    variables = jax.jit(module.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False)
    return JaxCompiledModel(module, variables["params"], optimizer=MOMENTUM,
                            loss="categorical_crossentropy", metrics=["acc"],
                            batch_stats=variables["batch_stats"])


def _port(jm, dtype="float32", **kw):
    module = get_model("resnet18", width=WIDTH, dtype=dtype, device="cpu", **kw)
    state = from_flax_params(jax.device_get(jm.params), module,
                             jax.device_get(jm.batch_stats))
    return CompiledModel(module, state, optimizer=MOMENTUM,
                         loss="categorical_crossentropy", metrics=["acc"])


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jax.device_get(tree))}


def _jax_train(jm, x, y):
    """The JAX package's training-mode logits and new batch statistics."""
    out, mutated = jm.module.apply({"params": jm.params, "batch_stats": jm.batch_stats}, x,
                                   train=True, mutable=["batch_stats"])
    return np.asarray(out), mutated["batch_stats"]


def _jax_f64_step(jm, x, y):
    """One jitted ``make_train_step`` of the same model in float64:
    ``(grads, params after the step)`` as flat dicts. The first momentum
    step moves each parameter by -lr times its gradient, which gives the
    gradient back to float64 precision."""
    with jax.enable_x64(True):
        wide = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jm.params)
        stats = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jm.batch_stats)
        module = jax_get_model("resnet18", width=WIDTH, dtype="float64")
        jm64 = JaxCompiledModel(module, wide, optimizer=MOMENTUM,
                                loss="categorical_crossentropy", metrics=["acc"],
                                batch_stats=stats)
        state, _ = jax.jit(jax_step.make_train_step(jm64))(
            jax_step.init_train_state(jm64), x.astype(np.float64), y.astype(np.float64))
        before, after = _leaves(wide), _leaves(state.params)
    lr = MOMENTUM["learning_rate"]
    return {k: (before[k] - after[k]) / lr for k in before}, after


@pytest.fixture(scope="module")
def case32():
    x, y = _batch(32)
    jm = _jax(32)
    logits, stats = _jax_train(jm, x, y)
    grads, params = _jax_f64_step(jm, x, y)
    return {"jm": jm, "x": x, "y": y, "train_logits": logits, "stats": _leaves(stats),
            "eval_logits": np.asarray(jm.apply_eval(jm.params, jm.batch_stats, x)),
            "grads": grads, "params": params}


def _close(got, want, atol_scale):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=atol_scale * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("size, pads", [(32, (1, 1)), (7, (1, 1)), (8, (1, 1))])
def test_same_padding_stride_1(size, pads):
    assert same_padding(size, 3, 1) == pads


@pytest.mark.parametrize("size, kernel, pads", [(32, 3, (0, 1)), (7, 3, (1, 1)),
                                                (16, 1, (0, 0)), (7, 1, (0, 0)),
                                                (32, 7, (2, 3)), (15, 3, (1, 1))])
def test_same_padding_stride_2(size, kernel, pads):
    """flax's SAME: an even input pads (0, 1) under a 3x3 stride-2 conv,
    where torch's ``padding=1`` would pad (1, 1); a 1x1 pads nothing."""
    assert same_padding(size, kernel, 2) == pads


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_resnet_logits_match_jax(case32, mode):
    pm = _port(case32["jm"])
    x = torch.from_numpy(case32["x"])
    got = pm.apply_eval(x) if mode == "eval" else pm.apply_train(x).detach()
    _close(got.numpy(), case32[f"{mode}_logits"], 1e-4)


def test_resnet_train_step_matches_jax(case32):
    """Loss and new batch statistics against the float32 JAX run; each
    gradient within 1e-4 of its max and the parameters after one momentum
    step against the float64 one; the step's loss is the forward's."""
    pm = _port(case32["jm"])
    x, y = (torch.from_numpy(case32[k]) for k in ("x", "y"))
    loss, _ = port_step.make_loss_fn(pm)(x, y)
    want_loss = -(case32["y"] * jax.nn.log_softmax(case32["train_logits"])).sum(-1).mean()
    _close(loss.item(), float(want_loss), 1e-4)
    loss.backward()
    grads = _leaves(to_flax_params({n: p.grad for n, p in pm.module.named_parameters()},
                                   pm.module))
    assert grads.keys() == case32["grads"].keys()
    for name, want in case32["grads"].items():
        err = np.abs(grads[name] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err, np.abs(want).max())

    pm = _port(case32["jm"])
    state, metrics = port_step.make_train_step(pm)(port_step.init_train_state(pm), x, y)
    assert state.step == 1
    _close(float(metrics["loss"]), float(want_loss), 1e-4)
    stats = _leaves(to_flax_batch_stats(pm.module.state_dict(), pm.module))
    assert stats.keys() == case32["stats"].keys()
    for name, want in case32["stats"].items():
        _close(stats[name], want, 1e-5)
    params = _leaves(to_flax_params(pm.module.state_dict(), pm.module))
    for name, want in case32["params"].items():
        _close(params[name], want, 1e-5)
    assert int(pm.module.stem_norm.num_batches_tracked) == 1


@pytest.mark.parametrize("size, kw", [(7, {}), (17, {"imagenet_stem": True})])
def test_resnet_other_sizes_and_stem_match_jax(case32, size, kw):
    """An odd size pins SAME padding on both sides of each stride-2 conv;
    the ImageNet stem (7x7 stride 2 padded 3, then a SAME 3x3 stride-2
    max pool) at an odd size too. Logits in both modes and the new batch
    statistics in float32. (The CIFAR model's weights do not depend on
    the image size.)"""
    x, y = _batch(size, seed=1)
    jm = _jax(size, **kw) if kw else case32["jm"]
    pm = _port(jm, **kw)
    _close(pm.apply_eval(torch.from_numpy(x)).numpy(),
           np.asarray(jm.apply_eval(jm.params, jm.batch_stats, x)), 1e-4)
    logits, stats = _jax_train(jm, x, y)
    _close(pm.apply_train(torch.from_numpy(x)).detach().numpy(), logits, 1e-4)
    got = _leaves(to_flax_batch_stats(pm.module.state_dict(), pm.module))
    for name, want in _leaves(stats).items():
        _close(got[name], want, 1e-5)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_bf16_resnet_tracks_jax(case32, mode):
    """bf16 convs on float32 parameters, norms computed in float32: the two
    frameworks round at different places, so logits agree within 0.05, as
    the LM's bf16 forward does (``test_bf16_forward_tracks_jax``)."""
    x, y = _batch(32, seed=2)
    jm = JaxCompiledModel(jax_get_model("resnet18", width=WIDTH, dtype="bfloat16"),
                          case32["jm"].params, batch_stats=case32["jm"].batch_stats)
    pm = _port(jm, dtype="bfloat16")
    if mode == "eval":
        want = np.asarray(jm.apply_eval(jm.params, jm.batch_stats, x))
        got = pm.apply_eval(torch.from_numpy(x))
    else:
        want = _jax_train(jm, x, y)[0]
        got = pm.apply_train(torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.05)


def test_layouts_round_trip(case32):
    """Conv HWIO <-> OIHW, BatchNorm scale/bias/mean/var <-> weight/bias/
    running_*, Dense (in, out) <-> (out, in): flax -> torch -> flax is the
    identity, and num_batches_tracked is set on the way in."""
    jm = case32["jm"]
    module = get_model("resnet18", width=WIDTH, device="cpu")
    state = from_flax_params(jax.device_get(jm.params), module,
                             jax.device_get(jm.batch_stats))
    assert state["stem.conv.weight"].shape == (WIDTH, 3, 3, 3)
    np.testing.assert_array_equal(
        state["blocks.2.shortcut.conv.weight"].numpy(),
        np.asarray(jm.params["ResidualBlock_2"]["Conv_2"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["head.weight"].numpy(),
                                  np.asarray(jm.params["Dense_0"]["kernel"]).T)
    assert int(state["stem_norm.num_batches_tracked"]) == 0
    module.load_state_dict(state)
    for back, tree in ((to_flax_params, jm.params), (to_flax_batch_stats, jm.batch_stats)):
        got, want = _leaves(back(state, module)), _leaves(tree)
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])


def test_unconsumed_or_missing_leaves_raise(case32):
    jm = case32["jm"]
    params, stats = jax.device_get(jm.params), jax.device_get(jm.batch_stats)
    module = get_model("resnet18", width=WIDTH, device="cpu")
    with pytest.raises(KeyError, match="batch_stats lack"):
        from_flax_params(params, module)
    extra = {**stats, "Stray_0": {"mean": np.zeros(3)}}
    with pytest.raises(KeyError, match="not consumed"):
        from_flax_params(params, module, extra)


def test_seeded_state_for_convs_and_norms():
    """Seeded weights: convs N(0, 1/fan_in), norms at identity with running
    variance 1 (never negative), the same on every call."""
    module = get_model("resnet18", width=WIDTH, device="cpu")
    compiled = CompiledModel(module, input_shape=(32, 32, 3), seed=3)
    state = compiled.get_weights()
    conv = state["blocks.4.conv2.conv.weight"]
    assert abs(conv.std().item() - 1 / np.sqrt(4 * WIDTH * 9)) < 0.1 / np.sqrt(4 * WIDTH * 9)
    for name, value in state.items():
        if name.endswith("running_var") or name.endswith("norm1.weight"):
            assert torch.equal(value, torch.ones_like(value)), name
        elif name.endswith("running_mean") or name.endswith("norm1.bias"):
            assert torch.equal(value, torch.zeros_like(value)), name
    again = CompiledModel(get_model("resnet18", width=WIDTH, device="cpu"),
                          input_shape=(32, 32, 3), seed=3).get_weights()
    for name in state:
        assert torch.equal(state[name], again[name]), name
    with pytest.raises(ValueError, match="input_shape"):
        CompiledModel(get_model("resnet18", width=WIDTH, device="cpu"))
