"""The port's MNIST CNN (``elephas_tpu_torch/models/cnn.py``) against the
flax ``SimpleCNN``, on the CPU: forward and gradients on converted
weights, the NHWC flatten order the first dense layer's rows follow, the
``convert.py`` round trip, and the registry entry. Limits: logits 1e-5
and gradients 1e-4 of each tensor's max (float32 sums in two frameworks'
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu_torch.convert import from_flax_params, to_flax_params
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.models.cnn import SimpleCNN

SMALL = {"channels": (4, 8), "dense_width": 16, "num_classes": 10}


def _pair(shape=(5, 12, 12, 1), kwargs=SMALL, seed=0):
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    flax_model = jax_get_model("cnn", **kwargs)
    params = jax.device_get(flax_model.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    module = get_model("cnn", device="cpu", **kwargs)
    module.load_state_dict(from_flax_params(params, module))
    return x, flax_model, params, module


@pytest.mark.parametrize("shape", [(5, 12, 12, 1), (3, 28, 28, 1), (2, 9, 13, 3)])
def test_forward_matches_flax(shape):
    x, flax_model, params, module = _pair(shape)
    want = np.asarray(flax_model.apply({"params": params}, jnp.asarray(x)))
    got = module(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_gradients_match_flax():
    x, flax_model, params, module = _pair((6, 12, 12, 1))
    y = np.eye(10, dtype=np.float32)[np.arange(6) % 10]

    def loss(p):
        logits = flax_model.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy(logits, jnp.asarray(y)).mean()

    want = to_flax_params({k: torch.from_numpy(np.asarray(v)) for k, v in
                           from_flax_params(jax.device_get(jax.grad(loss)(params)),
                                            module).items()}, module)
    out = module(torch.from_numpy(x), train=True)
    torch.nn.functional.cross_entropy(out, torch.from_numpy(y)).backward()
    grads = {name: p.grad for name, p in module.named_parameters()}
    got = to_flax_params(grads, module)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=1e-4 * max(1e-6, np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))


def test_dense_rows_follow_flax_nhwc_flatten():
    """A single live feature after the last pool reaches the dense layer
    at row (h * W + w) * C + c, as flax's NHWC reshape puts it; an NCHW
    flatten would put it at (c * H + h) * W + w."""
    module = SimpleCNN(channels=(2,), dense_width=64, num_classes=3)
    module(torch.zeros(1, 8, 8, 1))
    with torch.no_grad():
        for p in module.parameters():
            p.zero_()
        conv = module.convs[0]
        conv.weight[1, 0, 1, 1] = 1.0  # channel 1 copies the input pixel
    x = torch.zeros(1, 8, 8, 1)
    x[0, 4, 6, 0] = 1.0  # pools to (h, w) = (2, 3) of the 4x4 map
    captured = {}
    module.dense.register_forward_hook(lambda m, inp, out: captured.update(x=inp[0]))
    module(x)
    flat = captured["x"][0]
    assert flat.nonzero().flatten().tolist() == [(2 * 4 + 3) * 2 + 1]


def test_convert_round_trip_and_registry():
    _, _, params, module = _pair()
    back = to_flax_params(module.state_dict(), module)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    assert module._elephas_config == {"name": "cnn", "kwargs": {**SMALL, "device": "cpu"}}
    default = get_model("cnn", device="cpu")
    default(torch.zeros(1, 28, 28, 1))
    assert sum(p.numel() for p in default.parameters()) == sum(
        np.asarray(v).size for v in jax.tree_util.tree_leaves(
            jax_get_model("cnn").init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))))


def test_dropout_draws_from_the_module_generator():
    module = get_model("cnn", device="cpu", dropout_rate=0.5, **SMALL)
    x = torch.rand(4, 12, 12, 1)
    module(x)
    module.train()
    outs = []
    for _ in range(2):
        module.dropout_generator = torch.Generator().manual_seed(3)
        outs.append(module(x, train=True))
    assert torch.equal(outs[0], outs[1])
    module.eval()
    assert torch.equal(module(x), module(x))
