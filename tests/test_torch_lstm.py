"""Parity of the port's LSTM classifier (``models/lstm.py``, BASELINE
config 3) with the JAX package's on the CPU, at a small width (vocab 50,
embed 8, hidden 8, sequences of 12, batch 4).

Both sides hold the same weights (the flax init, converted by
``from_flax_params``) and the same NumPy-seeded tokens, pre-padded with
zeros as ``synthetic_imdb`` pads. Limits: logits 1e-5; each gradient
leaf 1e-5 of its norm; after three Adam or three LAMB steps each
parameter 1e-5 of its norm. LAMB scales each tensor's update by its own
trust ratio, so it holds only if the port keeps flax's 12 cell leaves
as 12 tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.engine import step as jax_step
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu_torch.api import CompiledModel
from elephas_tpu_torch.convert import from_flax_params, to_flax_params
from elephas_tpu_torch.engine import step as port_step
from elephas_tpu_torch.models import get_model

SMALL = dict(vocab_size=50, embed_dim=8, hidden_dim=8)
SEQ, BATCH = 12, 4
OPTIMIZERS = {"adam": {"name": "adam", "learning_rate": 1e-2},
              "lamb": {"name": "lamb", "learning_rate": 1e-2}}


def _tokens(seed, rows=BATCH):
    """Token ids pre-padded with zeros to SEQ, lengths 3..SEQ."""
    rng = np.random.default_rng(seed)
    x = np.zeros((rows, SEQ), np.int32)
    for i, n in enumerate(rng.integers(3, SEQ + 1, rows)):
        x[i, SEQ - n:] = rng.integers(1, SMALL["vocab_size"], n)
    return x, rng.integers(0, 2, rows).astype(np.int32)


@pytest.fixture(scope="module")
def flax_params():
    module = jax_get_model("lstm", **SMALL)
    return jax.device_get(module.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
                          ["params"])


def _port_module(params):
    module = get_model("lstm", device="cpu", **SMALL)
    module.load_state_dict(from_flax_params(params, module))
    return module


def _assert_by_norm(got: dict, want: dict, rtol):
    assert got.keys() == want.keys()
    for name, ref in want.items():
        ref = np.asarray(ref)
        err = np.linalg.norm(np.asarray(got[name]) - ref)
        assert err <= rtol * np.linalg.norm(ref), (name, err, np.linalg.norm(ref))


def test_parameters_are_flax_leaves_one_for_one(flax_params):
    """Embed, 4 bias-free input kernels, 4 hidden kernels with a bias each,
    the dense head: 15 tensors, flax's leaves; 2,691,842 at the registry
    width."""
    module = _port_module(flax_params)
    assert len(jax.tree_util.tree_leaves(flax_params)) == len(list(module.parameters())) == 15
    names = [n for n, _ in module.named_parameters()]
    assert names == ["embed.weight", "cell.ii.weight", "cell.if.weight", "cell.ig.weight",
                     "cell.io.weight", "cell.hi.weight", "cell.hi.bias", "cell.hf.weight",
                     "cell.hf.bias", "cell.hg.weight", "cell.hg.bias", "cell.ho.weight",
                     "cell.ho.bias", "out.weight", "out.bias"]
    full = get_model("lstm", device="cpu")
    assert sum(p.numel() for p in full.parameters()) == 2_691_842
    assert full.embed.weight.device == torch.device("cpu")


def test_forward_matches_jax(flax_params):
    x, _ = _tokens(1)
    want = np.asarray(jax_get_model("lstm", **SMALL).apply({"params": flax_params}, x))
    got = _port_module(flax_params)(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_float_token_ids_equal_int_ids(flax_params):
    """A DataFrame column carries token ids as float32; the model casts."""
    x, _ = _tokens(2)
    module = _port_module(flax_params)
    ints = module(torch.as_tensor(x)).detach()
    floats = module(torch.as_tensor(x.astype(np.float32))).detach()
    assert torch.equal(ints, floats)


def test_gradients_match_jax_per_leaf(flax_params):
    x, y = _tokens(3)
    jmodule = jax_get_model("lstm", **SMALL)

    def loss(params):
        logits = jmodule.apply({"params": params}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    grads = jax.device_get(jax.grad(loss)(flax_params))
    module = _port_module(flax_params)
    F.cross_entropy(module(torch.as_tensor(x)), torch.as_tensor(y).long()).backward()
    want = from_flax_params(grads, module)
    got = {n: p.grad for n, p in module.named_parameters()}
    for name in ("cell.if.weight", "cell.hg.bias", "out.bias"):
        assert got[name].norm() > 0, name
    _assert_by_norm({k: v.numpy() for k, v in got.items()},
                    {k: v.numpy() for k, v in want.items()}, 1e-5)


@pytest.mark.parametrize("optimizer", ["adam", "lamb"])
def test_train_steps_match_jax(flax_params, optimizer):
    """Three steps on three batches through each package's train step."""
    jm = JaxCompiledModel(jax_get_model("lstm", **SMALL), flax_params,
                          optimizer=OPTIMIZERS[optimizer],
                          loss="sparse_categorical_crossentropy", metrics=["acc"])
    step, state = jax.jit(jax_step.make_train_step(jm)), jax_step.init_train_state(jm)
    module = _port_module(flax_params)
    pm = CompiledModel(module, module.state_dict(), optimizer=OPTIMIZERS[optimizer],
                       loss="sparse_categorical_crossentropy", metrics=["acc"])
    pstep, pstate = port_step.make_train_step(pm), port_step.init_train_state(pm)
    for seed in range(3):
        x, y = _tokens(10 + seed)
        state, metrics = step(state, x, y)
        pstate, pmetrics = pstep(pstate, torch.as_tensor(x), torch.as_tensor(y))
        np.testing.assert_allclose(float(pmetrics["loss"]), float(metrics["loss"]), rtol=1e-5)
    want = from_flax_params(jax.device_get(state.params), module)
    moved = from_flax_params(flax_params, module)
    got = module.state_dict()
    assert all(not torch.equal(got[n], moved[n]) for n in ("cell.io.weight", "cell.ho.bias"))
    _assert_by_norm({k: v.numpy() for k, v in got.items()},
                    {k: v.numpy() for k, v in want.items()}, 1e-5)


def test_flax_params_round_trip_exactly(flax_params):
    module = get_model("lstm", device="cpu", **SMALL)
    back = to_flax_params(from_flax_params(flax_params, module), module)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(flax_params)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(flax_params)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError, match="not consumed"):
        extra = {**flax_params, "Dense_1": flax_params["Dense_0"]}
        from_flax_params(extra, module)


def test_dropout_draws_from_the_given_generator(flax_params):
    module = get_model("lstm", device="cpu", dropout_rate=0.5, **SMALL)
    module.load_state_dict(from_flax_params(flax_params, module))
    x = torch.as_tensor(_tokens(4)[0])
    module.train()
    outs = []
    for _ in range(2):
        module.dropout_generator = torch.Generator().manual_seed(7)
        outs.append(module(x, train=True).detach())
    assert torch.equal(outs[0], outs[1])
    module.eval()
    assert torch.equal(module(x), _port_module(flax_params)(x))
