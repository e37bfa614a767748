"""Parity of the port's optimizers and schedules (``elephas_tpu_torch.api``)
with optax as the JAX package resolves it, on the CPU."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from elephas_tpu.api import compile as jax_compile
from elephas_tpu_torch.api import compile as port_compile

SHAPES = {"w": (3, 4), "b": (5,), "k": (2, 2, 3)}


def _tree(rng):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


# Each spec twice where it matters: the registry defaults, and options
# that reach every branch of the rule.
SPECS = [
    "sgd", "momentum", "adam", "adamw", "rmsprop", "adagrad", "lamb",
    {"name": "momentum", "nesterov": True},
    {"name": "adam", "b1": 0.8, "eps_root": 1e-6, "nesterov": True},
    {"name": "adamw", "weight_decay": 0.05},
    {"name": "rmsprop", "centered": True, "momentum": 0.9, "eps_in_sqrt": False},
    {"name": "rmsprop", "bias_correction": True, "momentum": 0.5, "nesterov": True},
    {"name": "adagrad", "initial_accumulator_value": 0.0},
    {"name": "lamb", "weight_decay": 0.01},
    {"name": "adam", "learning_rate": {"schedule": "warmup_cosine", "init_value": 0.0,
                                       "peak_value": 0.01, "warmup_steps": 2,
                                       "decay_steps": 5}},
]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: str(s if isinstance(s, str) else
                                                         sorted(s.items())))
def test_optimizer_matches_optax(spec):
    """Five updates of a seeded parameter tree with seeded gradients."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    tx, _ = jax_compile.resolve_optimizer(spec)
    state = tx.init(params)
    builder, _ = port_compile.resolve_optimizer(spec)
    leaves = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in SHAPES]
    opt = builder(leaves)
    want = dict(params)
    for g in grads:
        updates, state = tx.update(g, state, want)
        want = optax.apply_updates(want, updates)
        for leaf, k in zip(leaves, SHAPES):
            leaf.grad = torch.from_numpy(g[k])
        opt.step()
    for leaf, k in zip(leaves, SHAPES):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want[k]), atol=1e-6)
    assert all(group["count"] == 5 for group in opt.param_groups)


def test_missing_gradient_counts_as_zero():
    """optax always sees a gradient; a parameter torch left without one
    moves as if its gradient were 0 (adam's moments still decay)."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    tx, _ = jax_compile.resolve_optimizer("adam")
    state = tx.init(params)
    builder, _ = port_compile.resolve_optimizer("adam")
    leaves = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in SHAPES]
    opt = builder(leaves)
    want = dict(params)
    for i in range(2):
        g = _tree(rng) if i == 0 else {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
        updates, state = tx.update(g, state, want)
        want = optax.apply_updates(want, updates)
        for leaf, k in zip(leaves, SHAPES):
            leaf.grad = torch.from_numpy(g[k]) if i == 0 else None
        opt.step()
    for leaf, k in zip(leaves, SHAPES):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want[k]), atol=1e-6)


SCHEDULE_SPECS = {
    "constant": [{"value": 0.1}],
    "exponential_decay": [
        {"init_value": 0.1, "transition_steps": 4, "decay_rate": 0.5},
        {"init_value": 0.1, "transition_steps": 3, "decay_rate": 0.7,
         "transition_begin": 5, "staircase": True, "end_value": 0.02},
        {"init_value": 0.1, "transition_steps": 2, "decay_rate": 2.0, "end_value": 0.5},
        {"init_value": 0.1, "transition_steps": 0, "decay_rate": 0.5},
    ],
    "cosine_decay": [
        {"init_value": 0.1, "decay_steps": 20},
        {"init_value": 0.1, "decay_steps": 12, "alpha": 0.1, "exponent": 2.0},
    ],
    "piecewise_constant": [
        {"init_value": 0.1, "boundaries_and_scales": {5: 0.5, 12: 0.1, 20: 2.0}},
        {"init_value": 0.1},
    ],
    "warmup_cosine": [
        {"init_value": 0.0, "peak_value": 0.1, "warmup_steps": 5, "decay_steps": 25},
        {"init_value": 0.01, "peak_value": 0.1, "warmup_steps": 3, "decay_steps": 20,
         "end_value": 0.001, "exponent": 1.5},
    ],
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_SPECS))
def test_schedule_matches_optax(name):
    assert set(port_compile.SCHEDULES) == set(jax_compile.SCHEDULES)
    for kwargs in SCHEDULE_SPECS[name]:
        want = jax_compile.SCHEDULES[name](**kwargs)
        got = port_compile.SCHEDULES[name](**kwargs)
        for count in range(31):
            np.testing.assert_allclose(got(count), float(want(jnp.asarray(count))),
                                       rtol=1e-6, atol=1e-9, err_msg=f"{kwargs} @ {count}")


def test_schedule_errors_match_optax():
    for name, kwargs in [("cosine_decay", {"init_value": 0.1, "decay_steps": 0}),
                         ("piecewise_constant",
                          {"init_value": 0.1, "boundaries_and_scales": {3: -1.0}})]:
        with pytest.raises(ValueError):
            jax_compile.SCHEDULES[name](**kwargs)
        with pytest.raises(ValueError):
            port_compile.SCHEDULES[name](**kwargs)


@pytest.mark.parametrize("spec", [
    "adam",
    {"name": "SGD", "learning_rate": 0.1},
    {"name": "adamw", "injected": True, "weight_decay": 0.01},
    {"name": "momentum", "injected": True,
     "learning_rate": {"schedule": "exponential_decay", "init_value": 0.1,
                       "transition_steps": 2, "decay_rate": 0.5}},
])
def test_optimizer_config_matches_jax(spec):
    _, want = jax_compile.resolve_optimizer(spec)
    builder, got = port_compile.resolve_optimizer(spec)
    assert got == want
    opt = builder([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, torch.optim.Optimizer)


def test_injected_learning_rate_lives_in_param_groups():
    """The learning rate can change between updates without rebuilding."""
    builder, config = port_compile.resolve_optimizer(
        {"name": "sgd", "learning_rate": 0.1, "injected": True})
    assert config["injected"] is True
    p = torch.nn.Parameter(torch.ones(3))
    opt = builder([p])
    p.grad = torch.ones(3)
    opt.step()
    opt.param_groups[0]["lr"] = 0.5
    opt.step()
    torch.testing.assert_close(p.detach(), torch.full((3,), 1.0 - 0.1 - 0.5))


def test_resolve_optimizer_errors_and_passthrough():
    with pytest.raises(ValueError, match="unknown optimizer"):
        port_compile.resolve_optimizer("adadelta")
    with pytest.raises(ValueError, match="schedule"):
        port_compile.resolve_optimizer({"name": "adam", "learning_rate": {"init_value": 1}})
    with pytest.raises(ValueError, match="unknown lr schedule"):
        port_compile.resolve_optimizer(
            {"name": "adam", "learning_rate": {"schedule": "linear"}})
    with pytest.raises(TypeError):
        port_compile.resolve_optimizer({"name": "adam", "mu_dtype": "bfloat16"})[0](
            [torch.nn.Parameter(torch.zeros(1))])

    def builder(params):
        return torch.optim.SGD(params, lr=0.1)

    assert port_compile.resolve_optimizer(builder) == (builder, None)
