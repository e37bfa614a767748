"""``convert.from_optax_state`` for the optimizers a JAX checkpoint hands
over beyond sgd and adam: one JAX step, the params and optax state
carried into the port, then one more step on each side agrees. On the
small LSTM (vocab 50, embed 8, hidden 8, sequences of 12, batch 4), on
the CPU. Limits: the second step's loss 1e-6 relative, and each
parameter after it 1e-6 of its norm.
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
from elephas_tpu_torch.convert import from_flax_params, from_optax_state
from elephas_tpu_torch.engine import step as port_step
from elephas_tpu_torch.engine.state import TrainState
from elephas_tpu_torch.models import get_model

SMALL = dict(vocab_size=50, embed_dim=8, hidden_dim=8)
DECAY = {"schedule": "exponential_decay", "init_value": 1e-2, "transition_steps": 1,
         "decay_rate": 0.5}
OPTIMIZERS = {
    "rmsprop": {"name": "rmsprop", "learning_rate": 1e-2},
    "rmsprop_momentum_centered": {"name": "rmsprop", "learning_rate": 1e-2, "momentum": 0.9,
                                  "centered": True},
    "adagrad": {"name": "adagrad", "learning_rate": 1e-1},
    "lamb": {"name": "lamb", "learning_rate": 1e-2},
    "adam_injected": {"name": "adam", "learning_rate": 1e-2, "injected": True},
    "adam_injected_schedule": {"name": "adam", "learning_rate": DECAY, "injected": True},
    "momentum_injected": {"name": "momentum", "learning_rate": 5e-2, "injected": True},
}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 50, (4, 12)).astype(np.int32), rng.integers(0, 2, 4).astype(np.int32)


@pytest.fixture(scope="module")
def flax_params():
    module = jax_get_model("lstm", **SMALL)
    return jax.device_get(module.init(jax.random.PRNGKey(0), jnp.zeros((1, 12), jnp.int32))
                          ["params"])


def _port(params, optimizer):
    module = get_model("lstm", device="cpu", **SMALL)
    return CompiledModel(module, from_flax_params(params, module), optimizer=optimizer,
                         loss="sparse_categorical_crossentropy", metrics=["acc"])


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_resume_jax_optimizer_state_in_port(flax_params, name):
    jm = JaxCompiledModel(jax_get_model("lstm", **SMALL), flax_params,
                          optimizer=OPTIMIZERS[name], loss="sparse_categorical_crossentropy",
                          metrics=["acc"])
    step = jax.jit(jax_step.make_train_step(jm))
    state, _ = step(jax_step.init_train_state(jm), *_batch(0))
    pm = _port(jax.device_get(state.params), OPTIMIZERS[name])
    optimizer = from_optax_state(jax.device_get(state.opt_state), pm)
    # rmsprop and adagrad keep no update count in optax (none drives them).
    count = 0 if name.startswith(("rmsprop", "adagrad")) else 1
    assert all(group["count"] == count for group in optimizer.param_groups)
    if name == "adam_injected_schedule":  # the injected rate: the schedule's at count 0
        assert optimizer.param_groups[0]["lr"] == pytest.approx(1e-2, rel=1e-6)
    pstate = TrainState.create(optimizer, step=1, module=pm.module)

    x, y = _batch(1)
    state, metrics = step(state, x, y)
    pstate, pmetrics = port_step.make_train_step(pm)(pstate, torch.as_tensor(x),
                                                      torch.as_tensor(y))
    np.testing.assert_allclose(float(pmetrics["loss"]), float(metrics["loss"]), rtol=1e-6)
    want = from_flax_params(jax.device_get(state.params), pm.module)
    for key, got in pm.module.state_dict().items():
        ref = want[key].numpy()
        err = np.linalg.norm(got.numpy() - ref)
        assert err <= 1e-6 * np.linalg.norm(ref), (key, err)


def test_state_fields_carried_by_name(flax_params):
    """Each optimizer's per-parameter state lands under optax's field
    name: rmsprop ``nu`` (and ``mu``, ``trace`` centered with momentum),
    adagrad ``sum_of_squares`` (starting at 0.1, optax's fill), lamb
    ``mu`` and ``nu``."""
    expect = {"rmsprop": {"nu"}, "rmsprop_momentum_centered": {"mu", "nu", "trace"},
              "adagrad": {"sum_of_squares"}, "lamb": {"mu", "nu"}}
    for name, fields in expect.items():
        jm = JaxCompiledModel(jax_get_model("lstm", **SMALL), flax_params,
                              optimizer=OPTIMIZERS[name],
                              loss="sparse_categorical_crossentropy", metrics=[])
        optimizer = from_optax_state(jax.device_get(jm.init_opt_state()),
                                     _port(flax_params, OPTIMIZERS[name]))
        for per_param in optimizer.state.values():
            assert set(per_param) == fields, name
        if name == "adagrad":
            assert all(torch.all(s["sum_of_squares"] == np.float32(0.1))
                       for s in optimizer.state.values())
