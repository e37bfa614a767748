"""Parity of the port's synchronous ``fit`` on the ResNet with the JAX
package's: two gloo processes against ``elephas_tpu.SparkModel(
num_workers=2)``, frequency epoch, which pins the averaging of the
BatchNorm statistics at the end of each epoch.

The JAX side runs in float64 (``jax.enable_x64``; its head stays float32
as the model has it), for the reason ``test_torch_resnet.py`` gives: its
float32 gradients on the CPU stray from its own float64 ones by more than
the port's float32 gradients do. Limits as ``test_torch_fit.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
from test_torch_fit import _assert_match, _jax_fit, _jax_model, _job, _port_state, _spawn

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu_torch.models import get_model


def test_resnet_fit_averages_batch_stats(tmp_path):
    """ResNet-18 at width 4 on two ranks, one batch of 8 each per epoch,
    two epochs: each rank's BatchNorm statistics are its own during the
    epoch and are averaged at its end, with the parameters and the
    momentum traces."""
    rng = np.random.default_rng(5)
    x = rng.random((16, 8, 8, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    sgd = {"name": "momentum", "learning_rate": 0.05}
    kwargs = {"width": 4}
    jm = _jax_model("resnet18", kwargs, sgd, (8, 8, 3))
    state = _port_state(jm, "resnet18", kwargs)
    with jax.enable_x64(True):
        wide = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                      {"params": jm.params, "stats": jm.batch_stats})
        jm64 = JaxCompiledModel(jax_get_model("resnet18", dtype="float64", **kwargs),
                                wide["params"], optimizer=sgd,
                                loss="categorical_crossentropy", metrics=["acc"],
                                batch_stats=wide["stats"])
        want = _jax_fit(jm64, x.astype(np.float64), y, 2, "epoch", 8, epochs=2,
                        eval_batch=8)
    (port,) = _spawn(tmp_path, 2, [_job(tmp_path, "resnet", state, x, y, "epoch", 8,
                                        model="resnet18", kwargs=kwargs, optimizer=sgd,
                                        epochs=2, eval_batch=8)])
    _assert_match(port, want, get_model("resnet18", device="cpu", **kwargs))
    for k, v in want["evaluate"].items():
        assert abs(port["evaluate"][k] - v) <= 1e-5 * max(1.0, abs(v)), (k, port["evaluate"], v)
