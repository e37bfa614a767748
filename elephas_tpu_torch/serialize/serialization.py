"""Model <-> dict wire format (counterpart of
``elephas_tpu/serialize/serialization.py``).

The payload has the JAX package's keys: ``arch``, ``weights``,
``batch_stats``, ``optimizer``, ``loss``, ``metrics``, ``input_shape``,
``input_dtype``. For a registry model the architecture is its registry
config and the weights are the flax layout (nested dicts of NumPy
arrays, ``convert.to_flax_params``/``to_flax_batch_stats``), so a payload
written by either package loads in the other. The config leaves out the
port's ``device`` keyword, which the JAX builders do not take, and
``dict_to_model`` places the model on the device its caller asks for: a
payload written on the card loads on the CPU and the other way round.

A module from outside the registry is pickled (``arch.kind ==
"pickle"``, a CPU copy) and its weights are its ``state_dict`` as NumPy
arrays: such payloads load in the port only, as the JAX package's
pickled flax modules load in the JAX package only. Optimizers without a
config, and callable losses and metrics, are pickled too.

``input_dtype`` is a NumPy dtype name (``"int32"``, ``"float32"``).
Parameters must have a NumPy type: a bfloat16 parameter raises (the
registry models keep float32 parameters whatever their compute dtype).
"""

from __future__ import annotations

import copy
import pickle
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from elephas_tpu_torch.convert import from_flax_params, to_flax_batch_stats, to_flax_params
from elephas_tpu_torch.utils.device import resolve_device


def _dtype_name(dtype) -> str:
    """The NumPy name of a torch or NumPy dtype (``torch.int32`` -> ``"int32"``)."""
    if isinstance(dtype, torch.dtype):
        return str(torch.empty(0, dtype=dtype).numpy().dtype)
    return str(np.dtype(dtype))


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a NumPy dtype name (``"int32"`` -> ``torch.int32``)."""
    return torch.from_numpy(np.zeros(0, dtype=name)).dtype


def _pickled(obj) -> dict:
    return {"kind": "pickle", "payload": pickle.dumps(obj)}


def model_to_dict(compiled) -> dict:
    """Serialize a ``CompiledModel`` to a plain dict."""
    module = compiled.module
    state = module.state_dict()
    low = sorted(name for name, t in state.items() if t.dtype == torch.bfloat16)
    if low:
        raise TypeError(f"bfloat16 parameters have no NumPy type for the payload: {low}; "
                        "keep parameters in float32 (the compute dtype may be bfloat16)")
    if compiled.model_config is not None:
        config = compiled.model_config
        kwargs = {k: v for k, v in config["kwargs"].items() if k != "device"}
        arch = {"kind": "registry", "config": {"name": config["name"], "kwargs": kwargs}}
        weights = to_flax_params(state, module)
        batch_stats = to_flax_batch_stats(state, module)
    else:
        arch = _pickled(copy.deepcopy(module).cpu())
        weights = {name: t.detach().cpu().numpy() for name, t in state.items()}
        batch_stats = {}
    if compiled.optimizer_config is not None:
        opt = {"kind": "config", "config": compiled.optimizer_config}
    else:
        opt = _pickled(compiled.optimizer)
    loss = compiled.loss_spec if isinstance(compiled.loss_spec, str) else _pickled(
        compiled.loss_spec)
    metrics = [m if isinstance(m, str) else _pickled(m) for m in compiled.metric_specs]
    return {
        "arch": arch,
        "weights": weights,
        "batch_stats": batch_stats,
        "optimizer": opt,
        "loss": loss,
        "metrics": metrics,
        "input_shape": compiled.input_shape,
        "input_dtype": _dtype_name(compiled.input_dtype) if compiled.input_shape else None,
    }


def _unpickled(spec):
    return pickle.loads(spec["payload"]) if isinstance(spec, dict) else spec


def dict_to_model(payload: dict, custom_objects: Optional[dict] = None, device=None):
    """Rebuild a ``CompiledModel`` from ``model_to_dict`` output, on
    ``device`` (None: ``cuda``, as every entry point).

    ``custom_objects`` mirrors the reference kwarg: a builder listed
    under a registry name replaces the registry's (called with the
    config's keyword arguments and ``device``), and the model then
    carries no registry config.
    """
    from elephas_tpu_torch.api.compile import CompiledModel
    from elephas_tpu_torch.models import get_model

    custom_objects = custom_objects or {}
    device = resolve_device(device)
    arch = payload["arch"]
    if arch["kind"] == "registry":
        name = arch["config"]["name"]
        kwargs = {k: v for k, v in arch["config"]["kwargs"].items() if k != "device"}
        if name in custom_objects:
            module = custom_objects[name](**kwargs, device=device)
            model_config = None
        else:
            module = get_model(name, device=device, **kwargs)
            model_config = {"name": name, "kwargs": kwargs}
        params = from_flax_params(payload["weights"], module, payload.get("batch_stats"))
    elif arch["kind"] == "pickle":
        module = pickle.loads(arch["payload"])
        if not isinstance(module, nn.Module):
            raise TypeError(
                f"the pickled architecture is a {type(module).__name__}, not a torch module "
                "(a JAX package payload's pickled flax module loads in that package only)")
        module.to(device)
        params = {k: torch.as_tensor(np.asarray(v)) for k, v in payload["weights"].items()}
        model_config = None
    else:
        raise ValueError(f"unknown architecture kind {arch['kind']!r}")

    opt = payload["optimizer"]
    optimizer = opt["config"] if opt["kind"] == "config" else _unpickled(opt)
    input_dtype = payload.get("input_dtype")
    return CompiledModel(
        module,
        params,
        optimizer=optimizer,
        loss=_unpickled(payload["loss"]),
        metrics=[_unpickled(m) for m in payload.get("metrics", ())],
        input_shape=payload.get("input_shape"),
        input_dtype=torch_dtype(input_dtype) if input_dtype else torch.float32,
        model_config=model_config,
    )
