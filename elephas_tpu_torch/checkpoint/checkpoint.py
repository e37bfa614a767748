"""Train-state checkpointing (counterpart of
``elephas_tpu/checkpoint/checkpoint.py``, which writes with Orbax).

Layout: ``<directory>/<step>/state.pt`` per snapshot, one ``torch.save``
of a dict holding the module's ``state_dict`` (parameters and BatchNorm
statistics), the optimizer's state (per-parameter tensors, and each
param group's hyperparameters with the update ``count`` that drives
bias corrections and schedules), the ``TrainState``'s generator state,
its step and its epoch count. Tensors are saved on the CPU and restored
onto the target module's device, so a snapshot taken on the card
resumes on the CPU and the other way round. A snapshot is written into
a temporary directory and renamed into place, so a step directory is
always whole.

Only rank 0 of a ``torch.distributed`` group writes (the ranks hold the
same replicated state and share one host's disk); every rank may read.
A tensor-parallel state (``parallel.tensor_parallel``) is gathered whole
before rank 0 writes it, its parameters and their optimizer slots along
their sharded dims, so every rank of the model group takes part in a
save; a restore gives each rank its shard again. A snapshot is the same
whichever layout took it: one taken under tensor parallelism restores
into one process, and the other way round.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

import torch
import torch.distributed as dist

from elephas_tpu_torch.engine.state import TrainState

STATE_FILE = "state.pt"


class NoCheckpointError(FileNotFoundError):
    """No restorable checkpoint exists under the given directory.

    Raised by every restore path here instead of a raw
    ``FileNotFoundError``, so "cold start" is one clearly named branch
    for callers::

        try:
            state = manager.restore(target)
        except NoCheckpointError:
            state = cold_init()

    Subclasses ``FileNotFoundError`` so existing handlers keep working.
    """


def latest_step(directory: str) -> Optional[int]:
    """Highest numbered snapshot step under ``directory``, or None: a
    filename scan of the ``<directory>/<step>/`` layout, with no manager
    built, to decide cheaply whether a resume is possible."""
    try:
        steps = [int(d) for d in os.listdir(os.path.abspath(directory)) if d.isdigit()]
    except (FileNotFoundError, NotADirectoryError):
        return None
    return max(steps) if steps else None


def _cpu(value):
    return value.detach().to("cpu", copy=True) if torch.is_tensor(value) else value


def _param_names(module, optimizer) -> list:
    """The parameter name of each index of ``optimizer.state_dict()``."""
    names = {id(p): n for n, p in module.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups for p in group["params"]]


def _slots(opt_state: dict, names: list, module, convert) -> dict:
    """Each optimizer slot shaped like its parameter passed through
    ``convert(name, tensor)`` (a gather or a slice), in index order."""
    out = {}
    for i in sorted(opt_state):
        shape = module.get_parameter(names[i]).shape
        out[i] = {k: convert(names[i], v) if torch.is_tensor(v) and v.shape == shape else v
                  for k, v in opt_state[i].items()}
    return out


def _snapshot(state: TrainState, step: int) -> dict:
    """A CPU copy of everything ``state`` trains, taken now (training
    goes on changing the tensors in place); a tensor-parallel state
    gathered whole."""
    if state.module is None:
        raise ValueError("the TrainState names no module (make it with "
                         "engine.step.init_train_state)")
    opt = state.optimizer.state_dict()
    module = state.module.state_dict()
    tp = getattr(state.module, "_tensor_parallel", None)
    if tp is not None:
        module = tp.full_state(module)
        opt = {**opt, "state": _slots(opt["state"], _param_names(state.module, state.optimizer),
                                      state.module, tp.gather)}
    return {
        "step": step,
        "epoch": int(state.epoch),
        "module": {k: _cpu(v) for k, v in module.items()},
        "optimizer": {
            "state": {i: {k: _cpu(v) for k, v in s.items()} for i, s in opt["state"].items()},
            # A schedule is a function, not data: the target's own stays.
            "param_groups": [{k: v for k, v in g.items() if k != "schedule"}
                             for g in opt["param_groups"]],
        },
        "rng": state.rng.get_state(),
        "batch_stats": state.batch_stats,
    }


def _writer() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _write(directory: str, snapshot: dict) -> None:
    final = os.path.join(directory, str(snapshot["step"]))
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save(snapshot, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def _load_into(target: TrainState, directory: str, step: int) -> TrainState:
    path = os.path.join(directory, str(step), STATE_FILE)
    if not os.path.exists(path):
        raise NoCheckpointError(f"no checkpoint at step {step} under {directory}")
    if target.module is None:
        raise ValueError("the target TrainState names no module (make it with "
                         "engine.step.init_train_state)")
    snap = torch.load(path, map_location="cpu", weights_only=True)
    slots = snap["optimizer"]["state"]
    tp = getattr(target.module, "_tensor_parallel", None)
    if tp is not None:
        full = {n: p.shape for n, p in snap["module"].items()}
        snap["module"] = tp.local_state(snap["module"])
        names = _param_names(target.module, target.optimizer)
        slots = {i: {k: tp.local(names[i], v) if torch.is_tensor(v)
                     and v.shape == full[names[i]] else v
                     for k, v in s.items()} for i, s in slots.items()}
    target.module.load_state_dict(snap["module"])
    live = target.optimizer.state_dict()["param_groups"]
    groups = [{**mine, **saved} for mine, saved in zip(live, snap["optimizer"]["param_groups"])]
    target.optimizer.load_state_dict({"state": slots, "param_groups": groups})
    target.rng.set_state(snap["rng"])
    target.step, target.epoch = snap["step"], snap["epoch"]
    target.batch_stats = snap["batch_stats"]
    return target


def _cold(directory: str) -> NoCheckpointError:
    return NoCheckpointError(f"no checkpoints under {directory} (cold start: "
                             "initialize fresh state instead of restoring)")


class CheckpointManager:
    """Rotating snapshot manager and fit-callback factory.

    ``keep``: the newest snapshots kept (by step). ``save_every_epochs``:
    the callback's cadence. ``host0_only`` is accepted for the JAX
    package's signature and ignored: rank 0 alone writes in every mode.
    """

    def __init__(self, directory: str, keep: int = 3, save_every_epochs: int = 1,
                 host0_only: bool = False):
        self.directory = os.path.abspath(directory)
        self.keep = max(1, keep)
        self.save_every = max(1, save_every_epochs)
        self.host0_only = host0_only
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, state: TrainState, step: Optional[int] = None, block: bool = False) -> None:
        """Snapshot ``state``: copied to host memory now, written to disk
        on a background thread (one write in flight; a new save waits for
        the last), so training does not stall on the disk. ``wait()`` (or
        ``block=True``) waits for the write."""
        step = int(state.step) if step is None else int(step)
        snapshot = _snapshot(state, step)
        self.wait()
        if _writer():
            self._thread = threading.Thread(target=self._write_and_rotate, args=(snapshot,),
                                            name="checkpoint-writer", daemon=True)
            self._thread.start()
        if block:
            self.wait()

    def _write_and_rotate(self, snapshot: dict) -> None:
        try:
            _write(self.directory, snapshot)
            steps = sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())
            for old in steps[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        except Exception as exc:  # surfaced by wait() on the caller's thread
            self._error = exc

    def wait(self) -> None:
        """Wait for the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("a checkpoint write failed") from error

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    def restore(self, target: TrainState, step: Optional[int] = None) -> TrainState:
        """Load snapshot ``step`` (default: the latest) into ``target``
        (``init_train_state(model)``): its module's weights, optimizer,
        generator, step and epoch count. Returns ``target``, ready for
        ``SparkModel.fit(initial_state=...)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise _cold(self.directory)
        return _load_into(target, self.directory, step)

    def callback(self):
        """An ``(epoch, state, metrics)`` callback for ``fit``: saves every
        ``save_every_epochs`` epochs; ``SparkModel.fit`` waits for the last
        write through its ``on_fit_end`` hook."""
        return _CheckpointCallback(self)

    def close(self) -> None:
        self.wait()


class _CheckpointCallback:
    def __init__(self, manager: CheckpointManager):
        self._manager = manager

    def __call__(self, epoch: int, state: TrainState, metrics: dict) -> None:
        if (epoch + 1) % self._manager.save_every == 0:
            self._manager.save(state)

    def on_fit_end(self) -> None:
        self._manager.wait()


def save_train_state(directory: str, state: TrainState, step: Optional[int] = None) -> None:
    """One-shot save (no rotation), written before it returns."""
    step = int(state.step) if step is None else int(step)
    snapshot = _snapshot(state, step)
    if _writer():
        os.makedirs(os.path.abspath(directory), exist_ok=True)
        _write(os.path.abspath(directory), snapshot)


def restore_train_state(directory: str, target: TrainState,
                        step: Optional[int] = None) -> TrainState:
    """One-shot restore into ``target``; the highest step if unspecified."""
    directory = os.path.abspath(directory)
    step = latest_step(directory) if step is None else step
    if step is None:
        raise _cold(directory)
    return _load_into(target, directory, step)
