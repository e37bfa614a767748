"""SparkModel-compatible driver API (counterpart of ``elephas_tpu/api/spark_model.py``).

Reference: ``elephas/spark_model.py::SparkModel``
(SURVEY.md §2.1, §3.1, §3.5). The constructor signature, the
mode/frequency semantics and the fit/predict/evaluate surface are the
JAX package's.

- ``mode="synchronous"`` (``engine/sync.py``): Spark executors become the
  processes of a ``torch.distributed`` group, one per device
  (``parallel/mesh.py``); one process with no group is a group of one.
- ``mode="asynchronous"`` (the default) and ``"hogwild"``
  (``engine/async_engine.py``): Downpour SGD, one worker thread per
  device of the worker list against a parameter server on the card
  (``parameter/``), locked or lock-free. Under a ``torch.distributed``
  group of several processes the wire transports (``http``/``socket``)
  run one server on rank 0 that every rank's workers dial (the job's
  partitions are the ranks' workers together); every rank calls ``fit``,
  then ``predict`` and ``evaluate`` run on the whole group and give
  every rank the same answer.

``save`` writes the JAX package's pickled dict around a
``model_to_dict`` payload and ``load_spark_model`` reads it back; the
constructor takes such a payload as well as a ``CompiledModel``.
``SparkMLlibModel`` trains on LabeledPoints. ``autotune`` times the
eager step against the step captured as a CUDA graph at the start of a
fit and trains with the faster (``utils/compiler.py``); ``fit(...,
stream_batches=N)`` streams the data to the device in chunks of N
batches instead of uploading it once. Not ported yet, and raising where
asked for: Keras models (the Keras bridge; ROADMAP.md, queue 1).
"""

from __future__ import annotations

import logging
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from elephas_tpu_torch.api.compile import CompiledModel
from elephas_tpu_torch.data.rdd import ShardedDataset, lp_to_simple_rdd
from elephas_tpu_torch.engine.async_engine import AsyncTrainer, default_worker_devices
from elephas_tpu_torch.engine.step import init_train_state
from elephas_tpu_torch.engine.sync import SyncTrainer
from elephas_tpu_torch.parallel.mesh import build_mesh, world
from elephas_tpu_torch.serialize.serialization import dict_to_model, model_to_dict
from elephas_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

MODES = ("synchronous", "asynchronous", "hogwild")
FREQUENCIES = ("batch", "epoch", "fit")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it arrives with {item} "
                               "(ROADMAP.md, queue 1)")


class TpuModel:
    """Driver-side distributed model (the reference's ``SparkModel``).

    Parameters mirror the reference constructor and the JAX package's:

    mode: 'synchronous' | 'asynchronous' (Downpour SGD, locked parameter
        server) | 'hogwild' (lock-free).
    frequency: 'batch' | 'epoch' | 'fit' — the averaging granularity of
        synchronous training (``engine/sync.py``); 'batch' | 'epoch' — the
        pull/train/push unit of the asynchronous modes.
    parameter_server_mode: 'local' | 'http' | 'socket' (asynchronous
        modes): the transport between the workers and the parameter
        server (``parameter/``); ``port`` its port (0: a free one).
    hogwild_granularity: 'tree' | 'leaf', the hogwild apply isolation
        (``parameter.buffer.ParameterBuffer``).
    max_failures: attempts per asynchronous unit before a worker fault
        fails the fit (Spark's ``spark.task.maxFailures``).
    pipelined_comms: asynchronous modes: each worker's parameter-server
        traffic on a background thread (default: on for the wire
        transports).
    num_workers: synchronous: the data-group size, defaulting to the
        world size (one process per device). Asynchronous: the number of
        worker threads of this process, defaulting to the length of the
        worker device list (across processes the job's workers are every
        rank's together). Either is capped with a warning.
    custom_objects: builders by registry name, used where ``model`` is a
        ``model_to_dict`` payload (``serialize.dict_to_model``).
    device: where a payload's model is built (None: ``cuda``).
    batch_size: default per-worker batch size for ``fit``.
    mesh: synchronous: an optional pre-built ``parallel.mesh.Mesh``.
        Asynchronous: the workers' devices, a list in which a device may
        repeat (several workers on one card, each on its own stream);
        default one per visible card of the model's device type.
    autotune: at the start of each fit, time the eager train step
        against the same step captured as one CUDA graph (on a card;
        elsewhere there is one candidate) on 2 batches of real rows, and
        train with the faster; ``last_autotune`` and the history's
        ``compile_autotune`` record the winner ('default', 'cuda_graph',
        or 'skipped' where the fit cannot use it). A synchronous fit of
        several ranks on cards times only the eager step, and
        ``compile_autotune_note`` says why.
    """

    def __init__(
        self,
        model,
        mode: str = "asynchronous",
        frequency: str = "epoch",
        parameter_server_mode: str = "local",
        num_workers: Optional[int] = None,
        port: int = 4000,
        custom_objects: Optional[dict] = None,
        batch_size: int = 32,
        mesh=None,
        hogwild_granularity: str = "tree",
        max_failures: int = 4,
        autotune: bool = False,
        pipelined_comms: Optional[bool] = None,
        device=None,
    ):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if frequency not in FREQUENCIES:
            raise ValueError(f"frequency must be one of {FREQUENCIES}, got {frequency!r}")
        if hogwild_granularity not in ("tree", "leaf"):
            raise ValueError(
                f"hogwild_granularity must be tree|leaf, got {hogwild_granularity!r}"
            )
        if max_failures < 1:
            raise ValueError(f"max_failures must be >= 1, got {max_failures}")
        if isinstance(model, dict):
            model = dict_to_model(model, custom_objects, device=device)
        if not isinstance(model, CompiledModel):
            if type(model).__module__.split(".")[0] == "keras":
                raise _not_ported("a Keras model", "item 3's Keras bridge "
                                  "(serialize/keras_bridge.py)")
            raise TypeError(
                "model must be a CompiledModel; wrap modules with "
                "elephas_tpu_torch.compile_model"
            )
        self._master = model
        self.mode = mode
        self.frequency = frequency
        self.parameter_server_mode = parameter_server_mode
        self.port = port
        self.hogwild_granularity = hogwild_granularity
        self.max_failures = max_failures
        self.pipelined_comms = pipelined_comms
        self.autotune = autotune
        self.last_autotune = None
        self.custom_objects = custom_objects or {}
        self.batch_size = batch_size
        self.last_epoch_end_times = None
        self.async_trainer = None  # the last asynchronous fit's trainer

        self._worker_devices = None
        if mode == "synchronous":
            n_devices = world()[0]
        else:
            devices = (default_worker_devices(next(model.module.parameters()).device)
                       if mesh is None else [resolve_device(d) for d in mesh])
            n_devices = len(devices)
        if num_workers is None:
            num_workers = n_devices
        if num_workers > n_devices:
            logger.warning(
                "num_workers=%d exceeds device count %d; capping (one worker per chip)",
                num_workers,
                n_devices,
            )
            num_workers = n_devices
        self.num_workers = num_workers
        if mode == "synchronous":
            self._mesh = mesh
        else:
            self._worker_devices = devices[:num_workers]
            self._mesh = None
        self._state = None  # latest TrainState (post-fit)
        self._sync_trainer = None
        self.training_histories: List[Dict[str, List[float]]] = []

    # -- reference surface -----------------------------------------------------

    @property
    def master_network(self) -> CompiledModel:
        return self._master

    @master_network.setter
    def master_network(self, model: CompiledModel) -> None:
        self._master = model
        self._state = None
        self._sync_trainer = None

    def get_weights(self):
        return self._master.get_weights()

    def set_weights(self, params) -> None:
        self._master.set_weights(params)
        self._state = None

    @property
    def mesh(self):
        """The synchronous data group; the asynchronous modes evaluate and
        predict on the whole process group (one process alone)."""
        if self._mesh is None:
            self._mesh = build_mesh(num_data=self.num_workers if self.mode == "synchronous"
                                    else None)
        return self._mesh

    def _as_dataset(self, data) -> ShardedDataset:
        if isinstance(data, ShardedDataset):
            if data.num_partitions != self.num_workers:
                data = data.repartition(self.num_workers)
            return data
        if isinstance(data, tuple) and len(data) == 2:
            return ShardedDataset(data[0], data[1], self.num_workers)
        if isinstance(data, np.ndarray):
            return ShardedDataset(data, None, self.num_workers)
        raise TypeError(f"cannot interpret training data of type {type(data)}")

    def fit(
        self,
        rdd,
        epochs: int = 10,
        batch_size: Optional[int] = None,
        verbose: int = 0,
        validation_split: float = 0.0,
        validation_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        callbacks=(),
        stream_batches: Optional[int] = None,
        initial_state=None,
    ) -> Dict[str, List[float]]:
        """Train on a ShardedDataset (or ``(x, y)``), reference §3.1.

        ``validation_split`` holds out the last rows, ``validation_data``
        is evaluated after every epoch (``val_*`` keys of the history), and
        each callback is called as ``cb(epoch, state, metrics)`` after
        every epoch, and its ``on_fit_end()`` (where it has one) after the
        fit. ``initial_state``: a ``TrainState`` to resume from, restored
        into this model's module (``checkpoint.CheckpointManager.restore(
        init_train_state(model.master_network))``). ``stream_batches``:
        hold at most about three chunks of that many batches of the data
        on the device (a double-buffered host-to-device pipeline) instead
        of all of it: each process of the synchronous group streams its
        partition, each asynchronous worker its own.

        In the asynchronous modes the parameter server's final weights are
        folded back into the master network, and ``last_epoch_end_times``
        holds the wall time at which the slowest worker finished each
        epoch (the training cadence; callbacks run on a drainer thread
        that lags it).
        """
        if initial_state is not None and initial_state.module not in (None, self._master.module):
            raise ValueError("initial_state trains another module: restore it into this "
                             "model's (init_train_state(model.master_network))")
        batch_size = batch_size or self.batch_size
        dataset = self._as_dataset(rdd)
        if dataset.labels is None:
            raise ValueError("fit needs labels")
        if validation_data is not None:
            # One pair of array objects for the whole fit: the evaluator's
            # device cache is keyed by their identity.
            validation_data = (np.asarray(validation_data[0]), np.asarray(validation_data[1]))
        if validation_data is None and validation_split > 0:
            n_val = int(len(dataset) * validation_split)
            if n_val:
                validation_data = (dataset.features[-n_val:], dataset.labels[-n_val:])
                dataset = ShardedDataset(dataset.features[:-n_val], dataset.labels[:-n_val],
                                         dataset.num_partitions)

        if self.mode == "synchronous":
            trainer = SyncTrainer(self._master, self.mesh, frequency=self.frequency,
                                  autotune=self.autotune)
            state, history = trainer.fit(
                dataset,
                epochs=epochs,
                batch_size=batch_size,
                validation_data=validation_data,
                verbose=verbose,
                callbacks=callbacks,
                initial_state=initial_state,
                stream_batches=stream_batches,
            )
            self._sync_trainer = trainer
        else:
            trainer = AsyncTrainer(
                self._master,
                self._worker_devices,
                frequency=self.frequency,
                lock=(self.mode == "asynchronous"),
                parameter_server_mode=self.parameter_server_mode,
                port=self.port,
                granularity=(self.hogwild_granularity if self.mode == "hogwild"
                             else "tree"),
                max_failures=self.max_failures,
                autotune=self.autotune,
                stream_batches=stream_batches,
                pipelined_comms=self.pipelined_comms,
            )
            state, history = trainer.fit(
                dataset,
                epochs=epochs,
                batch_size=batch_size,
                validation_data=validation_data,
                verbose=verbose,
                callbacks=callbacks,
                initial_step=int(initial_state.step) if initial_state is not None else 0,
            )
            self._sync_trainer = None
            self.async_trainer = trainer
            self.last_epoch_end_times = trainer.epoch_end_times
        # Which step trained, on the model and in the history.
        self.last_autotune = trainer.autotune_choice
        if self.last_autotune is not None:
            history["compile_autotune"] = self.last_autotune["winner"]
            if "note" in self.last_autotune:
                history["compile_autotune_note"] = self.last_autotune["note"]
        for cb in callbacks:
            hook = getattr(cb, "on_fit_end", None)
            if hook is not None:
                hook()
        # The master network's module holds the trained weights already:
        # synchronous training updates them in place, the asynchronous
        # trainer copies the parameter server's final weights into it.
        self._state = state
        self.training_histories.append(history)
        return history

    def _eval_trainer(self) -> SyncTrainer:
        # Evaluation and prediction always take the synchronous path.
        if self._sync_trainer is None:
            self._sync_trainer = SyncTrainer(self._master, self.mesh, frequency="batch")
        return self._sync_trainer

    def _current_state(self):
        if self._state is None:
            self._state = init_train_state(self._master)
        return self._state

    def predict(self, data, batch_size: int = 256) -> np.ndarray:
        """Distributed inference (reference §3.5): every row's output, on
        every rank."""
        features = data.features if isinstance(data, ShardedDataset) else np.asarray(data)
        return self._eval_trainer().predict_state(self._current_state(), features,
                                                  batch_size=batch_size)

    def evaluate(self, x, y=None, batch_size: int = 256) -> Dict[str, float]:
        """Distributed evaluation: the loss and compiled metrics as the
        exact weighted mean over all rows (reference §3.5)."""
        if isinstance(x, ShardedDataset):
            features, labels = x.features, x.labels
        else:
            features, labels = np.asarray(x), np.asarray(y)
        return self._eval_trainer().evaluate_state(self._current_state(), features, labels,
                                                   batch_size=batch_size)

    def save(self, path: str) -> None:
        """Persist the master network (architecture, weights, optimizer
        config) and the constructor's settings: the JAX package's pickled
        dict around a ``model_to_dict`` payload. ``checkpoint/`` keeps
        mid-training snapshots with optimizer state."""
        payload = {
            "model": model_to_dict(self._master),
            "mode": self.mode,
            "frequency": self.frequency,
            "parameter_server_mode": self.parameter_server_mode,
            "num_workers": self.num_workers,
            "batch_size": self.batch_size,
            "port": self.port,
            "hogwild_granularity": self.hogwild_granularity,
            "max_failures": self.max_failures,
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)


# Reference alias: user code says ``SparkModel``.
SparkModel = TpuModel


def load_spark_model(path: str, custom_objects: Optional[dict] = None,
                     device=None) -> TpuModel:
    """Inverse of ``SparkModel.save``, the model built on ``device``
    (None: ``cuda``). Reads files of either package whose model is a
    registry model. Unpickles the file: load only files this program
    or one you trust wrote."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    model = dict_to_model(payload["model"], custom_objects, device=device)
    return TpuModel(
        model,
        mode=payload["mode"],
        frequency=payload["frequency"],
        parameter_server_mode=payload["parameter_server_mode"],
        num_workers=payload["num_workers"],
        batch_size=payload["batch_size"],
        port=payload["port"],
        hogwild_granularity=payload.get("hogwild_granularity", "tree"),
        max_failures=payload.get("max_failures", 4),
    )


class SparkMLlibModel(TpuModel):
    """LabeledPoint façade (reference ``SparkMLlibModel``): ``fit`` takes
    a list of ``LabeledPoint`` (``data.rdd.to_labeled_point``)."""

    def fit(
        self,
        labeled_points,
        epochs: int = 10,
        batch_size: Optional[int] = None,
        verbose: int = 0,
        validation_split: float = 0.0,
        categorical: bool = False,
        nb_classes: Optional[int] = None,
        validation_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        callbacks=(),
    ):
        dataset = lp_to_simple_rdd(labeled_points, categorical=categorical,
                                   nb_classes=nb_classes, num_partitions=self.num_workers)
        return super().fit(dataset, epochs=epochs, batch_size=batch_size, verbose=verbose,
                           validation_split=validation_split,
                           validation_data=validation_data, callbacks=callbacks)
