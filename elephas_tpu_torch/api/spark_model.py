"""SparkModel-compatible driver API (counterpart of ``elephas_tpu/api/spark_model.py``).

Reference: ``elephas/spark_model.py::SparkModel``
(SURVEY.md §2.1, §3.1, §3.5). The constructor signature, the
mode/frequency semantics and the fit/predict/evaluate surface are the
JAX package's. Spark executors become the processes of a
``torch.distributed`` group, one per device (``parallel/mesh.py``); one
process with no group is a group of one.

Ported: ``mode="synchronous"`` (``engine/sync.py``). Not ported yet, and
raising where asked for: ``"asynchronous"`` and ``"hogwild"``,
``save``/``load_spark_model``, Keras models and ``model_to_dict``
payloads (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from elephas_tpu_torch.api.compile import CompiledModel
from elephas_tpu_torch.data.rdd import ShardedDataset
from elephas_tpu_torch.engine.step import init_train_state
from elephas_tpu_torch.engine.sync import SyncTrainer
from elephas_tpu_torch.parallel.mesh import build_mesh, world

logger = logging.getLogger(__name__)

MODES = ("synchronous", "asynchronous", "hogwild")
FREQUENCIES = ("batch", "epoch", "fit")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it arrives with {item} "
                               "(ROADMAP.md, queue 1)")


class TpuModel:
    """Driver-side distributed model (the reference's ``SparkModel``).

    Parameters mirror the reference constructor and the JAX package's:

    mode: 'synchronous' (ported) | 'asynchronous' | 'hogwild' (raise).
    frequency: 'batch' | 'epoch' | 'fit' — the averaging granularity of
        synchronous training (``engine/sync.py``).
    parameter_server_mode, port, hogwild_granularity, max_failures,
        pipelined_comms: the asynchronous modes' settings. They are
        validated as the JAX package validates them and then dropped:
        synchronous training, the one mode ported, reads none of them.
    num_workers: data-group size; defaults to the world size (one process
        per device) and is capped to it with a warning.
    custom_objects: kept for deserialization.
    batch_size: default per-worker batch size for ``fit``.
    mesh: an optional pre-built ``parallel.mesh.Mesh``.
    autotune: compile-option A/B; not ported (raises when True).
    """

    def __init__(
        self,
        model: CompiledModel,
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
        if mode != "synchronous":
            raise _not_ported(f"mode={mode!r}", "async and hogwild training")
        if autotune:
            raise _not_ported("autotune (a torch.compile mode A/B)",
                              "the sync fit slice's left-outs")
        if isinstance(model, dict):
            raise _not_ported("a model_to_dict payload", "serialization")
        if not isinstance(model, CompiledModel):
            if type(model).__module__.split(".")[0] == "keras":
                raise _not_ported("a Keras model", "serialization (the Keras bridge)")
            raise TypeError(
                "model must be a CompiledModel; wrap modules with "
                "elephas_tpu_torch.compile_model"
            )
        self._master = model
        self.mode = mode
        self.frequency = frequency
        self.custom_objects = custom_objects or {}
        self.batch_size = batch_size

        n_devices = world()[0]
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
        self._mesh = mesh
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
        if self._mesh is None:
            self._mesh = build_mesh(num_data=self.num_workers)
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
        fit. ``initial_state``: a ``TrainState`` to resume from.
        ``stream_batches`` is not ported yet and raises.
        """
        if stream_batches is not None:
            raise _not_ported("stream_batches (streamed epochs)",
                              "the sync fit slice's left-outs")
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

        trainer = SyncTrainer(self._master, self.mesh, frequency=self.frequency)
        state, history = trainer.fit(
            dataset,
            epochs=epochs,
            batch_size=batch_size,
            validation_data=validation_data,
            verbose=verbose,
            callbacks=callbacks,
            initial_state=initial_state,
        )
        self._sync_trainer = trainer
        for cb in callbacks:
            hook = getattr(cb, "on_fit_end", None)
            if hook is not None:
                hook()
        # The master network's module holds the trained weights already:
        # training updates them in place.
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
        raise _not_ported("SparkModel.save", "serialization")


# Reference alias: user code says ``SparkModel``.
SparkModel = TpuModel


def load_spark_model(path: str, custom_objects: Optional[dict] = None) -> TpuModel:
    """Inverse of ``SparkModel.save`` — not ported yet."""
    raise _not_ported("load_spark_model", "serialization")
