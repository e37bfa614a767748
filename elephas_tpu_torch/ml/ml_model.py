"""Estimator/Transformer pipeline stages over columnar DataFrames
(counterpart of ``elephas_tpu/ml/ml_model.py``).

Reference: ``elephas/ml_model.py::{ElephasEstimator, ElephasTransformer,
load_ml_estimator, load_ml_transformer}``: DataFrame in, DataFrame out,
making distributed training a pipeline stage with save/load. The
estimator builds its model, trains it through ``df_to_simple_rdd`` and
``SparkModel.fit``, and hands the trained network to the transformer as
a ``model_to_dict`` payload.

``device`` (estimator, transformer and loaders) is a run-time choice,
not a persisted param: where the model is built (None: ``cuda``).
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np

from elephas_tpu_torch.api.compile import CompiledModel
from elephas_tpu_torch.api.spark_model import SparkModel
from elephas_tpu_torch.data.dataframe import DataFrame, df_to_simple_rdd
from elephas_tpu_torch.ml.params import (
    HasAutotune,
    HasBatchSize,
    HasCategoricalLabels,
    HasEpochs,
    HasFeaturesCol,
    HasFrequency,
    HasKerasModelConfig,
    HasLabelCol,
    HasLoss,
    HasMetrics,
    HasMode,
    HasNumberOfClasses,
    HasNumberOfWorkers,
    HasOptimizerConfig,
    HasOutputCol,
    HasParameterServerMode,
    HasValidationSplit,
    HasVerbosity,
)
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.serialize.serialization import dict_to_model, model_to_dict, torch_dtype


class ElephasEstimator(
    HasKerasModelConfig,
    HasAutotune,
    HasMode,
    HasFrequency,
    HasNumberOfClasses,
    HasNumberOfWorkers,
    HasEpochs,
    HasBatchSize,
    HasVerbosity,
    HasValidationSplit,
    HasCategoricalLabels,
    HasLoss,
    HasMetrics,
    HasOptimizerConfig,
    HasOutputCol,
    HasFeaturesCol,
    HasLabelCol,
    HasParameterServerMode,
):
    """Trainable pipeline stage: ``fit(df) -> ElephasTransformer``.

    ``keras_model_config`` accepts either a ``model_to_dict`` payload (of
    either package) or a registry config ``{"name": ..., "kwargs": ...,
    "input_shape": ..., "input_dtype": ...}``. ``callbacks`` (``(epoch,
    state, metrics)`` callables) are run-time only and not persisted.
    ``autotune=True`` reaches ``SparkModel``'s autotune.
    """

    def __init__(self, **kwargs):
        self.callbacks = tuple(kwargs.pop("callbacks", ()))
        self.device = kwargs.pop("device", None)
        self.set_params(**kwargs)

    def _build_model(self) -> CompiledModel:
        config = self.keras_model_config
        if config is None:
            raise ValueError("set_keras_model_config(...) before fit")
        if "arch" in config:  # a full model_to_dict payload
            compiled = dict_to_model(config, device=self.device)
            # The stage's params override the payload's training attributes.
            return CompiledModel(
                compiled.module,
                params=compiled.module.state_dict(),
                optimizer=self.optimizer_config,
                loss=self.loss,
                metrics=list(self.metrics),
                model_config=compiled.model_config,
            )
        input_shape = config.get("input_shape")
        if input_shape is None:
            raise ValueError("registry keras_model_config needs 'input_shape' to initialize")
        module = get_model(config["name"], **{"device": self.device, **config.get("kwargs", {})})
        return CompiledModel(
            module,
            optimizer=self.optimizer_config,
            loss=self.loss,
            metrics=list(self.metrics),
            input_shape=tuple(input_shape),
            input_dtype=torch_dtype(config.get("input_dtype", "float32")),
        )

    def _fit(self, df: DataFrame) -> "ElephasTransformer":
        compiled = self._build_model()
        rdd = df_to_simple_rdd(
            df,
            categorical=self.categorical,
            nb_classes=self.nb_classes,
            features_col=self.features_col,
            label_col=self.label_col,
            num_partitions=self.num_workers or 1,
        )
        spark_model = SparkModel(
            compiled,
            mode=self.mode,
            frequency=self.frequency,
            parameter_server_mode=self.parameter_server_mode,
            num_workers=self.num_workers,
            batch_size=self.batch_size,
            autotune=self.autotune,
        )
        spark_model.fit(
            rdd,
            epochs=self.epochs,
            batch_size=self.batch_size,
            verbose=self.verbose,
            validation_split=self.validation_split,
            callbacks=self.callbacks,
        )
        return ElephasTransformer(
            model_payload=model_to_dict(spark_model.master_network),
            output_col=self.output_col,
            features_col=self.features_col,
            categorical=self.categorical,
            history=spark_model.training_histories[-1],
            device=self.device,
        )

    # pyspark.ml parity: public fit() delegates to _fit().
    def fit(self, df: DataFrame) -> "ElephasTransformer":
        return self._fit(df)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"kind": "estimator", "params": self.param_map()}, f)


class ElephasTransformer(HasOutputCol, HasFeaturesCol, HasCategoricalLabels):
    """Fitted stage: ``transform(df)`` appends a prediction column: the
    argmax as float32 when ``categorical``, else the raw outputs, (N,)
    for one output and (N, C) otherwise."""

    def __init__(
        self,
        model_payload: dict,
        output_col: str = "prediction",
        features_col: str = "features",
        categorical: bool = True,
        history: Optional[dict] = None,
        device=None,
    ):
        self.model_payload = model_payload
        self.set_output_col(output_col)
        self.set_features_col(features_col)
        self.set_categorical(categorical)
        self.history = history or {}
        self.device = device
        self._spark_model: Optional[SparkModel] = None

    def get_model(self) -> CompiledModel:
        """The trained CompiledModel (reference ``Transformer.get_model``)."""
        return self._model().master_network

    def _model(self) -> SparkModel:
        if self._spark_model is None:
            self._spark_model = SparkModel(dict_to_model(self.model_payload, device=self.device),
                                           mode="synchronous")
        return self._spark_model

    def _transform(self, df: DataFrame) -> DataFrame:
        outputs = self._model().predict(df[self.features_col])
        if self.categorical:
            predictions = np.argmax(outputs, axis=-1).astype(np.float32)
        elif outputs.ndim > 1 and outputs.shape[-1] == 1:
            predictions = np.squeeze(outputs, axis=-1)  # keep the row dim
        else:
            predictions = outputs
        return df.with_column(self.output_col, predictions)

    def transform(self, df: DataFrame) -> DataFrame:
        return self._transform(df)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "kind": "transformer",
                    "model_payload": self.model_payload,
                    "output_col": self.output_col,
                    "features_col": self.features_col,
                    "categorical": self.categorical,
                    "history": self.history,
                },
                f,
            )


def _load(path: str, kind: str) -> dict:
    """The pickled stage at ``path`` (load only files you trust)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("kind") != kind:
        raise ValueError(f"{path} does not contain an Elephas{kind.title()}")
    return payload


def load_ml_estimator(path: str, device=None) -> ElephasEstimator:
    return ElephasEstimator(device=device, **_load(path, "estimator")["params"])


def load_ml_transformer(path: str, device=None) -> ElephasTransformer:
    payload = _load(path, "transformer")
    return ElephasTransformer(
        model_payload=payload["model_payload"],
        output_col=payload["output_col"],
        features_col=payload["features_col"],
        categorical=payload["categorical"],
        history=payload["history"],
        device=device,
    )
