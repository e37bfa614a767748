"""Spark-ML-style ``Has*`` parameter mixins (counterpart of
``elephas_tpu/ml/params.py``; the same names, docs and defaults).

Reference: ``elephas/ml/params.py``, one tiny mixin class per
hyperparameter, each with a getter/setter so pipeline stages are
introspectable and serializable. pyspark is absent, so this module
provides a dependency-free ``Param`` descriptor with the same chainable
``set_x()/get_x()`` surface (setters return ``self``, Spark-style) plus
``explain_params()`` / ``param_map()`` for introspection and stage
save/load.
"""

from __future__ import annotations

from typing import Any, Dict


class Param:
    """A named, documented, defaulted stage parameter (descriptor)."""

    def __init__(self, name: str, doc: str, default: Any = None):
        self.name = name
        self.doc = doc
        self.default = default

    def __set_name__(self, owner, attr_name):
        self._attr = "_param_" + self.name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if not hasattr(obj, self._attr) and isinstance(self.default, (dict, list)):
            # Never hand out the shared class-level default for mutable
            # values — a stage mutating it in place would leak into every
            # other stage.
            import copy

            setattr(obj, self._attr, copy.deepcopy(self.default))
        return getattr(obj, self._attr, self.default)

    def __set__(self, obj, value):
        setattr(obj, self._attr, value)


class HasParams:
    """Base: parameter discovery, explain, and dict round-trip."""

    @classmethod
    def _params(cls) -> Dict[str, Param]:
        out: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for name, value in vars(klass).items():
                if isinstance(value, Param):
                    out[value.name] = value
        return out

    def param_map(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in self._params()}

    def set_params(self, **kwargs) -> "HasParams":
        params = self._params()
        for key, value in kwargs.items():
            if key not in params:
                raise ValueError(f"unknown param {key!r}; known: {sorted(params)}")
            setattr(self, key, value)
        return self

    def explain_params(self) -> str:
        lines = []
        for name, param in sorted(self._params().items()):
            lines.append(f"{name}: {param.doc} (default: {param.default!r}, "
                         f"current: {getattr(self, name)!r})")
        return "\n".join(lines)


def _mixin(param_name: str, doc: str, default=None, class_name: str = None):
    """Build one reference-style ``Has*`` mixin with get/set methods."""
    param = Param(param_name, doc, default)

    def setter(self, value):
        setattr(self, param_name, value)
        return self

    def getter(self):
        return getattr(self, param_name)

    cls = type(
        class_name or f"Has{param_name.title().replace('_', '')}",
        (HasParams,),
        {
            param_name: param,
            f"set_{param_name}": setter,
            f"get_{param_name}": getter,
        },
    )
    return cls


# The reference's mixin set, with snake_case param names matching
# SparkModel's constructor kwargs.
HasKerasModelConfig = _mixin(
    "keras_model_config",
    "serialized model architecture (registry config or model_to_dict payload)",
    class_name="HasKerasModelConfig",
)
HasMode = _mixin("mode", "training mode: synchronous|asynchronous|hogwild", "asynchronous")
HasFrequency = _mixin("frequency", "coordination granularity: batch|epoch|fit", "epoch")
HasNumberOfClasses = _mixin("nb_classes", "number of label classes", 10,
                            class_name="HasNumberOfClasses")
HasNumberOfWorkers = _mixin("num_workers", "number of data-parallel workers (chips)", None,
                            class_name="HasNumberOfWorkers")
HasEpochs = _mixin("epochs", "training epochs", 10)
HasBatchSize = _mixin("batch_size", "per-worker batch size", 32)
HasVerbosity = _mixin("verbose", "verbosity level", 0, class_name="HasVerbosity")
HasValidationSplit = _mixin("validation_split", "fraction held out for validation", 0.0)
HasCategoricalLabels = _mixin("categorical", "labels are class indices to one-hot", True,
                              class_name="HasCategoricalLabels")
HasLoss = _mixin("loss", "loss name (engine.losses) or callable", "categorical_crossentropy")
HasMetrics = _mixin("metrics", "metric names", ("acc",))
HasOptimizerConfig = _mixin("optimizer_config", "optimizer name/config dict",
                            {"name": "sgd"}, class_name="HasOptimizerConfig")
HasOutputCol = _mixin("output_col", "prediction column name", "prediction",
                      class_name="HasOutputCol")
HasFeaturesCol = _mixin("features_col", "features column name", "features")
HasLabelCol = _mixin("label_col", "label column name", "label")
HasParameterServerMode = _mixin(
    "parameter_server_mode", "async weight transport: local|http|socket", "local"
)
HasAutotune = _mixin(
    "autotune",
    "one-shot per-workload compile-option A/B at fit start "
    "(not ported: SparkModel raises where it is set)",
    False,
)
