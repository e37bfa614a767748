"""elephas_tpu_torch.tune — elastic hyperparameter search (counterpart of
``elephas_tpu/tune``).

Trials are lease-fenced ``UnitLedger`` units on the
``ElasticWorkerPool`` (``resilience/elastic.py``), rung checkpoints ride
the packed wire codec (``MemoryVault``) or live on a parameter server
(``GroupVault``), promotion decisions come from an async
successive-halving scheduler, and the search reports through the
``obs`` registry, tracer and flight recorder.

Layout:
    trial.py      TrialSpec / TrialState + replay-stable digests
    scheduler.py  AshaScheduler (async successive halving)
    vault.py      MemoryVault / GroupVault rung checkpoints
    runner.py     TuneRunner (the elastic-pool execution engine)
    search.py     hp combinators, HyperParamModel (reference parity),
                  sample_trials / run_search (the ASHA frontend)
    cli.py        ``python -m elephas_tpu_torch.tune.cli``

The ``/trials`` ops route serves ``TuneRunner.trials_snapshot``:
``obs.OpsServer(trials_fn=runner.trials_snapshot)``.
"""

from elephas_tpu_torch.tune.scheduler import AshaScheduler  # noqa: F401
from elephas_tpu_torch.tune.search import (  # noqa: F401
    HyperParamModel,
    current_trial_device,
    hp,
    run_search,
    sample_space,
    sample_trials,
    width_bucket,
)
from elephas_tpu_torch.tune.trial import TrialSpec, TrialState  # noqa: F401
from elephas_tpu_torch.tune.vault import (  # noqa: F401
    GroupVault,
    MemoryVault,
    TrialCheckpoint,
)

__all__ = [
    "AshaScheduler", "GroupVault", "HyperParamModel", "MemoryVault",
    "TrialCheckpoint", "TrialSpec", "TrialState", "current_trial_device",
    "hp", "run_search", "sample_space", "sample_trials", "width_bucket",
]
