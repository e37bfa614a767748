"""Search-space combinators, samplers, and the two search frontends
(counterpart of ``elephas_tpu/tune/search.py``).

1. The **reference-parity frontend** — ``hp`` combinators +
   ``HyperParamModel.minimize`` (hyperas/hyperopt analogue, SURVEY.md
   §3.4): embarrassingly-parallel trials with independent per-worker
   streams, one host thread per card, the argmin across processes.
2. The **elastic ASHA frontend** — ``sample_trials`` + ``run_search``:
   the same ``hp`` spaces, trials run as lease-fenced ledger units on the
   elastic worker pool with successive halving and vault checkpoints
   (``tune/scheduler.py``, ``tune/runner.py``).

The combinators, ``sample_space``, the samplers, ``width_bucket`` and
``sample_trials`` are NumPy code copied from the JAX package: the same
seed draws the identical streams in both packages.

Objective contract (hyperopt-compatible, frontend 1):
    ``model_fn(sample: dict, data) -> {"loss": float, "model":
    CompiledModel, "status": "ok"}`` — extra keys are kept and returned
    with the trial.
"""

from __future__ import annotations

import contextlib
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from elephas_tpu_torch.parallel.mesh import world
from elephas_tpu_torch.tune.trial import TrialSpec
from elephas_tpu_torch.utils.device import resolve_device

__all__ = [
    "hp", "HyperParamModel", "sample_space", "current_trial_device",
    "width_bucket", "sample_trials", "run_search",
]


def width_bucket(width: int, buckets) -> int:
    """Smallest bucket >= ``width``: the width quantizer of a search that
    builds its models at bucket widths with the true width masked
    (``models.mlp.MaskedMLP``), so that every width of a bucket runs one
    set of shapes."""
    for b in sorted(int(b) for b in buckets):
        if width <= b:
            return b
    raise ValueError(
        f"width {width} exceeds the largest bucket {max(buckets)} — "
        "add a bucket at least as large as the search space's maximum"
    )


_trial_ctx = threading.local()


def current_trial_device() -> torch.device:
    """The device the calling trial's worker thread is pinned to.

    For objectives that build their own model and trainer: each worker
    thread of ``HyperParamModel.minimize`` publishes its device here
    before running trials. Outside a trial thread it is the default
    device, ``cuda`` (``resolve_device(None)``: raises without a GPU).
    """
    device = getattr(_trial_ctx, "device", None)
    return device if device is not None else resolve_device(None)


class _Dist:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    # -- numeric-KDE interface (TPE). Choice overrides with categorical logic.
    def warp(self, value) -> float:
        """Map a sampled value into the continuous domain the TPE kernel
        density lives in (log-space for loguniform, identity otherwise)."""
        return float(value)

    @property
    def span(self) -> float:
        """Width of the warped domain (bandwidth floor for the KDE)."""
        raise NotImplementedError


class _Choice(_Dist):
    def __init__(self, options):
        self.options = list(options)

    def sample(self, rng):
        return self.options[rng.integers(len(self.options))]


class _Uniform(_Dist):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))

    @property
    def span(self):
        return float(self.high - self.low)


class _LogUniform(_Dist):
    def __init__(self, low, high):
        # hyperopt convention: bounds are on log(value).
        self.low, self.high = low, high

    def sample(self, rng):
        return float(np.exp(rng.uniform(self.low, self.high)))

    def warp(self, value):
        return float(np.log(value))

    @property
    def span(self):
        return float(self.high - self.low)


class _QUniform(_Dist):
    def __init__(self, low, high, q):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        return float(np.round(rng.uniform(self.low, self.high) / self.q) * self.q)

    @property
    def span(self):
        return float(self.high - self.low)


class _RandInt(_Dist):
    def __init__(self, upper):
        self.upper = upper

    def sample(self, rng):
        return int(rng.integers(self.upper))

    @property
    def span(self):
        return float(self.upper)


class hp:
    """hyperopt-flavored search-space combinators."""

    choice = _Choice
    uniform = _Uniform
    loguniform = _LogUniform
    quniform = _QUniform
    randint = _RandInt


def sample_space(space: Any, rng: np.random.Generator) -> Any:
    """Recursively sample every ``hp.*`` node in a nested dict/list/tuple."""
    if isinstance(space, _Dist):
        return space.sample(rng)
    if isinstance(space, dict):
        return {k: sample_space(v, rng) for k, v in space.items()}
    if isinstance(space, (list, tuple)):
        return type(space)(sample_space(v, rng) for v in space)
    return space


def _iter_nodes(space: Any, path=()):
    """Yield (path, dist) for every ``hp.*`` node in the nested space."""
    if isinstance(space, _Dist):
        yield path, space
    elif isinstance(space, dict):
        for k, v in space.items():
            yield from _iter_nodes(v, path + (k,))
    elif isinstance(space, (list, tuple)):
        for i, v in enumerate(space):
            yield from _iter_nodes(v, path + (i,))


def _substitute(space: Any, values: Dict, path=()):
    """Rebuild the space structure with ``values[path]`` at each hp node."""
    if isinstance(space, _Dist):
        return values[path]
    if isinstance(space, dict):
        return {k: _substitute(v, values, path + (k,)) for k, v in space.items()}
    if isinstance(space, (list, tuple)):
        return type(space)(
            _substitute(v, values, path + (i,)) for i, v in enumerate(space)
        )
    return space


class _RandomSampler:
    """Pure random search (``algo='random'``) — the r1/r2 behavior."""

    def __init__(self, space: Any, rng: np.random.Generator):
        self.space = space
        self.rng = rng
        self.nodes = list(_iter_nodes(space))

    def suggest(self):
        values = {path: dist.sample(self.rng) for path, dist in self.nodes}
        return values, _substitute(self.space, values)

    def observe(self, values: Dict, loss: float) -> None:
        pass


class _TPESampler(_RandomSampler):
    """TPE-lite: within-worker *adaptive* sampling (``algo='tpe'``).

    The reference runs sequential ``hyperopt.fmin`` (default algo: TPE)
    inside each executor (SURVEY.md §3.4) — adaptive within a worker,
    independent across workers. This is the same shape: after
    ``n_startup`` random trials, observations are split at the ``gamma``
    quantile into good/bad sets; each of ``n_candidates`` prior draws is
    scored by the factorized density ratio l(x)/g(x) (per-node Gaussian
    KDE in the warped domain for numeric nodes, add-one-smoothed
    categorical for ``hp.choice``) and the argmax is evaluated. Like
    hyperopt, nodes are treated independently.
    """

    def __init__(self, space, rng, n_startup: int = 5, n_candidates: int = 24,
                 gamma: float = 0.25):
        super().__init__(space, rng)
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.gamma = gamma
        self.history: List[tuple] = []  # (values, loss)

    def observe(self, values: Dict, loss: float) -> None:
        self.history.append((values, float(loss)))

    def _node_log_density(self, path, dist, value, observations) -> float:
        obs = [o[path] for o in observations]
        if isinstance(dist, _Choice):
            try:
                matches = sum(1 for o in obs if o == value)
            except Exception:
                matches = 0
            return float(
                np.log((matches + 1.0) / (len(obs) + len(dist.options)))
            )
        w = dist.warp(value)
        ws = np.array([dist.warp(o) for o in obs], dtype=np.float64)
        sigma = max(float(np.std(ws)), 0.05 * dist.span, 1e-12)
        logps = -0.5 * ((w - ws) / sigma) ** 2 - np.log(sigma)
        return float(np.logaddexp.reduce(logps) - np.log(len(ws)))

    def suggest(self):
        if not self.nodes or len(self.history) < self.n_startup:
            return super().suggest()
        ordered = sorted(self.history, key=lambda t: t[1])
        n_good = max(1, int(np.ceil(self.gamma * len(ordered))))
        good = [v for v, _ in ordered[:n_good]]
        bad = [v for v, _ in ordered[n_good:]] or good
        best_score, best_values = -np.inf, None
        for _ in range(self.n_candidates):
            values = {path: dist.sample(self.rng) for path, dist in self.nodes}
            score = sum(
                self._node_log_density(path, dist, values[path], good)
                - self._node_log_density(path, dist, values[path], bad)
                for path, dist in self.nodes
            )
            if score > best_score:
                best_score, best_values = score, values
        return best_values, _substitute(self.space, best_values)


_SAMPLERS = {"random": _RandomSampler, "tpe": _TPESampler}


class HyperParamModel:
    """Distributed random search with per-worker independent streams.

    Constructor mirrors the reference (``HyperParamModel(sc,
    num_workers)``); ``sc`` is accepted and ignored (no Spark driver).

    ``device``: None gives one worker thread per local CUDA device (at
    most ``num_workers``), each pinned to its card with
    ``torch.cuda.device``, raising without a GPU; inside a process group,
    whose ranks each drive one card, None gives one worker on the rank's
    current card (``torch.cuda.current_device()``), so the group takes
    each card once, as the JAX package's hosts take each chip once; a
    CUDA device gives one worker on it (threads on one card take turns
    launching, so it is not
    oversubscribed); ``"cpu"`` gives ``num_workers`` (default 1) threads
    on the CPU, the counterpart of the JAX package's virtual CPU devices.
    """

    def __init__(self, sc=None, num_workers: Optional[int] = None, device=None):
        del sc
        if device is None:
            resolve_device(None)
            if dist.is_available() and dist.is_initialized():
                # One process per card (parallel/mesh.py): the rank's own.
                devices = [torch.device("cuda", torch.cuda.current_device())]
            else:
                devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            device = resolve_device(device)
            if device.type == "cpu":
                devices = [device] * max(1, int(num_workers or 1))
            else:
                devices = [device]
        self.num_workers = min(num_workers or len(devices), len(devices))
        self.devices = devices[: self.num_workers]
        self.best_models: List[Dict] = []  # per-worker bests (reference attr)
        self.trials: List[Dict] = []  # every LOCAL trial of the last minimize
        self._last_best: Optional[Dict] = None  # returned best (global, multi-process)

    def minimize(
        self,
        model: Callable,
        data: Callable,
        max_evals: int = 10,
        space: Optional[Dict] = None,
        seed: int = 0,
        algo: str = "tpe",
    ):
        """Run ``max_evals`` trials split across workers; return the best
        trial dict (``{"loss", "model", "sample", ...}``).

        ``model``: objective ``(sample, data) -> {"loss", "model", ...}``.
        ``data``: zero-arg callable returning the dataset given to every
        trial (the reference's hyperas ``data`` function).
        ``algo``: ``'tpe'`` (default — within-worker adaptive, matching
        the reference's per-executor ``hyperopt.fmin``) or ``'random'``.

        Several processes (a ``torch.distributed`` default group): every
        process calls this with the same arguments (the gathers below are
        collectives). ``max_evals`` splits across the group's global
        worker slots so exactly ``max_evals`` trials run group-wide; each
        process's best is gathered and every process returns the same
        argmin, the winner's model rebuilt from its ``model_to_dict``
        payload where it was serializable. Per-trial wall times ride each
        result as ``t_start``/``t_end``/``secs`` (``time.perf_counter``).
        """
        if space is None:
            space = {}
        if algo not in _SAMPLERS:
            raise ValueError(f"algo must be one of {sorted(_SAMPLERS)}, got {algo!r}")
        dataset = data() if callable(data) else data
        n_procs, rank = world()
        multi_process = n_procs > 1
        # Global worker slots over the GATHERED local counts: exactly
        # max_evals trials group-wide, the leading slots taking the
        # remainder (idle slots get zero, like the reference's idle
        # executors).
        if multi_process:
            counts = [None] * n_procs
            dist.all_gather_object(counts, self.num_workers)
            total_workers = int(sum(counts))
            offset = int(sum(counts[:rank]))
        else:
            total_workers = self.num_workers
            offset = 0
        base, extra = divmod(max_evals, total_workers)
        trials_for = [base + (1 if g < extra else 0) for g in range(total_workers)]
        results: List[List[Dict]] = [[] for _ in range(self.num_workers)]
        errors: List[BaseException] = []

        def worker(index: int, device: torch.device) -> None:
            # Independent stream per GLOBAL worker slot (the reference's
            # independent Trials() per executor); SeedSequence spawning is
            # collision-free across (seed, slot) pairs.
            g = offset + index
            rng = np.random.default_rng([seed, g])
            sampler = _SAMPLERS[algo](space, rng)
            _trial_ctx.device = device  # thread-local; see current_trial_device
            pinned = (torch.cuda.device(device) if device.type == "cuda"
                      else contextlib.nullcontext())
            try:
                with pinned:
                    for trial in range(trials_for[g]):
                        values, sample = sampler.suggest()
                        t0 = time.perf_counter()
                        out = model(sample, dataset)
                        t1 = time.perf_counter()
                        if not isinstance(out, dict) or "loss" not in out:
                            raise TypeError(
                                "objective must return a dict with a 'loss' key"
                            )
                        out.setdefault("status", "ok")
                        out["sample"] = sample
                        out["worker"] = g
                        out["trial"] = trial
                        out["t_start"] = t0
                        out["t_end"] = t1
                        out["secs"] = t1 - t0
                        results[index].append(out)
                        sampler.observe(values, float(out["loss"]))
            except BaseException as exc:
                errors.append(exc)

        threads = [
            threading.Thread(target=worker, args=(i, dev), daemon=True)
            for i, dev in enumerate(self.devices)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors and not multi_process:
            raise errors[0]

        self.trials = [t for worker_results in results for t in worker_results]
        self.best_models = [
            min(worker_results, key=lambda r: r["loss"])
            for worker_results in results
            if worker_results
        ]
        local_best = (
            min(self.best_models, key=lambda r: r["loss"])
            if self.best_models
            else None
        )
        if not multi_process:
            if local_best is None:
                raise RuntimeError("no trials completed")
            self._last_best = local_best
            return local_best
        # The gather is a COLLECTIVE: a process that raised before it
        # would park every peer inside it. So even a process whose
        # workers errored contributes what it has (possibly nothing),
        # completes the collective, and THEN re-raises locally.
        try:
            best = self._global_argmin(local_best, rank)
        except RuntimeError:
            if errors:
                raise errors[0]  # the objective's real failure, not the
            raise                # derived "no trials group-wide"
        if errors:
            raise errors[0]
        self._last_best = best
        return best

    def _global_argmin(self, local_best: Optional[Dict], rank: int) -> Dict:
        """Reference §3.4's driver ``collect()`` + argmin across the
        processes: gather every process's best (a collective — every
        process must call this), pick the argmin with a deterministic
        (loss, rank) tie-break, and rebuild the winner's model locally
        where it was serializable."""
        candidate = None
        if local_best is not None:
            summary = {k: v for k, v in local_best.items() if k != "model"}
            model_payload = None
            model_obj = local_best.get("model")
            if model_obj is not None:
                try:
                    from elephas_tpu_torch.serialize.serialization import model_to_dict

                    model_payload = model_to_dict(model_obj)
                except Exception:
                    model_payload = None  # the winner's process keeps the live object
            candidate = {"host": rank, "summary": summary, "model_payload": model_payload}
            try:
                # Pickled here, before the collective, so a summary that
                # cannot travel falls back instead of failing one rank
                # inside the gather.
                pickle.dumps(candidate)
            except Exception:
                candidate["summary"] = {
                    "loss": float(local_best["loss"]),
                    "sample": local_best.get("sample"),
                    "worker": local_best.get("worker"),
                    "trial": local_best.get("trial"),
                    "status": local_best.get("status", "ok"),
                }
        gathered = [None] * world()[0]
        dist.all_gather_object(gathered, candidate)
        candidates = [c for c in gathered if c is not None]
        if not candidates:
            raise RuntimeError("no trials completed job-wide")
        win = min(candidates, key=lambda c: (c["summary"]["loss"], c["host"]))
        if win["host"] == rank and local_best is not None:
            return local_best  # the live trial dict, model object included
        best = dict(win["summary"])
        if win["model_payload"] is not None:
            from elephas_tpu_torch.serialize.serialization import dict_to_model

            best["model"] = dict_to_model(win["model_payload"], device=self.devices[0])
        return best

    def best_model(self):
        """Best model object across workers — group-wide after a
        multi-process ``minimize`` (reference convenience)."""
        best = getattr(self, "_last_best", None)
        if best is None:
            # A rank whose global slots got zero trials still holds the
            # gathered winner in _last_best; best_models alone can't tell
            # "never minimized" from "idle rank".
            if not self.best_models:
                raise RuntimeError("call minimize() first")
            best = min(self.best_models, key=lambda r: r["loss"])
        return best.get("model")


# -- elastic ASHA frontend ----------------------------------------------------


def sample_trials(space: Any, num_trials: int, seed: int = 0) -> List[TrialSpec]:
    """Draw the search's trial population from ONE seeded stream.

    Same ``seed`` ⇒ the identical config stream (the chaos gate's
    precondition); per-trial seeds derive from ``SeedSequence([seed,
    trial])`` so trial workloads are decorrelated but replayable.
    """
    rng = np.random.default_rng([int(seed)])
    sampler = _RandomSampler(space, rng)
    specs: List[TrialSpec] = []
    for i in range(int(num_trials)):
        values, config = sampler.suggest()
        trial_seed = int(np.random.SeedSequence([int(seed), i])
                         .generate_state(1)[0])
        specs.append(TrialSpec(i, config, trial_seed, values=values))
    return specs


def run_search(trial_fn: Callable, space: Any, *, num_trials: int = 9,
               seed: int = 0, eta: int = 3, rungs: int = 3, r0: int = 1,
               workers: int = 2, vault=None, injector=None,
               client_factory=None, plateau_delta_norm: Optional[float] = None,
               stall_after: Optional[float] = None,
               registry=None, tracer=None, flight=None,
               clock: Callable[[], float] = time.monotonic,
               sleep: Callable[[float], None] = time.sleep) -> Dict[str, Any]:
    """One elastic ASHA search, end to end.

    ``trial_fn(config, state, epochs, seed, rung) -> {"loss", "state"}``
    trains ``epochs`` more epochs from ``state`` (None = fresh init).
    Returns the search doc (winner config/digest, search digest, epoch
    accounting, pool resilience stats) — see ``TuneRunner.run``.
    """
    # Lazy import: the elastic/observability stack is only needed when a
    # search actually runs, and this module loads during package init.
    from elephas_tpu_torch.tune.runner import TuneRunner
    from elephas_tpu_torch.tune.scheduler import AshaScheduler

    specs = sample_trials(space, num_trials, seed)
    scheduler = AshaScheduler(
        specs, eta=eta, rungs=rungs, r0=r0,
        plateau_delta_norm=plateau_delta_norm, stall_after=stall_after,
        clock=clock, registry=registry, flight=flight)
    runner = TuneRunner(
        trial_fn, scheduler, vault=vault,
        worker_ids=[f"w{i}" for i in range(int(workers))],
        client_factory=client_factory, injector=injector,
        registry=registry, tracer=tracer, flight=flight,
        clock=clock, sleep=sleep)
    doc = runner.run()
    doc["trials"] = {str(t.spec.trial_id): t.to_doc()
                     for t in scheduler.trials}
    return doc
