"""How a hot train step is dispatched, chosen per workload (counterpart of
``elephas_tpu/utils/compiler.py``).

The JAX package A/Bs XLA compile options for its jitted programs: the
TPU's scoped-VMEM budget (``xla_tpu_scoped_vmem_limit_kib``), forced for
every program by ``$ELEPHAS_SCOPED_VMEM_KIB``. Neither has a counterpart
on a GPU, so there is no ``tpu_compiler_options`` here and no
``env_forced`` candidate, and none of its measurements carries over.
The port's steps run eagerly, one launch per operation, and on a card
the host between those launches is the first loss of the small and
host-bound steps. So the port's A/B is how a step is dispatched:

- ``default``: the eager step (``engine.step.make_train_step``);
- ``cuda_graph``: the same step captured once as one ``CUDAGraph`` and
  replayed, one launch a step (``engine.step.CapturedStep``), its
  optimizer in capturable mode (``api.optim``).

``torch.compile`` is not a candidate yet (its compile time at the start
of a fit and its rounding are open questions; ROADMAP queue 1). Off the
card there is one candidate and nothing is timed.

``note_retrace`` lives in ``obs`` (this module imports no JAX in the
port, but the serving engine reached it before this module existed);
it is re-exported here under the reference's import path.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from elephas_tpu_torch import obs
from elephas_tpu_torch.obs import note_retrace  # noqa: F401

logger = logging.getLogger(__name__)

def autotune_candidates(device: Optional[torch.device] = None) -> List[Tuple[str, Optional[bool]]]:
    """``[(label, options)]`` worth A/B-ing for a train step on ``device``
    (None: the card if there is one): the eager step and, on CUDA, the
    captured one. A candidate's options are ``build_train_step``'s
    ``capture``."""
    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    if not on_card:
        return [("default", None)]
    return [("default", None), ("cuda_graph", True)]


def autotune_compile_options(build: Callable, run: Callable, force: Callable, steps: int = 24,
                             candidates=None) -> Tuple[str, object, Dict[str, float]]:
    """One-shot per-workload A/B of the candidates.

    ``build(options) -> fn`` builds the workload's step with one
    candidate's options; ``run(fn) -> out`` dispatches it once (no
    wait); ``force(out)`` waits for its result (reads a scalar, which
    synchronises with the card). Each candidate is built, warmed with
    one forced run, then timed over ``steps`` dispatches with ONE
    trailing force: a wait per run would bill the host-device round trip
    to every run and hide what dispatching costs. Each build and warm-up
    is a ``compile/autotune:<label>`` span. The fastest candidate wins; a
    candidate's ``fn`` is dropped before the next one is built, so a
    captured graph and its memory pool go with it.

    Returns ``(winner_label, winner_options, ms_per_run_table)``. With a
    single candidate nothing is timed and the table is empty.
    """
    if candidates is None:
        candidates = autotune_candidates()
    if len(candidates) == 1:
        label, opts = candidates[0]
        return label, opts, {}
    table: Dict[str, float] = {}
    by_label = {}
    tracer = obs.default_tracer()
    for label, opts in candidates:
        with tracer.span(f"compile/autotune:{label}"):
            fn = build(opts)
            force(run(fn))  # build + warm
        t0 = time.perf_counter()
        out = None
        for _ in range(steps):
            out = run(fn)
        force(out)
        table[label] = (time.perf_counter() - t0) / steps * 1e3
        by_label[label] = opts
        del fn, out
    winner = min(table, key=table.get)
    logger.info("autotune: %r wins — %s", winner,
                {k: f"{v:.3f}ms" for k, v in table.items()})
    return winner, by_label[winner], table
