"""Per-engine weight delivery: version-gated PS pulls at step boundaries
(counterpart of ``elephas_tpu/rollout/subscriber.py``).

A ``WeightSubscriber`` is the only thing that ever swaps a serving
engine's weights. The engine calls ``on_step(engine)`` from
``_on_step_boundary`` — under the step lock, after the scheduler step —
so every install is atomic with respect to dispatch: no compiled program
is in flight, and a speculative draft+verify window (one scheduler step)
can never straddle a swap.

Three modes, cheapest steady state first:

- **hold** (managed default): no wire traffic at all. The
  ``RolloutController`` moves the pin; an unpinned managed engine serves
  what it has.
- **pinned**: one pinned pull (live buffer or WAL history) when the
  engine is not yet at the pin, then zero traffic until the pin moves.
  ``VersionUnavailable`` is definitive — the subscriber stops retrying
  that pin (``pin_failed``) and the controller falls back to a peer
  copy via ``offer``.
- **follow** (standalone, ``follow=True``): poll the live version every
  ``every`` steps. Steady state costs K not-modified frames per poll
  (the wire layer's version gate); a version change costs one full
  transfer and one ``weight_swap``.

Failures degrade, never stall: any pull error counts ``failures``,
notes ``weight_pull_fail``, and the engine keeps serving its current
weights — delivery is not a liveness dependency.

A spec-decoding engine's ``DraftModelSource`` (``subscribed=True``)
rides the same cadence: after each successful target poll the
subscriber calls ``draft.refresh()``, so the draft model costs no extra
polling schedule of its own.
"""

from __future__ import annotations

from typing import Optional

from elephas_tpu_torch import obs
from elephas_tpu_torch.parameter.client import VersionUnavailable
from elephas_tpu_torch.utils import locksan

__all__ = ["WeightSubscriber"]


class WeightSubscriber:
    """See module docstring. One subscriber per engine — the step/pin
    state is per-engine, and sharing one across engines would alias
    their cadences. The wire ``client`` CAN be shared (its fan-out and
    pull cache are thread-safe, and pinned steady state is silent)."""

    def __init__(self, client, every: int = 1, follow: bool = False,
                 draft_source=None):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.client = client
        self.every = int(every)
        self.follow = bool(follow)
        self.draft = draft_source
        # pin/offer state crosses threads: the controller writes from
        # its tick thread, on_step reads from the serve thread.
        self._lock = locksan.make_lock("WeightSubscriber._lock")
        self._pinned: Optional[int] = None
        self._pin_failed = False
        self._offered = None  # (tree, version) staged for next boundary
        self._steps = 0
        self.pulls = 0      # network polls that completed
        self.unchanged = 0  # polls answered entirely by not-modified
        self.swaps = 0      # installs (version actually changed)
        self.failures = 0   # failed pulls (engine kept serving)

    # -- control plane (any thread) -----------------------------------------

    def attach(self, engine) -> "WeightSubscriber":
        """Register on ``engine`` (its step-boundary hook calls us) and
        adopt its spec draft source when that source opted into
        subscription — one cadence for target AND draft."""
        engine.subscriber = self
        spec = getattr(engine, "spec", None)
        source = getattr(spec, "source", None)
        if self.draft is None and getattr(source, "subscribed", False):
            self.draft = source
        return self

    def pin(self, version: int) -> None:
        """Target one exact version; the next step boundary pulls it
        (pinned read), then the subscriber goes silent until the pin
        moves."""
        with self._lock:
            self._pinned = int(version)
            self._pin_failed = False

    def unpin(self) -> None:
        with self._lock:
            self._pinned = None
            self._pin_failed = False

    @property
    def pinned(self) -> Optional[int]:
        with self._lock:
            return self._pinned

    @property
    def pin_failed(self) -> bool:
        """True when the current pin came back ``VersionUnavailable`` —
        a definitive answer; the controller must supply the bytes
        another way (``offer``) or move the pin."""
        with self._lock:
            return self._pin_failed

    def offer(self, tree, version: Optional[int]) -> None:
        """Stage a host tree for installation at the next step boundary
        — the controller's peer-copy rollback path when the WAL has
        pruned the pinned version. Atomicity is unchanged: the install
        still happens under the step lock."""
        with self._lock:
            self._offered = (tree, version)

    def nudge(self, engine) -> bool:
        """Give an idle engine a synthetic step boundary. Pins and
        offers normally land at the next decode-step boundary — but an
        engine with no traffic has none, and a promotion wave must not
        depend on traffic for liveness. Taking the engine's step lock
        non-blocking preserves the atomicity contract exactly: the lock
        free means no compiled program is in flight (same invariant as
        the real boundary hook), and the lock busy means the engine is
        mid-step and will run the hook itself moments later. Returns
        whether the boundary ran. Engines without a step lock (bare
        fakes) are never nudged — they must step explicitly."""
        lock = getattr(engine, "_step_lock", None)
        if lock is None or not lock.acquire(blocking=False):
            return False
        try:
            self.on_step(engine)
        finally:
            lock.release()
        return True

    def snapshot(self) -> dict:
        with self._lock:
            pinned, pin_failed = self._pinned, self._pin_failed
        return {
            "pinned": pinned, "pin_failed": pin_failed,
            "follow": self.follow, "every": self.every,
            "steps": self._steps, "pulls": self.pulls,
            "unchanged": self.unchanged, "swaps": self.swaps,
            "failures": self.failures,
            "draft_shared": self.draft is not None,
        }

    # -- data plane (serve thread, under the engine's step lock) ------------

    def on_step(self, engine) -> None:
        """One step-boundary tick. Cheap in every steady state: staged
        offer → install it; pinned and already there → return; hold
        mode → return; follow mode → poll on the ``every`` cadence."""
        self._steps += 1
        with self._lock:
            offered, self._offered = self._offered, None
            pinned, pin_failed = self._pinned, self._pin_failed
        if offered is not None:
            self._install(engine, offered[0], offered[1])
            return
        if pinned is not None:
            if pin_failed or engine.model_version == pinned:
                return
            self._pull_pinned(engine, pinned)
            return
        if not self.follow:
            return
        if (self._steps - 1) % self.every != 0:
            return
        self._pull_live(engine)

    def _pull_live(self, engine) -> None:
        try:
            version, tree = self.client.pull()
        except Exception as err:
            self._note_fail(engine, err)
            return
        self.pulls += 1
        if version == engine.model_version and version is not None:
            self.unchanged += 1
        elif version is None and engine.model_version is None:
            # A versionless server: deliver once, then treat every
            # identical answer as unchanged rather than re-swapping.
            self._install(engine, tree, None)
        else:
            self._install(engine, tree, version)
        self._refresh_draft()

    def _pull_pinned(self, engine, pinned: int) -> None:
        try:
            version, tree = self.client.pull(version=pinned)
        except VersionUnavailable as err:
            with self._lock:
                if self._pinned == pinned:
                    self._pin_failed = True  # definitive: stop retrying
            self._note_fail(engine, err, pinned=pinned)
            return
        except Exception as err:
            self._note_fail(engine, err, pinned=pinned)  # retried next step
            return
        self.pulls += 1
        self._install(engine, tree, version)
        self._refresh_draft()

    def _install(self, engine, tree, version: Optional[int]) -> None:
        prior = engine.model_version
        # The hook runs under the engine's step lock: install through the
        # body that assumes it held (a bare fake has only the public call).
        install = getattr(engine, "install_weights_held", None) or engine.install_weights
        install(tree, version)
        self.swaps += 1
        obs.default_flight_recorder().note(
            "weight_swap", "info", version=version, prior=prior,
            step=self._steps,
        )

    def _refresh_draft(self) -> None:
        if self.draft is None:
            return
        try:
            self.draft.refresh()
        except Exception as err:
            self.failures += 1
            obs.default_flight_recorder().note(
                "weight_pull_fail", "warn", model="draft",
                error=repr(err),
            )

    def _note_fail(self, engine, err,
                   pinned: Optional[int] = None) -> None:
        self.failures += 1
        obs.default_flight_recorder().note(
            "weight_pull_fail", "warn", error=repr(err),
            serving_version=engine.model_version, pinned=pinned,
        )
