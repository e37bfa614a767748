"""Device-resident parameter buffer — the async/hogwild weight store
(counterpart of ``elephas_tpu/parameter/buffer.py``).

This replaces the reference's Flask/socket parameter server *state*
(``elephas/parameter/server.py::HttpServer``'s weight list guarded by
``RWLock`` — SURVEY.md §2.1, §5.2): the canonical weights live as tensors
on one device (the card), and applying a delta is a subtract on that
device — on the single-process path the weights never visit the host.

**Published tensors are never written in place.** The JAX buffer is
functional: an apply builds new arrays and publishes them with one
assignment, so a pulled snapshot never changes. The port keeps that
contract: an apply computes ``weights - delta`` out of place
(``torch._foreach_sub``) and publishes the new tensors with one
assignment ('tree') or one dict slot per leaf ('leaf'). A worker, the
epoch-boundary validation or a wire encoder may hold a snapshot for as
long as it likes.

Locking discipline (SURVEY.md §2.2):
- ``lock=True``  (asynchronous): writer-preferring RWLock around
  pull/apply — Downpour SGD with consistent snapshots.
- ``lock=False`` (hogwild): ``NullLock``; applies race as whole-tensor
  read-modify-writes. ``granularity='tree'`` can drop an ENTIRE racing
  delta; ``'leaf'`` keeps each leaf in its own slot, so a race drops at
  most the leaves it overlaps. Survivors are always exact sums of whole
  per-leaf deltas — never torn — and ``version`` counts attempts, so the
  loss rate is observable as ``1 - applied/version``: each published
  tree (or leaf) carries the count of deltas it holds, and
  ``applied_share()`` reads it.

Streams (on the card): the buffer issues its uploads and applies on a
stream of its own. ``apply_delta`` makes that stream wait for the
caller's current stream (where the delta was made) and marks the delta's
memory as used by it (``record_stream``); a reader calls ``hand_over``
(``get`` does it for the calling thread), which makes its current stream
wait for the buffer's and marks the snapshot's memory as used by the
reader's stream, so the caching allocator never hands a snapshot's
memory to another tensor while the reader still reads it.

Trees are nested dicts of tensors (NumPy arrays and scalars are taken
too), held with each dict's keys sorted, as the JAX buffer holds them.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Mapping, Optional

import numpy as np
import torch

from elephas_tpu_torch.utils import locksan
from elephas_tpu_torch.utils.device import resolve_device
from elephas_tpu_torch.utils.functional_utils import tree_leaves_with_path
from elephas_tpu_torch.utils.rwlock import NullLock, RWLock


def _tensor(leaf, device: torch.device, copy: bool) -> torch.Tensor:
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(np.asarray(leaf))
    return leaf.detach().to(device, copy=copy)


def _sorted_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, each dict rebuilt with
    its keys sorted (empty subtrees kept)."""
    if isinstance(tree, Mapping):
        return {k: _sorted_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _refill(tree, leaves):
    """``tree``'s structure with its leaves replaced, in sorted order, by
    the iterator ``leaves``."""
    if isinstance(tree, Mapping):
        return {k: _refill(tree[k], leaves) for k in tree}
    return next(leaves)


class ParameterBuffer:
    """``granularity`` (hogwild only): ``'tree'`` applies a delta as one
    whole-tree read-modify-write, so a racing apply can drop an entire
    delta; ``'leaf'`` applies leaf by leaf against per-leaf slots, so a
    race drops at most the leaves it overlaps, at one subtract per leaf
    per apply. With ``lock=True`` the two are equivalent.

    ``device``: where the weights live; ``None`` takes the card (raises
    without one, ``utils.device.resolve_device``)."""

    def __init__(self, params, lock: bool = True, device=None, granularity: str = "tree"):
        if granularity not in ("tree", "leaf"):
            raise ValueError(f"granularity must be tree|leaf, got {granularity!r}")
        self._device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self._device) if self._device.type == "cuda"
                        else None)
        self._lock = RWLock(name="ParameterBuffer._lock") if lock else NullLock()
        self._granularity = granularity
        self._version = 0
        self._version_guard = locksan.make_lock("ParameterBuffer._version_guard")
        self._publish(self._upload(params, copy=True))

    # -- device plumbing -------------------------------------------------------

    def _on_stream(self):
        """Enter the buffer's stream after the caller's current stream."""
        if self._stream is None:
            return nullcontext()
        self._stream.wait_stream(torch.cuda.current_stream(self._device))
        return torch.cuda.stream(self._stream)

    def _upload(self, tree, copy: bool):
        """``tree`` as tensors on the buffer's device, on its stream. A
        device tensor made on another stream is marked as used by the
        buffer's (its memory is not reused until the buffer's work is
        done)."""
        with self._on_stream():
            out = _sorted_map(lambda leaf: _tensor(leaf, self._device, copy), tree)
        if self._stream is not None:
            for _, t in tree_leaves_with_path(tree):
                if isinstance(t, torch.Tensor) and t.device == self._device:
                    t.record_stream(self._stream)
        return out

    def hand_over(self, tree):
        """Make a snapshot of this buffer safe to read on the calling
        thread's current stream (see the module note); returns ``tree``.
        A no-op off the card."""
        if self._stream is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_stream(self._stream)
            for _, t in tree_leaves_with_path(tree):
                if t.device == self._device:
                    t.record_stream(current)
        return tree

    def _publish(self, params, applied: int = 0) -> None:
        if self._granularity == "leaf":
            # Per-leaf SLOTS of (tensor, deltas it holds): a dict-item
            # assignment is atomic under the GIL, so a racing apply
            # clobbers only the slots whose read-modify-write windows it
            # overlaps. (skeleton, paths, store) is published as ONE
            # attribute.
            flat = tree_leaves_with_path(params)
            self._leaf_state = (params, [p for p, _ in flat],
                                {p: (t, applied) for p, t in flat})
            self._head = None
        else:
            self._head = (params, applied)  # (tree, deltas it holds), one attribute

    # -- reads -----------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def version(self) -> int:
        """Number of ATTEMPTED updates. Under ``lock=False`` attempts can
        overwrite each other, so the applied count can be lower."""
        return self._version

    def applied_share(self) -> float:
        """The share of attempted updates that stand: whole deltas in
        'tree', leaves in 'leaf' (1.0 under the lock)."""
        if not self._version:
            return 1.0
        if self._granularity == "leaf":
            slots = self._leaf_state[2].values()
            return sum(applied for _, applied in slots) / (len(slots) * self._version)
        return self._head[1] / self._version

    def _snapshot(self):
        if self._granularity == "leaf":
            skeleton, paths, store = self._leaf_state
            return _refill(skeleton, iter([store[p][0] for p in paths]))
        return self._head[0]

    def get(self):
        """Snapshot of the current weights, on the buffer device, safe to
        read on the calling thread's current stream."""
        with self._lock.reading():
            snap = self._snapshot()
        return self.hand_over(snap)

    def get_with_version(self):
        """``(version, snapshot)`` for the servers' version-gated cache.
        The version is read BEFORE the snapshot, so a racing hogwild apply
        can only make the snapshot NEWER than its version: a cache keyed
        on it re-encodes at worst, never serves stale content."""
        with self._lock.reading():
            version = self._version
            snap = self._snapshot()
        return version, self.hand_over(snap)

    def get_host(self):
        """Host copy (CPU tensors), for the wire transports."""
        return self.get_host_with_version()[1]

    def get_host_with_version(self):
        """``(version, host snapshot)``; the copy to the host runs after
        the read lock is released."""
        version, snap = self.get_with_version()
        return version, _sorted_map(lambda t: t.cpu(), snap)

    # -- writes ----------------------------------------------------------------

    def apply_delta(self, delta) -> None:
        """``weights -= delta`` on the device (the reference's update
        convention), out of place."""
        delta = self._upload(delta, copy=False)
        with self._lock.writing():
            with self._on_stream():
                if self._granularity == "tree":
                    params, applied = self._head
                    self._head = (self._subtract(params, delta), applied + 1)
                else:
                    self._apply_per_leaf(delta)
            # Version moves INSIDE the write lock: bumping after release
            # would let a reader cache new content under the old version.
            with self._version_guard:
                self._version += 1

    @staticmethod
    def _subtract(params, delta):
        have = tree_leaves_with_path(params)
        got = tree_leaves_with_path(delta)
        if [p for p, _ in have] != [p for p, _ in got]:
            raise ValueError("delta does not match the parameter tree's structure")
        new = torch._foreach_sub([t for _, t in have], [t for _, t in got])
        return _refill(params, iter(new))

    def _apply_per_leaf(self, delta) -> None:
        """One read-modify-write per leaf SLOT: under NullLock a concurrent
        apply can clobber only the slots whose windows it overlaps."""
        store = self._leaf_state[2]
        for path, leaf_delta in tree_leaves_with_path(delta):
            tensor, applied = store[path]
            store[path] = (tensor - leaf_delta, applied + 1)

    def set(self, params, version: Optional[int] = None) -> None:
        """Replace the stored tree, uploaded on the buffer's stream and
        published as one attribute ('leaf' too). ``version`` (a warm
        restart, a standby's catch-up): resume the counter at a WAL
        snapshot's durable version instead of bumping it. The applied
        counts restart at the new version (the set tree stands for every
        update before it), so ``applied_share`` counts what is lost from
        here on. Stale caches do not rest on the number alone:
        version-gated pulls are keyed on the server's boot id too."""
        params = self._upload(params, copy=True)
        with self._lock.writing():
            # Moves inside the write lock, as apply_delta's does.
            with self._version_guard:
                self._version = int(version) if version is not None else self._version + 1
                self._publish(params, applied=self._version)
