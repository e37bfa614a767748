"""Abstract parameter server/client interfaces (counterpart of
``elephas_tpu/parameter/base.py``).

Reference: ``elephas/parameter/base.py::{BaseParameterServer,
BaseParameterClient}`` (SURVEY.md §2.1 "PS servers"/"PS clients" rows).
"""

from __future__ import annotations

import abc


class BaseParameterServer(abc.ABC):
    """Central weight store for async/hogwild modes."""

    @abc.abstractmethod
    def start(self) -> None:
        """Begin serving (no-op for in-process stores)."""

    @abc.abstractmethod
    def stop(self) -> None:
        """Stop serving and release resources."""

    @abc.abstractmethod
    def get_parameters(self):
        """Current weights as a tree of tensors (server-side view)."""

    @abc.abstractmethod
    def client(self) -> "BaseParameterClient":
        """A client wired to this server (in-process or via its transport)."""


class BaseParameterClient(abc.ABC):
    """Worker-side pull/push of weights and deltas."""

    @abc.abstractmethod
    def get_parameters(self):
        """Pull current weights."""

    @abc.abstractmethod
    def update_parameters(self, delta) -> None:
        """Push a weight delta (``before - after``; server applies
        ``weights -= delta``, matching the reference's convention)."""

    # --- liveness / control-plane surface (resilience layer) -----------
    # Benign defaults so in-process clients and test fakes stay minimal;
    # the wire clients override these with real PS round-trips.

    def heartbeat(self, worker_id: str) -> None:
        """Tell the PS failure detector this worker is alive."""

    def membership(self) -> dict:
        """The PS failure detector's worker table (id -> state info)."""
        return {}

    def deregister(self, worker_id: str) -> None:
        """Graceful exit: drop the worker from the failure detector so a
        clean shutdown is never counted as an expiry."""

    def health(self) -> bool:
        """Would a new request reach the server right now?"""
        return True

    def close(self) -> None:
        """Release any pooled transport state (idempotent)."""
