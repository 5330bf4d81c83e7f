"""Reliable-delivery primitives shared by the socket/RPC transports (the
port's copy of ``fedml_tpu/comm/reliable.py``).

The reference's transports treat the network as infallible: gRPC calls are
fail-fast one-shots (grpc_comm_manager.py) and a dead peer either hangs the
federation or silently loses a frame. Production federated systems invert that assumption: transient link failure
is the COMMON case (Bonawitz et al., MLSys 2019), so every send is retried
with bounded, seeded exponential backoff, and duplicates created by
retrying an already-delivered frame are shed receive-side by per-stream
sequence numbers (comm/base.py). The contract after this module:

    a frame is delivered to observers exactly once, or the sender raises
    :class:`TransportError` — never a silent drop.

``RetryPolicy`` is deterministic: the backoff jitter comes from its own
seeded RNG, so a run replays the same retry schedule every time.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class TransportError(ConnectionError):
    """A send failed after exhausting its retry budget.

    ``transient`` distinguishes failures that MIGHT succeed on a fresh
    attempt later (peer restarting, link flap — ``UNAVAILABLE`` /
    ``DEADLINE_EXCEEDED`` / ``ECONNREFUSED``) from permanent ones
    (unknown host, protocol error): callers with their own recovery
    loop (the silo rejoin path) retry the former and surface the
    latter. Subclasses ``ConnectionError`` so pre-existing
    ``except OSError`` call sites still catch it.
    """

    def __init__(self, message: str, *, transient: bool = False):
        super().__init__(message)
        self.transient = transient


@dataclass
class RetryPolicy:
    """Bounded, seeded exponential backoff.

    ``max_attempts`` counts the FIRST try: 4 means 1 try + 3 retries.
    Delay before retry ``i`` (1-based) is ``base_delay_s * 2**(i-1)``
    capped at ``max_delay_s``, scaled by a jitter factor in [0.5, 1.0]
    drawn from the policy's own seeded RNG — deterministic per policy
    instance, so chaos tests replay identical schedules.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    seed: int = 0
    _rng: random.Random = field(init=False, repr=False, compare=False,
                                default=None)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")
        self._rng = random.Random(self.seed)

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1 = first retry)."""
        raw = min(self.max_delay_s,
                  self.base_delay_s * (2.0 ** (attempt - 1)))
        return raw * (0.5 + 0.5 * self._rng.random())


def default_retry_policy(seed: int = 0) -> RetryPolicy:
    """The un-configured transport retries by default — callers opt DOWN
    with ``RetryPolicy(max_attempts=1)``, never up to get safety."""
    return RetryPolicy(seed=seed)


def retry_call(fn: Callable[[], None], policy: RetryPolicy, *,
               describe: str,
               is_transient: Callable[[BaseException], bool],
               on_retry: Optional[Callable[[int, BaseException], None]]
               = None,
               sleep: Callable[[float], None] = time.sleep) -> int:
    """Run ``fn`` under ``policy``; returns the number of retries used.

    ``is_transient(exc)`` decides whether an exception is worth another
    attempt; a non-transient exception re-raises as a permanent
    :class:`TransportError` immediately. Exhausting the budget raises a
    transient :class:`TransportError` chained to the last failure.
    ``on_retry(attempt, exc)`` runs before each backoff sleep (counter
    hooks for the transports).
    """
    retries = 0
    while True:
        try:
            fn()
            return retries
        except Exception as exc:  # noqa: BLE001 — classified below
            if isinstance(exc, TransportError):
                raise
            if not is_transient(exc):
                raise TransportError(
                    f"{describe}: permanent failure: {exc!r}",
                    transient=False) from exc
            attempt = retries + 1
            if attempt >= policy.max_attempts:
                raise TransportError(
                    f"{describe}: still failing after "
                    f"{policy.max_attempts} attempts: {exc!r}",
                    transient=True) from exc
            retries = attempt
            if on_retry is not None:
                on_retry(attempt, exc)
            delay = policy.delay_s(attempt)
            logging.warning("%s failed (%r) — retry %d/%d in %.0f ms",
                            describe, exc, attempt,
                            policy.max_attempts - 1, delay * 1e3)
            sleep(delay)
