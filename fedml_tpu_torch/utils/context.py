"""Federation-wide error context, the port's copy of
``fedml_tpu/utils/context.py`` (reference fedml_api/utils/context.py:10-18
``raise_MPI_error`` — a ctx manager that logs the exception and calls
``MPI.COMM_WORLD.Abort()`` so one rank's failure kills the job instead of
deadlocking the barrier).

Here ranks are threads or processes over the comm layer;
``federation_guard`` logs the failing rank's traceback, stops every supplied
manager (unblocking their receive loops), and records the exception so the
launcher can re-raise it on the main thread — same fail-fast semantics,
clean shutdown instead of Abort.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any, List, Optional, Sequence


class FederationErrors:
    """Shared collector: first error wins, launcher re-raises it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._errors: List[BaseException] = []

    def record(self, exc: BaseException) -> None:
        with self._lock:
            self._errors.append(exc)

    @property
    def first(self) -> Optional[BaseException]:
        with self._lock:
            return self._errors[0] if self._errors else None

    def reraise(self) -> None:
        exc = self.first
        if exc is not None:
            raise exc


@contextlib.contextmanager
def federation_guard(errors: FederationErrors,
                     managers: Sequence[Any] = (),
                     rank: Optional[int] = None):
    """Wrap one rank's event loop: on exception, log, record, and stop all
    ``managers`` so no peer blocks forever on a message that will never
    arrive (the reference's Abort, without killing the process)."""
    try:
        yield
    except BaseException as exc:  # noqa: BLE001 — re-raised by launcher
        logging.exception("rank %s failed: %s",
                          "?" if rank is None else rank, exc)
        errors.record(exc)
        for m in managers:
            try:
                m.finish()
            except Exception:
                # best-effort shutdown: the original failure is the one
                # the launcher re-raises
                logging.debug("rank %s: stopping a manager failed", rank,
                              exc_info=True)
