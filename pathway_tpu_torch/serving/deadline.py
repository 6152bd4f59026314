"""Request-deadline registry — deadline propagation through the tick
(counterpart of ``pathway_tpu/serving/deadline.py``, copied as is).

The REST ingress registers each admitted request's absolute deadline
(``time.monotonic()`` seconds) under the request's row key; batch-shaped
operators downstream (the micro-batcher at flush, the external-index
exec before a device search) consult it so work whose deadline already
expired is dropped instead of burning a batch slot. Mirrors the tracing
pending-request registry (observability/tracing.py) — module-level, lock
under a dict, ~zero cost while empty.
"""

from __future__ import annotations

import threading
import time

_lock = threading.Lock()
_deadlines: dict[int, float] = {}

# entries this far past their deadline are garbage (their row either
# already ticked or will never tick); swept lazily on register so a
# handler that timed out (504) can leave its entry behind for the
# engine to observe without leaking it forever
_SWEEP_GRACE_S = 60.0


def register(key: int, deadline: float) -> None:
    now = time.monotonic()
    with _lock:
        if len(_deadlines) > 128:
            cutoff = now - _SWEEP_GRACE_S
            for k in [k for k, d in _deadlines.items() if d < cutoff]:
                del _deadlines[k]
        _deadlines[key] = deadline


def unregister(key: int) -> None:
    if not _deadlines:
        return
    with _lock:
        _deadlines.pop(key, None)


def expired(key: int, now: float | None = None) -> bool:
    """True only when the key carries a deadline AND it has passed —
    unknown keys (no gate, bulk rows) never read as expired."""
    if not _deadlines:  # fast path: no serving gate active
        return False
    with _lock:
        d = _deadlines.get(key)
    if d is None:
        return False
    return (time.monotonic() if now is None else now) > d


def remaining(key: int, now: float | None = None) -> float | None:
    """Seconds until the key's deadline (negative = expired); None when
    the key has no registered deadline."""
    if not _deadlines:
        return None
    with _lock:
        d = _deadlines.get(key)
    if d is None:
        return None
    return d - (time.monotonic() if now is None else now)


def active_count() -> int:
    with _lock:
        return len(_deadlines)
