"""The port's own copy of ``pathway_tpu/internals/errors.py``. Error handling: poison values + error logs
(reference: src/engine/error.rs, python/pathway/internals/errors.py).

Expression failures produce `ERROR` poison values that flow through the graph
instead of crashing (when ``terminate_on_error=False``); every recorded error
also lands in the global error log, queryable as a table via
``pw.global_error_log()``."""

from __future__ import annotations

import logging
import threading
from typing import Any

logger = logging.getLogger("pathway_tpu_torch")

_lock = threading.Lock()
_ERROR_LOG: list[dict[str, Any]] = []

# --- error-log scoping (reference: pw.local_error_log contexts) ----------
# Operators built inside a `with pw.local_error_log()` block route their
# RUNTIME errors to that log instead of the global one. The scope is
# captured at build time (Node.__init__) and activated around each exec's
# process()/on_end() via a thread-local (one thread per exec per tick).
_scope_stack: list[int] = []
_scope_counter = iter(range(1, 1 << 62))
_exec_scope = threading.local()


def current_build_scope() -> int | None:
    return _scope_stack[-1] if _scope_stack else None


def set_exec_scope(scope: int | None) -> None:
    _exec_scope.value = scope


def _active_scope() -> int | None:
    return getattr(_exec_scope, "value", None)


class EngineError(ValueError):
    """Engine-originated error whose message is a canonical phrase used
    verbatim in the error log (reference: src/engine/error.rs displays).
    Subclasses ValueError so terminate_on_error re-raises remain
    catchable as the conventional exception type."""


def _normalize_message(exc: Exception | str, user: bool) -> str:
    """Reference-parity wordings (reference: src/engine/error.rs display
    impls) so ported test suites compare error logs verbatim: engine
    errors use canonical phrases (EngineError / plain strings /
    'division by zero'); USER exceptions (udfs, stateful reducers)
    format as 'Type: message'."""
    if isinstance(exc, EngineError):
        return str(exc)
    if isinstance(exc, BaseException):
        if isinstance(exc, ZeroDivisionError) and not user:
            return "division by zero"
        return f"{type(exc).__name__}: {exc}"
    return str(exc)


_SCOPE_ACTIVE = object()  # sentinel: use the thread's active scope


def record_error(
    exc: Exception | str,
    operator: str | None = None,
    user: bool = False,
    scope: Any = _SCOPE_ACTIVE,
) -> None:
    if isinstance(exc, BaseException):
        # drop traceback frames before retaining: each frame pins the
        # whole evaluation batch (arrays in _elementwise locals), and a
        # UDF failing per-row would otherwise hold every failed batch
        # alive until drain_errors()
        import traceback as _tb

        _tb.clear_frames(exc.__traceback__)
        kept: BaseException | None = exc
    else:
        kept = None
    with _lock:
        _ERROR_LOG.append(
            {
                "message": _normalize_message(exc, user),
                "operator_id": operator or "",
                "trace": "",
                "log_id": _active_scope() if scope is _SCOPE_ACTIVE else scope,
                # original exception object so terminate_on_error re-raises
                # with its real type (reference: engine propagates DataError
                # as the user's exception when terminate_on_error=true)
                "exc": kept,
            }
        )
    logger.debug("recorded error: %s", exc)


def error_count() -> int:
    with _lock:
        return len(_ERROR_LOG)


def first_exception_since(n0: int) -> BaseException | str | None:
    """First error recorded after position ``n0`` — the original exception
    object when available, else its message string."""
    with _lock:
        for entry in _ERROR_LOG[n0:]:
            return entry["exc"] if entry["exc"] is not None else entry["message"]
    return None


def drain_errors() -> list[dict[str, Any]]:
    with _lock:
        out = list(_ERROR_LOG)
        _ERROR_LOG.clear()
    return out


def peek_errors() -> list[dict[str, Any]]:
    with _lock:
        return list(_ERROR_LOG)


def clear_errors() -> None:
    with _lock:
        _ERROR_LOG.clear()


def global_error_log():
    """Table of errors recorded during the run (excluding those captured
    by local error-log scopes)."""
    from pathway_tpu_torch.internals.error_log_table import error_log_table

    return error_log_table(scope=None)


class _LocalErrorLog:
    """Context manager: operators built inside route their errors to the
    yielded table (reference: pw.local_error_log)."""

    def __enter__(self):
        from pathway_tpu_torch.internals.error_log_table import error_log_table

        self.scope = next(_scope_counter)
        _scope_stack.append(self.scope)
        # the handle table itself must NOT be scope-tagged (it reads the
        # log, it doesn't produce errors into it)
        _scope_stack.append(None)  # type: ignore[arg-type]
        table = error_log_table(scope=self.scope)
        _scope_stack.pop()
        return table

    def __exit__(self, *exc_info):
        _scope_stack.pop()
        return False


def local_error_log():
    return _LocalErrorLog()
