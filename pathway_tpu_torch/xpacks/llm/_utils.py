"""The port's own copy of ``pathway_tpu/xpacks/llm/_utils.py``: the
UDF/async plumbing shared across the LLM xpack. ``_run_async`` runs a
coroutine on a fresh event loop (in a thread of its own when a loop is
already running here), so the async API clients work under the engine's
synchronous UDF path."""

from __future__ import annotations

import asyncio
import functools
import threading
from collections.abc import Callable

import pathway_tpu_torch as pw


class _RunThread(threading.Thread):
    """Run a coroutine on a fresh loop when one is already running here."""

    def __init__(self, coroutine):
        self.coroutine = coroutine
        self.result = None
        super().__init__()

    def run(self):
        self.result = asyncio.run(self.coroutine)


def _run_async(coroutine):
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        loop = None
    if loop and loop.is_running():
        thread = _RunThread(coroutine)
        thread.start()
        thread.join()
        return thread.result
    return asyncio.run(coroutine)


def _coerce_sync(func: Callable) -> Callable:
    if asyncio.iscoroutinefunction(func):

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            return _run_async(func(*args, **kwargs))

        return wrapper
    return func


def _unwrap_udf(func) -> Callable:
    """Turn a UDF into its plain callable (keeps UDF-applied settings)."""
    if isinstance(func, pw.UDF):
        return func.func
    return func


def _wrap_udf(func):
    """Wrap a callable into a UDF (UDFs pass through)."""
    if isinstance(func, pw.UDF):
        return func
    return pw.udf(func)


def _is_text_with_meta(text_with_meta) -> bool:
    return (
        isinstance(text_with_meta, tuple)
        and len(text_with_meta) == 2
        and (
            isinstance(text_with_meta[1], dict)
            or isinstance(text_with_meta[1], pw.Json)
        )
    )


def _to_dict(element):
    if isinstance(element, pw.Json):
        return element.as_dict()
    return element
