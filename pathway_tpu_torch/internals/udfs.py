"""The port's own copy of ``pathway_tpu/internals/udfs.py``. @pw.udf — user-defined functions
(reference: python/pathway/udfs.py + internals/udfs/). Sync UDFs evaluate
batched on the host feed path; async UDFs gather per-row coroutines with
capacity/timeout/retry policies."""

from __future__ import annotations

import asyncio
import functools
import typing
from typing import Any, Callable

from pathway_tpu_torch.internals import expression as expr_mod


class CacheStrategy:
    pass


class DiskCache(CacheStrategy):
    def __init__(self, name: str | None = None):
        self.name = name


class InMemoryCache(CacheStrategy):
    pass


class DefaultCache(DiskCache):
    pass


class AsyncRetryStrategy:
    pass


class ExponentialBackoffRetryStrategy(AsyncRetryStrategy):
    def __init__(
        self,
        max_retries: int = 3,
        initial_delay_ms: int = 1000,
        backoff_factor: float = 2.0,
        jitter_ms: int = 300,
    ):
        self.max_retries = max_retries
        self.initial_delay_ms = initial_delay_ms
        self.backoff_factor = backoff_factor
        self.jitter_ms = jitter_ms


class FixedDelayRetryStrategy(ExponentialBackoffRetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1000):
        super().__init__(max_retries, delay_ms, 1.0, 0)


class NoRetryStrategy(AsyncRetryStrategy):
    pass


def with_capacity(fn: Callable, capacity: int) -> Callable:
    """Bound concurrent invocations of an async fn with a semaphore
    (reference: executors.py with_capacity). One semaphore per event loop:
    each engine tick runs its own asyncio.run, and a semaphore must not
    carry waiters across loops."""
    import weakref

    sems: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    @functools.wraps(fn)
    async def limited(*args, **kwargs):
        loop = asyncio.get_running_loop()
        sem = sems.get(loop)
        if sem is None:
            sem = asyncio.Semaphore(capacity)
            sems[loop] = sem
        async with sem:
            return await fn(*args, **kwargs)

    return limited


def with_timeout(fn: Callable, timeout: float) -> Callable:
    @functools.wraps(fn)
    async def timed(*args, **kwargs):
        return await asyncio.wait_for(fn(*args, **kwargs), timeout=timeout)

    return timed


def async_options(
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: "AsyncRetryStrategy | None" = None,
    cache_strategy: "CacheStrategy | None" = None,
):
    """Decorator applying the async execution options to a coroutine fn
    (reference: udfs.async_options)."""

    def wrapper(fn):
        fn = coerce_async(fn)
        if cache_strategy is not None:
            fn = with_cache_strategy(fn, cache_strategy)
        if retry_strategy is not None:
            fn = with_retry_strategy(fn, retry_strategy)
        if timeout is not None:
            fn = with_timeout(fn, timeout)
        if capacity is not None:
            fn = with_capacity(fn, capacity)
        return fn

    return wrapper


def run_async_blocking(coro_factory: Callable[[], Any]) -> Any:
    """Run a coroutine to completion from sync code, whether or not an
    event loop is already running in this thread (shared by the expression
    evaluator's async apply and AsyncTransformer)."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro_factory())
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(lambda: asyncio.run(coro_factory())).result()


def coerce_async(fn: Callable) -> Callable:
    """Lift a sync fn to a coroutine running in the default thread pool —
    calling it inline would serialize the whole gather behind each
    blocking call (reference: executors.py coerce_async dispatches sync
    fns via run_in_executor)."""
    if asyncio.iscoroutinefunction(fn):
        return fn

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, functools.partial(fn, *args, **kwargs)
        )

    return wrapper


def with_cache_strategy(fn, cache_strategy):
    memo: dict = {}

    if asyncio.iscoroutinefunction(fn):
        # coalesce CONCURRENT calls for the same key: rows of one batch
        # fire simultaneously, and each key must compute exactly once
        # (reference: async caches share the in-flight future). In-flight
        # state is scoped per event loop (one asyncio.run per tick) via a
        # weak mapping, like with_capacity; only the RESULT memo persists
        # across batches.
        import weakref

        inflight_by_loop: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary()
        )

        @functools.wraps(fn)
        async def cached_async(*args):
            key = args
            loop = asyncio.get_running_loop()
            inflight = inflight_by_loop.setdefault(loop, {})
            while True:
                if key in memo:
                    return memo[key]
                fut = inflight.get(key)
                if fut is not None:
                    try:
                        return await fut
                    except asyncio.CancelledError:
                        if fut.cancelled():
                            # the OWNER was cancelled (e.g. its timeout):
                            # retry — this waiter may become the owner and
                            # still produce a per-row result
                            continue
                        raise  # this waiter itself was cancelled
                fut = loop.create_future()
                inflight[key] = fut
                try:
                    result = await fn(*args)
                except asyncio.CancelledError:
                    # do NOT broadcast cancellation as an exception: cancel
                    # the shared future so waiters recompute; the owner's
                    # own cancellation propagates (wait_for turns it into
                    # TimeoutError -> a clean per-row ERROR)
                    inflight.pop(key, None)
                    fut.cancel()
                    raise
                except BaseException as exc:
                    inflight.pop(key, None)
                    fut.set_exception(exc)
                    # consume so an un-awaited future does not warn;
                    # waiters re-raise via the shared future
                    fut.exception()
                    raise
                memo[key] = result
                fut.set_result(result)
                inflight.pop(key, None)
                return result

        return cached_async

    @functools.wraps(fn)
    def cached(*args):
        key = args
        if key in memo:
            return memo[key]
        result = fn(*args)
        memo[key] = result
        return result

    return cached


def with_retry_strategy(fn, retry_strategy: AsyncRetryStrategy):
    if isinstance(retry_strategy, NoRetryStrategy) or not isinstance(
        retry_strategy, ExponentialBackoffRetryStrategy
    ):
        return fn

    @functools.wraps(fn)
    async def retried(*args, **kwargs):
        delay = retry_strategy.initial_delay_ms / 1000
        last: Exception | None = None
        for attempt in range(retry_strategy.max_retries + 1):
            try:
                return await fn(*args, **kwargs)
            except Exception as exc:
                last = exc
                if attempt == retry_strategy.max_retries:
                    raise
                await asyncio.sleep(delay)
                delay *= retry_strategy.backoff_factor
        raise last  # pragma: no cover

    return retried


class UDF:
    """Base class for user-defined functions
    (subclass with __wrapped__, or produced by @pw.udf)."""

    def __init__(
        self,
        *,
        return_type: Any = None,
        deterministic: bool | None = None,
        propagate_none: bool = False,
        executor: Any = None,
        cache_strategy: CacheStrategy | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
        timeout: float | None = None,
        max_batch_size: int | None = None,
        **kwargs: Any,
    ):
        self._return_type = return_type
        self._deterministic = deterministic
        self._propagate_none = propagate_none
        self._cache_strategy = cache_strategy
        self._retry_strategy = retry_strategy
        self._timeout = timeout
        self._max_batch_size = max_batch_size
        self._executor = executor
        if hasattr(self, "__wrapped__"):
            self._prepare(self.__wrapped__)

    def _prepare(self, fn: Callable) -> None:
        self._fn_raw = fn
        self._is_async = asyncio.iscoroutinefunction(fn)
        fn2 = fn
        ex = getattr(self, "_executor", None)
        if isinstance(ex, AsyncExecutor):
            # async execution requested: lift sync fns and fold the
            # executor's options into the UDF-level ones
            fn2 = coerce_async(fn2)
            self._is_async = True
            if ex.retry_strategy is not None and self._retry_strategy is None:
                self._retry_strategy = ex.retry_strategy
            if ex.timeout is not None and self._timeout is None:
                self._timeout = ex.timeout
        elif isinstance(ex, SyncExecutor) and self._is_async:
            raise TypeError(
                "sync_executor() cannot run a coroutine function"
            )
        if self._cache_strategy is not None:
            fn2 = with_cache_strategy(fn2, self._cache_strategy)
        if self._is_async and self._retry_strategy is not None:
            fn2 = with_retry_strategy(fn2, self._retry_strategy)
        if self._is_async and self._timeout is not None:
            fn2 = with_timeout(fn2, self._timeout)
        if isinstance(ex, AsyncExecutor) and ex.capacity is not None:
            # outermost so the concurrency bound covers retries + timeout
            fn2 = with_capacity(fn2, ex.capacity)
        self._fn = fn2
        if self._return_type is None:
            try:
                hints = typing.get_type_hints(fn)
                self._return_type = hints.get("return", Any)
            except Exception:
                self._return_type = Any

    @property
    def func(self) -> Callable:
        return self._fn_raw

    _batched = False

    def __call__(self, *args: Any, **kwargs: Any) -> expr_mod.ColumnExpression:
        if not hasattr(self, "_fn"):
            self._prepare(self.__wrapped__)  # type: ignore[attr-defined]
        if self._batched and self._is_async:
            raise TypeError(
                "batched UDFs must be synchronous (the batch already "
                "amortizes latency); drop async or _batched"
            )
        if self._batched:
            cls: Any = expr_mod.BatchApplyExpression
        elif self._is_async:
            cls = expr_mod.AsyncApplyExpression
        else:
            cls = expr_mod.ApplyExpression
        expr = cls(
            self._fn,
            self._return_type,
            self._propagate_none,
            self._deterministic,
            args,
            kwargs,
            max_batch_size=self._max_batch_size,
        )
        # provenance for static analysis: which UDF produced this node
        expr._udf_name = getattr(self._fn_raw, "__name__", None)
        return expr

    @property
    def deterministic(self) -> bool | None:
        """Tri-state determinism declaration: True (re-evaluation under
        retraction/replay yields identical values), False (explicitly
        non-deterministic — the Graph Doctor's shard-safety rule flags it
        when it feeds an exchange boundary), or None (unspecified)."""
        return self._deterministic


def udf(
    fn: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool | None = None,
    propagate_none: bool = False,
    executor: Any = None,
    cache_strategy: CacheStrategy | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
    timeout: float | None = None,
    max_batch_size: int | None = None,
    **kwargs: Any,
):
    """Decorator turning a function into a column-expression builder."""

    def make(f: Callable) -> UDF:
        u = UDF(
            return_type=return_type,
            deterministic=deterministic,
            propagate_none=propagate_none,
            executor=executor,
            cache_strategy=cache_strategy,
            retry_strategy=retry_strategy,
            timeout=timeout,
            max_batch_size=max_batch_size,
        )
        u._prepare(f)
        functools.update_wrapper(u, f, updated=[])
        return u

    if fn is not None:
        return make(fn)
    return make


# executors (reference: internals/udfs/executors.py:36-225)


class Executor:
    """Execution strategy marker for @pw.udf(executor=...)."""


class AutoExecutor(Executor):
    """Sync for plain functions, async for coroutines (the default)."""


class SyncExecutor(Executor):
    """Force synchronous in-batch evaluation."""


class AsyncExecutor(Executor):
    """Run the UDF asynchronously (a sync fn is lifted to a coroutine)
    with optional concurrency capacity, timeout and retries."""

    def __init__(
        self,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
    ):
        self.capacity = capacity
        self.timeout = timeout
        self.retry_strategy = retry_strategy


class FullyAsyncExecutor(AsyncExecutor):
    """Results may arrive across ticks in the reference; under the
    totally-ordered microbatch engine the batch completes within its tick
    (same stance as AsyncTransformer), so this behaves as AsyncExecutor."""


def auto_executor() -> Executor:
    return AutoExecutor()


def sync_executor() -> Executor:
    return SyncExecutor()


def async_executor(
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
) -> Executor:
    return AsyncExecutor(
        capacity=capacity, timeout=timeout, retry_strategy=retry_strategy
    )


def fully_async_executor(
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
) -> Executor:
    return FullyAsyncExecutor(
        capacity=capacity, timeout=timeout, retry_strategy=retry_strategy
    )
