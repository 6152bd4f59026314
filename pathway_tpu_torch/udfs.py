"""The port's own copy of ``pathway_tpu/udfs.py``, whole.

pw.udfs — UDF helpers: caching, retries, executors
(reference: python/pathway/udfs.py)."""

from pathway_tpu_torch.internals.udfs import (
    UDF,
    AsyncRetryStrategy,
    CacheStrategy,
    DefaultCache,
    DiskCache,
    ExponentialBackoffRetryStrategy,
    FixedDelayRetryStrategy,
    InMemoryCache,
    NoRetryStrategy,
    async_executor,
    async_options,
    auto_executor,
    coerce_async,
    with_capacity,
    with_timeout,
    fully_async_executor,
    sync_executor,
    udf,
    with_cache_strategy,
    with_retry_strategy,
)

__all__ = [
    "UDF",
    "udf",
    "CacheStrategy",
    "DiskCache",
    "InMemoryCache",
    "DefaultCache",
    "AsyncRetryStrategy",
    "ExponentialBackoffRetryStrategy",
    "FixedDelayRetryStrategy",
    "NoRetryStrategy",
    "auto_executor",
    "sync_executor",
    "async_executor",
    "fully_async_executor",
    "async_options",
    "coerce_async",
    "with_capacity",
    "with_timeout",
    "with_cache_strategy",
    "with_retry_strategy",
]
