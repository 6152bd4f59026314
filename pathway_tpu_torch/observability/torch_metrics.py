"""PyTorch/CUDA gauges for the metrics registry — counterpart of
``pathway_tpu/observability/jax_metrics.py``.

* ``pathway_build_info`` — the reference's info series with ``torch`` (and
  the CUDA toolkit torch was built with) in place of ``jax``; ``platform``
  and ``backend`` resolve once CUDA is initialised.
* ``pathway_device_memory_bytes{device,kind}`` — ``torch.cuda.memory_stats``
  per device, and ``pathway_torch_local_devices``.
* ``pathway_torch_kernel_builds_total`` / ``_build_seconds_total`` — the
  port's ``nvcc`` builds (``_build.py``). They stand where the reference
  counts jit compilations (``jax.monitoring`` events), which have no torch
  counterpart: the port's compiled programs are its hand-written kernels.

Everything here is defensive: a scrape must never *initialise* CUDA (the
reference's rule: scraping never forces backend init), so the device series
stay at their placeholders until something else has touched the card.
"""

from __future__ import annotations

import platform as _platform
import threading

from pathway_tpu_torch.observability.registry import REGISTRY, MetricsRegistry

_install_lock = threading.Lock()
_installed_on: set[int] = set()


def _cuda_if_initialized():
    """The torch module when CUDA is already initialised, else None. Never
    initialises CUDA itself."""
    try:
        import torch

        return torch if torch.cuda.is_initialized() else None
    except Exception:
        return None


def install_torch_metrics(registry: MetricsRegistry | None = None) -> None:
    """Idempotent per registry."""
    registry = registry or REGISTRY
    with _install_lock:
        if id(registry) in _installed_on:
            return
        _installed_on.add(id(registry))
    _install_build_info(registry)
    _install_build_counters(registry)
    _install_device_memory(registry)


def _install_build_info(registry: MetricsRegistry) -> None:
    import torch

    from pathway_tpu_torch import __version__ as version

    torch_version = str(torch.__version__)
    cuda_version = str(torch.version.cuda or "none")
    info = registry.gauge(
        "pathway_build_info",
        "constant 1; build/runtime identity in labels (platform/backend "
        "resolve once CUDA initializes — scraping never forces init)",
        labelnames=("version", "python", "torch", "cuda", "platform", "backend"),
    )
    state = {"platform": "uninitialized", "backend": "uninitialized"}

    def ident() -> tuple:
        return (
            version, _platform.python_version(), torch_version, cuda_version,
            state["platform"], state["backend"],
        )

    def _collect() -> None:
        if state["platform"] == "uninitialized":
            cuda = _cuda_if_initialized()
            if cuda is not None:
                # retire the placeholder series, or a scrape that raced
                # CUDA init would expose two build_info identities
                info.remove(*ident())
                state["platform"] = "cuda"
                state["backend"] = cuda.cuda.get_device_name(0)
        info.labels(*ident()).set(1)

    registry.register_collector(_collect)


def _install_build_counters(registry: MetricsRegistry) -> None:
    from pathway_tpu_torch import _build

    builds = registry.counter(
        "pathway_torch_kernel_builds_total",
        "nvcc builds of the port's CUDA sources finished in this process",
    )
    seconds = registry.counter(
        "pathway_torch_kernel_build_seconds_total",
        "cumulative wall seconds of those builds (parallel builds overlap)",
    )

    def _collect() -> None:
        builds.labels().set_total(float(_build.stats["builds"]))
        seconds.labels().set_total(float(_build.stats["seconds"]))

    registry.register_collector(_collect)


def _install_device_memory(registry: MetricsRegistry) -> None:
    mem = registry.gauge(
        "pathway_device_memory_bytes",
        "per-device memory stats from torch.cuda.memory_stats() (absent "
        "until CUDA initializes)",
        labelnames=("device", "kind"),
    )
    ndev = registry.gauge(
        "pathway_torch_local_devices",
        "local CUDA device count (0 until CUDA initializes)",
    )
    kinds = {
        "bytes_in_use": "allocated_bytes.all.current",
        "peak_bytes_in_use": "allocated_bytes.all.peak",
        "bytes_reserved": "reserved_bytes.all.current",
    }

    def _collect() -> None:
        torch = _cuda_if_initialized()
        if torch is None:
            ndev.set(0)
            return
        n = torch.cuda.device_count()
        ndev.set(n)
        for i in range(n):
            try:
                stats = torch.cuda.memory_stats(i)
                limit = torch.cuda.get_device_properties(i).total_memory
            except Exception:
                continue
            for kind, key in kinds.items():
                if key in stats:
                    mem.labels(f"cuda:{i}", kind).set(float(stats[key]))
            mem.labels(f"cuda:{i}", "bytes_limit").set(float(limit))

    registry.register_collector(_collect)
