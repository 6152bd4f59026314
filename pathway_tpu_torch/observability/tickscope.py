"""Tick Scope, the part the serving plane uses — counterpart of
``pathway_tpu/observability/tickscope.py``.

* **Memory ledger** — planes register resident-bytes providers
  (:func:`register_memory_provider`): the KV page pools + ledger + host
  mirror of every ``DecodeScheduler`` (``generate:<label>``). Everything
  lands as ``pathway_tickscope_resident_bytes{owner,part}`` at scrape time
  and in :func:`memory_snapshot`.

* **Roofline attribution** — per-program FLOP estimates (analytic here:
  the port's kernels have no compiler cost model) over measured monotonic
  wall time give achieved FLOP/s and MFU per kernel family: ``topk``
  (stdlib/indexing), ``paged_attention`` (generate/scheduler).

The peak comes from ``PATHWAY_PEAK_FLOPS`` or, once CUDA is initialised,
from the card's name (data-sheet dense bf16 peaks, as the reference's TPU
entries are bf16 peaks); otherwise a crude per-core CPU estimate.

Not ported: the per-tick flight recorder (``TickScope``, critical paths,
``stitch_ranks``), the per-exec memory ledger, the wire taps and the
coverage feed of the plane doctor — they need the engine's runtime, which
the port does not have yet (ROADMAP.md).

Knobs::

    PATHWAY_PEAK_FLOPS       peak FLOP/s for MFU (overrides the table)
"""

from __future__ import annotations

import inspect
import os
import threading
from typing import Any, Callable

__all__ = [
    "register_memory_provider",
    "unregister_memory_provider",
    "memory_snapshot",
    "roofline",
    "Roofline",
    "peak_flops",
    "reset",
]


# ---------------------------------------------------------------------------
# metric families (lazy — importing this module must not touch the registry
# until something actually records)

_metrics_lock = threading.Lock()
_metrics: tuple | None = None


def _tickscope_metrics():
    global _metrics
    if _metrics is not None:
        return _metrics
    with _metrics_lock:
        if _metrics is not None:
            return _metrics
        from pathway_tpu_torch.observability.registry import (
            REGISTRY,
            log_linear_buckets,
        )

        resident = REGISTRY.gauge(
            "pathway_tickscope_resident_bytes",
            "resident bytes per memory-ledger owner and part (exec "
            "arrangements, GroupBy ledger doubling, KV pools + host "
            "mirror, replica index, monolith pickles)",
            labelnames=("owner", "part"),
        )
        mfu = REGISTRY.gauge(
            "pathway_tickscope_mfu",
            "achieved model-FLOP utilization per kernel family: "
            "(cost-analysis FLOPs / measured monotonic wall) / peak "
            "FLOP/s (PATHWAY_PEAK_FLOPS or the per-platform table)",
            labelnames=("family",),
        )
        flops = REGISTRY.counter(
            "pathway_tickscope_flops_total",
            "estimated FLOPs executed per kernel family (XLA cost "
            "analysis x call count)",
            labelnames=("family",),
        )
        # sub-millisecond floor: a decode step's kernels finish in tens of
        # microseconds — the default 1e-4 floor would flatten them
        kernel_seconds = REGISTRY.histogram(
            "pathway_tickscope_kernel_seconds",
            "measured wall per roofline-attributed kernel call",
            labelnames=("family",),
            buckets=log_linear_buckets(lo=1e-6, hi=64.0, per_octave=4),
        )
        REGISTRY.register_collector(_collect)
        _metrics = (resident, mfu, flops, kernel_seconds)
        return _metrics


def _collect() -> None:
    """Registry collector: promote ledger/roofline state to gauges at
    scrape time — the decode loop never pays for metric formatting."""
    resident, mfu, flops, _ks = _metrics
    snap = memory_snapshot(deep=False)
    for owner, parts in snap["owners"].items():
        for part, nbytes in parts.items():
            resident.labels(owner, part).set(float(nbytes))
    for family, fam in roofline().snapshot().items():
        mfu.labels(family).set(fam["mfu"])
        flops.labels(family).set_total(fam["flops_total"])


# ---------------------------------------------------------------------------
# memory ledger

_mem_lock = threading.Lock()
_mem_providers: dict[str, Callable[[], dict[str, int]]] = {}


def register_memory_provider(
    owner: str, fn: Callable[[], dict[str, int]]
) -> None:
    """Register (or replace) a resident-bytes provider: ``fn()`` returns
    ``{part: bytes}``. Providers are pulled at scrape/snapshot time —
    they must be cheap and must not raise (exceptions are swallowed)."""
    with _mem_lock:
        _mem_providers[owner] = fn
    _tickscope_metrics()  # arm the collector on first provider


def unregister_memory_provider(owner: str) -> None:
    with _mem_lock:
        _mem_providers.pop(owner, None)


def memory_snapshot(deep: bool = False) -> dict[str, Any]:
    """All providers' parts + the top resident-byte owners. ``deep`` is
    passed to providers that take it."""
    with _mem_lock:
        providers = dict(_mem_providers)
    owners: dict[str, dict[str, int]] = {}
    for owner, fn in providers.items():
        try:
            parts = fn(deep) if deep and _takes_deep(fn) else fn()
        except Exception:
            continue
        if parts:
            owners[owner] = {k: int(v) for k, v in parts.items()}
    flat = [
        (f"{owner}/{part}", nbytes)
        for owner, parts in owners.items()
        for part, nbytes in parts.items()
    ]
    flat.sort(key=lambda kv: -kv[1])
    return {
        "owners": owners,
        "total_bytes": sum(b for _, b in flat),
        "top": flat[:10],
    }


def _takes_deep(fn) -> bool:
    try:
        return "deep" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# roofline attribution

# dense bf16 peak FLOP/s per card, from the data sheets, matched against
# torch.cuda.get_device_name() in lower case; an unlisted card gets the
# smallest entry — set PATHWAY_PEAK_FLOPS for honest MFU there
_PEAK_TABLE = {
    "h100 80gb hbm3": 989e12,  # H100 SXM5
    "h100 pcie": 756e12,
}
_CPU_CORE_PEAK = 32e9  # 2 GHz x 2 FMA x 8 f32 lanes, a crude estimate


def _cuda_device_name() -> str | None:
    """The name of CUDA device 0 when CUDA is already initialised; None
    otherwise (a scrape must never initialise the card)."""
    try:
        import torch

        if torch.cuda.is_initialized():
            return torch.cuda.get_device_name(0)
    except Exception:
        pass
    return None


def peak_flops() -> float:
    env = os.environ.get("PATHWAY_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    name = _cuda_device_name()
    if name:
        kind = name.lower()
        for key, peak in _PEAK_TABLE.items():
            if key in kind:
                return peak
        return min(_PEAK_TABLE.values())
    return float(os.cpu_count() or 1) * _CPU_CORE_PEAK


class Roofline:
    """Per-family FLOP ledger: programs register once per (family, key)
    with their per-call FLOP estimate; every execution observes wall
    time; MFU = (sum flops / sum wall) / peak."""

    def __init__(self):
        self._lock = threading.Lock()
        # family -> key -> {flops, bytes, calls, wall_s}
        self._programs: dict[str, dict[str, dict]] = {}

    @staticmethod
    def _blank(source: str) -> dict:
        return {
            "flops": 0.0, "bytes": 0.0, "calls": 0, "wall_s": 0.0,
            "source": source,
        }

    def register(
        self,
        family: str,
        key: str,
        flops: float,
        bytes_accessed: float = 0.0,
        source: str = "cost_analysis",
    ) -> None:
        with self._lock:
            fam = self._programs.setdefault(family, {})
            p = fam.setdefault(key, self._blank(source))
            p["flops"] = float(flops)
            p["bytes"] = float(bytes_accessed)
            p["source"] = source

    def known(self, family: str, key: str) -> bool:
        with self._lock:
            return key in self._programs.get(family, {})

    def observe(self, family: str, key: str, wall_s: float) -> None:
        with self._lock:
            fam = self._programs.setdefault(family, {})
            p = fam.setdefault(key, self._blank("unregistered"))
            p["calls"] += 1
            p["wall_s"] += float(wall_s)
        _tickscope_metrics()[3].labels(family).observe(float(wall_s))

    def snapshot(self) -> dict[str, dict]:
        peak = peak_flops()
        out: dict[str, dict] = {}
        with self._lock:
            for family, fam in self._programs.items():
                flops_total = sum(
                    p["flops"] * p["calls"] for p in fam.values()
                )
                wall_total = sum(p["wall_s"] for p in fam.values())
                calls = sum(p["calls"] for p in fam.values())
                achieved = flops_total / wall_total if wall_total > 0 else 0.0
                out[family] = {
                    "programs": len(fam),
                    "calls": calls,
                    "flops_total": flops_total,
                    "wall_s": round(wall_total, 6),
                    "achieved_flops_s": achieved,
                    "peak_flops_s": peak,
                    "mfu": achieved / peak if peak > 0 else 0.0,
                }
        return out

    def samples(self, family: str) -> int:
        with self._lock:
            return sum(
                p["calls"] for p in self._programs.get(family, {}).values()
            )


_roofline = Roofline()


def roofline() -> Roofline:
    return _roofline


def reset() -> None:
    """Test hook: drop providers and roofline state (registry metric
    families persist — they are process-global like every other family)."""
    global _roofline
    with _mem_lock:
        _mem_providers.clear()
    _roofline = Roofline()
