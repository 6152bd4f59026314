"""Own copy of ``pathway_tpu/observability/tickscope.py``: the per-tick
flight recorder, the memory ledger and the roofline, with the same record
layout, names and snapshot keys as the reference.

Tick Scope — per-operator flight recorder, memory ledger, and roofline
attribution for every tick. Three legs share one file because they share
one clock and one registry:

* **Flight recorder** — an always-on, bounded-overhead ring of per-tick
  records. Every tick the runtime (engine/runtime.py) appends one entry
  per exec that ran: monotonic wall time, rows in/out, and whether the
  work went through a compiled segment (never, in the port: it runs the
  interpreter, ROADMAP [compiled-ticks]). Off (``PATHWAY_TICKSCOPE=0``)
  the hot loop pays exactly one ``is None`` check per node. The per-tick
  critical path over the exec DAG is computed lazily at snapshot time
  (:func:`critical_path`), never on the tick itself, and stitches across
  ranks through exchange channels (:func:`stitch_ranks`).
  :meth:`TickScope.chrome_trace` renders the ring as Perfetto-loadable
  trace events with **one track per exec**.

* **Memory ledger** — per-arrangement / per-exec resident-bytes
  accounting. Execs report through ``NodeExec.memory_ledger()``
  (arrangement segments, GroupBy ledger doubling, monolith pickles under
  ``deep=1``); other planes register providers
  (:func:`register_memory_provider`): the KV page pools + ledger + host
  mirror of every ``DecodeScheduler`` (``generate:<label>``). Everything
  lands as ``pathway_tickscope_resident_bytes{owner,part}`` at scrape
  time and in :func:`memory_snapshot`.

* **Roofline attribution** — per-program FLOP estimates over measured
  monotonic wall time give achieved FLOP/s and MFU per kernel family:
  ``topk`` (stdlib/indexing), ``paged_attention`` (generate/scheduler).
  The hand kernels register analytic counts; :func:`estimate_program_cost`
  counts a plain-torch function's FLOPs with
  ``torch.utils.flop_counter.FlopCounterMode`` where the reference asks
  XLA's cost analysis.

The peak comes from ``PATHWAY_PEAK_FLOPS`` or, once CUDA is initialised,
from the card's name (data-sheet dense bf16 peaks, as the reference's TPU
entries are bf16 peaks); otherwise a crude per-core CPU estimate.

The wire taps (:func:`wire_tap`) have no caller in the port yet: the mesh
exchange that feeds them is ROADMAP [mesh].

Knobs::

    PATHWAY_TICKSCOPE        1 (default) records; 0 disables the ring
    PATHWAY_TICKSCOPE_RING   ticks kept per runtime (default 128)
    PATHWAY_PEAK_FLOPS       peak FLOP/s for MFU (overrides the table)
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Hashable, Iterable, Mapping, Sequence

__all__ = [
    "TickScope",
    "TickRecord",
    "critical_path",
    "stitch_ranks",
    "recorder",
    "register_memory_provider",
    "unregister_memory_provider",
    "memory_snapshot",
    "exec_memory_ledger",
    "roofline",
    "Roofline",
    "estimate_program_cost",
    "peak_flops",
    "coverage_status",
    "wire_tap",
    "wire_snapshot",
    "reset",
]


def enabled_from_env() -> bool:
    return os.environ.get("PATHWAY_TICKSCOPE", "1") not in ("0", "false", "")


def _ring_size() -> int:
    try:
        return max(1, int(os.environ.get("PATHWAY_TICKSCOPE_RING", "128")))
    except ValueError:
        return 128


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
        wire_bytes = REGISTRY.counter(
            "pathway_tickscope_wire_bytes_total",
            "encoded mesh-frame bytes per exchange channel (tapped in "
            "parallel/wire.encode_frame callers)",
            labelnames=("channel",),
        )
        wire_rows = REGISTRY.counter(
            "pathway_tickscope_wire_rows_total",
            "rows shipped per exchange channel",
            labelnames=("channel",),
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
        # sub-millisecond floor: compiled ticks finish in 10-100 us —
        # the default 1e-4 floor would flatten them into one bucket
        kernel_seconds = REGISTRY.histogram(
            "pathway_tickscope_kernel_seconds",
            "measured wall per roofline-attributed kernel call",
            labelnames=("family",),
            buckets=log_linear_buckets(lo=1e-6, hi=64.0, per_octave=4),
        )
        cp_seconds = REGISTRY.gauge(
            "pathway_tickscope_critical_path_seconds",
            "critical-path time of the most recent recorded tick",
        )
        REGISTRY.register_collector(_collect)
        _metrics = (
            resident, wire_bytes, wire_rows, mfu, flops, kernel_seconds,
            cp_seconds,
        )
        return _metrics


def _collect() -> None:
    """Registry collector: promote ledger/roofline state to gauges at
    scrape time — the tick loop never pays for metric formatting."""
    m = _metrics
    if m is None:  # pragma: no cover - collector armed implies metrics
        return
    resident, _wb, _wr, mfu, flops, _ks, cp = m
    snap = memory_snapshot(deep=False)
    for owner, parts in snap["owners"].items():
        for part, nbytes in parts.items():
            resident.labels(owner, part).set(float(nbytes))
    for family, fam in roofline().snapshot().items():
        mfu.labels(family).set(fam["mfu"])
        flops.labels(family).set_total(fam["flops_total"])
    rec = recorder()
    if rec is not None:
        last = rec.last()
        if last is not None:
            total_s, _path = rec.record_critical_path(last)
            cp.set(total_s)


# ---------------------------------------------------------------------------
# critical path (pure — property-tested over random DAGs)


def critical_path(
    durations: Mapping[Hashable, float],
    edges: Iterable[tuple[Hashable, Hashable]],
    edge_weights: Mapping[tuple[Hashable, Hashable], float] | None = None,
) -> tuple[float, list[Hashable]]:
    """Longest duration-weighted source-to-sink path in a DAG.

    ``durations`` maps node -> node cost (seconds); ``edges`` are
    ``(src, dst)`` pairs meaning *dst consumes src*; ``edge_weights``
    optionally adds a cost to traversing an edge (an exchange channel's
    wait, a cross-rank hop). Nodes appearing only in ``edges`` count as
    zero-cost. Returns ``(total, path)`` with the path in src->dst
    order. Raises ``ValueError`` on a cycle."""
    ew = edge_weights or {}
    succs: dict[Hashable, list[Hashable]] = {}
    indeg: dict[Hashable, int] = {}
    nodes = set(durations)
    for s, d in edges:
        succs.setdefault(s, []).append(d)
        indeg[d] = indeg.get(d, 0) + 1
        nodes.add(s)
        nodes.add(d)
    best: dict[Hashable, float] = {}
    prev: dict[Hashable, Hashable | None] = {}
    ready = [n for n in nodes if indeg.get(n, 0) == 0]
    seen = 0
    while ready:
        n = ready.pop()
        seen += 1
        here = best.get(n, durations.get(n, 0.0))
        if n not in best:
            best[n] = here
            prev.setdefault(n, None)
        for d in succs.get(n, ()):
            cand = here + ew.get((n, d), 0.0) + durations.get(d, 0.0)
            if cand > best.get(d, float("-inf")):
                best[d] = cand
                prev[d] = n
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(d)
    if seen != len(nodes):
        raise ValueError("critical_path: graph has a cycle")
    if not best:
        return 0.0, []
    end = max(best, key=lambda n: best[n])
    path: list[Hashable] = []
    cur: Hashable | None = end
    while cur is not None:
        path.append(cur)
        cur = prev.get(cur)
    path.reverse()
    return best[end], path


def stitch_ranks(
    rank_durations: Mapping[int, Mapping[Hashable, float]],
    rank_edges: Mapping[int, Iterable[tuple[Hashable, Hashable]]],
    channel_edges: Iterable[
        tuple[tuple[int, Hashable], tuple[int, Hashable], float]
    ] = (),
) -> tuple[float, list[tuple[int, Hashable]]]:
    """Cross-rank critical path: each rank's exec DAG plus exchange-
    channel edges ``((src_rank, src_node), (dst_rank, dst_node), wait)``
    stitched into one graph over ``(rank, node)`` ids — the fleet-wide
    answer to "which operator chain gates the lockstep tick"."""
    durations: dict[tuple[int, Hashable], float] = {}
    edges: list[tuple[tuple[int, Hashable], tuple[int, Hashable]]] = []
    weights: dict[tuple, float] = {}
    for rank, durs in rank_durations.items():
        for n, d in durs.items():
            durations[(rank, n)] = d
    for rank, es in rank_edges.items():
        for s, d in es:
            edges.append(((rank, s), (rank, d)))
    for src, dst, wait in channel_edges:
        edges.append((src, dst))
        weights[(src, dst)] = float(wait)
    return critical_path(durations, edges, weights)


# ---------------------------------------------------------------------------
# flight recorder


class TickRecord:
    """One recorded tick: ``entries`` is a list of
    ``(node_id, start_ns, end_ns, rows_in, rows_out, compiled)`` tuples
    in completion order (``start_ns``/``end_ns`` are perf_counter_ns —
    monotonic, comparable only within this process)."""

    __slots__ = ("t", "tick_ns", "start_ns", "entries")

    def __init__(self, t: int, tick_ns: int, start_ns: int, entries: list):
        self.t = t
        self.tick_ns = tick_ns
        self.start_ns = start_ns
        self.entries = entries


class TickScope:
    """Per-runtime flight recorder. The runtime calls ``begin_tick`` /
    ``end_tick`` around its tick and appends entry tuples between them;
    everything else (critical path, snapshots, traces) reads the ring."""

    def __init__(self, ring: int | None = None, enabled: bool | None = None):
        self.enabled = enabled_from_env() if enabled is None else enabled
        self.ring: deque[TickRecord] = deque(
            maxlen=ring if ring is not None else _ring_size()
        )
        self.ticks_recorded = 0
        self.compiled_entries = 0
        self.interpreted_entries = 0
        self._names: dict[int, str] = {}
        self._edges: list[tuple[int, int]] = []
        self._channels: list[str] = []
        self._runtime: weakref.ref | None = None
        self._cur: list | None = None
        self._cur_t = 0
        self._cur_t0 = 0

    # --- runtime hooks (hot path) --------------------------------------

    def attach(self, runtime) -> None:
        """Capture the exec DAG (names + edges) the records refer to and
        register the runtime's exec memory ledger as a provider."""
        self._runtime = weakref.ref(runtime)
        self._names = {
            n.id: f"{type(n).__name__}_{n.id}" for n in runtime.order
        }
        self._edges = [
            (inp.id, n.id) for n in runtime.order for inp in n.inputs
        ]
        self._channels = sorted(
            {
                getattr(ex, "channel", None)
                for ex in runtime.execs.values()
                if getattr(ex, "channel", None)
            }
            - {None}
        ) if runtime.execs else []
        _runtimes.add(self)
        rref = self._runtime

        def _runtime_memory(deep: bool = False) -> dict[str, int]:
            rt = rref()
            if rt is None:
                return {}
            parts: dict[str, int] = {}
            for nid, ex in rt.execs.items():
                led = exec_memory_ledger(ex, deep=deep)
                name = self._names.get(nid, str(nid))
                for part, nbytes in led.items():
                    if nbytes:
                        parts[f"{name}/{part}"] = nbytes
            return parts

        register_memory_provider("runtime", _runtime_memory)

    def begin_tick(self, t: int) -> list | None:
        """Returns the per-tick entry list (or None when disabled — the
        caller's only obligation is one ``is None`` check per node)."""
        if not self.enabled:
            return None
        self._cur = []
        self._cur_t = t
        self._cur_t0 = time.perf_counter_ns()
        return self._cur

    def end_tick(self, entries: list | None, tick_ns: int) -> None:
        if entries is None or entries is not self._cur:
            return
        self._cur = None
        if not entries and self.ticks_recorded:
            return  # idle autocommit tick: nothing to attribute
        self.ticks_recorded += 1
        for e in entries:
            if e[5]:
                self.compiled_entries += 1
            else:
                self.interpreted_entries += 1
        self.ring.append(
            TickRecord(self._cur_t, tick_ns, self._cur_t0, entries)
        )

    # --- read side ------------------------------------------------------

    def last(self) -> TickRecord | None:
        return self.ring[-1] if self.ring else None

    def records(self) -> list[TickRecord]:
        return list(self.ring)

    def record_critical_path(
        self, rec: TickRecord
    ) -> tuple[float, list[int]]:
        """Critical path of one recorded tick over the attached exec DAG
        (node durations in seconds; edges from the runtime topology)."""
        durations = {
            e[0]: (e[2] - e[1]) / 1e9 for e in rec.entries
        }
        edges = [
            (s, d) for s, d in self._edges if s in durations or d in durations
        ]
        total, path = critical_path(durations, edges)
        return total, [n for n in path if n in durations]

    def operator_rollup(self, n_ticks: int | None = None) -> dict[str, dict]:
        """Per-exec totals over the trailing ``n_ticks`` records: wall
        seconds, rows in/out, compiled vs interpreted tick counts."""
        recs = self.records()
        if n_ticks is not None:
            recs = recs[-n_ticks:]
        out: dict[str, dict] = {}
        for rec in recs:
            for nid, t0, t1, rin, rout, compiled in rec.entries:
                name = self._names.get(nid, str(nid))
                d = out.setdefault(
                    name,
                    {
                        "wall_s": 0.0,
                        "rows_in": 0,
                        "rows_out": 0,
                        "compiled_ticks": 0,
                        "interpreted_ticks": 0,
                    },
                )
                d["wall_s"] += (t1 - t0) / 1e9
                d["rows_in"] += rin
                d["rows_out"] += rout
                d["compiled_ticks" if compiled else "interpreted_ticks"] += 1
        return out

    def snapshot(
        self, *, ticks: int = 1, deep: bool = False
    ) -> dict[str, Any]:
        """The ``/debug/tick`` body: last-tick anatomy + rollup + memory
        ledger + roofline + wire channels."""
        doc: dict[str, Any] = {
            "enabled": self.enabled,
            "ticks_recorded": self.ticks_recorded,
            "ring": len(self.ring),
            "compiled_entries": self.compiled_entries,
            "interpreted_entries": self.interpreted_entries,
        }
        last = self.last()
        if last is not None:
            ops = []
            for nid, t0, t1, rin, rout, compiled in last.entries:
                ops.append(
                    {
                        "node": self._names.get(nid, str(nid)),
                        "wall_ms": round((t1 - t0) / 1e6, 6),
                        "start_ms": round((t0 - last.start_ns) / 1e6, 6),
                        "rows_in": rin,
                        "rows_out": rout,
                        "compiled": bool(compiled),
                    }
                )
            cp_total, cp_path = self.record_critical_path(last)
            ran = {e[0] for e in last.entries}
            doc["last"] = {
                "t": last.t,
                "wall_ms": round(last.tick_ns / 1e6, 6),
                "operators": ops,
                # dependency edges among the operators that ran, by name
                # — what fleet.federate_ticks stitches cross-rank
                "edges": [
                    [self._names.get(s, str(s)), self._names.get(d, str(d))]
                    for s, d in self._edges
                    if s in ran and d in ran
                ],
                "critical_path": {
                    "total_ms": round(cp_total * 1e3, 6),
                    "stages": [
                        self._names.get(n, str(n)) for n in cp_path
                    ],
                    "coverage": round(
                        cp_total / max(last.tick_ns / 1e9, 1e-12), 4
                    ),
                },
            }
        if ticks > 1:
            doc["rollup"] = self.operator_rollup(ticks)
        doc["memory"] = memory_snapshot(deep=deep)
        doc["roofline"] = roofline().snapshot()
        doc["wire"] = wire_snapshot()
        return doc

    def chrome_trace(self, n_ticks: int | None = None) -> dict:
        """The ring as Chrome trace-event JSON with ONE track per exec
        (tid = node id, named via thread_name metadata) — load in
        Perfetto next to ``/debug/trace`` output; both use the same
        anchored monotonic clock as observability/tracing.py."""
        from pathway_tpu_torch.observability.tracing import _ANCHOR_NS

        events: list[dict] = []
        pid = os.getpid()
        seen_tids: set[int] = set()
        recs = self.records()
        if n_ticks is not None:
            recs = recs[-n_ticks:]
        for rec in recs:
            for nid, t0, t1, rin, rout, compiled in rec.entries:
                if nid not in seen_tids:
                    seen_tids.add(nid)
                    events.append(
                        {
                            "ph": "M",
                            "name": "thread_name",
                            "pid": pid,
                            "tid": nid,
                            "ts": 0,
                            "args": {
                                "name": self._names.get(nid, str(nid))
                            },
                        }
                    )
                events.append(
                    {
                        "ph": "X",
                        "name": self._names.get(nid, str(nid)),
                        "cat": "tickscope",
                        "pid": pid,
                        "tid": nid,
                        "ts": (_ANCHOR_NS + t0) / 1e3,
                        "dur": max((t1 - t0) / 1e3, 0.001),
                        "args": {
                            "t": rec.t,
                            "rows_in": rin,
                            "rows_out": rout,
                            "compiled": bool(compiled),
                        },
                    }
                )
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# every live recorder (weak — a GC'd runtime drops out): the doctor rule
# and the monitoring server read "the" recorder as the newest attached
_runtimes: "weakref.WeakSet[TickScope]" = weakref.WeakSet()
_last_recorder: weakref.ref | None = None


def make_recorder(runtime) -> TickScope:
    """Build + attach the per-runtime recorder (engine/runtime.py)."""
    global _last_recorder
    scope = TickScope()
    scope.attach(runtime)
    _last_recorder = weakref.ref(scope)
    return scope


def recorder() -> TickScope | None:
    """The most recently attached runtime's recorder, if still alive."""
    return _last_recorder() if _last_recorder is not None else None


def publish_recorder(scope: TickScope | None) -> None:
    """Make ``scope`` the one ``recorder()`` returns again (a nested
    runtime, such as an iterate depth's, hands it back to the outer one)."""
    global _last_recorder
    _last_recorder = weakref.ref(scope) if scope is not None else None


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
    """All providers' parts + the top resident-byte owners.

    ``deep`` is reserved for providers that expose a costlier exact
    accounting (monolith pickle sizes); the registered callables decide
    what it means — the default pull never pickles."""
    with _mem_lock:
        providers = dict(_mem_providers)
    owners: dict[str, dict[str, int]] = {}
    for owner, fn in providers.items():
        try:
            parts = fn(deep) if _takes_deep(fn) and deep else fn()
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
        import inspect

        return "deep" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def exec_memory_ledger(ex, deep: bool = False) -> dict[str, int]:
    """Resident-bytes parts of one exec. Prefers the exec's own
    ``memory_ledger`` (GroupByExec names its dict/ledger doubling);
    falls back to walking ``__dict__`` for Arrangement attributes.
    ``deep`` adds the monolith-pickle size for execs WITHOUT
    arranged_state — the exact number the snapshot-coverage rule and
    the ROADMAP's "kill the last pickle" item argue about."""
    led = getattr(ex, "memory_ledger", None)
    parts: dict[str, int] = {}
    if callable(led):
        try:
            parts = dict(led(deep=deep) or {})
        except Exception:
            parts = {}
    if not parts:
        from pathway_tpu_torch.engine.arrangement import Arrangement

        for k, v in getattr(ex, "__dict__", {}).items():
            if isinstance(v, Arrangement):
                parts[f"arrangement:{k}"] = v.resident_bytes()
    if deep and "monolith_pickle" not in parts:
        try:
            if getattr(ex, "arranged_state", lambda: None)() is None:
                state = getattr(ex, "state_dict", lambda: None)()
                if state:
                    import pickle

                    parts["monolith_pickle"] = len(
                        pickle.dumps(
                            state, protocol=pickle.HIGHEST_PROTOCOL
                        )
                    )
        except Exception:
            pass
    return parts


# ---------------------------------------------------------------------------
# wire byte taps (parallel/host_exchange.py, parallel/replicate.py)

_wire_lock = threading.Lock()
_wire: dict[str, dict[str, int]] = {}


def wire_tap(
    channel: str, wire_bytes: int, raw_bytes: int = 0, rows: int = 0
) -> None:
    """Account one encoded data frame against its exchange channel.
    Called from the mesh sender threads — off the tick hot loop, so a
    small lock is fine here."""
    with _wire_lock:
        d = _wire.setdefault(
            channel, {"wire_bytes": 0, "raw_bytes": 0, "rows": 0, "frames": 0}
        )
        d["wire_bytes"] += int(wire_bytes)
        d["raw_bytes"] += int(raw_bytes)
        d["rows"] += int(rows)
        d["frames"] += 1
    m = _tickscope_metrics()
    m[1].labels(channel).inc(int(wire_bytes))
    if rows:
        m[2].labels(channel).inc(int(rows))


def wire_snapshot() -> dict[str, dict[str, int]]:
    with _wire_lock:
        return {ch: dict(d) for ch, d in _wire.items()}


# ---------------------------------------------------------------------------
# roofline attribution

# dense bf16 peak FLOP/s per card, from the data sheets, matched against
# torch.cuda.get_device_name() in lower case; an unlisted card gets the
# smallest entry — set PATHWAY_PEAK_FLOPS for honest MFU there. The CPU
# entry is a deliberately crude per-core estimate (2 GHz x 2 FMA x 8 f32
# lanes); the *achieved* FLOP/s column is measured either way.
_PEAK_TABLE = {
    "h100 80gb hbm3": 989e12,  # H100 SXM5
    "h100 pcie": 756e12,
}
_CPU_CORE_PEAK = 32e9


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


def estimate_program_cost(fn, *args, **kwargs) -> tuple[float, float]:
    """(flops, bytes_accessed) per call of a plain-torch ``fn`` at these
    arguments: FLOPs from ``torch.utils.flop_counter.FlopCounterMode``
    (one run of ``fn``, matmul-class ops only, as the counter counts
    them), bytes as every tensor argument read once plus every tensor
    result written once. Raises when ``fn`` runs no counted op."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        out = fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    if flops <= 0:
        raise TypeError("estimate_program_cost: fn ran no counted op")
    outs = out if isinstance(out, (list, tuple)) else (out,)
    nbytes = sum(
        t.numel() * t.element_size()
        for t in (*args, *kwargs.values(), *outs)
        if isinstance(t, torch.Tensor)
    )
    return flops, float(nbytes)


class Roofline:
    """Per-family FLOP ledger: programs register once per (family, key)
    with their per-call FLOP estimate; every execution observes wall
    time; MFU = (sum flops / sum wall) / peak."""

    def __init__(self):
        self._lock = threading.Lock()
        # family -> key -> {flops, bytes, calls, wall_s}
        self._programs: dict[str, dict[str, dict]] = {}

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
            p = fam.setdefault(
                key,
                {
                    "flops": 0.0,
                    "bytes": 0.0,
                    "calls": 0,
                    "wall_s": 0.0,
                    "source": source,
                },
            )
            p["flops"] = float(flops)
            p["bytes"] = float(bytes_accessed)
            p["source"] = source

    def known(self, family: str, key: str) -> bool:
        with self._lock:
            return key in self._programs.get(family, {})

    def observe(self, family: str, key: str, wall_s: float) -> None:
        with self._lock:
            fam = self._programs.setdefault(family, {})
            p = fam.setdefault(
                key,
                {
                    "flops": 0.0,
                    "bytes": 0.0,
                    "calls": 0,
                    "wall_s": 0.0,
                    "source": "unregistered",
                },
            )
            p["calls"] += 1
            p["wall_s"] += float(wall_s)
        _tickscope_metrics()[5].labels(family).observe(float(wall_s))

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


# ---------------------------------------------------------------------------
# doctor-rule feed (analysis/plane.py `tickscope-coverage`)

_serving_active = False


def mark_serving(active: bool = True) -> None:
    """Serving surfaces (serving/replica.py) flip this so the plane
    doctor can see a replica running with the recorder off."""
    global _serving_active
    _serving_active = bool(active)


def coverage_status() -> dict[str, Any]:
    """What the `tickscope-coverage` plane rule reads: is the recorder
    enabled, is anything serving, did any compiled plane run, and how
    many roofline samples each family has."""
    compiled_ticks = 0
    for scope in list(_runtimes):
        rt = scope._runtime() if scope._runtime is not None else None
        plan = getattr(rt, "compiled_plan", None) if rt is not None else None
        if plan is not None:
            compiled_ticks += sum(
                s.compiled_ticks for s in plan.segments
            )
    return {
        "recorder_enabled": enabled_from_env(),
        "serving_active": _serving_active
        or any(o.startswith(("replica", "serving")) for o in _mem_providers),
        "compiled_ticks": compiled_ticks,
        "roofline_samples": {
            family: _roofline.samples(family)
            for family in ("compiled_tick", "topk", "paged_attention")
        },
    }


def reset() -> None:
    """Test hook: drop providers, wire counters, roofline state and the
    serving flag (registry metric families persist — they are process-
    global counters like every other family)."""
    global _roofline, _serving_active, _last_recorder
    with _mem_lock:
        _mem_providers.clear()
    with _wire_lock:
        _wire.clear()
    _roofline = Roofline()
    _serving_active = False
    _last_recorder = None
