"""Key-sharded execution of stateful engine operators over a device mesh —
own copy of ``pathway_tpu/engine/sharded.py``.

Every shard owns the slice of keys whose low 16 bits map to it (``shard_of``),
and an Exchange moves each record to its owner before stateful work. Each
stateful exec is split into ``n_shards`` sub-execs with disjoint keyed
state. Numeric rows travel through ``parallel/exchange.py`` on the mesh's
devices (transport ``device``); host-only payloads (strings, json, ragged
tuples) and small batches take the numpy partition (transport ``host``).
Both give each shard the same rows in the same order.

``shard_of`` is the one ownership function of every plane (the read
plane's corpus shards use it too), and ``exchange_facts`` is the static
routing contract of each operator the Graph Doctor's shard rules read.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import (
    BufferExec,
    GroupByExec,
    JoinExec,
    NodeExec,
    SortExec,
)

# Minimum rows per batch before the device exchange is worth its dispatch
# overhead; tests lower this to force it.
DEVICE_EXCHANGE_MIN_ROWS = 512

SHARD_MASK = 0xFFFF  # low 16 bits route the row


def shard_of(gks: np.ndarray, n_shards: int) -> np.ndarray:
    """THE ownership function: every plane routes a key by this same
    jk-hash partition, so a key's owner is one agreed fact across layers
    and across the two packages."""
    return ((gks.astype(np.uint64) & np.uint64(SHARD_MASK)) % np.uint64(
        n_shards
    )).astype(np.int32)


def exchange_facts(node) -> list[tuple[str, tuple[str, ...]]]:
    """Static description of the exchange edges the sharded engine inserts
    in front of `node`: [(input label, routing key columns)]. Empty for
    operators that never re-route rows. Consumed by the Graph Doctor's
    shard-safety and graph-stats rules."""
    from pathway_tpu_torch.engine import nodes as _n

    if isinstance(node, _n.GroupByNode):
        return [("input", node.key_columns())]
    if isinstance(node, _n.JoinNode):
        return [
            ("left", tuple(node.left_on)),
            ("right", tuple(node.right_on)),
        ]
    if isinstance(node, _n.SortNode):
        # instance-less sorts are one global order and never shard
        if node.instance_col is not None:
            return [("input", (node.instance_col,))]
        return []
    if isinstance(node, _n.BufferNode):
        # the sharded buffer routes by row key; the watermark is global
        return [("input", ("id",))]
    return []


def _pack_scalar_column(col: np.ndarray):
    """One numeric array + rebuild spec for a scalar column, or None when
    ineligible."""
    from pathway_tpu_torch.parallel.exchange import packable

    orig = col.dtype
    arr = col
    if arr.dtype == object:
        # type-homogeneous python scalars only: a mixed int/float column
        # would come back type-changed after the round trip and hash to
        # different group keys than the host path
        t0 = type(arr[0])
        if t0 not in (int, float, bool) or not all(type(v) is t0 for v in arr):
            return None
        try:
            arr = np.asarray(arr.tolist())
        except (TypeError, ValueError, OverflowError):
            return None
    if arr.dtype.kind == "f" and arr.dtype.itemsize < 4:
        arr = arr.astype(np.float32)
    if arr.dtype.kind in "iu" and arr.dtype.itemsize < 8:
        arr = arr.astype(np.int64)
    if not packable(arr):
        return None
    return [arr], ("scalar", orig)


def _pack_tuple_column(col: np.ndarray):
    """Fixed-arity tuples of homogeneous numeric scalars decompose into one
    array per position (window ids like (instance, start, end) take the
    device exchange instead of forcing the whole batch onto the host)."""
    from pathway_tpu_torch.parallel.exchange import packable

    v0 = col[0]
    arity = len(v0)
    if arity == 0:
        return None
    elem_types = [type(v) for v in v0]
    if any(t not in (int, float, bool) for t in elem_types):
        return None
    for v in col:
        if type(v) is not tuple or len(v) != arity:
            return None
        for x, t in zip(v, elem_types):
            if type(x) is not t:
                return None
    arrays = []
    for pos in range(arity):
        a = np.asarray([v[pos] for v in col])
        if a.dtype.kind == "f" and a.dtype.itemsize < 4:
            a = a.astype(np.float32)
        if a.dtype.kind in "iu" and a.dtype.itemsize < 8:
            a = a.astype(np.int64)
        if not packable(a):
            return None
        arrays.append(a)
    return arrays, ("tuple", elem_types)


def _rebuild_column(arrays: list[np.ndarray], spec) -> np.ndarray:
    kind, info = spec
    if kind == "scalar":
        return arrays[0].astype(info)
    lists = [a.tolist() for a in arrays]  # python scalars, like the host path
    out = np.empty(len(lists[0]), dtype=object)
    for i, vals in enumerate(zip(*lists)):
        # restore bools: int arrays round-trip python bools as ints
        out[i] = tuple(t(v) for t, v in zip(info, vals))
    return out


def _batch_numeric_columns(b: DiffBatch):
    """[(arrays, rebuild spec)] per value column, or None if any column
    holds payloads that cannot take the device exchange (strings/json/
    nested or ragged tuples stay on the host). The spec lets the receiver
    restore the exact representation the host partition would have kept,
    so both transports feed identical columns downstream."""
    out = []
    for col in b.columns.values():
        if col.dtype == object:
            if not len(col):
                return None
            packed = (
                _pack_tuple_column(col)
                if type(col[0]) is tuple
                else _pack_scalar_column(col)
            )
        else:
            packed = _pack_scalar_column(col)
        if packed is None:
            return None
        out.append(packed)
    return out


class _ShardRouter:
    """Shared routing logic: split each incoming batch into per-shard
    sub-batches, over the mesh's devices when the rows are numeric."""

    def __init__(self, mesh: Any, axis: str):
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]
        self.device_exchanges = 0  # exchanges that ran on the mesh's devices
        # rows routed per destination shard and the transport that carried
        # them; children prebound, routing is on the per-batch hot path
        from pathway_tpu_torch.observability import REGISTRY

        rows = REGISTRY.counter(
            "pathway_shard_rows_total",
            "rows routed to each shard by the sharded-exec exchange",
            labelnames=("shard",),
        )
        self._m_shard_rows = [rows.labels(str(s)) for s in range(self.n_shards)]
        self._m_exchanges = REGISTRY.counter(
            "pathway_shard_exchanges_total",
            "exchange batches, by transport (device=the ragged all-to-all on "
            "the mesh's devices, host=numpy partition)",
            labelnames=("transport",),
        )

    def route(self, b: DiffBatch, dest: np.ndarray) -> list[DiffBatch | None]:
        """Returns one sub-batch per shard (None where empty)."""
        numeric = (
            _batch_numeric_columns(b)
            if len(b) >= DEVICE_EXCHANGE_MIN_ROWS
            else None
        )
        if numeric is not None:
            out = self._route_device(b, dest, numeric)
            self._m_exchanges.labels("device").inc()
        else:
            out = self._route_host(b, dest)
            self._m_exchanges.labels("host").inc()
        for s, sub in enumerate(out):
            if sub is not None:
                self._m_shard_rows[s].inc(len(sub))
        return out

    def _route_host(self, b, dest):
        out: list[DiffBatch | None] = [None] * self.n_shards
        for s in range(self.n_shards):
            m = dest == s
            if m.any():
                out[s] = b.mask(m)
        return out

    def _route_device(self, b, dest, numeric_cols):
        from pathway_tpu_torch.parallel.exchange import exchange_rows

        self.device_exchanges += 1
        arrays = [b.keys, b.diffs]
        for col_arrays, _spec in numeric_cols:
            arrays.extend(col_arrays)
        blocks = exchange_rows(arrays, dest, self.mesh, self.axis)
        names = b.column_names
        out: list[DiffBatch | None] = [None] * self.n_shards
        for s, cols in enumerate(blocks):
            if not len(cols[0]):
                continue
            # restore each column to its pre-exchange representation
            # (object columns back to python scalars, tuple columns
            # re-zipped, typed columns back to their dtype) so sharded
            # results equal the host partition's and the unsharded ones
            columns = {}
            pos = 2
            for name, (col_arrays, spec) in zip(names, numeric_cols):
                take = len(col_arrays)
                columns[name] = _rebuild_column(list(cols[pos : pos + take]), spec)
                pos += take
            out[s] = DiffBatch(cols[0], cols[1], columns)
        return out


class _ShardedExec(NodeExec):
    """Shared scaffolding for per-shard execs: a router, one inner exec
    per shard, the partition loop, and shard-state (de)serialization."""

    inner_cls: Any = None

    def __init__(self, node, mesh: Any, axis: str = "data"):
        super().__init__(node)
        self.router = _ShardRouter(mesh, axis)
        self.shards = [self.inner_cls(node) for _ in range(self.router.n_shards)]

    def _partition(self, batches, dests_fn) -> list[list[DiffBatch]]:
        parts: list[list[DiffBatch]] = [[] for _ in self.shards]
        for b in batches:
            if not len(b):
                continue
            for s, sub in enumerate(self.router.route(b, dests_fn(b))):
                if sub is not None:
                    parts[s].append(sub)
        return parts

    def state_dict(self) -> dict:
        # the router holds the mesh; shard states carry the data
        return {"shards": [ex.state_dict() for ex in self.shards]}

    def load_state(self, state: dict) -> None:
        for ex, st in zip(self.shards, state["shards"]):
            if st:
                ex.load_state(st)

    # --- incremental (arrangement-backed) snapshots: the State Ledger
    # protocol delegated to every shard's inner exec, each shard's
    # arrangement parts namespaced "s<i>.<name>" so segment identity (and
    # so bytes per churn) stays stable per shard across restarts

    def enable_state_ledger(self) -> None:
        for ex in self.shards:
            hook = getattr(ex, "enable_state_ledger", None)
            if hook is not None:
                hook()

    def arranged_state(self):
        per_shard = []
        for ex in self.shards:
            fn = getattr(ex, "arranged_state", None)
            arranged = fn() if fn is not None else None
            if arranged is None:
                # ANY shard on the monolith path forces the whole exec
                # monolithic: a mixed snapshot could not restore
                return None
            per_shard.append(arranged)
        arrs: dict[str, Any] = {}
        for i, (_res, shard_arrs) in enumerate(per_shard):
            for name, arr in shard_arrs.items():
                arrs[f"s{i}.{name}"] = arr
        return {"__shard_residuals__": [res for res, _a in per_shard]}, arrs

    def check_arranged_state(self, residual, arrangements) -> bool:
        """Pre-mutation restore validation: a snapshot taken under another
        shard count restores too, re-partitioned at load time."""
        shards = residual.get("__shard_residuals__")
        return isinstance(shards, list) and len(shards) >= 1

    def load_arranged_state(self, residual, arrangements) -> None:
        residuals = residual["__shard_residuals__"]
        per: list[dict] = [{} for _ in residuals]
        for key, arr in arrangements.items():
            shard, _, name = key.partition(".")
            per[int(shard[1:])][name] = arr
        if len(residuals) != len(self.shards):
            # the snapshot's N-shard partition re-splits to this run's M
            # shards by the same jk-hash ownership the router uses
            import logging

            from pathway_tpu_torch.elastic.planner import repartition_shard_states

            n_old = len(residuals)
            residuals, per, stats = repartition_shard_states(residuals, per, len(self.shards))
            logging.getLogger("pathway_tpu_torch").info(
                "elastic restore: re-partitioned %d-shard snapshot to %d shards "
                "(%d rows, %d moved) for %s",
                n_old,
                len(self.shards),
                stats["total_rows"],
                stats["moved_rows"],
                type(self).__name__,
            )
        for ex, res, shard_arrs in zip(self.shards, residuals, per):
            ex.load_arranged_state(res, shard_arrs)


class ShardedGroupByExec(_ShardedExec):
    """groupby-reduce with per-shard disjoint state: rows are exchanged to
    the shard owning their group key, each shard reduces on its own."""

    inner_cls = GroupByExec

    def _dests(self, b: DiffBatch) -> np.ndarray:
        ex = self.shards[0]
        simple = not self.node.set_id and ex.inst_idx is None
        if simple:
            gks = np.asarray(ex._group_keys_batch(b), dtype=np.uint64)
        else:
            cols = list(b.columns.values())
            gks = np.fromiter(
                (
                    ex._group_key(tuple(c[i] for c in cols)) & 0xFFFFFFFFFFFFFFFF
                    for i in range(len(b))
                ),
                dtype=np.uint64,
                count=len(b),
            )
        return shard_of(gks, self.router.n_shards)

    def process(self, t, inputs):
        parts = self._partition(inputs[0], self._dests)
        out: list[DiffBatch] = []
        for ex, sub_batches in zip(self.shards, parts):
            if sub_batches:
                out.extend(ex.process(t, [sub_batches]))
        return out

    def shard_group_keys(self) -> list[set[int]]:
        """Per-shard owned group keys — disjoint by construction."""
        return [set(ex.groups.keys()) for ex in self.shards]


class ShardedJoinExec(_ShardedExec):
    """Equijoin with per-shard disjoint state: both sides exchange on the
    join-key hash so matching rows co-locate."""

    inner_cls = JoinExec

    def _dests(self, b: DiffBatch, on_idx, side_tag: str) -> np.ndarray:
        # route by the EXACT join keys the inner exec arranges by
        # (_batch_jks: null on-columns get per-row private keys); hashing
        # the raw columns would pile every null-keyed row onto one shard
        jks = np.asarray(self.shards[0]._batch_jks(b, on_idx, side_tag), dtype=np.uint64)
        return shard_of(jks, self.router.n_shards)

    def process(self, t, inputs):
        l_on = self.shards[0].l_on_idx
        r_on = self.shards[0].r_on_idx
        lparts = self._partition(inputs[0], lambda b: self._dests(b, l_on, "l"))
        rparts = self._partition(inputs[1], lambda b: self._dests(b, r_on, "r"))
        out: list[DiffBatch] = []
        for ex, lsub, rsub in zip(self.shards, lparts, rparts):
            if lsub or rsub:
                out.extend(ex.process(t, [lsub, rsub]))
        return out


class ShardedBufferExec(_ShardedExec):
    """Temporal buffer with per-shard held state: rows route to the shard
    owning their row key; the release watermark (max time seen) is a
    GLOBAL property, combined across shards every tick."""

    inner_cls = BufferExec

    def _dests(self, b: DiffBatch) -> np.ndarray:
        return shard_of(np.asarray(b.keys, dtype=np.uint64), self.router.n_shards)

    def process(self, t, inputs):
        cur_idx = self.shards[0].cur_idx
        batch_max = None
        for b in inputs[0]:
            if not len(b):
                continue
            # global watermark: the max current-time over the WHOLE batch
            # (all shards), not just the rows a shard happens to own
            for v in b.columns[self.node.inputs[0].column_names[cur_idx]]:
                if v is not None and (batch_max is None or v > batch_max):
                    batch_max = v
        parts = self._partition(inputs[0], self._dests)
        if batch_max is not None:
            for ex in self.shards:
                if ex.max_seen is None or batch_max > ex.max_seen:
                    ex.max_seen = batch_max
        out: list[DiffBatch] = []
        for ex, sub_batches in zip(self.shards, parts):
            if sub_batches or batch_max is not None:
                out.extend(ex.process(t, [sub_batches]))
        return out

    def on_end(self):
        out: list[DiffBatch] = []
        for ex in self.shards:
            out.extend(ex.on_end())
        return out

    def shard_touched_keys(self) -> list[set[int]]:
        """Keys each shard has ever held or released (held empties after
        the final flush)."""
        return [set(ex.held.keys()) | set(ex.released) for ex in self.shards]


class ShardedSortExec(_ShardedExec):
    """prev/next maintenance sharded by INSTANCE: each instance's sorted
    order lives wholly on the shard owning the instance hash. Instance-less
    sorts never take this path (``SortNode._make_local_exec``)."""

    inner_cls = SortExec

    def __init__(self, node, mesh: Any, axis: str = "data"):
        super().__init__(node, mesh, axis)
        self._i_idx = self.shards[0].i_idx

    def _dests(self, b: DiffBatch) -> np.ndarray:
        if self._i_idx is None:
            return np.zeros(len(b), dtype=np.int32)
        from pathway_tpu_torch.internals.api import ref_scalars_columns

        inst_col = list(b.columns.values())[self._i_idx]
        insts = np.asarray(ref_scalars_columns([inst_col], len(b)), dtype=np.uint64)
        return shard_of(insts, self.router.n_shards)

    def process(self, t, inputs):
        parts = self._partition(inputs[0], self._dests)
        out: list[DiffBatch] = []
        for ex, sub_batches in zip(self.shards, parts):
            if sub_batches:
                out.extend(ex.process(t, [sub_batches]))
        return out

    def shard_instances(self) -> list[set]:
        return [set(ex.instances.keys()) for ex in self.shards]
