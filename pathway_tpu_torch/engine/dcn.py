"""Cross-process exec wrappers: keyed state spanning engine processes —
the port's own copy of ``pathway_tpu/engine/dcn.py`` (the same routing,
channels and placement contract, over ``parallel/host_exchange.py``).

Stateful operators exchange rows to the process owning their key before
doing stateful work, exactly like the reference's Exchange pact over
timely's TCP mesh (reference: src/engine/dataflow/operators.rs:128,432;
external/timely-dataflow/communication/src/networking.rs:16-33). Rows are
routed by the low shard bits of the group/join key hash
(src/engine/value.rs:38 SHARD_MASK), so each process's inner exec holds a
disjoint key range; within a process the inner exec may further shard
over the device mesh (engine/sharded.py). Every process calls process()
for every node at every lockstep tick (runtime.py), so each (channel,
tick, src->dst) pair carries exactly one message — possibly an empty
partition — and gather() knows exactly how many to wait for.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from pathway_tpu_torch.engine.batch import DiffBatch
from pathway_tpu_torch.engine.nodes import NodeExec
from pathway_tpu_torch.engine.sharded import shard_of


class _DcnRouter:
    """Partition batches by owning process and swap partitions over the
    host mesh; merge arrivals in process-id order (deterministic)."""

    def __init__(self, channel: str):
        from pathway_tpu_torch.observability.tracing import get_tracer
        from pathway_tpu_torch.parallel.host_exchange import get_host_mesh

        self.mesh = get_host_mesh()
        self.channel = channel
        self.n = self.mesh.n
        self.pid = self.mesh.pid
        self.exchanges = 0  # observability, mirrors _ShardRouter counter
        self._tracer = get_tracer()

    def partition(
        self, batches: Sequence[DiffBatch], dests_fn
    ) -> list[list[DiffBatch]]:
        """Split each batch by destination process with ONE stable
        argsort + segment-bound search per batch, instead of n_procs
        boolean mask + ``b.mask(m)`` passes. The stable sort keeps the
        original row order inside every partition, so receivers apply
        rows in the same order the old masking produced."""
        parts: list[list[DiffBatch]] = [[] for _ in range(self.n)]
        for b in batches:
            if not len(b):
                continue
            dest = np.asarray(dests_fn(b))
            first = int(dest[0])
            if bool((dest == first).all()):
                # the overwhelmingly common case once upstream data is
                # already sharded: the whole batch has one owner
                parts[first].append(b)
                continue
            order = np.argsort(dest, kind="stable")
            bounds = np.searchsorted(
                dest[order], np.arange(self.n + 1)
            )
            for p in range(self.n):
                lo, hi = bounds[p], bounds[p + 1]
                if hi > lo:
                    parts[p].append(b.take(order[lo:hi]))
        return parts

    def _all_to_all(self, span_name: str, t: int, payload_for) -> dict:
        """Traced send-to-all + gather: the wire hop — frames carry this
        span's traceparent (host_exchange stamps every frame); the lowest
        received remote traceparent is attached so a cross-process trace
        is inspectable from either side."""
        with self._tracer.span(
            span_name, channel=self.channel, tick=t
        ) as sp:
            for p in range(self.n):
                if p != self.pid:
                    self.mesh.send(p, self.channel, t, payload_for(p))
            got = self.mesh.gather(self.channel, t)
            remote = self.mesh.take_gather_tps(self.channel, t)
            if remote:
                sp.set_attribute(
                    "remote_traceparent", remote[min(remote)]
                )
        return got

    def exchange_keep_src(
        self, t: int, parts: list[list[DiffBatch]]
    ) -> list[tuple[int, list[DiffBatch]]]:
        """Swap partitions; result is (src, batches) in GLOBAL pid order —
        every process then applies one tick's rows in the identical order,
        so order-sensitive state (last-write-wins triplets, acceptors)
        agrees group-wide. The src tags let ops route results back home."""
        self.exchanges += 1
        got = self._all_to_all("dcn.exchange", t, lambda p: parts[p])
        return [
            (p, parts[p] if p == self.pid else got.get(p, []))
            for p in range(self.n)
        ]

    def exchange(
        self, t: int, parts: list[list[DiffBatch]]
    ) -> list[DiffBatch]:
        return [
            b for _src, bs in self.exchange_keep_src(t, parts) for b in bs
        ]

    def exchange_scalar(self, t: int, value: Any) -> list[Any]:
        """All-gather one picklable value per process (pid order)."""
        self.exchanges += 1
        got = self._all_to_all("dcn.exchange_scalar", t, lambda p: value)
        got[self.pid] = value
        return [got[p] for p in sorted(got)]


DCN_INNER_KEY = "__dcn_inner__"  # wrapper residual nesting contract —
DCN_EXTRA_KEY = "__dcn_extra__"  # shared with the elastic resharder
# (elastic/mesh.py), which must peel and re-wrap these exact keys when
# it re-partitions a rank's arranged blob for a new topology


class _InnerArrangedMixin:
    """Delegates the incremental-snapshot protocol (PR-7 State Ledger)
    to the wrapped inner exec, so DCN-wrapped operators get
    arrangement-backed segment snapshots instead of pickling their inner
    state monolithically through the wrapper's ``state_dict``.  The
    wrapper's own cross-process bookkeeping (e.g. the origin tracker)
    rides in the residual under reserved keys; the arrangements pass
    through untouched, keeping segment identity (and so bytes ∝ churn)
    stable across the wrapper boundary."""

    def _wrapper_residual(self) -> dict:
        return {}

    def _load_wrapper_residual(self, extra: dict) -> None:
        pass

    def enable_state_ledger(self) -> None:
        """The persistence driver arms ledger-keeping execs before any
        tick runs; forward the arming through the wrapper so a
        DCN-wrapped GroupBy keeps its ledger too."""
        hook = getattr(self.inner, "enable_state_ledger", None)
        if hook is not None:
            hook()

    def arranged_state(self):
        inner_fn = getattr(self.inner, "arranged_state", None)
        arranged = inner_fn() if inner_fn is not None else None
        if arranged is None:
            return None  # inner snapshots monolithically (state_dict)
        residual, arrs = arranged
        return (
            {
                DCN_INNER_KEY: residual,
                DCN_EXTRA_KEY: self._wrapper_residual(),
            },
            arrs,
        )

    def check_arranged_state(self, residual, arrangements) -> bool:
        """Pre-mutation restore validation passes through the wrapper
        to the inner exec (e.g. a sharded inner validating its shard
        count against the snapshot's)."""
        check = getattr(self.inner, "check_arranged_state", None)
        if check is None:
            return True
        return check(
            residual.get(DCN_INNER_KEY, residual), arrangements
        )

    def load_arranged_state(self, residual, arrangements) -> None:
        if DCN_INNER_KEY in residual:
            self._load_wrapper_residual(residual.get(DCN_EXTRA_KEY, {}))
            self.inner.load_arranged_state(
                residual[DCN_INNER_KEY], arrangements
            )
        else:
            # a snapshot written single-process then restored under DCN
            # cannot occur (the group restores its own per-process
            # stores), but a bare-residual blob still belongs to the
            # inner exec — never to the wrapper
            self.inner.load_arranged_state(residual, arrangements)


class DcnGroupByExec(_InnerArrangedMixin, NodeExec):
    """groupby-reduce whose keyed state spans processes: rows go to the
    process owning their group key; the local exec (possibly device-mesh
    sharded) reduces its disjoint range (reference: group_by_table after
    Exchange, src/engine/dataflow.rs:3404)."""

    def __init__(self, node):
        super().__init__(node)
        self.inner = node._make_local_exec()
        self.router = _DcnRouter(f"gb{node.id}")
        # ticks at or below this time are already covered by restored
        # state: drop them AFTER the exchange (the exchange itself must
        # still run so channel/tick pairing stays aligned group-wide) —
        # the receiver-side half of the reference's "all workers flushed
        # up to T" consensus (src/persistence/state.rs:291)
        self.replay_floor = -1
        # stateless probe for group-key derivation (no rows ever applied)
        self._probe = (
            self.inner.shards[0]
            if hasattr(self.inner, "shards")
            else self.inner
        )

    def _gks(self, b: DiffBatch) -> np.ndarray:
        probe = self._probe
        simple = not self.node.set_id and probe.inst_idx is None
        if simple:
            return np.asarray(probe._group_keys_batch(b), dtype=np.uint64)
        cols = list(b.columns.values())
        return np.fromiter(
            (
                probe._group_key(tuple(c[i] for c in cols))
                & 0xFFFFFFFFFFFFFFFF
                for i in range(len(b))
            ),
            dtype=np.uint64,
            count=len(b),
        )

    def _dests(self, b: DiffBatch) -> np.ndarray:
        return shard_of(self._gks(b), self.router.n)

    def process(self, t, inputs):
        parts = self.router.partition(inputs[0], self._dests)
        local = self.router.exchange(t, parts)
        if t <= self.replay_floor:
            return []  # restored state already covers this tick
        return self.inner.process(t, [local])

    def owned_group_keys(self) -> set[int]:
        if hasattr(self.inner, "shard_group_keys"):
            return set().union(*self.inner.shard_group_keys())
        return set(self.inner.groups.keys())

    def on_end(self):
        return self.inner.on_end()

    def state_dict(self):
        return {"inner": self.inner.state_dict()}

    def load_state(self, state):
        if state.get("inner"):
            self.inner.load_state(state["inner"])


class DcnJoinExec(_InnerArrangedMixin, NodeExec):
    """Equijoin whose build/probe state spans processes: both sides route
    by join-key hash so matches co-locate (reference: join_tables
    arrange+join_core after Exchange, src/engine/dataflow.rs:2740)."""

    def __init__(self, node):
        super().__init__(node)
        self.inner = node._make_local_exec()
        self.lrouter = _DcnRouter(f"jl{node.id}")
        self.rrouter = _DcnRouter(f"jr{node.id}")
        self.replay_floor = -1  # see DcnGroupByExec.replay_floor
        lcols = node.inputs[0].column_names
        rcols = node.inputs[1].column_names
        self._l_on = [lcols.index(c) for c in node.left_on]
        self._r_on = [rcols.index(c) for c in node.right_on]
        # probe JoinExec for join-key derivation: the routing hash MUST be
        # the exact _batch_jks contract the inner exec groups by, or DCN
        # routing silently diverges from local state
        self._probe = (
            self.inner.shards[0]
            if hasattr(self.inner, "shards")
            else self.inner
        )

    def _dests(self, b: DiffBatch, on_idx: list[int]) -> np.ndarray:
        jks = np.asarray(
            self._probe._batch_jks(b, on_idx), dtype=np.uint64
        )
        return shard_of(jks, self.lrouter.n)

    def process(self, t, inputs):
        lparts = self.lrouter.partition(
            inputs[0], lambda b: self._dests(b, self._l_on)
        )
        rparts = self.rrouter.partition(
            inputs[1], lambda b: self._dests(b, self._r_on)
        )
        local_l = self.lrouter.exchange(t, lparts)
        local_r = self.rrouter.exchange(t, rparts)
        if t <= self.replay_floor:
            return []  # restored state already covers this tick
        return self.inner.process(t, [local_l, local_r])

    def on_end(self):
        return self.inner.on_end()

    def state_dict(self):
        return {"inner": self.inner.state_dict()}

    def load_state(self, state):
        if state.get("inner"):
            self.inner.load_state(state["inner"])


# ---------------------------------------------------------------------------
# Generic stateful exchange (VERDICT r4 item 2): every remaining stateful
# operator type gets a cross-process wrapper, mirroring the reference's
# universal Exchange pact (external/timely-dataflow/timely/src/dataflow/
# channels/pact.rs:56-59; src/engine/dataflow/operators.rs:415 Reshard).
# Routing disciplines:
#   "key"   — partition rows by an operator-specific key hash; the inner
#             exec owns a disjoint key range (groupby/join discipline)
#   "bcast" — replicate this input on every process (small side inputs:
#             gradual_broadcast thresholds, external-index corpus)
#   "p0"    — centralize this input on process 0 (inherently global state:
#             instance-less sort, iterate fixpoints)
#   "local" — no exchange (rows already live where their state lives)
#
# Placement contract: an op whose output universe is FRESH (dedup, iterate,
# update_rows — new keys or a new key set) may leave results on the process
# that computed them; union across processes is the result. An op whose
# output universe is an INPUT's universe (ix, set-ops, sort, buffer,
# gradual_broadcast, external_index) must emit each row on the process
# where that input row lives, or downstream aligned row-wise execs would
# see half a row — so those ops either keep the universe-owning side local
# (replicating the other side) or exchange results back to their origin.

_U64 = 0xFFFFFFFFFFFFFFFF


class _DcnStatefulExec(_InnerArrangedMixin, NodeExec):
    """Shared plumbing: build the node's local exec, route each input per
    its spec, feed the merged partitions through. Output rows are emitted
    on the process owning their key — per-process outputs union to the
    single-process result, the same contract as DcnGroupByExec."""

    def __init__(self, node, specs, tag: str):
        super().__init__(node)
        self.inner = node._make_local_exec()
        self.replay_floor = -1  # see DcnGroupByExec.replay_floor
        if getattr(self.inner, "persist_standalone", False):
            self.persist_standalone = True
        self.specs = list(specs)
        self.routers = [
            None if s == "local" else _DcnRouter(f"{tag}{i}n{node.id}")
            for i, s in enumerate(self.specs)
        ]
        self.n = next((r.n for r in self.routers if r is not None), 1)

    def _dests(self, i: int, b: DiffBatch) -> np.ndarray:
        raise NotImplementedError

    def process(self, t, inputs):
        local: list[list[DiffBatch]] = []
        for i, (spec, router, batches) in enumerate(
            zip(self.specs, self.routers, inputs)
        ):
            if spec == "local":
                local.append(list(batches))
                continue
            if spec == "bcast":
                nonempty = [b for b in batches if len(b)]
                parts = [list(nonempty) for _ in range(router.n)]
            elif spec == "p0":
                parts = [[] for _ in range(router.n)]
                parts[0] = [b for b in batches if len(b)]
            else:  # "key"
                parts = router.partition(
                    batches, lambda b, i=i: self._dests(i, b)
                )
            local.append(router.exchange(t, parts))
        if t <= self.replay_floor:
            return []
        return self.inner.process(t, local)

    def on_end(self):
        return self.inner.on_end()

    def state_dict(self):
        return {"inner": self.inner.state_dict()}

    def load_state(self, state):
        if state.get("inner"):
            self.inner.load_state(state["inner"])


def _rowkey_dests(b: DiffBatch, n: int) -> np.ndarray:
    return shard_of(np.asarray(b.keys, dtype=np.uint64), n)


class _OriginTracker:
    """row key -> feeding process, maintained by diffs: insert after full
    retraction re-homes the key, full retraction frees the entry (deferred
    to flush_dead so the retraction's own output row still routes home)."""

    def __init__(self):
        self.entries: dict[int, list] = {}  # key -> [origin_pid, count]

    def observe(self, src: int, batches: list[DiffBatch]) -> None:
        """numpy batch update keyed on ``np.unique`` of the batch keys
        (the per-row Python dict loop ran on every tick). Semantics
        match the old row-wise scan exactly: a key is re-homed to
        ``src`` iff some positive diff lands while the running count is
        <= 0 — for keys this batch creates, the first row already names
        ``src``, so only their total matters; for existing keys the
        revive test needs the within-key running sum, computed from one
        stable sort + cumsum."""
        entries = self.entries
        for b in batches:
            n = len(b)
            if n == 0:
                continue
            diffs = np.ascontiguousarray(b.diffs, dtype=np.int64)
            uniq, inv = np.unique(b.keys, return_inverse=True)
            totals = np.zeros(len(uniq), dtype=np.int64)
            np.add.at(totals, inv, diffs)
            c0 = np.empty(len(uniq), dtype=np.int64)
            ukeys = uniq.tolist()
            known = [entries.get(k) for k in ukeys]
            needs_scan = False
            for j, e in enumerate(known):
                c0[j] = e[1] if e is not None else 0
                needs_scan = needs_scan or e is not None
            if needs_scan:
                # within-key inclusive running sums in original row order
                order = np.argsort(inv, kind="stable")
                sd = diffs[order]
                si = inv[order]
                csum = np.cumsum(sd)
                starts = np.searchsorted(si, np.arange(len(uniq)))
                base = np.zeros(len(uniq), dtype=np.int64)
                base[1:] = csum[starts[1:] - 1]
                prefix_before = (csum - base[si]) - sd
                row_revive = (sd > 0) & ((c0[si] + prefix_before) <= 0)
                revived = np.zeros(len(uniq), dtype=bool)
                np.logical_or.at(revived, si[row_revive], True)
            for j, (k, e) in enumerate(zip(ukeys, known)):
                if e is None:
                    entries[k] = [src, int(totals[j])]
                else:
                    if revived[j]:
                        e[0] = src
                    e[1] += int(totals[j])

    def flush_dead(self) -> None:
        dead = [k for k, e in self.entries.items() if e[1] <= 0]
        for k in dead:
            del self.entries[k]

    def dests(self, b: DiffBatch, default: int) -> np.ndarray:
        """Per-unique-key dict lookups fanned back out through the
        ``np.unique`` inverse (was a per-row generator)."""
        n = len(b)
        if n == 0:
            return np.empty(0, dtype=np.int32)
        entries = self.entries
        uniq, inv = np.unique(b.keys, return_inverse=True)
        owners = np.empty(len(uniq), dtype=np.int32)
        for j, k in enumerate(uniq.tolist()):
            e = entries.get(k)
            owners[j] = e[0] if e is not None else default
        return owners[inv]

    def state_dict(self) -> dict:
        return {k: list(v) for k, v in self.entries.items()}

    def load_state(self, state: dict) -> None:
        self.entries = {int(k): list(v) for k, v in state.items()}


class DcnDeduplicateExec(_DcnStatefulExec):
    """Rows route by instance-key hash — the process owning an instance
    holds its accepted value (reference: deduplicate over Exchange,
    src/engine/dataflow.rs:3514). Output keys ARE instance hashes (a fresh
    universe), so results may stay on their owner."""

    def __init__(self, node):
        super().__init__(node, ["key"], "dd")
        self._inst_cols = list(node.instance_cols)

    def _dests(self, i, b):
        from pathway_tpu_torch.internals.api import ref_scalar

        cols = [b.columns[c] for c in self._inst_cols]
        ks = np.fromiter(
            (
                int(ref_scalar(*(col[r] for col in cols))) & _U64
                for r in range(len(b))
            ),
            dtype=np.uint64,
            count=len(b),
        )
        return shard_of(ks, self.n)


class _DcnReturnHomeExec(_InnerArrangedMixin, NodeExec):
    """Base for ops whose OUTPUT universe preserves input row keys while
    their state needs exchanged inputs: inputs route per `dest_for`, every
    arrival records its feeding process in an _OriginTracker, and output
    rows are exchanged BACK to that process so downstream aligned selects
    see whole rows (placement contract above)."""

    def __init__(self, node, tag: str):
        super().__init__(node)
        self.inner = node._make_local_exec()
        self.replay_floor = -1
        if getattr(self.inner, "persist_standalone", False):
            self.persist_standalone = True
        self.routers = [
            _DcnRouter(f"{tag}{i}n{node.id}") for i in range(len(node.inputs))
        ]
        self.back = _DcnRouter(f"{tag}bn{node.id}")
        self.n = self.routers[0].n
        self.origins = _OriginTracker()

    def dest_for(self, i: int, b: DiffBatch) -> np.ndarray:
        raise NotImplementedError

    def process(self, t, inputs):
        local: list[list[DiffBatch]] = []
        for i, (router, batches) in enumerate(zip(self.routers, inputs)):
            parts = router.partition(
                batches, lambda b, i=i: self.dest_for(i, b)
            )
            merged: list[DiffBatch] = []
            for src, bs in router.exchange_keep_src(t, parts):
                self.origins.observe(src, bs)
                merged.extend(bs)
            local.append(merged)
        out = (
            [] if t <= self.replay_floor else list(self.inner.process(t, local))
        )
        homed = self.back.exchange(
            t,
            self.back.partition(
                out, lambda b: self.origins.dests(b, self.back.pid)
            ),
        )
        self.origins.flush_dead()
        return homed

    def on_end(self):
        # runs after the lockstep cadence ends — no exchange possible; the
        # wrapped ops emit nothing new on flush
        return self.inner.on_end()

    # the wrapper's origin tracker is keyed state too: it rides in the
    # arranged residual (small — one entry per live row key fed from a
    # FOREIGN process, which upstream sharding keeps rare)
    def _wrapper_residual(self) -> dict:
        return {"origin": self.origins.state_dict()}

    def _load_wrapper_residual(self, extra: dict) -> None:
        self.origins.load_state(extra.get("origin", {}))

    def state_dict(self):
        return {
            "inner": self.inner.state_dict(),
            "origin": self.origins.state_dict(),
        }

    def load_state(self, state):
        if state.get("inner"):
            self.inner.load_state(state["inner"])
        self.origins.load_state(state.get("origin", {}))


class DcnSortExec(_DcnReturnHomeExec):
    """Each instance's sorted order lives wholly on the process owning the
    instance hash (reference: prev_next instance co-location,
    src/engine/dataflow/operators/prev_next.rs); an instance-less sort is
    one global order, centralized on process 0. prev/next rows return to
    the process each input row arrived from."""

    def __init__(self, node):
        super().__init__(node, "srt")

    def dest_for(self, i, b):
        if self.node.instance_col is None:
            return np.zeros(len(b), dtype=np.int32)
        from pathway_tpu_torch.internals.api import ref_scalar

        col = b.columns[self.node.instance_col]
        ks = np.fromiter(
            (int(ref_scalar(v)) & _U64 for v in col),
            dtype=np.uint64,
            count=len(b),
        )
        return shard_of(ks, self.n)


class DcnUpdateRowsExec(_DcnReturnHomeExec):
    """Both sides route by row key so the left/right rows of one key
    co-locate for the override decision; the merged row then returns to
    the process that fed the key (output keys are the UNION of the input
    key sets, so downstream aligned consumers need them home)."""

    def __init__(self, node):
        super().__init__(node, "ur")

    def dest_for(self, i, b):
        return _rowkey_dests(b, self.n)


class DcnUniverseSetOpExec(_DcnStatefulExec):
    """The left (universe-owning) side stays local; the other key sets
    replicate, so membership counting is process-local and output rows
    stay where their left row lives (placement contract above)."""

    def __init__(self, node):
        super().__init__(
            node, ["local"] + ["bcast"] * (len(node.inputs) - 1), "us"
        )


class DcnIxExec(_DcnStatefulExec):
    """The indexer (universe-owning) side stays local; the indexed table
    replicates on every process, so each lookup answers locally and the
    result row stays on its indexer row's process (placement contract
    above — the reference instead exchanges both sides and re-exchanges
    the result, operators.rs ix arrange+join)."""

    def __init__(self, node):
        super().__init__(node, ["local", "bcast"], "ix")


class DcnGradualBroadcastExec(_DcnStatefulExec):
    """Data rows stay local; the tiny (lower, value, upper) threshold table
    replicates everywhere so every process sweeps the same triplet
    (reference: gradual_broadcast's broadcasted apx counter,
    src/engine/dataflow/operators/gradual_broadcast.rs)."""

    def __init__(self, node):
        super().__init__(node, ["local", "bcast"], "gb")


class DcnExternalIndexExec(_DcnStatefulExec):
    """The index side replicates on every process (each holds the full
    corpus, device-mesh sharded locally); queries stay local and answer
    as-of-now against the replica (reference: external index operator,
    src/engine/dataflow/operators/external_index.rs)."""

    def __init__(self, node):
        super().__init__(node, ["bcast", "local"], "xi")


class DcnIterateExec(_DcnReturnHomeExec):
    """Fixpoint iteration centralizes on process 0: iterate bodies are
    arbitrary subgraphs whose per-depth runtimes cannot yet join the
    lockstep cadence, so inputs funnel to one process and the fixpoint
    runs there. Bodies commonly PRESERVE input keys, so result rows are
    exchanged back to each key's feeding process (keys the body invented
    stay on process 0). Correct, not scale-out — iterate-heavy jobs
    should shard by instance upstream."""

    def __init__(self, node):
        super().__init__(node, "it")

    def dest_for(self, i, b):
        return np.zeros(len(b), dtype=np.int32)


class DcnWatermarkExec(_InnerArrangedMixin, NodeExec):
    """Buffer/Forget/Freeze: per-row state needs no co-location (a row and
    its retraction always arrive on the same process), but the release
    watermark — max over the current-time column — is GLOBAL. Every tick
    the local watermark is all-gathered and the inner exec advanced to the
    group max, then re-released (reference: time_column.rs postpone/forget
    consult the broadcast frontier of the time column)."""

    def __init__(self, node):
        super().__init__(node)
        self.inner = node._make_local_exec()
        self.router = _DcnRouter(f"wm{node.id}")
        self.replay_floor = -1

    def _shards(self):
        inner = self.inner
        return inner.shards if hasattr(inner, "shards") else [inner]

    def process(self, t, inputs):
        out = [] if t <= self.replay_floor else list(
            self.inner.process(t, inputs)
        )
        local_wm = None
        for ex in self._shards():
            wm = ex.max_seen
            if wm is not None and (local_wm is None or wm > local_wm):
                local_wm = wm
        for wm in self.router.exchange_scalar(t, local_wm):
            if wm is not None and (local_wm is None or wm > local_wm):
                local_wm = wm
        advanced = False
        for ex in self._shards():
            if local_wm is not None and (
                ex.max_seen is None or local_wm > ex.max_seen
            ):
                ex.max_seen = local_wm
                advanced = True
        if advanced and t > self.replay_floor:
            # an empty process() re-runs the release scan under the
            # advanced watermark (Freeze has no release scan: no-op)
            out.extend(self.inner.process(t, [[]]))
        return out

    def on_end(self):
        return self.inner.on_end()

    def state_dict(self):
        return {"inner": self.inner.state_dict()}

    def load_state(self, state):
        if state.get("inner"):
            self.inner.load_state(state["inner"])
