"""Own copy of ``pathway_tpu/analysis/rules.py`` over the port's engine.

Built-in Graph Doctor rules + the extensible registry.

A rule is a function `(facts: GraphFacts) -> Iterable[Diagnostic]`
registered under a stable id. Third-party packages (or user conftest
code) add rules with::

    from pathway_tpu_torch.analysis import rule

    @rule("my-rule")
    def check_my_invariant(facts):
        for node in facts.order:
            ...
            yield Diagnostic("my-rule", Severity.WARNING, "...", node)

Rule ids double as the suppression handles:
``pw.analysis.suppress(table, "unbounded-state")``.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Iterable

from pathway_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from pathway_tpu_torch.analysis.graph_facts import GraphFacts
from pathway_tpu_torch.engine.nodes import (
    ConcatNode,
    DeduplicateNode,
    GroupByNode,
    InputNode,
    JoinNode,
    Node,
    OutputNode,
    RowwiseNode,
    UniverseSetOpNode,
)
from pathway_tpu_torch.engine.temporal_nodes import (
    AsofJoinNode,
    AsofNowJoinNode,
    IntervalJoinNode,
)
from pathway_tpu_torch.internals.expression import iter_apply_expressions

RuleFn = Callable[[GraphFacts], Iterable[Diagnostic]]

RULES: dict[str, RuleFn] = {}


def rule(rule_id: str) -> Callable[[RuleFn], RuleFn]:
    """Register a Graph Doctor rule under `rule_id` (replacing any
    previous registration of the same id)."""

    def deco(fn: RuleFn) -> RuleFn:
        RULES[rule_id] = fn
        return fn

    return deco


# ---------------------------------------------------------------------------
# 1. dead nodes / dead columns


@rule("dead-node")
def dead_nodes(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Declared nodes whose results can never reach any registered
    output — built but silently discarded work."""
    if not facts.outputs:
        return  # nothing registered yet: reachability is undefined
    for node in facts.order:
        if node.id in facts.reachable or isinstance(node, OutputNode):
            continue
        # flag only the FRONTIER: dead nodes none of whose consumers are
        # also dead (the deepest dead table) — one diagnostic per dead
        # chain instead of one per node
        if any(
            c.id not in facts.reachable for c in facts.consumers[node.id]
        ):
            continue
        if node.column_names and all(
            c.startswith("_") for c in node.column_names
        ):
            continue  # library scaffolding (probe/prep tables), not user work
        kind = "source" if isinstance(node, InputNode) else "table"
        yield Diagnostic(
            "dead-node",
            Severity.WARNING,
            f"this {kind} never reaches any output; it is built but its "
            "rows are discarded",
            node,
            fix_hint="write/subscribe it, feed it into a consumed table, "
            "or delete the declaration",
        )


@rule("dead-column")
def dead_columns(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Computed columns no downstream consumer ever reads."""
    from pathway_tpu_torch.engine.expression_eval import InternalColRef

    for node in facts.order:
        if not isinstance(node, RowwiseNode):
            continue
        if node.id not in facts.reachable or not facts.consumers[node.id]:
            continue  # dead-node territory / externally captured
        live = facts.live_columns.get(node.id)
        if live is None:
            continue
        for name in node.column_names:
            if name in live or name.startswith("_"):
                continue  # "_"-prefixed: engine-internal prep columns
            if isinstance(node.exprs.get(name), InternalColRef):
                continue  # zero-cost passthrough, not computed work
            yield Diagnostic(
                "dead-column",
                Severity.INFO,
                f"column {name!r} is computed but never read by any "
                "consumer on the way to an output",
                node,
                fix_hint=f"drop {name!r} from the select/with_columns, or "
                "consume it downstream",
                data={"column": name},
            )


# ---------------------------------------------------------------------------
# 2. unbounded state

_STATEFUL_JOINS = (JoinNode, IntervalJoinNode, AsofJoinNode, AsofNowJoinNode)


@rule("unbounded-state")
def unbounded_state(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Stateful operators fed by a streaming source with no temporal
    guard (Forget/Buffer/Freeze from `behavior=`) on the path and no
    instance cap: their keyed state grows without bound for the lifetime
    of the run."""
    for node in facts.order:
        if not getattr(node, "is_stateful", False):
            continue
        if not facts.has_unguarded_streaming_input(node):
            continue
        if isinstance(node, GroupByNode):
            if getattr(node, "_windowed", False):
                yield Diagnostic(
                    "unbounded-state",
                    Severity.INFO,
                    "windowed aggregation over a streaming source without "
                    "a temporal behavior: state grows with the number of "
                    "open windows",
                    node,
                    fix_hint="pass behavior=pw.temporal.common_behavior("
                    "cutoff=...) (or exactly_once_behavior) to windowby "
                    "so closed windows free their state",
                )
            else:
                yield Diagnostic(
                    "unbounded-state",
                    Severity.WARNING,
                    "groupby over a streaming source holds one aggregate "
                    "per distinct key forever: state grows without bound",
                    node,
                    fix_hint="aggregate inside windowby(...) with a "
                    "temporal behavior, or bound the input with "
                    "a Forget (pw.temporal) before grouping",
                )
        elif isinstance(node, _STATEFUL_JOINS):
            yield Diagnostic(
                "unbounded-state",
                Severity.WARNING,
                f"{type(node).__name__.removesuffix('Node')} over a "
                "streaming source retains every row of both sides "
                "forever: state grows without bound",
                node,
                fix_hint="use asof_now semantics for query streams, add a "
                "temporal behavior, or bound the inputs with a window",
            )
        elif isinstance(node, DeduplicateNode):
            if node.instance_cols:
                yield Diagnostic(
                    "unbounded-state",
                    Severity.WARNING,
                    "deduplicate over a streaming source keeps one entry "
                    "per distinct instance: state grows with instance "
                    "cardinality",
                    node,
                    fix_hint="drop instance= for a single bounded slot, "
                    "pick a low-cardinality instance, or bound the input "
                    "temporally",
                )
        # other stateful nodes (sort, ix, aligned select, ...) also grow,
        # but proportionally to the LIVE key set, which retractions bound;
        # flagging them would be noise


# ---------------------------------------------------------------------------
# 3. universe safety


def _rel(a, b) -> str:
    if a is None or b is None:
        return "unknown"
    if a is b:
        return "equal"
    if a.is_subset_of(b) or b.is_subset_of(a):
        return "subset"
    if a.is_disjoint_from(b):
        return "disjoint"
    return "unrelated"


@rule("universe-safety")
def universe_safety(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Re-checks the key-set relations row-aligned operators depend on,
    surfaced as diagnostics with declaration-site tracebacks instead of
    the bare build/runtime exceptions."""
    for node in facts.order:
        if isinstance(node, RowwiseNode) and len(node.inputs) > 1:
            primary = getattr(node.inputs[0], "_universe", None)
            for other in node.inputs[1:]:
                r = _rel(primary, getattr(other, "_universe", None))
                if r == "equal":
                    continue
                if r == "subset":
                    yield Diagnostic(
                        "universe-safety",
                        Severity.INFO,
                        "row-aligned expression mixes tables related only "
                        "by a subset promise; missing keys surface at run "
                        "time",
                        node,
                        fix_hint="verify the promise "
                        "(promise_is_subset_of / with_universe_of) holds "
                        "for every input, or join explicitly",
                    )
                else:
                    yield Diagnostic(
                        "universe-safety",
                        Severity.ERROR,
                        "row-aligned expression mixes tables over "
                        f"{r} universes: rows cannot be matched by key",
                        node,
                        fix_hint="use with_universe_of / "
                        "pw.universes.promise_is_subset_of to assert how "
                        "the key sets relate, or join the tables instead",
                    )
        elif isinstance(node, UniverseSetOpNode) and node.mode == "restrict":
            if getattr(node, "_intentional_restrict", False):
                continue  # having(): dropping missing keys IS the point
            primary = getattr(node.inputs[0], "_universe", None)
            for other in node.inputs[1:]:
                r = _rel(primary, getattr(other, "_universe", None))
                if r in ("equal", "subset"):
                    continue
                yield Diagnostic(
                    "universe-safety",
                    Severity.WARNING,
                    "with_universe_of/restrict over universes with no "
                    "declared relation: rows missing from the target key "
                    "set silently drop",
                    node,
                    fix_hint="promise the subset relation explicitly "
                    "(pw.universes.promise_is_subset_of) so the intent "
                    "is checked",
                )
        elif isinstance(node, ConcatNode):
            for i, a in enumerate(node.inputs):
                ua = getattr(a, "_universe", None)
                for b in node.inputs[i + 1:]:
                    r = _rel(ua, getattr(b, "_universe", None))
                    if r == "disjoint":
                        yield Diagnostic(
                            "universe-safety",
                            Severity.INFO,
                            "concat relies on a pairwise-disjointness "
                            "PROMISE; a key collision would only surface "
                            "at run time",
                            node,
                            fix_hint="use concat_reindex to rehash ids "
                            "if disjointness is not structurally "
                            "guaranteed",
                        )
                    elif r == "unrelated":
                        yield Diagnostic(
                            "universe-safety",
                            Severity.ERROR,
                            "concat over universes that are not promised "
                            "disjoint: duplicate keys would collide",
                            node,
                            fix_hint="call pw.universes."
                            "promise_are_pairwise_disjoint first, or use "
                            "concat_reindex",
                        )


# ---------------------------------------------------------------------------
# 4. shard safety (the parallel/ layer)

_ORDER_DEPENDENT_REDUCERS = {
    "stateful": Severity.WARNING,  # arbitrary combine fn: not provably
    # commutative/associative — cross-shard merge order is unspecified
    "earliest": Severity.INFO,  # tie order at equal times is
    "latest": Severity.INFO,  # arrival-dependent across shards
}


@rule("shard-exchange")
def shard_exchange(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Operators whose key columns force a row exchange when the engine
    runs sharded (PATHWAY_ENGINE_SHARDS / multi-process DCN)."""
    for node in facts.order:
        fx = facts.exchange_edges.get(node.id)
        if not fx:
            continue
        edges = [
            (
                label,
                [
                    facts.input_column_label(node, k, side)
                    for k in keys
                ],
            )
            for side, (label, keys) in enumerate(fx)
        ]
        desc = "; ".join(
            f"{label} routed by ({', '.join(keys) or 'id'})"
            for label, keys in edges
        )
        yield Diagnostic(
            "shard-exchange",
            Severity.INFO,
            f"forces a row exchange under sharding: {desc}",
            node,
            data={"edges": [keys for _l, keys in edges]},
        )


@rule("shard-nondeterminism")
def shard_nondeterminism(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Non-deterministic UDFs whose values cross an exchange boundary:
    re-evaluation on retraction/replay may produce different values on
    different shards, breaking cross-replica consistency (the EQuARX
    concern applied to the dataflow layer)."""
    # nodes downstream of which an exchange occurs
    exchanging = set(facts.exchange_edges)
    feeds_exchange: dict[int, bool] = {}
    for node in reversed(facts.order):
        feeds_exchange[node.id] = node.id in exchanging or any(
            feeds_exchange.get(c.id, False)
            for c in facts.consumers[node.id]
        )
    for node in facts.order:
        if not isinstance(node, RowwiseNode):
            continue
        if not feeds_exchange.get(node.id, False):
            continue
        bad = []
        for name, e in node.exprs.items():
            for a in iter_apply_expressions(e):
                if a._deterministic is False:
                    bad.append(
                        getattr(a, "_udf_name", None) or f"column {name!r}"
                    )
        for label in dict.fromkeys(bad):
            yield Diagnostic(
                "shard-nondeterminism",
                Severity.WARNING,
                f"non-deterministic UDF {label} feeds an exchange "
                "boundary: retraction replay may route or value rows "
                "differently across shards",
                node,
                fix_hint="declare the UDF deterministic=True if it is, "
                "or materialize its result before the exchange (e.g. via "
                "a connector) so every shard sees one value",
            )


@rule("shard-reducer")
def shard_reducer(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Reducers that are not commutative/associative merge-safe when a
    groupby runs sharded."""
    for node in facts.order:
        if not isinstance(node, GroupByNode):
            continue
        for out_col, spec in node.reducer_specs.items():
            sev = _ORDER_DEPENDENT_REDUCERS.get(spec.kind)
            if sev is None:
                # tuple/ndarray without an explicit sort key depend on
                # arrival order per group
                if spec.kind in ("tuple", "ndarray") and not node.sort_by:
                    sev = Severity.INFO
                else:
                    continue
            label = facts.output_column_label(node, out_col)
            yield Diagnostic(
                "shard-reducer",
                sev,
                f"reducer {spec.kind!r} (column {label!r}) is "
                "order-dependent: under sharding its result depends on "
                "per-shard arrival order",
                node,
                fix_hint="use a commutative reducer (sum/count/min/max), "
                "add sort_by= to fix the order, or accept "
                "run-to-run variation",
                data={"reducer": spec.kind, "column": label},
            )


# ---------------------------------------------------------------------------
# 5. serving admission


@rule("serving-admission")
def serving_admission(facts: GraphFacts) -> Iterable[Diagnostic]:
    """REST ingress with no Surge Gate: every HTTP request drops
    straight into the InputSession, so overload manifests as unbounded
    queueing (and unbounded memory) instead of explicit shedding."""
    for node in facts.order:
        if not isinstance(node, InputNode):
            continue
        subject = getattr(getattr(node, "source", None), "subject", None)
        # type-name check: the http module (aiohttp) need not be loaded
        # for graphs that don't use it
        if subject is None or type(subject).__name__ != "RestServerSubject":
            continue
        if getattr(subject, "_qos", None) is not None:
            continue
        yield Diagnostic(
            "serving-admission",
            Severity.WARNING,
            "rest_connector ingress has no admission bound: under "
            "overload, requests queue without limit instead of shedding "
            "with 429/Retry-After, and nothing batches or expires them",
            node,
            fix_hint="pass qos=pathway_tpu_torch.serving.QoSConfig(...) to "
            "rest_connector / run_server (or set "
            "PATHWAY_SERVING_ENABLED=1) to put the endpoint behind the "
            "Surge Gate",
        )


# ---------------------------------------------------------------------------
# 5a. replicated serving (Replica Shield)


@rule("unreplicated-serving")
def unreplicated_serving(facts: GraphFacts) -> Iterable[Diagnostic]:
    """A gated REST ingress serving an external index with NO stale
    read path and NO replica set: during any recovery window (peer
    failure, restore replay, supervised restart) every read hard-503s
    for the whole window — the Surge Gate can shed politely, but
    nothing can answer.  The stale responder or a Replica Shield
    replica set (serving/replica.py + serving/router.py) each close the
    gap; INFO when replicas exist but nothing bounds staleness, so a
    partitioned writer silently serves ever-older data.  Shard Harbor
    facets: WARNING when a replicated plane has no standby writer
    (PATHWAY_REPL_STANDBY — the single ingest writer is an SPOF), INFO
    when the shard layout leaves some key range with a single owner."""
    import os

    from pathway_tpu_torch.engine.index_node import ExternalIndexNode

    index_nodes = [
        n for n in facts.order if isinstance(n, ExternalIndexNode)
    ]
    if not index_nodes:
        return
    replicas = [
        u
        for u in os.environ.get("PATHWAY_SERVING_REPLICAS", "").split(",")
        if u.strip()
    ]
    # a Shard Harbor plane may be configured ONLY via the shard map —
    # its members ARE the replica set.  Reuse the router's parser (the
    # single source of truth); a torn map is the router's boot error,
    # not this rule's concern, so fall back to the count heuristics.
    from pathway_tpu_torch.serving.router import shard_map_from_env

    try:
        shard_map = shard_map_from_env()
    except ValueError:
        shard_map = None
    if shard_map:
        replicas = replicas + [u for part in shard_map for u in part]
    from pathway_tpu_torch.serving import degrade

    first_gated = None
    for node in facts.order:
        if not isinstance(node, InputNode):
            continue
        subject = getattr(getattr(node, "source", None), "subject", None)
        if subject is None or type(subject).__name__ != "RestServerSubject":
            continue
        if getattr(subject, "_qos", None) is None:
            continue  # ungated ingress is serving-admission's finding
        route = getattr(subject, "_route", "/")
        if not replicas and degrade.stale_responder(route) is None:
            yield Diagnostic(
                "unreplicated-serving",
                Severity.WARNING,
                f"gated REST ingress {route!r} serves an external index "
                "with no stale responder registered and no replica set "
                "configured: every read hard-503s for the entire "
                "recovery window (restore replay, peer failure, "
                "supervised restart)",
                node,
                fix_hint="register a degraded answer path with "
                "pathway_tpu_torch.serving.degrade.register_stale_responder("
                f"{route!r}, fn), or configure read replicas "
                "(PATHWAY_SERVING_REPLICAS + serving/replica.py) behind "
                "the failover router",
                data={"route": route, "index_nodes": len(index_nodes)},
            )
        elif replicas:
            if not os.environ.get("PATHWAY_SERVING_MAX_STALENESS_MS", ""):
                yield Diagnostic(
                    "unreplicated-serving",
                    Severity.INFO,
                    f"REST ingress {route!r} has {len(replicas)} "
                    "replica(s) configured but max-staleness is "
                    "unbounded: a partitioned or dead writer keeps "
                    "serving ever-older answers with no shed point",
                    node,
                    fix_hint="set PATHWAY_SERVING_MAX_STALENESS_MS (or "
                    "have clients send x-pathway-max-staleness-ms) so "
                    "reads past the freshness bound shed explicitly "
                    "with 503 + Retry-After",
                    data={"route": route, "replicas": len(replicas)},
                )
            if not os.environ.get("PATHWAY_REPL_STANDBY", ""):
                yield Diagnostic(
                    "unreplicated-serving",
                    Severity.WARNING,
                    f"REST ingress {route!r} has a replicated read "
                    "plane but NO standby writer configured: the "
                    "single ingest writer is the last serving SPOF — "
                    "kill it and every replica serves permanently "
                    "stale data with nothing publishing deltas, "
                    "snapshotting, or ingesting",
                    node,
                    fix_hint="run a standby writer (python -m "
                    "pathway_tpu_torch.parallel.standby -- <writer argv>) "
                    "and point replicas at its takeover endpoint via "
                    "PATHWAY_REPL_STANDBY=host:port",
                    data={"route": route, "replicas": len(replicas)},
                )
        if first_gated is None:
            first_gated = node
    # Shard Harbor: a shard whose key range has ONE owner turns any
    # single member death into a partial-corpus outage (bounded reads
    # shed 503 for that key range until it recovers).  One plane-level
    # finding, anchored at the first gated ingress.
    if first_gated is None:
        return
    if shard_map:
        # the map names exact ownership: per-shard claims are precise
        single_owner = [
            s for s, part in enumerate(shard_map) if len(part) == 1
        ]
        if single_owner:
            yield Diagnostic(
                "unreplicated-serving",
                Severity.INFO,
                f"shard(s) {single_owner} of the serving plane have a "
                "single owner: one member death makes that key range "
                "unavailable (bounded reads shed 503 naming the "
                "shard) until the supervisor restarts it",
                first_gated,
                fix_hint="give every shard at least two members in "
                "PATHWAY_SERVING_SHARD_MAP",
                data={"single_owner_shards": single_owner},
            )
    else:
        try:
            n_shards = int(
                os.environ.get("PATHWAY_SERVING_SHARDS", "1") or 1
            )
        except ValueError:
            n_shards = 1
        # count-only pigeonhole: fewer than 2 members per shard on
        # average guarantees SOME shard has a single owner — which one
        # depends on the layout only the shard map can name
        if n_shards > 1 and replicas and len(replicas) < 2 * n_shards:
            yield Diagnostic(
                "unreplicated-serving",
                Severity.INFO,
                f"{len(replicas)} replica(s) over "
                f"PATHWAY_SERVING_SHARDS={n_shards} leaves at least "
                "one shard with a single owner (which one depends on "
                "the layout): one member death makes that key range "
                "unavailable (bounded reads shed 503 naming the "
                "shard) until the supervisor restarts it",
                first_gated,
                fix_hint="raise the replica count to at least "
                f"{2 * n_shards} (2 per shard), or declare exact "
                "ownership via PATHWAY_SERVING_SHARD_MAP for a "
                "per-shard diagnosis",
                data={"shards": n_shards, "replicas": len(replicas)},
            )


# ---------------------------------------------------------------------------
# 5c. tenant fairness (Tenant Weave)


@rule("tenant-fairness")
def tenant_fairness(facts: GraphFacts) -> Iterable[Diagnostic]:
    """A replicated serving plane with tenant-blind admission: the
    Surge Gate bounds TOTAL load, but one hot tenant can fill the
    admission queue (and drain the endpoint token bucket) so the shed
    lands on whoever arrives next — usually a tail tenant that sent one
    request all day.  WARNING when a gated REST ingress fronts a
    replicated plane without per-tenant fair admission
    (``PATHWAY_TENANT_QOS``); INFO when the router's result cache is
    armed without a delta-stream invalidation source, because a
    TTL-only cache can serve answers up to a full TTL staler than the
    corpus (time-based staleness only)."""
    import os

    from pathway_tpu_torch.serving.result_cache import cache_enabled_via_env
    from pathway_tpu_torch.serving.router import shard_map_from_env
    from pathway_tpu_torch.serving.tenancy import tenancy_enabled_via_env

    replicas = [
        u
        for u in os.environ.get("PATHWAY_SERVING_REPLICAS", "").split(",")
        if u.strip()
    ]
    try:
        shard_map = shard_map_from_env()
    except ValueError:
        shard_map = None
    replicated = bool(
        replicas or shard_map or os.environ.get("PATHWAY_REPL_PORT", "")
    )
    first_gated = None
    for node in facts.order:
        if not isinstance(node, InputNode):
            continue
        subject = getattr(getattr(node, "source", None), "subject", None)
        if subject is None or type(subject).__name__ != "RestServerSubject":
            continue
        if getattr(subject, "_qos", None) is None:
            continue  # ungated ingress is serving-admission's finding
        if first_gated is None:
            first_gated = node
        route = getattr(subject, "_route", "/")
        if replicated and not tenancy_enabled_via_env():
            yield Diagnostic(
                "tenant-fairness",
                Severity.WARNING,
                f"gated REST ingress {route!r} on a replicated serving "
                "plane has tenant-blind admission: one hot tenant can "
                "fill the admission queue and the shed lands on the "
                "queue tail, starving every other tenant",
                node,
                fix_hint="set PATHWAY_TENANT_QOS=1 (per-tenant "
                "fair-share buckets + weighted-fair EDF ordering, "
                "identity from the x-pathway-tenant header; weight "
                "classes via PATHWAY_TENANT_WEIGHTS)",
                data={"route": route, "replicas": len(replicas)},
            )
    if first_gated is None:
        return
    if cache_enabled_via_env() and not os.environ.get(
        "PATHWAY_ROUTER_CACHE_WRITER", ""
    ):
        yield Diagnostic(
            "tenant-fairness",
            Severity.INFO,
            "the router result cache is enabled "
            "(PATHWAY_ROUTER_CACHE=1) without a delta-stream "
            "invalidation source: entries expire by TTL only "
            "(PATHWAY_ROUTER_CACHE_TTL_MS), so a hit can be up to a "
            "full TTL staler than the corpus instead of provably "
            "current as of the stream's applied tick",
            first_gated,
            fix_hint="point PATHWAY_ROUTER_CACHE_WRITER=host:port at "
            "the writer's delta endpoint (PATHWAY_REPL_PORT) so each "
            "tick's changed keys evict exactly the affected entries",
        )


# ---------------------------------------------------------------------------
# 5d. generation serving (Token Loom)


@rule("generation-serving")
def generation_serving(facts: GraphFacts) -> Iterable[Diagnostic]:
    """A ``/generate`` route without a deadline bound or admission gate
    is unbounded DEVICE MEMORY, not just unbounded queueing: every
    admitted generation pins KV pages for its whole decode, so nothing
    ever reclaims them without deadline propagation, and an ungated
    ingress lets a burst exhaust the page pool for everyone.  WARNING
    on either; INFO when the KV page-pool size runs on the default —
    the pool IS the generation plane's memory budget and deserves an
    explicit statement (``PATHWAY_GENERATE_PAGES``)."""
    import os

    from pathway_tpu_torch.generate.scheduler import (
        DEFAULT_PAGES,
        generate_enabled_via_env,
    )

    # graph-declared generate ingress: a rest_connector route named
    # like /generate feeding the engine
    gen_nodes = []
    for node in facts.order:
        if not isinstance(node, InputNode):
            continue
        subject = getattr(getattr(node, "source", None), "subject", None)
        if subject is None or type(subject).__name__ != "RestServerSubject":
            continue
        route = getattr(subject, "_route", "/") or "/"
        if "generate" not in str(route):
            continue
        gen_nodes.append((node, route, getattr(subject, "_qos", None)))
    # env-armed generation plane (serving/replica.py role):
    # PATHWAY_GENERATE=1 mounts /generate on the replica
    env_armed = generate_enabled_via_env()
    if not gen_nodes and not env_armed:
        return
    for node, route, qos in gen_nodes:
        if qos is None:
            yield Diagnostic(
                "generation-serving",
                Severity.WARNING,
                f"generate ingress {route!r} has no admission gate: "
                "every request starts a decode that pins KV pages "
                "until completion — an unbounded burst exhausts the "
                "page pool (device memory), not just the queue",
                node,
                fix_hint="pass qos=pathway_tpu_torch.serving.QoSConfig(...) "
                "(or set PATHWAY_SERVING_ENABLED=1) so generations "
                "shed explicitly before touching the device",
                data={"route": route},
            )
    anchor = gen_nodes[0][0] if gen_nodes else None
    if env_armed or gen_nodes:
        deadline_bounded = bool(
            os.environ.get("PATHWAY_SERVING_DEADLINE_MS", "")
            or os.environ.get("PATHWAY_SERVING_MAX_DEADLINE_MS", "")
        )
        if not deadline_bounded:
            yield Diagnostic(
                "generation-serving",
                Severity.WARNING,
                "generation serving has no configured deadline bound: "
                "deadline propagation is what drops expired "
                "generations MID-decode and reclaims their KV pages — "
                "unbounded decode is unbounded device memory",
                anchor,
                fix_hint="set PATHWAY_SERVING_DEADLINE_MS (the default "
                "budget applied when x-pathway-deadline-ms is absent) "
                "and/or PATHWAY_SERVING_MAX_DEADLINE_MS (the clamp on "
                "client budgets) for the generate route",
            )
        if not os.environ.get("PATHWAY_GENERATE_PAGES", ""):
            yield Diagnostic(
                "generation-serving",
                Severity.INFO,
                "the KV page pool is running on its default size "
                f"({DEFAULT_PAGES} pages): the pool is the generation "
                "plane's device-memory budget — size it explicitly "
                "for the expected concurrent sequences x "
                "(prompt+max_tokens)/page_size",
                anchor,
                fix_hint="set PATHWAY_GENERATE_PAGES (and "
                "PATHWAY_GENERATE_PAGE_SIZE) to the planned budget",
            )


# ---------------------------------------------------------------------------
# 5b. recoverability (Phoenix Mesh)


@rule("unrecoverable-state")
def unrecoverable_state(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Stateful nodes whose snapshots cannot participate in group
    recovery: a node fed (transitively) by BOTH a transient fixture and
    a persisted connector disables operator snapshots for the whole
    graph (persistence/_runtime_glue.py mixed-dependency guard), so a
    kill/restart must replay the FULL input log — recovery time grows
    with history instead of churn, and the Phoenix Mesh supervisor's
    restart budget buys much less."""
    tainted: set[int] = set()
    logged: set[int] = set()
    for node in facts.order:
        if isinstance(node, InputNode):
            if getattr(node.source, "transient", False):
                tainted.add(node.id)
            else:
                logged.add(node.id)
            continue
        if any(inp.id in tainted for inp in node.inputs):
            tainted.add(node.id)
        if any(inp.id in logged for inp in node.inputs):
            logged.add(node.id)
    for node in facts.order:
        if not getattr(node, "is_stateful", False):
            continue
        if node.id in tainted and node.id in logged:
            yield Diagnostic(
                "unrecoverable-state",
                Severity.INFO,
                "this stateful node mixes transient fixture input with a "
                "persisted connector: operator snapshots are disabled for "
                "the whole graph, so group recovery (Phoenix Mesh "
                "supervisor restart) replays the full input log instead "
                "of restoring the latest committed snapshot generation",
                node,
                fix_hint="feed the node from persisted connectors only, "
                "or give the fixture a persistent source (pw.io.*) so "
                "snapshots stay enabled",
            )


# ---------------------------------------------------------------------------
# 5c. elastic resharding (Shard Flux)


@rule("elastic-resharding")
def elastic_resharding(facts: GraphFacts) -> Iterable[Diagnostic]:
    """A supervised multi-rank group can resize N→M ranks with zero
    replay ONLY when every stateful exec snapshots as arrangements
    (``arranged_state`` — the segment-handoff substrate
    elastic/mesh.py re-partitions by jk).  Any stateful exec still on
    the monolithic-pickle path (e.g. the temporal_nodes interval/asof
    monoliths) pins the WHOLE group's resize to the log-replay
    fallback: its keyed state cannot be split by key range, so
    ``GroupSupervisor.resize`` carries it forward un-moved and a grown
    rank rebuilds it from the log.  WARNING once on the group, INFO
    naming each pinning exec."""
    from pathway_tpu_torch.elastic.planner import reshard_capable
    from pathway_tpu_torch.parallel import exchange_topology

    topo = exchange_topology()
    if topo["dcn_processes"] <= 1:
        return  # single-rank: nothing to resize live
    pinned = [
        node
        for node in facts.order
        if getattr(node, "is_stateful", False)
        and reshard_capable(node) is False
    ]
    if not pinned:
        return
    yield Diagnostic(
        "elastic-resharding",
        Severity.WARNING,
        f"this {topo['dcn_processes']}-rank group holds state that "
        f"cannot ride a key-range segment handoff: {len(pinned)} "
        "stateful exec(s) snapshot monolithically, so a live resize "
        "(GroupSupervisor.resize / elastic.mesh.reshard_stores) "
        "falls back to log replay for them — resize pause grows with "
        "history instead of moved key ranges",
        pinned[0],
        fix_hint="rebase the named execs onto arrangement-backed "
        "snapshots (arranged_state), or accept log-replay resizes "
        "for this graph",
    )
    for node in pinned:
        yield Diagnostic(
            "elastic-resharding",
            Severity.INFO,
            f"{type(node).__name__} snapshots monolithically (no "
            "arranged_state): its keyed state cannot be split by key "
            "range during an elastic resize",
            node,
        )


# ---------------------------------------------------------------------------
# 6. join vectorization

_ROWWISE_JOINS = (IntervalJoinNode, AsofJoinNode, AsofNowJoinNode)


@rule("join-vectorization")
def join_vectorization(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Joins whose declared mode statically forces the rowwise path.
    Equijoins run on the columnar arrangement (delta-join) engine —
    roughly an order of magnitude faster per steady-state tick — unless
    PATHWAY_JOIN_ROWWISE pins them to the dict oracle; temporal joins
    (interval/asof/asof_now) have no vectorized path yet."""
    import os

    rowwise_forced = os.environ.get("PATHWAY_JOIN_ROWWISE", "") not in (
        "",
        "0",
    )
    for node in facts.order:
        if isinstance(node, JoinNode) and rowwise_forced:
            yield Diagnostic(
                "join-vectorization",
                Severity.WARNING,
                "PATHWAY_JOIN_ROWWISE=1 pins this join to the rowwise "
                "dict oracle: every steady-state tick loops per row in "
                "Python instead of probing the columnar arrangement "
                "(~5-10x slower)",
                node,
                fix_hint="unset PATHWAY_JOIN_ROWWISE (the oracle path "
                "exists for differential testing, not serving)",
            )
        elif isinstance(node, _ROWWISE_JOINS):
            yield Diagnostic(
                "join-vectorization",
                Severity.INFO,
                f"{type(node).__name__} always runs the rowwise "
                "touched-group path — its match rules (interval/asof "
                "bounds) have no columnar delta-join implementation yet; "
                "expect per-row Python cost on every tick",
                node,
                fix_hint="for equality-only match conditions prefer a "
                "plain join, which runs on the arrangement engine",
            )


# ---------------------------------------------------------------------------
# 7. graph stats

_STATE_ESTIMATES = {
    "GroupByNode": "O(distinct groups x reducer state)",
    "JoinNode": "O(left rows + right rows)",
    "UpdateRowsNode": "O(rows of both sides)",
    "SortNode": "O(live rows)",
    "DeduplicateNode": "O(distinct instances)",
    "IxNode": "O(rows of both sides)",
    "UniverseSetOpNode": "O(live rows)",
    "GradualBroadcastNode": "O(live rows)",
    "BufferNode": "O(rows held before the watermark)",
    "ForgetNode": "O(rows inside the retention window)",
    "RowwiseNode": "O(live rows x inputs)",
    "IntervalJoinNode": "O(rows inside the interval bounds)",
    "AsofJoinNode": "O(live rows of both sides)",
    "AsofNowJoinNode": "O(right rows + emitted matches)",
    "SessionAssignNode": "O(live rows per instance)",
}


def _compile_member(node: Node) -> bool:
    from pathway_tpu_torch.engine.compile import classify_node

    try:
        return classify_node(node)[0]
    except Exception:
        return False


@rule("compile-boundary")
def compile_boundary(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Tick Forge visibility: every exec that FORCES a stateless chain
    back to the per-operator interpreter — a node adjacent (producer or
    consumer) to compilable operators that is itself not lowerable — is
    named with its reason (object-valued expression, UDF, stateful
    state, ...), so a user wondering why /debug/graph shows a segment
    boundary can see the exact expression/operator that drew it.  INFO
    severity: boundaries are normal; the diagnostic is a map, not a
    complaint."""
    from pathway_tpu_torch.engine.compile import classify_node

    for node in facts.order:
        try:
            ok, reason = classify_node(node)
        except Exception:
            continue
        if ok or reason == "__io__":
            continue
        # only boundaries that actually cut a chain are interesting:
        # the node must touch at least one compilable neighbor
        if not (
            any(_compile_member(i) for i in node.inputs)
            or any(
                _compile_member(c) for c in facts.consumers.get(node.id, [])
            )
        ):
            continue
        yield Diagnostic(
            "compile-boundary",
            Severity.INFO,
            f"compiled-tick chain boundary: this operator runs on the "
            f"interpreter ({reason}); the adjacent stateless chain is "
            f"fused up to here",
            node,
        )


# ---------------------------------------------------------------------------
# 8. observability coverage (Fleet Lens)


@rule("observability-coverage")
def observability_coverage(facts: GraphFacts) -> Iterable[Diagnostic]:
    """A replicated or sharded plane nobody can see: takeovers, ejections
    and reshards leave no record, and the first debugging tool arrives
    AFTER the incident.  WARNING when a replicated/sharded serving plane
    runs in this process with no monitoring server armed (no /metrics,
    /debug/signals, /debug/events, /fleet/* — and no signal sampler or
    crash hooks, which arming installs) or with tracing disabled (the
    stitched /fleet/trace view cannot cross this member); INFO when the
    signal sampler runs but no ``PATHWAY_SLO_*`` target is declared —
    burn rates have nothing to burn against."""
    import os

    from pathway_tpu_torch.internals import monitoring_server
    from pathway_tpu_torch.observability.signals import (
        get_sampler,
        signals_enabled,
        slo_targets,
    )
    from pathway_tpu_torch.observability.tracing import get_tracer
    from pathway_tpu_torch.serving.router import shard_map_from_env

    replicas = [
        u
        for u in os.environ.get("PATHWAY_SERVING_REPLICAS", "").split(",")
        if u.strip()
    ]
    try:
        shard_map = shard_map_from_env()
    except ValueError:
        shard_map = None
    replicated = bool(
        replicas or shard_map or os.environ.get("PATHWAY_REPL_PORT", "")
    )
    if replicated:
        with monitoring_server._servers_lock:
            armed = bool(monitoring_server._servers)
        if not armed:
            yield Diagnostic(
                "observability-coverage",
                Severity.WARNING,
                "replicated/sharded serving plane with no monitoring "
                "server armed in this process: no /metrics scrape, no "
                "SLO signal rings, no incident journal endpoint, no "
                "postmortem crash hooks — the fleet's failure story "
                "goes unrecorded",
                None,
                fix_hint="call "
                "pathway_tpu_torch.internals.monitoring_server."
                "start_http_server() (pw.run(with_http_server=True)); "
                "arming it also starts the signal sampler and installs "
                "the crash hooks",
                data={
                    "replicas": len(replicas),
                    "shards": len(shard_map or []),
                },
            )
        if not get_tracer().enabled:
            yield Diagnostic(
                "observability-coverage",
                Severity.WARNING,
                "tracing is disabled (PATHWAY_TRACING=0) on a "
                "replicated/sharded plane: the stitched /fleet/trace "
                "view cannot cross this member, so a slow request's "
                "router -> replica -> writer path is invisible",
                None,
                fix_hint="unset PATHWAY_TRACING (default on) — the "
                "span ring is bounded and costs microseconds per hop",
            )
    if (get_sampler() is not None or signals_enabled()) and not slo_targets():
        yield Diagnostic(
            "observability-coverage",
            Severity.INFO,
            "the SLO signal sampler is armed but no PATHWAY_SLO_* "
            "target is declared: signal rings fill, burn rates have "
            "nothing to burn against, and /debug/signals reports "
            "trends without verdicts",
            None,
            fix_hint="declare targets, e.g. PATHWAY_SLO_SHED_RATE=0.01 "
            "PATHWAY_SLO_TTFT_P99_MS=500 PATHWAY_SLO_STALENESS_S=5 "
            "(see README 'Observability' for the full signal "
            "inventory)",
        )


@rule("graph-stats")
def graph_stats(facts: GraphFacts) -> Iterable[Diagnostic]:
    """One INFO report: node counts per type, exchange edges, estimated
    state per stateful operator, streaming/static source split."""
    from pathway_tpu_torch.parallel import exchange_topology

    counts = Counter(type(n).__name__ for n in facts.order)
    n_stream = sum(
        1
        for n in facts.order
        if isinstance(n, InputNode) and facts.is_streaming(n)
    )
    n_static = sum(1 for n in facts.order if isinstance(n, InputNode)) - (
        n_stream
    )
    stateful = [n for n in facts.order if getattr(n, "is_stateful", False)]
    topo = exchange_topology()
    lines = [
        f"{len(facts.order)} nodes "
        f"({len(facts.reachable)} reach an output), "
        f"{n_stream} streaming + {n_static} static sources, "
        f"{len(stateful)} stateful operators, "
        f"{sum(len(v) for v in facts.exchange_edges.values())} exchange "
        f"edges (topology: {topo['engine_shards']} engine shard(s) x "
        f"{topo['dcn_processes']} process(es))",
        "node counts: "
        + ", ".join(f"{k}={v}" for k, v in sorted(counts.items())),
    ]
    if stateful:
        lines.append("estimated state:")
        for n in stateful:
            est = _STATE_ESTIMATES.get(type(n).__name__, "O(live rows)")
            lines.append(f"  {n!r}: {est}")
    yield Diagnostic("graph-stats", Severity.INFO, "\n".join(lines), None)


def default_rules() -> dict[str, RuleFn]:
    return dict(RULES)
