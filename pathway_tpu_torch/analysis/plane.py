"""Own copy of ``pathway_tpu/analysis/plane.py`` over the port's engine.

Plane Doctor: deployment-scope rules over graph + environment.

The per-graph rules (analysis/rules.py) prove properties of one
declared dataflow. The invariants the serving and elastic planes enforce at *runtime* —
snapshot coverage for elastic resizes, wire-codec efficiency, knob
coherence across the ``PATHWAY_*`` surface — are statically checkable
too, but their scope is the deployment plane (graph ⨯ exec metadata ⨯
environment), not a single node. These rules live in their own
registry (``PLANE_RULES``) and run via
:func:`pathway_tpu_torch.analysis.doctor.run_plane_doctor` /
``python -m pathway_tpu_torch.analysis --plane``.

Rules consume the same :class:`GraphFacts` instance as the graph rules
(node-anchored findings honor the same per-node ``suppress()``), plus
the exec metadata hooks the elastic and serving planes export:
``elastic.planner.reshard_capable`` (which exec classes can hand state
over as arrangements) and ``serving.config.plane_knobs`` (the
``PATHWAY_*`` environment snapshot).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from pathway_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from pathway_tpu_torch.analysis.graph_facts import GraphFacts

PLANE_RULES: dict[str, Callable[[GraphFacts], Iterable[Diagnostic]]] = {}


def plane_rule(rule_id: str):
    """Register a deployment-scope rule (same contract as ``@rule``:
    a generator of Diagnostics over one GraphFacts)."""

    def deco(fn):
        PLANE_RULES[rule_id] = fn
        return fn

    return deco


def default_plane_rules() -> dict:
    return dict(PLANE_RULES)


# ---------------------------------------------------------------------------
# snapshot coverage (the Shard Flux precondition, ROADMAP 5c)


@plane_rule("snapshot-coverage")
def snapshot_coverage(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Name every stateful exec lacking ``arranged_state``.

    Execs without it snapshot monolithically (one pickle blob): a
    replica boot re-unpickles the whole thing and a live resize (Shard
    Flux) cannot move its state as key-range arrangements — the node
    pins the old shard count until the operator gains arranged-state
    support. Flags the node *statically*, before anyone attempts a
    resize against it."""
    from pathway_tpu_torch.elastic.planner import monolithic_state_nodes

    for node, exec_name in monolithic_state_nodes(facts.order):
        yield Diagnostic(
            "snapshot-coverage",
            Severity.WARNING,
            f"{exec_name} snapshots monolithically (no arranged_state): "
            "replica boots re-unpickle its whole state and a live "
            "resize carries it forward unmoved instead of handing it "
            "over as key-range arrangements",
            node,
            fix_hint="implement arranged_state()/load_arranged_state() "
            "on the exec (see GroupByExec), or suppress with "
            'pw.analysis.suppress(table, "snapshot-coverage") if the '
            "operator's state is accepted as resize-pinned",
            data={"exec": exec_name},
        )


# ---------------------------------------------------------------------------
# pickle on the hot path (ROADMAP 5a precondition)


def _pickles_when_encoded(dtype: Any) -> bool:
    """True when a column of this DType falls through to the pickle
    fallback in the wire codec (parallel/wire.py _encode_column) and the
    segment encoder (persistence/segments.py _encode_col): object
    storage that is not a uniform-ndarray column."""
    from pathway_tpu_torch.internals import dtype as dt

    if dtype is None or dtype is dt.NONE:
        return False
    if isinstance(dtype, dt.ArrayDType):
        # uniform ndarray columns stack into one dense buffer
        return False
    try:
        nd = dt.np_storage_dtype(dtype)
    except Exception:
        return False
    return getattr(nd, "hasobject", False)


def _object_columns(node: Any) -> list[tuple[str, Any]]:
    dtypes = getattr(node, "_column_dtypes", None) or {}
    return [(c, dt_) for c, dt_ in dtypes.items() if _pickles_when_encoded(dt_)]


@plane_rule("pickle-hot-path")
def pickle_hot_path(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Object columns crossing the wire or segment encoders.

    Both encoders fall back to per-column pickle for object-dtype
    columns that are not uniform ndarrays (str/bytes/json/tuple/
    datetime/Optional[...]). On an exchange edge that cost is paid per
    routed batch per tick; in arranged-state segments it is paid per
    snapshot. Dictionary/offsets encodings (ROADMAP 5a) remove it —
    until then, this rule makes the hot-path pickles visible."""
    from pathway_tpu_torch.elastic.planner import reshard_capable

    try:
        from pathway_tpu_torch.parallel import exchange_topology

        sharded = exchange_topology()["sharding_active"]
    except Exception:
        sharded = False
    wire_sev = Severity.WARNING if sharded else Severity.INFO

    seen: set[tuple[int, int, str]] = set()
    for node in facts.order:
        if node.id in facts.exchange_edges:
            for idx, inp in enumerate(node.inputs):
                for col, dt_ in _object_columns(inp):
                    key = (node.id, inp.id, col)
                    if key in seen:
                        continue
                    seen.add(key)
                    try:
                        # resolve prep columns (_g0, _a0_0) back to the
                        # user-facing source column where possible
                        label = facts.input_column_label(
                            node, col, side=min(idx, 1)
                        )
                    except Exception:
                        label = col
                    yield Diagnostic(
                        "pickle-hot-path",
                        wire_sev,
                        f"column {label!r} ({dt_}) crosses the shard "
                        f"exchange in front of {type(node).__name__} as "
                        "per-column pickle (wire codec object "
                        "fallback) — every routed batch pays "
                        "serialization on the tick path",
                        node,
                        fix_hint="store the payload as numeric/Array "
                        "columns, or keep object columns out of "
                        "exchanged tables until dictionary/offsets "
                        "encodings land (ROADMAP 5a)",
                        data={"column": col, "dtype": str(dt_)},
                    )
        if getattr(node, "is_stateful", False) and reshard_capable(node):
            for inp in node.inputs:
                for col, dt_ in _object_columns(inp):
                    key = (node.id, inp.id, col)
                    if key in seen:
                        continue
                    seen.add(key)
                    yield Diagnostic(
                        "pickle-hot-path",
                        Severity.INFO,
                        f"column {col!r} ({dt_}) enters the arranged "
                        f"state of {type(node).__name__} and will "
                        "per-column pickle in segment snapshots",
                        node,
                        fix_hint="numeric/Array payloads snapshot as "
                        "dense buffers; object columns re-pickle every "
                        "segment write",
                        data={"column": col, "dtype": str(dt_)},
                    )


# ---------------------------------------------------------------------------
# PATHWAY_* knob coherence


@plane_rule("knob-coherence")
def knob_coherence(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Lint the ``PATHWAY_*`` environment for contradictions that today
    only fail at boot (ValueError in shard_map_from_env / QoSConfig
    .from_env) or silently degrade (a result cache that never
    invalidates, a gate with no deadline bound)."""
    import os

    from pathway_tpu_torch.serving.config import (
        QoSConfig,
        serving_enabled_via_env,
    )

    def env(name: str) -> str:
        return os.environ.get(name, "").strip()

    # --- conflicting shard counts -------------------------------------
    raw_shards = env("PATHWAY_SERVING_SHARDS")
    raw_map = env("PATHWAY_SERVING_SHARD_MAP")
    shards = None
    if raw_shards:
        try:
            shards = int(raw_shards)
        except ValueError:
            yield Diagnostic(
                "knob-coherence",
                Severity.ERROR,
                f"PATHWAY_SERVING_SHARDS={raw_shards!r} is not an int",
                data={"knob": "PATHWAY_SERVING_SHARDS"},
            )
    shard_map = None
    if raw_map:
        try:
            from pathway_tpu_torch.serving.router import shard_map_from_env

            shard_map = shard_map_from_env()
        except ValueError as exc:
            yield Diagnostic(
                "knob-coherence",
                Severity.ERROR,
                f"PATHWAY_SERVING_SHARD_MAP does not parse: {exc}",
                fix_hint="format: shard0host:port,shard0host:port|"
                "shard1host:port (| separates shards)",
                data={"knob": "PATHWAY_SERVING_SHARD_MAP"},
            )
    if shards is not None and shard_map is not None and len(
        shard_map
    ) != shards:
        yield Diagnostic(
            "knob-coherence",
            Severity.ERROR,
            f"conflicting shard counts: PATHWAY_SERVING_SHARDS={shards} "
            f"but PATHWAY_SERVING_SHARD_MAP describes "
            f"{len(shard_map)} shard(s) — the router would route "
            "against a fabric the engine does not run",
            fix_hint="make the map's |-separated shard count match "
            "PATHWAY_SERVING_SHARDS (or drop one of the knobs)",
            data={
                "knob": "PATHWAY_SERVING_SHARDS",
                "shards": shards,
                "map_shards": len(shard_map),
            },
        )

    # --- gated ingress without deadline bounds ------------------------
    gate_on = serving_enabled_via_env()
    cfg = None
    try:
        cfg = QoSConfig.from_env()
    except ValueError as exc:
        yield Diagnostic(
            "knob-coherence",
            Severity.ERROR,
            f"PATHWAY_SERVING_* does not parse: {exc}",
            data={"knob": "PATHWAY_SERVING_*"},
        )
    if gate_on and cfg is not None:
        if cfg.default_deadline_ms <= 0 or cfg.max_deadline_ms <= 0:
            yield Diagnostic(
                "knob-coherence",
                Severity.WARNING,
                "gated ingress without deadline bounds: "
                "PATHWAY_SERVING_ENABLED=1 but the deadline budget is "
                f"non-positive (DEADLINE_MS={cfg.default_deadline_ms}, "
                f"MAX_DEADLINE_MS={cfg.max_deadline_ms}) — queued "
                "requests can wait forever instead of shedding",
                fix_hint="set PATHWAY_SERVING_DEADLINE_MS and "
                "PATHWAY_SERVING_MAX_DEADLINE_MS to positive budgets",
                data={"knob": "PATHWAY_SERVING_DEADLINE_MS"},
            )
        elif cfg.default_deadline_ms > cfg.max_deadline_ms:
            yield Diagnostic(
                "knob-coherence",
                Severity.WARNING,
                f"PATHWAY_SERVING_DEADLINE_MS="
                f"{cfg.default_deadline_ms} exceeds "
                f"MAX_DEADLINE_MS={cfg.max_deadline_ms}: every "
                "default-budget request is silently clamped to the cap",
                fix_hint="lower DEADLINE_MS or raise MAX_DEADLINE_MS",
                data={"knob": "PATHWAY_SERVING_DEADLINE_MS"},
            )

    # --- cache without invalidation stream ----------------------------
    from pathway_tpu_torch.serving.result_cache import cache_enabled_via_env

    if cache_enabled_via_env() and not env("PATHWAY_ROUTER_CACHE_WRITER"):
        yield Diagnostic(
            "knob-coherence",
            Severity.WARNING,
            "PATHWAY_ROUTER_CACHE=1 without "
            "PATHWAY_ROUTER_CACHE_WRITER: the hot-tenant result cache "
            "has no delta stream to invalidate against and serves "
            "stale results for the full TTL",
            fix_hint="point PATHWAY_ROUTER_CACHE_WRITER at the "
            "engine's delta feed (host:port), or disable the cache",
            data={"knob": "PATHWAY_ROUTER_CACHE"},
        )

    # --- tenancy armed with no gate to apply it -----------------------
    from pathway_tpu_torch.serving.tenancy import tenancy_enabled_via_env

    if tenancy_enabled_via_env() and not gate_on:
        yield Diagnostic(
            "knob-coherence",
            Severity.INFO,
            "PATHWAY_TENANT_QOS=1 but PATHWAY_SERVING_ENABLED is off: "
            "per-tenant fair admission only applies inside the serving "
            "gate, so the knob is inert",
            fix_hint="set PATHWAY_SERVING_ENABLED=1 (or pass qos= to "
            "the rest_connector) to arm the gate tenancy rides on",
            data={"knob": "PATHWAY_TENANT_QOS"},
        )


# ---------------------------------------------------------------------------
# tick-scope coverage (blind planes and silently-broken rooflines)


@plane_rule("tickscope-coverage")
def tickscope_coverage(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Flag planes flying blind or with a broken roofline hook.

    INFO when a serving surface is live while the flight recorder is
    disabled (PATHWAY_TICKSCOPE=0): the first slow-tick incident on
    that plane will have no per-operator evidence to read back.
    WARNING when a plane has executed compiled ticks but the roofline
    has zero ``compiled_tick`` samples: the cost-analysis hook in
    engine/compile.py is silently broken (its registration is
    best-effort by design, so breakage shows up only here)."""
    from pathway_tpu_torch.observability import tickscope

    status = tickscope.coverage_status()
    if status["serving_active"] and not status["recorder_enabled"]:
        yield Diagnostic(
            "tickscope-coverage",
            Severity.INFO,
            "serving surface live with the tick flight recorder "
            "disabled (PATHWAY_TICKSCOPE=0): slow-tick incidents on "
            "this plane will have no per-operator attribution",
            fix_hint="unset PATHWAY_TICKSCOPE (default-on) — the "
            "recorder's hot-loop cost is one `is None` check per "
            "node when idle and is covered by the obs_overhead bench "
            "budget when recording",
            data={"knob": "PATHWAY_TICKSCOPE"},
        )
    samples = status["roofline_samples"]
    if status["compiled_ticks"] > 0 and samples.get("compiled_tick", 0) == 0:
        yield Diagnostic(
            "tickscope-coverage",
            Severity.WARNING,
            f"{status['compiled_ticks']} compiled ticks executed but "
            "the roofline has zero compiled_tick samples: the "
            "cost-analysis observe hook (engine/compile.py "
            "_run_compiled) is silently broken and MFU attribution "
            "reads as 'no compiled work'",
            fix_hint="check that observability.tickscope imports "
            "cleanly in this environment; the hook swallows "
            "exceptions by contract, so an import/runtime error there "
            "only surfaces through this rule",
            data={"compiled_ticks": status["compiled_ticks"]},
        )


# ---------------------------------------------------------------------------
# autoscale coverage (Flux Pilot — planes that CAN resize but nothing is
# watching, and controllers armed with nothing to watch)


@plane_rule("autoscale-coverage")
def autoscale_coverage(facts: GraphFacts) -> Iterable[Diagnostic]:
    """Flag control loops that are half-closed.

    WARNING when the plane is resizable (a sharded serving fabric is
    declared, or the graph holds reshard-capable stateful execs) but no
    Flux Pilot controller is armed: every surge is a page, not an
    actuation.  WARNING when a controller IS armed but not one
    ``PATHWAY_SLO_*`` target is set — its burn input is permanently
    None and the policy holds forever.  INFO when the controller is
    pinned (min_ranks == max_ranks): valid for a canary, but the loop
    can never act."""
    import os

    from pathway_tpu_torch.autoscale import get_controller
    from pathway_tpu_torch.elastic.planner import reshard_capable
    from pathway_tpu_torch.observability.signals import slo_targets

    ctrl = get_controller()
    resizable = bool(os.environ.get("PATHWAY_SERVING_SHARD_MAP", "").strip())
    if not resizable:
        resizable = any(
            getattr(node, "is_stateful", False) and reshard_capable(node)
            for node in facts.order
        )
    if resizable and ctrl is None:
        yield Diagnostic(
            "autoscale-coverage",
            Severity.WARNING,
            "the plane is resizable (reshard-capable state or a sharded "
            "serving fabric) but no Flux Pilot controller is armed: "
            "SLO burns page a human instead of actuating a resize",
            fix_hint="arm one with pathway_tpu_torch.autoscale.arm_controller"
            "(actuator, ranks=N, start=True) — or accept manual "
            "resizes and suppress this finding",
            data={"controller": None},
        )
    if ctrl is not None:
        targets = slo_targets()
        if not targets:
            yield Diagnostic(
                "autoscale-coverage",
                Severity.WARNING,
                "a Flux Pilot controller is armed but zero PATHWAY_SLO_* "
                "targets are set: its burn input is permanently None, "
                "so the policy holds forever and the loop is inert",
                fix_hint="declare at least one SLO target (e.g. "
                "PATHWAY_SLO_SHED_RATE=0.01) so the sampler produces "
                "burn rates the policy can act on",
                data={"slo_targets": 0},
            )
        cfg = ctrl.policy.config
        if cfg.min_ranks == cfg.max_ranks:
            yield Diagnostic(
                "autoscale-coverage",
                Severity.INFO,
                f"the armed controller is pinned at "
                f"{cfg.min_ranks} rank(s) (min_ranks == max_ranks): "
                "decisions always hold — fine for a canary, inert as a "
                "control loop",
                fix_hint="widen PATHWAY_AUTOSCALE_MIN_RANKS / "
                "PATHWAY_AUTOSCALE_MAX_RANKS to give the policy a band",
                data={
                    "min_ranks": cfg.min_ranks,
                    "max_ranks": cfg.max_ranks,
                },
            )
