"""Own copy of ``pathway_tpu/observability/fleet.py`` (standard library
``urllib`` over the port's exposition parser): the same federated
documents, so a fleet of port members, reference members or both reads as
one.

Fleet Lens federation — one observability plane for the whole mesh.

Every member (writer, standby, replicas, router) already serves its own
``/metrics``, ``/debug/events`` and ``/debug/trace``; this module is the
read side that stitches them into one view.  The router (and
``GroupSupervisor``) mount it as:

* ``/fleet/metrics`` — member-labeled aggregation of every member's
  exposition body.  Each sample gains a ``member="<name>"`` label and
  each family keeps exactly one HELP/TYPE line, so the merged body
  passes :func:`validate_exposition` — one scrape target for the whole
  plane.
* ``/fleet/events`` — the members' incident journals merged into a
  single (incarnation, wall, tick)-ordered timeline.  This is the feed
  chaos benches measure takeover/reshard windows from: the system's own
  record, not a bench-side stopwatch.
* ``/fleet/trace`` — cross-member Chrome-trace stitch.  Each member
  becomes a Perfetto process (distinct integer ``pid`` + a
  ``process_name`` metadata event); pass ``trace_id`` to cut one
  request's path across router → replica → writer out of the merged
  stream.  The result passes :func:`validate_chrome_trace`.

All fetches use stdlib ``urllib`` with short timeouts; a dead member
degrades to ``pathway_fleet_member_up{member=...} 0`` (metrics) or an
entry in ``errors`` (events/trace) — federation never raises because
one member is mid-crash.  That property is load-bearing: the chaos
bench scrapes `/fleet/*` WHILE it SIGKILLs members.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Iterable, Mapping

from pathway_tpu_torch.observability.exposition import parse_exposition
from pathway_tpu_torch.observability.registry import escape_label_value, format_value

DEFAULT_TIMEOUT_S = 2.0

#: reserved label injected into every federated sample.
MEMBER_LABEL = "member"


def _fetch(url: str, timeout: float) -> bytes:
    req = urllib.request.Request(url, headers={"Accept": "*/*"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def _normalize_members(
    members: Mapping[str, str] | Iterable[tuple[str, str]],
) -> list[tuple[str, str]]:
    """(name, base_url) pairs with trailing slashes trimmed."""
    if isinstance(members, Mapping):
        items = list(members.items())
    else:
        items = list(members)
    return [(str(n), str(u).rstrip("/")) for (n, u) in items]


def members_from_env(env: Mapping[str, str] | None = None) -> list[
    tuple[str, str]
]:
    """``PATHWAY_FLEET_MEMBERS``: comma-separated ``name=http://h:p``
    entries (bare URLs get positional ``member<i>`` names) — the fleet a
    monitoring server's ``/fleet/*`` endpoints federate over.  The group
    supervisor stamps this into every rank's environment so any rank's
    monitoring port answers for the whole group."""
    import os

    raw = (env or os.environ).get("PATHWAY_FLEET_MEMBERS", "")
    out: list[tuple[str, str]] = []
    for i, part in enumerate(p.strip() for p in raw.split(",")):
        if not part:
            continue
        name, eq, url = part.partition("=")
        if not eq:
            name, url = f"member{i}", part
        out.append((name.strip(), url.strip().rstrip("/")))
    return out


# --- /fleet/metrics ---------------------------------------------------------


def federate_metrics(
    members: Mapping[str, str] | Iterable[tuple[str, str]],
    timeout: float = DEFAULT_TIMEOUT_S,
    local: tuple[str, str] | None = None,
) -> tuple[str, dict[str, str]]:
    """Merge every member's ``/metrics`` body into one member-labeled
    exposition text.  ``local`` is an optional (name, body) pair for the
    federating process itself (the router scrapes itself in-process
    rather than over HTTP).  Returns (text, errors-by-member); the text
    passes ``validate_exposition`` regardless of which members failed.
    """
    members = _normalize_members(members)
    errors: dict[str, str] = {}
    bodies: list[tuple[str, str]] = []
    if local is not None:
        bodies.append((local[0], local[1]))
    up: dict[str, int] = {}
    for name, base in members:
        try:
            bodies.append(
                (name, _fetch(f"{base}/metrics", timeout).decode("utf-8"))
            )
            up[name] = 1
        except Exception as exc:  # noqa: BLE001 — any member failure degrades
            errors[name] = f"{type(exc).__name__}: {exc}"
            up[name] = 0
    if local is not None:
        up.setdefault(local[0], 1)

    # family name → (type, help, [(member, Sample), ...]); first member
    # to expose a family wins its TYPE/HELP (mismatches recorded, the
    # first type kept so the merged body stays self-consistent).
    fams: dict[str, dict[str, Any]] = {}
    order: list[str] = []
    for member, body in bodies:
        parsed, perrs = parse_exposition(body)
        if perrs:
            errors[member] = "; ".join(perrs[:4])
        for fname, fam in parsed.items():
            ent = fams.get(fname)
            if ent is None:
                ent = {"type": fam.type, "help": fam.help, "samples": []}
                fams[fname] = ent
                order.append(fname)
            elif fam.type != "untyped" and ent["type"] == "untyped":
                ent["type"] = fam.type
            for s in fam.samples:
                ent["samples"].append((member, s))

    lines: list[str] = []
    for fname in order:
        ent = fams[fname]
        if ent["help"]:
            lines.append(f"# HELP {fname} {ent['help']}")
        if ent["type"] != "untyped":
            lines.append(f"# TYPE {fname} {ent['type']}")
        seen: set[tuple[str, tuple[tuple[str, str], ...]]] = set()
        for member, s in ent["samples"]:
            labels = dict(s.labels)
            labels[MEMBER_LABEL] = member
            key = (s.name, tuple(sorted(labels.items())))
            if key in seen:
                continue
            seen.add(key)
            lines.append(_render_sample(s.name, labels, s.value))

    lines.append("# HELP pathway_fleet_member_up member scrape success")
    lines.append("# TYPE pathway_fleet_member_up gauge")
    for name in sorted(up):
        lines.append(
            _render_sample(
                "pathway_fleet_member_up", {MEMBER_LABEL: name}, float(up[name])
            )
        )
    return "\n".join(lines) + "\n", errors


def _render_sample(name: str, labels: dict[str, str], value: float) -> str:
    if labels:
        # keep `le`/`quantile` last so bucket lines read naturally
        keys = sorted(labels, key=lambda k: (k in ("le", "quantile"), k))
        body = ",".join(f'{k}="{escape_label_value(labels[k])}"' for k in keys)
        return f"{name}{{{body}}} {format_value(value)}"
    return f"{name} {format_value(value)}"


# --- /fleet/events ----------------------------------------------------------


def federate_events(
    members: Mapping[str, str] | Iterable[tuple[str, str]],
    timeout: float = DEFAULT_TIMEOUT_S,
    local: list[dict[str, Any]] | None = None,
) -> dict[str, Any]:
    """Merge member ``/debug/events`` journals (plus the federator's own
    ``local`` events) into one (incarnation, wall, tick)-ordered
    timeline.  Monotonic stamps are per-process and deliberately NOT
    used for cross-member ordering."""
    members = _normalize_members(members)
    errors: dict[str, str] = {}
    merged: list[dict[str, Any]] = []
    seen_members: list[str] = []
    for ev in local or []:
        merged.append(dict(ev))
    for name, base in members:
        try:
            raw = json.loads(_fetch(f"{base}/debug/events", timeout))
        except Exception as exc:  # noqa: BLE001
            errors[name] = f"{type(exc).__name__}: {exc}"
            continue
        events = raw.get("events", raw) if isinstance(raw, dict) else raw
        if not isinstance(events, list):
            errors[name] = "malformed events payload"
            continue
        seen_members.append(name)
        for ev in events:
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            ev.setdefault("member", name)
            merged.append(ev)

    def _key(ev: dict[str, Any]):
        tick = ev.get("tick")
        return (
            int(ev.get("incarnation") or 0),
            float(ev.get("wall") or 0.0),
            -1 if tick is None else int(tick),
            str(ev.get("member", "")),
            int(ev.get("seq") or 0),
        )

    merged.sort(key=_key)
    return {"members": seen_members, "events": merged, "errors": errors}


def window_from_events(
    events: list[dict[str, Any]],
    start_kinds: Iterable[str],
    end_kinds: Iterable[str],
    min_incarnation: int = 0,
) -> dict[str, Any] | None:
    """Wall-clock window from the first start-kind event to the LAST
    end-kind event at/after it.  This is how chaos benches derive
    takeover/reshard windows from `/fleet/events` alone: e.g. first
    ``stream-disconnect`` → last ``caught-up`` with the new incarnation.
    Returns {start_wall, end_wall, seconds, start_event, end_event} or
    None when either edge is missing."""
    starts = set(start_kinds)
    ends = set(end_kinds)
    start_ev: dict[str, Any] | None = None
    end_ev: dict[str, Any] | None = None
    for ev in events:
        if int(ev.get("incarnation") or 0) < min_incarnation:
            continue
        kind = ev.get("kind")
        wall = float(ev.get("wall") or 0.0)
        if kind in starts and (start_ev is None or wall < start_ev["wall"]):
            start_ev = ev
    if start_ev is None:
        return None
    for ev in events:
        if int(ev.get("incarnation") or 0) < min_incarnation:
            continue
        wall = float(ev.get("wall") or 0.0)
        if (
            ev.get("kind") in ends
            and wall >= float(start_ev.get("wall") or 0.0)
            and (end_ev is None or wall > end_ev["wall"])
        ):
            end_ev = ev
    if end_ev is None:
        return None
    start_w = float(start_ev["wall"])
    end_w = float(end_ev["wall"])
    return {
        "start_wall": start_w,
        "end_wall": end_w,
        "seconds": max(end_w - start_w, 0.0),
        "start_event": start_ev,
        "end_event": end_ev,
    }


# --- /fleet/trace -----------------------------------------------------------


def stitch_traces(
    members: Mapping[str, str] | Iterable[tuple[str, str]],
    trace_id: str | None = None,
    timeout: float = DEFAULT_TIMEOUT_S,
    local: tuple[str, dict[str, Any]] | None = None,
) -> dict[str, Any]:
    """Merge member Chrome-trace docs into one Perfetto-loadable doc.
    Each member gets a distinct integer ``pid`` and a ``process_name``
    metadata event so the UI shows one track group per member; with
    ``trace_id`` only that trace's spans survive the cut.  The result
    passes ``validate_chrome_trace``."""
    members = _normalize_members(members)
    errors: dict[str, str] = {}
    docs: list[tuple[str, dict[str, Any]]] = []
    if local is not None:
        docs.append(local)
    for name, base in members:
        try:
            doc = json.loads(_fetch(f"{base}/debug/trace", timeout))
        except Exception as exc:  # noqa: BLE001
            errors[name] = f"{type(exc).__name__}: {exc}"
            continue
        if isinstance(doc, dict):
            docs.append((name, doc))
        else:
            errors[name] = "malformed trace payload"

    events: list[dict[str, Any]] = []
    member_names: list[str] = []
    exemplars: list[Any] = []
    for pid, (name, doc) in enumerate(docs, start=1):
        member_names.append(name)
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "ts": 0,
                "args": {"name": name},
            }
        )
        other = doc.get("otherData")
        if isinstance(other, dict):
            ex = other.get("exemplars")
            if isinstance(ex, list):
                exemplars.extend(ex)
        for ev in doc.get("traceEvents", []):
            if not isinstance(ev, dict):
                continue
            if ev.get("ph") == "M":
                continue  # replaced by the per-member process_name above
            if trace_id is not None:
                args = ev.get("args")
                if not (
                    isinstance(args, dict)
                    and str(args.get("trace_id", "")) == str(trace_id)
                ):
                    continue
            ev = dict(ev)
            ev["pid"] = pid
            events.append(ev)

    # stable cross-member order for span events (metadata stays first)
    meta = [e for e in events if e.get("ph") == "M"]
    spans = [e for e in events if e.get("ph") != "M"]
    spans.sort(key=lambda e: (float(e.get("ts") or 0.0), int(e.get("pid") or 0)))
    return {
        "traceEvents": meta + spans,
        "displayTimeUnit": "ms",
        "otherData": {
            "members": member_names,
            "trace_id": trace_id,
            "errors": errors,
            "exemplars": exemplars,
        },
    }


def federate_ticks(
    members: Mapping[str, str] | Iterable[tuple[str, str]],
    timeout: float = DEFAULT_TIMEOUT_S,
    local: tuple[str, dict[str, Any]] | None = None,
    channel_edges: Iterable[
        tuple[tuple[str, str], tuple[str, str], float]
    ] = (),
) -> dict[str, Any]:
    """Tick Scope across the fleet: pull every member's ``/debug/tick``
    and stitch the per-rank exec DAGs into one fleet-wide critical path
    (observability/tickscope.py ``stitch_ranks``). ``channel_edges``
    optionally adds exchange hops as
    ``((member, node), (member, node), wait_seconds)`` — without them
    the rank DAGs are disjoint and the fleet critical path is the
    slowest member's chain, which is exactly the lockstep-tick answer
    when channel waits are unmeasured."""
    from pathway_tpu_torch.observability.tickscope import stitch_ranks

    members = _normalize_members(members)
    errors: dict[str, str] = {}
    docs: dict[str, dict[str, Any]] = {}
    if local is not None:
        docs[local[0]] = local[1]
    for name, base in members:
        try:
            doc = json.loads(_fetch(f"{base}/debug/tick", timeout))
        except Exception as exc:  # noqa: BLE001
            errors[name] = f"{type(exc).__name__}: {exc}"
            continue
        if isinstance(doc, dict):
            docs[name] = doc
        else:
            errors[name] = "malformed tick payload"

    rank_names = sorted(docs)
    rank_of = {name: i for i, name in enumerate(rank_names)}
    rank_durations: dict[int, dict[str, float]] = {}
    rank_edges: dict[int, list[tuple[str, str]]] = {}
    per_member: dict[str, Any] = {}
    for name in rank_names:
        last = docs[name].get("last") or {}
        ops = last.get("operators") or []
        rank_durations[rank_of[name]] = {
            op["node"]: float(op.get("wall_ms", 0.0)) / 1e3
            for op in ops
            if isinstance(op, dict) and "node" in op
        }
        rank_edges[rank_of[name]] = [
            (s, d)
            for e in (last.get("edges") or [])
            if isinstance(e, (list, tuple)) and len(e) == 2
            for s, d in [(str(e[0]), str(e[1]))]
        ]
        per_member[name] = {
            "tick_wall_ms": last.get("wall_ms"),
            "critical_path": last.get("critical_path"),
        }
    stitched = [
        ((rank_of[sm], sn), (rank_of[dm], dn), float(w))
        for (sm, sn), (dm, dn), w in channel_edges
        if sm in rank_of and dm in rank_of
    ]
    total_s, path = stitch_ranks(rank_durations, rank_edges, stitched)
    return {
        "members": per_member,
        "errors": errors,
        "critical_path": {
            "total_ms": round(total_s * 1e3, 6),
            "stages": [
                f"{rank_names[r]}:{node}" for r, node in path
            ],
        },
    }
