"""Own copy of ``pathway_tpu/testing/faults.py``: the same ``PATHWAY_FAULTS``
grammar and exit code 23. The whole grammar parses; of the hooks, the port
calls ``on_tick`` (the engine's runtime), ``before_meta_commit`` and
``wrap_store`` (the persistence glue), ``on_decode_step``
(``generate/scheduler.py``), ``on_writer_tick`` and ``on_wire_send`` for
``ch:repl`` (``parallel/replicate.py``'s publisher and sender loop) and
``on_replica_tick`` (``serving/replica.py``) — the ferry hook waits for the
mesh's slice.

Fault Forge — deterministic, seeded fault injection for chaos tests.

The reference exercises its persistence/recovery guarantees with
integration tests that kill whole worker groups mid-run (reference:
integration_tests/wordcount); Fault Forge makes that style of test (and
the ``bench.py chaos_recovery`` tier) deterministic and scriptable: a
single ``PATHWAY_FAULTS`` spec arms a small set of hooks baked into the
hot paths, each of which is a no-op (one cached ``None`` check) when the
variable is unset.

Spec grammar — semicolon-separated directives, each ``name=arg:val,...``::

    PATHWAY_FAULTS="seed=7;kill=tick:5,pid:1;drop=ch:gb,nth:2"

Directives:

``seed=<int>``
    Seeds the plan RNG (used by probabilistic args; purely informative
    for count-based specs, which are deterministic by construction).
``kill=tick:<N>[,pid:<P>][,at:head|tail][,inc:<I>]``
    ``os._exit(FAULT_EXIT)`` when the N-th data tick starts (``head``,
    default) or ends (``tail`` — the group-visible "mid-tick" kill: peers
    are already exchanging the next round) on process P (default: every
    process). Fires only in supervisor incarnation I (default 0), so a
    restarted group does not re-kill itself.
``kill=replica:<R>[,tick:<T>][,inc:<I>]``
    Replica-scoped kill (Replica Shield): ``os._exit(FAULT_EXIT)`` on
    read replica R when it has APPLIED its T-th delta-stream tick
    (default 1) — the deterministic counter is the replica's per-process
    applied-tick count, so the kill lands at the same corpus state every
    run.  Same incarnation gating as engine kills: a supervised restart
    of the replica runs fault-free by default.  The delta stream itself
    is targeted with the wire directives below via its channel prefix
    (``ch:repl`` — e.g. ``delay=ch:repl,nth:3,ms:200``; the
    writer→standby leg alone via ``ch:repl:standby``).
``kill=ferry:<N>[,inc:<I>]``
    Shard Flux handoff kill: ``os._exit(FAULT_EXIT)`` after the
    SegmentFerry has sent (and had acknowledged) its N-th segment —
    the deterministic counter is the sender's per-process transferred
    -segment count, so a chaos leg lands the death at the same point
    of the handoff every run, always BEFORE the transfer's commit
    frame (the two-phase barrier must roll back cleanly: the old
    ownership map stays committed, the staged segments resume
    content-addressed).  ``at:`` is rejected (the transfer counter is
    the clock); incarnation-gated like every kill, so a supervised
    retry of the handoff runs fault-free by default.
``kill=writer:1[,tick:<T>][,inc:<I>]``
    Writer-scoped kill (Shard Harbor, symmetric with ``kill=replica``):
    ``os._exit(FAULT_EXIT)`` on the replication WRITER when it has
    PUBLISHED its T-th distinct delta-stream tick (default 1) — the
    deterministic counter is the delta publisher's distinct-tick count,
    so standby takeover lands at the same stream position every run.
    Fires only on a process that IS a publisher (PATHWAY_REPL_PORT
    armed); incarnation-gated like every kill, so the standby's
    takeover writer (bumped incarnation) runs fault-free by default.
``drop=ch:<prefix>,nth:<K>[,pid:<P>][,inc:<I>]``
    Silently drop the K-th wire frame sent on channels whose name starts
    with ``<prefix>`` (``bar`` = barrier frames, ``hb`` = heartbeats).
``dup=ch:<prefix>,nth:<K>[,pid:<P>][,inc:<I>]``
    Send the K-th matching frame twice (delivery is keyed per
    (channel, tick, src), so duplicates must be idempotent — asserted by
    the chaos tests).
``delay=ch:<prefix>,nth:<K>,ms:<D>[,pid:<P>][,inc:<I>]``
    Sleep D ms before sending the K-th matching frame.
``torn=nth:<K>[,pid:<P>][,inc:<I>]``
    ``os._exit(FAULT_EXIT)`` immediately before the K-th metadata commit
    that publishes a NEW operator-state generation — segments and state
    blobs are already on disk, the manifest pointer is not: the classic
    torn snapshot.
``slow_store=ms:<D>``
    Sleep D ms on every persistence-store put/get/get_buffer (I/O
    degradation, including the mmap segment-recovery reads).
``flood=tenant:<T>,rps:<R>[,ticks:<N>][,class:<C>][,inc:<I>]``
    Deterministic noisy neighbor (Tenant Weave): charge R synthetic
    requests to tenant T (weight class C) through the tenant ledger for
    every REAL admission processed — the ledger's admission counter is
    the clock, like ``kill=`` uses tick counters, so fairness tests
    need no wall-clock load generators.  ``ticks:N`` bounds the flood
    to the first N real admissions (default: the whole run); ``at:`` is
    rejected (admissions have no head/tail).  Incarnation-gated like
    every directive.

The incarnation comes from ``PATHWAY_MESH_INCARNATION`` (set by the
group supervisor, ``parallel/supervisor.py``); kill-like directives
default to incarnation 0 so a supervised restart runs fault-free and the
test can assert clean recovery.  ``FAULT_EXIT`` (= 23) distinguishes an
injected death from a genuine crash in supervisor logs and tests.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any

FAULT_EXIT = 23  # exit code of every injected process death

_WIRE_DIRECTIVES = ("drop", "dup", "delay")

_plan: "FaultPlan | None | bool" = False  # False = not resolved yet


class FaultSpecError(ValueError):
    pass


class _Directive:
    __slots__ = ("name", "args", "fired")

    def __init__(self, name: str, args: dict[str, str]):
        self.name = name
        self.args = args
        self.fired = 0

    def arg_int(self, key: str, default: int | None = None) -> int | None:
        raw = self.args.get(key)
        if raw is None:
            if default is None:
                raise FaultSpecError(
                    f"fault directive {self.name!r} needs `{key}:<int>`"
                )
            return default
        try:
            return int(raw)
        except ValueError:
            raise FaultSpecError(
                f"fault directive {self.name!r}: {key}:{raw!r} is not an int"
            ) from None

    def matches_process(self, pid: int, incarnation: int) -> bool:
        want_pid = self.arg_int("pid", -1)
        if want_pid >= 0 and want_pid != pid:
            return False
        inc = self.args.get("inc", "0")
        if inc == "*":
            return True
        return int(inc) == incarnation


class FaultPlan:
    """Parsed ``PATHWAY_FAULTS`` spec + per-process deterministic state.

    Thread-safe: wire hooks run on per-peer sender threads, store hooks
    on whatever thread drives persistence."""

    def __init__(self, spec: str, pid: int, incarnation: int):
        self.spec = spec
        self.pid = pid
        self.incarnation = incarnation
        self.directives: list[_Directive] = []
        self._lock = threading.Lock()
        self._ticks = 0
        self._meta_commits = 0
        seed = 0
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise FaultSpecError(
                    f"fault directive {part!r}: expected name=arg:val,..."
                )
            name, _, rest = part.partition("=")
            name = name.strip()
            if name == "seed":
                seed = int(rest)
                continue
            args: dict[str, str] = {}
            for kv in rest.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                if ":" not in kv:
                    raise FaultSpecError(
                        f"fault directive {name!r}: bad arg {kv!r} "
                        "(expected key:value)"
                    )
                k, _, v = kv.partition(":")
                args[k.strip()] = v.strip()
            known = ("kill", "torn", "slow_store", "flood") + _WIRE_DIRECTIVES
            if name not in known:
                raise FaultSpecError(
                    f"unknown fault directive {name!r} (known: "
                    f"{', '.join(known)})"
                )
            d = _Directive(name, args)
            # validate eagerly so a typo fails at startup, not mid-chaos
            inc_raw = args.get("inc", "0")
            if inc_raw != "*":
                try:
                    int(inc_raw)
                except ValueError:
                    raise FaultSpecError(
                        f"fault directive {name!r}: inc:{inc_raw!r} is "
                        "not an int (or '*')"
                    ) from None
            if args.get("pid") is not None:
                d.arg_int("pid")
            if name == "kill":
                if args.get("replica") is not None:
                    # replica-scoped kill: tick optional (default 1 =
                    # first applied delta tick); `at` is meaningless —
                    # replicas apply whole ticks, they never exchange
                    d.arg_int("replica")
                    if args.get("tick") is not None:
                        d.arg_int("tick")
                    if args.get("at") is not None:
                        raise FaultSpecError(
                            "kill: `at` does not apply to replica-"
                            "scoped kills (replicas have no tick "
                            "head/tail)"
                        )
                elif args.get("decode") is not None:
                    # decode-scoped kill: counts the generation
                    # scheduler's decode steps (generate/scheduler.py);
                    # `at` is meaningless — the step counter is the
                    # deterministic clock
                    d.arg_int("decode")
                    if args.get("at") is not None:
                        raise FaultSpecError(
                            "kill: `at` does not apply to decode-"
                            "scoped kills (the decode-step counter is "
                            "the clock)"
                        )
                elif args.get("ferry") is not None:
                    # ferry-scoped kill: counts the SegmentFerry's
                    # acknowledged segment transfers; `at` is
                    # meaningless (the transfer counter is the clock)
                    d.arg_int("ferry")
                    if args.get("at") is not None:
                        raise FaultSpecError(
                            "kill: `at` does not apply to ferry-"
                            "scoped kills (the segment-transfer "
                            "counter is the clock)"
                        )
                elif args.get("writer") is not None:
                    # writer-scoped kill: counts distinct PUBLISHED
                    # delta ticks; `at` is meaningless (the publish
                    # point is the deterministic clock)
                    d.arg_int("writer")
                    if args.get("tick") is not None:
                        d.arg_int("tick")
                    if args.get("at") is not None:
                        raise FaultSpecError(
                            "kill: `at` does not apply to writer-"
                            "scoped kills (the publish point is the "
                            "clock)"
                        )
                else:
                    d.arg_int("tick")
                    if args.get("at", "head") not in ("head", "tail"):
                        raise FaultSpecError(
                            "kill: `at` must be head or tail"
                        )
            elif name == "flood":
                if not args.get("tenant"):
                    raise FaultSpecError("flood: needs `tenant:<id>`")
                d.arg_int("rps")
                if args.get("ticks") is not None:
                    d.arg_int("ticks")
                if args.get("at") is not None:
                    raise FaultSpecError(
                        "flood: `at` does not apply (the admission "
                        "counter is the clock)"
                    )
            elif name == "torn":
                d.arg_int("nth")
            elif name == "slow_store":
                d.arg_int("ms")
            else:  # wire directives
                d.arg_int("nth")
                if "ch" not in args:
                    raise FaultSpecError(f"{name}: needs `ch:<prefix>`")
                if name == "delay":
                    d.arg_int("ms")
            self.directives.append(d)
        self.rng = random.Random(seed)
        self._slow_store_s = 0.0
        for d in self.directives:
            if d.name == "slow_store":
                self._slow_store_s = d.arg_int("ms") / 1000.0
        self._has_wire = any(
            d.name in _WIRE_DIRECTIVES for d in self.directives
        )
        self._wire_counts: dict[str, int] = {}

    # --- hooks ------------------------------------------------------------

    def _exit(self, what: str) -> None:
        import logging
        import sys

        logging.getLogger("pathway_tpu_torch").warning(
            "fault forge: injected death (%s) on process %d", what, self.pid
        )
        # Fleet Lens: an injected FAULT_EXIT drops a postmortem bundle
        # (journal tail + spans + metrics + thread dump) exactly like a
        # real crash would — chaos runs exercise the forensics path too
        try:
            from pathway_tpu_torch.observability.journal import journal

            j = journal()
            j.record(
                "fault-exit", f"injected death ({what})", persist=True
            )
            j.postmortem(f"fault-exit:{what}")
        except Exception:
            pass  # forensics must never block the injected death
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(FAULT_EXIT)

    def on_tick(self, t: int, phase: str = "head") -> None:
        """Called by the runtime at the head and tail of every data tick
        (t < END_OF_TIME). ``kill=tick:N`` counts head calls."""
        with self._lock:
            if phase == "head":
                self._ticks += 1
            n = self._ticks
        for d in self.directives:
            if d.name != "kill" or d.fired:
                continue
            if (
                d.args.get("replica") is not None
                or d.args.get("writer") is not None
                or d.args.get("decode") is not None
                or d.args.get("ferry") is not None
            ):
                continue  # replica-/writer-/decode-/ferry-scoped kills
                # fire in their own hooks (on_replica_tick /
                # on_writer_tick / on_decode_step / on_ferry_segment)
            if not d.matches_process(self.pid, self.incarnation):
                continue
            if d.args.get("at", "head") != phase:
                continue
            if n >= (d.arg_int("tick") or 0):
                d.fired += 1
                self._exit(f"kill at tick {n} ({phase})")

    def on_replica_tick(self, replica_id: int, n_applied: int) -> None:
        """Called by a read replica (serving/replica.py) after applying
        each delta-stream tick; ``n_applied`` is the deterministic
        per-process applied-tick counter ``kill=replica:R,tick:T``
        fires on."""
        for d in self.directives:
            if d.name != "kill" or d.fired:
                continue
            want = d.args.get("replica")
            if want is None or int(want) != int(replica_id):
                continue
            if not d.matches_process(self.pid, self.incarnation):
                continue
            if n_applied >= (d.arg_int("tick", 1) or 1):
                d.fired += 1
                self._exit(
                    f"kill replica {replica_id} after applied tick "
                    f"{n_applied}"
                )

    def on_writer_tick(self, n_published: int) -> None:
        """Called by the replication writer's delta publisher
        (parallel/replicate.py) after fanning out each DISTINCT tick;
        ``n_published`` is the deterministic per-process published-tick
        counter ``kill=writer:1,tick:T`` fires on."""
        for d in self.directives:
            if d.name != "kill" or d.fired:
                continue
            if d.args.get("writer") is None:
                continue
            if not d.matches_process(self.pid, self.incarnation):
                continue
            if n_published >= (d.arg_int("tick", 1) or 1):
                d.fired += 1
                self._exit(
                    f"kill writer after published tick {n_published}"
                )

    def on_decode_step(self, n_steps: int) -> None:
        """Called by the generation scheduler (generate/scheduler.py)
        after each completed decode step; ``n_steps`` is the
        deterministic per-process step counter ``kill=decode:N`` fires
        on — the chaos clock for mid-generation deaths."""
        for d in self.directives:
            if d.name != "kill" or d.fired:
                continue
            if d.args.get("decode") is None:
                continue
            if not d.matches_process(self.pid, self.incarnation):
                continue
            if n_steps >= (d.arg_int("decode") or 1):
                d.fired += 1
                self._exit(f"kill after decode step {n_steps}")

    def on_ferry_segment(self, n_sent: int) -> None:
        """Called by the SegmentFerry sender (elastic/ferry.py) after
        each ACKNOWLEDGED segment transfer; ``n_sent`` is the
        deterministic per-transfer counter ``kill=ferry:N`` fires on —
        the chaos clock for mid-handoff deaths (always before the
        transfer's commit frame, so the two-phase barrier rolls
        back)."""
        for d in self.directives:
            if d.name != "kill" or d.fired:
                continue
            if d.args.get("ferry") is None:
                continue
            if not d.matches_process(self.pid, self.incarnation):
                continue
            if n_sent >= (d.arg_int("ferry") or 1):
                d.fired += 1
                self._exit(f"kill after ferry segment {n_sent}")

    def flood_charges(
        self, admission_n: int
    ) -> list[tuple[str, str | None, int]]:
        """Tenant Weave hook, called by the tenant ledger per REAL
        admission (``admission_n`` = the ledger's deterministic 1-based
        admission counter).  Returns ``(tenant, weight_class, rps)``
        synthetic-charge triples for every live ``flood=`` directive —
        R charges per real admission, for the first ``ticks`` (default:
        unlimited) admissions."""
        charges: list[tuple[str, str | None, int]] = []
        for d in self.directives:
            if d.name != "flood":
                continue
            if not d.matches_process(self.pid, self.incarnation):
                continue
            ticks = d.arg_int("ticks", 0) or 0  # 0 = unlimited
            if ticks and admission_n > ticks:
                continue
            charges.append(
                (
                    d.args["tenant"],
                    d.args.get("class"),
                    d.arg_int("rps") or 0,
                )
            )
        return charges

    def on_wire_send(self, channel: str) -> tuple[str, float] | None:
        """Called by the mesh sender thread per outgoing frame. Returns
        None (send normally), ("drop", 0), ("dup", 0) or ("delay", s)."""
        if not self._has_wire:
            return None
        with self._lock:
            for idx, d in enumerate(self.directives):
                if d.name not in _WIRE_DIRECTIVES or d.fired:
                    continue
                if not d.matches_process(self.pid, self.incarnation):
                    continue
                if not channel.startswith(d.args["ch"]):
                    continue
                # counters are PER DIRECTIVE (keyed by position): two
                # same-kind directives on one channel prefix count their
                # matching frames independently
                key = str(idx)
                count = self._wire_counts.get(key, 0) + 1
                self._wire_counts[key] = count
                if count == (d.arg_int("nth") or 0):
                    d.fired += 1
                    if d.name == "delay":
                        return ("delay", (d.arg_int("ms") or 0) / 1000.0)
                    return (d.name, 0.0)
        return None

    def before_meta_commit(self, publishes_state: bool) -> None:
        """Called by the persistence layer immediately before writing
        metadata; ``publishes_state`` = this commit names a new operator
        -state generation (segments already durable)."""
        if not publishes_state:
            return
        with self._lock:
            self._meta_commits += 1
            n = self._meta_commits
        for d in self.directives:
            if d.name != "torn" or d.fired:
                continue
            if not d.matches_process(self.pid, self.incarnation):
                continue
            if n >= (d.arg_int("nth") or 0):
                d.fired += 1
                self._exit(f"torn snapshot before metadata commit {n}")

    def store_delay(self) -> None:
        if self._slow_store_s > 0.0:
            time.sleep(self._slow_store_s)

    def wrap_store(self, store: Any) -> Any:
        """Wrap a BackendStore so every put/get pays the slow-store
        delay. Other attributes pass through untouched."""
        if self._slow_store_s <= 0.0:
            return store
        return _SlowStore(store, self)


class _SlowStore:
    def __init__(self, inner: Any, plan: FaultPlan):
        self._inner = inner
        self._plan = plan

    def put(self, key: str, data: bytes) -> None:
        self._plan.store_delay()
        self._inner.put(key, data)

    def get(self, key: str):
        self._plan.store_delay()
        return self._inner.get(key)

    def get_buffer(self, key: str):
        # the mmap recovery-read path (segment restore) must pay the
        # injected I/O degradation too, or recovery timings lie
        self._plan.store_delay()
        return self._inner.get_buffer(key)

    def __getattr__(self, name: str):
        return getattr(self._inner, name)


def active() -> FaultPlan | None:
    """The process's fault plan, parsed once from PATHWAY_FAULTS (None
    when unset). The cached plan keeps deterministic counters across
    every hook site."""
    global _plan
    if _plan is False:
        spec = os.environ.get("PATHWAY_FAULTS", "")
        if not spec:
            _plan = None
        else:
            pid = int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0)
            inc = int(os.environ.get("PATHWAY_MESH_INCARNATION", "0") or 0)
            _plan = FaultPlan(spec, pid, inc)
    return _plan


def reset() -> None:
    """Drop the cached plan (tests re-arm with a fresh env)."""
    global _plan
    _plan = False
