"""Phoenix Mesh group supervisor — whole-group restart on rank failure, the
port's own copy of ``pathway_tpu/parallel/supervisor.py``.

The mesh is fail-stop per incarnation: a dead peer surfaces as
HostMeshError on every survivor (heartbeat liveness, reader EOF, or a
send failure — parallel/host_exchange.py), every rank exits nonzero, and
recovery = restart the WHOLE group from the latest group-committed
snapshot generation (persistence/_runtime_glue.py), the reference's
recovery model (whole-cluster restart from the persisted frontier). This
module is the restart half: it spawns the N ranks, watches them, tears the
group down when any rank dies, and respawns everything under a bounded
restart budget with jittered backoff.

Each incarnation gets ``PATHWAY_MESH_INCARNATION=<n>`` in its
environment: Fault Forge directives (testing/faults.py) default to
incarnation 0, so an injected death is not re-injected into the
restarted group.

Where the JAX package's ranks read ``JAX_*``, a rank of this package joins
``torch.distributed`` from ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK`` (parallel/distributed.py). They are set per rank and
per incarnation from the group's current size (:func:`rank_vars`, also
what ``cli spawn`` sets), so a :meth:`GroupSupervisor.resize` never leaves
a rank with the old size. Every incarnation keeps the coordinator
(``MASTER_ADDR:MASTER_PORT``): the rendezvous store binds it with
``SO_REUSEADDR``, so the next incarnation's rank 0 can bind it as soon as
the last one's is gone, even where that rank was killed.

Usage::

    python -m pathway_tpu_torch.parallel.supervisor -n 2 -- python job.py
    python -m pathway_tpu_torch.cli spawn -n 2 --supervise -- python job.py

or programmatically::

    sup = GroupSupervisor(["python", "job.py"], n=2, env=extra_env)
    rc = sup.run()
    sup.events  # [(monotonic_ts, "rank-died"|"group-restart"|..., detail)]
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Mapping


def max_restarts_env() -> int:
    """Bounded restart budget before giving up with today's fail-stop
    diagnostics (PATHWAY_MESH_MAX_RESTARTS, default 2)."""
    return int(os.environ.get("PATHWAY_MESH_MAX_RESTARTS", "2") or 2)


def rank_vars(n: int, pid: int) -> dict[str, str]:
    """The process-group variables of rank ``pid`` in a group of ``n`` on
    one host: the reference's ``PATHWAY_PROCESSES``/``PATHWAY_PROCESS_ID``
    and what ``torch.distributed`` reads."""
    return {
        "PATHWAY_PROCESSES": str(n),
        "PATHWAY_PROCESS_ID": str(pid),
        "WORLD_SIZE": str(n),
        "LOCAL_WORLD_SIZE": str(n),
        "RANK": str(pid),
        "LOCAL_RANK": str(pid),
    }


class GroupSupervisor:
    """Spawn-and-respawn an N-rank process group.

    ``argv`` is the per-rank command line; each rank runs it with
    PATHWAY_PROCESSES / PATHWAY_PROCESS_ID / PATHWAY_MESH_INCARNATION and
    the ``torch.distributed`` variables of :func:`rank_vars` set (plus
    ``env`` overrides, applied to every rank; ``rank_env`` may add per-rank
    variables). A group where every rank exits 0 is done; any nonzero (or
    signaled) rank kills the survivors and — if the restart budget allows
    — respawns the whole group.
    """

    def __init__(
        self,
        argv: list[str],
        n: int,
        *,
        env: Mapping[str, str] | None = None,
        rank_env: Callable[[int], Mapping[str, str] | None] | None = None,
        max_restarts: int | None = None,
        grace_s: float = 5.0,
        backoff_s: float = 0.25,
        poll_s: float = 0.05,
        log_dir: str | None = None,
        initial_incarnation: int = 0,
    ):
        self.argv = list(argv)
        self.n = int(n)
        self.env = dict(env or {})
        self.rank_env = rank_env
        # a standby-writer takeover spawns the writer role starting at
        # the FENCED incarnation (one past everything the plane has
        # seen) so the PWRP2 handshake token outranks any zombie; the
        # restart budget still counts from zero
        self.initial_incarnation = int(initial_incarnation)
        self.max_restarts = max_restarts_env() if max_restarts is None else int(max_restarts)
        self.grace_s = grace_s
        self.backoff_s = backoff_s
        self.poll_s = poll_s
        self.log_dir = log_dir
        self.restarts_used = 0
        self.events: list[tuple[float, str, str]] = []
        self.last_codes: list[int | None] = []
        self._rng = random.Random(0xF0E1)
        self._stop = threading.Event()
        # Shard Flux: a pending live resize — (new rank count, reshard
        # callback) consumed by the run loop at the next poll
        self._resize: tuple[int, Callable[[], Any] | None] | None = None
        self._resize_ev = threading.Event()

    def resize(self, m: int, *, reshard: Callable[[], Any] | None = None):
        """Live elastic resize (Shard Flux): ask a running :meth:`run`
        loop to grow/shrink the group to ``m`` ranks WITHOUT the
        log-replay fallback. The loop terminates the current group at its
        next poll (phase-1 freeze: DCN groups commit durably every
        lockstep tick, so the cut is a group-committed state), runs the
        ``reshard`` callback (the transfer phase — moving each
        arrangement's moved key ranges to their new owners' stores), then
        respawns ``m`` ranks under a BUMPED incarnation (phase-2 commit:
        zombies of the old topology present a stale incarnation and are
        fenced by the existing checks). A reshard callback that RAISES
        rolls the resize back: the old rank count respawns and the old
        committed state still rules — bounded pause either way. The
        respawn does not consume the restart budget."""
        self._resize = (int(m), reshard)
        self._resize_ev.set()

    def _apply_resize(self, incarnation: int) -> int:
        """Run the transfer phase + commit the new size; returns the next
        incarnation (always bumped — even a rollback restarts the group,
        and stale ranks must be fenced)."""
        m, reshard = self._resize
        self._resize = None
        self._resize_ev.clear()
        old_n = self.n
        try:
            if reshard is not None:
                reshard()
            self.n = int(m)
            self._event("group-resize", f"{old_n} -> {self.n} ranks")
        except Exception as e:
            # rollback: the old ownership map was never superseded —
            # respawn at the old size and surface the cause
            self._event(
                "resize-rollback",
                f"reshard {old_n} -> {m} failed ({e}); staying at {old_n} ranks",
            )
        return incarnation + 1

    def stop(self) -> None:
        """Ask a running :meth:`run` loop (e.g. on another thread) to
        SIGTERM the current group and return. A group whose ranks serve
        until terminated (read replicas) has no natural all-exited-0 end,
        so the owner drives shutdown explicitly."""
        self._stop.set()

    def _event(self, kind: str, detail: str) -> None:
        self.events.append((time.monotonic(), kind, detail))
        # mirror into the Fleet Lens incident journal — rank-died /
        # group-restart / group-resize are the supervisor's side of the
        # fleet timeline (rank-died persists: it is a peer's record of a
        # SIGKILLed member)
        from pathway_tpu_torch.observability.journal import record as journal_record

        journal_record(
            f"group-{kind}" if not kind.startswith(("group", "rank")) else kind,
            detail,
            persist=kind in ("rank-died", "gave-up", "resize-rollback"),
        )

    def _spawn_group(self, incarnation: int) -> list[subprocess.Popen]:
        from pathway_tpu_torch.internals.monitoring_server import BASE_PORT

        procs: list[subprocess.Popen] = []
        for pid in range(self.n):
            env = dict(os.environ)
            env.update(self.env)
            env.update(rank_vars(self.n, pid))
            env["PATHWAY_MESH_INCARNATION"] = str(incarnation)
            # Fleet Lens: every rank knows the whole group's monitoring
            # ports, so ANY rank's /fleet/* federates the group (an
            # explicit member map wins)
            env.setdefault(
                "PATHWAY_FLEET_MEMBERS",
                ",".join(f"rank-{i}=http://127.0.0.1:{BASE_PORT + i}" for i in range(self.n)),
            )
            if self.rank_env is not None:
                env.update(self.rank_env(pid) or {})
            stdout = None
            if self.log_dir is not None:
                os.makedirs(self.log_dir, exist_ok=True)
                stdout = open(os.path.join(self.log_dir, f"rank{pid}-inc{incarnation}.log"), "ab")
            procs.append(
                subprocess.Popen(
                    self.argv,
                    env=env,
                    stdout=stdout,
                    stderr=subprocess.STDOUT if stdout is not None else None,
                )
            )
            if stdout is not None:
                stdout.close()  # the child holds its own fd now
        self._event("group-start", f"incarnation {incarnation}")
        return procs

    def _terminate(self, procs: list[subprocess.Popen]) -> None:
        """SIGTERM the survivors, escalate to SIGKILL after the grace
        period — a wedged rank must not block the restart."""
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + self.grace_s
        for p in procs:
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(self.poll_s)
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
                p.wait()

    def run(self) -> int:
        incarnation = self.initial_incarnation
        while True:
            procs = self._spawn_group(incarnation)
            failed: int | None = None
            resized = False
            while True:
                if self._stop.is_set():
                    self._terminate(procs)
                    self.last_codes = [p.returncode for p in procs]
                    self._event("group-stopped", f"incarnation {incarnation}")
                    return 0
                if self._resize_ev.is_set():
                    # phase-1 freeze: stop the group at this poll (each
                    # lockstep tick is durably committed, so the cut is a
                    # group-committed state), move state, respawn at the
                    # new size under a bumped incarnation
                    self._terminate(procs)
                    self.last_codes = [p.returncode for p in procs]
                    incarnation = self._apply_resize(incarnation)
                    resized = True
                    break
                codes = [p.poll() for p in procs]
                bad = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = bad[0][0]
                    self._event(
                        "rank-died",
                        f"rank {bad[0][0]} exited {bad[0][1]} (incarnation {incarnation})",
                    )
                    break
                if all(c == 0 for c in codes):
                    self.last_codes = codes
                    self._event("group-done", f"incarnation {incarnation}")
                    return 0
                time.sleep(self.poll_s)
            if resized:
                continue  # respawn at the new size, budget untouched
            self._terminate(procs)
            self.last_codes = [p.returncode for p in procs]
            if self.restarts_used >= self.max_restarts:
                self._event(
                    "gave-up",
                    f"restart budget exhausted ({self.restarts_used}/{self.max_restarts}); rank "
                    f"{failed} last exit {self.last_codes[failed] if failed is not None else '?'}",
                )
                # propagate the code of the rank that CAUSED the give-up —
                # a survivor we ourselves SIGTERMed would otherwise mask it
                # with -15
                if failed is not None and self.last_codes[failed] not in (0, None):
                    return self.last_codes[failed]
                return next((c for c in self.last_codes if c not in (0, None)), 1)
            self.restarts_used += 1
            incarnation += 1
            delay = min(5.0, self.backoff_s * (2 ** (self.restarts_used - 1)))
            delay *= 0.5 + self._rng.random()
            self._event(
                "group-restart",
                f"restart {self.restarts_used}/{self.max_restarts} in {delay:.2f}s "
                f"(incarnation {incarnation})",
            )
            time.sleep(delay)


def main(argv: list[str] | None = None) -> int:
    import argparse
    import secrets

    parser = argparse.ArgumentParser(
        prog="python -m pathway_tpu_torch.parallel.supervisor",
        description="run an N-rank DCN group under the Phoenix Mesh restart supervisor",
    )
    parser.add_argument("--processes", "-n", type=int, default=2)
    parser.add_argument("--max-restarts", type=int, default=None)
    parser.add_argument("--log-dir", default=None)
    args, extra = parser.parse_known_args(argv)
    if extra and extra[0] == "--":
        extra = extra[1:]
    if not extra:
        print("nothing to run", file=sys.stderr)
        return 2
    env = {}
    if "PATHWAY_DCN_SECRET" not in os.environ:
        env["PATHWAY_DCN_SECRET"] = secrets.token_hex(32)
    sup = GroupSupervisor(
        extra,
        args.processes,
        env=env,
        max_restarts=args.max_restarts,
        log_dir=args.log_dir,
    )
    rc = sup.run()
    for ts, kind, detail in sup.events:
        print(f"[supervisor +{ts - sup.events[0][0]:8.3f}s] {kind}: {detail}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
