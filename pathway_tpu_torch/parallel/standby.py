"""Standby writer — hot takeover of the ingest/delta-publishing role, the
port's own copy of ``pathway_tpu/parallel/standby.py``.

The replicated read plane has ONE serving single point of failure: the
writer. Kill it and every replica keeps answering, but the read plane goes
permanently stale — nothing publishes deltas, nothing snapshots, nothing
ingests. ``StandbyWriter`` closes that gap:

* **Shadow subscription** — the standby subscribes to the primary's
  delta stream exactly like a replica (``DeltaStreamClient`` with the
  reserved ``STANDBY_ID``; its leg carries the ``repl:standby`` wire
  channel so Fault Forge can target it) and PERSISTS its position
  (applied tick + highest incarnation seen) with an atomic tmp+rename,
  so a restarted standby knows where the stream was.

* **Death detection** — the primary is declared dead when the
  subscription stays disconnected for ``grace_s`` continuously (every
  redial failing — the analog of the mesh liveness timeout), or
  immediately when :meth:`notify_failure` is called (wire it to a
  ``HostMesh.add_failure_listener`` / ``FailoverRouter`` listener for
  detection-time takeover).

* **Takeover** — the standby re-opens the persistence store
  (``resume_point`` reads the newest committed generation + the
  group-commit barrier record), bumps ``PATHWAY_MESH_INCARNATION`` past
  every incarnation it has seen, and respawns the writer role (the
  supervised ``argv`` — the writer process itself restores the
  generation, replays the connector log tail, calls
  ``DeltaStreamServer.set_floor`` and resumes publishing on the SAME
  ``PATHWAY_REPL_PORT``). Replicas reconnect through the existing
  resync-from-floor path; the bumped incarnation in the ``PWRP2`` suback
  fences a zombie primary that comes back from the dead
  (parallel/replicate.py).

An in-process ``on_takeover`` callback replaces the subprocess spawn for
tests and embedded deployments.

``python -m pathway_tpu_torch.parallel.standby -- python writer.py`` runs
the env-configured standby role: PATHWAY_REPL_PORT names the primary's
delta endpoint; on takeover the argv is spawned under the Phoenix Mesh
supervisor (parallel/supervisor.py) with the bumped incarnation.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

from pathway_tpu_torch.parallel.replicate import STANDBY_ID, DeltaStreamClient


def grace_env() -> float:
    """Seconds of continuous primary unreachability before the standby
    takes over (PATHWAY_STANDBY_GRACE_MS, default 5000)."""
    raw = os.environ.get("PATHWAY_STANDBY_GRACE_MS", "5000") or "5000"
    try:
        ms = float(raw)
    except ValueError:
        raise ValueError(f"PATHWAY_STANDBY_GRACE_MS={raw!r} is not a number") from None
    return max(ms, 100.0) / 1000.0


class StandbyWriter:
    """Shadow the primary's delta stream; take over when it dies.

    ``on_takeover(standby) -> None`` runs the takeover (default: spawn
    ``argv`` under a 1-rank GroupSupervisor with
    ``PATHWAY_MESH_INCARNATION`` = ``next_incarnation()``). ``argv`` is the
    writer role's command line; ``env`` extends its environment.
    ``store_root`` (optional) lets the standby log the persistence resume
    point it is handing the new writer.
    """

    def __init__(
        self,
        writer_host: str = "127.0.0.1",
        writer_port: int | None = None,
        *,
        endpoints: list[tuple[str, int]] | None = None,
        argv: list[str] | None = None,
        env: dict[str, str] | None = None,
        store_root: str | None = None,
        position_path: str | None = None,
        on_takeover: Callable[["StandbyWriter"], None] | None = None,
        grace_s: float | None = None,
        poll_s: float = 0.2,
    ):
        if endpoints is None:
            if writer_port is None:
                raise ValueError("StandbyWriter needs writer_port or endpoints")
            endpoints = [(writer_host, int(writer_port))]
        self.endpoints = endpoints
        self.argv = list(argv) if argv else None
        self.env = dict(env or {})
        self.store_root = store_root
        self.position_path = position_path
        self.on_takeover = on_takeover
        self.grace_s = grace_env() if grace_s is None else float(grace_s)
        self.poll_s = poll_s
        self.applied_tick = -1
        self.seen_incarnation = int(os.environ.get("PATHWAY_MESH_INCARNATION", "0") or 0)
        self.took_over = False
        self.takeover_count = 0
        self.takeover_incarnation: int | None = None
        self._position_written_at = -1.0e9
        self.events: list[tuple[float, str, str]] = []
        self._restore_position()
        self._closed = False
        self._failure = threading.Event()
        self._took_over_ev = threading.Event()
        self._lock = threading.Lock()
        self._client: DeltaStreamClient | None = None
        self._monitor: threading.Thread | None = None
        self._sup: Any = None  # GroupSupervisor after a spawn takeover
        self._sup_thread: threading.Thread | None = None

    # --- position persistence ---------------------------------------------

    def _restore_position(self) -> None:
        if not self.position_path or not os.path.exists(self.position_path):
            return
        try:
            with open(self.position_path) as f:
                pos = json.load(f)
            self.applied_tick = int(pos.get("applied_tick", -1))
            self.seen_incarnation = max(self.seen_incarnation, int(pos.get("incarnation", 0)))
        except (OSError, ValueError):
            pass  # a torn position file only costs a deeper resubscribe

    def _persist_position(self, force: bool = False) -> None:
        """Throttled (0.5 s) atomic write: the position's only consumer is
        a restarted standby, which tolerates a stale value (it just
        resubscribes a little deeper) — a write per applied tick would be
        pure filesystem churn on the shadow's apply path. Takeover forces
        the write (the fenced incarnation must be durable)."""
        if not self.position_path:
            return
        now = time.monotonic()
        if not force and now - self._position_written_at < 0.5:
            return
        self._position_written_at = now
        tmp = self.position_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"applied_tick": self.applied_tick, "incarnation": self.seen_incarnation}, f)
            os.replace(tmp, self.position_path)
        except OSError:
            pass

    def next_incarnation(self) -> int:
        """The incarnation the takeover writer must publish under: one past
        everything this standby (or its persisted position) has seen, so
        the PWRP2 fencing token outranks any zombie. Stable once a takeover
        is in flight — the on_takeover callback may call it again."""
        if self.takeover_incarnation is not None:
            return self.takeover_incarnation
        return self.seen_incarnation + 1

    # --- lifecycle ---------------------------------------------------------

    def _event(self, kind: str, detail: str) -> None:
        self.events.append((time.monotonic(), kind, detail))
        # mirror into the Fleet Lens incident journal: standby-start /
        # failure-notified / takeover are exactly the records peers use to
        # reconstruct a SIGKILLed primary's death (persist=True — a
        # takeover record must survive the standby dying right after)
        from pathway_tpu_torch.observability.journal import record as journal_record

        journal_record(
            f"standby-{kind}" if not kind.startswith("standby") else kind,
            detail,
            tick=self.applied_tick if self.applied_tick >= 0 else None,
            incarnation=self.seen_incarnation,
            persist=kind in ("takeover", "failure-notified"),
        )

    def start(self) -> "StandbyWriter":
        self._client = DeltaStreamClient(
            self.endpoints[0][0],
            self.endpoints[0][1],
            STANDBY_ID,
            from_tick=self.applied_tick,
            on_deltas=self._on_deltas,
            endpoints=self.endpoints,
            connect_timeout=3600.0,
        )
        self._client.start()
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True, name="pw-standby")
        self._monitor.start()
        self._event("standby-start", f"shadowing {self.endpoints[0]}")
        return self

    def stop(self) -> None:
        self._closed = True
        self._failure.set()
        self._persist_position(force=True)  # flush the throttle
        if self._client is not None:
            self._client.close()
        if self._sup is not None:
            self._sup.stop()
        if self._sup_thread is not None:
            self._sup_thread.join(timeout=30)

    def _on_deltas(self, tick: int, batches: list) -> None:
        self.applied_tick = tick
        c = self._client
        if c is not None:
            self.seen_incarnation = max(self.seen_incarnation, c.writer_incarnation)
        self._persist_position()

    def notify_failure(self, peer: Any = None, reason: str = "") -> None:
        """External death signal (mesh failure listener / router ejection
        callback): skip the disconnect grace window and take over now."""
        if not self._closed:
            self._event("failure-notified", f"{peer}: {reason}")
            self._failure.set()

    # --- death detection + takeover ----------------------------------------

    def _monitor_loop(self) -> None:
        # the grace clock only runs AFTER the primary has been reached at
        # least once this life (or a persisted position proves a past
        # life): a standby booted before/alongside its primary must not
        # usurp a merely slow boot — the bumped incarnation would fence
        # the legitimate writer forever. An explicit notify_failure()
        # (mesh/router listener) bypasses the gate. An applied tick is
        # contact too: a link that came and went between two polls still
        # counts (the reference reads the flag only at its polls, so a
        # primary that dies within a poll of the first contact is never
        # taken over)
        ever_connected = self.applied_tick >= 0
        disconnected_since: float | None = None
        while not self._closed:
            if self._failure.wait(self.poll_s):
                if self._closed:
                    return
                self._takeover("external failure notification")
                return
            c = self._client
            if c is None:
                continue
            if c.connected:
                ever_connected = True
                disconnected_since = None
                self.seen_incarnation = max(self.seen_incarnation, c.writer_incarnation)
                continue
            if not ever_connected and self.applied_tick < 0:
                continue
            now = time.monotonic()
            if disconnected_since is None:
                disconnected_since = now
            elif now - disconnected_since >= self.grace_s:
                self._takeover(f"primary unreachable for {now - disconnected_since:.1f}s")
                return

    def _takeover(self, reason: str) -> None:
        with self._lock:
            if self.took_over or self._closed:
                return
            self.took_over = True
        from pathway_tpu_torch.observability.tracing import get_tracer

        with get_tracer().span("standby.takeover", root=True, reason=reason):
            self._takeover_locked(reason)

    def _takeover_locked(self, reason: str) -> None:
        self.takeover_count += 1
        inc = self.seen_incarnation + 1
        self.takeover_incarnation = inc
        self.seen_incarnation = inc
        self._persist_position(force=True)
        if self._client is not None:
            self._client.close()
        detail = f"{reason}; resuming as incarnation {inc}"
        if self.store_root is not None:
            try:
                from pathway_tpu_torch.persistence._runtime_glue import resume_point
                from pathway_tpu_torch.persistence.backends import FilesystemStore

                rp = resume_point(FilesystemStore(self.store_root))
                detail += (
                    f"; store resume point: generation time {rp['state_time']}, group-commit barrier "
                    f"{rp['group_commit_time']}, log tail to {rp['last_time']}"
                )
            except Exception as exc:
                detail += f"; resume-point read failed: {exc}"
        self._event("takeover", detail)
        import logging

        logging.getLogger("pathway_tpu_torch").warning("standby writer: taking over (%s)", detail)
        if self.on_takeover is not None:
            self.on_takeover(self)
        elif self.argv:
            self._spawn_writer(inc)
        self._took_over_ev.set()

    def _spawn_writer(self, incarnation: int) -> None:
        """Default takeover: respawn the writer role under a 1-rank Phoenix
        Mesh supervisor starting at the fenced incarnation. The writer's own
        boot restores the newest committed generation, replays the
        connector log from the group-commit barrier, floors the delta ring,
        and resumes publishing."""
        from pathway_tpu_torch.parallel.supervisor import GroupSupervisor

        env = dict(self.env)
        self._sup = GroupSupervisor(self.argv, 1, env=env, initial_incarnation=incarnation)
        self._sup_thread = threading.Thread(target=self._sup.run, daemon=True, name="pw-standby-writer")
        self._sup_thread.start()

    def wait_takeover(self, timeout: float | None = None) -> bool:
        return self._took_over_ev.wait(timeout)


def main(argv: list[str] | None = None) -> int:
    import argparse
    import signal
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m pathway_tpu_torch.parallel.standby",
        description="shadow a replication writer's delta stream and respawn the writer role (the "
        "trailing argv) on primary death",
    )
    parser.add_argument("--writer-host", default=os.environ.get("PATHWAY_REPL_WRITER_HOST", "127.0.0.1"))
    parser.add_argument("--writer-port", type=int, default=int(os.environ.get("PATHWAY_REPL_PORT", "0") or 0))
    parser.add_argument("--store-root", default=os.environ.get("PATHWAY_REPLICA_STORE") or None)
    parser.add_argument("--position-file", default=None)
    args, extra = parser.parse_known_args(argv)
    if extra and extra[0] == "--":
        extra = extra[1:]
    if not args.writer_port:
        print("no writer port (set PATHWAY_REPL_PORT)", file=sys.stderr)
        return 2
    if not extra:
        print("nothing to take over with (pass -- <writer argv>)", file=sys.stderr)
        return 2
    standby = StandbyWriter(
        args.writer_host,
        args.writer_port,
        argv=extra,
        store_root=args.store_root,
        position_path=args.position_file,
    ).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())
    signal.signal(signal.SIGINT, lambda *_a: stop.set())
    print("STANDBY-READY", flush=True)
    while not stop.is_set():
        if standby.took_over and standby._sup_thread is not None:
            # after a takeover the standby process IS the writer's
            # supervisor: stay alive for its lifetime
            stop.wait(0.5)
        else:
            stop.wait(0.2)
    standby.stop()
    for ts, kind, detail in standby.events:
        print(f"[standby] {kind}: {detail}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
