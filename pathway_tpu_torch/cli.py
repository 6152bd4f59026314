"""``python -m pathway_tpu_torch.cli`` — the multi-process launcher and the
record/replay flags, the port's own copy of ``pathway_tpu/cli.py``.

As the reference CLI (upstream Pathway: python/pathway/cli.py — `pathway
spawn` launches N OS processes with PATHWAY_PROCESSES/PATHWAY_PROCESS_ID/
PATHWAY_FIRST_PORT; `--record`/`--replay_mode` set PATHWAY_REPLAY_STORAGE /
PATHWAY_SNAPSHOT_ACCESS), ``spawn`` sets the same ``PATHWAY_*`` env on every
process and a fresh ``PATHWAY_DCN_SECRET`` per job. Where the JAX package
sets the ``JAX_*`` coordinator variables and ``XLA_FLAGS``, this one sets
what ``torch.distributed`` reads: ``MASTER_ADDR``/``MASTER_PORT`` (the
coordinator at PATHWAY_FIRST_PORT), ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``
and ``LOCAL_WORLD_SIZE``. ``--backend gloo`` names the device group's
backend for ranks that share one card (``PATHWAY_DIST_BACKEND``; NCCL, the
default on cards, refuses two ranks on one card).

Every child is started with ``subprocess`` (never forked), and a spawn that
ends — normally, on a signal or on ``--timeout`` — kills the children still
running. ``--supervise`` runs the group under the Phoenix Mesh restart
supervisor (``parallel/supervisor.py``): a dead rank tears the group down
and the whole group respawns, from the latest group-committed snapshot
generation, up to ``--max-restarts`` times; each incarnation's ranks get
their ``torch.distributed`` variables from the supervisor (one rule with
:func:`rank_env`). ``--timeout`` and SIGTERM stop the supervisor, and with
it every rank.
"""

from __future__ import annotations

import argparse
import os
import secrets
import signal
import subprocess
import sys
import threading
import time

from pathway_tpu_torch.parallel.supervisor import GroupSupervisor, rank_vars


def _env_base(args) -> dict:
    n = args.processes
    env = dict(os.environ)
    env["PATHWAY_PROCESSES"] = str(n)
    # per-job shared secret authenticating host-mesh frames (HMAC); see
    # parallel/host_exchange.py
    env.setdefault("PATHWAY_DCN_SECRET", secrets.token_hex(32))
    env["PATHWAY_THREADS"] = str(args.threads)
    env["PATHWAY_FIRST_PORT"] = str(args.first_port)
    # -t T workers = T engine key-shards over the device mesh (reference:
    # PATHWAY_THREADS timely workers per process, config.rs:88-121; here
    # engine/sharded.py execs)
    if args.threads > 1:
        env["PATHWAY_ENGINE_SHARDS"] = str(args.threads)
    if args.record:
        env["PATHWAY_REPLAY_STORAGE"] = args.record_path
        env["PATHWAY_SNAPSHOT_ACCESS"] = "record"
    elif args.replay_mode:
        env["PATHWAY_REPLAY_STORAGE"] = args.record_path
        env["PATHWAY_SNAPSHOT_ACCESS"] = args.replay_mode
    # the torch.distributed rendezvous (parallel/distributed.py): one host,
    # the coordinator at PATHWAY_FIRST_PORT
    env.setdefault("MASTER_ADDR", "127.0.0.1")
    env.setdefault("MASTER_PORT", str(args.first_port))
    if args.backend:
        env["PATHWAY_DIST_BACKEND"] = args.backend
    return env


def rank_env(env_base: dict, pid: int) -> dict:
    """One rank's env: the group's plus its process id, ranks and world
    size (``parallel.supervisor.rank_vars``, the supervisor's own rule)."""
    env = dict(env_base)
    env.update(rank_vars(int(env_base["PATHWAY_PROCESSES"]), pid))
    return env


def _stop(procs: list[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def _spawn(args, extra: list[str]) -> int:
    n = args.processes
    env_base = _env_base(args)
    if extra and extra[0] == "--":
        extra = extra[1:]
    if not extra:
        print("nothing to run", file=sys.stderr)
        return 2
    if getattr(args, "supervise", False):
        return _supervise(args, extra, env_base)
    procs: list[subprocess.Popen] = []
    deadline = time.monotonic() + args.timeout if args.timeout else None

    def _on_signal(signum, _frame):
        _stop(procs)
        raise SystemExit(128 + signum)

    main_thread = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGTERM, _on_signal) if main_thread else None
    try:
        for pid in range(n):
            procs.append(subprocess.Popen(extra, env=rank_env(env_base, pid)))
        # wait for every rank; a spawn past its deadline kills the group
        while any(p.poll() is None for p in procs):
            if deadline is not None and time.monotonic() > deadline:
                print(f"spawn: --timeout {args.timeout}s passed; killing the group", file=sys.stderr)
                _stop(procs)
                return 124
            time.sleep(0.05)
        code = 0
        for pid, p in enumerate(procs):
            if p.returncode:
                print(f"spawn: rank {pid} exited {p.returncode}", file=sys.stderr, flush=True)
            code = p.returncode or code
        return code
    finally:
        _stop(procs)
        if main_thread:
            signal.signal(signal.SIGTERM, old)


def _supervise(args, extra: list[str], env_base: dict) -> int:
    """Phoenix Mesh: run the group under the restart supervisor — a dead
    rank tears the group down and the whole group respawns from the latest
    group-committed snapshot generation, up to ``--max-restarts`` (else
    PATHWAY_MESH_MAX_RESTARTS) times. The supervisor runs on a thread of
    its own, so that ``--timeout`` and SIGTERM can stop it (and with it
    every rank) from here."""
    sup = GroupSupervisor(extra, args.processes, env=env_base, max_restarts=args.max_restarts)
    rc: list[int] = []
    runner = threading.Thread(target=lambda: rc.append(sup.run()), name="pw-spawn-supervisor")
    deadline = time.monotonic() + args.timeout if args.timeout else None

    def _halt() -> None:
        sup.stop()
        runner.join()

    def _on_signal(signum, _frame):
        _halt()
        raise SystemExit(128 + signum)

    main_thread = threading.current_thread() is threading.main_thread()
    old = signal.signal(signal.SIGTERM, _on_signal) if main_thread else None
    try:
        runner.start()
        while runner.is_alive():
            if deadline is not None and time.monotonic() > deadline:
                print(f"spawn: --timeout {args.timeout}s passed; stopping the supervised group", file=sys.stderr)
                _halt()
                return 124
            runner.join(0.05)
        return rc[0] if rc else 1
    finally:
        if runner.is_alive():
            _halt()
        if main_thread:
            signal.signal(signal.SIGTERM, old)


def _spawn_from_env(args, extra: list[str]) -> int:
    """`spawn-from-env` — read the spawn arguments from PATHWAY_SPAWN_ARGS
    (reference: cli.py spawn-from-env, used by container entrypoints)."""
    spawn_args = os.environ.get("PATHWAY_SPAWN_ARGS", "").split()
    return main(["spawn", *spawn_args, "--", *extra] if extra else ["spawn", *spawn_args])


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m pathway_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("spawn", help="launch a program over N processes")
    sp.add_argument("--processes", "-n", type=int, default=1)
    sp.add_argument("--threads", "-t", type=int, default=1)
    sp.add_argument("--first-port", type=int, default=10000)
    sp.add_argument(
        "--supervise",
        action="store_true",
        help="restart the whole group on rank failure (Phoenix Mesh), up to --max-restarts times",
    )
    sp.add_argument("--max-restarts", type=int, default=None)
    sp.add_argument("--record", action="store_true")
    sp.add_argument("--record-path", default="./record")
    sp.add_argument(
        "--replay-mode", dest="replay_mode", choices=["replay", "full"], default=None
    )
    sp.add_argument(
        "--backend", choices=["gloo", "nccl"], default=None,
        help="the torch.distributed backend of the device group (PATHWAY_DIST_BACKEND): "
        "gloo for ranks that share one card or run on the CPU, nccl for one card a rank",
    )
    sp.add_argument(
        "--timeout", type=float, default=None,
        help="seconds after which the group is killed and spawn exits 124",
    )
    sub.add_parser("spawn-from-env", help="spawn with args from PATHWAY_SPAWN_ARGS")
    args, extra = parser.parse_known_args(argv)
    if args.command == "spawn":
        return _spawn(args, extra)
    if args.command == "spawn-from-env":
        return _spawn_from_env(args, extra)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
