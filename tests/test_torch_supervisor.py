"""The port's group supervisor (``parallel/supervisor.py``) held against the
JAX package's on the CPU.

* The reference's supervisor cases as port cases, with the outcome equal in
  both packages: a restart then success, an exhausted budget returning the
  failed rank's code, the env budget, the fleet members stamped into every
  rank and the journal's lifecycle records.
* The event kinds, in order, for one child script under both packages'
  ``GroupSupervisor``: done, one restart, budget exhausted, ``stop()``, and
  a ``resize`` whose callback succeeds and one whose callback raises; the
  restart counts and return codes are equal too.
* The env of each incarnation (port only): after ``resize(3)`` every rank
  sees ``PATHWAY_PROCESSES``, ``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE`` = 3
  and its own ``RANK``/``LOCAL_RANK``; a device group on gloo whose
  rendezvous host died rejoins the same ``MASTER_PORT`` in the next
  incarnation.
* The reference's supervised kill mid-tick (Fault Forge kills rank 1 at the
  tail of a data tick; the whole group restarts): in both packages the
  folded outputs equal the uninterrupted run's.
* Mixed packages: a port group supervised after a JAX-package group died
  resumes from the group's stores.

Every group has a deadline and its children are killed when it ends. Keys
and values are compared exactly."""

from __future__ import annotations

import json
import os
import sys
import textwrap
import threading
import time

import pytest

from pathway_tpu_torch.testing.chaos import fold_diff_stream, free_dcn_port
from torch_group import PRELUDE, ROOT
from torch_repl_parity import wait

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
FAULT_EXIT = 23  # testing/faults.py, both packages


def _sup_cls(pkg: str):
    import importlib

    return importlib.import_module(f"{pkg}.parallel.supervisor").GroupSupervisor


def _run_bounded(sup, timeout: float = 90.0) -> int:
    """``sup.run()`` on a thread with a deadline; a supervisor still running
    at the deadline is stopped (its ranks with it) and the test fails."""
    rc: list[int] = []
    runner = threading.Thread(target=lambda: rc.append(sup.run()), daemon=True)
    runner.start()
    runner.join(timeout)
    if runner.is_alive():
        sup.stop()
        runner.join(30)
        raise AssertionError(f"the supervisor did not finish within {timeout}s: {sup.events}")
    return rc[0]


def _kinds(sup) -> list[str]:
    return [k for _ts, k, _d in sup.events]


# --- the reference's cases (tests/test_faults.py, test_observability.py) ---

_SUP_CHILD = (
    "import os,sys;"
    "inc=int(os.environ.get('PATHWAY_MESH_INCARNATION','0'));"
    "sys.exit(23 if inc==0 else 0)"
)


def _restart_once(pkg: str):
    sup = _sup_cls(pkg)([sys.executable, "-c", _SUP_CHILD], 2, max_restarts=2, backoff_s=0.05, poll_s=0.02)
    rc = _run_bounded(sup)
    kinds = _kinds(sup)
    return rc, sup.restarts_used, "rank-died" in kinds and "group-restart" in kinds, kinds[-1]


def _budget_exhausted(pkg: str):
    sup = _sup_cls(pkg)([sys.executable, "-c", "import sys; sys.exit(23)"], 2, max_restarts=1, backoff_s=0.05,
                        poll_s=0.02)
    rc = _run_bounded(sup)
    kinds = _kinds(sup)
    return rc, sup.restarts_used, kinds[-1], kinds.count("rank-died")


def _env_budget(pkg: str):
    import importlib

    mod = importlib.import_module(f"{pkg}.parallel.supervisor")
    old = os.environ.get("PATHWAY_MESH_MAX_RESTARTS")
    os.environ["PATHWAY_MESH_MAX_RESTARTS"] = "7"
    try:
        return mod.max_restarts_env()
    finally:
        if old is None:
            os.environ.pop("PATHWAY_MESH_MAX_RESTARTS")
        else:
            os.environ["PATHWAY_MESH_MAX_RESTARTS"] = old


def _fleet_members(pkg: str, tmp_path):
    import importlib

    journal = importlib.import_module(f"{pkg}.observability.journal")
    logs = tmp_path / pkg
    sup = _sup_cls(pkg)([sys.executable, "-c", "import os; print(os.environ['PATHWAY_FLEET_MEMBERS'])"], n=2,
                        max_restarts=0, log_dir=str(logs))
    rc = _run_bounded(sup)
    kinds = [e["kind"] for e in journal.journal().events()]
    printed = [(logs / f"rank{p}-inc0.log").read_text().strip() for p in range(2)]
    return rc, "group-start" in kinds and "group-done" in kinds, printed


REFERENCE_CASES = {
    # tests/test_faults.py:134
    "restarts_group_once_then_succeeds": (_restart_once, (0, 1, True, "group-done")),
    # tests/test_faults.py:151
    "budget_exhausted_propagates_failure": (_budget_exhausted, (23, 1, "gave-up", 2)),
    # tests/test_faults.py:190
    "env_budget": (_env_budget, 7),
}


@pytest.mark.parametrize("name", sorted(REFERENCE_CASES))
def test_reference_case_equal_in_both_packages(name):
    scenario, want = REFERENCE_CASES[name]
    got = {pkg: scenario(pkg) for pkg in PACKAGES}
    assert got["pathway_tpu_torch"] == got["pathway_tpu"] == want, got


def test_supervisor_stamps_fleet_members_into_rank_env(tmp_path):
    """tests/test_observability.py:687 as a port case: every rank sees the
    whole group's monitoring ports, and the journal mirrors the
    supervisor's lifecycle, in both packages."""
    got = {pkg: _fleet_members(pkg, tmp_path) for pkg in PACKAGES}
    members = ",".join(f"rank-{i}=http://127.0.0.1:{20000 + i}" for i in range(2))
    assert got["pathway_tpu_torch"] == got["pathway_tpu"] == (0, True, [members, members]), got


# --- the event kinds, in order, under both packages ------------------------

# PW_MODE: "ok" exits 0; "die" exits 23 in incarnation 0, then 0; "fail"
# always exits 23; "serve" runs until terminated in incarnation 0 (so stop()
# and resize() meet a live group), then exits 0
_LIFE_CHILD = (
    "import os,sys,time;"
    "inc=int(os.environ.get('PATHWAY_MESH_INCARNATION','0'));"
    "mode=os.environ['PW_MODE'];"
    "time.sleep(120) if inc==0 and mode=='serve' else None;"
    "sys.exit(23 if mode=='fail' or (inc==0 and mode=='die') else 0)"
)


def _lifecycle(pkg: str, case: str):
    mode = {"done": "ok", "one_restart": "die", "budget_exhausted": "fail"}.get(case, "serve")
    sup = _sup_cls(pkg)([sys.executable, "-c", _LIFE_CHILD], 2, env={"PW_MODE": mode}, max_restarts=1,
                        backoff_s=0.05, poll_s=0.02, grace_s=5.0)
    rc: list[int] = []
    runner = threading.Thread(target=lambda: rc.append(sup.run()), daemon=True)
    runner.start()
    try:
        if mode == "serve":
            assert wait(lambda: "group-start" in _kinds(sup), timeout=30)
            time.sleep(0.3)  # the ranks are up
            if case == "stop":
                sup.stop()
            else:
                def reshard():
                    if case == "resize_raises":
                        raise RuntimeError("ferry refused")

                sup.resize(3, reshard=reshard)
        runner.join(90)
        assert not runner.is_alive(), sup.events
    finally:
        if runner.is_alive():
            sup.stop()
            runner.join(30)
    return {"kinds": _kinds(sup), "rc": rc[0], "restarts_used": sup.restarts_used, "n": sup.n,
            "codes": sorted(sup.last_codes, key=lambda c: (c is None, c))}


LIFECYCLE = {
    "done": {"kinds": ["group-start", "group-done"], "rc": 0, "restarts_used": 0, "n": 2, "codes": [0, 0]},
    "one_restart": {"kinds": ["group-start", "rank-died", "group-restart", "group-start", "group-done"],
                    "rc": 0, "restarts_used": 1, "n": 2, "codes": [0, 0]},
    "budget_exhausted": {"kinds": ["group-start", "rank-died", "group-restart", "group-start", "rank-died",
                                   "gave-up"], "rc": 23, "restarts_used": 1, "n": 2, "codes": [23, 23]},
    "stop": {"kinds": ["group-start", "group-stopped"], "rc": 0, "restarts_used": 0, "n": 2, "codes": [-15, -15]},
    "resize": {"kinds": ["group-start", "group-resize", "group-start", "group-done"], "rc": 0,
               "restarts_used": 0, "n": 3, "codes": [0, 0, 0]},
    "resize_raises": {"kinds": ["group-start", "resize-rollback", "group-start", "group-done"], "rc": 0,
                      "restarts_used": 0, "n": 2, "codes": [0, 0]},
}


@pytest.mark.parametrize("case", list(LIFECYCLE))
def test_event_kinds_equal_in_both_packages(case):
    """One child script under each package's ``GroupSupervisor``: the same
    events in the same order, the same restart count, return code, size
    and rank exit codes (a rank both ranks exit 23 in the budget case: the
    survivor's code is its own, never the −15 of a SIGTERM)."""
    got = {pkg: _lifecycle(pkg, case) for pkg in PACKAGES}
    if case == "budget_exhausted":
        # which rank the poll meets first is a race; each exits 23 itself
        for g in got.values():
            g["codes"] = [c if c != -15 else 23 for c in g["codes"]]
    assert got["pathway_tpu_torch"] == got["pathway_tpu"] == LIFECYCLE[case], got


# --- the env of each incarnation (port only) --------------------------------

_ENV_CHILD = textwrap.dedent(
    """
    import json, os, pathlib, sys, time
    keys = ("PATHWAY_PROCESSES", "PATHWAY_PROCESS_ID", "PATHWAY_MESH_INCARNATION", "WORLD_SIZE",
            "LOCAL_WORLD_SIZE", "RANK", "LOCAL_RANK")
    inc, pid = os.environ["PATHWAY_MESH_INCARNATION"], os.environ["PATHWAY_PROCESS_ID"]
    out = pathlib.Path(os.environ["PW_OUT"]) / f"inc{inc}_rank{pid}.json"
    out.write_text(json.dumps({k: os.environ.get(k) for k in keys}))
    if inc == "0":
        time.sleep(120)  # serve until the resize terminates the group
    """
)


def test_resize_sets_the_torch_distributed_env_of_the_new_size(tmp_path):
    """After ``resize(3)`` each of the 3 ranks sees the new size in
    ``PATHWAY_PROCESSES``, ``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE`` and its
    id in ``RANK``/``LOCAL_RANK``, even where the caller's env names the
    old size (as ``cli spawn``'s did)."""
    from pathway_tpu_torch.parallel.supervisor import GroupSupervisor

    script = tmp_path / "env.py"
    script.write_text(_ENV_CHILD)
    stale = {"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2", "PATHWAY_PROCESSES": "2", "PW_OUT": str(tmp_path)}
    sup = GroupSupervisor([sys.executable, str(script)], 2, env=stale, backoff_s=0.05, poll_s=0.02)
    runner = threading.Thread(target=sup.run, daemon=True)
    runner.start()
    try:
        assert wait(lambda: all((tmp_path / f"inc0_rank{p}.json").exists() for p in range(2)), timeout=30)
        sup.resize(3)
        runner.join(60)
        assert not runner.is_alive(), sup.events
    finally:
        sup.stop()
        runner.join(30)
    for inc, n in ((0, 2), (1, 3)):
        for pid in range(n):
            got = json.loads((tmp_path / f"inc{inc}_rank{pid}.json").read_text())
            assert got == {"PATHWAY_PROCESSES": str(n), "PATHWAY_PROCESS_ID": str(pid),
                           "PATHWAY_MESH_INCARNATION": str(inc), "WORLD_SIZE": str(n),
                           "LOCAL_WORLD_SIZE": str(n), "RANK": str(pid), "LOCAL_RANK": str(pid)}, (inc, pid)
    assert not (tmp_path / "inc1_rank3.json").exists()


_REJOIN_CHILD = textwrap.dedent(
    """
    import os, sys, torch, torch.distributed as td
    from pathway_tpu_torch.parallel import distributed as dist
    inc, pid = int(os.environ["PATHWAY_MESH_INCARNATION"]), int(os.environ["PATHWAY_PROCESS_ID"])
    assert dist.maybe_initialize(device="cpu")
    x = torch.ones(1) * (pid + 1)
    td.all_reduce(x)
    sys.stdout.write(f"JOINED {inc} {pid} {int(x.item())} {os.environ['MASTER_PORT']}\\n")
    sys.stdout.flush()
    if inc == 0 and pid == 0:
        os._exit(23)  # the rank that hosts the rendezvous store dies
    if inc == 0:
        td.barrier()  # never completes: rank 0 is gone
    """
)


def test_next_incarnation_rejoins_the_same_rendezvous_port(tmp_path):
    """Every incarnation keeps ``MASTER_PORT``. Rank 0, which hosts the
    gloo group's rendezvous store, dies after joining; the survivor is
    terminated, and incarnation 1 binds and joins the same port at once
    (the store listens with ``SO_REUSEADDR``)."""
    from pathway_tpu_torch.parallel.supervisor import GroupSupervisor

    script = tmp_path / "rejoin.py"
    script.write_text(_REJOIN_CHILD)
    port = free_dcn_port(1)
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": "",
           "PATHWAY_DCN_TIMEOUT": "60"}
    sup = GroupSupervisor([sys.executable, str(script)], 2, env=env, max_restarts=1, backoff_s=0.05,
                          log_dir=str(tmp_path / "logs"))
    assert _run_bounded(sup, 150) == 0, sup.events
    assert _kinds(sup) == ["group-start", "rank-died", "group-restart", "group-start", "group-done"]
    assert "rank 0 exited 23" in sup.events[1][2]
    for pid in range(2):
        lines = [ln.split() for ln in (tmp_path / "logs" / f"rank{pid}-inc1.log").read_text().splitlines()
                 if ln.startswith("JOINED")]
        assert lines == [["JOINED", "1", str(pid), "3", str(port)]]


# --- the reference's supervised kill mid-tick (tests/test_distributed.py:802)

_DCN_CHAOS_WORKER = PRELUDE + textwrap.dedent(
    """
    inc = os.environ.get("PATHWAY_MESH_INCARNATION", "0")
    base = pathlib.Path(os.environ["PW_TEST_DIR"])
    in_dir = base / f"in{PID}"
    pdir = base / f"pstorage{PID}"
    out_file = base / f"out{PID}_inc{inc}.jsonl"
    stop_file = base / "STOP"

    class S(pw.Schema):
        k: str
        t: int
        v: int

    rows = pw.io.jsonlines.read(str(in_dir), schema=S, mode="streaming")
    r = rows.groupby(rows.k).reduce(rows.k, s=pw.reducers.sum(rows.v), cnt=pw.reducers.count())
    pw.io.jsonlines.write(r, str(out_file))

    def watch():
        while True:
            time.sleep(0.05)
            if stop_file.exists():
                rt = pw.internals.parse_graph.G.runtime
                if rt is not None:
                    rt.stop()
                return

    threading.Thread(target=watch, daemon=True).start()
    cfg = pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(str(pdir)),
        snapshot_every=int(os.environ.get("PW_SNAPSHOT_EVERY", "2")),
    )
    pw.run(persistence_config=cfg, autocommit_duration_ms=20)
    drv = getattr(pw.internals.parse_graph.G.runtime, "persistence_driver", None)
    print("REPLAYED %d" % (drv.replayed_events if drv else -1), flush=True)
    print("CLEAN-EXIT", flush=True)
    """
)


def _chaos_rows(i: int, pid: int) -> list[dict]:
    return [{"k": f"k{(i + j + pid) % 4}", "t": i, "v": i + j} for j in range(3)]


def _supervised_kill_mid_tick(pkg: str, tmp_path) -> dict:
    """The reference's driver: the first file up front, the rest only once
    the group's first output appears (a pre-written pile would collapse into
    one tick); a stopper ends the run once the fold converges."""
    base = tmp_path / pkg
    for pid in range(2):
        (base / f"in{pid}").mkdir(parents=True)
    script = tmp_path / f"worker_{pkg}.py"
    script.write_text(_DCN_CHAOS_WORKER)
    port = free_dcn_port(2)

    def write_rows(pid, fname, rows):
        with open(base / f"in{pid}" / fname, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")

    expected: dict = {}
    for i in range(6):
        for pid in range(2):
            for r in _chaos_rows(i, pid):
                cnt, s = expected.get((r["k"],), (0, 0))
                expected[(r["k"],)] = (cnt + 1, s + r["v"])
    outs = lambda: sorted(base.glob("out*_inc*.jsonl"))  # noqa: E731

    def trickler():
        for pid in range(2):
            write_rows(pid, "f0.jsonl", _chaos_rows(0, pid))
        wait(lambda: any(p.stat().st_size > 0 for p in base.glob("out*_inc0.jsonl")), timeout=90, interval=0.2)
        for i in range(1, 6):
            for pid in range(2):
                write_rows(pid, f"f{i}.jsonl", _chaos_rows(i, pid))
            time.sleep(0.4)

    def stopper():
        wait(lambda: fold_diff_stream(outs(), ["k"]) == expected, timeout=120, interval=0.25)
        (base / "STOP").touch()

    sup = _sup_cls(pkg)(
        [sys.executable, str(script)], 2,
        env={"PW_TEST_DIR": str(base), "PATHWAY_DCN_PORT": str(port), "PATHWAY_DCN_SECRET": f"chaos-secret-{port}",
             "PATHWAY_DCN_TIMEOUT": "60", "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": "", "PW_PKG": pkg,
             "PATHWAY_COMPILED_TICK": "0", "PYTHONPATH": ROOT, "PATHWAY_FAULTS": "kill=tick:3,pid:1,at:tail"},
        max_restarts=2, backoff_s=0.1, log_dir=str(base / "logs"))
    tr = threading.Thread(target=trickler, daemon=True)
    st = threading.Thread(target=stopper, daemon=True)
    tr.start()
    st.start()
    rc = _run_bounded(sup, 200)
    st.join(timeout=150)
    tr.join(timeout=10)
    logs = "\n".join(f"--- {p.name}\n{p.read_text()[-2000:]}" for p in sorted((base / "logs").glob("*.log")))
    died = [d for _t, k, d in sup.events if k == "rank-died"]
    return {"rc": rc, "restarted": sup.restarts_used >= 1, "killed": any(f"exited {FAULT_EXIT}" in d for d in died),
            "folded_equal": fold_diff_stream(outs(), ["k"]) == expected, "logs": logs}


def test_two_process_kill_mid_tick_supervised_recovery(tmp_path):
    """Fault Forge kills rank 1 at the tail of its 3rd data tick; the
    survivor fail-stops, each package's supervisor restarts the whole
    group, and incarnation 1 restores the group-committed generation and
    its log tail: the folded outputs equal the uninterrupted run's, in
    both packages."""
    for pkg in PACKAGES:
        got = _supervised_kill_mid_tick(pkg, tmp_path)
        logs = got.pop("logs")
        assert got == {"rc": 0, "restarted": True, "killed": True, "folded_equal": True}, (pkg, logs)


# --- mixed packages ---------------------------------------------------------


def test_port_group_supervised_after_a_jax_group_died_resumes_its_stores(tmp_path):
    """A two-process JAX-package group dies midway (rank 1 after two output
    rows, rank 0 fail-stops); a port group under the port's supervisor
    resumes from the stores it left, to the JAX package's single-process
    output over every row."""
    from pathway_tpu_torch.parallel.supervisor import GroupSupervisor
    from test_torch_dcn import _ROWS, _Matrix

    m = _Matrix(tmp_path, "groupby_sum", first_pkg="pathway_tpu")
    rows1, rows2 = _ROWS["groupby_sum"]
    for pid, rows in rows1.items():
        m.write(pid, "f1.jsonl", rows)
    m.kill_phase()
    assert any((m.base / f"pstorage{p}" / "metadata.json").exists() for p in range(2))
    for pid, rows in rows2.items():
        m.write(pid, "f2.jsonl", rows)
    expected = m.reference()

    def stopper():
        wait(lambda: fold_diff_stream(m.outs(), ["k"]) == expected, timeout=150, interval=0.2)
        (m.base / "STOP").touch()

    port = free_dcn_port(2)
    sup = GroupSupervisor(
        [sys.executable, str(m.script)], 2,
        env={"PW_TEST_DIR": str(m.base), "PW_PIPELINE": "groupby_sum", "PW_PHASE": "2",
             "PATHWAY_DCN_PORT": str(port), "PATHWAY_DCN_SECRET": f"mixed-secret-{port}", "JAX_PLATFORMS": "cpu",
             "CUDA_VISIBLE_DEVICES": "", "PW_PKG": "pathway_tpu_torch", "PYTHONPATH": ROOT},
        max_restarts=0, log_dir=str(tmp_path / "logs"))
    st = threading.Thread(target=stopper, daemon=True)
    st.start()
    rc = _run_bounded(sup, 200)
    st.join(timeout=160)
    logs = "\n".join(p.read_text()[-2000:] for p in sorted((tmp_path / "logs").glob("*.log")))
    assert rc == 0 and _kinds(sup) == ["group-start", "group-done"], (sup.events, logs)
    assert logs.count("CLEAN-EXIT") == 2, logs
    assert fold_diff_stream(m.outs(), ["k"]) == expected


# --- the Replica Shield chaos leg (tests/test_distributed.py:1067) ----------


def _replica_shield_chaos(pkg: str, tmp_path) -> dict:
    """A real writer streams deltas to two replica processes, each under its
    own 1-rank supervisor, behind the failover router; Fault Forge kills
    replica 1 after its 12th applied tick; incarnation 1 re-hydrates,
    replays and is re-admitted, while no client sees an error."""
    import importlib
    import subprocess

    from torch_repl_parity import get, post

    base = tmp_path / pkg
    (base / "docs").mkdir(parents=True)
    (base / "q").mkdir()
    dim = 16
    repl_port, http_ports = free_dcn_port(1), [free_dcn_port(1), free_dcn_port(1)]
    env_common = {"PW_WRITER_DIR": str(base), "PATHWAY_DCN_SECRET": f"shield-{repl_port}",
                  "PATHWAY_REPLICA_DIM": str(dim), "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": "",
                  "PATHWAY_REPLICA_DEVICE": "cpu", "PATHWAY_COMPILED_TICK": "0", "PYTHONPATH": ROOT}

    def write_docs(lo, hi, tag):
        with open(base / "docs" / f"{tag}.jsonl", "w") as f:
            for i in range(lo, hi):
                f.write(json.dumps({"text": f"doc {i}"}) + "\n")

    write_docs(0, 8, "f0")
    chaos = importlib.import_module(f"{pkg}.testing.chaos")
    script = base / "writer.py"
    script.write_text(chaos.REPL_WRITER_SCRIPT)
    writer_log = open(base / "writer.log", "wb")
    writer = subprocess.Popen([sys.executable, str(script)], stdout=writer_log, stderr=subprocess.STDOUT,
                              env={**os.environ, **env_common, "PATHWAY_REPL_PORT": str(repl_port)})
    sups, threads, router = [], [], None
    out: dict = {}
    try:
        import socket

        def up() -> bool:
            with socket.socket() as s:
                return s.connect_ex(("127.0.0.1", repl_port)) == 0

        assert wait(up, timeout=120, interval=0.5), (base / "writer.log").read_text()[-3000:]
        for rid in range(2):
            renv = dict(env_common, PATHWAY_REPLICA_ID=str(rid), PATHWAY_REPLICA_STORE=str(base / "pstorage"),
                        PATHWAY_REPL_PORT=str(repl_port), PATHWAY_REPLICA_HTTP_PORT=str(http_ports[rid]))
            if rid == 1:
                renv["PATHWAY_FAULTS"] = "kill=replica:1,tick:12"
            sup = _sup_cls(pkg)([sys.executable, "-m", f"{pkg}.serving.replica"], 1, env=renv, max_restarts=2,
                                backoff_s=0.2, log_dir=str(base / f"replica{rid}-logs"))
            sups.append(sup)
            th = threading.Thread(target=sup.run, daemon=True)
            threads.append(th)
            th.start()
        router = importlib.import_module(f"{pkg}.serving.router").FailoverRouter(
            [f"http://127.0.0.1:{p}" for p in http_ports], health_interval_ms=150).start()
        failures: list = []
        router.add_failure_listener(lambda name, why: failures.append((name, why)))

        def health(rid):
            try:
                return get(http_ports[rid], "/replica/health", timeout=2).json()
            except (OSError, ValueError):
                return None

        assert wait(lambda: all((health(r) or {}).get("ready") for r in range(2)), timeout=180, interval=0.5)
        statuses: dict = {}
        killed_seen = restarted_ready = False
        for i in range(200):
            if i % 4 == 0:
                write_docs(8 + i, 9 + i, f"t{i}")
            try:
                r = post(router.port, "/query", {"query": f"doc {i % 8}", "k": 1}, timeout=15)
                statuses[r.status] = statuses.get(r.status, 0) + 1
            except OSError:
                statuses["transport"] = statuses.get("transport", 0) + 1
            killed_seen = killed_seen or bool(failures)
            h1 = health(1)
            if killed_seen and h1 is not None and h1.get("incarnation") == 1 and h1.get("ready"):
                restarted_ready = True
                break
            time.sleep(0.15)
        died = [d for _t, k, d in sups[1].events if k == "rank-died"]
        ep1 = router.endpoints[1]
        out = {"killed_seen": killed_seen, "restarted_ready": restarted_ready,
               "restarted": sups[1].restarts_used >= 1,
               "killed_by_fault": bool(died) and f"exited {FAULT_EXIT}" in died[0],
               "errors": sum(v for k, v in statuses.items() if k not in (200, 429, 503)),
               "served": statuses.get(200, 0) > 0,
               "readmitted": wait(lambda: not ep1.ejected, timeout=30, interval=0.2)}
    finally:
        (base / "STOP").touch()
        if router is not None:
            router.stop()
        for sup in sups:
            sup.stop()
        for th in threads:
            th.join(timeout=30)
        writer.terminate()
        try:
            writer.wait(timeout=30)
        except subprocess.TimeoutExpired:
            writer.kill()
            writer.wait()
        writer_log.close()
    return out


@pytest.mark.slow
def test_replica_shield_chaos_kill_and_supervised_restart(tmp_path):
    """The reference's full replication chaos leg, in both packages: the
    injected replica death is restarted by its supervisor (incarnation 1
    runs fault-free), the router re-admits it, and clients see no error."""
    want = {"killed_seen": True, "restarted_ready": True, "restarted": True, "killed_by_fault": True,
            "errors": 0, "served": True, "readmitted": True}
    for pkg in PACKAGES:
        assert _replica_shield_chaos(pkg, tmp_path) == want, pkg
