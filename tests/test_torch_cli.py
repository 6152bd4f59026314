"""``python -m pathway_tpu_torch.cli``: ``spawn`` sets the reference's
``PATHWAY_*`` env on every rank (a fresh ``PATHWAY_DCN_SECRET`` per job,
``PATHWAY_ENGINE_SHARDS`` for ``-t`` > 1, the record/replay variables) and
what ``torch.distributed`` reads where the JAX package sets its ``JAX_*``
variables; ``spawn-from-env`` reads its arguments from
``PATHWAY_SPAWN_ARGS``; ``--timeout`` kills the group; ``--supervise``
restarts the whole group after a Fault Forge kill (and ``--timeout`` still
kills every rank of a supervised group); and a spawned group with
``PATHWAY_JAX_DISTRIBUTED=1`` joins the gloo device group in ``pw.run``
and folds to the JAX package's single-process wordcount."""

from __future__ import annotations

import os
import sys
import textwrap
import time

import pytest

from pathway_tpu_torch.testing.chaos import free_dcn_port
from torch_group import ROOT, results, run_procs, worker

_ENV = textwrap.dedent(
    """
    import json, os, sys
    keys = ("PATHWAY_PROCESSES", "PATHWAY_PROCESS_ID", "PATHWAY_FIRST_PORT", "PATHWAY_DCN_SECRET",
            "PATHWAY_THREADS", "PATHWAY_ENGINE_SHARDS", "PATHWAY_REPLAY_STORAGE", "PATHWAY_SNAPSHOT_ACCESS",
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "PATHWAY_DIST_BACKEND")
    # one write of the whole line: the ranks share spawn's stdout
    sys.stdout.write("RESULT " + json.dumps({k: os.environ.get(k) for k in keys}) + "\\n")
    sys.stdout.flush()
    """
)


def _cli(args, env_extra=None, timeout=120):
    env = dict(os.environ)
    env.pop("PATHWAY_DCN_SECRET", None)
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return run_procs([([sys.executable, "-m", "pathway_tpu_torch.cli", *args], env)], timeout)


def _rank_envs(procs, outs):
    got = results(procs, outs)
    return sorted(got, key=lambda e: int(e["PATHWAY_PROCESS_ID"]))


def test_spawn_sets_the_env_contract(tmp_path):
    script = tmp_path / "env.py"
    script.write_text(_ENV)
    a = _rank_envs(*_cli(["spawn", "-n", "2", "--first-port", "12345", "--", sys.executable, str(script)]))
    assert [e["PATHWAY_PROCESS_ID"] for e in a] == ["0", "1"]
    for pid, e in enumerate(a):
        assert e["PATHWAY_PROCESSES"] == "2" and e["PATHWAY_FIRST_PORT"] == "12345"
        assert e["PATHWAY_THREADS"] == "1" and e["PATHWAY_ENGINE_SHARDS"] is None
        assert (e["MASTER_ADDR"], e["MASTER_PORT"]) == ("127.0.0.1", "12345")
        assert (e["WORLD_SIZE"], e["RANK"], e["LOCAL_RANK"], e["LOCAL_WORLD_SIZE"]) == ("2", str(pid), str(pid), "2")
        assert e["PATHWAY_REPLAY_STORAGE"] is None and e["PATHWAY_DIST_BACKEND"] is None
    # one secret per job, the same on every rank
    assert a[0]["PATHWAY_DCN_SECRET"] == a[1]["PATHWAY_DCN_SECRET"] and len(a[0]["PATHWAY_DCN_SECRET"]) == 64
    b = _rank_envs(*_cli(["spawn", "-n", "3", "-t", "2", "--record", "--record-path", str(tmp_path / "rec"),
                          "--backend", "gloo", "--", sys.executable, str(script)]))
    assert len(b) == 3 and b[0]["PATHWAY_DCN_SECRET"] != a[0]["PATHWAY_DCN_SECRET"]
    for e in b:
        assert e["PATHWAY_ENGINE_SHARDS"] == "2" and e["PATHWAY_THREADS"] == "2"
        assert (e["PATHWAY_REPLAY_STORAGE"], e["PATHWAY_SNAPSHOT_ACCESS"]) == (str(tmp_path / "rec"), "record")
        assert e["PATHWAY_DIST_BACKEND"] == "gloo"
    c = _rank_envs(*_cli(["spawn", "-n", "1", "--replay-mode", "full", "--", sys.executable, str(script)]))
    assert (c[0]["PATHWAY_REPLAY_STORAGE"], c[0]["PATHWAY_SNAPSHOT_ACCESS"]) == ("./record", "full")


def test_spawn_from_env(tmp_path):
    script = tmp_path / "env.py"
    script.write_text(_ENV)
    got = _rank_envs(*_cli(["spawn-from-env", sys.executable, str(script)],
                           {"PATHWAY_SPAWN_ARGS": "-n 2 --first-port 13000"}))
    assert [(e["PATHWAY_PROCESS_ID"], e["PATHWAY_FIRST_PORT"]) for e in got] == [("0", "13000"), ("1", "13000")]


def test_spawn_exit_codes_and_timeout(tmp_path):
    """The group's exit code is a failed rank's; nothing to run is 2; past
    ``--timeout`` the group is killed and spawn exits 124."""
    from pathway_tpu_torch import cli

    assert cli.main(["spawn", "-n", "2"]) == 2
    assert cli.main(["spawn", "-n", "2", "--", sys.executable, "-c",
                     "import os, sys; sys.exit(3 if os.environ['PATHWAY_PROCESS_ID'] == '1' else 0)"]) == 3
    marker = tmp_path / "alive"
    slow = f"import time, pathlib; time.sleep(60); pathlib.Path({str(marker)!r}).touch()"
    t0 = time.monotonic()
    assert cli.main(["spawn", "-n", "2", "--timeout", "2", "--", sys.executable, "-c", slow]) == 124
    assert time.monotonic() - t0 < 30
    time.sleep(0.5)
    assert not marker.exists()


_SUPERVISED_RUN = worker(
    """
    import logging
    logging.basicConfig(level=logging.WARNING)

    class S(pw.Schema):
        word: str

    words_all = [f"w{i % 7}" for i in range(100)]
    t = pw.debug.table_from_rows(S, [(w,) for i, w in enumerate(words_all) if i % N == PID])
    r = t.groupby(t.word).reduce(t.word, count=pw.reducers.count())
    out = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            out[row["word"]] = row["count"]
        elif out.get(row["word"]) == row["count"]:
            del out[row["word"]]

    pw.io.subscribe(r, on_change=on_change)
    pw.run()
    import torch.distributed as td
    info = None  # the single-process reference run joins no group
    if td.is_available() and td.is_initialized():
        info = [os.environ["PATHWAY_MESH_INCARNATION"], td.get_world_size(), os.environ["WORLD_SIZE"],
                os.environ["RANK"]]
    sys.stdout.write("RESULT " + json.dumps([out, info]) + "\\n")  # one write: a shared stdout
    sys.stdout.flush()
    """
)


def test_spawn_supervise_restarts_the_group_after_a_fault_forge_kill(tmp_path):
    """``spawn -n 2 --supervise --backend gloo`` with ``PATHWAY_FAULTS``
    killing rank 1 at its first tick: rank 0 fail-stops, the supervisor
    restarts the whole group once, incarnation 1 (no injected death) joins
    the gloo device group again, and spawn exits 0 with the JAX package's
    single-process wordcount."""
    script = tmp_path / "wc.py"
    script.write_text(_SUPERVISED_RUN)
    env = {"PATHWAY_DCN_PORT": str(free_dcn_port(2)), "PATHWAY_DIST_DEVICE": "cpu", "PATHWAY_JAX_DISTRIBUTED": "1",
           "PATHWAY_FAULTS": "kill=tick:1,pid:1", "PATHWAY_MESH_LIVENESS_TIMEOUT_MS": "5000"}
    procs, outs = _cli(["spawn", "-n", "2", "--backend", "gloo", "--supervise", "--max-restarts", "1",
                        "--first-port", str(free_dcn_port(1)), "--timeout", "150", "--", sys.executable,
                        str(script)], env, timeout=200)
    assert procs[0].returncode == 0, outs[0][-4000:]
    assert "fault forge: injected death" in outs[0], outs[0][-4000:]
    got = results(procs, outs)
    # only incarnation 1 finished: one restart, both ranks in a group of 2
    assert sorted(info for _out, info in got) == [["1", 2, "2", "0"], ["1", 2, "2", "1"]], got
    merged = {**got[0][0], **got[1][0]}
    single = results(*run_procs([([sys.executable, str(script)], {**os.environ, "PYTHONPATH": ROOT,
                                                                    "PW_PKG": "pathway_tpu"})]))
    assert merged == single[0][0]


def test_spawn_supervise_timeout_kills_every_rank(tmp_path):
    """Past ``--timeout`` a supervised group is stopped with its supervisor:
    spawn exits 124 and no rank lives on."""
    from pathway_tpu_torch import cli

    marker = tmp_path / "alive"
    slow = f"import time, pathlib; time.sleep(60); pathlib.Path({str(marker)!r}).touch()"
    t0 = time.monotonic()
    assert cli.main(["spawn", "-n", "2", "--supervise", "--timeout", "2", "--", sys.executable, "-c", slow]) == 124
    assert time.monotonic() - t0 < 30
    time.sleep(0.5)
    assert not marker.exists()
    assert cli.main(["spawn", "-n", "2", "--supervise", "--", sys.executable, "-c", "pass"]) == 0


_GROUP_RUN = worker(
    """
    import logging
    logging.basicConfig(level=logging.WARNING)

    class S(pw.Schema):
        word: str

    words_all = [f"w{i % 7}" for i in range(100)]
    t = pw.debug.table_from_rows(S, [(w,) for i, w in enumerate(words_all) if i % N == PID])
    r = t.groupby(t.word).reduce(t.word, count=pw.reducers.count())
    out = {}

    def on_change(key, row, time, is_addition):
        if is_addition:
            out[row["word"]] = [int(key), row["count"]]
        elif out.get(row["word"]) == [int(key), row["count"]]:
            del out[row["word"]]

    pw.io.subscribe(r, on_change=on_change)
    pw.run()
    import torch.distributed as td
    joined = td.is_initialized()
    info = [joined, td.get_backend() if joined else None, td.get_world_size() if joined else None]
    sys.stdout.write("RESULT " + json.dumps([out, info]) + "\\n")  # one write: a shared stdout
    sys.stdout.flush()
    """
)


@pytest.mark.parametrize("device_group", [True, False], ids=["device_group", "host_mesh_only"])
def test_spawned_group_runs_pw_run(tmp_path, device_group):
    """``spawn -n 2`` runs a port pipeline as a group: with
    ``PATHWAY_JAX_DISTRIBUTED=1`` ``pw.run`` joins the gloo device group as
    well, without it only the host mesh (the reference's warning names
    the variable); the union of the ranks' rows is the JAX package's
    single-process wordcount."""
    script = tmp_path / "wc.py"
    script.write_text(_GROUP_RUN)
    env = {"PATHWAY_DCN_PORT": str(free_dcn_port(2)), "PATHWAY_DIST_DEVICE": "cpu"}
    if device_group:
        env["PATHWAY_JAX_DISTRIBUTED"] = "1"
    procs, outs = _cli(["spawn", "-n", "2", "--backend", "gloo", "--first-port", str(free_dcn_port(1)),
                        "--timeout", "100", "--", sys.executable, str(script)], env)
    got = results(procs, outs)
    assert len(got) == 2
    merged = {**got[0][0], **got[1][0]}
    for _out, info in got:
        assert info == ([True, "gloo", 2] if device_group else [False, None, None])
    if not device_group:
        assert "PATHWAY_JAX_DISTRIBUTED=1" in outs[0]
    single = results(*run_procs([([sys.executable, str(script)], {**os.environ, "PYTHONPATH": ROOT,
                                                                    "PW_PKG": "pathway_tpu"})]))
    assert merged == single[0][0]
