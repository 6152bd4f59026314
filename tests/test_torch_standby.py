"""The port's standby writer (``parallel/standby.py``) held against the JAX
package's on the CPU.

* The reference's standby cases (``tests/test_sharded_serving.py``) as port
  cases, with the outcome equal in both packages: the takeover smoke (the
  primary dies, the standby takes over under a bumped incarnation, the
  replica re-converges with no duplicate row and no fenced writer), the gate
  that never usurps a primary it has never reached, and the position file
  (throttled, atomic, restored by a restarted standby).
* The reference's standby-leg wire fault (``tests/test_faults.py:774``):
  ``drop=ch:repl:standby`` drops frames to the standby alone, in both
  packages.
* The default takeover: the writer's argv respawned under a 1-rank
  ``GroupSupervisor`` at the fenced incarnation, in both packages.
* ``python -m pathway_tpu_torch.parallel.standby`` as a process: it
  shadows a real writer (``testing/chaos.REPL_WRITER_SCRIPT``), the writer
  is SIGKILLed, and the respawned writer (incarnation 1) restores the store
  and publishes on the same port to a ``serving.replica`` process, which
  serves the documents written after the takeover.

Keys and values are compared exactly."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from torch_group import ROOT
from torch_repl_parity import ToyIndex, both, get, pkg, post, wait


@pytest.fixture(autouse=True)
def _repl_env(monkeypatch):
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "standby-parity-secret")
    for name in ("PATHWAY_SERVING_SHARDS", "PATHWAY_SERVING_SHARD_MAP", "PATHWAY_MESH_INCARNATION",
                 "PATHWAY_STANDBY_GRACE_MS", "PATHWAY_FAULTS"):
        monkeypatch.delenv(name, raising=False)
    yield
    for name in ("jax", "torch"):
        pkg(name).reset()


def _standby(P):
    import importlib

    return importlib.import_module(f"{P.root}.parallel.standby")


def _free_port() -> int:
    from pathway_tpu_torch.testing.chaos import free_dcn_port

    return free_dcn_port(1)


class _InProcWriter:
    """The reference's in-process 'writer role': a DeltaStreamServer on a
    FIXED port plus the corpus it republishes."""

    def __init__(self, P, port, corpus, incarnation):
        self.P = P
        self.srv = P.replicate.DeltaStreamServer(port, incarnation=incarnation, ring_ticks=64)
        self.corpus = corpus
        self.tick = 100 * incarnation  # distinct tick ranges per life
        self.srv.set_floor(-1 if incarnation == 0 else self.tick - 1)
        self.publish_corpus()

    def publish_corpus(self):
        rows = [(k, 1, (v, None)) for k, v in sorted(self.corpus.items())]
        self.srv.publish(self.tick, [self.P.batch(rows)] if rows else [])
        self.tick += 1

    def publish(self, rows):
        for k, d, v in rows:
            if d > 0:
                self.corpus[k] = v[0]
            else:
                self.corpus.pop(k, None)
        self.srv.publish(self.tick, [self.P.batch(rows)])
        self.tick += 1


def _takeover_smoke(P):
    """tests/test_sharded_serving.py:510."""
    port = _free_port()
    corpus = {k: f"v{k}" for k in range(6)}
    primary = _InProcWriter(P, port, dict(corpus), incarnation=0)
    rep = P.replica_server(
        replica_id=0, index_factory=ToyIndex, writer_port=port,
        responder=lambda s, v: {"corpus": {str(k): str(val[0]) for k, val in s.index.d.items()}},
    ).start()
    takeovers: list = []

    def on_takeover(standby):
        takeovers.append(_InProcWriter(P, port, dict(primary.corpus), standby.next_incarnation()))

    standby = _standby(P).StandbyWriter("127.0.0.1", port, on_takeover=on_takeover, grace_s=0.6,
                                        poll_s=0.05).start()
    out = {}
    try:
        assert wait(lambda: rep.ready, timeout=15)
        assert wait(lambda: standby.applied_tick >= 0, timeout=15)
        # the reference's monitor counts contact only at a poll that finds
        # the link up (test_first_contact_between_two_polls_counts)
        assert wait(lambda: standby._client.connected, timeout=15)
        time.sleep(0.3)
        primary.publish([(6, 1, ("v6", None))])
        assert wait(lambda: 6 in rep.index.d, timeout=10)
        primary.srv.close()  # the primary dies mid-stream
        out["took_over"] = standby.wait_takeover(timeout=20)
        out["takeovers"] = len(takeovers)
        new_writer = takeovers[0]
        out["new_incarnation"] = new_writer.srv.incarnation
        out["replica_follows"] = wait(lambda: rep.health()["writer_incarnation"] == 1, timeout=20)
        new_writer.publish([(7, 1, ("v7", None))])
        out["live_write"] = wait(lambda: 7 in rep.index.d, timeout=15)
        # no replayed-duplicate row: the folded corpus is the writer's
        out["corpus"] = {k: v for k, v in sorted(rep.index.d.items())}
        r = post(rep.http_port, "/query", {})
        out["reply"] = (r.status, r.json()["corpus"]["7"])
        out["fenced_writers"] = rep.health()["fenced_writers"]
        out["events"] = [k for _t, k, _d in standby.events]
    finally:
        standby.stop()
        rep.stop()
        primary.srv.close()
        for w in takeovers:
            w.srv.close()
    return out


def _never_usurps(P):
    """tests/test_sharded_serving.py:720."""
    port = _free_port()  # nothing listens here yet
    standby = _standby(P).StandbyWriter("127.0.0.1", port, on_takeover=lambda s: None, grace_s=0.2,
                                        poll_s=0.05).start()
    try:
        early = standby.wait_takeover(timeout=1.5), standby.took_over
        # an explicit failure notification still takes over at once
        standby.notify_failure("test", "operator says dead")
        return early, standby.wait_takeover(timeout=10), standby.next_incarnation()
    finally:
        standby.stop()


def _contact_between_polls(P):
    """The primary is reached, publishes a tick and dies before the
    standby's first poll."""
    srv = P.replicate.DeltaStreamServer(0)
    t0 = time.monotonic()
    standby = _standby(P).StandbyWriter("127.0.0.1", srv.port, on_takeover=lambda s: None, grace_s=0.2,
                                        poll_s=3.0).start()
    try:
        srv.publish(0, [P.batch([(1, 1, ("a", None))])])
        assert wait(lambda: standby.applied_tick == 0, timeout=15)
        srv.close()
        assert time.monotonic() - t0 < 2.5, "the first contact came after the first poll"
        return standby.wait_takeover(timeout=10), standby.next_incarnation()
    finally:
        standby.stop()
        srv.close()


def test_first_contact_between_two_polls_counts():
    """A fault of the reference that the port repairs: its monitor counts
    the first contact only at a poll that finds the link up, so a primary
    that publishes and dies within one poll of the standby's start is never
    taken over. The port counts an applied tick as contact: it takes over
    after the grace; the JAX package never does."""
    jax_out, torch_out = both(_contact_between_polls)
    assert torch_out == (True, 1)
    assert jax_out == (False, 1)


def _persists_position(P, tmp_path):
    """tests/test_sharded_serving.py:746."""
    srv = P.replicate.DeltaStreamServer(0)
    pos_file = str(tmp_path / f"standby_{P.name}.json")
    standby = _standby(P).StandbyWriter("127.0.0.1", srv.port, position_path=pos_file, grace_s=60.0,
                                        on_takeover=lambda s: None).start()

    def persisted_tick():
        try:
            return json.loads(open(pos_file).read())["applied_tick"]
        except (OSError, ValueError, KeyError):
            return -1

    try:
        srv.publish(0, [P.batch([(1, 1, ("a", None))])])
        assert wait(lambda: standby.applied_tick == 0, timeout=15)
        time.sleep(0.6)  # clear the position-write throttle window
        srv.publish(1, [P.batch([(2, 1, ("b", None))])])
        # wait on the FILE: applied_tick is assigned before the atomic write
        landed = wait(lambda: persisted_tick() == 1, timeout=15)
    finally:
        standby.stop()
        srv.close()
    leftovers = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith(f"standby_{P.name}"))
    # a restarted standby resumes from the persisted position
    restarted = _standby(P).StandbyWriter("127.0.0.1", 1, position_path=pos_file, grace_s=3600.0,
                                          on_takeover=lambda s: None)
    return landed, leftovers, restarted.applied_tick, restarted.next_incarnation() >= 1


def test_writer_kill_standby_takeover_smoke():
    jax_out, torch_out = both(_takeover_smoke)
    assert torch_out == jax_out
    assert torch_out["took_over"] and torch_out["takeovers"] == 1 and torch_out["new_incarnation"] == 1
    assert torch_out["replica_follows"] and torch_out["live_write"]
    assert torch_out["corpus"] == {k: (f"v{k}", None) for k in range(8)}
    assert torch_out["reply"] == (200, "v7") and torch_out["fenced_writers"] == 0
    assert torch_out["events"] == ["standby-start", "takeover"]


def test_standby_never_usurps_before_first_contact():
    """A standby booted before its primary must not take over while the
    primary is merely slow to open its port: the grace clock starts at the
    first contact. A failure notification takes over at once."""
    jax_out, torch_out = both(_never_usurps)
    assert torch_out == jax_out == ((False, False), True, 1)


def test_standby_persists_position(tmp_path):
    jax_out, torch_out = both(_persists_position, tmp_path)
    assert torch_out[1] == [f"standby_torch.json"] and jax_out[1] == ["standby_jax.json"]  # no .tmp left
    assert (torch_out[0], torch_out[2:]) == (jax_out[0], jax_out[2:]) == (True, (1, True))


def test_grace_env_equal_in_both_packages(monkeypatch):
    """PATHWAY_STANDBY_GRACE_MS: milliseconds, floored at 100; a word is
    refused naming the variable."""
    for raw, want in (("1000", 1.0), ("5", 0.1), ("", 5.0)):
        monkeypatch.setenv("PATHWAY_STANDBY_GRACE_MS", raw)
        assert both(lambda P: _standby(P).grace_env()) == (want, want)
    monkeypatch.setenv("PATHWAY_STANDBY_GRACE_MS", "soon")
    for P in (pkg("jax"), pkg("torch")):
        with pytest.raises(ValueError, match="PATHWAY_STANDBY_GRACE_MS='soon'"):
            _standby(P).grace_env()


def _standby_leg_fault(P, monkeypatch):
    """tests/test_faults.py:774: drop=ch:repl:standby drops frames on the
    writer→standby leg ONLY; the replica fan-out is untouched."""
    import importlib

    faults = importlib.import_module(f"{P.root}.testing.faults")
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "fault-test-secret")
    monkeypatch.setenv("PATHWAY_FAULTS", "drop=ch:repl:standby,nth:2")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "0")
    monkeypatch.delenv("PATHWAY_MESH_INCARNATION", raising=False)
    faults.reset()
    try:
        rp = P.replicate
        srv = rp.DeltaStreamServer(0)
        replica_applied: list[int] = []
        standby_applied: list[int] = []
        cl = rp.DeltaStreamClient("127.0.0.1", srv.port, 0, from_tick=-1,
                                  on_deltas=lambda t, bs: replica_applied.append(t))
        sb = rp.DeltaStreamClient("127.0.0.1", srv.port, rp.STANDBY_ID, from_tick=-1,
                                  on_deltas=lambda t, bs: standby_applied.append(t))
        cl.start()
        sb.start()
        try:
            assert wait(lambda: cl.connected and sb.connected, timeout=10)
            for t in range(4):
                srv.publish(t, [P.batch([(t, 1, ("x", None))])])
            wait(lambda: replica_applied[-1:] == [3] and standby_applied[-1:] == [3], timeout=10)
            return replica_applied, standby_applied
        finally:
            cl.close()
            sb.close()
            srv.close()
    finally:
        faults.reset()


def test_standby_leg_wire_faults_target_only_standby(monkeypatch):
    got = [_standby_leg_fault(pkg(name), monkeypatch) for name in ("jax", "torch")]
    assert got[0] == got[1] == ([0, 1, 2, 3], [0, 2, 3])


_INC_CHILD = "import os, pathlib; pathlib.Path(os.environ['PW_OUT']).write_text(os.environ['PATHWAY_MESH_INCARNATION'])"


def _default_takeover(P, tmp_path):
    """No on_takeover: the argv is respawned under a 1-rank supervisor at
    the fenced incarnation (one past the primary's)."""
    out = tmp_path / f"inc_{P.name}.txt"
    srv = P.replicate.DeltaStreamServer(0, incarnation=2)
    standby = _standby(P).StandbyWriter("127.0.0.1", srv.port, argv=[sys.executable, "-c", _INC_CHILD],
                                        env={"PW_OUT": str(out)}, grace_s=0.3, poll_s=0.05).start()
    try:
        srv.publish(0, [P.batch([(1, 1, ("a", None))])])
        assert wait(lambda: standby.applied_tick == 0 and standby._client.connected, timeout=15)
        time.sleep(0.3)  # a poll of the reference's monitor finds the link up
        srv.close()
        took = standby.wait_takeover(timeout=20)
        assert wait(lambda: out.exists() and out.read_text() != "", timeout=30)
        assert wait(lambda: not standby._sup_thread.is_alive(), timeout=30)
        sup = standby._sup
        return (took, standby.next_incarnation(), out.read_text(), sup.n, sup.initial_incarnation,
                [k for _t, k, _d in sup.events], [k for _t, k, _d in standby.events])
    finally:
        standby.stop()
        srv.close()


def test_default_takeover_spawns_the_writer_at_the_fenced_incarnation(tmp_path):
    jax_out, torch_out = both(_default_takeover, tmp_path)
    assert torch_out == jax_out == (True, 3, "3", 1, 3, ["group-start", "group-done"], ["standby-start", "takeover"])


# --- the standby as a process, over a real writer and replica --------------

DIM = 16


def _docs(base, lo: int, hi: int, tag: str) -> None:
    tmp = base / f".{tag}.tmp"
    with open(tmp, "w") as f:
        for i in range(lo, hi):
            f.write(json.dumps({"text": f"doc {i}"}) + "\n")
    os.replace(tmp, base / "docs" / f"{tag}.jsonl")


def test_standby_process_takes_over_a_killed_writer(tmp_path):
    """``python -m pathway_tpu_torch.parallel.standby --writer-port P
    --store-root S --position-file F -- python writer.py``: the writer
    indexes documents and publishes them to a ``serving.replica`` process;
    it is SIGKILLed; within the grace the standby respawns it at
    incarnation 1, which restores the store, publishes on the same port
    and indexes the documents written after the takeover; the replica
    follows it, holds every document once, and answers for a new one."""
    from pathway_tpu_torch.serving.replica import text_vector
    from pathway_tpu_torch.testing.chaos import REPL_WRITER_SCRIPT

    base = tmp_path
    (base / "docs").mkdir()
    (base / "q").mkdir()
    script = base / "writer.py"
    script.write_text(REPL_WRITER_SCRIPT)
    repl_port, http_port = _free_port(), _free_port()
    env = dict(os.environ, PW_WRITER_DIR=str(base), PATHWAY_DCN_SECRET="standby-process-test",
               PATHWAY_REPLICA_DIM=str(DIM), PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               PATHWAY_REPL_PORT=str(repl_port), PATHWAY_STANDBY_GRACE_MS="1000")
    env.pop("PATHWAY_FAULTS", None)
    _docs(base, 0, 8, "f0")
    procs = []
    logs = {name: open(base / f"{name}.log", "w") for name in ("writer", "standby", "replica")}
    try:
        writer = subprocess.Popen([sys.executable, str(script)], env=env, stdout=logs["writer"],
                                  stderr=subprocess.STDOUT)
        procs.append(writer)
        standby = subprocess.Popen(
            [sys.executable, "-m", "pathway_tpu_torch.parallel.standby", "--writer-port", str(repl_port),
             "--store-root", str(base / "pstorage"), "--position-file", str(base / "standby.json"), "--",
             sys.executable, str(script)],
            env=env, stdout=logs["standby"], stderr=subprocess.STDOUT)
        procs.append(standby)
        assert wait(lambda: (base / "pstorage" / "metadata.json").exists(), timeout=90), \
            (base / "writer.log").read_text()[-3000:]
        replica = subprocess.Popen(
            [sys.executable, "-m", "pathway_tpu_torch.serving.replica"],
            env=dict(env, PATHWAY_REPLICA_ID="0", PATHWAY_REPLICA_STORE=str(base / "pstorage"),
                     PATHWAY_REPLICA_HTTP_PORT=str(http_port), PATHWAY_REPLICA_DEVICE="cpu"),
            stdout=logs["replica"], stderr=subprocess.STDOUT)
        procs.append(replica)

        def health():
            try:
                return get(http_port, "/replica/health", timeout=2).json()
            except OSError:
                return None

        assert wait(lambda: (health() or {}).get("corpus_docs") == 8, timeout=90), \
            (health(), (base / "replica.log").read_text()[-3000:])
        assert wait(lambda: (base / "standby.json").exists(), timeout=30)
        os.kill(writer.pid, signal.SIGKILL)
        writer.wait(timeout=30)
        t_dead = time.monotonic()
        # the documents after the takeover: written once the respawned
        # writer publishes as incarnation 1
        assert wait(lambda: (health() or {}).get("writer_incarnation") == 1, timeout=90), \
            (health(), (base / "standby.log").read_text()[-3000:])
        _docs(base, 8, 12, "f1")
        assert wait(lambda: (health() or {}).get("corpus_docs") == 12, timeout=90), health()
        h = health()
        assert h["fenced_writers"] == 0 and h["ready"]
        r = post(http_port, "/query", {"vec": [float(x) for x in text_vector("doc 11", DIM)], "k": 1})
        assert r.status == 200 and r.json()["matches"][0][1] == pytest.approx(0.0, abs=1e-5)  # -(1 - cos)
        takeover_s = time.monotonic() - t_dead
        pos = json.loads((base / "standby.json").read_text())
        assert pos["incarnation"] == 1 and takeover_s < 90
    finally:
        (base / "STOP").touch()
        for p in reversed(procs):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in reversed(procs):
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    out = (base / "standby.log").read_text()
    assert "STANDBY-READY" in out and "[standby] takeover:" in out and "resuming as incarnation 1" in out, out[-3000:]
    assert "store resume point: generation time" in out
