"""The port's Shard Flux (``pathway_tpu_torch/elastic/``) held against the JAX
package's on the CPU: the reference's ``tests/test_elastic.py`` cases, each
run through both packages with equal outcomes.

* The two-phase handover: the same commit/rollback sequence gives the same
  maps, and the map files are the same bytes, read by either package.
* The segment ferry: round trip, content-addressed resume, the refused
  secret and ``abort``, equal in both packages; and the wire across the
  packages both ways (a port sender commits into a JAX receiver and back).
* ``kill=ferry:N``: the spec parses alike, and a sender killed after its
  second segment leaves the old ownership map in force in both packages;
  the retry resumes and commits.
* The N → M → N re-partition of a sharded groupby: the folded output equals
  the uninterrupted run's, bit for bit, in both packages.
* ``reshard_stores`` over a real persisted run: the 1 → 2 split and the
  segment-level 2 → 1 merge give equal statistics and equal arranged rows
  in both packages; the shrink guard refuses alike; a store written by one
  package, resharded 1 → 2 → 1 by the other, restores in the first with
  zero replayed events and the right totals.
* The serving plane's router map swap, and the doctor's
  ``elastic-resharding`` rule, alike in both packages; between its members'
  adoption of a reshard and the router's swap, the JAX package serves a
  read from half the corpus where the port answers 503.
* The supervised 2 → 3 resize of a DCN group with zero replay, as a port
  case (its both-packages twin is ``slow``, as the reference's case is).

Keys, counts and bytes are compared exactly. Every group has a deadline and
its children are killed when it ends."""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import pickle
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import pathway_tpu_torch as tpw  # noqa: F401
from pathway_tpu_torch.internals import parse_graph as port_parse_graph

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")
REPO = pathlib.Path(__file__).resolve().parent.parent
SECRET = "elastic-test-secret"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    monkeypatch.setenv("PATHWAY_DCN_SECRET", SECRET)
    monkeypatch.delenv("PATHWAY_FAULTS", raising=False)
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _both(fn, *args):
    """``fn(pkg, *args)`` for both packages; the outcomes must be equal."""
    got = {pkg: fn(pkg, *args) for pkg in PACKAGES}
    assert got["pathway_tpu_torch"] == got["pathway_tpu"], got
    return got["pathway_tpu_torch"]


# --- the two-phase handover ----------------------------------------------------


def _handover_sequence(pkg, root):
    ho = _mod(pkg, "elastic.handover")
    out = []
    h = ho.TwoPhaseHandover(str(root))
    out.append(h.committed)
    out.append(tuple(vars(h.ensure_committed(2)).values()))
    nxt = h.begin(3)
    out.append((nxt.n_shards, nxt.incarnation, nxt.status))
    out.append((tuple(vars(h.committed).values()), h.in_transition))
    with pytest.raises(ho.HandoverError):
        h.begin(4)
    h.rollback()
    out.append((tuple(vars(h.committed).values()), h.in_transition))
    h.begin(3)
    out.append(tuple(vars(h.commit()).values()))
    out.append(tuple(vars(h.committed).values()))
    h.begin(5)
    out.append(h.commit().incarnation)
    with pytest.raises(ho.HandoverError, match="no handover in transition"):
        h.commit()
    out.append((root / "reshard" / "ownership.json").read_bytes())
    return out


def test_handover_commit_and_rollback(tmp_path):
    got = _both(lambda pkg: _handover_sequence(pkg, tmp_path / pkg))
    assert got[1] == (2, 0, "committed") and got[2] == (3, 1, "transition")
    assert got[3] == ((2, 0, "committed"), True) and got[4] == ((2, 0, "committed"), False)
    assert got[5] == got[6] == (3, 1, "committed") and got[7] == 2
    # the commit renames the transition file as it was written: its status
    # field stays "transition", and load_ownership reads it as committed
    assert got[8] == b'{"n_shards":5,"incarnation":2,"status":"transition"}'


@pytest.mark.parametrize("writer,reader", [("pathway_tpu", "pathway_tpu_torch"), ("pathway_tpu_torch", "pathway_tpu")])
def test_ownership_maps_cross_packages(tmp_path, writer, reader):
    """A map committed by one package is the other's committed map; a
    transition the other begins and commits is read back by the first."""
    w, r = _mod(writer, "elastic.handover"), _mod(reader, "elastic.handover")
    hw = w.TwoPhaseHandover(str(tmp_path))
    hw.ensure_committed(2)
    hw.begin(3)
    assert r.load_ownership(str(tmp_path)) == r.OwnershipMap(2, 0)
    assert r.TwoPhaseHandover(str(tmp_path)).in_transition
    hw.commit()
    assert r.load_ownership(str(tmp_path)) == r.OwnershipMap(3, 1)
    hr = r.TwoPhaseHandover(str(tmp_path))
    hr.begin(4)
    hr.commit()
    assert w.load_ownership(str(tmp_path)) == w.OwnershipMap(4, 2)


# --- the segment ferry ---------------------------------------------------------


def _ferry_case(case, sender, receiver, tmp, monkeypatch):
    """One ferry scenario with a ``sender`` package shipping into a
    ``receiver`` package's FerryReceiver; the outcome is the senders' stats,
    the placed bytes and the receiver's inventory."""
    fr, fs = _mod(receiver, "elastic.ferry"), _mod(sender, "elastic.ferry")
    if case == "wrong_secret":
        monkeypatch.setenv("PATHWAY_DCN_SECRET", "secret-A")
    recv = fr.FerryReceiver(str(tmp / "dst"))
    try:
        if case == "roundtrip":
            files = [("segments/a/0.seg", b"alpha" * 100), ("segments/b/1.seg", b"beta" * 50),
                     ("manifest.json", b'{"v":1}')]
            stats = [fs.ferry_files(recv.host, recv.port, files, transfer_id="t1")]
        elif case == "resume":
            files = [(f"f{i}", bytes([i]) * 64) for i in range(4)]
            stats = [fs.ferry_files(recv.host, recv.port, files, transfer_id="t2", commit=False)]
            assert not recv.received
            stats.append(fs.ferry_files(recv.host, recv.port, files, transfer_id="t2"))
        elif case == "wrong_secret":
            files = [("x", b"y")]
            monkeypatch.setenv("PATHWAY_DCN_SECRET", "secret-B")
            with pytest.raises(fs.FerryError, match="authentication"):
                fs.ferry_files(recv.host, recv.port, files, transfer_id="t3")
            stats = []
        else:  # abort
            files = [("f", b"data")]
            stats = [fs.ferry_files(recv.host, recv.port, files, transfer_id="t4", commit=False)]
            staged = sorted(recv.staged("t4"))
            recv.abort("t4")
            stats.append({"staged": staged, "after_abort": sorted(recv.staged("t4"))})
        placed = {name: (tmp / "dst" / name).read_bytes() for name, _ in files if (tmp / "dst" / name).exists()}
        received = {tid: sorted(v) for tid, v in recv.received.items()}
        return stats, placed, received, list(recv.committed)
    finally:
        recv.close()


FERRY_CASES = ["roundtrip", "resume", "wrong_secret", "abort"]


@pytest.mark.parametrize("case", FERRY_CASES)
def test_ferry_case_equal_in_both_packages(case, tmp_path, monkeypatch):
    got = _both(lambda pkg: _ferry_case(case, pkg, pkg, tmp_path / pkg, monkeypatch))
    stats, placed, received, committed = got
    if case == "roundtrip":
        assert stats[0]["committed"] and stats[0]["segments_sent"] == 3 and stats[0]["segments_resumed"] == 0
        assert placed["manifest.json"] == b'{"v":1}' and committed == ["t1"]
    elif case == "resume":
        assert stats[0]["segments_sent"] == 4 and not stats[0]["committed"]
        assert stats[1]["segments_sent"] == 0 and stats[1]["segments_resumed"] == 4 and stats[1]["committed"]
        assert placed == {f"f{i}": bytes([i]) * 64 for i in range(4)}
    elif case == "wrong_secret":
        assert not placed and not received
    else:
        assert len(stats[1]["staged"]) == 1 and stats[1]["after_abort"] == []


@pytest.mark.parametrize("sender,receiver", [("pathway_tpu_torch", "pathway_tpu"), ("pathway_tpu", "pathway_tpu_torch")])
@pytest.mark.parametrize("case", ["roundtrip", "resume", "wrong_secret"])
def test_ferry_wire_crosses_packages(case, sender, receiver, tmp_path, monkeypatch):
    """The ``PWFY1`` handshake, the frames and the segment MACs are the
    reference's: a sender of one package commits into a receiver of the
    other, resumes there, and is refused there under another secret, with
    the outcome of a one-package transfer."""
    same = _ferry_case(case, receiver, receiver, tmp_path / "same", monkeypatch)
    monkeypatch.setenv("PATHWAY_DCN_SECRET", SECRET)
    assert _ferry_case(case, sender, receiver, tmp_path / "cross", monkeypatch) == same


# --- kill=ferry ----------------------------------------------------------------


def _kill_ferry_spec(pkg):
    faults = _mod(pkg, "testing.faults")
    p = faults.FaultPlan("kill=ferry:2", 0, 0)
    with pytest.raises(faults.FaultSpecError):
        faults.FaultPlan("kill=ferry:2,at:head", 0, 0)
    faults.FaultPlan("kill=ferry:1", 0, 1).on_ferry_segment(5)  # another incarnation: no exit
    return p.directives[0].args["ferry"]


def test_kill_ferry_spec_parses_and_rejects_at():
    assert _both(_kill_ferry_spec) == "2"


_FERRY_KILL_CHILD = """
import sys
sys.path.insert(0, {repo!r})
if {pkg!r} == "pathway_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
from {pkg}.elastic.ferry import ferry_files
files = [(f"f{{i}}", bytes([i]) * 128) for i in range(5)]
ferry_files("127.0.0.1", int(sys.argv[1]), files, transfer_id="chaos")
print("FERRY-DONE", flush=True)
"""


def _kill_ferry_mid_handoff(pkg, root):
    ho, ferry = _mod(pkg, "elastic.handover"), _mod(pkg, "elastic.ferry")
    h = ho.TwoPhaseHandover(str(root))
    h.ensure_committed(2)
    h.begin(3)
    recv = ferry.FerryReceiver(str(root / "dst"))
    out = []
    try:
        env = dict(os.environ, PATHWAY_FAULTS="kill=ferry:2", PATHWAY_DCN_SECRET=SECRET, JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        child = [sys.executable, "-c", _FERRY_KILL_CHILD.format(repo=str(REPO), pkg=pkg), str(recv.port)]
        proc = subprocess.run(child, env=env, capture_output=True, text=True, timeout=120)
        out.append((proc.returncode, "FERRY-DONE" in proc.stdout, dict(recv.received), len(recv.staged("chaos"))))
        h.rollback()
        out.append(tuple(vars(h.committed).values()))
        env["PATHWAY_MESH_INCARNATION"] = "1"  # the retry runs under a bumped incarnation
        proc = subprocess.run(child, env=env, capture_output=True, text=True, timeout=120)
        out.append((proc.returncode, "FERRY-DONE" in proc.stdout, sorted(recv.received.get("chaos", {}))))
        h.begin(3)
        out.append(tuple(vars(h.commit()).values()))
    finally:
        recv.close()
    return out


def test_kill_ferry_mid_handoff_rolls_back(tmp_path):
    """A sender killed after its second acknowledged segment (exit 23)
    commits nothing: two segments stay staged and the old map rules; the
    retry resumes and commits, and only then does the new map commit."""
    got = _both(lambda pkg: _kill_ferry_mid_handoff(pkg, tmp_path / pkg))
    assert got[0] == (23, False, {}, 2)
    assert got[1] == (2, 0, "committed")
    assert got[2] == (0, True, [f"f{i}" for i in range(5)])
    assert got[3] == (3, 1, "committed")


# --- the N -> M -> N re-partition ----------------------------------------------


def _gb_node(pkg):
    nodes = _mod(pkg, "engine.nodes")
    ReducerSpec = _mod(pkg, "engine.reducers").ReducerSpec
    gin = nodes.InputNode(_mod(pkg, "engine.runtime").StaticSource(["k", "v"]), ["k", "v"])
    return nodes.GroupByNode(gin, ["k"], {"cnt": ReducerSpec(kind="count", arg_cols=()),
                                          "s": ReducerSpec(kind="sum", arg_cols=("v",))})


def _sharded(pkg, node, n):
    ex = _mod(pkg, "engine.sharded").ShardedGroupByExec(node, SimpleNamespace(shape={"data": n}), "data")
    ex.enable_state_ledger()
    return ex


def _fold(rows):
    state: dict = {}
    for key, diff, vals in rows:
        if diff > 0:
            state[key] = vals
        elif state.get(key) == vals:
            del state[key]
    return state


def _random_phases(seed: int, n_phases: int = 3):
    """Random inserts, retractions and updates with ties and deletions (the
    reference's generator); a retraction always matches a live row."""
    rng = np.random.default_rng(seed)
    live: list = []
    next_key = 1
    phases = []
    for _p in range(n_phases):
        events = []
        for _ in range(rng.integers(30, 60)):
            op = rng.random()
            if op < 0.6 or not live:
                k = next_key
                next_key += 1
                row = (f"g{int(rng.integers(0, 9))}", int(rng.integers(0, 4)))
                live.append((k, row))
                events.append((k, 1, row))
            elif op < 0.8:
                k, row = live.pop(int(rng.integers(0, len(live))))
                events.append((k, -1, row))
            else:
                i = int(rng.integers(0, len(live)))
                k, row = live[i]
                new_row = (row[0], int(rng.integers(0, 4)))
                live[i] = (k, new_row)
                events.append((k, -1, row))
                events.append((k, 1, new_row))
        phases.append(events)
    return phases


def _feed(pkg, ex, t, events):
    DiffBatch = _mod(pkg, "engine.batch").DiffBatch
    out = []
    for b in ex.process(t, [[DiffBatch.from_rows(events, ["k", "v"])]]):
        out.extend((int(k), int(d), tuple(v)) for k, d, v in b.iter_rows())
    return out


def _handoff(pkg, ex_src, node, n_new):
    residual, arrs = ex_src.arranged_state()
    ex_dst = _sharded(pkg, node, n_new)
    assert ex_dst.check_arranged_state(residual, arrs)
    ex_dst.load_arranged_state(residual, arrs)
    return ex_dst


def _n_m_n(pkg, n, m, seed):
    phases = _random_phases(seed)
    node = _gb_node(pkg)
    ref = _sharded(pkg, node, n)
    ref_out = []
    for t, events in enumerate(phases):
        ref_out.extend(_feed(pkg, ref, t, events))
    ex = _sharded(pkg, node, n)
    out = _feed(pkg, ex, 0, phases[0])
    ex = _handoff(pkg, ex, node, m)
    out.extend(_feed(pkg, ex, 1, phases[1]))
    ex = _handoff(pkg, ex, node, n)
    out.extend(_feed(pkg, ex, 2, phases[2]))
    shard_of = _mod(pkg, "engine.sharded").shard_of
    for s, keys in enumerate(ex.shard_group_keys()):
        if keys:
            assert (shard_of(np.asarray(sorted(keys), dtype=np.uint64), n) == s).all()
    return _fold(out), _fold(ref_out), [sorted(k) for k in ex.shard_group_keys()]


@pytest.mark.parametrize("n,m", [(2, 3), (3, 2), (1, 4)])
@pytest.mark.parametrize("seed", [3, 11, 42])
def test_reshard_n_m_n_bit_equal_to_uninterrupted(n, m, seed):
    folded, uninterrupted, _owned = _both(_n_m_n, n, m, seed)
    assert folded == uninterrupted and folded


def _same_count(pkg):
    node = _gb_node(pkg)
    ex = _sharded(pkg, node, 2)
    _feed(pkg, ex, 0, [(1, 1, ("a", 1)), (2, 1, ("b", 2))])
    residual, arrs = ex.arranged_state()
    ex2 = _sharded(pkg, node, 2)
    assert ex2.check_arranged_state(residual, arrs)
    ex2.load_arranged_state(residual, arrs)
    assert ex2.shard_group_keys() == ex.shard_group_keys()
    return [sorted(k) for k in ex2.shard_group_keys()]


def test_same_count_snapshot_unchanged_path():
    _both(_same_count)


def _reshard_capable(pkg):
    return _mod(pkg, "elastic.planner").reshard_capable(_gb_node(pkg))


def test_reshard_capable_resolution():
    assert _both(_reshard_capable) is True


# --- reshard_stores over a real persisted run -----------------------------------


def _pw(pkg):
    pw = importlib.import_module(pkg)
    pw.internals.parse_graph.G.clear()
    return pw


def _write_words(path, words):
    with open(path, "w") as f:
        for w in words:
            f.write(json.dumps({"word": w}) + "\n")


def _folded_counts(path, state=None):
    state = {} if state is None else state
    try:
        lines = [json.loads(ln) for ln in open(path) if ln.strip()]
    except OSError:
        lines = []
    for obj in lines:
        if obj["diff"] > 0:
            state[obj["word"]] = obj["count"]
        elif state.get(obj["word"]) == obj["count"]:
            del state[obj["word"]]
    return state


def _persisted_wordcount(pkg, base: pathlib.Path, want: dict, out_name="out.jsonl", timeout=60.0):
    """A streaming groupby over ``base/in`` persisted under ``base/pstorage``
    (a snapshot every tick), stopped once the output ``base/out_name``
    folds to ``want``; returns the run's persistence driver."""
    pw = _pw(pkg)

    class S(pw.Schema):
        word: str

    t = pw.io.jsonlines.read(str(base / "in"), schema=S, mode="streaming")
    r = t.groupby(t.word).reduce(t.word, count=pw.reducers.count())
    out = base / out_name
    pw.io.jsonlines.write(r, str(out))
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(str(base / "pstorage")),
                                              snapshot_every=1)
    runner = threading.Thread(target=lambda: pw.run(persistence_config=cfg, autocommit_duration_ms=20),
                              daemon=True)
    runner.start()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and _folded_counts(out) != want:
        time.sleep(0.05)
    time.sleep(0.3)  # a few idle ticks: the per-tick snapshot covers the log
    rt = pw.internals.parse_graph.G.runtime
    if rt is not None:
        rt.stop()
    runner.join(timeout=30)
    assert _folded_counts(out) == want
    return pw.internals.parse_graph.G.last_runtime.persistence_driver


WORDS = [f"w{i % 13}" for i in range(60)]
COUNTS = {f"w{i}": sum(1 for w in WORDS if w == f"w{i}") for i in range(13)}


def _arranged_rows(pkg, root):
    """(ident, name, jk, key) -> summed diff over every arranged node of a
    store: the fold-equality fingerprint of a reshard round trip."""
    glue = _mod(pkg, "persistence._runtime_glue")
    store = _mod(pkg, "persistence.backends").FilesystemStore(root)
    load_arrangement = _mod(pkg, "persistence.segments").load_arrangement
    snap = json.loads(store.get("metadata.json").decode())["state"]
    out: dict = {}
    for ident in snap["nodes"]:
        blob = pickle.loads(store.get(glue.state_key(snap["gen"], ident)))
        if not (isinstance(blob, dict) and blob.get("__pw_arranged__")):
            continue
        for name, man in blob["manifests"].items():
            arr = load_arrangement(man, lambda sid, n=name, e=man["epoch"], i=ident:
                                   store.get_buffer(glue.segment_key(i, n, e, sid)))
            rows = arr.entries()
            for jk, key, cnt in zip(rows.jk, rows.key, rows.count):
                k = (name, int(jk), int(key))
                out[k] = out.get(k, 0) + int(cnt)
    return {k: v for k, v in out.items() if v != 0}


def _owned_jks(pkg, root, n):
    """Every arranged row of a new store hashes to its rank under ``n``."""
    shard_of = _mod(pkg, "engine.sharded").shard_of
    rows = _arranged_rows(pkg, root)
    jks = np.asarray(sorted({jk for _n, jk, _k in rows}), dtype=np.uint64)
    return jks, shard_of(jks, n)


_STAT_KEYS = ("total_rows", "moved_rows", "segments_shipped_intact", "segments_split", "segments_kept",
              "nodes_resharded", "monolithic_carried", "plan")


def _stats(res):
    """The counts of a reshard, which both packages must agree on. The group
    time is a wall-clock tick; the byte counts are checked per package, as
    each package pickles its state objects under its own encoding (either
    reads the other's, ``persistence/_pickle.py``)."""
    assert 0 <= res["bytes_ferried"] <= res["bytes_total_segments"]
    assert (res["bytes_ferried"] > 0) == (res["moved_rows"] > 0)
    return {k: res[k] for k in _STAT_KEYS}


def _split_one_into_two(pkg, base):
    (base / "in").mkdir(parents=True)
    _write_words(base / "in" / "w.jsonl", WORDS)
    _persisted_wordcount(pkg, base, COUNTS)
    reshard_stores = _mod(pkg, "elastic.mesh").reshard_stores
    dsts = [str(base / "new0"), str(base / "new1")]
    res = reshard_stores([str(base / "pstorage")], dsts, via_wire=True)
    assert res["ferry"] and res["ferry"][0]["committed"]
    assert not os.path.exists(os.path.join(dsts[1], "reshard", "inbox"))
    owned = []
    for p, root in enumerate(dsts):
        jks, owner = _owned_jks(pkg, root, 2)
        assert (owner == p).all()
        owned.append(jks.tolist())
    assert 0 < res["bytes_ferried"] == res["ferry"][0]["bytes_sent"]
    return _stats(res), owned, [f["segments_sent"] for f in res["ferry"]]


def test_reshard_stores_splits_one_rank_into_two(tmp_path):
    stats, owned, _ferries = _both(lambda pkg: _split_one_into_two(pkg, tmp_path / pkg))
    assert stats["plan"]["n_old"] == 1 and stats["plan"]["n_new"] == 2
    assert 0 < stats["moved_rows"] < stats["total_rows"]
    assert owned[0] and owned[1]


def _split_and_merge(pkg, base):
    (base / "in").mkdir(parents=True)
    _write_words(base / "in" / "w.jsonl", WORDS)
    _persisted_wordcount(pkg, base, COUNTS)
    reshard_stores = _mod(pkg, "elastic.mesh").reshard_stores
    src = str(base / "pstorage")
    before = _arranged_rows(pkg, src)
    two = [str(base / "two0"), str(base / "two1")]
    up = reshard_stores([src], two, via_wire=False)
    assert up["segments_split"] >= 1 and up["transfer_seconds"] > 0
    down = reshard_stores(two, [str(base / "one0")], via_wire=False)
    assert down["segments_split"] == 0 and down["segments_shipped_intact"] >= 1 and down["moved_rows"] > 0
    after = _arranged_rows(pkg, str(base / "one0"))
    assert after == before and before
    return _stats(up), _stats(down), sorted(after.items())


def test_reshard_segment_level_split_and_intact_merge(tmp_path):
    """The 1 → 2 split slices the straddling segments; the 2 → 1 merge ships
    every segment whole; the round trip keeps every arranged row, and both
    packages count and keep the same."""
    _both(lambda pkg: _split_and_merge(pkg, tmp_path / pkg))


def _shrink_guard(pkg, base):
    FilesystemStore = _mod(pkg, "persistence.backends").FilesystemStore
    for r in range(2):
        FilesystemStore(str(base / f"p{r}")).put("metadata.json", json.dumps({
            "last_time": 9 if r == 1 else 5, "chunks": {},
            "live_chunks": {"input-0": [3]} if r == 1 else {},
            "state": {"gen": 1, "time": 5, "nodes": {}, "segment_keys": []},
        }).encode())
    with pytest.raises(_mod(pkg, "elastic.handover").HandoverError, match="retires") as e:
        _mod(pkg, "elastic.mesh").reshard_stores([str(base / "p0"), str(base / "p1")], [str(base / "n0")],
                                                 via_wire=False)
    with pytest.raises(_mod(pkg, "elastic.handover").HandoverError, match="no persistence metadata"):
        _mod(pkg, "elastic.mesh").reshard_stores([str(base / "none")], [str(base / "n1")], via_wire=False)
    return str(e.value)


def test_reshard_shrink_guard_refuses_a_retired_log_tail(tmp_path):
    _both(lambda pkg: _shrink_guard(pkg, tmp_path / pkg))


@pytest.mark.parametrize("owner,resharder", [("pathway_tpu", "pathway_tpu_torch"),
                                             ("pathway_tpu_torch", "pathway_tpu")])
def test_store_resharded_by_the_other_package_restores(tmp_path, owner, resharder):
    """A store written by ``owner`` is resharded 1 → 2 → 1 in place by
    ``resharder`` (over the ferry's wire); ``owner`` restores the merged
    store with zero replayed events and counts on from the totals."""
    (tmp_path / "in").mkdir()
    _write_words(tmp_path / "in" / "w.jsonl", WORDS)
    _persisted_wordcount(owner, tmp_path, COUNTS)
    reshard_stores = _mod(resharder, "elastic.mesh").reshard_stores
    # rank 0 keeps its root (its input offsets and log stay in place), as a
    # supervised resize does
    two = [str(tmp_path / "pstorage"), str(tmp_path / "two1")]
    assert reshard_stores(two[:1], two, via_wire=True)["bytes_ferried"] > 0
    assert reshard_stores(two, two[:1], via_wire=True)["bytes_ferried"] > 0
    _write_words(tmp_path / "in" / "w2.jsonl", ["w0", "w0", "zz"])
    drv = _persisted_wordcount(owner, tmp_path, {"w0": COUNTS["w0"] + 2, "zz": 1}, out_name="out2.jsonl")
    assert drv.restored_from_snapshot and drv.replayed_events == 0


# --- the serving plane and the doctor --------------------------------------------


def _router_swap(pkg):
    r = _mod(pkg, "serving.router").FailoverRouter(["http://127.0.0.1:1"])
    before = r.n_shards
    r.swap_shard_map([["http://127.0.0.1:1"], ["http://127.0.0.1:2"]])
    with pytest.raises(ValueError):
        r.swap_shard_map([[]])
    return before, r.n_shards, [ep.shard for ep in r.endpoints]


def test_router_swap_shard_map_before_start():
    assert _both(_router_swap) == (1, 2, [0, 1])


def _adopted_before_the_swap(pkg, monkeypatch):
    """Two members of a one-shard plane adopt a 1 -> 2 reshard; a read
    routed under the router's old map reaches a member that already owns
    half the corpus (the router's health poll is too slow to eject it).
    Returns (status, the keys answered, the plain top-10's keys)."""
    import http.client

    from pathway_tpu_torch.engine.batch import DiffBatch

    replicate = _mod(pkg, "parallel.replicate")
    ReplicaServer = _mod(pkg, "serving.replica").ReplicaServer
    FailoverRouter = _mod(pkg, "serving.router").FailoverRouter
    index_cls = _mod(pkg, "stdlib.indexing._index_impls").TpuDenseKnnIndex
    batch_cls = DiffBatch if pkg == "pathway_tpu_torch" else _mod(pkg, "engine.batch").DiffBatch
    kw = {"device": "cpu"} if pkg == "pathway_tpu_torch" else {}
    rng = np.random.default_rng(5)
    n, d = 512, 16
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    keys = np.arange(1, n + 1, dtype=np.uint64)
    data = np.empty(n, dtype=object)
    data[:] = list(vecs)
    srv = replicate.DeltaStreamServer(0, ring_ticks=8, n_shards=1)
    srv.publish(0, [batch_cls(keys, np.ones(n, np.int64), {"_data": data, "_meta": np.full(n, None, object)})])
    reps = [ReplicaServer(replica_id=i, index_factory=lambda: index_cls(dimensions=d, **kw), writer_port=srv.port,
                          dim=d, **kw).start() for i in range(2)]
    router = None
    try:
        deadline = time.monotonic() + 30
        while not all(r.ready and len(r.index) == n for r in reps) and time.monotonic() < deadline:
            time.sleep(0.02)
        router = FailoverRouter([f"http://127.0.0.1:{r.http_port}" for r in reps], health_interval_ms=60_000).start()

        def ask():
            c = http.client.HTTPConnection("127.0.0.1", router.port, timeout=30)
            c.request("POST", "/query", body=json.dumps({"vec": vecs[7].tolist(), "k": 10}),
                      headers={"content-type": "application/json"})
            r = c.getresponse()
            out = (r.status, json.loads(r.read()))
            c.close()
            return out

        deadline = time.monotonic() + 30
        while ask()[0] != 200 and time.monotonic() < deadline:
            time.sleep(0.05)
        srv.reshard(2)
        for i, r in enumerate(reps):
            r.adopt_shard_map(i, 2)
        status, body = ask()
    finally:
        if router is not None:
            router.stop()
        for r in reps:
            r.stop()
        srv.close()
    unit = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    plain = (np.argsort(-(unit @ unit[7]), kind="stable")[:10] + 1).tolist()
    got = [int(k) for k, _s in body.get("matches", [])] if status == 200 else []
    return status, got, plain


def test_a_member_that_adopted_a_reshard_refuses_the_old_maps_reads(monkeypatch):
    """Between the members' adoption of a reshard and the router's swap, the
    JAX package's router serves a read from the member it reaches: half the
    corpus, with a 200. The port's router names its map's shard count with
    every attempt, and a member that splits the corpus another way answers
    503 (a fault of the reference the port repairs, ``ROADMAP.md`` §3)."""
    status, got, plain = _adopted_before_the_swap("pathway_tpu", monkeypatch)
    assert status == 200 and got != plain
    status, got, _plain = _adopted_before_the_swap("pathway_tpu_torch", monkeypatch)
    assert status == 503 and got == []


def _elastic_rule(pkg, monkeypatch):
    pw = _pw(pkg)
    t = pw.debug.table_from_markdown(
        """
        k | v
        a | 1
        b | 2
        """
    )
    t2 = pw.debug.table_from_markdown(
        """
          | k | v
        9 | c | 3
        """
    )
    pw.io.null.write(t.update_rows(t2))
    silent = pw.analysis.run_doctor().by_rule("elastic-resharding")
    with monkeypatch.context() as m:
        m.setenv("PATHWAY_PROCESSES", "2")
        diags = pw.analysis.run_doctor().by_rule("elastic-resharding")
    return (len(silent), sorted((d.severity.name, "UpdateRowsNode" in d.message) for d in diags))


def test_elastic_resharding_rule(monkeypatch):
    """Silent in one process; in a two-process group the monolithic
    ``update_rows`` state pins resizes to log replay: a WARNING, and an INFO
    naming the exec, in both packages."""
    silent, diags = _both(_elastic_rule, monkeypatch)
    assert silent == 0 and ("WARNING", False) in diags and ("INFO", True) in diags


# --- the supervised 2 -> 3 resize with zero replay ------------------------------


def _supervised_resize(pkg, tmp_path):
    """The reference's supervised case under ``pkg``: a two-rank group of
    ``RESHARD_WORKER_SCRIPT`` resized to three ranks through
    ``GroupSupervisor.resize`` + ``reshard_stores``; returns (the folded
    outputs, each rank's replayed events in the new incarnation, the
    supervisor's event kinds)."""
    chaos = _mod(pkg, "testing.chaos")
    reshard_stores = _mod(pkg, "elastic.mesh").reshard_stores
    base = tmp_path / "work"
    for pid in range(3):
        (base / f"in{pid}").mkdir(parents=True)
    script = tmp_path / "worker.py"
    script.write_text(chaos.RESHARD_WORKER_SCRIPT)
    for pid, words in {0: ["a", "b", "a", "c", "a"], 1: ["b", "c", "d", "a", "d"]}.items():
        _write_words(base / f"in{pid}" / "f1.jsonl", words)
    env = {"PW_TEST_DIR": str(base), "PATHWAY_DCN_PORT": str(chaos.free_dcn_port(3)),
           "PATHWAY_DCN_SECRET": SECRET, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO), "XLA_FLAGS": ""}
    roots = [str(base / f"pstorage{p}") for p in range(3)]
    sup = _mod(pkg, "parallel.supervisor").GroupSupervisor(
        [sys.executable, str(script)], 2, env=env, max_restarts=1, grace_s=25.0, log_dir=str(base / "logs"))
    th = threading.Thread(target=sup.run, daemon=True)
    th.start()

    def fold_until(paths, want, timeout=120.0):
        deadline = time.monotonic() + timeout
        while True:
            folded = chaos.fold_diff_stream(paths, ["word"])
            if folded == want or time.monotonic() > deadline:
                return folded
            time.sleep(0.2)

    try:
        p1 = {("a",): (4,), ("b",): (2,), ("c",): (2,), ("d",): (2,)}
        assert fold_until([base / f"out{p}_inc0.jsonl" for p in range(2)], p1) == p1
        sup.resize(3, reshard=lambda: reshard_stores(roots[:2], roots))
        deadline = time.monotonic() + 120
        while not any(e[1] == "group-resize" for e in sup.events) and time.monotonic() < deadline:
            time.sleep(0.1)
        for pid, words in {0: ["a", "e"], 1: ["e", "b"], 2: ["f", "a", "d"]}.items():
            _write_words(base / f"in{pid}" / "f2.jsonl", words)
        expected = {("a",): (6,), ("b",): (3,), ("c",): (2,), ("d",): (3,), ("e",): (2,), ("f",): (1,)}
        # incarnation-major: all inc-0 activity precedes inc-1
        folded = fold_until([base / f"out{p}_inc{i}.jsonl" for i in range(2) for p in range(3)], expected)
        (base / "STOP").touch()
        th.join(timeout=90)
        assert not th.is_alive(), "the supervised group never stopped"
        replayed = {}
        for p in range(3):
            log = base / "logs" / f"rank{p}-inc1.log"
            for line in (log.read_text().splitlines() if log.exists() else []):
                if line.startswith("REPLAYED "):
                    replayed[p] = int(line.split()[1])
        return folded, replayed, [e[1] for e in sup.events if e[1] in ("group-resize", "resize-rollback")]
    finally:
        (base / "STOP").touch()
        sup.stop()
        th.join(timeout=30)


def test_supervised_group_resizes_2_to_3_with_zero_replay(tmp_path):
    """The port's group grows from 2 to 3 ranks through the supervisor and
    ``reshard_stores``: every rank of the new incarnation restores moved
    state with zero replayed events, and the folded outputs equal the
    uninterrupted totals."""
    folded, replayed, events = _supervised_resize("pathway_tpu_torch", tmp_path)
    assert events == ["group-resize"]
    assert replayed == {0: 0, 1: 0, 2: 0}
    assert folded == {("a",): (6,), ("b",): (3,), ("c",): (2,), ("d",): (3,), ("e",): (2,), ("f",): (1,)}


@pytest.mark.slow
def test_supervised_resize_equal_in_both_packages(tmp_path):
    got = {pkg: _supervised_resize(pkg, tmp_path / pkg) for pkg in PACKAGES}
    assert got["pathway_tpu_torch"] == got["pathway_tpu"]
