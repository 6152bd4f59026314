"""The port's DCN execs and group persistence on the CPU, held against the
JAX package (the reference's kill/restart matrix, torn-manifest recovery
and ``tests/test_distributed_ops.py`` as port cases).

* Every stateful operator type in a two-process port group — dedup, sort
  (per instance, aligned, global), update_rows, intersect, difference,
  ix, gradual broadcast, windowby with a behavior, iterate, and the
  external index — unions to what the JAX package computes in ONE process
  on the same rows, row keys and values exact.
* Kill and restart: rank 1 dies mid-stream, rank 0 fail-stops with
  ``HostMeshError`` naming peer 1, and a respawned group resumes from its
  group-committed generation to the folded output of the JAX package's
  single-process run over all the rows — for a wordcount, a groupby with
  sum and max, a windowby with a behavior and a deduplicate, after a torn
  snapshot, and from a store written by a two-process JAX-package group.

Each group has its own deadline and its children are killed when it ends
(``torch_group.py``)."""

from __future__ import annotations

import json
import threading
import time

import pytest

from pathway_tpu_torch.testing.chaos import fold_diff_stream, free_dcn_port
from torch_group import results, spawn_group, worker

FAULT_EXIT = 23  # testing/faults.py, both packages

# one pipeline per PW_PIPELINE, streaming from in<pid>/ with persistence
# under pstorage<pid>/, or — PW_STATIC=1 — the same pipeline over every
# rank's input in all/, static, in one process: the reference run
_MATRIX = worker(
    """
    base = pathlib.Path(os.environ["PW_TEST_DIR"])
    static = os.environ.get("PW_STATIC") == "1"
    out_file = base / (f"ref_{PKG}.jsonl" if static else f"out{PID}_{os.environ['PW_PHASE']}.jsonl")
    stop_file = base / "STOP"
    die_after = int(os.environ.get("PW_DIE_AFTER_ROWS", "0"))
    pipeline = os.environ["PW_PIPELINE"]
    phase_outs = [base / f"out{p}_{os.environ.get('PW_PHASE')}.jsonl" for p in range(N)]

    class S(pw.Schema):
        k: str
        t: int
        v: int

    src = str(base / "all") if static else str(base / f"in{PID}")
    rows = pw.io.jsonlines.read(src, schema=S, mode="static" if static else "streaming")
    if pipeline == "wordcount":
        r = rows.groupby(rows.k).reduce(rows.k, count=pw.reducers.count())
    elif pipeline == "groupby_sum":
        r = rows.groupby(rows.k).reduce(
            rows.k, s=pw.reducers.sum(rows.v), mx=pw.reducers.max(rows.v), cnt=pw.reducers.count())
    elif pipeline == "windowby":
        r = rows.windowby(
            rows.t, window=pw.temporal.tumbling(duration=4), instance=rows.k,
            behavior=pw.temporal.common_behavior(delay=2, cutoff=100, keep_results=True),
        ).reduce(k=pw.this._pw_instance, start=pw.this._pw_window_start,
                 cnt=pw.reducers.count(), s=pw.reducers.sum(pw.this.v))
    elif pipeline == "dedup":
        r = rows.deduplicate(value=rows.v, instance=rows.k, acceptor=lambda new, old: new > old,
                             name="dedup_max")
    else:
        raise SystemExit(f"unknown pipeline {pipeline}")
    pw.io.jsonlines.write(r, str(out_file))
    if static:
        pw.run()
        print("CLEAN-EXIT", flush=True)
        raise SystemExit(0)

    def watch():
        while True:
            time.sleep(0.05)
            n = 0
            for p in phase_outs:
                try:
                    n += sum(1 for _ in open(p))
                except OSError:
                    pass
            if die_after and n >= die_after:
                os._exit(17)
            if stop_file.exists():
                rt = pw.internals.parse_graph.G.runtime
                if rt is not None:
                    rt.stop()
                return

    threading.Thread(target=watch, daemon=True).start()
    cfg = pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(str(base / f"pstorage{PID}")),
        snapshot_every=int(os.environ.get("PW_SNAPSHOT_EVERY", "8")),
    )
    pw.run(persistence_config=cfg, autocommit_duration_ms=20)
    drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
    print("REPLAYED %d" % drv.replayed_events, flush=True)
    print("CLEAN-EXIT", flush=True)
    """
)

KEYS = {"wordcount": ["k"], "groupby_sum": ["k"], "windowby": ["k", "start"], "dedup": ["k"]}


class _Matrix:
    """The shared two-process kill/restart driver."""

    def __init__(self, tmp_path, pipeline, first_pkg="pathway_tpu_torch"):
        self.base = tmp_path / "work"
        for pid in range(2):
            (self.base / f"in{pid}").mkdir(parents=True)
        (self.base / "all").mkdir()
        self.script = tmp_path / "worker.py"
        self.script.write_text(_MATRIX)
        self.pipeline = pipeline
        self.first_pkg = first_pkg

    def write(self, pid, fname, rows):
        for d, name in ((self.base / f"in{pid}", fname), (self.base / "all", f"{pid}_{fname}")):
            with open(d / name, "w") as f:
                for r in rows:
                    f.write(json.dumps(r) + "\n")

    def phase(self, phase, extra=lambda pid: {}, pkg="pathway_tpu_torch", timeout=200):
        return spawn_group(self.script, 2, free_dcn_port(2), lambda pid: {
            "PW_TEST_DIR": str(self.base), "PW_PIPELINE": self.pipeline, "PW_PHASE": str(phase),
            **extra(pid)}, timeout=timeout, pkg=pkg)

    def outs(self):
        return [self.base / f"out{pid}_{ph}.jsonl" for pid in range(2) for ph in (1, 2)]

    def reference(self) -> dict:
        """The JAX package's single-process static run over every row."""
        procs, outs = spawn_group(self.script, 1, free_dcn_port(1), lambda pid: {
            "PW_TEST_DIR": str(self.base), "PW_PIPELINE": self.pipeline, "PW_STATIC": "1"}, pkg="pathway_tpu")
        assert procs[0].returncode == 0, outs[0][-3000:]
        return fold_diff_stream([self.base / "ref_pathway_tpu.jsonl"], KEYS[self.pipeline])

    def kill_phase(self, die_env=None):
        """Phase 1: rank 1 dies; rank 0 fail-stops naming peer 1."""
        die_env = die_env or {"PW_DIE_AFTER_ROWS": "2"}
        procs, outs = self.phase(1, lambda pid: die_env if pid == 1 else {}, pkg=self.first_pkg)
        assert procs[1].returncode in (17, FAULT_EXIT), outs[1][-2000:]
        assert procs[0].returncode != 0, outs[0][-2000:]
        assert "HostMeshError" in outs[0] and "peer(s) [1]" in outs[0], outs[0][-2000:]
        return procs, outs

    def resume(self, expected, live=None):
        """Phase 2: the whole group restarts from persistence; a stopper ends
        it once the folded outputs reach ``live`` (default ``expected``)."""
        target = live if live is not None else expected
        keys = KEYS[self.pipeline]

        # generous under a loaded host: the stopper ends the group as soon
        # as the outputs converge
        def stopper():
            deadline = time.time() + 150
            while time.time() < deadline:
                merged = fold_diff_stream(self.outs(), keys)
                if live is not None:
                    merged = {k: v for k, v in merged.items() if k in live}
                if merged == target:
                    break
                time.sleep(0.2)
            (self.base / "STOP").touch()

        st = threading.Thread(target=stopper, daemon=True)
        st.start()
        procs, outs = self.phase(2)
        st.join(timeout=180)
        for pid, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"phase2 pid={pid}:\n{out[-3000:]}"
            assert "CLEAN-EXIT" in out
        assert fold_diff_stream(self.outs(), keys) == expected
        return outs


_ROWS = {
    "wordcount": (
        {0: [{"k": w, "t": 0, "v": 0} for w in "abacadb"], 1: [{"k": w, "t": 0, "v": 0} for w in "bceaefa"]},
        {0: [{"k": w, "t": 1, "v": 0} for w in "agd"], 1: [{"k": w, "t": 1, "v": 0} for w in "gbe"]},
    ),
    "groupby_sum": (
        {0: [{"k": "x", "t": 0, "v": 3}, {"k": "y", "t": 1, "v": 5}, {"k": "x", "t": 2, "v": 4}],
         1: [{"k": "y", "t": 0, "v": 2}, {"k": "z", "t": 1, "v": 7}, {"k": "x", "t": 2, "v": 1}]},
        {0: [{"k": "z", "t": 3, "v": 10}], 1: [{"k": "x", "t": 3, "v": 6}]},
    ),
    "windowby": (
        {0: [{"k": "a", "t": t, "v": t} for t in (0, 1, 3, 5, 6)],
         1: [{"k": "b", "t": t, "v": 2 * t} for t in (2, 4, 7)]},
        # high sentinel times on both ranks so every earlier window crosses
        # the delay threshold group-wide
        {0: [{"k": "a", "t": 9, "v": 9}, {"k": "a", "t": 40, "v": 0}],
         1: [{"k": "b", "t": 11, "v": 22}, {"k": "b", "t": 41, "v": 0}]},
    ),
    "dedup": (
        {0: [{"k": "a", "t": 0, "v": 3}, {"k": "b", "t": 0, "v": 10}, {"k": "a", "t": 0, "v": 7},
             {"k": "c", "t": 0, "v": 1}],
         1: [{"k": "b", "t": 0, "v": 2}, {"k": "c", "t": 0, "v": 5}, {"k": "a", "t": 0, "v": 6},
             {"k": "d", "t": 0, "v": 4}]},
        # lower values must not regress the accepted max
        {0: [{"k": "a", "t": 1, "v": 2}, {"k": "d", "t": 1, "v": 9}],
         1: [{"k": "b", "t": 1, "v": 11}, {"k": "e", "t": 1, "v": 8}]},
    ),
}


@pytest.mark.parametrize("pipeline", ["wordcount", "groupby_sum", "windowby", "dedup"])
def test_two_process_kill_restart(tmp_path, pipeline):
    """Rank 1 dies after two output rows; rank 0 fail-stops; the whole group
    restarts from persistence and the folded outputs equal the JAX
    package's single-process run over every row exactly."""
    m = _Matrix(tmp_path, pipeline)
    rows1, rows2 = _ROWS[pipeline]
    for pid, rows in rows1.items():
        m.write(pid, "f1.jsonl", rows)
    m.kill_phase()
    for pid, rows in rows2.items():
        m.write(pid, "f2.jsonl", rows)
    expected = m.reference()
    assert expected
    # windows past the sentinels flush only on a clean shutdown
    live = {k: v for k, v in expected.items() if k[1] < 40} if pipeline == "windowby" else None
    m.resume(expected, live)


def test_two_process_torn_manifest_recovery(tmp_path):
    """A Fault Forge torn snapshot on rank 0 (death between the segment
    writes and the metadata commit at a group-safe snapshot point): the
    group fail-stops, a clean restart restores the previous consistent
    generation, and the folded outputs equal the JAX package's
    single-process run."""
    m = _Matrix(tmp_path, "groupby_sum")
    m.write(0, "f1.jsonl", [{"k": "x", "t": i, "v": i} for i in range(5)])
    m.write(1, "f1.jsonl", [{"k": "y", "t": i, "v": 2 * i} for i in range(5)])
    phase1 = [m.base / f"out{p}_1.jsonl" for p in range(2)]

    # the group-safe snapshot fires at the head of the 2nd data tick
    # (snapshot_every=1): feed the second batch once the first tick's
    # output is visible, so the torn directive hits that commit
    def feed_second_tick():
        deadline = time.time() + 90
        while time.time() < deadline:
            if fold_diff_stream(phase1, ["k"]):
                break
            time.sleep(0.2)
        for pid in range(2):
            m.write(pid, "f1b.jsonl", [{"k": "w", "t": 6 + pid, "v": 1}])

    feeder = threading.Thread(target=feed_second_tick, daemon=True)
    feeder.start()
    procs, outs = m.phase(1, lambda pid: {"PW_SNAPSHOT_EVERY": "1",
                                          **({"PATHWAY_FAULTS": "torn=nth:1,pid:0"} if pid == 0 else {})})
    feeder.join(timeout=10)
    assert procs[0].returncode == FAULT_EXIT, outs[0][-2000:]
    assert procs[1].returncode != 0, outs[1][-2000:]
    m.write(0, "f2.jsonl", [{"k": "x", "t": 9, "v": 100}])
    m.write(1, "f2.jsonl", [{"k": "z", "t": 9, "v": 7}])
    expected = m.reference()
    assert expected == {("x",): (6, 100, 110), ("y",): (5, 8, 20), ("w",): (2, 1, 2), ("z",): (1, 7, 7)}
    m.resume(expected)


def test_jax_group_store_resumes_in_a_port_group(tmp_path):
    """A store written by a two-process JAX-package group killed midway is
    resumed by a port group, to the JAX package's single-process output."""
    m = _Matrix(tmp_path, "groupby_sum", first_pkg="pathway_tpu")
    rows1, rows2 = _ROWS["groupby_sum"]
    for pid, rows in rows1.items():
        m.write(pid, "f1.jsonl", rows)
    m.kill_phase()
    assert any((m.base / f"pstorage{p}" / "metadata.json").exists() for p in range(2))
    for pid, rows in rows2.items():
        m.write(pid, "f2.jsonl", rows)
    m.resume(m.reference())


# every op section prints one "RESULT <tag> <json>" line; rows shard
# round-robin by PATHWAY_PROCESS_ID so each process feeds a disjoint slice
_OPS = worker(
    """
    G = pw.internals.parse_graph.G

    def mine(rows):
        # the GLOBAL row index as an explicit primary key: row keys are
        # then value hashes, identical under any process count
        return [(i, *r) for i, r in enumerate(rows) if i % N == PID]

    def emit(tag, table):
        keys, cols = pw.debug.table_to_dicts(table)
        names = sorted(cols)
        out = {str(k): [str(cols[c].get(k)) for c in names] for k in keys}
        print("RESULT " + json.dumps([tag, out], sort_keys=True), flush=True)

    G.clear()
    class SD(pw.Schema):
        idx: int = pw.column_definition(primary_key=True)
        v: int
        inst: int
    t = pw.debug.table_from_rows(SD, mine([(i, i % 3) for i in range(20)]))
    emit("dedup", t.deduplicate(value=t.v, instance=t.inst, acceptor=lambda new, old: new > old))

    G.clear()
    class SS(pw.Schema):
        idx: int = pw.column_definition(primary_key=True)
        v: int
        inst: int
    t = pw.debug.table_from_rows(SS, mine([((i * 7) % 13, i % 2) for i in range(12)]))
    emit("sort_inst", t.sort(key=t.v, instance=t.inst))
    # aligned join-back: prev/next rows must live on the process feeding
    # the input row, or this multi-input row-wise select sees half a row
    G.clear()
    t = pw.debug.table_from_rows(SS, mine([((i * 7) % 13, i % 2) for i in range(12)]))
    s = t.sort(key=t.v, instance=t.inst)
    emit("sort_align", t.select(t.v, t.inst, p=s.prev, nx=s.next))
    G.clear()
    t = pw.debug.table_from_rows(SS, mine([((i * 5) % 11, 0) for i in range(10)]))
    emit("sort_global", t.sort(key=t.v))

    G.clear()
    class SU(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        val: str
    l = pw.debug.table_from_rows(SU, [r[1:] for r in mine([(i, f"L{i}") for i in range(8)])])
    r = pw.debug.table_from_rows(SU, [r[1:] for r in mine([(i, f"R{i}") for i in range(4, 11)])])
    emit("update_rows", l.update_rows(r))

    for op in ("intersect", "difference"):
        G.clear()
        a = pw.debug.table_from_rows(SU, [r[1:] for r in mine([(i, f"A{i}") for i in range(10)])])
        b = pw.debug.table_from_rows(SU, [r[1:] for r in mine([(i, f"B{i}") for i in range(5, 15)])])
        emit(op, getattr(a, op)(b))

    G.clear()
    class SA(pw.Schema):
        name: str = pw.column_definition(primary_key=True)
        genus: str
    class SB(pw.Schema):
        bird: str = pw.column_definition(primary_key=True)
        ref: str
    animals = pw.debug.table_from_rows(SA, [r[1:] for r in mine([(f"a{i}", f"g{i}") for i in range(8)])])
    birds = pw.debug.table_from_rows(SB, [r[1:] for r in mine([(f"b{i}", f"a{(i * 3) % 8}") for i in range(8)])])
    birds = birds.with_columns(ptr=animals.pointer_from(birds.ref))
    emit("ix", birds.select(latin=animals.ix(birds.ptr).genus))

    # the threshold table is fed on the LAST process only: replication
    # must carry it everywhere
    G.clear()
    class SV(pw.Schema):
        idx: int = pw.column_definition(primary_key=True)
        v: int
    class ST(pw.Schema):
        tid: int = pw.column_definition(primary_key=True)
        lower: int
        value: int
        upper: int
    data = pw.debug.table_from_rows(SV, mine([(i,) for i in range(30)]))
    thr = pw.debug.table_from_rows(ST, [(0, 0, 7, 10)] if PID == N - 1 else [])
    emit("gbcast", data._gradual_broadcast(thr, thr.lower, thr.value, thr.upper))

    # the release watermark of a behavior must be the GROUP max time
    G.clear()
    class SW(pw.Schema):
        idx: int = pw.column_definition(primary_key=True)
        inst: int
        t: int
        v: int
    t = pw.debug.table_from_rows(SW, mine([(i % 3, (i * 11) % 40, i) for i in range(60)]))
    emit("window_behavior", t.windowby(
        t.t, window=pw.temporal.tumbling(duration=10), instance=t.inst,
        behavior=pw.temporal.common_behavior(delay=5),
    ).reduce(pw.this._pw_instance, start=pw.this._pw_window_start, s=pw.reducers.sum(pw.this.v)))

    # the external index: the corpus side is broadcast, queries answer on
    # the process that holds them
    G.clear()
    import numpy as np
    class SX(pw.Schema):
        idx: int = pw.column_definition(primary_key=True)
        vec: np.ndarray
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(40, 8)).astype(np.float32)
    docs = pw.debug.table_from_rows(SX, [(i, vecs[i]) for i in range(40) if i % N == PID])
    qs = pw.debug.table_from_rows(SX, [(100 + i, vecs[3 * i] + 0.01) for i in range(10) if i % N == PID])
    knn = {"device": "cpu"} if PKG == "pathway_tpu_torch" else {}
    index = pw.stdlib.indexing.DataIndex(docs, pw.stdlib.indexing.TpuKnn(docs.vec, dimensions=8, **knn))
    emit("external_index", index.query_as_of_now(qs.vec, number_of_matches=3).select(
        q=pw.left.idx, ids=pw.right.idx))
    if N > 1:
        dcn = importlib.import_module(PKG + ".engine.dcn")
        rt = G.last_runtime
        assert any(isinstance(e, dcn.DcnExternalIndexExec) for e in rt.execs.values())

    # the fixpoint centralizes on process 0, which builds the body's nodes
    # alone: node ids (and so channel names) differ between the ranks
    # after it, so it runs last and the aligned consumer in a worker of its
    # own, as in the reference
    G.clear()
    class SI(pw.Schema):
        idx: int = pw.column_definition(primary_key=True)
        v: int
    t = pw.debug.table_from_rows(SI, mine([(5,), (7,), (12,), (20,)]))
    emit("iterate", pw.iterate(lambda tab: tab.select(tab.idx, v=pw.if_else(tab.v > 10, tab.v - 3, tab.v)), tab=t))
    print("WORKER-DONE", flush=True)
    """
)


_ITER_ALIGNED = worker(
    """
    def mine(rows):
        return [(i, *r) for i, r in enumerate(rows) if i % N == PID]

    class SI(pw.Schema):
        idx: int = pw.column_definition(primary_key=True)
        v: int
    t = pw.debug.table_from_rows(SI, mine([(5 + 4 * i,) for i in range(6)]))
    res = pw.iterate(lambda tab: tab.select(tab.idx, v=pw.if_else(tab.v > 10, tab.v - 3, tab.v)),
                     tab=t).with_universe_of(t)
    keys, cols = pw.debug.table_to_dicts(t.select(orig=t.v, done=res.v))
    out = {str(k): [str(cols[c].get(k)) for c in sorted(cols)] for k in keys}
    print("RESULT " + json.dumps(["iterate_aligned", out], sort_keys=True), flush=True)
    print("WORKER-DONE", flush=True)
    """
)


def _ops_results(procs, outs) -> dict:
    merged: dict[str, dict] = {}
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert "WORKER-DONE" in out, out[-4000:]
    for tag, part in results(procs, outs):
        into = merged.setdefault(tag, {})
        for k, v in part.items():
            assert k not in into or into[k] == v, f"{tag}: key {k} on two processes: {into[k]} vs {v}"
            into[k] = v
    return merged


@pytest.mark.parametrize("which", ["stateful_ops", "iterate_aligned"])
def test_two_process_stateful_ops_match_single_process(tmp_path, which):
    """Every stateful operator type's two-process union equals the JAX
    package's single-process result, row keys included."""
    script = tmp_path / "ops.py"
    script.write_text(_OPS if which == "stateful_ops" else _ITER_ALIGNED)
    single = _ops_results(*spawn_group(script, 1, free_dcn_port(1), pkg="pathway_tpu", timeout=240))
    double = _ops_results(*spawn_group(script, 2, free_dcn_port(2), timeout=240))
    assert set(single) == set(double) and len(single) == (12 if which == "stateful_ops" else 1)
    for tag in sorted(single):
        assert single[tag], tag
        assert double[tag] == single[tag], (
            f"{tag}: 2-process union != single-process result\n"
            f"single={json.dumps(single[tag], sort_keys=True)[:2000]}\n"
            f"double={json.dumps(double[tag], sort_keys=True)[:2000]}"
        )


def test_matrix_worker_reference_needs_no_group(tmp_path):
    """The reference run of the matrix is one JAX-package process over the
    union of the ranks' inputs; the copy of every input it reads is
    complete."""
    m = _Matrix(tmp_path, "wordcount")
    rows1, rows2 = _ROWS["wordcount"]
    for pid in range(2):
        m.write(pid, "f1.jsonl", rows1[pid])
        m.write(pid, "f2.jsonl", rows2[pid])
    assert sorted(p.name for p in (m.base / "all").iterdir()) == [
        "0_f1.jsonl", "0_f2.jsonl", "1_f1.jsonl", "1_f2.jsonl"]
    ref = m.reference()
    assert ref == {(w,): (n,) for w, n in {"a": 6, "b": 4, "c": 2, "d": 2, "e": 3, "f": 1, "g": 2}.items()}
