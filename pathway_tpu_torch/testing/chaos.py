"""Shared helpers for chaos/recovery harnesses — the port's own copy of
``pathway_tpu/testing/chaos.py``. The two worker scripts run on the CPU
(``CUDA_VISIBLE_DEVICES=""`` where the reference pins jax to the CPU), alone
or under the group supervisor (``parallel/supervisor.py``).

The kill/restart matrix in ``tests/test_distributed.py`` and the
``bench.py chaos_recovery`` tier drive the same shape of experiment: a
multi-process DCN group writing jsonlines diff streams whose FOLDED
state must converge on the uninterrupted run's totals.  The folding
rules (``diff > 0`` installs a key's value, ``diff < 0`` removes it only
when it matches — a rewound incarnation may re-emit retractions the fold
must tolerate) and the mesh port probing are shared here so the two
harnesses cannot drift.
"""

from __future__ import annotations

import json
import random
import socket
import textwrap

# Replica Shield writer role, shared by the test chaos matrix
# (tests/test_distributed.py) and the `bench.py serve_chaos` tier so the
# two harnesses drive the SAME pipeline: streaming jsonlines docs ->
# deterministic pseudo-embedding -> TpuKnn external index (+ an empty
# query stream), persistence snapshots, and the PATHWAY_REPL_PORT delta
# publisher.  Env contract: PW_WRITER_DIR (base dir with docs/ and q/
# subdirs; a STOP file there stops the run), PATHWAY_REPLICA_DIM,
# PATHWAY_REPL_PORT, PATHWAY_DCN_SECRET.
REPL_WRITER_SCRIPT = textwrap.dedent(
    """
    import os, sys, json, time, pathlib, threading
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.serving.replica import text_vector

    base = pathlib.Path(os.environ["PW_WRITER_DIR"])
    DIM = int(os.environ["PATHWAY_REPLICA_DIM"])
    stop_file = base / "STOP"

    class DocS(pw.Schema):
        text: str

    docs = pw.io.jsonlines.read(
        str(base / "docs"), schema=DocS, mode="streaming"
    )
    docs = docs.select(
        vec=pw.apply(lambda t: text_vector(t, DIM), docs.text),
        text=docs.text,
    )
    queries = pw.io.jsonlines.read(
        str(base / "q"), schema=DocS, mode="streaming"
    )
    queries = queries.select(
        vec=pw.apply(lambda t: text_vector(t, DIM), queries.text)
    )
    from pathway_tpu_torch.stdlib.indexing import DataIndex, TpuKnn

    index = DataIndex(docs, TpuKnn(docs.vec, dimensions=DIM, device="cpu"))
    res = index.query_as_of_now(queries.vec, number_of_matches=2).select(
        texts=pw.right.text
    )
    pw.io.null.write(res)

    def watch():
        # Shard Flux: a RESHARD file holding an int resplits the delta
        # publisher's shard map live (harness-scriptable — the writer
        # subprocess has no other control channel); consumed once per
        # content change.
        reshard_file = base / "RESHARD"
        last_reshard = None
        while not stop_file.exists():
            time.sleep(0.1)
            if reshard_file.exists():
                try:
                    want = int(reshard_file.read_text().strip())
                except (ValueError, OSError):
                    continue
                if want != last_reshard:
                    from pathway_tpu_torch.parallel import replicate
                    pub = replicate.publisher()
                    if pub is not None:
                        res = pub.reshard(want)
                        last_reshard = want
                        print("WRITER-RESHARDED %s" % json.dumps(res),
                              flush=True)
        rt = pw.internals.parse_graph.G.runtime
        if rt is not None:
            rt.stop()

    threading.Thread(target=watch, daemon=True).start()
    cfg = pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(str(base / "pstorage")),
        snapshot_every=2,
    )
    pw.run(persistence_config=cfg, autocommit_duration_ms=30)
    print("WRITER-CLEAN-EXIT", flush=True)
    """
)


# Shard Flux mesh-resize worker, shared by tests/test_elastic.py and
# the `bench.py reshard_live` tier: a supervised jsonlines→groupby rank
# with a per-rank input dir + per-rank store, per-tick snapshots (so a
# resize cut is always snapshot-covered once input quiesces), and a
# REPLAYED line on exit — the zero-replay evidence the resize
# acceptance reads.  Env contract: PW_TEST_DIR (holds in<pid>/ dirs; a
# STOP file ends the run), plus the supervisor's PATHWAY_PROCESS_ID /
# PATHWAY_MESH_INCARNATION.
RESHARD_WORKER_SCRIPT = textwrap.dedent(
    """
    import os, json, signal, threading, time, pathlib
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import pathway_tpu_torch as pw

    pid = int(os.environ["PATHWAY_PROCESS_ID"])
    inc = int(os.environ.get("PATHWAY_MESH_INCARNATION", "0"))
    base = pathlib.Path(os.environ["PW_TEST_DIR"])
    in_dir = base / f"in{pid}"
    pdir = base / f"pstorage{pid}"
    out_file = base / f"out{pid}_inc{inc}.jsonl"
    stop_file = base / "STOP"

    class S(pw.Schema):
        word: str

    t = pw.io.jsonlines.read(str(in_dir), schema=S, mode="streaming")
    r = t.groupby(t.word).reduce(t.word, count=pw.reducers.count())
    pw.io.jsonlines.write(r, str(out_file))

    def _stop(*_a):
        rt = pw.internals.parse_graph.G.runtime
        if rt is not None:
            rt.stop()

    # phase-1 freeze: the supervisor's resize SIGTERM is a GRACEFUL
    # stop — the run ends at a tick boundary and the final commit
    # snapshots, so the handoff cut covers the whole durable log
    # (zero-replay resize)
    signal.signal(signal.SIGTERM, _stop)

    def watch():
        while True:
            time.sleep(0.05)
            if stop_file.exists():
                _stop()
                return

    threading.Thread(target=watch, daemon=True).start()
    cfg = pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(str(pdir)),
        snapshot_every=1,
    )
    pw.run(persistence_config=cfg, autocommit_duration_ms=20)
    drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
    print("REPLAYED %d" % drv.replayed_events, flush=True)
    print("CLEAN-EXIT", flush=True)
    """
)


def wait_snapshot_covered(roots, timeout_s: float = 90.0) -> bool:
    """Wait until every store in ``roots`` holds a committed operator
    -state generation that covers its whole durable log (state time ==
    last_time, live chunk list empty) — the quiesced group-safe cut a
    zero-replay resize starts from."""
    import json as _json
    import os as _os
    import time as _time

    deadline = _time.monotonic() + timeout_s
    while _time.monotonic() < deadline:
        ok = 0
        for root in roots:
            try:
                meta = _json.load(
                    open(_os.path.join(str(root), "metadata.json"))
                )
            except (OSError, ValueError):
                break
            state = meta.get("state")
            covered = (
                state is not None
                and int(state.get("time", -1))
                >= int(meta.get("last_time", 0))
                and not any(
                    v for v in meta.get("live_chunks", {}).values()
                )
            )
            if not covered:
                break
            ok += 1
        if ok == len(roots):
            return True
        _time.sleep(0.25)
    return False


def free_dcn_port(n: int = 2) -> int:
    """A base port where ``base..base+n-1`` are all currently free (the
    host mesh binds base_port + pid for every rank)."""
    for _ in range(50):
        base = random.randint(20000, 40000)
        ok = True
        for off in range(n):
            s = socket.socket()
            try:
                s.bind(("127.0.0.1", base + off))
            except OSError:
                ok = False
            finally:
                s.close()
            if not ok:
                break
        if ok:
            return base
    raise RuntimeError("no free port window")


def fold_diff_stream(paths, key_fields) -> dict:
    """Fold jsonlines diff streams into current state: key = tuple of
    ``key_fields``, value = tuple of every other field (sorted by name,
    excluding diff/time/id).  Insertions overwrite; a retraction removes
    the key only when it matches the current value, so replayed
    retractions from a restarted incarnation are absorbed."""
    state: dict = {}
    for p in paths:
        try:
            lines = open(p).read().splitlines()
        except OSError:
            continue
        for line in lines:
            if not line.strip():
                continue
            o = json.loads(line)
            key = tuple(o[f] for f in key_fields)
            val = tuple(
                v
                for f, v in sorted(o.items())
                if f not in ("diff", "time", "id", *key_fields)
            )
            if o["diff"] > 0:
                state[key] = val
            elif state.get(key) == val:
                del state[key]
    return state
