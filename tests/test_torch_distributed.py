"""The port's process groups on the CPU, held against the JAX package
(the reference's ``tests/test_distributed.py`` cases as port cases):
``sharded_topk_global`` on two gloo ranks returns the JAX package's
``dense_topk`` ids over the whole corpus exactly (scores within 1e-5); both
``process_env``s keep the reference's defaults; and two-process port groups
— a wordcount, a join, the wordcount under both wire formats and with a
duplicated exchange frame — fold to what the JAX package computes in ONE
process on the same rows, keys and counts exact, with disjoint key
ownership. Each group has its own deadline and its children are killed
when it ends (``torch_group.py``)."""

from __future__ import annotations

import json

import numpy as np
import pytest

from pathway_tpu_torch.testing.chaos import free_dcn_port
from torch_group import results, spawn_group, worker

_KNN = worker(
    """
    from pathway_tpu_torch.parallel import distributed as dist
    import torch.distributed as td

    assert dist.maybe_initialize(device="cpu"), "expected multi-process mode"
    assert dist.is_multiprocess() and td.get_world_size() == 2 and td.get_backend() == "gloo"
    mesh = dist.global_mesh(device="cpu")
    assert mesh.shape == {"data": 2}, mesh
    import numpy as np
    n_global, dim, k = 4096, 16, 5
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(n_global, dim)).astype(np.float32)
    corpus[100] = corpus[3000]  # an exact tie across the two shards
    valid = np.ones(n_global, bool)
    valid[7] = False
    queries = rng.normal(size=(3, dim)).astype(np.float32)
    queries[2] = corpus[3000]
    half = n_global // 2
    lo, hi = PID * half, (PID + 1) * half
    sc, ix = dist.sharded_topk_global(queries, corpus[lo:hi], valid[lo:hi], k, metric="cosine",
                                      mesh=mesh, device="cpu")
    print("RESULT " + json.dumps({"pid": PID, "ids": ix.tolist(), "scores": sc.tolist()}), flush=True)
    """
)


def test_two_process_sharded_knn(tmp_path):
    """Each gloo rank runs the block top-k (its plain version on the CPU) on
    its half of the corpus; the merged ids equal the JAX package's
    ``dense_topk`` over the whole corpus, the lower global id first on the
    cross-shard tie, on both ranks."""
    import jax.numpy as jnp

    from pathway_tpu.ops.knn import dense_topk

    script = tmp_path / "knn.py"
    script.write_text(_KNN)
    store = free_dcn_port(1)
    procs, outs = spawn_group(script, 2, free_dcn_port(2), lambda pid: {"PATHWAY_FIRST_PORT": str(store)})
    got = results(procs, outs)
    assert sorted(g["pid"] for g in got) == [0, 1]
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(4096, 16)).astype(np.float32)
    corpus[100] = corpus[3000]
    valid = np.ones(4096, bool)
    valid[7] = False
    queries = rng.normal(size=(3, 16)).astype(np.float32)
    queries[2] = corpus[3000]
    s_ref, i_ref = dense_topk(jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(valid), 5, metric="cosine")
    for g in got:
        assert np.asarray(g["ids"]).tolist() == np.asarray(i_ref).tolist()
        np.testing.assert_allclose(np.asarray(g["scores"]), np.asarray(s_ref), atol=1e-5)
    assert got[0]["ids"][2][:2] == [100, 3000]


def test_sharded_knn_groups_side_by_side_exit_cleanly(tmp_path):
    """Six two-rank gloo groups run ``sharded_topk_global`` at once: every
    rank prints its result and exits 0, and no rank aborts at exit
    ("terminate called ..."): ``maybe_initialize`` destroys the group it
    joined before the interpreter tears torch down."""
    import threading

    script = tmp_path / "knn.py"
    script.write_text(_KNN)
    runs = [None] * 6

    def one(i):
        store = free_dcn_port(1)
        runs[i] = spawn_group(script, 2, free_dcn_port(2), lambda pid: {"PATHWAY_FIRST_PORT": str(store)},
                              timeout=240.0)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(runs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for procs, outs in runs:
        got = results(procs, outs)
        assert sorted(g["pid"] for g in got) == [0, 1]
        for out in outs:
            assert "terminate called" not in out, out[-2000:]


def test_process_env_defaults(monkeypatch):
    """Both modules' ``process_env`` read the reference's env contract with
    its defaults; a single process stays single (no group joined)."""
    from pathway_tpu.parallel import distributed as ref_dist
    from pathway_tpu_torch.parallel import distributed as dist
    from pathway_tpu_torch.parallel import host_exchange as hx

    for k in ("PATHWAY_PROCESSES", "PATHWAY_PROCESS_ID", "PATHWAY_FIRST_PORT", "JAX_COORDINATOR_ADDRESS",
              "MASTER_ADDR", "MASTER_PORT", "PATHWAY_DCN_PORT", "PATHWAY_DCN_HOST"):
        monkeypatch.delenv(k, raising=False)
    assert dist.process_env() == ref_dist.process_env() == (1, 0, "127.0.0.1:10000")
    assert dist.maybe_initialize() is False  # single process: no-op, no card needed
    assert hx.process_env() == (1, 0, 10700, "127.0.0.1")
    monkeypatch.setenv("PATHWAY_PROCESSES", "4")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "3")
    monkeypatch.setenv("PATHWAY_FIRST_PORT", "12345")
    assert dist.process_env() == ref_dist.process_env() == (4, 3, "127.0.0.1:12345")
    # the torch.distributed rendezvous spawn sets names the coordinator
    monkeypatch.setenv("MASTER_ADDR", "10.1.2.3")
    monkeypatch.setenv("MASTER_PORT", "23456")
    assert dist.process_env() == (4, 3, "10.1.2.3:23456")


def test_device_group_refuses_without_a_card_and_two_ranks_on_one_card(monkeypatch):
    """The device group defaults to the card and raises without one; NCCL on
    more ranks than cards raises naming the cause (gloo is the named way
    for ranks sharing one card); NCCL on the CPU raises."""
    import torch

    from pathway_tpu_torch.parallel import distributed as dist

    monkeypatch.setenv("PATHWAY_PROCESSES", "2")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "0")
    for k in ("LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=r"torch\.cuda\.is_available\(\) is False"):
            dist.maybe_initialize()
        with pytest.raises(RuntimeError, match=r"torch\.cuda\.is_available\(\) is False"):
            dist.global_mesh()
    with pytest.raises(RuntimeError, match="NCCL backend needs device='cuda'"):
        dist.maybe_initialize(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="unsupported torch.distributed backend"):
        dist.maybe_initialize(device="cpu", backend="mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one card"):
        dist._backend(torch.device("cuda"), None, 2)
    assert dist._backend(torch.device("cuda"), "gloo", 2) == "gloo"
    assert dist._backend(torch.device("cpu"), None, 2) == "gloo"


def test_nccl_counts_only_the_ranks_on_this_host(monkeypatch):
    """A multi-host group launched through the env contract (a remote
    coordinator, one card per host, no LOCAL_WORLD_SIZE) is not refused:
    only the ranks known to share this host count against its cards."""
    import torch

    from pathway_tpu_torch.parallel import distributed as dist

    monkeypatch.setenv("PATHWAY_PROCESSES", "2")
    monkeypatch.setenv("PATHWAY_PROCESS_ID", "1")
    monkeypatch.setenv("MASTER_ADDR", "10.1.2.3")
    monkeypatch.setenv("MASTER_PORT", "23456")
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dist._host_ranks(2) is None
    assert dist._backend(torch.device("cuda"), None, 2) == "nccl"
    # two ranks named on this host still cannot share its one card
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one card"):
        dist._backend(torch.device("cuda"), None, 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert dist._backend(torch.device("cuda"), None, 2) == "nccl"
    # a local coordinator puts the whole group on this host
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert dist._host_ranks(2) == 2
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one card"):
        dist._backend(torch.device("cuda"), None, 2)


_WORDCOUNT = worker(
    """
    class S(pw.Schema):
        word: str

    words_all = [f"w{i % 7}" for i in range(100)]
    mine = [(w,) for i, w in enumerate(words_all) if i % N == PID]
    t = pw.debug.table_from_rows(S, mine)
    r = t.groupby(t.word).reduce(t.word, count=pw.reducers.count())
    keys, cols = pw.debug.table_to_dicts(r)
    out = {cols["word"][k]: [int(k), cols["count"][k]] for k in keys}
    rt = pw.internals.parse_graph.G.last_runtime
    if N > 1:
        dcn = importlib.import_module(PKG + ".engine.dcn")
        gbs = [e for e in rt.execs.values() if isinstance(e, dcn.DcnGroupByExec)]
        assert gbs, "expected a DCN groupby exec"
        assert gbs[0].router.exchanges > 0, "no cross-process exchange ran"
        print("OWNED " + json.dumps(sorted(gbs[0].owned_group_keys())), flush=True)
    print("RESULT " + json.dumps(out), flush=True)
    """
)


@pytest.fixture(scope="module")
def jax_wordcount(tmp_path_factory):
    """The JAX package's wordcount in one process: {word: [row key, count]}."""
    script = tmp_path_factory.mktemp("wc") / "wc.py"
    script.write_text(_WORDCOUNT)
    procs, outs = spawn_group(script, 1, free_dcn_port(1), pkg="pathway_tpu")
    (single,) = results(procs, outs)
    assert sum(c for _k, c in single.values()) == 100
    return single


def _merged(procs, outs) -> dict:
    got = results(procs, outs)
    assert len(got) == 2
    assert not (set(got[0]) & set(got[1])), "a word reported by both processes"
    owned = [set(x) for x in results(procs, outs, "OWNED")]
    assert owned[0] and owned[1] and not (owned[0] & owned[1])
    return {**got[0], **got[1]}


@pytest.mark.parametrize(
    "env",
    [{}, {"PATHWAY_DCN_WIRE": "codec"}, {"PATHWAY_DCN_WIRE": "pickle"},
     {"PATHWAY_FAULTS": "dup=ch:gb,nth:1,inc:*"}],
    ids=["wordcount", "wire_codec", "wire_pickle", "duplicated_frame"],
)
def test_two_process_wordcount_dcn(tmp_path, jax_wordcount, env):
    """Host rows cross processes: each rank owns disjoint group keys, and the
    union of the ranks' rows is the JAX package's single-process wordcount,
    row keys and counts exact — under the columnar codec, the pickle
    escape hatch, and a Fault Forge duplicate of a groupby exchange frame
    (delivery is keyed per (channel, tick, src), so it is absorbed)."""
    script = tmp_path / "wc.py"
    script.write_text(_WORDCOUNT)
    procs, outs = spawn_group(script, 2, free_dcn_port(2), lambda pid: env)
    assert _merged(procs, outs) == jax_wordcount


_JOIN = worker(
    """
    # primary keys: the row keys are then value hashes, the same under
    # any process count
    class L(pw.Schema):
        i: int = pw.column_definition(primary_key=True)
        k: int
        a: int

    class R(pw.Schema):
        k: int = pw.column_definition(primary_key=True)
        b: int

    # left rows split across processes; right table only on process 0 —
    # the exchange must co-locate matching rows regardless of origin
    lrows = [(i, i % 5, i) for i in range(40) if i % N == PID]
    rrows = [(i, i * 100) for i in range(5)] if PID == 0 else []
    lt = pw.debug.table_from_rows(L, lrows)
    rt = pw.debug.table_from_rows(R, rrows)
    j = lt.join(rt, lt.k == rt.k).select(lt.a, rt.b)
    keys, cols = pw.debug.table_to_dicts(j)
    out = sorted((int(k), cols["a"][k], cols["b"][k]) for k in keys)
    if N > 1:
        dcn = importlib.import_module(PKG + ".engine.dcn")
        rtm = pw.internals.parse_graph.G.last_runtime
        assert any(isinstance(e, dcn.DcnJoinExec) for e in rtm.execs.values())
    print("RESULT " + json.dumps(out), flush=True)
    """
)


def test_two_process_join_dcn(tmp_path):
    """A two-process equijoin: both sides exchanged by join-key hash so
    matches co-locate; the union of the ranks' rows is the JAX package's
    single-process join, row keys included."""
    script = tmp_path / "join.py"
    script.write_text(_JOIN)
    (single,) = results(*spawn_group(script, 1, free_dcn_port(1), pkg="pathway_tpu"))
    got = results(*spawn_group(script, 2, free_dcn_port(2)))
    merged = sorted(tuple(x) for r in got for x in r)
    assert merged == sorted(tuple(x) for x in single)
    assert sorted((a, b) for _k, a, b in merged) == sorted((i, (i % 5) * 100) for i in range(40))


_MESH_GROUP = worker(
    """
    from pathway_tpu_torch.parallel import exchange_topology, host_exchange as hx

    topo = exchange_topology()
    m = hx.get_host_mesh()
    assert hx.get_host_mesh() is m and m.n == N and m.pid == PID
    vals = m.barrier(("hello", PID * 10))
    m.send(1 - PID, "x", 0, {"from": PID})
    got = m.gather("x", 0)
    print("RESULT " + json.dumps({"topo": topo, "bar": sorted(vals.items()), "got": got[1 - PID]}), flush=True)
    """
)


def test_host_mesh_singleton_in_a_group(tmp_path):
    """``get_host_mesh`` joins the group the env describes, and
    ``exchange_topology`` reports its processes as the reference's does."""
    script = tmp_path / "mesh.py"
    script.write_text(_MESH_GROUP)
    got = results(*spawn_group(script, 2, free_dcn_port(2)))
    assert len(got) == 2
    for r in got:
        assert r["topo"] == {"engine_shards": 1, "dcn_processes": 2, "sharding_active": True}
        assert r["bar"] == [[0, ["hello", 0]], [1, ["hello", 10]]]
    assert sorted(r["got"]["from"] for r in got) == [0, 1]

