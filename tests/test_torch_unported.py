"""Every reference hook the port does not carry yet raises
``NotImplementedError`` naming its ROADMAP tag, instead of running
without it: compiled ticks, engine shards, the multi-process engine (DCN),
replication, ``persistence_config``, ``mesh=``, and the LSH / IVF / BM25 /
hybrid indexes, the temporal operators and the ``.dt`` namespace, the
other connectors, and the REST serving of the RAG layer."""

import numpy as np
import pytest

import pathway_tpu_torch as pw
from pathway_tpu_torch.internals import parse_graph
from pathway_tpu_torch.stdlib import indexing


@pytest.fixture(autouse=True)
def _fresh_graph():
    parse_graph.G.clear()
    yield
    parse_graph.G.clear()


def _table():
    return pw.debug.table_from_markdown(
        """
        | a | b
      1 | 1 | x
      2 | 2 | y
    """
    )


def _run_simple():
    t = _table()
    pw.io.subscribe(t.select(c=t.a + 1), on_change=lambda **kw: None)
    pw.run()


def _index_pipeline(**kw):
    schema = pw.schema_from_types(vec=np.ndarray)
    docs = pw.debug.table_from_rows(schema, [(np.ones(4, np.float32),)])
    index = indexing.DataIndex(docs, indexing.TpuKnn(docs.vec, dimensions=4, device="cpu", **kw))
    res = index.query_as_of_now(docs.vec, number_of_matches=1).select(r=pw.right.vec)
    pw.io.subscribe(res, on_change=lambda **k: None)
    pw.run()


ENV_CASES = [
    ({"PATHWAY_COMPILED_TICK": "1"}, _run_simple, r"\[compiled-ticks\]"),
    ({"PATHWAY_ENGINE_SHARDS": "4"}, _run_simple, r"\[mesh\]"),
    ({"PATHWAY_PROCESSES": "2"}, _run_simple, r"\[mesh\]"),  # the DCN engine
    ({"PATHWAY_REPL_PORT": "18765"}, _index_pipeline, r"\[replication\]"),
    ({"PATHWAY_REPLAY_STORAGE": "/nonexistent"}, _run_simple, r"\[persistence\]"),
]


@pytest.mark.parametrize(
    "env,run,item", ENV_CASES, ids=[next(iter(c[0])) for c in ENV_CASES]
)
def test_env_hook_raises(monkeypatch, env, run, item):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=item):
        run()


def test_compiled_tick_off_or_unset_runs_the_interpreter(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    _run_simple()
    assert parse_graph.G.last_runtime.compiled_plan is None


def test_persistence_config_raises():
    t = _table()
    pw.io.subscribe(t, on_change=lambda **kw: None)
    with pytest.raises(NotImplementedError, match=r"\[persistence\]"):
        pw.run(persistence_config=object())


def test_tpu_knn_mesh_raises():
    t = _table()
    with pytest.raises(NotImplementedError, match=r"\[mesh\]"):
        indexing.TpuKnn(t.a, dimensions=4, mesh=object(), device="cpu")


@pytest.mark.parametrize(
    "make,item",
    [
        (lambda t: indexing.LshKnn(t.a, dimensions=4), r"\[index-kinds\]"),
        (lambda t: indexing.LshKnnFactory(dimensions=4), r"\[index-kinds\]"),
        (lambda t: indexing.IvfKnn(t.a, dimensions=4), r"\[index-kinds\]"),
        (lambda t: indexing.IvfKnnFactory(dimensions=4), r"\[index-kinds\]"),
        (lambda t: indexing.TantivyBM25(t.b), r"\[index-kinds\]"),
        (lambda t: indexing.HybridIndex([]), r"\[index-kinds\]"),
        (lambda t: t.windowby(t.a, window=None), r"\[temporal\]"),
        (lambda t: t.interval_join(t, t.a, t.a, None), r"\[temporal\]"),
        (lambda t: t.diff(t.a, t.b), r"\[temporal\]"),
        (lambda t: t.b.dt, r"\[temporal\]"),
        (lambda t: pw.io.csv, r"\[connectors\]"),
        (lambda t: pw.run(with_http_server=True), r"\[observability\]"),
        (lambda t: pw.debug.table_to_dicts(t, persistence_config=object()), r"\[persistence\]"),
    ],
    ids=[
        "LshKnn", "LshKnnFactory", "IvfKnn", "IvfKnnFactory", "TantivyBM25", "HybridIndex",
        "windowby", "interval_join", "diff", "dt_namespace", "io.csv", "http_server", "debug_persistence",
    ],
)
def test_unported_kind_raises(make, item):
    with pytest.raises(NotImplementedError, match=item):
        make(_table())


def _store():
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    docs = pw.debug.table_from_rows(pw.schema_from_types(data=bytes), [(b"a b c",)])
    emb = SentenceTransformerEmbedder(dim=8, depth=1, heads=2, max_len=16, device="cpu")
    return VectorStoreServer(docs, embedder=emb, device="cpu")


def _answerer():
    from pathway_tpu_torch.xpacks.llm.llms import EchoChat
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer

    return BaseRAGQuestionAnswerer(EchoChat(), _store())


@pytest.mark.parametrize(
    "call",
    [
        lambda llm: _store().run_server("127.0.0.1", 0),
        lambda llm: _store().drain(),
        lambda llm: _answerer().build_server("127.0.0.1", 0),
        lambda llm: _answerer().run_server(),
        lambda llm: llm.BaseRestServer("127.0.0.1", 0),
        lambda llm: llm.DocumentStoreServer("127.0.0.1", 0, None),
        lambda llm: llm.QARestServer("127.0.0.1", 0, None),
        lambda llm: llm.QASummaryRestServer("127.0.0.1", 0, None),
    ],
    ids=[
        "VectorStoreServer.run_server", "VectorStoreServer.drain", "build_server",
        "answerer.run_server", "BaseRestServer", "DocumentStoreServer", "QARestServer",
        "QASummaryRestServer",
    ],
)
def test_rest_hooks_raise(call):
    import pathway_tpu_torch.xpacks.llm as llm

    with pytest.raises(NotImplementedError, match=r"\[rest\]"):
        call(llm)
