"""The port's ``VectorStoreServer`` and ``DocumentStore`` against the JAX
package's: the same seeded documents (bytes with a ``path``/``topic``
metadata) go through ``Utf8Parser`` → ``TokenCountSplitter`` →
``SentenceTransformerEmbedder`` (dim 32, depth 2, no weights carried
across: both packages' ``seed=0`` init is the same) → ``DataIndex``, and
the same query tables through ``retrieve_query``, ``statistics_query`` and
``inputs_query``.

Both encoders compute in float32 here (the default bfloat16 rounds in other
places in the two frameworks). Tolerances: reply texts, metadata, keys and
order are exact; ``dist`` within atol 1e-4 (the two encoders' f32 sums run
in another order); the ``statistics_query``/``inputs_query`` results are
exactly equal ``Json``. The JAX side runs its interpreter
(``PATHWAY_COMPILED_TICK=0``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.stdlib import indexing as jidx
from pathway_tpu.xpacks.llm import (
    document_store as jds,
    parsers as jparsers,
    splitters as jsplit,
    vector_store as jvs,
)
from pathway_tpu.xpacks.llm._encoder import TransformerEncoder as JaxEncoder
from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JaxEmbedder
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from pathway_tpu_torch.observability import REGISTRY
from pathway_tpu_torch.observability.tracing import get_tracer
from pathway_tpu_torch.stdlib import indexing as tidx
from pathway_tpu_torch.xpacks.llm import (
    document_store as tds,
    parsers as tparsers,
    splitters as tsplit,
    vector_store as tvs,
)
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TorchEmbedder

DIM, DEPTH, HEADS, MAXLEN = 32, 2, 2, 64
N_DOCS = 240
DIST_ATOL = 1e-4
JAX = dict(pw=jpw, vs=jvs, ds=jds, parsers=jparsers, split=jsplit, idx=jidx, dev={})
PORT = dict(pw=tpw, vs=tvs, ds=tds, parsers=tparsers, split=tsplit, idx=tidx, dev={"device": "cpu"})


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


@pytest.fixture(scope="module")
def embedders():
    kw = dict(dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, batch_size=64)
    jemb = JaxEmbedder(**kw)
    jemb.runtime.model = JaxEncoder(
        vocab_size=30522, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, dtype=jnp.float32
    )
    temb = TorchEmbedder(device="cpu", **kw)
    temb.runtime.model.dtype = torch.float32
    return jemb, temb


WORDS = [f"w{i}" for i in range(400)]
TOPICS = ["alpha", "beta", "gamma", "delta"]


def _docs(n=N_DOCS, seed=0, start=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(start, start + n):
        sentences = []
        for _ in range(int(rng.integers(2, 6))):
            sentences.append(" ".join(rng.choice(WORDS, size=int(rng.integers(6, 20)))) + ".")
        meta = {"path": f"dir{i % 3}/doc{i}.txt", "topic": TOPICS[i % 4]}
        out.append((i, " ".join(sentences).encode(), meta))
    return out


def _doc_schema(pw):
    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        data: bytes
        _metadata: pw.Json

    return DocSchema


def _chunk_text(doc_bytes):
    """The first chunk the store's splitter makes of a document."""
    return tsplit.TokenCountSplitter(min_tokens=10, max_tokens=30).split(doc_bytes.decode())[0][0]


def _retrieve_rows(docs):
    """Queries copied from documents, plain, filtered and globbed."""
    return [
        (_chunk_text(docs[3][1]), 4, None, None),
        (_chunk_text(docs[77][1]), 3, None, None),
        (_chunk_text(docs[150][1]), 5, "topic == 'beta'", None),
        ("w1 w2 w3 w4", 4, "topic == 'gamma' && contains(path, 'dir1')", None),
        (_chunk_text(docs[5][1]), 4, None, "dir2/*"),
        ("w9 w10", 2, "topic == `delta`", "dir0/*"),
    ]


def _capture(pw, table, name, sink):
    def on_change(key, row, time, is_addition):
        sink.append((name, time, 1 if is_addition else -1, int(key), row["result"]))

    pw.io.subscribe(table, on_change=on_change)


def _store_run(pkg, emb, *, docs, stream=False, queries_at=0):
    pw, vs = pkg["pw"], pkg["vs"]
    rows = [(i, data, meta, *([t, d] if stream else [])) for i, data, meta, t, d in docs] if stream else [
        (i, data, meta) for i, data, meta in docs
    ]
    doc_t = pw.debug.table_from_rows(_doc_schema(pw), rows, is_stream=stream)
    store = vs.VectorStoreServer(
        doc_t,
        embedder=emb,
        parser=pkg["parsers"].Utf8Parser(),
        splitter=pkg["split"].TokenCountSplitter(min_tokens=10, max_tokens=30),
        **pkg["dev"],
    )
    plain_docs = [(i, data, meta) for i, data, meta, *_ in docs]
    qrows = _retrieve_rows(plain_docs)
    if stream:
        qrows = [(*r, queries_at, 1) for r in qrows]
    queries = pw.debug.table_from_rows(store.RetrieveQuerySchema, qrows, is_stream=stream)
    stats_q = pw.debug.table_from_rows(
        pw.schema_from_types(n=int), [(1, queries_at, 1)] if stream else [(1,)], is_stream=stream
    )
    inputs_rows = [(None, None), ("topic == 'alpha'", None), (None, "dir1/*")]
    if stream:
        inputs_rows = [(*r, queries_at, 1) for r in inputs_rows]
    inputs_q = pw.debug.table_from_rows(store.InputsQuerySchema, inputs_rows, is_stream=stream)
    events = []
    _capture(pw, store.retrieve_query(queries), "retrieve", events)
    _capture(pw, store.statistics_query(stats_q), "statistics", events)
    _capture(pw, store.inputs_query(inputs_q), "inputs", events)
    chunks = store._graph["chunked_docs"]
    _capture(pw, chunks.select(result=pw.make_tuple(chunks.text, chunks.metadata)), "chunks", events)
    pw.run()
    return events


def _final(events, name):
    state = {}
    for n, _t, diff, key, result in events:
        if n != name:
            continue
        if diff > 0:
            state[key] = result.value
        elif state.get(key) == result.value:
            del state[key]
    return state


def _assert_replies_equal(ref, got):
    assert sorted(ref) == sorted(got)
    for key in ref:
        r, g = ref[key], got[key]
        assert [(d["text"], d["metadata"]) for d in g] == [(d["text"], d["metadata"]) for d in r]
        np.testing.assert_allclose(
            [d["dist"] for d in g], [d["dist"] for d in r], atol=DIST_ATOL, rtol=0
        )


@pytest.fixture(scope="module")
def static_runs(embedders):
    jemb, temb = embedders
    docs = _docs()
    port_parse_graph.G.clear()
    ref = _store_run(JAX, jemb, docs=docs)
    port_parse_graph.G.clear()
    got = _store_run(PORT, temb, docs=docs)
    port_parse_graph.G.clear()
    return docs, ref, got


def test_retrieve_query_equals_reference(static_runs):
    docs, ref, got = static_runs
    r, g = _final(ref, "retrieve"), _final(got, "retrieve")
    assert len(r) == len(_retrieve_rows(docs))
    _assert_replies_equal(r, g)
    # a query copied from a chunk finds that chunk first, at distance ~0
    firsts = {rep[0]["metadata"]["path"] for rep in g.values() if rep and rep[0]["dist"] < 1e-5}
    assert {"dir0/doc3.txt", "dir2/doc77.txt", "dir2/doc5.txt"} <= firsts


def test_filtered_replies_match_their_filter(static_runs):
    _docs_, _ref, got = static_runs
    replies = list(_final(got, "retrieve").values())
    assert any(len(rep) == 5 for rep in replies)
    for rep in replies:
        metas = [d["metadata"] for d in rep]
        dists = [d["dist"] for d in rep]
        assert dists == sorted(dists)
        if metas and all(m["topic"] == "beta" for m in metas) and len(metas) == 5:
            break
    else:
        pytest.fail("no reply of the topic == 'beta' query")
    glob = [rep for rep in replies if rep and all(d["metadata"]["path"].startswith("dir2/") for d in rep)]
    assert glob


def test_chunk_row_keys_equal_reference(static_runs):
    """parse → flatten → split → flatten gives every chunk the reference's
    row key."""
    _docs_, ref, got = static_runs

    def chunks(events):
        rows = [(key, row) for n, _t, _d, key, row in events if n == "chunks"]
        return sorted((key, text, repr(meta.value)) for key, (text, meta) in rows)

    assert chunks(got) == chunks(ref)
    assert len(chunks(got)) > N_DOCS


def test_statistics_query_equals_reference(static_runs):
    _docs_, ref, got = static_runs
    r, g = _final(ref, "statistics"), _final(got, "statistics")
    assert r == g and len(g) == 1
    (stats,) = g.values()
    assert stats["file_count"] > N_DOCS  # documents split into several chunks


def test_inputs_query_equals_reference(static_runs):
    docs, ref, got = static_runs
    r, g = _final(ref, "inputs"), _final(got, "inputs")
    assert r == g and len(g) == 3
    by_len = sorted(len(v) for v in g.values())
    assert by_len == [N_DOCS // 4, N_DOCS // 3, N_DOCS]


def _inputs_run(pkg, emb, docs):
    pw, vs = pkg["pw"], pkg["vs"]
    doc_t = pw.debug.table_from_rows(_doc_schema(pw), docs)
    store = vs.VectorStoreServer(doc_t, embedder=emb, parser=pkg["parsers"].Utf8Parser(), **pkg["dev"])
    inputs_q = pw.debug.table_from_rows(store.InputsQuerySchema, [(None, None)])
    events = []
    _capture(pw, store.inputs_query(inputs_q), "inputs", events)
    pw.run()
    return _final(events, "inputs")


def test_inputs_query_dedups_unhashable_paths_like_reference(embedders):
    """A dict or list under "path" is deduplicated by equality, as the
    reference does: two equal dicts with their keys in another order are one
    input."""
    jemb, temb = embedders
    paths = [{"a": 1, "b": 2}, {"b": 2, "a": 1}, ["x", "y"], ["x", "y"], "s", "s", 7]
    docs = [(i, f"doc {i} w{i}".encode(), {"path": p}) for i, p in enumerate(paths)]
    ref = _inputs_run(JAX, jemb, docs)
    port_parse_graph.G.clear()
    got = _inputs_run(PORT, temb, docs)
    assert got == ref
    (result,) = got.values()
    assert len(result) == 4


def test_store_metrics_and_spans_move(static_runs):
    def value(name):
        return REGISTRY.counter(name, "").labels().value

    assert value("pathway_vector_store_chunks_total") > N_DOCS
    assert value("pathway_vector_store_retrievals_total") >= len(_retrieve_rows(static_runs[0]))
    names = {r.name for r in get_tracer().spans()}
    assert {"vector_store.chunk", "vector_store.retrieve"} <= names


def _stream_docs():
    """Documents arrive at times 2, 4 and 6; one is retracted at 8."""
    docs = _docs(n=160, seed=3)
    rows = [(i, data, meta, 2 + 2 * (i // 54), 1) for i, data, meta in docs]
    rows.append((docs[40][0], docs[40][1], docs[40][2], 8, -1))
    return rows


def test_update_stream_equals_reference(embedders):
    jemb, temb = embedders
    rows = _stream_docs()
    ref = _store_run(JAX, jemb, docs=rows, stream=True, queries_at=4)
    port_parse_graph.G.clear()
    got = _store_run(PORT, temb, docs=rows, stream=True, queries_at=4)

    def shape(events):
        out = []
        for name, t, diff, key, result in events:
            if name == "chunks":
                out.append((name, t, diff, key, (result[0], repr(result[1].value))))
                continue
            v = result.value
            if name == "retrieve":
                v = tuple((d["text"], repr(d["metadata"])) for d in v)
            else:
                v = repr(v)
            out.append((name, t, diff, key, v))
        return sorted(out, key=repr)

    assert shape(got) == shape(ref)
    # statistics moved with the stream: inserts at 4 and 6, a retraction at 8
    times = sorted({t for name, t, *_ in got if name == "statistics"})
    assert len(times) >= 3
    dists = {}
    for events, side in ((ref, "ref"), (got, "got")):
        for name, t, diff, key, result in events:
            if name == "retrieve":
                dists.setdefault((t, diff, key), {})[side] = [d["dist"] for d in result.value]
    for pair in dists.values():
        np.testing.assert_allclose(pair["got"], pair["ref"], atol=DIST_ATOL, rtol=0)


def _document_store_run(pkg, emb):
    pw, ds, idx = pkg["pw"], pkg["ds"], pkg["idx"]
    docs = _docs(n=160, seed=5)
    doc_t = pw.debug.table_from_rows(_doc_schema(pw), docs)
    factory = idx.BruteForceKnnFactory(dimensions=DIM, embedder=emb, **pkg["dev"])
    store = ds.DocumentStore(
        doc_t,
        retriever_factory=factory,
        splitter=pkg["split"].TokenCountSplitter(min_tokens=10, max_tokens=30),
    )
    queries = pw.debug.table_from_rows(store.RetrieveQuerySchema, _retrieve_rows(docs))
    parsed_q = pw.debug.table_from_rows(pw.schema_from_types(n=int), [(1,)])
    events = []
    _capture(pw, store.retrieve_query(queries), "retrieve", events)
    _capture(pw, store.parsed_documents_query(parsed_q), "parsed", events)
    pw.run()
    return events


def test_document_store_equals_reference(embedders):
    jemb, temb = embedders
    ref = _document_store_run(JAX, jemb)
    port_parse_graph.G.clear()
    got = _document_store_run(PORT, temb)
    r, g = _final(ref, "retrieve"), _final(got, "retrieve")
    _assert_replies_equal(r, g)
    for key in r:
        np.testing.assert_allclose(
            [d["score"] for d in g[key]], [d["score"] for d in r[key]], atol=DIST_ATOL, rtol=0
        )
    assert _final(ref, "parsed") == _final(got, "parsed")


def test_store_device_defaults_to_cuda(embedders):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _jemb, temb = embedders
    docs = tpw.debug.table_from_rows(_doc_schema(tpw), _docs(n=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvs.VectorStoreServer(docs, embedder=temb)


@pytest.mark.parametrize("hook", ["run_server", "drain"])
def test_rest_hooks_raise(embedders, hook):
    """The store's REST hooks serve instead of raising: ``run_server``
    answers ``/v1/retrieve`` as ``retrieve_query`` does, ``drain`` (a
    no-op before ``run_server``) closes the listener after it."""
    import http.client
    import json
    import socket
    import time

    _jemb, temb = embedders
    docs = _docs(n=4)
    store = tvs.VectorStoreServer(
        tpw.debug.table_from_rows(_doc_schema(tpw), docs), embedder=temb, device="cpu"
    )
    if hook == "drain":
        assert store.drain() is True
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    thread = store.run_server("127.0.0.1", port, threaded=True)
    query = _chunk_text(docs[2][1])
    try:
        for _ in range(300):
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
                conn.request("POST", "/v1/retrieve", body=json.dumps({"query": query, "k": 2}))
                resp = conn.getresponse()
                status, body = resp.status, json.loads(resp.read())
                conn.close()
                if status == 200 and body:
                    break
            except ConnectionRefusedError:
                time.sleep(0.05)
        assert status == 200 and body[0]["text"] == query and body[0]["dist"] < 1e-5
        if hook == "drain":
            assert store.drain() is True
            with pytest.raises(ConnectionRefusedError):
                http.client.HTTPConnection("127.0.0.1", port, timeout=5).connect()
    finally:
        port_parse_graph.G.runtime.stop()
        thread.join(timeout=15)
    assert not thread.is_alive()
