"""The other index kinds at the Table level, the port (``device="cpu"``)
against the JAX package, on the same seeded inputs:

* ``DataIndex`` over ``LshKnn`` (euclidean and cosine), ``IvfKnn`` (trained
  mid-stream), ``TantivyBM25``, and ``HybridIndex`` (BM25 + a dense index
  over an embedder UDF; LSH + IVF), on seeded update streams — documents
  upserted and deleted across ticks, queries answered live (``query``) and
  as of now, with and without a metadata filter;
* each ``default_*_document_index`` helper;
* ``pw.stdlib.ml.KNNIndex`` (``get_nearest_items`` and
  ``get_nearest_items_asof_now``, with and without distances);
* ``DocumentStore`` over ``HybridIndexFactory([TantivyBM25Factory(),
  BruteForceKnnFactory(the seeded embedder)])``;
* the reference's own cases of ``tests/test_indexing.py``, ``tests/test_ivf.py``
  and ``tests/test_ported_ml_index.py`` that use these classes, run under
  both packages;
* a ``TantivyBM25`` store and an ``IvfKnn`` store written by one package
  and restored by the other.

The full update streams must agree: times, diffs, row ids, matched ids and
data columns exactly; scores and distances within atol 1e-5 (1e-4 where
the seeded encoder computes the vectors, as in
``tests/test_torch_vector_store.py``). The JAX side runs its interpreter
(``PATHWAY_COMPILED_TICK=0``)."""

import importlib
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph

PKGS = {"jax": jpw, "port": tpw}
DEV = {"jax": {}, "port": {"device": "cpu"}}
ATOL = 1e-5
ENC_ATOL = 1e-4  # the seeded encoder's f32 sums run in another order
DIM = 8
WORDS = [f"w{i}" for i in range(24)]


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _mod(pw, name):
    return importlib.import_module(f"{pw.__name__}.{name}")


def _norm(v):
    if isinstance(v, (tuple, list)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, np.ndarray):
        return tuple(_norm(x) for x in v.tolist())
    if type(v).__name__ == "Pointer":
        return ("ptr", int(v))
    if type(v).__name__ == "Json":
        return ("json", json.dumps(v.value, sort_keys=True))
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


def _assert_close(got, ref, atol, where=""):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref), f"{where}: {got} != {ref}"
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_close(g, r, atol, f"{where}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert isinstance(got, float) and abs(got - ref) <= atol, f"{where}: {got} != {ref}"
    else:
        assert got == ref, f"{where}: {got!r} != {ref!r}"


def _run(pkg, script):
    """Build ``script(pw, dev)``'s tables in ``pkg``, run, return each
    table's update stream sorted by (time, diff, row id)."""
    pw = PKGS[pkg]
    pw.internals.parse_graph.G.clear()
    tables = script(pw, DEV[pkg])
    events = {name: [] for name in tables}
    for name, table in tables.items():
        def on_change(key, row, time, is_addition, out=events[name]):
            out.append((time, 1 if is_addition else -1, int(key), {c: _norm(v) for c, v in sorted(row.items())}))

        pw.io.subscribe(table, on_change=on_change)
    pw.run()
    return {name: sorted(ev, key=lambda e: (e[0], e[1], e[2])) for name, ev in events.items()}


def _assert_same_streams(script, atol=ATOL):
    ref = _run("jax", script)
    got = _run("port", script)
    for name in ref:
        r, g = ref[name], got[name]
        assert [e[:3] for e in g] == [e[:3] for e in r], name
        for (t, d, k, grow), (_t, _d, _k, rrow) in zip(g, r):
            assert grow.keys() == rrow.keys()
            for c in rrow:
                _assert_close(grow[c], rrow[c], atol, f"{name} t={t} d={d} key={k} {c}")
    return ref, got


# --- seeded streams ---------------------------------------------------------------


def _doc_events(seed=0, n=40):
    """(name, text, vec, meta, time, diff): inserts at t=2, upserts at t=4,
    deletions at t=6, late inserts at t=8."""
    rng = np.random.default_rng(seed)
    vec = lambda: rng.normal(size=DIM).astype(np.float32)  # noqa: E731
    text = lambda: " ".join(rng.choice(WORDS, size=int(rng.integers(2, 8))))  # noqa: E731
    first = {f"d{i}": (text(), vec(), {"lang": "en" if i % 3 else "fr", "n": i}) for i in range(n)}
    ev = [(nm, t, v, m, 2, 1) for nm, (t, v, m) in first.items()]
    for i in range(0, n, 5):
        nm = f"d{i}"
        t, v, m = first[nm]
        ev += [(nm, t, v, m, 4, -1), (nm, text(), vec(), m, 4, 1)]
    for i in range(3, n, 7):
        if i % 5:
            nm = f"d{i}"
            t, v, m = first[nm]
            ev.append((nm, t, v, m, 6, -1))
    ev += [(f"late{i}", text(), vec(), {"lang": "fr", "n": 100 + i}, 8, 1) for i in range(6)]
    return ev


def _query_events(seed=1):
    rng = np.random.default_rng(seed)
    return [
        (f"q{i}", " ".join(rng.choice(WORDS, size=3)), rng.normal(size=DIM).astype(np.float32),
         "lang == 'fr'" if i % 2 else None, t, 1)
        for i, t in enumerate([2, 2, 4, 6, 6, 8, 8])
    ]


def _tables(pw):
    class DocSchema(pw.Schema):
        name: str = pw.column_definition(primary_key=True)
        text: str
        vec: np.ndarray
        meta: dict

    class QSchema(pw.Schema):
        qname: str = pw.column_definition(primary_key=True)
        q: str
        qv: np.ndarray
        filter: str | None

    docs = pw.debug.table_from_rows(DocSchema, _doc_events(), is_stream=True)
    queries = pw.debug.table_from_rows(QSchema, _query_events(), is_stream=True)
    return docs, queries


def _bow(pw):
    """A bag-of-words embedder UDF: word ``w<i>`` adds 1 at ``i % 8``."""

    @pw.udf
    def embed(text: str) -> list[float]:
        v = [0.0] * DIM
        for w in text.split():
            v[int(w[1:]) % DIM] += 1.0
        return v

    return embed


INNER = {
    "lsh": (lambda ix, d, pw, dev: ix.LshKnn(d.vec, d.meta, dimensions=DIM, **dev), "qv"),
    "lsh_cosine": (lambda ix, d, pw, dev: ix.LshKnn(d.vec, d.meta, dimensions=DIM, distance_type="cosine",
                                                     **dev), "qv"),
    "ivf": (lambda ix, d, pw, dev: ix.IvfKnn(d.vec, d.meta, dimensions=DIM, min_train=16, n_clusters=4,
                                             n_probe=2, **dev), "qv"),
    "bm25": (lambda ix, d, pw, dev: ix.TantivyBM25(d.text, d.meta), "q"),
    "hybrid_bm25_dense": (lambda ix, d, pw, dev: ix.HybridIndex([
        ix.TantivyBM25(d.text, d.meta),
        ix.BruteForceKnn(d.text, d.meta, dimensions=DIM, embedder=_bow(pw), **dev),
    ]), "q"),
    "hybrid_lsh_ivf": (lambda ix, d, pw, dev: ix.HybridIndex([
        ix.LshKnn(d.vec, d.meta, dimensions=DIM, **dev),
        ix.IvfKnn(d.vec, d.meta, dimensions=DIM, min_train=16, n_clusters=4, **dev),
    ], k=10.0), "qv"),
}


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("live", [False, True], ids=["as_of_now", "live"])
@pytest.mark.parametrize("kind", sorted(INNER))
def test_data_index_stream_equals_reference(kind, live, k):
    make, qcol = INNER[kind]

    def script(pw, dev):
        docs, queries = _tables(pw)
        index = _mod(pw, "stdlib.indexing").DataIndex(docs, make(_mod(pw, "stdlib.indexing"), docs, pw, dev))
        ask = index.query if live else index.query_as_of_now
        res = ask(queries[qcol], number_of_matches=k, metadata_filter=queries["filter"]).select(
            qname=pw.left.qname, names=pw.right.name, ids=pw.right._pw_index_reply_id,
            scores=pw.right._pw_index_reply_score,
        )
        return {"res": res}

    ref, _got = _assert_same_streams(script)
    assert len(ref["res"]) >= len(_query_events())
    assert any(row["names"] for _t, _d, _k, row in ref["res"])


# --- the document-index helpers ------------------------------------------------------

HELPERS = {
    "default_vector_document_index": dict(embedder=True),
    "default_usearch_knn_document_index": dict(embedder=True),
    "default_brute_force_knn_document_index": dict(embedder=True),
    "default_lsh_knn_document_index": dict(embedder=True, dimensions=DIM),
    "default_ivf_knn_document_index": dict(embedder=True),
    "default_full_text_document_index": dict(),
}


@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_document_index_helper_equals_reference(helper):
    def script(pw, dev):
        docs, queries = _tables(pw)
        ix = _mod(pw, "stdlib.indexing")
        fn = getattr(ix, helper, None) or getattr(_mod(pw, "stdlib.indexing.vector_document_index"), helper)
        kw = dict(HELPERS[helper])
        if kw.pop("embedder", False):
            kw["embedder"] = _bow(pw)
            kw.update(dev)
        index = fn(docs.text, docs, metadata_column=docs.meta, **kw)
        res = index.query_as_of_now(queries.q, number_of_matches=3, metadata_filter=queries["filter"]).select(
            qname=pw.left.qname, names=pw.right.name, scores=pw.right._pw_index_reply_score)
        return {"res": res}

    ref, _got = _assert_same_streams(script)
    assert any(row["names"] for _t, _d, _k, row in ref["res"])


# --- KNNIndex -------------------------------------------------------------------------


@pytest.mark.parametrize("distance_type", ["euclidean", "cosine"])
@pytest.mark.parametrize("with_distances", [False, True])
@pytest.mark.parametrize("asof_now", [False, True], ids=["get_nearest_items", "asof_now"])
def test_knn_index_equals_reference(asof_now, with_distances, distance_type):
    def script(pw, dev):
        docs, queries = _tables(pw)
        index = pw.stdlib.ml.KNNIndex(docs.vec, docs, n_dimensions=DIM, distance_type=distance_type,
                                      metadata=docs.meta, **dev)
        ask = index.get_nearest_items_asof_now if asof_now else index.get_nearest_items
        return {"res": ask(queries.qv, k=3, with_distances=with_distances, metadata_filter=queries["filter"])}

    ref, _got = _assert_same_streams(script)
    assert any(row["name"] for _t, _d, _k, row in ref["res"])


def test_stdlib_ml_is_reachable_as_in_the_reference():
    assert tpw.stdlib.ml.KNNIndex is tpw.ml.KNNIndex
    assert set(jpw.stdlib.ml.__all__) - {"classifiers", "smart_table_ops"} <= set(tpw.stdlib.ml.__all__)
    assert tpw.stdlib.ml.utils._predict_asof_now


# --- DocumentStore over HybridIndexFactory -----------------------------------------


@pytest.fixture(scope="module")
def embedders():
    from pathway_tpu.xpacks.llm._encoder import TransformerEncoder as JaxEncoder
    from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JaxEmbedder
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TorchEmbedder

    kw = dict(dim=32, depth=2, heads=2, max_len=64, batch_size=64)
    jemb = JaxEmbedder(**kw)
    jemb.runtime.model = JaxEncoder(vocab_size=30522, dim=32, depth=2, heads=2, max_len=64, dtype=jnp.float32)
    temb = TorchEmbedder(device="cpu", **kw)
    temb.runtime.model.dtype = torch.float32
    return {"jax": jemb, "port": temb}


def _store_docs(n=120, seed=5):
    rng = np.random.default_rng(seed)
    words = [f"v{i}" for i in range(300)]
    out = []
    for i in range(n):
        text = ". ".join(" ".join(rng.choice(words, size=int(rng.integers(6, 18)))) for _ in range(3)) + "."
        out.append((i, text.encode(), {"path": f"dir{i % 3}/doc{i}.txt", "topic": ("a", "b")[i % 2]}))
    return out


@pytest.mark.parametrize("factories", ["bm25_dense", "bm25"])
def test_hybrid_document_store_equals_reference(embedders, factories):
    docs = _store_docs()

    def script(pkg):
        def build(pw, dev):
            ix = _mod(pw, "stdlib.indexing")
            split = _mod(pw, "xpacks.llm.splitters")
            ds = _mod(pw, "xpacks.llm.document_store")

            class DocSchema(pw.Schema):
                doc_id: int = pw.column_definition(primary_key=True)
                data: bytes
                _metadata: pw.Json

            doc_t = pw.debug.table_from_rows(DocSchema, docs)
            if factories == "bm25":
                factory = ix.TantivyBM25Factory()
            else:
                factory = ix.HybridIndexFactory([
                    ix.TantivyBM25Factory(),
                    ix.BruteForceKnnFactory(embedder=embedders[pkg], **dev),
                ])
            store = ds.DocumentStore(doc_t, retriever_factory=factory,
                                     splitter=split.TokenCountSplitter(min_tokens=10, max_tokens=30))
            chunk = lambda i: split.TokenCountSplitter(min_tokens=10, max_tokens=30).split(docs[i][1].decode())[0][0]  # noqa: E731
            rows = [(chunk(3), 4, None, None), (chunk(50), 3, "topic == 'b'", None),
                    ("v1 v2 v3 v4", 5, None, None), (chunk(77), 4, None, "dir2/*"), ("nothing here", 2, None, None)]
            queries = pw.debug.table_from_rows(store.RetrieveQuerySchema, rows)
            chunks = store._graph["chunked_docs"]
            return {"retrieve": store.retrieve_query(queries),
                    "chunks": chunks.select(text=chunks.text, metadata=chunks.metadata)}

        return build

    ref = _run("jax", script("jax"))
    got = _run("port", script("port"))
    assert [e[:3] for e in got["chunks"]] == [e[:3] for e in ref["chunks"]]  # the chunk keys
    assert [e[3] for e in got["chunks"]] == [e[3] for e in ref["chunks"]]
    assert [e[:3] for e in got["retrieve"]] == [e[:3] for e in ref["retrieve"]]
    n_replies = 0
    for g, r in zip(got["retrieve"], ref["retrieve"]):
        gr, rr = json.loads(g[3]["result"][1]), json.loads(r[3]["result"][1])
        assert [(d["text"], d["metadata"]) for d in gr] == [(d["text"], d["metadata"]) for d in rr]
        np.testing.assert_allclose([d["score"] for d in gr], [d["score"] for d in rr], atol=ENC_ATOL, rtol=0)
        n_replies += bool(rr)
    assert n_replies >= 4


def test_document_store_accepts_every_factory():
    from pathway_tpu_torch.stdlib import indexing as ix
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore

    docs = tpw.debug.table_from_rows(
        tpw.schema_from_types(data=bytes, _metadata=tpw.Json), [(b"a b c", tpw.Json({"path": "x"}))])
    emb = _bow(tpw)
    for factory in (ix.TantivyBM25Factory(), ix.LshKnnFactory(dimensions=DIM, embedder=emb, device="cpu"),
                    ix.IvfKnnFactory(embedder=emb, device="cpu"),
                    ix.HybridIndexFactory([ix.TantivyBM25Factory(), ix.BruteForceKnnFactory(embedder=emb,
                                                                                            device="cpu")])):
        port_parse_graph.G.clear()
        assert DocumentStore(docs, retriever_factory=factory).index is not None


# --- the reference's own cases, under both packages -----------------------------------


def _vec_rows(pw, rows, **extra):
    schema = pw.schema_from_types(name=str, vec=np.ndarray, **{k: type(v) for k, v in extra.items()})
    return pw.debug.table_from_rows(schema, [(n, np.asarray(v, np.float32), *extra.values()) for n, v in rows])


def _case_bm25_index(pw, dev):  # tests/test_indexing.py::test_bm25_index
    ix = _mod(pw, "stdlib.indexing")
    docs = pw.debug.table_from_rows(pw.schema_from_types(text=str), [
        ("the quick brown fox",), ("lazy dogs sleep deeply",), ("quick silver fox runs",)])
    queries = pw.debug.table_from_rows(pw.schema_from_types(q=str), [("quick fox",)])
    res = ix.DataIndex(docs, ix.TantivyBM25(docs.text)).query_as_of_now(queries.q, number_of_matches=2)
    return {"res": res.select(texts=pw.right.text)}


def _case_hybrid_index(pw, dev):  # tests/test_indexing.py::test_hybrid_index
    ix = _mod(pw, "stdlib.indexing")
    docs = pw.debug.table_from_rows(pw.schema_from_types(text=str, vec=np.ndarray), [
        ("alpha beta", np.asarray([1.0, 0.0], np.float32)), ("gamma delta", np.asarray([0.0, 1.0], np.float32))])
    queries = pw.debug.table_from_rows(pw.schema_from_types(q=str, vec=np.ndarray),
                                       [("alpha", np.asarray([1.0, 0.0], np.float32))])
    hybrid = ix.HybridIndex([ix.TpuKnn(docs.vec, dimensions=2, **dev), ix.TantivyBM25(docs.text)])
    res = ix.DataIndex(docs, hybrid).query_as_of_now(queries.vec, number_of_matches=1)
    return {"res": res.select(texts=pw.right.text)}


def _case_ml_knn_index(pw, dev):  # tests/test_indexing.py::test_ml_knn_index
    docs = _vec_rows(pw, [("a", [1.0, 0.0, 0.0]), ("b", [0.0, 1.0, 0.0]), ("c", [0.0, 0.0, 1.0]),
                          ("d", [0.9, 0.1, 0.0])])
    queries = _vec_rows(pw, [("q", [0.95, 0.05, 0.0])])
    index = pw.stdlib.ml.KNNIndex(docs.vec, docs, n_dimensions=3, **dev)
    return {"res": index.get_nearest_items(queries.vec, k=2, with_distances=True).without(pw.this.vec)}


def _case_lsh_knn(pw, dev):  # tests/test_indexing.py::test_lsh_knn
    ix = _mod(pw, "stdlib.indexing")
    base = np.random.default_rng(0).normal(size=(20, 8)).astype(np.float32)
    docs = _vec_rows(pw, [(f"d{i}", base[i]) for i in range(20)])
    queries = _vec_rows(pw, [("q", base[7] + 0.001)])
    inner = ix.LshKnn(docs.vec, dimensions=8, bucket_length=100.0, n_or=8, n_and=2, **dev)
    return {"res": ix.DataIndex(docs, inner).query_as_of_now(queries.vec, number_of_matches=1).select(
        names=pw.right.name)}


IVF_DOCS = [("a", [1.0, 0.0, 0.0]), ("b", [0.0, 1.0, 0.0]), ("c", [0.0, 0.0, 1.0]), ("d", [0.9, 0.1, 0.0])]


def _case_ivf_small_exact(pw, dev):  # tests/test_ivf.py::test_ivf_data_index_query_small_exact
    ix = _mod(pw, "stdlib.indexing")
    docs = _vec_rows(pw, IVF_DOCS)
    queries = _vec_rows(pw, [("q1", [1.0, 0.0, 0.0]), ("q2", [0.0, 1.0, 0.0])])
    res = ix.DataIndex(docs, ix.IvfKnn(docs.vec, dimensions=3, **dev)).query_as_of_now(
        queries.vec, number_of_matches=2)
    return {"res": res.select(qname=pw.left.name, names=pw.right.name)}


def _case_ivf_metadata_filter(pw, dev):  # tests/test_ivf.py::test_ivf_metadata_filter
    ix = _mod(pw, "stdlib.indexing")
    docs = pw.debug.table_from_rows(pw.schema_from_types(name=str, vec=np.ndarray, meta=dict), [
        ("a", np.asarray([1.0, 0.0], np.float32), {"lang": "en"}),
        ("b", np.asarray([0.9, 0.1], np.float32), {"lang": "fr"})])
    queries = pw.debug.table_from_rows(pw.schema_from_types(qname=str, filter=str, vec=np.ndarray),
                                       [("q1", "lang=='fr'", np.asarray([1.0, 0.0], np.float32))])
    res = ix.DataIndex(docs, ix.IvfKnn(docs.vec, docs.meta, dimensions=2, **dev)).query_as_of_now(
        queries.vec, number_of_matches=1, metadata_filter=queries["filter"])
    return {"res": res.select(names=pw.right.name)}


def _case_ivf_trained(pw, dev):  # tests/test_ivf.py::test_ivf_trained_engine_path
    ix = _mod(pw, "stdlib.indexing")
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 5
    rows = [(f"d{i}", centers[i % 8] + rng.normal(size=16).astype(np.float32) * 0.05) for i in range(512)]
    docs = _vec_rows(pw, rows)
    queries = _vec_rows(pw, [("q", centers[3])])
    inner = ix.IvfKnn(docs.vec, dimensions=16, min_train=256, n_clusters=8, n_probe=2, **dev)
    res = ix.DataIndex(docs, inner).query_as_of_now(queries.vec, number_of_matches=5)
    return {"res": res.select(names=pw.right.name, scores=pw.right._pw_index_reply_score)}


def _points(pw):  # tests/test_ported_ml_index.py::get_points, as rows
    pts = [(2, 2, 0), (3, -2, 0), (0, 0, 1), (-1, 0, 0), (2, -2, 1), (1, 2, 0), (-1, 1, 1), (-3, 1, 0),
           (-2, -3, 1), (1, -4, 0)]
    schema = pw.schema_from_types(coords=tuple, is_query=bool)
    table = pw.debug.table_from_rows(schema, [((float(x), float(y)), bool(q)) for x, y, q in pts])
    return (table.filter(~pw.this.is_query).without(pw.this.is_query),
            table.filter(pw.this.is_query).without(pw.this.is_query))


def _case_all_at_once(pw, dev):  # test_ported_ml_index.py::test_all_at_once / test_update_old
    ix = _mod(pw, "stdlib.indexing")
    points, queries = _points(pw)
    lsh = ix.LshKnn(points.coords, None, dimensions=2, n_and=5, **dev)
    queries = queries.with_columns(k=2)
    out = {}
    for name, inner in (("lsh", lsh), ("hybrid", ix.HybridIndex([lsh, lsh]))):
        out[name] = ix.DataIndex(points, inner).query(queries.coords, number_of_matches=queries.k).select(
            coords=pw.left.coords, nn=pw.right.coords)
    knn = pw.stdlib.ml.KNNIndex(points.coords, points, n_dimensions=2, n_and=5, **dev)
    out["knn"] = knn.get_nearest_items(queries.coords, k=2, with_distances=True)
    out["knn_asof_now"] = knn.get_nearest_items_asof_now(queries.coords, k=2)
    return out


def _case_full_text_search(pw, dev):  # test_ported_ml_index.py::test_full_text_search
    ix = _mod(pw, "stdlib.indexing")
    texts = ["Lorem ipsum dolor sit amet, consectetur adipiscing elit.",
             "Cras ex lorem, luctus nec dui eu, pellentesque vestibulum velit.",
             "Nunc laoreet tortor quis odio mattis vulputate.", "Quisque vel dictum neque, at efficitur nisi.",
             "Aliquam dui nibh, cursus ac porttitor nec, placerat quis nisi.",
             "Curabitur vehicula enim vitae rhoncus feugiat."]
    data = pw.debug.table_from_rows(pw.schema_from_types(index_text=str, extra_info=int),
                                    [(t, i + 1) for i, t in enumerate(texts)])
    queries = pw.debug.table_from_rows(pw.schema_from_types(query_text=str),
                                       [("nisi",), ("elit",), ("lorem",), ("marchewka",)])
    res = ix.DataIndex(data, ix.TantivyBM25(data.index_text, metadata_column=None)).query_as_of_now(
        query_column=queries.query_text, number_of_matches=4)
    return {"res": res.select(qtext=pw.left.query_text, info=pw.right.extra_info)}


def _case_lsh_helper_joined(pw, dev):  # test_ported_ml_index.py::test_output_joined_with_other_columns
    ix = _mod(pw, "stdlib.indexing")

    @pw.udf
    def embedder(x: str) -> list[float]:
        return [0.0, 1.0, 2.0]

    query = pw.debug.table_from_rows(pw.schema_from_types(query=str), [("a",)])
    docs = pw.debug.table_from_rows(pw.schema_from_types(doc=str), [("a",), ("b",), ("c",)])
    index = ix.default_lsh_knn_document_index(docs.doc, docs, dimensions=3, embedder=embedder, **dev)
    return {"res": query + index.query(query.query, collapse_rows=True).select(doc=pw.right.doc)}


def _case_index_factories(pw, dev):  # test_ported_ml_index.py::test_index_factory
    ix = _mod(pw, "stdlib.indexing")

    @pw.udf
    def fake_embedder(x: str) -> list[float]:
        return [0.0, 1.0, float(ord(x[0])) / 5.0]

    out = {}
    for name, factory in (
        ("lsh", ix.LshKnnFactory(dimensions=3, embedder=fake_embedder, **dev)),
        ("lsh_probed", ix.LshKnnFactory(embedder=fake_embedder, **dev)),
        ("ivf", ix.IvfKnnFactory(embedder=fake_embedder, **dev)),
        ("bm25", ix.TantivyBM25Factory()),
        ("hybrid", ix.HybridIndexFactory([
            ix.TantivyBM25Factory(),
            ix.UsearchKnnFactory(dimensions=3, reserved_space=3, embedder=fake_embedder,
                                 metric=ix.USearchMetricKind.COS, **dev)])),
    ):
        query = pw.debug.table_from_rows(pw.schema_from_types(query=str), [("a",)])
        docs = pw.debug.table_from_rows(pw.schema_from_types(doc=str), [("a",), ("b",), ("c",)])
        index = factory.build_index(docs.doc, docs)
        out[name] = query + index.query_as_of_now(query.query, collapse_rows=True, number_of_matches=1).select(
            pw.right.doc)
    return out


def _final(events):
    return [row for _t, d, _k, row in events if d > 0]


REFERENCE_CASES = {
    "test_bm25_index": _case_bm25_index,
    "test_hybrid_index": _case_hybrid_index,
    "test_ml_knn_index": _case_ml_knn_index,
    "test_lsh_knn": _case_lsh_knn,
    "test_ivf_data_index_query_small_exact": _case_ivf_small_exact,
    "test_ivf_metadata_filter": _case_ivf_metadata_filter,
    "test_ivf_trained_engine_path": _case_ivf_trained,
    "test_all_at_once": _case_all_at_once,
    "test_full_text_search": _case_full_text_search,
    "test_output_joined_with_other_columns": _case_lsh_helper_joined,
    "test_index_factory": _case_index_factories,
}

# the reference test's own assertion, held on the port's output
PORT_CHECKS = {
    "test_bm25_index": lambda out: [len(r["texts"]) == 2 and all("fox" in t for t in r["texts"])
                                    for r in _final(out["res"])] == [True],
    "test_hybrid_index": lambda out: [r["texts"] for r in _final(out["res"])] == [("alpha beta",)],
    "test_ml_knn_index": lambda out: [(set(r["name"]), all(d >= 0 for d in r["dist"]))
                                      for r in _final(out["res"])] == [({"a", "d"}, True)],
    "test_lsh_knn": lambda out: [r["names"] for r in _final(out["res"])] == [("d7",)],
    "test_ivf_data_index_query_small_exact": lambda out: {
        r["qname"]: r["names"][0] for r in _final(out["res"])} == {"q1": "a", "q2": "b"}
    and {r["qname"]: r["names"] for r in _final(out["res"])}["q1"] == ("a", "d"),
    "test_ivf_metadata_filter": lambda out: [r["names"] for r in _final(out["res"])] == [("b",)],
    "test_ivf_trained_engine_path": lambda out: [
        len(r["names"]) == 5 and all(int(n[1:]) % 8 == 3 for n in r["names"]) for r in _final(out["res"])] == [True],
    "test_all_at_once": lambda out: {
        r["coords"]: tuple(sorted(r["nn"])) for r in _final(out["lsh"])} == {
        (0.0, 0.0): ((-1.0, 0.0), (1.0, 2.0)), (2.0, -2.0): ((1.0, -4.0), (3.0, -2.0)),
        (-1.0, 1.0): ((-3.0, 1.0), (-1.0, 0.0)), (-2.0, -3.0): ((-1.0, 0.0), (1.0, -4.0))},
    "test_full_text_search": lambda out: {r["qtext"]: r["info"] for r in _final(out["res"])} == {
        "elit": (1,), "lorem": (1, 2), "marchewka": (), "nisi": (4, 5)},
    "test_output_joined_with_other_columns": lambda out: [tuple(sorted(r["doc"])) for r in _final(out["res"])]
    == [("a", "b", "c")],
    "test_index_factory": lambda out: all([r["doc"] for r in _final(t)] == [("a",)] for t in out.values()),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_case_equals_reference(case):
    _ref, got = _assert_same_streams(REFERENCE_CASES[case])
    assert PORT_CHECKS[case](got)


@pytest.mark.parametrize("factory", ["LshKnnFactory", "IvfKnnFactory"])
def test_knn_factory_needs_dimensions_or_embedder(factory):
    """``test_ported_ml_index.py::test_knn_index_factory_creation_error``."""
    from pathway_tpu_torch.stdlib import indexing as ix

    with pytest.raises(ValueError, match="Either `dimensions` or `embedder` must be provided"):
        getattr(ix, factory)(dimensions=None, embedder=None)
    assert getattr(ix, factory)(dimensions=3) is not None


# --- stores across the packages ----------------------------------------------------------


def _persisted_index_run(pkg, kind, base, query_files, want_queries, wait_docs):
    """Docs from ``base/docs`` and queries from ``base/queries`` (pw.io.fs
    jsonlines, streaming) into DataIndex over ``kind``, persisted in
    ``base/store``; the query files are written once ``wait_docs``
    documents are counted; returns the replies once ``want_queries`` are
    answered."""
    pw = PKGS[pkg]
    pw.internals.parse_graph.G.clear()
    ix = _mod(pw, "stdlib.indexing")
    dev = DEV[pkg]

    class DocSchema(pw.Schema):
        name: str
        text: str
        vec: list[float]

    class QSchema(pw.Schema):
        qname: str
        q: str
        qv: list[float]

    docs = pw.io.fs.read(os.path.join(base, "docs"), format="json", schema=DocSchema, mode="streaming")
    queries = pw.io.fs.read(os.path.join(base, "queries"), format="json", schema=QSchema, mode="streaming")
    if kind == "bm25":
        inner, col = ix.TantivyBM25(docs.text), queries.q
    else:
        inner, col = ix.IvfKnn(docs.vec, dimensions=DIM, min_train=32, n_clusters=4, **dev), queries.qv
    res = ix.DataIndex(docs, inner).query_as_of_now(col, number_of_matches=3).select(
        qname=pw.left.qname, names=pw.right.name, scores=pw.right._pw_index_reply_score)
    counts = docs.reduce(n=pw.reducers.count())
    replies, n_docs = {}, [0]
    pw.io.subscribe(res, on_change=lambda key, row, time, is_addition: is_addition and replies.__setitem__(
        row["qname"], (row["names"], row["scores"])))
    pw.io.subscribe(counts, on_change=lambda key, row, time, is_addition: is_addition and n_docs.__setitem__(
        0, row["n"]))
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(os.path.join(base, "store")),
                                              snapshot_every=1)
    th = threading.Thread(target=lambda: pw.run(persistence_config=cfg, autocommit_duration_ms=20), daemon=True)
    th.start()
    for path, rows in query_files:
        deadline = time.time() + 30
        while n_docs[0] < wait_docs and time.time() < deadline:
            time.sleep(0.02)
        with open(path + ".tmp", "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))
        os.replace(path + ".tmp", path)
    deadline = time.time() + 30
    while not all(q in replies for q in want_queries) and time.time() < deadline:
        time.sleep(0.02)
    time.sleep(0.3)  # a snapshot after the answer
    pw.internals.parse_graph.G.runtime.stop()
    th.join(10)
    drv = pw.internals.parse_graph.G.last_runtime.persistence_driver
    return replies, drv


def _qrows(names, seed):
    rng = np.random.default_rng(seed)
    return [{"qname": n, "q": " ".join(rng.choice(WORDS, size=3)), "qv": rng.normal(size=DIM).tolist()}
            for n in names]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("kind", ["bm25", "ivf"])
def test_index_store_written_by_one_package_restores_in_the_other(tmp_path, kind, writer, reader):
    """Run A (``writer``) indexes 60 documents and answers q0 (the IVF
    index trains there); run B (``reader``) restores A's store (no replay)
    and answers q1. Both replies equal a never-stopped run's."""
    base = str(tmp_path)
    os.makedirs(os.path.join(base, "docs"))
    os.makedirs(os.path.join(base, "queries"))
    rng = np.random.default_rng(3)
    with open(os.path.join(base, "docs", "d.jsonl"), "w") as f:
        for i in range(60):
            f.write(json.dumps({"name": f"d{i}", "text": " ".join(rng.choice(WORDS, size=int(rng.integers(2, 8)))),
                                "vec": rng.normal(size=DIM).tolist()}) + "\n")
    q0, q1 = _qrows(["q0"], 1), _qrows(["q1"], 2)
    a, _drv = _persisted_index_run(writer, kind, base, [(os.path.join(base, "queries", "q0.jsonl"), q0)], ["q0"],
                                   wait_docs=60)
    # the restored count emits nothing new: run B writes its query at once
    b, drv = _persisted_index_run(reader, kind, base, [(os.path.join(base, "queries", "q1.jsonl"), q1)], ["q1"],
                                  wait_docs=0)
    assert drv.restored_from_snapshot and drv.replayed_events == 0
    assert "q0" in a and "q1" in b

    # the never-stopped run: documents and both queries in one static run
    def script(pw, dev):
        ix = _mod(pw, "stdlib.indexing")
        rows = [json.loads(line) for line in open(os.path.join(base, "docs", "d.jsonl"))]
        docs = pw.debug.table_from_rows(pw.schema_from_types(name=str, text=str, vec=np.ndarray),
                                        [(r["name"], r["text"], np.asarray(r["vec"], np.float32)) for r in rows])
        queries = pw.debug.table_from_rows(pw.schema_from_types(qname=str, q=str, qv=np.ndarray),
                                           [(r["qname"], r["q"], np.asarray(r["qv"], np.float32)) for r in q0 + q1])
        if kind == "bm25":
            inner, col = ix.TantivyBM25(docs.text), queries.q
        else:
            inner, col = ix.IvfKnn(docs.vec, dimensions=DIM, min_train=32, n_clusters=4, **dev), queries.qv
        return {"res": ix.DataIndex(docs, inner).query_as_of_now(col, number_of_matches=3).select(
            qname=pw.left.qname, names=pw.right.name, scores=pw.right._pw_index_reply_score)}

    want = {row["qname"]: (row["names"], row["scores"]) for _t, d, _k, row in _run(reader, script)["res"] if d > 0}
    for q, got in (("q0", a["q0"]), ("q1", b["q1"])):
        assert tuple(got[0]) == want[q][0], q
        np.testing.assert_allclose(got[1], want[q][1], atol=ATOL, rtol=0)
