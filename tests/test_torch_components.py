"""The slice as a whole, at a small size, through both packages on the CPU:
seeded near-duplicate documents go through a 2-layer, 32-wide seeded
encoder (``SentenceTransformerEmbedder``, float32 on both sides) into a
``DataIndex`` over ``TpuKnn``; every document asks the live index for its 9
nearest neighbours (``query``, not ``query_as_of_now``, so the graph follows
updates); the edges scoring at least ``THRESHOLD`` (self-edges dropped) go
through ``pw.iterate`` (minimum-label propagation) to connected components;
``pw.sql`` counts each component's size. Later ticks insert documents and
delete some, splitting families.

Tolerances: the edges' scores agree within 1e-5 (the two encoders sum f32
in another order); edge keys, the components' keys and labels, and the SQL
sizes are exact. A score within 1e-4 of the threshold would make the
choice of an edge depend on that rounding, so the test checks that its
seeded data has none (a near tie at the ninth neighbour would show as a key
that differs). The narrow random encoder does not keep a family's
variants together as the full-width one does, so the graph is not the
families'; what is checked is that the engine's components are those of
its own edges. Every tick's labels
equal ``scipy``'s connected components of that tick's edges, and every
tick's sizes equal a ``numpy.bincount`` of its labels. The JAX side runs
with ``PATHWAY_COMPILED_TICK=0``."""

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import assert_streams_equal, components

DIM, DEPTH, HEADS, MAXLEN = 32, 2, 2, 64
K = 9
THRESHOLD = -0.02  # score = cosine - 1
SCORE_ATOL = 1e-5
MARGIN = 1e-4
_LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))
WORDS = ["".join(np.random.default_rng(i).choice(_LETTERS, size=3 + i % 6)) for i in range(2000)]


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def family_docs(seed, families, size=4, first_id=0):
    """``families`` families of ``size`` near-duplicates: each variant
    drops or swaps a few words of its family's base text."""
    rng = np.random.default_rng(seed)
    docs = []
    for f in range(families):
        base = list(rng.choice(WORDS, size=24))
        for v in range(size):
            words = list(base)
            for _ in range(int(rng.integers(1, 3))):
                if rng.random() < 0.5:
                    del words[int(rng.integers(len(words)))]
                else:
                    i, j = rng.integers(len(words), size=2)
                    words[i], words[j] = words[j], words[i]
            docs.append((first_id + f * size + v, " ".join(words)))
    return docs


def doc_stream(seed):
    """(doc, text, time, diff): 10 families at time 2, 3 more at time 4,
    at time 6 the middle variants of 3 families and one whole family go."""
    first = family_docs(seed, 10)
    later = family_docs(seed + 1, 3, first_id=100)
    rows = [(d, t, 2, 1) for d, t in first] + [(d, t, 4, 1) for d, t in later]
    gone = [first[1], first[2], first[9], first[17], first[28], first[29], first[30], first[31]]
    rows += [(d, t, 6, -1) for d, t in gone]
    return rows


def _embedder(pw):
    if pw is jpw:
        import jax.numpy as jnp

        from pathway_tpu.xpacks.llm._encoder import TransformerEncoder
        from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder

        emb = SentenceTransformerEmbedder(dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN)
        emb.runtime.model = TransformerEncoder(
            vocab_size=30522, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, dtype=jnp.float32
        )
        return emb
    import torch

    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    emb = SentenceTransformerEmbedder(dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, device="cpu")
    emb.runtime.model.dtype = torch.float32
    return emb


def pipeline(pw, seed):
    """(scored neighbour pairs, kept edges, components, sizes)."""
    from importlib import import_module

    indexing = import_module(pw.__name__ + ".stdlib.indexing")

    class Doc(pw.Schema):
        doc: int = pw.column_definition(primary_key=True)
        text: str

    docs = pw.debug.table_from_rows(Doc, doc_stream(seed), is_stream=True)
    docs = docs.with_columns(vec=_embedder(pw)(pw.this.text))
    knn = {"dimensions": DIM} if pw is jpw else {"dimensions": DIM, "device": "cpu"}
    index = indexing.DataIndex(docs, indexing.TpuKnn(docs.vec, **knn))
    hits = index.query(docs.vec, number_of_matches=K, collapse_rows=False)
    pairs = hits.select(u=pw.left.doc, w=pw.right.doc, score=pw.right._pw_index_reply_score)
    edges = pairs.filter((pairs.score >= THRESHOLD) & (pairs.u != pairs.w))
    comps = components(pw, edges)
    sizes = pw.sql("SELECT label, COUNT(*) AS size FROM comps GROUP BY label", comps=comps)
    return pairs, edges, comps, sizes


def _run(pw, seed):
    pw.internals.parse_graph.G.clear()
    tables = pipeline(pw, seed)
    events = [[] for _ in tables]

    def recorder(out):
        def on_change(key, row, time, is_addition):
            out.append((time, 1 if is_addition else -1, int(key),
                        tuple(sorted((k, v.item() if isinstance(v, np.generic) else v) for k, v in row.items()))))

        return on_change

    for t, out in zip(tables, events):
        pw.io.subscribe(t, on_change=recorder(out))
    pw.run()
    return [sorted(e, key=repr) for e in events]


def _states_by_time(events):
    """The table after each time: {time: {key: row}}."""
    out, state = {}, {}
    for t in sorted({e[0] for e in events}):
        for _t, d, k, row in (e for e in events if e[0] == t):
            if d < 0 and state.get(k) == dict(row):
                del state[k]
        for _t, d, k, row in (e for e in events if e[0] == t):
            if d > 0:
                state[k] = dict(row)
        out[t] = dict(state)
    return out


@pytest.mark.parametrize("seed", [3])
def test_components_slice_equals_reference_and_scipy(seed):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    pairs_p, edges_p, comps_p, sizes_p = _run(tpw, seed)
    pairs_j, edges_j, comps_j, sizes_j = _run(jpw, seed)
    # the data has no discrete choice within rounding of the encoders
    for _t, _d, _k, row in pairs_j:
        assert abs(dict(row)["score"] - THRESHOLD) > MARGIN, row
    assert_streams_equal(pairs_p, pairs_j, tol=SCORE_ATOL)
    assert_streams_equal(edges_p, edges_j, tol=SCORE_ATOL)
    assert comps_p == comps_j and sizes_p == sizes_j
    assert any(d < 0 for _t, d, _k, _r in comps_p)  # the deletions split components

    edge_states = _states_by_time(edges_p)
    comp_states = _states_by_time(comps_p)
    size_states = _states_by_time(sizes_p)
    assert sorted(edge_states) == sorted(comp_states) == [2, 4, 6]
    for t, edges in edge_states.items():
        uw = np.array([(e["u"], e["w"]) for e in edges.values()])
        n = int(uw.max()) + 1
        _, lab = connected_components(
            sp.coo_matrix((np.ones(len(uw)), (uw[:, 0], uw[:, 1])), shape=(n, n)), directed=False
        )
        labels = {row["v"]: row["label"] for row in comp_states[t].values()}
        assert set(labels) == set(uw.ravel().tolist())
        least = {}
        for v in sorted(labels):
            least.setdefault(lab[v], v)
        assert labels == {v: least[lab[v]] for v in labels}, t
        counts = np.bincount(np.array(list(labels.values()), dtype=np.int64))
        want = {lab: int(c) for lab, c in enumerate(counts.tolist()) if c}
        assert {row["label"]: row["size"] for row in size_states[t].values()} == want, t
    # a graph of several components, not one, nor only isolated pairs
    assert 3 <= len(size_states[4]) <= len(comp_states[4]) // 3
