"""The live-RAG user script — documents streamed through ``pw.io.python``,
embedded by the ``SentenceTransformerEmbedder`` UDF inside the engine's
ticks, indexed by ``DataIndex`` over ``TpuKnn``, queried as of now — run
under both packages at a small width (dim 64, depth 2). Both encoders run
in float32 on shared weights (carried across by
``pathway_tpu_torch.convert.flax_to_torch``, as in test_torch_rag_e2e), so
every query must get the same matched keys in the same order, and scores
within atol 1e-4. The JAX side runs its interpreter
(``PATHWAY_COMPILED_TICK=0``)."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.stdlib.indexing import DataIndex as JaxDataIndex, TpuKnn as JaxTpuKnn
from pathway_tpu.xpacks.llm._encoder import TransformerEncoder as JaxEncoder
from pathway_tpu.xpacks.llm.embedders import SentenceTransformerEmbedder as JaxEmbedder
from pathway_tpu_torch.convert import flax_to_torch
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from pathway_tpu_torch.stdlib.indexing import DataIndex as PortDataIndex, TpuKnn as PortTpuKnn
from pathway_tpu_torch.xpacks.llm._encoder import TransformerEncoder as TorchEncoder
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder as TorchEmbedder

DIM, DEPTH, HEADS, MAXLEN = 64, 2, 4, 64
N_DOCS, N_QUERIES, K = 96, 12, 5


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


@pytest.fixture(scope="module")
def embedders():
    jemb = JaxEmbedder(dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, batch_size=32)
    rt = jemb.runtime
    rt.model = JaxEncoder(
        vocab_size=30522, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, dtype=jnp.float32
    )
    temb = TorchEmbedder(
        dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, device="cpu", batch_size=32
    )
    temb.runtime.model = flax_to_torch(
        rt.params,
        TorchEncoder(
            vocab_size=30522, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, dtype=torch.float32
        ),
    ).eval()
    return jemb, temb


def _texts(seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(300)]
    return [
        " ".join(rng.choice(words, size=int(rng.integers(4, 30)))) + f" topic{i % 5}"
        for i in range(N_DOCS)
    ]


def _user_script(pw, DataIndex, TpuKnn, emb, **dev):
    """The script of the port's README, with its subjects: documents stream
    in commits of 16; the queries start once every document is in."""
    texts = _texts()
    all_in = threading.Event()

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str
        meta: str

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        q: str

    class DocSubject(pw.io.python.ConnectorSubject):
        def run(self):
            for i, text in enumerate(texts):
                self.next(doc_id=i, text=text, meta=f"m{i % 4}")
                if i % 16 == 15:
                    self.commit()

    class QuerySubject(pw.io.python.ConnectorSubject):
        def run(self):
            assert all_in.wait(60)
            for i in range(N_QUERIES):
                self.next(qid=i, q=texts[(i * 7) % N_DOCS] if i % 3 else "w1 w2 topic3")

    docs = pw.io.python.read(DocSubject(), schema=DocSchema)
    corpus = docs.select(vec=emb(pw.this.text), meta=pw.this.meta)
    index = DataIndex(corpus, TpuKnn(corpus.vec, corpus.meta, dimensions=DIM, **dev))
    queries = pw.io.python.read(QuerySubject(), schema=QuerySchema)
    qvecs = queries.select(qid=pw.this.qid, v=emb(pw.this.q))
    answers = index.query_as_of_now(qvecs.v, number_of_matches=K).select(
        qid=pw.left.qid,
        ids=pw.right._pw_index_reply_id,
        scores=pw.right._pw_index_reply_score,
        meta=pw.right.meta,
    )
    seen = set()

    def corpus_in(key, row, time, is_addition):
        seen.add(int(key))
        if len(seen) == N_DOCS:
            all_in.set()

    replies = {}

    def record(key, row, time, is_addition):
        if is_addition:
            replies[row["qid"]] = (tuple(int(i) for i in row["ids"]), row["scores"], row["meta"])

    pw.io.subscribe(corpus, on_change=corpus_in)
    pw.io.subscribe(answers, on_change=record)
    pw.run()
    return replies


def test_user_script_gives_the_reference_replies(embedders):
    jemb, temb = embedders
    ref = _user_script(jpw, JaxDataIndex, JaxTpuKnn, jemb)
    port = _user_script(tpw, PortDataIndex, PortTpuKnn, temb, device="cpu")
    assert sorted(ref) == sorted(port) == list(range(N_QUERIES))
    for qid in ref:
        r_ids, r_scores, r_meta = ref[qid]
        p_ids, p_scores, p_meta = port[qid]
        assert len(r_ids) == K and p_ids == r_ids and p_meta == r_meta
        np.testing.assert_allclose(p_scores, r_scores, atol=1e-4, rtol=0)
    # a query copied from a document finds that document first
    for qid, (ids, scores, _m) in port.items():
        if qid % 3:
            assert ids[0] == int(tpw.Pointer(int(tpw.internals.api.ref_scalar((qid * 7) % N_DOCS))))
            assert scores[0] > -1e-4
