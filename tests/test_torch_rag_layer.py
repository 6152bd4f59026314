"""The port's RAG product layer against the JAX package's, piece by piece:
splitters, parsers and prompts on a seeded corpus; the rerankers; the
question answerers over a ``VectorStoreServer``; the API embedders and
chats against fake client modules; and the REST clients against a
monkeypatched ``requests.post``. No network is used.

Tolerances: texts, metadata, prompts, answers and the kept ``rerank_topk_filter``
order are exact. Encoders compute in float32 on both sides: reranker
scores agree within atol 1e-5, with weights carried by ``convert.py`` or
drawn by both packages' seeded init. The JAX side runs its interpreter
(``PATHWAY_COMPILED_TICK=0``)."""

import asyncio
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.xpacks.llm import (
    _encoder as jenc,
    embedders as jemb_mod,
    llms as jllms,
    parsers as jparsers,
    prompts as jprompts,
    question_answering as jqa,
    rerankers as jrr,
    splitters as jsplit,
    utils as jutils,
    vector_store as jvs,
)
from pathway_tpu_torch.convert import flax_to_torch
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from pathway_tpu_torch.xpacks.llm import (
    embedders as temb_mod,
    llms as tllms,
    parsers as tparsers,
    prompts as tprompts,
    question_answering as tqa,
    rerankers as trr,
    splitters as tsplit,
    utils as tutils,
    vector_store as tvs,
)

DIM, DEPTH, HEADS, MAXLEN = 32, 2, 2, 64
CROSS_DIM, CROSS_DEPTH, CROSS_HEADS = 32, 1, 2
SCORE_ATOL = 1e-5
DIST_ATOL = 1e-4

JAX = types.SimpleNamespace(
    pw=jpw, vs=jvs, qa=jqa, rr=jrr, llms=jllms, split=jsplit, parsers=jparsers,
    emb=jemb_mod, utils=jutils, dev={},
)
PORT = types.SimpleNamespace(
    pw=tpw, vs=tvs, qa=tqa, rr=trr, llms=tllms, split=tsplit, parsers=tparsers,
    emb=temb_mod, utils=tutils, dev={"device": "cpu"},
)


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


WORDS = [f"w{i}" for i in range(300)]


def _corpus(n=60, seed=0):
    rng = np.random.default_rng(seed)
    texts = []
    for i in range(n):
        blocks = []
        for b in range(int(rng.integers(1, 5))):
            sentence = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 25))))
            kind = int(rng.integers(0, 5))
            if kind == 0:
                blocks.append(f"# Title {i} {b}")
            elif kind == 1:
                blocks.append(f"- item {sentence}")
            elif kind == 2:
                blocks.append(f"| a | b |\n|---|---|\n| {i} | {b} |")
            blocks.append(sentence + ("." if kind != 3 else "!"))
        text = "\n\n".join(blocks)
        if i % 7 == 0:
            text += "\f" + " ".join(rng.choice(WORDS, size=12)) + "."
        texts.append(text)
    return texts


# --- splitters, parsers, prompts, utils --------------------------------------


SPLITTERS = [
    ("NullSplitter", {}),
    ("TokenCountSplitter", {"min_tokens": 5, "max_tokens": 20}),
    ("TokenCountSplitter", {}),
    ("RecursiveSplitter", {"chunk_size": 12}),
    ("RecursiveSplitter", {"chunk_size": 40, "separators": [". ", " "]}),
]


@pytest.mark.parametrize("name,kw", SPLITTERS, ids=[f"{n}{i}" for i, (n, _k) in enumerate(SPLITTERS)])
def test_splitters_equal_reference(name, kw):
    ref, got = getattr(jsplit, name)(**kw), getattr(tsplit, name)(**kw)
    for text in _corpus() + ["", "one", "a. b. c."]:
        assert got.split(text) == ref.split(text)


@pytest.mark.parametrize("mode", ["single", "elements", "paged", "basic", "by_title"])
def test_parsers_equal_reference(mode):
    kw = {"chunking_kwargs": {"max_characters": 120}} if mode in ("basic", "by_title") else {}
    pairs = [
        (jparsers.Utf8Parser(), tparsers.Utf8Parser()),
        (jparsers.UnstructuredParser(chunking_mode=mode, **kw), tparsers.UnstructuredParser(chunking_mode=mode, **kw)),
        (jparsers.DoclingParser(chunking_mode=mode), tparsers.DoclingParser(chunking_mode=mode)),
    ]
    for text in _corpus(seed=1):
        data = text.encode()
        ref_el = [(e.text, e.category, e.metadata) for e in jparsers.native_partition(data)]
        got_el = [(e.text, e.category, e.metadata) for e in tparsers.native_partition(data)]
        assert got_el == ref_el
        for ref, got in pairs:
            assert got.parse(data) == ref.parse(data)


def test_parser_chunkers_equal_reference():
    for text in _corpus(seed=2):
        ref_el = jparsers.native_partition(text.encode())
        got_el = tparsers.native_partition(text.encode())
        for kw in ({"max_characters": 80}, {"max_characters": 50, "overlap": 10, "new_after_n_chars": 30}):
            r = [(c.text, c.metadata) for c in jparsers.chunk_elements_basic(ref_el, **kw)]
            g = [(c.text, c.metadata) for c in tparsers.chunk_elements_basic(got_el, **kw)]
            assert g == r
            r = [(c.text, c.metadata) for c in jparsers.chunk_by_title(ref_el, **kw)]
            g = [(c.text, c.metadata) for c in tparsers.chunk_by_title(got_el, **kw)]
            assert g == r


def test_image_and_slide_parsers_equal_reference():
    def vision(prompt, image):
        return f"{prompt}:{len(image)}"

    for cls in ("ImageParser", "SlideParser"):
        ref = getattr(jparsers, cls)(llm=vision).parse(b"\x89PNG fake")
        assert getattr(tparsers, cls)(llm=vision).parse(b"\x89PNG fake") == ref
    with pytest.raises(ValueError):
        tparsers.ImageParser().parse(b"x")


def test_prompts_equal_reference():
    docs = [{"text": t} for t in _corpus(n=5)] + ["plain", jpw.Json({"text": "j"})]
    port_docs = docs[:-1] + [tpw.Json({"text": "j"})]
    q = "what is w5?"
    assert tprompts.prompt_qa(q, port_docs) == jprompts.prompt_qa(q, docs)
    assert tprompts.prompt_qa_geometric_rag(q, port_docs, "none", " rule") == jprompts.prompt_qa_geometric_rag(
        q, docs, "none", " rule"
    )
    assert tprompts.prompt_short_qa("ctx", q) == jprompts.prompt_short_qa("ctx", q)
    assert tprompts.prompt_summarize(["a", "b"]) == jprompts.prompt_summarize(["a", "b"])
    assert tprompts.prompt_query_rewrite(q) == jprompts.prompt_query_rewrite(q)
    assert tprompts.prompt_query_rewrite_hyde(q) == jprompts.prompt_query_rewrite_hyde(q)
    assert tllms.prompt_chat_single_qa(q) == jllms.prompt_chat_single_qa(q)
    assert tllms._messages_to_prompt([{"role": "user", "content": "x"}, "y"]) == "x\ny"


def _plain(v):
    if type(v).__name__ == "Json":
        return repr(v.value)
    return repr(v)


def _dicts(pw, table):
    """The table's rows as sorted tuples of comparable text."""
    keys, cols = pw.debug.table_to_dicts(table)
    return sorted(tuple(_plain(cols[c][k]) for c in sorted(cols)) for k in keys)


def test_combine_metadata_equals_reference():
    def build(pkg):
        pw = pkg.pw
        t = pw.debug.table_from_rows(
            pw.schema_from_types(text=object, metadata=dict),
            [(("chunk a", {"page": 1}), {"path": "x"}), ("chunk b", {"path": "y"})],
        )
        return _dicts(pw, pkg.utils.combine_metadata(t))

    ref = build(JAX)
    port_parse_graph.G.clear()
    assert build(PORT) == ref
    assert ("{'path': 'x', 'page': 1}", "'chunk a'") in ref


# --- rerankers ---------------------------------------------------------------


def _pairs(n=14, seed=4):
    texts = _corpus(n=n, seed=seed)
    return [(texts[i], f"query {WORDS[i]} {WORDS[i + 1]}") for i in range(n)]


def _cross_encoders(carry):
    kw = dict(dim=CROSS_DIM, depth=CROSS_DEPTH, heads=CROSS_HEADS, max_len=MAXLEN)
    ref = jrr.CrossEncoderReranker(**kw)
    enc = jenc.TransformerEncoder(
        vocab_size=ref.tokenizer.vocab_size, dim=CROSS_DIM, depth=CROSS_DEPTH, heads=CROSS_HEADS,
        max_len=MAXLEN, dtype=jnp.float32,
    )
    ref.runtime.model = jenc.CrossEncoderHead(enc)
    got = trr.CrossEncoderReranker(device="cpu", **kw)
    got.runtime.model.encoder.dtype = torch.float32
    if carry:
        # other weights than the seeded ones, carried across
        ref.runtime.params = jenc.EncoderRuntime(
            vocab_size=ref.tokenizer.vocab_size, dim=CROSS_DIM, depth=CROSS_DEPTH,
            heads=CROSS_HEADS, max_len=MAXLEN, seed=11, cross_encoder=True,
        ).params
        flax_to_torch(ref.runtime.params, got.runtime.model)
    return ref, got


def _score_table(pkg, reranker, pairs):
    pw = pkg.pw
    t = pw.debug.table_from_rows(pw.schema_from_types(doc=str, query=str), pairs)
    keys, cols = pw.debug.table_to_dicts(t.select(s=reranker(pw.this.doc, pw.this.query), doc=pw.this.doc))
    return sorted((cols["doc"][k], cols["s"][k]) for k in keys)


@pytest.mark.parametrize("carry", [False, True], ids=["seeded", "convert"])
def test_cross_encoder_scores_equal_reference(carry):
    ref, got = _cross_encoders(carry)
    pairs = _pairs()
    r = _score_table(JAX, ref, pairs)
    port_parse_graph.G.clear()
    g = _score_table(PORT, got, pairs)
    assert [d for d, _ in g] == [d for d, _ in r]
    np.testing.assert_allclose([s for _, s in g], [s for _, s in r], atol=SCORE_ATOL, rtol=0)
    # the batched path scores one tick's pairs in one forward
    direct = got._score_batch([d for d, _ in pairs], [q for _, q in pairs])
    one = [got._score(d, q) for d, q in pairs[:3]]
    np.testing.assert_allclose(one, direct[:3], atol=SCORE_ATOL, rtol=0)
    assert got._pair_text({"text": "doc"}, "q") == ref._pair_text({"text": "doc"}, "q") == "q [SEP] doc"


@pytest.mark.parametrize("carry", [False, True], ids=["seeded", "convert"])
def test_encoder_reranker_scores_equal_reference(carry):
    kw = dict(dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN)
    ref = jrr.EncoderReranker(**kw)
    ref.embedder.runtime.model = jenc.TransformerEncoder(
        vocab_size=30522, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, dtype=jnp.float32
    )
    got = trr.EncoderReranker(device="cpu", **kw)
    got.embedder.runtime.model.dtype = torch.float32
    if carry:
        ref.embedder.runtime.params = jenc.EncoderRuntime(
            vocab_size=30522, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, seed=13
        ).params
        flax_to_torch(ref.embedder.runtime.params, got.embedder.runtime.model)
    for doc, query in _pairs(n=6):
        assert got._score({"text": doc}, query) == pytest.approx(ref._score({"text": doc}, query), abs=SCORE_ATOL)


def test_cross_encoder_mesh_raises():
    """``mesh=`` raised [mesh] until the mesh was ported: the reranker now
    splits each tick's pairs over the mesh's shards, and scores them as
    the unsharded one does (f32 on the CPU)."""
    from pathway_tpu_torch.parallel import make_mesh

    _ref, plain = _cross_encoders(False)
    sharded = trr.CrossEncoderReranker(mesh=make_mesh(3, device="cpu"), device="cpu", dim=CROSS_DIM,
                                       depth=CROSS_DEPTH, heads=CROSS_HEADS, max_len=MAXLEN)
    sharded.runtime.model.encoder.dtype = torch.float32
    pairs = _pairs(n=7)
    docs, queries = [d for d, _ in pairs], [q for _, q in pairs]
    np.testing.assert_allclose(sharded._score_batch(docs, queries), plain._score_batch(docs, queries),
                               atol=SCORE_ATOL, rtol=0)


def test_rerank_topk_filter_is_exact():
    def build(pkg):
        pw = pkg.pw
        t = pw.debug.table_from_rows(
            pw.schema_from_types(docs=tuple, scores=tuple),
            [(("a", "b", "c", "d"), (0.1, 0.9, 0.5, 0.9)), (("x",), (2.0,)), ((), ())],
        )
        return sorted(
            repr(v) for v in pw.debug.table_to_dicts(
                t.select(top=pkg.rr.rerank_topk_filter(pw.this.docs, pw.this.scores, k=3))
            )[1]["top"].values()
        )

    ref = build(JAX)
    port_parse_graph.G.clear()
    assert build(PORT) == ref
    assert "(('b', 'd', 'c'), (0.9, 0.9, 0.5))" in ref


def _judge_chat(llms):
    class Judge(llms.BaseChat):
        def _accept(self, messages, **kwargs):
            prompt = llms._messages_to_prompt(messages)
            return '{"score": 4}' if "w1 " in prompt else "I would say 2.5 of 5"

    return Judge()


def test_llm_reranker_equals_reference():
    docs = ["w1 w2", "w3 w4", "w1 w5"]
    ref = jrr.LLMReranker(_judge_chat(jllms))
    got = trr.LLMReranker(_judge_chat(tllms))
    assert [got._score(d, "q") for d in docs] == [ref._score(d, "q") for d in docs] == [4.0, 2.5, 4.0]


# --- question answering -------------------------------------------------------


def _store(pkg, emb, texts):
    pw = pkg.pw

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        data: bytes
        _metadata: pw.Json

    docs = pw.debug.table_from_rows(
        DocSchema,
        [(i, t.encode(), {"path": f"d{i % 2}/{i}.md"}) for i, t in enumerate(texts)],
    )
    return pkg.vs.VectorStoreServer(
        docs, embedder=emb, splitter=pkg.split.TokenCountSplitter(min_tokens=5, max_tokens=25), **pkg.dev
    )


@pytest.fixture(scope="module")
def embedders():
    kw = dict(dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, batch_size=64)
    j = jemb_mod.SentenceTransformerEmbedder(**kw)
    j.runtime.model = jenc.TransformerEncoder(
        vocab_size=30522, dim=DIM, depth=DEPTH, heads=HEADS, max_len=MAXLEN, dtype=jnp.float32
    )
    t = temb_mod.SentenceTransformerEmbedder(device="cpu", **kw)
    t.runtime.model.dtype = torch.float32
    return j, t


def _docs_needed_chat(llms):
    """Answers only once the prompt carries at least 4 documents."""

    class Chat(llms.BaseChat):
        def _accept(self, messages, **kwargs):
            prompt = llms._messages_to_prompt(messages)
            n = prompt.split("Articles:\n", 1)[-1].split("\nQuestion:")[0].count("\n\n") + 1
            return f"answer from {n} docs" if n >= 4 else "No information found."

    return Chat()


def _qa_run(pkg, emb, answerer_name, chat, texts, **kw):
    pw = pkg.pw
    store = _store(pkg, emb, texts)
    qa = getattr(pkg.qa, answerer_name)(chat, store, **kw)
    queries = pw.debug.table_from_rows(
        qa.AnswerQuerySchema,
        [
            (" ".join(texts[i].split()[:6]), None if i % 2 else "path == 'd0/0.md' || contains(path, 'd0')", None, i % 3 == 0)
            for i in range(0, 12, 2)
        ],
    )
    summarize = pw.debug.table_from_rows(
        qa.SummarizeQuerySchema, [(pw.Json(["alpha text", "beta text"]), None)]
    )
    stats = pw.debug.table_from_rows(pw.schema_from_types(n=int), [(1,)])
    out = {}
    for name, table in (
        ("answer", qa.answer_query(queries)),
        ("summary", qa.summarize_query(summarize)),
        ("retrieve", qa.retrieve(pw.debug.table_from_rows(
            store.RetrieveQuerySchema, [(texts[1][:30], 2, None, None)]))),
        ("statistics", qa.statistics(stats)),
        ("list", qa.list_documents(pw.debug.table_from_rows(store.InputsQuerySchema, [(None, "d1/*")]))),
    ):
        sink = out.setdefault(name, [])
        pw.io.subscribe(table, on_change=lambda key, row, time, is_addition, s=sink: s.append(row["result"]))
    pw.run()
    return {k: sorted(_strip_dist(v) for v in vs) for k, vs in out.items()}


def _strip_dist(v):
    """Results as comparable text, every dist rounded to the test's
    tolerance."""
    v = v.value if type(v).__name__ == "Json" else v

    def walk(x):
        if isinstance(x, dict):
            return {k: (round(val, 3) if k == "dist" else walk(val)) for k, val in x.items()}
        if isinstance(x, list):
            return [walk(i) for i in x]
        return x

    return repr(walk(v))


@pytest.mark.parametrize(
    "answerer,chat",
    [("BaseRAGQuestionAnswerer", "echo"), ("BaseRAGQuestionAnswerer", "docs"), ("AdaptiveRAGQuestionAnswerer", "docs")],
)
def test_question_answerers_equal_reference(embedders, answerer, chat):
    jemb, temb = embedders
    texts = _corpus(n=30, seed=6)

    def make(llms):
        return llms.EchoChat(prefix="echo: ") if chat == "echo" else _docs_needed_chat(llms)

    kw = {"search_topk": 5} if answerer == "BaseRAGQuestionAnswerer" else {"n_starting_documents": 2, "factor": 2, "max_iterations": 3}
    ref = _qa_run(JAX, jemb, answerer, make(jllms), texts, **kw)
    port_parse_graph.G.clear()
    got = _qa_run(PORT, temb, answerer, make(tllms), texts, **kw)
    assert got == ref
    assert len(got["answer"]) == 6
    if chat == "echo":
        # every echoed answer holds the texts the store retrieved for it
        assert all("echo: Use the below articles" in a for a in got["answer"])
    elif answerer == "AdaptiveRAGQuestionAnswerer":
        assert all("answer from 4 docs" in a for a in got["answer"])


def test_geometric_strategy_equals_reference():
    docs = [f"doc {i}" for i in range(10)]
    got = []
    for n0, factor, iters in ((1, 2, 4), (1, 2, 2), (2, 3, 2), (5, 2, 1)):
        r = jqa.answer_with_geometric_rag_strategy("q", docs, _docs_needed_chat(jllms), n0, factor, iters)
        g = tqa.answer_with_geometric_rag_strategy("q", docs, _docs_needed_chat(tllms), n0, factor, iters)
        assert g == r
        got.append(g)
    assert got == ["answer from 4 docs", None, "answer from 6 docs", "answer from 5 docs"]


def test_geometric_strategy_from_index_equals_reference(embedders):
    jemb, temb = embedders
    texts = _corpus(n=24, seed=8)

    def run(pkg, emb, idx):
        pw = pkg.pw
        docs = pw.debug.table_from_rows(pw.schema_from_types(text=str), [(t,) for t in texts])
        index = idx.DataIndex(docs, idx.BruteForceKnn(docs.text, dimensions=DIM, embedder=emb, **pkg.dev))
        qs = pw.debug.table_from_rows(pw.schema_from_types(q=str), [(texts[i][:40],) for i in range(0, 24, 4)])
        answers = pkg.qa.answer_with_geometric_rag_strategy_from_index(
            qs.q, index, "text", _docs_needed_chat(pkg.llms), 1, 2, 4
        )
        keys, cols = pw.debug.table_to_dicts(qs.select(a=answers))
        return sorted(cols["a"].values(), key=repr)

    from pathway_tpu.stdlib import indexing as jidx
    from pathway_tpu_torch.stdlib import indexing as tidx

    ref = run(JAX, jemb, jidx)
    port_parse_graph.G.clear()
    got = run(PORT, temb, tidx)
    assert got == ref and len(got) == 6
    assert all(a is not None and a.startswith("answer from") for a in got)


def test_prompt_templates_validate_like_reference():
    for tpl in ("{context} {query}", "{query}"):
        errs = []
        for mod in (jqa, tqa):
            try:
                mod._validate_prompt_template(tpl)
                errs.append(None)
            except ValueError as exc:
                errs.append(str(exc))
        assert errs[0] == errs[1]


# --- API embedders and chats over fake clients --------------------------------


def _fake_clients(monkeypatch):
    calls = []

    class _Resp:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    async def emb_create(input, model):
        calls.append(("openai.embed", input, model))
        return _Resp(data=[_Resp(embedding=[float(len(input[0])), 1.0, 2.0])])

    async def chat_create(messages, model, **params):
        calls.append(("openai.chat", messages, model, params))
        return _Resp(choices=[_Resp(message=_Resp(content=f"openai:{messages[-1]['content']}"))])

    class AsyncOpenAI:
        def __init__(self, **kw):
            self.embeddings = _Resp(create=emb_create)
            self.chat = _Resp(completions=_Resp(create=chat_create))

    async def aembedding(input, model):
        calls.append(("litellm.embed", input, model))
        return _Resp(data=[{"embedding": [3.0, float(len(input[0]))]}])

    async def acompletion(model, messages, **params):
        calls.append(("litellm.chat", model, params))
        return {"choices": [{"message": {"content": f"litellm:{messages[-1]['content']}"}}]}

    def embed_content(model, content):
        calls.append(("gemini.embed", model, content))
        return {"embedding": [float(len(content)), 0.5]}

    class AsyncClient:
        async def chat(self, message, model):
            calls.append(("cohere.chat", model))
            return _Resp(text=f"cohere:{message}")

    def pipeline(task, model, **kw):
        return lambda prompt, **call: [{"generated_text": f"hf:{prompt}"}]

    google = types.ModuleType("google")
    genai = types.ModuleType("google.generativeai")
    genai.embed_content = embed_content
    google.generativeai = genai
    fakes = {
        "openai": types.SimpleNamespace(AsyncOpenAI=AsyncOpenAI),
        "litellm": types.SimpleNamespace(aembedding=aembedding, acompletion=acompletion),
        "cohere": types.SimpleNamespace(AsyncClient=AsyncClient),
        "transformers": types.SimpleNamespace(pipeline=pipeline),
        "google": google,
        "google.generativeai": genai,
    }
    for name, mod in fakes.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return calls


def _api_run(pkg):
    pw = pkg.pw
    t = pw.debug.table_from_rows(pw.schema_from_types(text=str), [("hello",), ("a longer text",)])
    embedders = {
        "openai": pkg.emb.OpenAIEmbedder(model="m-emb"),
        "litellm": pkg.emb.LiteLLMEmbedder(model="l-emb"),
        "gemini": pkg.emb.GeminiEmbedder(),
        "openai_dims": pkg.emb.OpenAIEmbedderWithDimensions(),
    }
    chats = {
        "openai": pkg.llms.OpenAIChat(model="gpt-x", temperature=0.0, max_tokens=5),
        "litellm": pkg.llms.LiteLLMChat(model="cohere/command"),
        "cohere": pkg.llms.CohereChat(),
        "hf": pkg.llms.HFPipelineChat(model="tiny"),
    }
    cols = {f"e_{k}": e(pw.this.text) for k, e in embedders.items()}
    msgs = pw.apply_with_type(lambda s: ({"role": "user", "content": s},), pw.Json, pw.this.text)
    cols.update({f"c_{k}": c(msgs) for k, c in chats.items()})
    keys, out = pw.debug.table_to_dicts(t.select(text=pw.this.text, **cols))
    dims = {k: e.get_embedding_dimension() for k, e in embedders.items()}
    rows = sorted(
        tuple((c, [float(x) for x in out[c][k]] if c.startswith("e_") else out[c][k]) for c in sorted(out))
        for k in keys
    )
    return rows, dims


def test_api_embedders_and_chats_over_fake_clients(monkeypatch):
    calls = _fake_clients(monkeypatch)
    ref = _api_run(JAX)
    ref_calls = sorted(map(repr, calls))
    calls.clear()
    port_parse_graph.G.clear()
    got = _api_run(PORT)
    assert got == ref
    assert sorted(map(repr, calls)) == ref_calls
    rows, dims = got
    assert dims == {"openai": 3, "litellm": 2, "gemini": 2, "openai_dims": 3}
    # the messages column is Json in both packages: the fake echoes it
    assert ("c_openai", 'openai:"hello"') in rows[1]


def test_async_embedder_dimension_inside_a_running_loop(monkeypatch):
    """An async embedder's dimension probe works where an event loop is
    already running (the port runs the coroutine on a thread of its own)."""
    _fake_clients(monkeypatch)
    emb = PORT.emb.OpenAIEmbedder(model="m-emb")

    async def probe():
        return emb.get_embedding_dimension()

    assert asyncio.run(probe()) == 3


@pytest.mark.parametrize("name", ["OpenAIEmbedder", "LiteLLMEmbedder", "GeminiEmbedder"])
def test_api_embedder_without_its_client_raises_import_error(monkeypatch, name):
    import asyncio

    for mod in ("openai", "litellm", "google", "google.generativeai"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(ImportError):
        asyncio.run(getattr(temb_mod, name)()._embed("x"))


# --- REST clients over a fake requests.post -----------------------------------


def _client_calls(pkg, monkeypatch):
    import requests

    posted = []

    class _Resp:
        def __init__(self, url):
            self.url = url

        def raise_for_status(self):
            pass

        def json(self):
            return {"url": self.url}

    def fake_post(url, json, headers, timeout):
        posted.append((url, json, headers, timeout))
        return _Resp(url)

    monkeypatch.setattr(requests, "post", fake_post)
    vc = pkg.vs.VectorStoreClient(host="localhost", port=8000, additional_headers={"h": "1"})
    rc = pkg.qa.RAGClient(url="http://localhost:9000/")
    answers = [
        vc.query("q", k=2, metadata_filter="a == 'b'"),
        vc("q2"),
        vc.get_vectorstore_statistics(),
        vc.get_input_files(filepath_globpattern="*.md"),
        rc.answer("p", filters="x == 'y'", model="m"),
        rc.pw_ai_answer("p2"),
        rc.summarize(["a", "b"]),
        rc.retrieve("r", k=4),
        rc.statistics(),
        rc.list_documents(filters="f"),
    ]
    return posted, answers


def test_rest_clients_post_like_reference(monkeypatch):
    ref = _client_calls(JAX, monkeypatch)
    assert _client_calls(PORT, monkeypatch) == ref
    assert [p[0] for p in ref[0]][:4] == [
        "http://localhost:8000/v1/retrieve", "http://localhost:8000/v1/retrieve",
        "http://localhost:8000/v1/statistics", "http://localhost:8000/v1/inputs",
    ]


@pytest.mark.parametrize("hook", ["build_server", "run_server"])
def test_answerer_rest_hooks_raise(embedders, hook):
    """The answerer's REST hooks serve instead of raising: ``build_server``
    registers the reference's eight routes on one webserver, and
    ``run_server`` runs the graph that answers them over HTTP."""
    import http.client
    import json
    import socket
    import time

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    _j, temb = embedders
    qa = tqa.BaseRAGQuestionAnswerer(tllms.EchoChat(), _store(PORT, temb, ["a b c d e f"]))
    qa.build_server("127.0.0.1", port)
    assert set(qa.server._openapi["paths"]) == {
        "/v1/pw_ai_answer", "/v1/pw_ai_summary", "/v2/answer", "/v2/summarize",
        "/v1/retrieve", "/v2/list_documents", "/v1/statistics", "/v1/pw_list_documents",
    }
    if hook == "build_server":
        return
    thread = qa.run_server(threaded=True)
    try:
        for _ in range(300):
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
                conn.request("POST", "/v2/answer", body=json.dumps({"prompt": "a b c"}))
                resp = conn.getresponse()
                status, body = resp.status, json.loads(resp.read())
                conn.close()
                break
            except ConnectionRefusedError:
                time.sleep(0.05)
        assert status == 200 and "a b c" in body["response"]
    finally:
        port_parse_graph.G.runtime.stop()
        thread.join(timeout=15)
    assert not thread.is_alive()
