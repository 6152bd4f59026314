"""The port's own copy of ``pathway_tpu/xpacks/llm/rerankers.py``:
``rerank_topk_filter``, ``CrossEncoderReranker``, ``EncoderReranker``,
``LLMReranker`` and ``FlashRankReranker``.

``CrossEncoderReranker`` and ``EncoderReranker`` run the port's encoder
(``_encoder.py``) on ``device`` (default ``"cuda"``). The cross-encoder
keeps the reference's batched UDF path, so the pairs of one tick go through
one forward; its ``mesh=`` passes to the encoder (data-parallel batches).
``flashrank`` is imported only when ``FlashRankReranker`` scores."""

from __future__ import annotations

from typing import Any

import numpy as np

from pathway_tpu_torch.internals.common import apply_with_type
from pathway_tpu_torch.internals.expression import ColumnExpression
from pathway_tpu_torch.internals.udfs import UDF
from pathway_tpu_torch.xpacks.llm._encoder import EncoderRuntime
from pathway_tpu_torch.xpacks.llm._tokenizer import HashingTokenizer


def rerank_topk_filter(
    docs: ColumnExpression, scores: ColumnExpression, k: int = 5
) -> ColumnExpression:
    """Keep the k best docs by reranker score. Returns
    (docs_tuple, scores_tuple)."""

    def filt(docs_v, scores_v) -> tuple:
        pairs = sorted(
            zip(docs_v, scores_v), key=lambda p: -float(p[1])
        )[: int(k)]
        if not pairs:
            return ((), ())
        d, s = zip(*pairs)
        return (tuple(d), tuple(s))

    return apply_with_type(filt, tuple, docs, scores)


class CrossEncoderReranker(UDF):
    """Query/doc pair scoring with the port's cross-encoder on ``device``."""

    def __init__(
        self,
        model_name: str = "pathway-tpu/cross-encoder",
        *,
        dim: int = 256,
        depth: int = 4,
        heads: int = 4,
        max_len: int = 512,
        mesh: Any = None,
        device: str = "cuda",
        **kwargs,
    ):
        self.tokenizer = HashingTokenizer()
        self.runtime = EncoderRuntime(
            vocab_size=self.tokenizer.vocab_size,
            dim=dim,
            depth=depth,
            heads=heads,
            max_len=max_len,
            mesh=mesh,
            cross_encoder=True,
            device=device,
        )
        super().__init__(return_type=float, deterministic=True)
        self._prepare(self._score)
        self._batched = True
        self._fn = self._score_batch

    def _pair_text(self, doc: Any, query: str) -> str:
        if isinstance(doc, dict):
            doc = doc.get("text", str(doc))
        return f"{query} [SEP] {doc}"

    def _score_batch(self, docs: list, queries: list) -> list[float]:
        texts = [self._pair_text(d, q) for d, q in zip(docs, queries)]
        ids, mask = self.tokenizer.encode_batch(texts, self.runtime.max_len)
        out = self.runtime.forward_ids(ids, mask)
        return [float(x) for x in out]

    def _score(self, doc: Any, query: str, **kwargs) -> float:
        return self._score_batch([doc], [query])[0]

    @property
    def func(self):
        return self._score

    def __call__(self, doc: Any, query: Any, **kwargs) -> ColumnExpression:
        return super().__call__(doc, query, **kwargs)


class EncoderReranker(UDF):
    """Bi-encoder similarity reranker (``SentenceTransformerEmbedder``;
    ``device=`` and the width go through ``kwargs``)."""

    def __init__(self, model_name: str = "pathway-tpu/minilm-384", **kwargs):
        from pathway_tpu_torch.xpacks.llm.embedders import (
            SentenceTransformerEmbedder,
        )

        self.embedder = SentenceTransformerEmbedder(model=model_name, **kwargs)
        super().__init__(return_type=float, deterministic=True)
        self._prepare(self._score)

    def _score(self, doc: Any, query: str, **kwargs) -> float:
        if isinstance(doc, dict):
            doc = doc.get("text", str(doc))
        a = self.embedder.embed_batch([str(doc), str(query)])
        return float(np.dot(a[0], a[1]))

    @property
    def func(self):
        return self._score

    def __call__(self, doc: Any, query: Any, **kwargs) -> ColumnExpression:
        return super().__call__(doc, query, **kwargs)


class LLMReranker(UDF):
    """LLM-as-judge 1-5 relevance scoring."""

    def __init__(self, llm: Any, **kwargs):
        self.llm = llm
        super().__init__(return_type=float)
        self._prepare(self._score)

    def _score(self, doc: Any, query: str, **kwargs) -> float:
        from pathway_tpu_torch.xpacks.llm._utils import _coerce_sync

        prompt = (
            "Rate the relevance of the document to the query on a scale "
            f"1-5. Respond with a number only.\nQuery: {query}\nDoc: {doc}"
        )
        out = _coerce_sync(self.llm.func)(prompt)
        import json as _json
        import re

        try:
            parsed = _json.loads(str(out))
            if isinstance(parsed, dict) and "score" in parsed:
                return float(parsed["score"])
        except (ValueError, TypeError):
            pass
        m = re.search(r"\d+(\.\d+)?", str(out))
        if not m:
            raise ValueError(f"LLM reranker returned no number: {out!r}")
        return float(m.group())

    @property
    def func(self):
        return self._score

    def __call__(self, doc: Any, query: Any, **kwargs) -> ColumnExpression:
        return super().__call__(doc, query, **kwargs)


class FlashRankReranker(UDF):
    """Gated on ``flashrank``, imported when it scores."""

    def __init__(self, model: str = "ms-marco-TinyBERT-L-2-v2", **kwargs):
        super().__init__(return_type=float)
        self._prepare(self._score)

    def _score(self, doc: Any, query: str, **kwargs) -> float:
        try:
            from flashrank import Ranker  # type: ignore[import-not-found]
        except ImportError as exc:
            raise ImportError(
                "FlashRankReranker requires `flashrank`; "
                "CrossEncoderReranker runs on the card without extra deps"
            ) from exc
        raise NotImplementedError

    @property
    def func(self):
        return self._score
