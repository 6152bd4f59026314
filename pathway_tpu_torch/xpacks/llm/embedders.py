"""Local sentence embedder — counterpart of ``SentenceTransformerEmbedder``
in ``pathway_tpu/xpacks/llm/embedders.py``.

Same constructor arguments (less the mesh), tokenizer priority (HF tokenizer
when one is cached locally → WordPiece over a local vocab.txt → hashing) and
checkpoint fallback as the JAX class. It is a plain class here: the JAX
class is a pw ``UDF``, which needs the dataflow engine, not ported yet.
``embed_batch`` is the batched function the engine calls. Each device batch
records the JAX class's ``pathway_embed_batch_seconds``/``_docs_total``/
``_docs_per_sec_per_chip`` series and an ``embed.batch`` span; the batch
occupancy histogram (``serving/metrics.py``) is not ported yet.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Sequence

import numpy as np
import torch

from pathway_tpu_torch.observability import REGISTRY
from pathway_tpu_torch.observability.tracing import get_tracer
from pathway_tpu_torch.xpacks.llm._bert import _find_model_dir
from pathway_tpu_torch.xpacks.llm._encoder import EncoderRuntime
from pathway_tpu_torch.xpacks.llm._tokenizer import (
    HashingTokenizer,
    HFTokenizerAdapter,
    WordPieceTokenizer,
)


class SentenceTransformerEmbedder:
    """Local embedder on the card (reference name: pathway's
    SentenceTransformerEmbedder). Pass a model name or directory with a
    local checkpoint/tokenizer to use it; otherwise a seeded random-init
    encoder and the hashing tokenizer are used."""

    def __init__(
        self,
        model: str = "pathway-tpu/minilm-384",
        call_kwargs: dict | None = None,
        device: str | torch.device = "cuda",
        *,
        dim: int = 384,
        depth: int = 6,
        heads: int = 6,
        max_len: int = 512,
        batch_size: int = 1024,
    ):
        model_dir = _find_model_dir(model)
        model_path = None
        if model_dir is not None and os.path.exists(
            os.path.join(model_dir, "model.safetensors")
        ):
            model_path = model_dir
        self.tokenizer: Any = None
        for candidate in ([model_dir] if model_dir else []) + [model]:
            try:
                self.tokenizer = HFTokenizerAdapter(candidate)
                break
            except Exception:  # no transformers, or nothing cached locally
                pass
        vocab_txt = os.path.join(model_dir, "vocab.txt") if model_dir else None
        if self.tokenizer is None and vocab_txt and os.path.exists(vocab_txt):
            lowercase = True
            tok_cfg = os.path.join(model_dir, "tokenizer_config.json")
            if os.path.exists(tok_cfg):
                with open(tok_cfg) as f:
                    lowercase = bool(json.load(f).get("do_lower_case", True))
            self.tokenizer = WordPieceTokenizer(vocab_txt, lowercase=lowercase)
        if self.tokenizer is None:
            self.tokenizer = HashingTokenizer()
        if model_path is not None and isinstance(self.tokenizer, HashingTokenizer):
            # hash-bucket ids are unrelated to the checkpoint's vocabulary:
            # pretrained weights would emit noise, so use the random trunk
            logging.getLogger("pathway_tpu_torch").warning(
                "checkpoint %s has weights but no usable tokenizer "
                "(vocab.txt missing); falling back to the random-init encoder",
                model,
            )
            model_path = None
        self.runtime = EncoderRuntime(
            vocab_size=self.tokenizer.vocab_size,
            dim=dim,
            depth=depth,
            heads=heads,
            max_len=max_len,
            model_path=model_path,
            device=device,
        )
        self.model = model
        self.kwargs = call_kwargs or {}
        self.batch_size = batch_size
        # embed batch latency + the docs/sec/chip figure, measured where the
        # work happens (one card per embedder in the port)
        self._m_batch_seconds = REGISTRY.histogram(
            "pathway_embed_batch_seconds",
            "embedder batch latency (tokenize + device forward)",
            labelnames=("model",),
        ).labels(model)
        self._m_docs = REGISTRY.counter(
            "pathway_embed_docs_total",
            "documents embedded",
            labelnames=("model",),
        ).labels(model)
        self._m_rate = REGISTRY.gauge(
            "pathway_embed_docs_per_sec_per_chip",
            "throughput of the most recent embed batch, per local device",
            labelnames=("model",),
        ).labels(model)

    def embed_batch(self, texts: Sequence[str]) -> list[np.ndarray]:
        """Embed ``texts`` in chunks of at most ``batch_size``; one f32
        vector per text."""
        out: list[np.ndarray] = []
        for i in range(0, len(texts), self.batch_size):
            chunk = [str(t) for t in texts[i : i + self.batch_size]]
            with get_tracer().span("embed.batch", model=self.model, docs=len(chunk)) as sp:
                t0 = time.perf_counter()
                # runtime.max_len is clamped to a checkpoint's position table
                ids, mask = self.tokenizer.encode_batch(chunk, self.runtime.max_len)
                vecs = self.runtime.forward_ids(ids, mask)
                dt = time.perf_counter() - t0
            self._m_batch_seconds.observe(dt, exemplar=sp.trace_id)
            self._m_docs.inc(len(chunk))
            if dt > 0:
                self._m_rate.set(len(chunk) / dt)
            out.extend(vecs[j] for j in range(len(chunk)))
        return out

    def _single(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    @property
    def func(self):
        return self._single

    def get_embedding_dimension(self, **kwargs) -> int:
        return self.runtime.dim
