"""The port's own copy of ``pathway_tpu/xpacks/llm/splitters.py``
(``NullSplitter``, ``TokenCountSplitter``, ``RecursiveSplitter``).

Splitters are UDFs str -> list[tuple[str, dict]] (chunk, metadata).
``TokenCountSplitter`` counts regex tokens (whitespace-separated words and
newlines), as the reference does; it needs no tiktoken."""

from __future__ import annotations

import re

from pathway_tpu_torch.internals.udfs import UDF


class BaseSplitter(UDF):
    def __init__(self, **kwargs):
        super().__init__(return_type=list, **kwargs)
        self._prepare(self.split)

    def split(self, text: str, **kwargs) -> list[tuple[str, dict]]:
        raise NotImplementedError

    @property
    def func(self):
        return self.split


class NullSplitter(BaseSplitter):
    """No-op splitter."""

    def split(self, text: str, **kwargs) -> list[tuple[str, dict]]:
        return [(text, {})]


class TokenCountSplitter(BaseSplitter):
    """Split into chunks of [min_tokens, max_tokens] tokens, preferring
    sentence/punctuation boundaries."""

    def __init__(
        self,
        min_tokens: int = 50,
        max_tokens: int = 500,
        encoding_name: str = "cl100k_base",
        **kwargs,
    ):
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        self.encoding_name = encoding_name
        super().__init__(**kwargs)

    def _tokens(self, text: str) -> list[str]:
        return re.findall(r"\S+|\n", text)

    def split(self, text: str, **kwargs) -> list[tuple[str, dict]]:
        if not text:
            return []
        tokens = self._tokens(str(text))
        chunks: list[tuple[str, dict]] = []
        start = 0
        n = len(tokens)
        while start < n:
            end = min(start + self.max_tokens, n)
            # prefer to end at sentence punctuation past min_tokens
            best = end
            if end < n:
                for j in range(end - 1, start + self.min_tokens - 1, -1):
                    if re.search(r"[.!?]$", tokens[j]):
                        best = j + 1
                        break
            chunk = " ".join(t for t in tokens[start:best] if t != "\n")
            if chunk.strip():
                chunks.append((chunk, {}))
            start = best
        return chunks


class RecursiveSplitter(BaseSplitter):
    """Recursively split on separators until chunks fit (langchain-style)."""

    def __init__(
        self,
        chunk_size: int = 500,
        chunk_overlap: int = 0,
        separators: list[str] | None = None,
        encoding_name: str = "cl100k_base",
        model_name: str | None = None,
        **kwargs,
    ):
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = separators or ["\n\n", "\n", ". ", " "]
        super().__init__(**kwargs)

    def _size(self, text: str) -> int:
        return len(text.split())

    def _split_rec(self, text: str, seps: list[str]) -> list[str]:
        if self._size(text) <= self.chunk_size or not seps:
            return [text]
        sep, rest = seps[0], seps[1:]
        parts = text.split(sep)
        out: list[str] = []
        cur = ""
        for part in parts:
            candidate = (cur + sep + part) if cur else part
            if self._size(candidate) <= self.chunk_size:
                cur = candidate
            else:
                if cur:
                    out.append(cur)
                if self._size(part) > self.chunk_size:
                    out.extend(self._split_rec(part, rest))
                    cur = ""
                else:
                    cur = part
        if cur:
            out.append(cur)
        return out

    def split(self, text: str, **kwargs) -> list[tuple[str, dict]]:
        if not text:
            return []
        return [
            (c, {}) for c in self._split_rec(str(text), self.separators) if c.strip()
        ]
