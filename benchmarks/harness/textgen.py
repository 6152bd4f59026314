"""Seeded texts of published lengths.

Every word is a run of lowercase letters, so the hashing tokenizer makes
one token of it, and a text of w words is w + 1 tokens with the CLS id. A
stream's word counts are a fixed multiset, the quantiles of a lognormal
about the configured mean, the same for every seed: the seed only orders
them and picks the words. So two seeds do the same amount of work."""

from __future__ import annotations

import math
import statistics

import numpy as np

VOCAB_WORDS = 30000


def vocabulary() -> np.ndarray:
    """VOCAB_WORDS distinct four-letter words."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    i = np.arange(VOCAB_WORDS)
    digits = [(i // 26**p) % 26 for p in (3, 2, 1, 0)]
    return np.array(["".join(w) for w in zip(*(letters[d] for d in digits))])


def word_counts(n: int, mean: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """n quantiles of the lognormal with this mean and log-sigma, rounded
    and clipped to [lo, hi]."""
    mu = math.log(mean) - sigma * sigma / 2
    nd = statistics.NormalDist(mu, sigma)
    q = [math.exp(nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(q), lo, hi).astype(np.int64)


class TextStream:
    """An endless seeded stream of texts whose word counts cycle through
    permutations of one fixed multiset of ``pool`` counts."""

    def __init__(self, seed_seq: np.random.SeedSequence, lengths: dict, pool: int):
        self.rng = np.random.default_rng(seed_seq)
        self.counts = word_counts(pool, lengths["mean_words"], lengths["sigma"],
                                  lengths["min_words"], lengths["max_words"])
        self.words = vocabulary()
        self._order: list[int] = []

    def take(self, n: int) -> tuple[list[str], list[int]]:
        """The next n texts and their word counts."""
        texts, counts = [], []
        for _ in range(n):
            if not self._order:
                self._order = list(self.rng.permutation(self.counts))
            w = int(self._order.pop())
            texts.append(" ".join(self.words[self.rng.integers(0, VOCAB_WORDS, size=w)]))
            counts.append(w)
        return texts, counts


def seed_seq(seed: int, stream: int) -> np.random.SeedSequence:
    """An independent seed sequence per (run seed, stream)."""
    return np.random.SeedSequence([seed % (1 << 64), stream])
