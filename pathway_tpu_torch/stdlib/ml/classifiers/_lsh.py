"""LSH bucketers + the flattening ``lsh`` operator: the port's own copy of
``pathway_tpu/stdlib/ml/classifiers/_lsh.py`` (reference:
stdlib/ml/classifiers/_lsh.py). Bucketers hash vectors into L band
buckets (M ANDs per band) with numpy and ``hashlib`` on the host, so bucket
ids equal the JAX package's; ``lsh`` expands each row into its (band,
bucket) pairs as a table — the candidate-generation stage of the LSH KNN
and clustering pipelines. Nothing is left out."""

from __future__ import annotations

import hashlib
from typing import Callable

import numpy as np

from pathway_tpu_torch.internals.table import Table
from pathway_tpu_torch.internals.thisclass import this


def _fingerprint_i32(arr: np.ndarray) -> int:
    """Stable 32-bit fingerprint of an int vector (reference: fingerprints
    .fingerprint(format='i32'))."""
    h = hashlib.blake2b(
        np.ascontiguousarray(arr.astype(np.int64)).tobytes(), digest_size=4
    )
    return int.from_bytes(h.digest(), "little", signed=True)


def generate_euclidean_lsh_bucketer(
    d: int, M: int, L: int, A: float = 1.0, seed: int = 0
) -> Callable[[np.ndarray], np.ndarray]:
    """Euclidean LSH: M random projections per band, bucket width A,
    L bands (reference: _lsh.py:31)."""
    gen = np.random.default_rng(seed=seed)
    total = M * L
    lines = gen.standard_normal((d, total))
    lines = lines / np.linalg.norm(lines, axis=0)
    shift = gen.random(size=total) * A

    def bucketify(x: np.ndarray) -> np.ndarray:
        buckets = np.floor_divide(
            np.asarray(x, dtype=float) @ lines + shift, A
        ).astype(int)
        return np.array(
            [_fingerprint_i32(band) for band in np.split(buckets, L)]
        )

    return bucketify


def generate_cosine_lsh_bucketer(
    d: int, M: int, L: int, seed: int = 0
) -> Callable[[np.ndarray], np.ndarray]:
    """Cosine LSH: sign patterns over M random hyperplanes per band
    (reference: _lsh.py:58)."""
    gen = np.random.default_rng(seed=seed)
    planes = gen.standard_normal((d, M * L))

    def bucketify(x: np.ndarray) -> np.ndarray:
        signs = (np.asarray(x, dtype=float) @ planes > 0).astype(int)
        return np.array(
            [_fingerprint_i32(band) for band in np.split(signs, L)]
        )

    return bucketify


def lsh(
    data: Table,
    bucketer: Callable,
    origin_id: str = "origin_id",
    include_data: bool = True,
) -> Table:
    """Per-row LSH expansion: one output row per (band, bucket) of each
    input row, carrying the origin row's id (and optionally its vector)
    (reference: _lsh.py:82)."""
    from pathway_tpu_torch.internals.common import apply_with_type

    flat = data.select(
        **{origin_id: this.id},
        _pairs=apply_with_type(
            lambda x: tuple(
                (int(b), int(band)) for band, b in enumerate(bucketer(x))
            ),
            tuple,
            data.data,
        ),
    ).flatten(this._pairs)
    out = flat.select(
        flat[origin_id],
        bucketing=apply_with_type(lambda p: p[0], int, flat._pairs),
        band=apply_with_type(lambda p: p[1], int, flat._pairs),
    )
    if include_data:
        out = out.with_columns(data=data.ix(out[origin_id]).data)
    return out
