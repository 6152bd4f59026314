"""The JAX package's seeded encoder init, reproduced in numpy.

``EncoderRuntime(seed=s)`` in ``pathway_tpu`` draws its weights with
``model.init(jax.random.PRNGKey(s), ...)``. This module computes the same
parameter tree without JAX, so the port's ``EncoderRuntime(seed=s)`` gives
the JAX package's vectors and scores:

* keys: threefry-2x32 with 20 rounds. ``PRNGKey(s)`` is ``[0, s]``;
  ``fold_in(k, d)`` is ``threefry(k, [0, d])``; the bits of a shape are
  ``threefry(k, hi, lo)`` over the 64-bit row-major counter, the two words
  xor-ed (``jax_threefry_partitionable``, on by default since jax 0.5).
* flax derives each parameter's key from the root key by one ``fold_in``
  of the first 4 bytes (big-endian) of the SHA-1 of its scope path and the
  scope's call counter (``flax/core/scope.py`` ``_fold_in_static``); every
  random parameter here is the first one its scope draws, so the counter
  is 1.
* ``nn.Dense``/``DenseGeneral`` kernels are ``lecun_normal``: a normal
  truncated to (-2, 2), drawn as ``sqrt(2)*erfinv(u)`` with ``u`` uniform
  in ``[erf(-sqrt 2), erf(sqrt 2))``, times ``fan_in**-0.5 / .8796…``
  (``DenseGeneral`` draws its flattened ``[in, out]`` kernel).
  ``nn.Embed`` is ``normal * dim**-0.5``, ``u`` uniform in
  ``[nextafter(-1, 0), 1)``. Biases are 0, LayerNorm scales 1.

The uniforms are bit-exact. ``erfinv`` is the f32 polynomial XLA evaluates
(Giles' single-precision approximation), with its ``log1p`` taken in float64
and its fused multiply-adds emulated in float64, so about one weight in a
hundred differs from the JAX package's in its last bit or two
(``tests/test_torch_seeded_init.py`` holds every weight to a relative
1e-6).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter words ``x0, x1`` under
    ``key``; uint32 in, uint32 out."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**31."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return (0, seed)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    a, b = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return (int(a[0]), int(b[0]))


def random_bits(key: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    """32-bit ``jax.random.bits`` of ``shape`` (partitionable threefry)."""
    n = math.prod(shape)
    count = np.arange(n, dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = (count & _M32).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def _fma(a, b, c) -> np.ndarray:
    """f32 ``a*b + c`` rounded once, as XLA's fused multiply-add: the
    product of two f32 values is exact in float64."""
    return (
        np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)
    ).astype(np.float32)


def _uniform(key, shape, minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform`` in f32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled, then floored at ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


# Giles' single-precision erfinv, the polynomial XLA evaluates for f32
_ERFINV_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def _erfinv(x: np.ndarray) -> np.ndarray:
    """f32 erfinv for |x| < 1 (Horner steps fused)."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, np.float32(c_lt), np.float32(c_ge)))
    return p * x


_SQRT2 = np.float32(math.sqrt(2.0))


def _normal(key, shape) -> np.ndarray:
    u = _uniform(key, shape, float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)
    return _SQRT2 * _erfinv(u)


def _truncated_normal(key, shape) -> np.ndarray:
    lower, upper = np.float32(-2.0), np.float32(2.0)
    a = np.float32(math.erf(float(lower / _SQRT2)))
    b = np.float32(math.erf(float(upper / _SQRT2)))
    out = _SQRT2 * _erfinv(_uniform(key, shape, float(a), float(b)))
    return np.clip(
        out,
        np.nextafter(lower, np.float32(np.inf)),
        np.nextafter(upper, np.float32(-np.inf)),
    )


def _param_key(root: tuple[int, int], path: tuple[str, ...]) -> tuple[int, int]:
    """The key flax hands the first parameter of the scope at ``path``."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update((1).to_bytes(1, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def _lecun_normal(root, path, flat_shape, shape=None) -> np.ndarray:
    std = np.sqrt(np.float32(1.0 / flat_shape[0])) / np.float32(0.87962566103423978)
    w = _truncated_normal(_param_key(root, path), flat_shape) * std
    return w.astype(np.float32).reshape(shape or flat_shape)


def _embed(root, path, shape) -> np.ndarray:
    std = np.sqrt(np.float32(1.0 / shape[1]))
    return (_normal(_param_key(root, path), shape) * std).astype(np.float32)


def _dense(root, path, d_in, d_out) -> dict:
    return {
        "kernel": _lecun_normal(root, path, (d_in, d_out)),
        "bias": np.zeros(d_out, np.float32),
    }


def _layer_norm(dim) -> dict:
    return {"scale": np.ones(dim, np.float32), "bias": np.zeros(dim, np.float32)}


def encoder_params(
    root: tuple[int, int],
    prefix: tuple[str, ...],
    vocab_size: int,
    dim: int,
    depth: int,
    heads: int,
    mlp_ratio: int,
    max_len: int,
) -> dict:
    """The flax tree of ``TransformerEncoder`` under scope ``prefix``."""
    hd = dim // heads
    p: dict = {
        "Embed_0": {"embedding": _embed(root, prefix + ("Embed_0",), (vocab_size, dim))},
        "Embed_1": {"embedding": _embed(root, prefix + ("Embed_1",), (max_len, dim))},
        f"LayerNorm_{2 * depth}": _layer_norm(dim),
    }
    for i in range(depth):
        mha = prefix + (f"MultiHeadDotProductAttention_{i}",)
        attn = {
            name: {
                "kernel": _lecun_normal(root, mha + (name,), (dim, dim), (dim, heads, hd)),
                "bias": np.zeros((heads, hd), np.float32),
            }
            for name in ("query", "key", "value")
        }
        attn["out"] = {
            "kernel": _lecun_normal(root, mha + ("out",), (dim, dim), (heads, hd, dim)),
            "bias": np.zeros(dim, np.float32),
        }
        p[f"MultiHeadDotProductAttention_{i}"] = attn
        p[f"LayerNorm_{2 * i}"] = _layer_norm(dim)
        p[f"LayerNorm_{2 * i + 1}"] = _layer_norm(dim)
        p[f"Dense_{2 * i}"] = _dense(root, prefix + (f"Dense_{2 * i}",), dim, dim * mlp_ratio)
        p[f"Dense_{2 * i + 1}"] = _dense(
            root, prefix + (f"Dense_{2 * i + 1}",), dim * mlp_ratio, dim
        )
    return p


def init_params(
    seed: int,
    *,
    vocab_size: int,
    dim: int,
    depth: int,
    heads: int,
    mlp_ratio: int,
    max_len: int,
    cross_encoder: bool = False,
) -> dict:
    """``{"params": ...}`` as ``pathway_tpu``'s ``EncoderRuntime(seed=seed)``
    builds it for a ``TransformerEncoder`` (or a ``CrossEncoderHead`` over
    one, whose encoder scope is ``"encoder"``)."""
    root = prng_key(seed)
    shape = dict(
        vocab_size=vocab_size, dim=dim, depth=depth, heads=heads,
        mlp_ratio=mlp_ratio, max_len=max_len,
    )
    if not cross_encoder:
        return {"params": encoder_params(root, (), **shape)}
    return {
        "params": {
            "encoder": encoder_params(root, ("encoder",), **shape),
            "Dense_0": _dense(root, ("Dense_0",), dim, 1),
        }
    }
