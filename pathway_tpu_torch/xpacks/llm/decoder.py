"""Tiny bundled decoder for the generation serving plane — counterpart of
``pathway_tpu/xpacks/llm/decoder.py``.

A small pre-LN transformer with deterministic random-init parameters and a
byte-level tokenizer, so the repo runs generation without downloading
weights. ``init_params`` is the same numpy code as the JAX package's, so both
packages build bit-identical weights from one seed; ``convert.
decoder_params_to_torch`` moves that numpy tree onto a device.

``decode_step`` is embed -> N pre-LN blocks whose attention reads the paged KV
pools through :mod:`pathway_tpu_torch.ops.paged_attention` -> final norm ->
tied-embedding logits. It also WRITES the current token's K/V into the pools.
JAX writes them functionally into donated pools; here the write is in place
(``k_pool[li][page_ids, :, slots, :] = k``), so the pools the caller passes
in are the pools that come back. Prefill is decode: the prompt is fed token
by token through the same function.

The matmuls are plain ``torch.matmul`` (the JAX package leaves them to XLA);
the one hand-written kernel is paged attention, chosen by ``kernel``:
``"cuda"`` launches it on a CUDA tensor (its wrapper runs the plain version on
a CPU tensor), ``"ref"`` always runs the plain version.

Sampling is host-side numpy, copied as is: greedy at ``temperature == 0``,
else top-k softmax sampling with a per-(seed, step) PRNG.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.ops import paged_attention as pa

BOS = 256
EOS = 257
PAD = 258

KERNELS = ("ref", "cuda")


@dataclass(frozen=True)
class DecoderConfig:
    """Static decoder shape. ``head_dim_padded`` (the KV-pool lane width)
    pads ``head_dim`` up to a multiple of 128 lanes, the JAX package's pool
    layout; the padded tail is zero in q/k/v so the math is unchanged."""

    vocab_size: int = 259  # 256 bytes + BOS/EOS/PAD
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    head_dim: int = 32
    ffn_dim: int = 256
    max_len: int = 512
    page_size: int = 16

    @property
    def head_dim_padded(self) -> int:
        return pa.lane_pad(self.head_dim)

    @property
    def max_pages(self) -> int:
        return -(-self.max_len // self.page_size)


def init_params(cfg: DecoderConfig, seed: int = 0) -> dict:
    """Deterministic random-init parameter tree (numpy, f32): the same
    (cfg, seed) always builds bit-identical weights, in either package."""
    rng = np.random.default_rng(seed)

    def mat(*shape: int) -> np.ndarray:
        scale = 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    h = cfg.n_heads * cfg.head_dim
    params: dict = {
        "embed": mat(cfg.vocab_size, cfg.dim),
        "pos": (rng.standard_normal((cfg.max_len, cfg.dim)) * 0.02).astype(np.float32),
        "lnf_scale": np.ones(cfg.dim, np.float32),
        "lnf_bias": np.zeros(cfg.dim, np.float32),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append(
            {
                "ln1_scale": np.ones(cfg.dim, np.float32),
                "ln1_bias": np.zeros(cfg.dim, np.float32),
                "wq": mat(cfg.dim, h),
                "wk": mat(cfg.dim, h),
                "wv": mat(cfg.dim, h),
                "wo": mat(h, cfg.dim),
                "ln2_scale": np.ones(cfg.dim, np.float32),
                "ln2_bias": np.zeros(cfg.dim, np.float32),
                "w1": mat(cfg.dim, cfg.ffn_dim),
                "b1": np.zeros(cfg.ffn_dim, np.float32),
                "w2": mat(cfg.ffn_dim, cfg.dim),
                "b2": np.zeros(cfg.dim, np.float32),
            }
        )
    return params


def empty_pools(
    cfg: DecoderConfig, n_pages: int, device: str | torch.device = "cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed K/V page pools ``[n_layers, n_pages, H, P, Dp]`` f32. Page 0 is
    the null page: padded batch slots carry an all-zero page table, so their
    writes land there and never clobber a live sequence."""
    shape = (cfg.n_layers, n_pages, cfg.n_heads, cfg.page_size, cfg.head_dim_padded)
    dev = resolve_device(device)
    return (
        torch.zeros(shape, dtype=torch.float32, device=dev),
        torch.zeros(shape, dtype=torch.float32, device=dev),
    )


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + 1e-6) * scale + bias


@torch.no_grad()
def decode_step(
    params: dict,
    tokens: torch.Tensor,  # [B] int32 token being fed at `positions`
    positions: torch.Tensor,  # [B] int32 (0-based; 0 for padded slots)
    k_pool: torch.Tensor,  # [L, n_pages, H, P, Dp], written in place
    v_pool: torch.Tensor,  # written in place
    page_tables: torch.Tensor,  # [B, max_pages] int32 (all-zero for pads)
    seq_lens: torch.Tensor,  # [B] int32 valid tokens INCLUDING this one;
    #                           0 marks a padded batch slot
    *,
    cfg: DecoderConfig,
    kernel: str = "ref",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over the paged KV cache: write this token's K/V,
    attend over each sequence's cached prefix (ragged), and return
    ``(logits [B, vocab], k_pool, v_pool)`` (the same pool tensors)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown attention kernel {kernel!r}; expected one of {KERNELS}")
    attend = pa.paged_attention if kernel == "cuda" else pa.paged_attention_ref
    b = tokens.shape[0]
    hd, dp, p = cfg.head_dim, cfg.head_dim_padded, cfg.page_size
    scale = 1.0 / float(np.sqrt(hd))
    pos = positions.long()
    page_ids = torch.gather(page_tables, 1, (pos // p)[:, None])[:, 0].long()
    slots = pos % p
    x = params["embed"][tokens.long()] + params["pos"][pos]
    for li, layer in enumerate(params["layers"]):
        hnorm = _ln(x, layer["ln1_scale"], layer["ln1_bias"])

        def heads(y: torch.Tensor) -> torch.Tensor:
            y = y.reshape(b, cfg.n_heads, hd)
            return torch.nn.functional.pad(y, (0, dp - hd))

        q = heads(hnorm @ layer["wq"]) * scale
        k = heads(hnorm @ layer["wk"])
        v = heads(hnorm @ layer["wv"])
        # write this token's K/V into its page slot, in place (advanced
        # indices split by a slice index [B, H, Dp], matching k/v)
        k_pool[li][page_ids, :, slots, :] = k
        v_pool[li][page_ids, :, slots, :] = v
        att = attend(
            q.contiguous(), k_pool[li], v_pool[li], page_tables, seq_lens,
            sm_scale=1.0,  # q is pre-scaled
        )
        att = att[:, :, :hd].reshape(b, cfg.n_heads * hd)
        x = x + att @ layer["wo"]
        hnorm = _ln(x, layer["ln2_scale"], layer["ln2_bias"])
        ffn = torch.nn.functional.gelu(hnorm @ layer["w1"] + layer["b1"], approximate="tanh")
        x = x + (ffn @ layer["w2"] + layer["b2"])
    x = _ln(x, params["lnf_scale"], params["lnf_bias"])
    logits = x @ params["embed"].T
    return logits, k_pool, v_pool


def sample_token(
    logits: np.ndarray,  # [vocab] f32 host logits of ONE sequence
    *,
    temperature: float = 0.0,
    top_k: int = 40,
    seed: int = 0,
    step: int = 0,
) -> int:
    """Greedy at temperature 0, else top-k softmax sampling with a
    per-(seed, step) PRNG — a restored run re-draws the same tokens."""
    if temperature <= 0.0:
        return int(np.argmax(logits))
    top_k = max(int(top_k), 1)
    idx = np.argpartition(logits, -top_k)[-top_k:]
    z = logits[idx].astype(np.float64) / float(temperature)
    z -= z.max()
    probs = np.exp(z)
    probs /= probs.sum()
    # mask to a non-negative 63-bit stream id: client-supplied seeds
    # may be negative, and default_rng rejects negative ints
    stream = ((int(seed) << 20) ^ int(step)) & 0x7FFFFFFFFFFFFFFF
    rng = np.random.default_rng(stream)
    return int(rng.choice(idx, p=probs))


# --- byte tokenizer ---------------------------------------------------------


def encode_text(text: str) -> list[int]:
    """BOS + UTF-8 bytes (truncation is the caller's policy)."""
    return [BOS] + list(str(text).encode("utf-8", errors="replace"))


def decode_tokens(tokens: list[int]) -> str:
    return bytes(t for t in tokens if 0 <= t < 256).decode("utf-8", errors="replace")
