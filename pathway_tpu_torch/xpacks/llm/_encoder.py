"""Sentence encoder on PyTorch — counterpart of
``pathway_tpu/xpacks/llm/_encoder.py`` (``TransformerEncoder``,
``CrossEncoderHead``, ``_bucket_batch``, ``EncoderRuntime``).

The arithmetic follows the flax modules step for step: pre-LN blocks with
LayerNorm eps 1e-6 (statistics in f32), the tanh approximation of GELU, the
query scaled by ``head_dim**-0.5`` and masked positions filled with
``finfo(dtype).min`` (not -inf: a padded query row of a real sequence then
gets a uniform softmax instead of NaN, and the masked mean pool stays
finite), masked mean pooling in f32 and L2 normalisation. As with flax
``dtype=bf16``, parameters are kept in f32 and cast to the compute dtype
where they are used (bf16 by default).

Weights: ``EncoderRuntime(seed=s)`` loads the JAX package's seeded init,
reproduced in numpy by ``_flax_init.py`` (threefry keys, flax's per-scope
key derivation and initializers), so both packages give the same vectors
and scores for the same seed. Attention is plain tensor ops:
the JAX encoder has no Pallas kernel.

``EncoderRuntime(mesh=, axis=)`` runs data-parallel batches, as the
reference's does: the parameters are replicated once per distinct device
of the mesh (not once per shard), the batch bucket is padded up to a
multiple of the shard count, each shard runs its slice of the batch on its
device, and the outputs are concatenated in shard order.
"""

from __future__ import annotations

import copy
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.xpacks.llm import _flax_init


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with f32 statistics and affine, cast to ``dtype`` (flax)."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y.to(dtype)


def _pool(x: torch.Tensor, mask: torch.Tensor, floor: float) -> torch.Tensor:
    """Masked mean over tokens (f32), then L2 normalisation."""
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=floor)
    pooled = (x.float() * mask[:, :, None]).sum(dim=1) / denom
    return pooled / (torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) + 1e-12)


class _SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no dropout)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype):
        b, l, d = x.shape
        hd = d // self.heads

        def split(lin):
            return _linear(x, lin, dtype).view(b, l, self.heads, hd)

        q = split(self.query) / torch.tensor(math.sqrt(hd), dtype=dtype)
        k, v = split(self.key), split(self.value)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = w.masked_fill(~mask, torch.finfo(dtype).min)
        w = torch.softmax(w, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, l, d)
        return _linear(ctx, self.out, dtype)


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _SelfAttention(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x, mask, dtype):
        x = x + self.attn(_layer_norm(x, self.ln1, dtype), mask, dtype)
        h = _linear(_layer_norm(x, self.ln2, dtype), self.fc1, dtype)
        h = F.gelu(h, approximate="tanh")
        return x + _linear(h, self.fc2, dtype)


class TransformerEncoder(nn.Module):
    def __init__(
        self,
        vocab_size: int = 30522,
        dim: int = 384,
        depth: int = 6,
        heads: int = 6,
        mlp_ratio: int = 4,
        max_len: int = 512,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.dim, self.max_len, self.dtype = dim, max_len, dtype
        self.tok_embed = nn.Embedding(vocab_size, dim)
        self.pos_embed = nn.Embedding(max_len, dim)
        self.blocks = nn.ModuleList(_Block(dim, heads, mlp_ratio) for _ in range(depth))
        self.ln_f = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        pos = torch.arange(ids.shape[1], device=ids.device)
        x = F.embedding(ids, self.tok_embed.weight).to(dt)
        x = x + F.embedding(pos, self.pos_embed.weight).to(dt)[None]
        attn_mask = (mask[:, None, None, :] * mask[:, None, :, None]).bool()
        for blk in self.blocks:
            x = blk(x, attn_mask, dt)
        x = _layer_norm(x, self.ln_f, dt)
        return _pool(x, mask, 1.0)


class CrossEncoderHead(nn.Module):
    """Encoder + scalar relevance head (query/doc pair scoring)."""

    def __init__(self, encoder: TransformerEncoder):
        super().__init__()
        self.encoder = encoder
        self.head = nn.Linear(encoder.dim, 1)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        emb = self.encoder(ids, mask)
        return F.linear(emb, self.head.weight, self.head.bias)[:, 0]


def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Load the JAX package's seeded init into ``module`` (a
    ``TransformerEncoder`` or a ``CrossEncoderHead``): the flax tree that
    ``model.init(jax.random.PRNGKey(seed), ...)`` draws, computed in numpy
    (``_flax_init.py``), so the weights are the same on every device and in
    both packages."""
    from pathway_tpu_torch.convert import flax_to_torch

    cross = isinstance(module, CrossEncoderHead)
    enc = module.encoder if cross else module
    blk = enc.blocks[0]
    params = _seeded_tree(
        seed,
        enc.tok_embed.num_embeddings,
        enc.dim,
        len(enc.blocks),
        blk.attn.heads,
        blk.fc1.out_features // enc.dim,
        enc.max_len,
        cross,
    )
    return flax_to_torch(params, module)


@functools.lru_cache(maxsize=1)
def _seeded_tree(seed, vocab_size, dim, depth, heads, mlp_ratio, max_len, cross) -> dict:
    """The seeded flax tree of the last shape asked for, drawn once: a
    process that builds several encoders of one shape and seed (an
    embedder per pipeline, a mesh runtime beside a plain one) pays the
    numpy draw once. ``flax_to_torch`` copies out of it; nothing writes to
    it."""
    return _flax_init.init_params(
        seed, vocab_size=vocab_size, dim=dim, depth=depth, heads=heads,
        mlp_ratio=mlp_ratio, max_len=max_len, cross_encoder=cross,
    )


def _bucket_batch(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


class EncoderRuntime:
    """Owns the model on its device; pads batches to power-of-two buckets
    (at least 8 rows) as the JAX runtime does for its jit cache."""

    def __init__(
        self,
        vocab_size: int = 30522,
        dim: int = 384,
        depth: int = 6,
        heads: int = 6,
        max_len: int = 512,
        seed: int = 0,
        mesh: Any = None,
        axis: str = "data",
        cross_encoder: bool = False,
        model_path: str | None = None,
        param_dtype: torch.dtype | None = None,
        device: str | torch.device = "cuda",
    ):
        self.mesh = mesh
        self.axis = axis
        # with a mesh the model lives on the mesh's devices
        self.device = mesh.device_of(0, axis) if mesh is not None else resolve_device(device)
        self.max_len = max_len
        self.pretrained = False
        if model_path is not None and not cross_encoder:
            # pretrained BERT/MiniLM checkpoint (_bert.py) replaces the
            # random-init trunk; it computes in param_dtype (default f32)
            from pathway_tpu_torch.xpacks.llm._bert import load_bert_checkpoint

            self.model = load_bert_checkpoint(
                model_path,
                dtype=param_dtype if param_dtype is not None else torch.float32,
                device=self.device,
            )
            self.dim = self.model.dim
            self.max_len = min(max_len, self.model.max_len)
            self.pretrained = True
        else:
            enc = TransformerEncoder(
                vocab_size=vocab_size,
                dim=dim,
                depth=depth,
                heads=heads,
                max_len=max_len,
            )
            model = CrossEncoderHead(enc) if cross_encoder else enc
            self.model = init_weights(model, seed).to(self.device)
            self.dim = dim
        self.model.eval()
        # the model once per distinct device of the mesh's shards
        self._replicas = {self.device: self.model}
        if mesh is not None:
            for dev in mesh.shard_devices(axis):
                if dev not in self._replicas:
                    self._replicas[dev] = copy.deepcopy(self.model).to(dev)

    def forward_ids(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        n = ids.shape[0]
        bucket = _bucket_batch(n)
        if self.mesh is not None:
            n_dev = self.mesh.shape[self.axis]
            bucket = max(bucket, n_dev)
            bucket = ((bucket + n_dev - 1) // n_dev) * n_dev
        if bucket != n:
            ids = np.pad(ids, ((0, bucket - n), (0, 0)))
            mask = np.pad(mask, ((0, bucket - n), (0, 0)))
        ids_h = torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int64))
        mask_h = torch.from_numpy(np.ascontiguousarray(mask, dtype=np.float32))
        if self.mesh is None:
            with torch.inference_mode():
                out = self.model(ids_h.to(self.device), mask_h.to(self.device))
            return out.float().cpu().numpy()[:n]
        devices = self.mesh.shard_devices(self.axis)
        per = bucket // len(devices)
        outs = []
        with torch.inference_mode():
            for s, dev in enumerate(devices):
                rows = slice(s * per, (s + 1) * per)
                outs.append(self._replicas[dev](ids_h[rows].to(dev), mask_h[rows].to(dev)))
        return torch.cat([o.float().cpu() for o in outs]).numpy()[:n]
