"""The sentence encoder's forward pass in plain PyTorch.

The block is the one the configurations run (their ``assumed`` says so):
pre-LayerNorm with eps 1e-6, multi-head self-attention scaled by
``head_dim ** -0.5`` over the real tokens, a tanh-approximated GELU
feed-forward, a final LayerNorm, the mean over real tokens and L2
normalisation. Weights are a dict of tensors named as PyTorch names the
layers (``blocks.<i>.attn.query.weight`` is [out, in]).

``precision="float32"`` is the reference: every product in float32 with
TF32 off. ``precision="fp8"`` is the control: each matrix product's two
operands rounded to float8 e4m3 with one scale per tensor, the rest as the
reference.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _linear(x, w, b, precision: str):
    if precision == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    return F.linear(x, w, b)


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, 1e-6)


def forward(weights: dict, ids: torch.Tensor, mask: torch.Tensor, heads: int,
            precision: str = "float32") -> torch.Tensor:
    """[B, L] token ids and 0/1 mask -> [B, D] unit vectors (float32)."""
    w = weights
    b, length = ids.shape
    x = w["tok_embed.weight"][ids] + w["pos_embed.weight"][:length][None]
    d = x.shape[-1]
    hd = d // heads
    key_mask = torch.where(mask[:, None, None, :] > 0, 0.0, -math.inf)
    n_layers = 1 + max(int(k.split(".")[1]) for k in w if k.startswith("blocks."))
    for i in range(n_layers):
        p = f"blocks.{i}."
        h = _ln(x, w[p + "ln1.weight"], w[p + "ln1.bias"])

        def heads_of(name):
            y = _linear(h, w[p + f"attn.{name}.weight"], w[p + f"attn.{name}.bias"], precision)
            return y.view(b, length, heads, hd).transpose(1, 2)

        q, k, v = heads_of("query"), heads_of("key"), heads_of("value")
        if precision == "fp8":
            q, k = fp8_round(q), fp8_round(k)
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd) + key_mask, dim=-1)
        if precision == "fp8":
            att, v = fp8_round(att), fp8_round(v)
        ctx = (att @ v).transpose(1, 2).reshape(b, length, d)
        x = x + _linear(ctx, w[p + "attn.out.weight"], w[p + "attn.out.bias"], precision)
        h = _ln(x, w[p + "ln2.weight"], w[p + "ln2.bias"])
        h = F.gelu(_linear(h, w[p + "fc1.weight"], w[p + "fc1.bias"], precision), approximate="tanh")
        x = x + _linear(h, w[p + "fc2.weight"], w[p + "fc2.bias"], precision)
    x = _ln(x, w["ln_f.weight"], w["ln_f.bias"])
    pooled = (x * mask[:, :, None]).sum(dim=1) / mask.sum(dim=1, keepdim=True)
    return pooled / pooled.norm(dim=-1, keepdim=True)


def encode(weights: dict, token_ids: list[list[int]], heads: int, device,
           precision: str = "float32", tokens_per_block: int = 1 << 18) -> torch.Tensor:
    """Encode sequences of token ids, shortest first, in blocks padded to
    their longest and holding at most ``tokens_per_block`` padded tokens;
    rows come back in the order given."""
    blocks, cur = [], []
    for i in sorted(range(len(token_ids)), key=lambda i: len(token_ids[i])):
        if cur and (len(cur) + 1) * len(token_ids[i]) > tokens_per_block:
            blocks.append(cur)
            cur = []
        cur.append(i)
    if cur:
        blocks.append(cur)
    d = weights["tok_embed.weight"].shape[1]
    out = torch.empty(len(token_ids), d, dtype=torch.float32, device=device)
    with no_tf32(), torch.no_grad():
        for rows in blocks:
            length = len(token_ids[rows[-1]])
            ids = torch.zeros(len(rows), length, dtype=torch.long)
            mask = torch.zeros(len(rows), length, dtype=torch.float32)
            for j, i in enumerate(rows):
                ids[j, : len(token_ids[i])] = torch.tensor(token_ids[i])
                mask[j, : len(token_ids[i])] = 1.0
            vecs = forward(weights, ids.to(device), mask.to(device), heads, precision)
            out[torch.tensor(rows, device=device)] = vecs
    return out
