"""Carry parameters and state across from the JAX package to the port.

``flax_to_torch(params, module)`` loads a flax parameter tree (numpy arrays,
or anything ``np.asarray`` accepts, with or without the top-level
``"params"`` key) into a ``TransformerEncoder``, ``CrossEncoderHead`` or
``BertEncoder`` of this package, in place, and returns the module: trained or
converted weights cross over through it. (A seeded init needs no crossing:
``EncoderRuntime(seed=s)`` draws the JAX package's weights itself.)

Layout rules:

* flax ``Dense`` kernels are ``[in, out]``; ``Linear.weight`` is
  ``[out, in]``: transpose.
* flax ``MultiHeadDotProductAttention`` keeps ``query|key|value/kernel`` as
  ``[dim, heads, head_dim]`` (bias ``[heads, head_dim]``) and ``out/kernel``
  as ``[heads, head_dim, dim]``: flatten the head axes, then transpose.
* flax ``LayerNorm`` ``scale`` is ``weight``. Its default eps is 1e-6, which
  the port's modules already use (torch's default would be 1e-5).

The generation decoder is a plain parameter tree, not a module:
``decoder_params_to_torch(params, device)`` moves the numpy tree of
``init_params`` (either package's: they are the same numpy code) onto a
device with the same keys and layer list, and ``pools_to_torch(k_pool,
v_pool, device)`` carries K/V pools ``[L, n_pages, H, P, Dp]`` held by a JAX
scheduler across, so the port's ``decode_step`` continues the same sequences.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.xpacks.llm._bert import BertEncoder
from pathway_tpu_torch.xpacks.llm._encoder import CrossEncoderHead, TransformerEncoder


def _a(x: Any) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dense(p: dict) -> dict[str, np.ndarray]:
    return {"weight": _a(p["kernel"]).T, "bias": _a(p["bias"])}


def _ln(p: dict) -> dict[str, np.ndarray]:
    return {"weight": _a(p["scale"]), "bias": _a(p["bias"])}


def _mha(p: dict) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    for name in ("query", "key", "value"):
        k = _a(p[name]["kernel"])  # [dim, heads, head_dim]
        out[f"{name}.weight"] = k.reshape(k.shape[0], -1).T
        out[f"{name}.bias"] = _a(p[name]["bias"]).reshape(-1)
    k = _a(p["out"]["kernel"])  # [heads, head_dim, dim]
    out["out.weight"] = k.reshape(-1, k.shape[-1]).T
    out["out.bias"] = _a(p["out"]["bias"])
    return out


def _prefixed(prefix: str, d: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    return {f"{prefix}.{k}": v for k, v in d.items()}


def _encoder_state(p: dict, depth: int) -> dict[str, np.ndarray]:
    sd = {
        "tok_embed.weight": _a(p["Embed_0"]["embedding"]),
        "pos_embed.weight": _a(p["Embed_1"]["embedding"]),
        **_prefixed("ln_f", _ln(p[f"LayerNorm_{2 * depth}"])),
    }
    for i in range(depth):
        sd.update(_prefixed(f"blocks.{i}.ln1", _ln(p[f"LayerNorm_{2 * i}"])))
        sd.update(_prefixed(f"blocks.{i}.attn", _mha(p[f"MultiHeadDotProductAttention_{i}"])))
        sd.update(_prefixed(f"blocks.{i}.ln2", _ln(p[f"LayerNorm_{2 * i + 1}"])))
        sd.update(_prefixed(f"blocks.{i}.fc1", _dense(p[f"Dense_{2 * i}"])))
        sd.update(_prefixed(f"blocks.{i}.fc2", _dense(p[f"Dense_{2 * i + 1}"])))
    return sd


def _bert_state(p: dict, depth: int) -> dict[str, np.ndarray]:
    sd = {
        "word_embeddings.weight": _a(p["word_embeddings"]["embedding"]),
        "position_embeddings.weight": _a(p["position_embeddings"]["embedding"]),
        "token_type_embeddings.weight": _a(p["token_type_embeddings"]["embedding"]),
        **_prefixed("emb_ln", _ln(p["emb_ln"])),
    }
    for i in range(depth):
        lp = p[f"layer_{i}"]
        for name in ("query", "key", "value", "attn_out", "ffn_in", "ffn_out"):
            sd.update(_prefixed(f"layers.{i}.{name}", _dense(lp[name])))
        for name in ("attn_ln", "ffn_ln"):
            sd.update(_prefixed(f"layers.{i}.{name}", _ln(lp[name])))
    return sd


def flax_to_torch(params: dict, module: nn.Module) -> nn.Module:
    """Load the flax tree ``params`` into ``module`` (strict: every tensor
    must be present with its shape) and return ``module``."""
    tree = params.get("params", params)
    if isinstance(module, CrossEncoderHead):
        enc = module.encoder
        sd = _prefixed("encoder", _encoder_state(tree["encoder"], len(enc.blocks)))
        sd.update(_prefixed("head", _dense(tree["Dense_0"])))
    elif isinstance(module, TransformerEncoder):
        sd = _encoder_state(tree, len(module.blocks))
    elif isinstance(module, BertEncoder):
        sd = _bert_state(tree, len(module.layers))
    else:
        raise TypeError(f"no flax mapping for {type(module).__name__}")
    ref = module.state_dict()
    state = {}
    for k, v in sd.items():
        if k not in ref or tuple(ref[k].shape) != v.shape:
            got = None if k not in ref else tuple(ref[k].shape)
            raise ValueError(f"shape mismatch at {k}: flax {v.shape} vs module {got}")
        state[k] = torch.tensor(v)
    module.load_state_dict(state, strict=True)
    return module


def decoder_params_to_torch(params: dict, device: str | torch.device) -> dict:
    """The decoder's numpy parameter tree as f32 tensors on ``device``: the
    same keys, and ``"layers"`` the same list of per-layer dicts."""
    dev = resolve_device(device)

    def t(x: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    out = {k: t(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: t(v) for k, v in layer.items()} for layer in params["layers"]]
    return out


def pools_to_torch(
    k_pool: Any, v_pool: Any, device: str | torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """K/V pools ``[L, n_pages, H, P, Dp]`` (numpy, or anything
    ``np.asarray`` accepts) as contiguous f32 tensors on ``device``, byte
    for byte."""
    dev = resolve_device(device)
    pools = []
    for pool in (k_pool, v_pool):
        a = np.asarray(pool)
        if a.ndim != 5 or a.dtype != np.float32:
            raise ValueError(f"pools must be [L, n_pages, H, P, Dp] float32, got {a.shape} {a.dtype}")
        pools.append(torch.from_numpy(np.array(a, copy=True)).to(dev))
    if pools[0].shape != pools[1].shape:
        raise ValueError(f"k_pool {tuple(pools[0].shape)} and v_pool {tuple(pools[1].shape)} differ")
    return pools[0], pools[1]
