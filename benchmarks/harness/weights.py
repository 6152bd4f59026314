"""The encoder's weights, made from the seed on the device.

BERT's initializer (normal, std 0.02) for the embedding tables, the
matrices and the biases; LayerNorm gains 1 + 0.02 x normal and biases
0.02 x normal, so that every parameter is exercised. One draw of the whole
parameter count on a device generator, rounded to bfloat16, the
configuration's weight type; the values are then exact in float32, which
is how the port keeps them and how the reference reads them."""

from __future__ import annotations

import torch

STD = 0.02


def shapes(enc: dict) -> dict[str, tuple[int, ...]]:
    d, f = enc["hidden_size"], enc["intermediate_size"]
    out = {"tok_embed.weight": (enc["vocab_size"], d),
           "pos_embed.weight": (enc["max_seq_length"], d)}
    for i in range(enc["num_hidden_layers"]):
        p = f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            out[p + ln + ".weight"] = (d,)
            out[p + ln + ".bias"] = (d,)
        for name in ("query", "key", "value", "out"):
            out[p + f"attn.{name}.weight"] = (d, d)
            out[p + f"attn.{name}.bias"] = (d,)
        out[p + "fc1.weight"] = (f, d)
        out[p + "fc1.bias"] = (f,)
        out[p + "fc2.weight"] = (d, f)
        out[p + "fc2.bias"] = (d,)
    out["ln_f.weight"] = (d,)
    out["ln_f.bias"] = (d,)
    return out


def make(enc: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor holding bfloat16 values} on ``device``."""
    shp = shapes(enc)
    total = sum(torch.Size(s).numel() for s in shp.values())
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device) * STD
    out, at = {}, 0
    for name, s in shp.items():
        n = torch.Size(s).numel()
        w = flat[at:at + n].view(s)
        if name.endswith("weight") and len(s) == 1:  # a LayerNorm gain
            w = w + 1.0
        out[name] = w.to(torch.bfloat16).float()
        at += n
    return out
