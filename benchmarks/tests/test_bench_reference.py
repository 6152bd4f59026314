"""The reference against the port at a tiny size on the CPU: the frozen
tokenizer, the float32 encoder on the benchmark's weights, and whole runs
of both kinds of traffic judged correct."""

import sys
import time

import numpy as np
import pytest
import torch

from benchmarks.harness import cell as cellmod, drive, weights as weights_mod
from benchmarks.reference import encoder as ref_encoder, tokenizer as ref_tok
from benchmarks.tests import tiny


def test_frozen_tokenizer_equals_the_ports():
    from pathway_tpu_torch.xpacks.llm._tokenizer import HashingTokenizer

    port = HashingTokenizer()
    texts = ["hello world", "Mixed CASE words, with 12 digits and punctuation!", "", "a " * 300]
    for text in texts:
        assert ref_tok.encode(text, 30522, 256) == port.encode(text, 256)
        assert ref_tok.encode(text, 30522, 256, {}) == port.encode(text, 256)


def test_float32_reference_follows_the_ports_encoder_in_float32():
    sys.modules.setdefault("transformers", None)
    from pathway_tpu_torch.xpacks.llm import _encoder

    enc = tiny.ENCODER
    w = weights_mod.make(enc, 7, torch.device("cpu"))
    with drive.loaded_weights(_encoder):
        rt = _encoder.EncoderRuntime(dim=32, depth=1, heads=2, max_len=64, device="cpu")
    rt.model.load_state_dict(w)
    rt.model.dtype = torch.float32
    texts = ["alpha beta gamma", "delta " * 40, "one"]
    ids = [ref_tok.encode(t, 30522, 64) for t in texts]
    n = max(len(i) for i in ids)
    pad = np.zeros((3, 16 * -(-n // 16)), dtype=np.int64)
    mask = np.zeros(pad.shape, dtype=np.float32)
    for r, i in enumerate(ids):
        pad[r, : len(i)] = i
        mask[r, : len(i)] = 1
    got = rt.forward_ids(pad, mask)
    want = ref_encoder.encode(w, ids, 2, torch.device("cpu")).numpy()
    assert np.abs(got - want).max() < 1e-5


def test_weights_are_bfloat16_values_from_the_seed():
    a = weights_mod.make(tiny.ENCODER, 3, torch.device("cpu"))
    b = weights_mod.make(tiny.ENCODER, 3, torch.device("cpu"))
    c = weights_mod.make(tiny.ENCODER, 4, torch.device("cpu"))
    for name, t in a.items():
        assert torch.equal(t, b[name])
        assert torch.equal(t, t.to(torch.bfloat16).float())
    assert not torch.equal(a["blocks.0.fc1.weight"], c["blocks.0.fc1.weight"])


@pytest.mark.parametrize("make", [tiny.query_cell, tiny.ingest_cell], ids=["query", "ingest"])
def test_a_tiny_run_is_judged_correct(make):
    sys.modules.setdefault("transformers", None)
    out = cellmod.run_cell(make(), 2**31 + 17, 1.5, False, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
