#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pathway_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a, one process per
source, all started together), then runs six phases, printing one JSON
object per phase:

1. device         — nvidia-smi name/power limit, toolchain versions, build seconds.
2. kernel parity  — every kernel against its plain PyTorch version on the card.
                    block_topk: B in {1, 16, 64}, D = 384, N = 1024 * {1, 64, 1024},
                    k in {1, 10, 40, 1024}, f32 and bf16 corpora with exact ties,
                    invalid rows and fully invalid blocks; then random unit
                    vectors at the path shapes (B = 1 and 16 with k = 10, B = 32
                    with k = 3). paged_attention: B in
                    {1, 8, 64} x H in {1, 4, 32} x P in {8, 16} x Dp in {128, 256},
                    256 pages per table (contexts up to 4096 tokens) drawn from a
                    1025-page pool, ragged seq_lens with 0, P, P+1, full and < 0.
3. main path      — the live-RAG retrieval path at full default width:
                    SentenceTransformerEmbedder (vocab 30522, dim 384, depth 6,
                    heads 6, max_len 512, bf16, seeded init) embeds 4096 seeded
                    documents; TpuDenseKnnIndex(cosine, reserved 1<<20) holds them
                    beside ~1M seeded unit vectors; 64 query texts are answered in
                    batches of 1 and 16 (k = 10) plus one filtered batch. The
                    results are checked against kernel="torch" on the same index.
4. generation     — ask -> retrieve -> generate: 24 asks are embedded and
                    retrieved (k = 3) on the phase-3 index, each grounded prompt
                    goes to one DecodeScheduler(GenerateConfig()) at the decoder's
                    serving defaults (dim 128, 2 layers, 4 heads, head_dim 32,
                    64 pages of 16, max_batch 8, 32 new tokens; half greedy, half
                    temperature 0.7 / top_k 40), whose every step runs the
                    paged-attention kernel. Checked: every answer, the page pool
                    back to empty, launches == decode steps x layers, the same
                    tokens from a kernel="ref" scheduler, and the logits of one
                    recorded step, kernel against plain.
5. durability     — the same 24 prompts at the same width, with snapshots.
                    A child process (this script with --kill-child) runs them
                    with PATHWAY_GENERATE_SNAPSHOT_EVERY=8, a store in a temp
                    dir and PATHWAY_FAULTS="kill=decode:150"; it must exit 23
                    after step 150 leaving a manifest. A scheduler restores
                    the store (pages bit-equal to the ledger, every sequence
                    completes with the generation phase's tokens, pool back to
                    empty, launches == steps x layers); split_kv_store splits
                    it across two stores whose schedulers resume every
                    sequence exactly once; then one run with the hooks and no
                    snapshots (step p50, tokens/s, the exposition, spans,
                    memory ledger and roofline checked against the run's own
                    counts) and one with a snapshot every 8 steps and one from
                    this thread mid-run (mirror and snapshot ms, bytes and
                    segments per snapshot). Tokens are compared exactly; a
                    difference passes only at a near tie: the uninterrupted
                    run's top-2 logit margin there below GEN_LOGIT_TOL.
6. kernels        — per kernel and per path shape: launches on its path, ms
                    (CUDA events) and device ms (torch.profiler), its plain
                    version's ms, the bound and what sets it, the bytes it must
                    move, and the ms of the library call(s) computing the same
                    function (the yardstick). block_topk: B = 1 and B = 16
                    (k = 10, retrieval), B = 16 with k = 40 (the filtered
                    batch, oversampled x4) and B = 32 (k = 3, the generation
                    phase's 24 asks padded to 32); paged_attention: the
                    recorded decode step and a long context, each with its
                    split count S.

Then, on lines of their own, the kernels table, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no result. It needs one CUDA device and refuses to run
without one.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

SEED = 0
DIM = 384
N_DOCS = 4096
EMBED_BATCH = 256
CORPUS_ROWS = 1 << 20
N_QUERIES = 64
K = 10
KEY_BASE = 10_000_000  # keys of the synthetic unit vectors, disjoint from docs
# kernel vs plain on random unit vectors, |score| <= 1: the D products are
# summed in another order. bf16 inputs are multiplied exactly in f32, so the
# same f32 sum-order tolerance holds for bf16 corpora.
F32_TOL = 1e-5
BF16_TOL = 1e-5
# paged attention, kernel vs plain, absolute: outputs are softmax-weighted
# means of N(0, 1) values; the kernel sums scores and up to 4096 weighted
# rows in another order (per-warp online softmax, merged at the end) than the
# plain version's batched products, so the f32 rounding grows with context
PA_TOL = 1e-5
PA_POOL_PAGES = 1025
PA_MAX_PAGES = 256
# decode-step logits, kernel vs plain attention: the attention differences
# above, carried through 2 layers and the tied-embedding head
GEN_LOGIT_TOL = 1e-4
N_ASKS = 24
RETRIEVE_K = 3
RECORD_STEP = 150  # the decode step whose inputs the phase records
KILL_STEP = 150  # the durability child dies after this decode step
SNAPSHOT_EVERY = 8
FAULT_EXIT = 23  # the fault plan's exit code
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # dense, H100 SXM


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def memory_rate() -> tuple[float, str]:
    """Bytes/s of device memory: HBM at clocks.max.memory (MHz), double data
    rate, 5120-bit bus (every H100 variant; 3.35e12 on an H100 SXM)."""
    mhz = float(nvidia_smi("clocks.max.memory").split()[0])
    return mhz * 1e6 * 2 * 5120 / 8, f"nvidia-smi clocks.max.memory {mhz:g} MHz x 5120-bit DDR"


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel from nvcc -Xptxas -v: its name and
    template arguments as mangled, registers, static shared memory, spills."""
    lines, name, spills = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(block_topk_kernel|paged_decode_kernel)I(\w+?)E+v", ln)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
        elif "spill" in ln:
            spills = ln.strip()
        elif "registers" in ln and name:
            lines.append(f"{name}: {ln.split('Used', 1)[1].strip()}; {spills}")
    return lines


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, reps: int = 20) -> dict[str, tuple[int, float]] | None:
    """Run ``fn`` ``reps`` times under torch.profiler: {device kernel or
    copy name: (launches, device ms in all)}, or None when the trace shows
    no device time (the times are a measurement only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {
        e.key: (e.count, e.self_device_time_total / 1e3)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    }
    return out if sum(ms for _n, ms in out.values()) > 0 else None


def kernel_device_ms(times: dict | None, name: str, reps: int) -> float | None:
    """Device ms per call of the kernels whose name contains ``name``."""
    if times is None:
        return None
    return sum(ms for key, (_n, ms) in times.items() if name in key) / reps


# --- phase 2: kernel parity --------------------------------------------------


def grid_corpus(n: int, d: int, dtype: torch.dtype, gen: torch.Generator, dev):
    """Small-integer vectors: every product and sum is exact in f32, so the
    kernel and the plain version must agree bit for bit and ties are exact.
    Duplicated rows, a run of identical rows, ~10% invalid rows and, for
    N >= 64K, two fully invalid 1024-row blocks."""
    c = torch.randint(-3, 4, (n, d), generator=gen, device=dev).to(dtype)
    src = torch.randint(0, n, (n // 4,), generator=gen, device=dev)
    dst = torch.randint(0, n, (n // 4,), generator=gen, device=dev)
    c[dst] = c[src]
    c[: min(n, 512)] = c[0]
    valid = torch.rand(n, generator=gen, device=dev) > 0.1
    if n >= 64 * 1024:
        valid[1024:2048] = False
        valid[5 * 1024 : 6 * 1024] = False
    return c.contiguous(), valid


def kernel_parity(dev) -> dict:
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.knn import dense_topk_prepared

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = 0
    for n in (1024, 64 * 1024, 1024 * 1024):
        for dtype in (torch.float32, torch.bfloat16):
            c, valid = grid_corpus(n, DIM, dtype, gen, dev)
            for b in (1, 16, 64):
                q = torch.randint(-3, 4, (b, DIM), generator=gen, device=dev).to(dtype)
                q[0] = c[0]  # a query equal to the long run of identical rows
                for k in (1, 10, 40, 1024):
                    sc, ix = bt.block_topk(q, c, valid, k)
                    sr, ir = bt.block_topk_ref(q, c, valid, k)
                    torch.cuda.synchronize()
                    what = f"N={n} B={b} k={k} {dtype}"
                    check(torch.equal(ix, ir), f"block indices differ at {what}")
                    check(torch.equal(sc, sr), f"block scores differ at {what}")
                    s2, i2 = bt.dense_topk_kernel(q.float(), c, valid, k)
                    s3, i3 = dense_topk_prepared(
                        q.float(), c, None, valid, k, metric="dot", bf16=dtype == torch.bfloat16
                    )
                    check(torch.equal(i2, i3.to(i2.dtype)), f"merged indices differ at {what}")
                    check(torch.equal(s2, s3), f"merged scores differ at {what}")
                    cases += 1
            del c, valid
    # random unit vectors at the main-path shape: sums are not exact, so the
    # scores agree within F32_TOL and an index may differ only at a near-tie
    exact = 0
    total = 0
    max_err = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).split(".")[-1]
        max_err[name] = 0.0
        c = torch.randn(CORPUS_ROWS, DIM, generator=gen, device=dev)
        c = (c / c.norm(dim=-1, keepdim=True)).to(dtype)
        valid = torch.rand(CORPUS_ROWS, generator=gen, device=dev) > 0.01
        for b, k in ((1, K), (16, K), (32, RETRIEVE_K)):
            q = torch.randn(b, DIM, generator=gen, device=dev)
            q = (q / q.norm(dim=-1, keepdim=True)).to(dtype)
            sc, ix = bt.block_topk(q, c, valid, k)
            sr, ir = bt.block_topk_ref(q, c, valid, k)
            err = float((sc - sr).abs().max())
            max_err[name] = max(max_err[name], err)
            check(err <= tol, f"random scores differ by {err} ({name}, B={b})")
            full = torch.where(valid[None, :], q.float() @ c.float().T, -float("inf"))
            got = torch.gather(full, 1, ix.reshape(b, -1).long()).reshape(ix.shape)
            check(bool(((got - sr).abs() <= tol).all()), f"kernel picked a wrong row ({name})")
            exact += int((ix == ir).sum())
            total += ix.numel()
        del c, valid
    return {
        "phase": "kernel parity",
        "grid_cases": cases,
        "grid_check": "indices and scores bit-equal, kernel vs block_topk_ref and merged vs dense_topk_prepared",
        "random_max_abs_err": max_err,
        "random_tol": {"float32": F32_TOL, "bfloat16": BF16_TOL},
        "random_index_equal_fraction": exact / total,
        "paged_attention": paged_parity(dev),
    }


def paged_parity(dev) -> dict:
    """The paged-attention kernel against paged_attention_ref over the grid
    B x H x P x Dp, 256-page tables over a 1025-page pool, random values
    in every lane (pad lanes included) and ragged lengths with the edges."""
    from pathway_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases, max_err, zero_rows = 0, 0.0, 0
    for dp in (128, 256):
        for p in (8, 16):
            for h in (1, 4, 32):
                k = torch.randn(PA_POOL_PAGES, h, p, dp, generator=gen, device=dev)
                v = torch.randn(PA_POOL_PAGES, h, p, dp, generator=gen, device=dev)
                full = PA_MAX_PAGES * p
                for b in (1, 8, 64):
                    q = torch.randn(b, h, dp, generator=gen, device=dev)
                    pt = torch.randint(
                        1, PA_POOL_PAGES, (b, PA_MAX_PAGES), generator=gen, device=dev,
                        dtype=torch.int32,
                    )
                    sl = torch.randint(
                        0, full + 1, (b,), generator=gen, device=dev, dtype=torch.int32
                    )
                    edges = torch.tensor([0, p, p + 1, full, -3], dtype=torch.int32, device=dev)
                    if b == 1:
                        sl[0] = edges[cases % 4]
                    else:
                        sl[:5] = edges
                    got = pa.paged_attention(q, k, v, pt, sl, sm_scale=32**-0.5)
                    ref = pa.paged_attention_ref(q, k, v, pt, sl, sm_scale=32**-0.5)
                    torch.cuda.synchronize()
                    what = f"B={b} H={h} P={p} Dp={dp}"
                    err = float((got - ref).abs().max())
                    max_err = max(max_err, err)
                    check(err <= PA_TOL, f"paged attention differs by {err} at {what}")
                    empty = sl <= 0
                    check(bool((got[empty] == 0).all()), f"an empty row is not exactly 0 at {what}")
                    zero_rows += int(empty.sum())
                    cases += 1
                del k, v
    return {
        "cases": cases,
        "pool_pages": PA_POOL_PAGES,
        "max_pages": PA_MAX_PAGES,
        "max_abs_err": max_err,
        "tol": PA_TOL,
        "empty_rows_exactly_zero": zero_rows,
    }


# --- phase 3: main path -------------------------------------------------------


def synthetic_docs(n: int, rng: np.random.Generator) -> list[str]:
    words = [f"term{i}" for i in range(20000)]
    return [
        f"doc {i}: " + " ".join(rng.choice(words, size=int(rng.integers(24, 200))))
        for i in range(n)
    ]


def build_index_state(doc_vecs: np.ndarray, dev) -> dict:
    """Index state holding the documents (keys 0..N_DOCS-1, with metadata)
    and seeded unit vectors under keys KEY_BASE.. up to CORPUS_ROWS rows."""
    host = np.empty((CORPUS_ROWS, DIM), dtype=np.float32)
    host[:N_DOCS] = doc_vecs
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    step = 1 << 17
    for lo in range(N_DOCS, CORPUS_ROWS, step):
        hi = min(lo + step, CORPUS_ROWS)
        v = torch.randn(hi - lo, DIM, generator=gen, device=dev)
        host[lo:hi] = (v / v.norm(dim=-1, keepdim=True)).cpu().numpy()
    keys = list(range(N_DOCS)) + list(range(KEY_BASE, KEY_BASE + CORPUS_ROWS - N_DOCS))
    return {
        "metadata": {i: {"doc": i, "group": i % 8} for i in range(N_DOCS)},
        "corpus": {
            "dim": DIM,
            "capacity": CORPUS_ROWS,
            "host": host,
            "valid_host": np.ones(CORPUS_ROWS, dtype=bool),
            "free": [],
            "slot_of": dict(zip(keys, range(CORPUS_ROWS))),
            "key_of": dict(zip(range(CORPUS_ROWS), keys)),
        },
    }


def same_up_to_near_ties(a: tuple, b: tuple, tol: float) -> bool:
    """Two result rows agree: equal lengths, scores within tol position by
    position, and a key differs only where its score is within tol of the
    other row's score at that position (a near-tie the sum order decides)."""
    if len(a) != len(b):
        return False
    sb = dict(b)
    for i, ((ka, sa), (kb, s_b)) in enumerate(zip(a, b)):
        if abs(sa - s_b) > tol:
            return False
        if ka != kb and not (ka in sb and abs(sb[ka] - s_b) <= tol) and abs(sa - b[-1][1]) > tol:
            return False
    return True


def main_path(dev) -> tuple[dict, dict]:
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    rng = np.random.default_rng(SEED)
    docs = synthetic_docs(N_DOCS, rng)
    copied = rng.choice(N_DOCS, size=N_QUERIES // 2, replace=False)
    queries = [docs[i] for i in copied] + [
        "what does " + " ".join(rng.choice([f"term{i}" for i in range(20000)], size=12))
        for _ in range(N_QUERIES - len(copied))
    ]
    in_group3 = [i for i in range(N_DOCS) if i % 8 == 3][:16]
    filtered = [docs[i] for i in in_group3]

    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    torch.cuda.reset_peak_memory_stats()  # the parity phase's peak is not the path's
    t0 = time.perf_counter()
    emb = SentenceTransformerEmbedder(device=dev)  # seeded init, seed 0
    check(emb.get_embedding_dimension() == DIM, "embedding width")
    emb.embed_batch(docs[:EMBED_BATCH])  # warm-up (kernel selection, allocator)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vecs = []
    for lo in range(0, N_DOCS, EMBED_BATCH):
        vecs.extend(emb.embed_batch(docs[lo : lo + EMBED_BATCH]))
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t1
    doc_vecs = np.stack(vecs)
    t2 = time.perf_counter()
    for lo in range(0, N_DOCS, EMBED_BATCH):  # the host share of embedding
        emb.tokenizer.encode_batch(docs[lo : lo + EMBED_BATCH], emb.runtime.max_len)
    tokenize_s = time.perf_counter() - t2
    check(doc_vecs.shape == (N_DOCS, DIM), "doc embedding shape")
    check(bool(np.isfinite(doc_vecs).all()), "non-finite doc embedding")
    check(bool(np.allclose(np.linalg.norm(doc_vecs, axis=1), 1.0, atol=1e-2)), "embeddings not unit")

    state = build_index_state(doc_vecs, dev)
    index = TpuDenseKnnIndex(dimensions=DIM, metric="cosine", reserved_space=CORPUS_ROWS, device=dev)
    index.load_state(state)
    check(len(index) == CORPUS_ROWS, "index size")
    index.search([(doc_vecs[0], K, None)])  # uploads + prepares the corpus once
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    results: dict[int, list] = {}
    latency: dict[int, dict] = {}
    for bs in (1, 16):
        search_ms, query_ms, rows = [], [], []
        for lo in range(0, N_QUERIES, bs):
            t_q = time.perf_counter()
            qv = emb.embed_batch(queries[lo : lo + bs])
            t_s = time.perf_counter()
            res = index.search([(v, K, None) for v in qv])
            t_e = time.perf_counter()  # search() returns host results: synchronized
            search_ms.append((t_e - t_s) * 1e3)
            query_ms.append((t_e - t_q) * 1e3)
            rows.extend(res)
        results[bs] = rows
        latency[bs] = {
            "search_p50_ms": float(np.percentile(search_ms, 50)),
            "search_p99_ms": float(np.percentile(search_ms, 99)),
            "query_p50_ms": float(np.percentile(query_ms, 50)),
            "qps": bs * len(query_ms) / (sum(query_ms) / 1e3),
        }
    fvecs = emb.embed_batch(filtered)
    fres = index.search([(v, K, "group == `3`") for v in fvecs])
    torch.cuda.synchronize()
    launches = bt.block_topk.launches
    shapes = dict(bt.block_topk.shapes)

    check(launches > 0, "the main path never launched the block_topk kernel")
    for qi, doc in enumerate(copied):
        for bs in (1, 16):
            key, score = results[bs][qi][0]
            check(key == doc and abs(score) < 1e-2, f"query copied from doc {doc} returned {key} ({score})")
    for row, doc in zip(fres, in_group3):
        check(len(row) > 0 and row[0][0] == doc, f"filtered query for doc {doc} returned {row[:1]}")
        check(all(k % 8 == 3 and k < N_DOCS for k, _s in row), "filter let a non-matching key through")
    for bs in (1, 16):
        check(all(len(r) == K for r in results[bs]), "a query returned fewer than k results")

    torch_index = TpuDenseKnnIndex(
        dimensions=DIM, metric="cosine", reserved_space=CORPUS_ROWS, kernel="torch", device=dev
    )
    torch_index.load_state(state)
    launches_before = bt.block_topk.launches
    qv = emb.embed_batch(queries)
    ref = torch_index.search([(v, K, None) for v in qv])
    ref_f = torch_index.search([(v, K, "group == `3`") for v in fvecs])
    check(bt.block_topk.launches == launches_before, 'kernel="torch" launched the kernel')
    got = index.search([(v, K, None) for v in qv])
    exact = sum(
        [k for k, _s in a] == [k for k, _s in b] for a, b in zip(got + fres, ref + ref_f)
    )
    check(
        all(same_up_to_near_ties(a, b, F32_TOL) for a, b in zip(got + fres, ref + ref_f)),
        'kernel results differ from kernel="torch"',
    )
    del torch_index

    phase = {
        "phase": "main path",
        "docs": N_DOCS,
        "corpus_rows": len(index),
        "embed_docs_per_s": N_DOCS / embed_s,
        "embed_batch": EMBED_BATCH,
        "embed_s": embed_s,
        "tokenize_s": tokenize_s,
        "setup_s": setup_s,
        "search": {f"B={bs}": latency[bs] for bs in (1, 16)},
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "results_keys_equal_torch_path": exact,
        "results_compared": len(ref) + len(ref_f),
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    prep, _c2, valid = index.corpus.prepared_arrays("cosine", bf16=False)
    batches = {bs: torch.from_numpy(np.stack(qv[:bs])).to(dev) for bs in (1, 16)}
    batches["filtered"] = torch.from_numpy(np.stack(fvecs)).to(dev)
    return phase, {
        "prep": prep, "valid": valid, "queries": batches, "launches": launches,
        "shapes": shapes, "index": index, "emb": emb,
    }


# --- phase 4: generation ------------------------------------------------------


class StepRecorder:
    """Wraps decoder.decode_step for one scheduler run: passes every call
    through, and keeps the inputs (and copies of the pools as they were
    before the call) of the RECORD_STEP-th step."""

    def __init__(self, dec):
        self.dec, self.orig, self.calls, self.step = dec, dec.decode_step, 0, None

    def __enter__(self):
        self.dec.decode_step = self
        return self

    def __exit__(self, *exc):
        self.dec.decode_step = self.orig

    def __call__(self, params, tokens, positions, k_pool, v_pool, pt, sl, **kw):
        self.calls += 1
        if self.calls == RECORD_STEP:
            self.step = {
                "params": params, "tokens": tokens.clone(), "positions": positions.clone(),
                "k_pool": k_pool.clone(), "v_pool": v_pool.clone(), "pt": pt.clone(),
                "sl": sl.clone(), "cfg": kw["cfg"],
            }
        return self.orig(params, tokens, positions, k_pool, v_pool, pt, sl, **kw)


def replay(step: dict, kernel: str):
    """decode_step on the recorded inputs (fresh copies of the pools)."""
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    logits, _k, _v = dec.decode_step(
        step["params"], step["tokens"], step["positions"], step["k_pool"].clone(),
        step["v_pool"].clone(), step["pt"], step["sl"], cfg=step["cfg"], kernel=kernel,
    )
    return logits


def prefix_logits(params, dcfg, tokens: list[int], kernel: str, dev) -> np.ndarray:
    """Logits after feeding ``tokens`` one by one to a lone sequence."""
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    k, v = dec.empty_pools(dcfg, dcfg.max_pages + 1, device=dev)
    pt = torch.arange(1, dcfg.max_pages + 1, dtype=torch.int32, device=dev)[None]

    def one(x: int) -> torch.Tensor:
        return torch.tensor([x], dtype=torch.int32, device=dev)

    for i, t in enumerate(tokens):
        logits, k, v = dec.decode_step(
            params, one(t), one(i), k, v, pt, one(i + 1), cfg=dcfg, kernel=kernel
        )
    return logits[0].cpu().numpy()


def sampling(i: int) -> dict:
    """Ask i's sampling: even asks greedy, odd ones seeded top-k samples."""
    return dict(temperature=0.7, top_k=40, seed=SEED + i) if i % 2 else {}


def run_requests(sched, prompts: list[list[int]]) -> tuple[list[dict], list[float], float]:
    """Submit every prompt (even ones greedy, odd ones seeded top-k samples)
    and wait: (results, time to first token per request, wall seconds)."""
    from pathway_tpu_torch.generate import GenerationRequest

    first: dict[int, float] = {}
    reqs = []
    t0 = time.perf_counter()
    for i, prompt in enumerate(prompts):
        def on_token(_tok, _done, i=i):
            first.setdefault(i, time.monotonic())

        req = GenerationRequest(
            f"ask-{i}", prompt, deadline=time.monotonic() + 600.0,
            max_new_tokens=sched.config.max_new_tokens, on_token=on_token, **sampling(i),
        )
        sched.submit(req)
        reqs.append(req)
    results = [r.wait(600.0) for r in reqs]
    wall = time.perf_counter() - t0
    check(all(r is not None for r in results), "a generation request never finished")
    ttft = [first[i] - r.created_at for i, r in enumerate(reqs) if i in first]
    return results, ttft, wall


def layer_inputs(step: dict, li: int = 0) -> tuple:
    """The paged-attention call of layer ``li`` in the recorded step: a
    seeded q of its shape, and the step's pools, page table and lengths."""
    k, v = step["k_pool"][li], step["v_pool"][li]
    gen = torch.Generator(device=k.device).manual_seed(SEED + 4)
    q = torch.randn(step["tokens"].shape[0], k.shape[1], k.shape[3], generator=gen, device=k.device)
    return q, k, v, step["pt"], step["sl"]


def step_anatomy(step: dict) -> dict:
    """Where one decode step at the recorded shape goes: its host wall time
    (inputs already on the card, logits back with .cpu()), the kernel's
    CUDA-event time over back-to-back launches, and from a torch.profiler
    trace the kernel's own device time per step and the card's busy time
    per step (every device kernel and copy)."""
    from pathway_tpu_torch.ops import paged_attention as pa
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    k_pool, v_pool = step["k_pool"].clone(), step["v_pool"].clone()

    def one_step():
        logits, _k, _v = dec.decode_step(
            step["params"], step["tokens"], step["positions"], k_pool, v_pool, step["pt"],
            step["sl"], cfg=step["cfg"], kernel="cuda",
        )
        return logits.cpu()

    for _ in range(5):
        one_step()
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        one_step()
    replay_ms = (time.perf_counter() - t0) / reps * 1e3
    q, k, v, pt, sl = layer_inputs(step)
    kernel_ms = cuda_ms(lambda: pa.paged_attention(q, k, v, pt, sl, sm_scale=1.0), iters=200)
    times = device_times(one_step)
    busy_ms = None if times is None else sum(ms for _n, ms in times.values()) / 20
    return {
        "replay_step_ms": replay_ms,
        "kernel_event_ms": kernel_ms,
        "kernel_device_ms_per_step": kernel_device_ms(times, "paged_decode_kernel", 20),
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share_of_replay_step": None if busy_ms is None else busy_ms / replay_ms,
        "device_ops_per_step": None if times is None else sum(n for n, _ms in times.values()) / 20,
    }


def generation(dev, main: dict) -> tuple[dict, dict]:
    from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig, assemble_prompt
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops import paged_attention as pa
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    emb, index = main["emb"], main["index"]
    rng = np.random.default_rng(SEED + 2)
    words = [f"term{i}" for i in range(20000)]
    asks = [f"what does {' '.join(rng.choice(words, size=4))} mean?" for _ in range(N_ASKS)]
    cfg = GenerateConfig()

    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    pa.paged_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vecs = emb.embed_batch(asks)
    matches = index.search([(v, RETRIEVE_K, None) for v in vecs])
    topk_shapes = dict(bt.block_topk.shapes)
    prompts = [dec.encode_text(assemble_prompt(a, m)) for a, m in zip(asks, matches)]
    retrieve_s = time.perf_counter() - t0
    sched = DecodeScheduler(cfg, device=dev)
    try:
        with StepRecorder(dec) as rec:
            results, ttft, wall = run_requests(sched, prompts)
        stats = sched.stats()
        launches = pa.paged_attention.launches
        topk_launches = bt.block_topk.launches
        in_use = sched.pool.in_use
        step_ms = np.array(sched.step_seconds) * 1e3
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        sched.stop()

    check(all(len(m) == RETRIEVE_K for m in matches), "an ask retrieved fewer than k docs")
    check(topk_launches > 0, "retrieval never launched the block_topk kernel")
    check(stats["kernel"] == "cuda", f"the default scheduler chose kernel {stats['kernel']!r}")
    for i, r in enumerate(results):
        check(r["status"] == 200, f"ask {i} answered {r}")
        n = r["token_count"]
        check(
            n == cfg.max_new_tokens or (0 < n < cfg.max_new_tokens and r["tokens"][-1] == dec.EOS),
            f"ask {i} returned {n} tokens",
        )
    check(in_use == 0, f"{in_use} KV pages still in use after every request finished")
    steps = stats["decode_steps"]
    check(
        launches == steps * cfg.n_layers,
        f"paged_attention launched {launches} times over {steps} steps x {cfg.n_layers} layers",
    )
    check(rec.step is not None, "fewer decode steps than the recorded one")

    # the same requests through a scheduler on the plain attention
    ref_sched = DecodeScheduler(replace(cfg, kernel="ref"), device=dev)
    try:
        ref_results, _ttft, ref_wall = run_requests(ref_sched, prompts)
    finally:
        ref_sched.stop()
    check(pa.paged_attention.launches == launches, 'kernel="ref" launched the kernel')
    equal = sum(a["tokens"] == b["tokens"] for a, b in zip(results, ref_results))
    diverged = []
    for i, (a, b) in enumerate(zip(results, ref_results)):
        if a["tokens"] == b["tokens"]:
            continue
        # tokens may part only where the two attentions' logits, equal
        # within GEN_LOGIT_TOL, sit on a near-tie: replay that prefix alone
        at = next(j for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y)
        prefix = prompts[i] + a["tokens"][:at]
        zc = prefix_logits(sched.params, sched.dcfg, prefix, "cuda", dev)
        zr = prefix_logits(sched.params, sched.dcfg, prefix, "ref", dev)
        gap = float(np.abs(zc - zr).max())
        check(gap <= GEN_LOGIT_TOL, f"ask {i}: logits differ by {gap} where tokens part")
        if i % 2 == 0:  # greedy: both choices within the tolerance of the top
            top = float(zr.max())
            tie = max(top - zr[a["tokens"][at]], top - zr[b["tokens"][at]])
            check(tie <= 2 * GEN_LOGIT_TOL, f"ask {i}: greedy tokens part {tie} below the top")
        diverged.append({"ask": i, "at": at, "logit_gap": gap})

    step = rec.step
    lc, lr = replay(step, "cuda"), replay(step, "ref")
    step_err = float((lc - lr).abs().max())
    check(step_err <= GEN_LOGIT_TOL, f"recorded step: logits differ by {step_err}")
    shape = (step["tokens"].shape[0], cfg.decoder_config().vocab_size)
    check(bool(torch.isfinite(lc).all()) and lc.shape == shape, "recorded step: bad logits")
    anatomy = step_anatomy(step)
    pa.paged_attention.launches = launches  # the replays above are not the path's

    generated = sum(r["token_count"] for r in results)
    step_p50 = float(np.percentile(step_ms, 50))
    phase = {
        "phase": "generation",
        "asks": N_ASKS,
        "retrieve_k": RETRIEVE_K,
        "retrieve_s": retrieve_s,
        "prompt_tokens": [min(len(p) for p in prompts), max(len(p) for p in prompts)],
        "config": {k: getattr(cfg, k) for k in (
            "dim", "n_layers", "n_heads", "head_dim", "ffn_dim", "max_len", "page_size",
            "n_pages", "max_batch", "max_new_tokens")},
        "generated_tokens": generated,
        "fed_tokens": sum(len(p) for p in prompts) + generated,
        "wall_s": wall,
        "tokens_per_s": generated / wall,
        "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
        "ttft_max_ms": float(np.max(ttft)) * 1e3,
        "decode_steps": steps,
        "step_p50_ms": step_p50,
        "step_p99_ms": float(np.percentile(step_ms, 99)),
        "paged_attention_launches": launches,
        "block_topk_launches": topk_launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(topk_shapes.items())},
        "peak_device_gib": peak_gib,
        "ref_wall_s": ref_wall,
        "ref_tokens_equal": equal,
        "ref_diverged_at_near_ties": diverged,
        "recorded_step": {
            "bucket": int(step["tokens"].shape[0]),
            "seq_lens": step["sl"].tolist(),
            "logits_max_abs_err": step_err,
            "tol": GEN_LOGIT_TOL,
        },
        "step_anatomy": anatomy,
        "kernel_share_of_step_p50": cfg.n_layers * anatomy["kernel_event_ms"] / step_p50,
        "kernel_device_share_of_step_p50": None if anatomy["kernel_device_ms_per_step"] is None
        else anatomy["kernel_device_ms_per_step"] / step_p50,
        "device_busy_share_of_step_p50": None if anatomy["device_busy_ms_per_step"] is None
        else anatomy["device_busy_ms_per_step"] / step_p50,
    }
    # the retrieval batch as the index hands it to the kernel: padded to 32
    asks_q = np.zeros((1 << (N_ASKS - 1).bit_length(), DIM), dtype=np.float32)
    asks_q[:N_ASKS] = np.stack(vecs)
    return phase, {
        "step": step, "launches": launches, "topk_shapes": topk_shapes,
        "asks": torch.from_numpy(asks_q).to(dev), "prompts": prompts, "results": results,
        "params": sched.params, "dcfg": sched.dcfg,
    }


# --- phase 5: durability ------------------------------------------------------


def kill_child(prompts_path: str) -> int:
    """The durability phase's child: the generation phase's prompts through
    a DecodeScheduler configured from PATHWAY_GENERATE_* and armed with
    PATHWAY_FAULTS, which ends this process after its decode step. Returns
    (exit code 1) only if the fault never fired."""
    from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig

    prompts = json.loads(Path(prompts_path).read_text())
    sched = DecodeScheduler(GenerateConfig.from_env(), replica_label="child")
    run_requests(sched, prompts)
    print(f"chip_smoke: the fault never fired ({sched.stats()})", file=sys.stderr)
    return 1


def top2_margin(params, dcfg, prefix: list[int], dev) -> float:
    from pathway_tpu_torch.ops import paged_attention as pa

    before = pa.paged_attention.launches
    z = np.sort(prefix_logits(params, dcfg, prefix, "cuda", dev))
    pa.paged_attention.launches = before  # this replay is not the path's
    return float(z[-1] - z[-2])


def compare_tokens(got: list[int], ask: int, gen: dict, dev, near_ties: list) -> None:
    """Tokens of a resumed sequence against the generation phase's answer
    to the same ask: equal, or parting only where the uninterrupted run's
    top-2 logit margin is below GEN_LOGIT_TOL (a near tie another bucket's
    sum order may decide); anything else fails."""
    want = gen["results"][ask]["tokens"]
    if got == want:
        return
    at = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y), min(len(got), len(want)))
    margin = top2_margin(gen["params"], gen["dcfg"], gen["prompts"][ask] + want[:at], dev)
    check(margin < GEN_LOGIT_TOL, f"ask {ask}: tokens part at step {at} with top-2 margin {margin}")
    near_ties.append({"ask": ask, "at": at, "top2_margin": margin})


def asks_by_prompt(prompts: list[list[int]]) -> dict:
    """(prompt tokens, seed, temperature) -> ask index, as run_requests
    submits them (GenerationRequest defaults: seed 0, temperature 0)."""
    out = {}
    for i, p in enumerate(prompts):
        s = sampling(i)
        out.setdefault((tuple(p), s.get("seed", 0), s.get("temperature", 0.0)), i)
    return out


def ask_of(meta: dict, index: dict) -> int:
    prompt = tuple(meta["tokens"][: meta["prompt_len"]])
    return index[(prompt, meta["seed"], meta["temperature"])]


class HeldRestore:
    """While open, every new DecodeScheduler restores (timed) and its decode
    loop idles, so the restored pools can be read before any step writes
    them; closing lets the loops decode."""

    def __init__(self):
        from pathway_tpu_torch.generate import DecodeScheduler

        self.cls, self.seconds = DecodeScheduler, []
        self.step, self.restore = DecodeScheduler._step, DecodeScheduler._restore

    def __enter__(self):
        def timed(sched, root):
            t0 = time.perf_counter()
            self.restore(sched, root)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)

        self.cls._step = lambda sched: time.sleep(0.002)
        self.cls._restore = timed
        return self

    def __exit__(self, *exc):
        self.cls._step, self.cls._restore = self.step, self.restore


def pages_bit_equal(sched, led) -> int:
    """Every restored page in the scheduler's pools against the ledger's
    bytes; returns the number of pages compared."""
    by_seq = {s.seq_id: s for s in sched._active}
    n = 0
    for (seq_id, page_idx), (k, v, _ident) in led.live_pages().items():
        pid = by_seq[seq_id].pages[page_idx]
        check(sched.k_pool[:, pid].cpu().numpy().tobytes() == k.tobytes(), f"K page {seq_id}/{page_idx} differs")
        check(sched.v_pool[:, pid].cpu().numpy().tobytes() == v.tobytes(), f"V page {seq_id}/{page_idx} differs")
        n += 1
    return n


def wait_finished(scheds: list, n: int, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while sum(len(s.finished) for s in scheds) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    check(sum(len(s.finished) for s in scheds) == n, "a restored sequence never completed")


def resumed_tokens(sched, metas: dict, index: dict, gen: dict, dev, near_ties: list) -> set:
    """Check every restored sequence's answer; returns their seq ids."""
    done = set()
    for rid, res in sched.finished.items():
        check(rid.startswith("restored-") and res["status"] == 200, f"restored answer {rid}: {res}")
        seq_id = int(rid.split("-", 1)[1])
        compare_tokens(res["tokens"], ask_of(metas[seq_id], index), gen, dev, near_ties)
        done.add(seq_id)
    return done


def span_count(tracer, name: str, label: str) -> int:
    return sum(1 for r in tracer.spans() if r.name == name and r.attributes.get("replica") == label)


def series(text: str, name: str, **labels) -> float:
    from pathway_tpu_torch.observability import parse_exposition

    fams, errors = parse_exposition(text)
    check(not errors, f"exposition parse errors: {errors[:3]}")
    return sum(
        smp.value for fam in fams.values() for smp in fam.samples
        if smp.name == name and all(smp.labels.get(k) == v for k, v in labels.items())
    )


def durability(dev, gen: dict) -> dict:
    from pathway_tpu_torch import _build
    from pathway_tpu_torch.elastic.kv import split_kv_store
    from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig, KvLedger
    from pathway_tpu_torch.observability import (
        REGISTRY,
        get_tracer,
        install_torch_metrics,
        tickscope,
        validate_exposition,
    )
    from pathway_tpu_torch.ops import paged_attention as pa

    prompts, index = gen["prompts"], asks_by_prompt(gen["prompts"])
    cfg = GenerateConfig()
    tmp = Path(tempfile.mkdtemp(prefix="pw-durability-"))
    near_ties: list = []
    pa.paged_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        # 1. the real kill: a child process dies by the fault plan
        store = tmp / "store"
        (tmp / "prompts.json").write_text(json.dumps(prompts))
        built_before = sorted(os.listdir(_build.BUILD_DIR))
        env = dict(
            os.environ, PATHWAY_GENERATE_SNAPSHOT_EVERY=str(SNAPSHOT_EVERY),
            PATHWAY_GENERATE_STORE=str(store), PATHWAY_FAULTS=f"kill=decode:{KILL_STEP}",
        )
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--kill-child", str(tmp / "prompts.json")],
            env=env, capture_output=True, text=True, timeout=300,
        )
        child_s = time.perf_counter() - t0
        check(child.returncode == FAULT_EXIT, f"child exited {child.returncode}:\n{child.stderr[-3000:]}")
        check(f"decode step {KILL_STEP}" in child.stderr, "the child did not die by kill=decode")
        check((store / "manifest.json").exists(), "the killed child left no manifest")
        check(sorted(os.listdir(_build.BUILD_DIR)) == built_before, "the child rebuilt a kernel")
        led = KvLedger.restore(str(store))
        metas = led.live_seqs()
        check(len(metas) > 0, "the child's last snapshot holds no sequence")

        # 2. restore on the card
        with HeldRestore() as held:
            restored = DecodeScheduler(replace(cfg, store_root=str(store)), replica_label="restored")
            check(restored.restored_seqs == len(metas), f"restored {restored.restored_seqs} of {len(metas)}")
            pages_checked = pages_bit_equal(restored, led)
        try:
            wait_finished([restored], len(metas))
            check(resumed_tokens(restored, metas, index, gen, dev, near_ties) == set(metas), "restore lost a sequence")
            restored_steps = restored.stats()["decode_steps"]
            check(restored.pool.in_use == 0, "pages still in use after the restored sequences finished")
            check(
                pa.paged_attention.launches == restored_steps * cfg.n_layers,
                f"{pa.paged_attention.launches} launches over {restored_steps} restored steps",
            )
        finally:
            restored.stop()

        # 3. resharding: two new owners resume every sequence exactly once
        owners = [str(tmp / "owner0"), str(tmp / "owner1")]
        split = split_kv_store(str(store), owners)
        with HeldRestore():
            scheds = [
                DecodeScheduler(replace(cfg, store_root=o), replica_label=f"owner{i}")
                for i, o in enumerate(owners)
            ]
        try:
            wait_finished(scheds, len(metas))
            parts = [resumed_tokens(s, metas, index, gen, dev, near_ties) for s in scheds]
            check(not (parts[0] & parts[1]) and parts[0] | parts[1] == set(metas), "resharding lost or doubled a sequence")
            owner_steps = sum(s.stats()["decode_steps"] for s in scheds)
        finally:
            for s in scheds:
                s.stop()

        # 4. the hooks without periodic snapshots, one snapshot from this
        # thread mid-run, and what the hooks report
        install_torch_metrics()
        get_tracer().clear()
        tickscope.reset()
        oob_store = tmp / "out-of-thread"
        hooks = DecodeScheduler(replace(cfg, store_root=str(oob_store)), replica_label="hooks")
        box: dict = {}
        runner = threading.Thread(target=lambda: box.update(out=run_requests(hooks, prompts)))
        try:
            runner.start()
            while hooks.stats()["decode_steps"] < KILL_STEP and runner.is_alive():
                time.sleep(0.001)
            t0 = time.perf_counter()
            oob = hooks.snapshot()  # from this thread: served at a step boundary
            oob_ms = (time.perf_counter() - t0) * 1e3
            oob_at = hooks.stats()["decode_steps"]
            check(oob is not None and oob["bytes_written"] > 0, f"out-of-thread snapshot wrote {oob}")
            runner.join(600)
            results, ttft, wall = box["out"]
            st = hooks.stats()
            mem = tickscope.memory_snapshot()["owners"]["generate:hooks"]
            check(mem["k_pool_device"] == hooks.k_pool.numel() * 4, "memory ledger: wrong K pool bytes")
            check(mem["v_pool_device"] == hooks.v_pool.numel() * 4, "memory ledger: wrong V pool bytes")
            text = REGISTRY.render()
            hooks_ms = np.array(hooks.step_seconds) * 1e3
        finally:
            hooks.stop()
        for i, r in enumerate(results):
            check(r["status"] == 200, f"hooks run: ask {i} answered {r}")
            compare_tokens(r["tokens"], i, gen, dev, near_ties)
        errors = validate_exposition(text)
        check(not errors, f"exposition invalid: {errors[:3]}")
        steps = st["decode_steps"]
        sampled = sum(r["token_count"] for r in results)
        check(series(text, "pathway_generate_decode_steps_total", replica="hooks") == steps, "steps counter")
        check(series(text, "pathway_generate_tokens_total", replica="hooks", kind="sampled") == sampled, "tokens counter")
        check(span_count(get_tracer(), "generate.decode_step", "hooks") == steps, "one span per decode step")
        check(tickscope.roofline().samples("paged_attention") == steps, "roofline samples")
        peak = tickscope.peak_flops()
        kind = torch.cuda.get_device_name(0).lower()
        want = next((p for key, p in tickscope._PEAK_TABLE.items() if key in kind), None)
        check(peak == want, f"peak_flops() {peak} is not the table's entry for {kind!r}")

        # the ledger the out-of-thread snapshot left restores
        oob_led = KvLedger.restore(str(oob_store))
        oob_metas = oob_led.live_seqs()
        check(len(oob_metas) > 0, "the out-of-thread snapshot holds no sequence")
        with HeldRestore():
            from_oob = DecodeScheduler(replace(cfg, store_root=str(oob_store)), replica_label="oob")
            check(from_oob.restored_seqs == len(oob_metas), "the out-of-thread snapshot did not restore")
            pages_bit_equal(from_oob, oob_led)
        try:
            wait_finished([from_oob], len(oob_metas))
            resumed_tokens(from_oob, oob_metas, index, gen, dev, near_ties)
            oob_steps = from_oob.stats()["decode_steps"]
        finally:
            from_oob.stop()

        # 5. a snapshot every 8 steps: mirror and snapshot costs
        snaps = DecodeScheduler(
            replace(cfg, store_root=str(tmp / "snapshots"), snapshot_every=SNAPSHOT_EVERY),
            replica_label="snapshots",
        )
        snap_ms, mirror_ms, written = [], [], []
        inline, mirror = snaps._snapshot_inline, snaps._mirror

        def timed_mirror():
            t = time.perf_counter()
            mirror()
            mirror_ms.append((time.perf_counter() - t) * 1e3)

        def timed_snapshot():
            t = time.perf_counter()
            out = inline()
            snap_ms.append((time.perf_counter() - t) * 1e3)
            written.append(out)
            return out

        snaps._mirror, snaps._snapshot_inline = timed_mirror, timed_snapshot
        try:
            snap_results, _ttft, snap_wall = run_requests(snaps, prompts)
            snap_step_ms = np.array(snaps.step_seconds) * 1e3
            snap_steps = snaps.stats()["decode_steps"]
        finally:
            snaps.stop()
        for i, r in enumerate(snap_results):
            check(r["status"] == 200, f"snapshot run: ask {i} answered {r}")
            compare_tokens(r["tokens"], i, gen, dev, near_ties)
        check(len(written) == snap_steps // SNAPSHOT_EVERY, f"{len(written)} snapshots over {snap_steps} steps")

        launches = pa.paged_attention.launches
        all_steps = restored_steps + owner_steps + steps + snap_steps + oob_steps
        check(launches == all_steps * cfg.n_layers, f"{launches} launches over {all_steps} steps")
        stats = torch.cuda.memory_stats()
        return {
            "phase": "durability",
            "kill": {
                "step": KILL_STEP, "snapshot_every": SNAPSHOT_EVERY, "exit_code": child.returncode,
                "child_s": child_s, "manifest_seqs": len(metas),
                "manifest_pages": len(led.live_pages()),
            },
            "restore": {
                "restored_seqs": len(metas), "pages_bit_equal": pages_checked,
                "restore_s": held.seconds[0], "decode_steps": restored_steps,
            },
            "reshard": {
                "seqs_per_owner": [d["seqs"] for d in split["destinations"]],
                "bytes_per_owner": [d["snapshot"]["bytes_written"] for d in split["destinations"]],
                "decode_steps": owner_steps,
            },
            "hooks_no_snapshots": {
                "decode_steps": steps, "step_p50_ms": float(np.percentile(hooks_ms, 50)),
                "tokens_per_s": sampled / wall, "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
                "exposition_valid": True, "decode_step_spans": steps,
                "out_of_thread_snapshot": {
                    "at_step": oob_at, "ms": oob_ms, "seqs": len(oob_metas),
                    "bytes": oob["bytes_written"], "segments": oob["segments_written"],
                    "restored_decode_steps": oob_steps,
                },
                "roofline_paged_attention": tickscope.roofline().snapshot()["paged_attention"],
                "peak_flops": peak, "memory_generate_hooks": mem,
            },
            "snapshots_every_8": {
                "decode_steps": snap_steps, "step_p50_ms": float(np.percentile(snap_step_ms, 50)),
                "tokens_per_s": sum(r["token_count"] for r in snap_results) / snap_wall,
                "snapshots": len(written),
                "mirror_ms_p50": float(np.percentile(mirror_ms, 50)),
                "mirror_ms_max": float(np.max(mirror_ms)),
                "snapshot_ms_p50": float(np.percentile(snap_ms, 50)),
                "snapshot_ms_max": float(np.max(snap_ms)),
                "bytes_per_snapshot_p50": float(np.percentile([w["bytes_written"] for w in written], 50)),
                "bytes_per_snapshot_max": max(w["bytes_written"] for w in written),
                "segments_per_snapshot_p50": float(np.percentile([w["segments_written"] for w in written], 50)),
                "segments_per_snapshot_max": max(w["segments_written"] for w in written),
            },
            "paged_attention_launches": launches,
            "tokens_compared": "exact; a difference passes only at a near tie",
            "near_ties": near_ties,
            "tol": GEN_LOGIT_TOL,
            "peak_allocated_bytes": stats.get("allocated_bytes.all.peak"),
            "peak_reserved_bytes": stats.get("reserved_bytes.all.peak"),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- phase 6: kernel times ----------------------------------------------------


def kernel_times(main: dict, gen: dict, rate: float, rate_src: str) -> list[dict]:
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.knn import BLK, _normalize

    prep, valid = main["prep"], main["valid"]
    n, d = prep.shape
    # (B, k, queries, launches of that shape on its path)
    path_shapes = [
        (1, K, main["queries"][1], main["shapes"].get((1, K), 0), "retrieval"),
        (16, K, main["queries"][16], main["shapes"].get((16, K), 0), "retrieval"),
        (16, 4 * K, main["queries"]["filtered"], main["shapes"].get((16, 4 * K), 0),
         "retrieval (filtered)"),
        (32, RETRIEVE_K, gen["asks"], gen["topk_shapes"].get((32, RETRIEVE_K), 0), "generation"),
    ]
    per_batch = []
    for bs, k, q, path_launches, path in path_shapes:
        check(path_launches > 0, f"block_topk never ran at B={bs}, k={k} on the {path} path")
        qn = _normalize(q).to(prep.dtype).contiguous()
        before = bt.block_topk.launches, bt.block_topk.shapes.copy()
        ms = cuda_ms(lambda: bt.block_topk(qn, prep, valid, k))
        times = device_times(lambda: bt.block_topk(qn, prep, valid, k))
        plain_ms = cuda_ms(lambda: bt.block_topk_ref(qn, prep, valid, k), iters=5)

        def library():
            s = torch.matmul(qn, prep.T).masked_fill_(~valid[None, :], -float("inf"))
            return torch.topk(s.view(bs, n // BLK, BLK), k, dim=-1)

        library_ms = cuda_ms(library, iters=5)
        sc, ix = bt.block_topk(qn, prep, valid, k)
        sr, ir = bt.block_topk_ref(qn, prep, valid, k)
        # timing launches are not the path's
        bt.block_topk.launches, bt.block_topk.shapes = before
        err = float((sc - sr).abs().max())
        check(err <= F32_TOL, f"block_topk timing inputs disagree by {err} at B={bs}")
        elem = prep.element_size()
        bytes_read = n * d * elem + bs * d * elem + n  # corpus, queries, valid
        nbytes = bytes_read + bs * (n // BLK) * k * 8  # + the candidates written
        ops = 2.0 * bs * n * d
        t_bytes = nbytes / rate * 1e3
        t_ops = ops / PEAK_OPS_PER_S[str(prep.dtype).split(".")[-1]] * 1e3
        per_batch.append({
            "B": bs, "N": n, "D": d, "k": k, "dtype": str(prep.dtype).split(".")[-1],
            "path": path, "launches": path_launches, "query_tile": bt._query_tile(bs, d, k),
            "dynamic_smem_bytes": bt._smem_bytes(bt._query_tile(bs, d, k), d, k),
            "ms": ms, "device_ms": kernel_device_ms(times, "block_topk_kernel", 20),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_read": bytes_read, "bytes": nbytes, "ops": ops, "max_abs_err": err,
        })
    head = per_batch[0]  # B=1: the "KNN p50 @1M x 384" shape
    return [{
        "name": "block_topk",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/block_topk.cu",
        "replaces": "pathway_tpu/ops/pallas_topk.py:69",
        "launches": main["launches"],
        "max_abs_err": max(p["max_abs_err"] for p in per_batch),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_call": "torch.matmul + masked_fill_ + torch.topk per 1024-row block",
        "memory_rate": rate_src,
        "per_batch": per_batch,
    }]


def paged_shape_times(label: str, q, k, v, pt, sl, sm_scale: float, rate: float) -> dict:
    """The paged-attention kernel, its plain version and the library
    yardstick on one set of inputs, with the bound from what they need."""
    import torch.nn.functional as F

    from pathway_tpu_torch.ops import paged_attention as pa

    b, h, dp = q.shape
    _n, _h, p, _dp = k.shape
    ctx = pt.shape[1] * p
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = pa.split_count(b * h, pt.shape[1], p, dp, sms)
    before = pa.paged_attention.launches
    ms = cuda_ms(lambda: pa.paged_attention(q, k, v, pt, sl, sm_scale=sm_scale), iters=100)
    plain_ms = cuda_ms(lambda: pa.paged_attention_ref(q, k, v, pt, sl, sm_scale=sm_scale), iters=10)
    ptl = pt.long()
    mask = (torch.arange(ctx, device=q.device)[None, :] < sl[:, None])[:, None, None, :]

    def library():  # gather the pages, then one fused attention call
        kk = k[ptl].permute(0, 2, 1, 3, 4).reshape(b, h, ctx, dp)
        vv = v[ptl].permute(0, 2, 1, 3, 4).reshape(b, h, ctx, dp)
        return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv, attn_mask=mask, scale=sm_scale)

    library_ms = cuda_ms(library, iters=10)
    times = device_times(lambda: pa.paged_attention(q, k, v, pt, sl, sm_scale=sm_scale))
    got = pa.paged_attention(q, k, v, pt, sl, sm_scale=sm_scale)
    ref = pa.paged_attention_ref(q, k, v, pt, sl, sm_scale=sm_scale)
    pa.paged_attention.launches = before  # timing launches are not the path's
    n = sl.clamp(0, ctx).long()
    live = int(n.sum())
    # each live K and V row read once, q read and the output written once,
    # the live page-table entries and seq_lens read once
    nbytes = live * h * dp * 4 * 2 + 2 * b * h * dp * 4 + int(((n + p - 1) // p).sum()) * 4 + b * 4
    ops = 4.0 * live * h * dp  # q.k and w.v, 2 operations per multiply-add
    t_bytes = nbytes / rate * 1e3
    t_ops = ops / PEAK_OPS_PER_S["float32"] * 1e3
    return {
        "shape": label, "B": b, "H": h, "P": p, "Dp": dp, "n_pages": k.shape[0],
        "max_pages": pt.shape[1], "splits": splits,
        "dynamic_smem_bytes": -(-pt.shape[1] // splits) * 4, "live_tokens": live,
        "ms": ms, "device_ms": kernel_device_ms(times, "paged_decode_kernel", 20),
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": ops, "max_abs_err": float((got - ref).abs().max()),
    }


def paged_kernel_times(gen: dict, rate: float, rate_src: str) -> dict:
    q, k, v, pt, sl = layer_inputs(gen["step"])
    shapes = [paged_shape_times("main path (recorded step, layer 0)", q, k, v, pt, sl, 1.0, rate)]
    # long context: 32 sequences of 2048 tokens over 4096 scattered pages
    dev = q.device
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    b, h, p, dp, mp = 32, 8, 16, 128, 128
    k = torch.randn(b * mp + 1, h, p, dp, generator=g, device=dev)
    v = torch.randn(b * mp + 1, h, p, dp, generator=g, device=dev)
    q = torch.randn(b, h, dp, generator=g, device=dev)
    pt = (torch.randperm(b * mp, generator=g, device=dev) + 1).to(torch.int32).reshape(b, mp)
    sl = torch.full((b,), mp * p, dtype=torch.int32, device=dev)
    shapes.append(paged_shape_times("long context", q, k, v, pt, sl, 32**-0.5, rate))
    check(all(s["max_abs_err"] <= PA_TOL for s in shapes), "paged attention timing inputs disagree")
    head = shapes[0]
    return {
        "name": "paged_attention",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/paged_attention.cu",
        "replaces": "pathway_tpu/ops/paged_attention.py:118",
        "launches": gen["launches"],
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_call": "two calls: k_pool[page_tables] gather + "
        "torch.nn.functional.scaled_dot_product_attention with a boolean mask",
        "memory_rate": rate_src,
        "per_shape": shapes,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from pathway_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the pathway_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--kill-child"]:
        return kill_child(sys.argv[2])
    dev = torch.device("cuda", 0)
    smi = nvidia_smi("name,power.limit")

    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln for name in built for ln in ptxas_report(_build.build_log(name))]
    rate, rate_src = memory_rate()
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s,
        "built": built, "memory_bytes_per_s": rate, "memory_rate_source": rate_src,
        "ptxas": ptxas,
    })
    emit(kernel_parity(dev))
    phase, main_data = main_path(dev)
    emit(phase)
    phase, gen_data = generation(dev, main_data)
    emit(phase)
    emit(durability(dev, gen_data))
    kernels = kernel_times(main_data, gen_data, rate, rate_src) + [
        paged_kernel_times(gen_data, rate, rate_src)
    ]
    emit({"phase": "kernels", "kernels": kernels})
    detail = ("per_batch", "per_shape")
    emit({"kernels": [{k: v for k, v in kern.items() if k not in detail} for kern in kernels]})
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
