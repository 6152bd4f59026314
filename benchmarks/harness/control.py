"""The control of the correctness check: the reference put in the program's
place, one precision step below what the configuration states, answering
the same requests a run judges. Its replies go through the same judge; the
check is sound only if the control fails it.

The configurations state a bfloat16 encoder and a float32 index scored with
TF32 off, so the control encodes in fp8 (e4m3, one scale per tensor) and
scores in TF32 (``encoder`` and ``scoring`` choose other steps, to see
what each alone reads). The index's own control is the program itself with
its bfloat16 scoring path (the sharded index's default) switched on for
the unsharded index: ``program_bf16_scoring``."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmarks.harness import drive, judge, textgen, weights as weights_mod
from benchmarks.reference import topk as ref_topk


@contextlib.contextmanager
def program_bf16_scoring():
    """The program's unsharded dense index prepares its corpus in bfloat16
    and casts its queries to it, as its sharded path does."""
    from pathway_tpu_torch.ops import knn
    from pathway_tpu_torch.stdlib.indexing import _index_impls

    prepared, scored = knn.DeviceCorpus.prepared_arrays, _index_impls.dense_topk_prepared
    knn.DeviceCorpus.prepared_arrays = lambda self, metric, bf16=True: prepared(self, metric, True)
    _index_impls.dense_topk_prepared = lambda *a, bf16=True, **kw: scored(*a, bf16=True, **kw)
    try:
        yield
    finally:
        knn.DeviceCorpus.prepared_arrays, _index_impls.dense_topk_prepared = prepared, scored


def _reply(scores: torch.Tensor, k: int) -> tuple[tuple, tuple, tuple]:
    top = torch.topk(scores, min(k, scores.shape[0]))
    pids = tuple(int(i) for i in top.indices.cpu())
    return pids, tuple(float(s) - 1.0 for s in top.values.cpu()), tuple(str(p) for p in pids)


def record(cfg: dict, traffic: dict, seed: int, device, passages: int,
           encoder: str = "fp8", scoring: str = "tf32") -> drive.Record:
    """A run's record whose replies are the control's."""
    dev = torch.device(device)
    k = cfg["index"]["k"]
    rec = drive.Record(prefilled_rows=cfg["index"].get("prefilled_rows", 0), t0=0.0, t1=1.0)
    w = weights_mod.make(cfg["encoder"], drive.torch_seed(seed, drive.WEIGHTS), dev)
    ingest = traffic.get("ingest")
    if ingest:
        stream = textgen.TextStream(textgen.seed_seq(seed, drive.PASSAGES), cfg["passages"], traffic["pool"])
        rng = np.random.default_rng(textgen.seed_seq(seed, drive.PROBES))
        rows = ingest["commit_rows"]
        for c in range(passages // rows):
            texts, words = stream.take(rows)
            first = rec.prefilled_rows + len(rec.passages)
            rec.passages += texts
            rec.passage_words += words
            qid, pick = drive.PROBE_QID + c, first + int(rng.integers(0, rows))
            rec.commits.append((0.5, first, first + rows, qid, pick))
            rec.sent[qid] = (0.5, rec.passages[pick - rec.prefilled_rows], 0)
            rec.committed_at_reply[qid] = first + rows
    corpus = judge.reference_corpus(cfg, seed, rec, w, dev, encoder)
    # the embeddings the control's index was handed: its own
    rec.passage_vecs = {rec.prefilled_rows + i: v for i, v in
                        enumerate(corpus[rec.prefilled_rows:].cpu().numpy())}
    if traffic.get("clients") or traffic.get("arrivals"):
        stream = textgen.TextStream(textgen.seed_seq(seed, drive.QUERIES), cfg["queries"], traffic["pool"])
        texts, words = stream.take(traffic["judged_replies"])
        q = judge.reference_embed(cfg, w, texts, dev, encoder)
        for qid, (text, nw, v) in enumerate(zip(texts, words, q.cpu().numpy())):
            rec.sent[qid] = (0.5, text, nw)
            rec.query_vecs[qid] = v
        for lo in range(0, len(texts), 32):
            s = ref_topk.scores(q[lo:lo + 32], corpus, scoring)
            for j in range(s.shape[0]):
                rec.replies[lo + j] = (0.7, *_reply(s[j], k))
    for _t, first, end, qid, pick in rec.commits:
        s = ref_topk.scores(corpus[pick:pick + 1], corpus[:end], scoring)
        rec.replies[qid] = (0.7, *_reply(s[0], k))
        rec.query_vecs[qid] = corpus[pick].cpu().numpy()
        rec.probe_done[qid] = (0.7, first <= rec.replies[qid][1][0] < end)
    return rec


def readings(cfg: dict, traffic: dict, seed: int, device, passages: int, **steps) -> dict:
    """{check: value} of the control on this seed."""
    rec = record(cfg, traffic, seed, device, passages, **steps)
    checks, _attempted, _failed = judge.judge(cfg, traffic, seed, rec, device)
    return {name: c["value"] for name, c in checks.items()}
