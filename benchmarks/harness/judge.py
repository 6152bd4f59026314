"""Whether what the timed path produced is correct, judged against the plain
reference once the window has closed and the program's state is freed.

The reference makes its inputs again from the seed (the encoder's weights,
the prefilled vectors) or takes the texts the harness sent, and works out
again what the program derived from them: token ids, embeddings in float32,
the index's rows (the passages the window committed included) and exact
cosine top-k. It reads the program's replies only to judge them.

Numbers compared, each against its limit:

* ``unanswered``: requests sent (probes committed) in the window with no
  reply a minute after it closed, or a probe whose reply does not rank one
  of its commit's passages first. Limit 0.
* ``rows_mismatched``: replies whose data column (``pid``, from the
  repack's join) does not pair with the row keys one to one across the
  sample. Limit 0.
* ``rows_from_future``: a probe's reply holding a passage committed after
  the reply arrived. Limit 0.
* ``rank_gap``: the widest gap, over the sample's replies and ranks, by
  which the reference's score of the row served at rank r lies below the
  reference's r-th best score over the rows the reply must have seen. A
  short reply counts 2, the widest a cosine gap can be.
* ``score_gap``: the widest gap between a served score and the reference's
  cosine - 1 of the same row (the port's replies are cosine - 1).
* ``index_rank_gap``, ``index_score_gap``: the same two gaps for the index
  alone. The query embeddings the program computed, and the rows it was
  handed (the prefilled vectors made again from the seed, the passages'
  embeddings as the program's encoder produced them), are scored exactly,
  in float64, and the served rows and scores judged against that. They
  hold the index to the configuration's float32 scoring, which the
  encoder's gaps are too wide to see.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.harness import drive, textgen, weights as weights_mod
from benchmarks.reference import encoder as ref_encoder, tokenizer as ref_tok, topk as ref_topk

SAMPLE = 6  # the seeded stream of the sample
WIDEST = 2.0


def reference_embed(cfg: dict, w: dict, texts: list[str], device, precision="float32") -> torch.Tensor:
    enc = cfg["encoder"]
    memo: dict = {}
    ids = [ref_tok.encode(t, enc["vocab_size"], enc["max_seq_length"], memo) for t in texts]
    return ref_encoder.encode(w, ids, enc["num_attention_heads"], device, precision)


def prefilled(cfg: dict, seed: int, rec, device) -> list[torch.Tensor]:
    return [block for _lo, block in drive.corpus_blocks(cfg, seed, device)] if rec.prefilled_rows else []


def reference_corpus(cfg: dict, seed: int, rec, w: dict, device, precision="float32",
                     blocks=None) -> torch.Tensor:
    """[rows, D] float32: the prefilled vectors, then the passages' embeddings."""
    parts = list(prefilled(cfg, seed, rec, device) if blocks is None else blocks)
    if rec.passages:
        parts.append(reference_embed(cfg, w, rec.passages, device, precision))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def handed(vecs: dict, keys, dim: int) -> np.ndarray:
    """[len(keys), dim] float64 of the program's embeddings; a missing one
    is zeros, which no sound reply can score against."""
    out = np.zeros((len(keys), dim))
    for i, key in enumerate(keys):
        v = vecs.get(key)
        if v is not None:
            out[i] = np.asarray(v, dtype=np.float32)
    return out


def index_gaps(cfg: dict, rec, judged: list, blocks: list, device) -> dict:
    """index_rank_gap and index_score_gap: the index judged in float64 on
    the embeddings it was handed."""
    dim, dev = cfg["encoder"]["hidden_size"], torch.device(device)
    parts = [b.double() for b in blocks]
    if rec.passages:
        pids = range(rec.prefilled_rows, rec.prefilled_rows + len(rec.passages))
        parts.append(torch.from_numpy(handed(rec.passage_vecs, pids, dim)).to(dev))
    corpus = torch.cat(parts) if len(parts) > 1 else parts[0]
    q = torch.from_numpy(handed(rec.query_vecs, [qid for qid, _s, _u in judged], dim)).to(dev)
    found = gaps(q, corpus, judged, rec, cfg["index"]["k"], "float64")
    return {"index_rank_gap": found["rank_gap"], "index_score_gap": found["score_gap"]}


def window_queries(rec) -> list[int]:
    return sorted(q for q, (t, _x, _w) in rec.sent.items()
                  if q < drive.PROBE_QID and rec.t0 <= t < rec.t1)


def window_probes(rec) -> list[tuple]:
    return [c for c in rec.commits if rec.t0 <= c[0] < rec.t1]


def sample(rec, seed: int, n: int) -> list[tuple[int, int, int]]:
    """(qid, rows visible at least, rows visible at most) of the judged
    replies: up to n drawn from the seed, with the longest query in."""
    rng = np.random.default_rng(textgen.seed_seq(seed, SAMPLE))
    out = []
    qids = [q for q in window_queries(rec) if q in rec.replies]
    if qids:
        # a query saw at least the commits whose probe had come back before
        # it was sent, and at most those committed before its reply
        shown = [(rec.probe_done[c[3]][0], c[2]) for c in rec.commits if rec.probe_done.get(c[3], (0, 0))[1]]
        committed = [(c[0], c[2]) for c in rec.commits]

        def rows_by(events, t):
            return max((end for at, end in events if at <= t), default=rec.prefilled_rows)

        longest = max(qids, key=lambda q: rec.sent[q][2])
        pick = rng.choice(len(qids), size=min(n, len(qids)), replace=False)
        chosen = {qids[i] for i in pick} | {longest}
        out += [(q, rows_by(shown, rec.sent[q][0]), rows_by(committed, rec.replies[q][0]))
                for q in sorted(chosen)]
    probes = [c for c in window_probes(rec) if c[3] in rec.replies]
    if probes:
        pick = rng.choice(len(probes), size=min(n, len(probes)), replace=False)
        for i in sorted(pick):
            _t, _first, end, qid, _pid = probes[i]
            out.append((qid, end, rec.committed_at_reply[qid]))
    return out


def gaps(q_ref: torch.Tensor, corpus: torch.Tensor, judged: list, rec, k: int,
         precision: str = "float32") -> dict:
    """rank_gap, score_gap and rows_from_future of the judged replies,
    given their reference query vectors (rows of q_ref)."""
    rank_gap = score_gap = 0.0
    future = 0
    corpus = ref_topk.unit(corpus)
    for lo in range(0, len(judged), 32):
        part = judged[lo:lo + 32]
        s = ref_topk.scores(q_ref[lo:lo + 32], corpus, precision, corpus_is_unit=True)
        for j, (qid, seen, upto) in enumerate(part):
            _t, pids, served, _keys = rec.replies[qid]
            best = torch.topk(s[j, :seen], min(k, seen)).values.double().cpu().numpy()
            if len(pids) < len(best):
                rank_gap = WIDEST
            for r, (pid, sc) in enumerate(zip(pids, served)):
                if not 0 <= pid < upto:
                    future += 1
                    rank_gap = WIDEST
                    continue
                ref = float(s[j, pid])
                if r < len(best):
                    rank_gap = max(rank_gap, float(best[r]) - ref)
                score_gap = max(score_gap, abs(float(sc) - (ref - 1.0)))
    return {"rank_gap": rank_gap, "score_gap": score_gap, "rows_from_future": future}


def rows_mismatched(rec, judged: list) -> int:
    """Replies whose keys and pids do not pair one to one across the sample."""
    key_of, pid_of, bad = {}, {}, 0
    for qid, _seen, _upto in judged:
        _t, pids, _s, keys = rec.replies[qid]
        wrong = len(keys) != len(pids)
        for key, pid in zip(keys, pids):
            key = str(key)
            wrong |= key_of.setdefault(pid, key) != key or pid_of.setdefault(key, pid) != pid
        bad += wrong
    return bad


def judge(cfg: dict, traffic: dict, seed: int, rec, device) -> tuple[dict, int, int]:
    """({check: {"value", "limit"}}, attempted, failed) of a run's record."""
    limits = cfg["correct_limits"]
    queries, probes = window_queries(rec), window_probes(rec)
    missing_q = sum(q not in rec.replies for q in queries)
    bad_probes = sum(not rec.probe_done.get(c[3], (0, False))[1] for c in probes)
    attempted, failed = len(queries) + len(probes), missing_q + bad_probes
    judged = sample(rec, seed, traffic["judged_replies"])
    dev = torch.device(device)
    w = weights_mod.make(cfg["encoder"], drive.torch_seed(seed, drive.WEIGHTS), dev)
    blocks = prefilled(cfg, seed, rec, dev)
    corpus = reference_corpus(cfg, seed, rec, w, dev, blocks=blocks)
    if judged:
        q_ref = reference_embed(cfg, w, [rec.sent[q][1] for q, _s, _u in judged], dev)
        found = gaps(q_ref, corpus, judged, rec, cfg["index"]["k"])
        del corpus, q_ref
        found.update(index_gaps(cfg, rec, judged, blocks, dev))
    else:
        found = {"rank_gap": WIDEST, "score_gap": WIDEST, "rows_from_future": 0,
                 "index_rank_gap": WIDEST, "index_score_gap": WIDEST}
    values = {"unanswered": failed, "rows_mismatched": rows_mismatched(rec, judged), **found}
    checks = {name: {"value": v, "limit": limits.get(name, 0)} for name, v in values.items()}
    if attempted == 0:
        checks["unanswered"]["value"] = 1  # nothing was served: never correct
    return checks, attempted, failed


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
