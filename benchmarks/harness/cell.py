"""One run of one cell: drive the port, judge its outputs, read the
metrics, and build the result line."""

from __future__ import annotations

import subprocess
import sys
from types import SimpleNamespace

import torch

from benchmarks import roofline
from benchmarks.harness import devtrace, drive, judge, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "pathway_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def tokens(cfg: dict, words: int) -> int:
    """Real tokens of a text of ``words`` words: one per word, plus CLS, cut
    at the encoder's max_seq_length."""
    return min(1 + words, cfg["encoder"]["max_seq_length"])


def context(c: spec.Cell, seed: int, rec, readings: dict | None, device_name: str) -> SimpleNamespace:
    """What the metric readers read: the window's observations."""
    cfg = c.config
    t0, t1 = rec.t0, rec.t1
    in_window = lambda t: t0 <= t <= t1  # noqa: E731
    queries = judge.window_queries(rec)
    requests = [(rec.sent[q][0], rec.replies[q][0] if q in rec.replies else None) for q in queries]
    answered = [tokens(cfg, w) for q, (t, _x, w) in rec.sent.items()
                if q < drive.PROBE_QID and q in rec.replies and in_window(rec.replies[q][0])]
    probes, reached = [], []
    for t, first, end, qid, _pick in judge.window_probes(rec):
        done = rec.probe_done.get(qid)
        probes.append((t, done[0] if done and done[1] else None))
    for t, first, end, qid, _pick in rec.commits:
        done = rec.probe_done.get(qid)
        if done and done[1] and in_window(done[0]):
            reached += [tokens(cfg, w) for w in
                        rec.passage_words[first - rec.prefilled_rows:end - rec.prefilled_rows]]
    node_ns = {n: ns - rec.node_ns[0].get(n, 0) for n, ns in rec.node_ns[1].items()}
    spans = [s for s in rec.spans if t0 * 1e9 <= s[1] <= t1 * 1e9]
    index_ticks = sum(1 for name, _a, _d, attrs in spans if name.startswith("op.")
                      and any(str(attrs.get("node", "")).endswith(f"_{n}") for n in rec.index_nodes))
    return SimpleNamespace(
        cell=c.name, config=cfg, seed=seed, window_s=t1 - t0, setup_s=rec.setup_s,
        requests=requests, query_tokens_answered=answered, probes=probes,
        passage_tokens_reached=reached, ticks=rec.ticks[1] - rec.ticks[0], node_ns=node_ns,
        embed_nodes=rec.embed_nodes, index_nodes=rec.index_nodes, index_ticks=index_ticks,
        spans=spans, index_rows=rec.prefilled_rows + len(rec.passages),
        topk_shapes=rec.topk_launches[0], topk_rows=rec.topk_launches[1],
        peaks=roofline.peaks_for(device_name), device=readings)


def run_cell(c: spec.Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> dict:
    dev = torch.device(device)
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    hooks = devtrace.DeviceTrace() if trace else None
    rec = drive.run(c.config, c.traffic, seed, seconds, trace, device, t_start, hooks)
    readings = hooks.readings(rec) if trace else None
    checks, attempted, failed = judge.judge(c.config, c.traffic, seed, rec, device)
    ctx = context(c, seed, rec, readings, device_name)
    metrics = {}
    for m in c.metrics:
        value = spec.reader(m["name"], c.root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": judge.correct(checks),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": device_name,
                   "count": 1, "memory_peak_bytes": rec.memory_peak_bytes,
                   "name_and_power_limit": power_limit() if dev.type == "cuda" else "cpu"},
    }
    # the window's seconds in Python's garbage collector, by generation: a
    # host pause the end-to-end metrics include (for the reader of the spread)
    gc_s: dict[str, float] = {}
    for name, a, b in rec.host_spans:
        if name.startswith("python.gc") and rec.t0 <= a <= rec.t1:
            gc_s[name] = gc_s.get(name, 0.0) + b - a
    out["host_gc_s"] = gc_s
    if trace:
        out["device"]["busy_s"] = readings["busy_s"]
        out["device"]["window_s"] = readings["window_s"]
        out["breakdown"] = {"device_ops": readings["device_ops"], "idle_gaps": readings["idle_gaps"]}
        out["block_topk_s"] = readings["block_topk_s"]
        out["block_topk_launches"] = sum(rec.topk_launches[0].values())
    out["checks"] = checks
    return out
