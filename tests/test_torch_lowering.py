"""The Hopper launch ledger (``pathway_tpu_torch/analysis/lowering.py``):
every case's verdict against Hopper's limits, with the shared memory held
against the formula of the CUDA sources themselves (their constants read
from ``csrc/``); the planted refusals; manifest hashes stable across calls
and moved by a changed kernel source; the segment programs proved on meta
tensors, ``tick_forge_live`` registered by a real compiled tick; the own
copies of the reference's lane arithmetic equal to it."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

import pathway_tpu_torch as pw
from pathway_tpu.analysis import lowering as jlow
from pathway_tpu_torch.analysis import lowering as low

CSRC = Path(low.__file__).resolve().parent.parent / "csrc"


def _constants(name: str) -> dict:
    src = (CSRC / name).read_text()
    out = {}
    for key, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        out[key] = int(eval(expr, {}, dict(out)))  # noqa: S307 - our own source
    return out


TOPK = _constants("block_topk.cu")
PAGED = _constants("paged_attention.cu")


def _cu_topk_smem(qt: int, d: int, k: int, bf16: bool) -> int:
    """``launch`` in csrc/block_topk.cu, from the source's constants."""
    dk = TOPK["CHUNK_BYTES"] // (2 if bf16 else 4)
    dpad = (d + dk - 1) // dk * dk
    big = k > TOPK["SMALL_K"]
    return (TOPK["RING_ALIGN"] + TOPK["RING_BYTES"] + TOPK["MERGE_BYTES"] + qt * dpad * 4
            + (qt * TOPK["BLK"] * 4 if big else 0) + TOPK["BAR_BYTES"])


TOPK_CASES = low.FAMILIES["block_topk"]()
PAGED_CASES = low.FAMILIES["paged_attention"]()


@pytest.mark.parametrize("case", TOPK_CASES, ids=[c.name for c in TOPK_CASES])
def test_block_topk_case_verdict(case):
    report = low.prove_lowering(cases=[case])
    (entry,) = report.entries
    s = case.shape
    if case.expect == "reject":
        assert entry["status"] == "rejected" and entry["rule"] == "smem-budget"
        assert _cu_topk_smem(1, s["d"], s["k"], bool(s["bf16"])) > TOPK["SMEM_LIMIT"]
        return
    assert entry["status"] == "proved" and not report.findings
    launch = entry["launch"]
    qt = launch["query_tile"]
    # the CUDA source's own arithmetic and dispatch agree with the ledger
    assert entry["smem_bytes"] == _cu_topk_smem(qt, s["d"], s["k"], bool(s["bf16"]))
    assert entry["smem_bytes"] <= TOPK["SMEM_LIMIT"] == low.SMEM_LIMIT_BYTES
    assert launch["threads"] == TOPK["BLOCK_THREADS"]
    assert qt in (1, 2, 4, 8, 16, 32) and not (qt == 32 and s["k"] > TOPK["SMALL_K"])
    assert qt == min(32, 1 << (s["b"] - 1).bit_length()) or _cu_topk_smem(
        qt * 2, s["d"], s["k"], bool(s["bf16"])) > TOPK["SMEM_LIMIT"]
    # the largest grid: every 1024-row block for each query tile
    assert launch["grid_max"] == [s["n"] // TOPK["BLK"], -(-s["b"] // qt), 1]
    assert launch["grid_max"][1] <= 65535


@pytest.mark.parametrize("case", PAGED_CASES, ids=[c.name for c in PAGED_CASES])
def test_paged_attention_case_verdict(case):
    from pathway_tpu_torch.ops import paged_attention as pa

    report = low.prove_lowering(cases=[case])
    (entry,) = report.entries
    s = case.shape
    if case.expect == "reject":
        assert entry["status"] == "rejected" and entry["rule"] == "vector-width"
        assert s["head_dim"] % low.LANE
        return
    launch = entry["launch"]
    splits = pa.split_count(s["b"] * s["h"], s["max_pages"], s["p"], s["head_dim"], 132)
    assert entry["status"] == "proved"
    assert launch["grid"] == [s["b"] * s["h"], splits, 1]
    assert launch["threads"] == PAGED["THREADS"]
    assert entry["smem_bytes"] == -(-s["max_pages"] // splits) * 4  # one int per page of a split


def test_the_planted_refusals_and_a_user_shape():
    report = low.prove_lowering(families=["block_topk", "paged_attention"], include_live=False)
    rejected = report.by_status("rejected")
    assert sorted((e["family"], e["rule"]) for e in rejected) == [
        ("block_topk", "smem-budget"), ("paged_attention", "vector-width")]
    assert not report.findings and not report.by_status("gate-regression")
    assert len(report.by_status("proved")) == len(report.entries) - 2
    # a user's shape that cannot launch is an ERROR finding naming the rule
    for spec, rule in (("paged_attention:head_dim=129", "vector-width"),
                       ("block_topk:d=40000", "smem-budget"),
                       ("block_topk:n=1000", "kernel-shape")):
        fam, shape = low.parse_shape_spec(spec)
        bad = low.prove_lowering(cases=[low.case_for_shape(fam, shape)])
        assert bad.entries[0]["status"] == "gate-rejected"
        assert bad.findings and bad.findings[0].severity.name == "ERROR"
        assert rule in bad.findings[0].message
    with pytest.raises(ValueError, match="unknown kernel family"):
        low.case_for_shape("pallas_topk", {})
    with pytest.raises(ValueError, match="unknown kernel family"):
        low.prove_lowering(families=["nope"])
    # a gate that stops refusing a planted shape is itself an ERROR
    planted = next(c for c in TOPK_CASES if c.expect == "reject")
    fixed = low.LoweringCase("block_topk", "regressed", planted.shape,
                             build=lambda: {"launch": {"grid": [1], "threads": 1,
                                                       "smem_bytes": 0}},
                             expect="reject", source="block_topk.cu")
    reg = low.prove_lowering(cases=[fixed])
    assert reg.entries[0]["status"] == "gate-regression" and reg.findings


def test_manifest_hashes_are_stable_and_move_with_the_source(tmp_path, monkeypatch):
    a = low.prove_lowering(include_live=False).to_manifest()
    b = low.prove_lowering(include_live=False).to_manifest()
    assert a == b and a["platform"] == "sm_90a"
    assert all(c["sha256"] for c in a["cases"] if c["status"] == "proved")
    p1 = low.write_manifest(low.prove_lowering(include_live=False), str(tmp_path / "m1.json"))
    p2 = low.write_manifest(low.prove_lowering(include_live=False), str(tmp_path / "m2.json"))
    assert Path(p1).read_bytes() == Path(p2).read_bytes()
    assert json.loads(Path(p1).read_text())["content_sha256"] == a["content_sha256"]
    # the default place is under build/, never the reference's manifest
    assert low.default_manifest_path().endswith("build/pathway_tpu_torch/launch_ledger.json")
    # an edited kernel source moves its cases' hashes, and only theirs
    edited = tmp_path / "csrc"
    edited.mkdir()
    for f in CSRC.glob("*.cu"):
        (edited / f.name).write_bytes(f.read_bytes())
    (edited / "paged_attention.cu").write_bytes(
        (CSRC / "paged_attention.cu").read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(low, "_CSRC", edited)
    c = low.prove_lowering(include_live=False).to_manifest()
    moved = {x["family"] for x, y in zip(a["cases"], c["cases"]) if x.get("sha256") != y.get("sha256")}
    assert moved == {"paged_attention"} and c["content_sha256"] != a["content_sha256"]


def test_tick_forge_family_proves_on_meta_tensors():
    report = low.prove_lowering(families=["tick_forge"], include_live=False)
    assert [e["status"] for e in report.entries] == ["proved"] * 3 and not report.findings
    for e in report.entries:
        # z = x * 2 + 1 (int64), w = y * 0.5 + y (float64), the filter's mask
        assert e["outputs"] == ["int64", "float64", "bool"]
        assert e["ops"] >= 5


def test_prove_program_refuses_a_wrong_dtype():
    import torch

    def fn(x):
        return (x.to(torch.float32),)

    with pytest.raises(low.LoweringRuleViolation, match="numpy's result dtype"):
        low.prove_program(fn, (((8,), np.dtype("int64")),), ["float64"])
    with pytest.raises(low.LoweringRuleViolation, match="shape"):
        low.prove_program(lambda x: (x[:4],), (((8,), np.dtype("int64")),))


def test_tick_forge_live_registered_by_a_real_compiled_tick(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "1")
    monkeypatch.setenv("PATHWAY_COMPILED_DEVICE", "cpu")
    monkeypatch.setenv("PATHWAY_COMPILED_MIN_ROWS", "1")
    low.clear_live_programs()
    pw.internals.parse_graph.G.clear()

    class S(pw.Schema):
        a: int
        b: float

    rng = np.random.default_rng(11)
    t = pw.debug.table_from_rows(
        S, [(int(a), float(b)) for a, b in zip(rng.integers(-9, 9, 40), rng.normal(size=40))])
    r = t.select(x=t.a * 3, y=t.b + t.a).filter(pw.this.x > 0)
    _keys, cols = pw.debug.table_to_dicts(r)
    rt = pw.internals.parse_graph.G.last_runtime
    assert sum(s.compiled_ticks for s in rt.compiled_plan.segments) >= 1
    live = low.live_cases()
    assert live and all(c.family == "tick_forge_live" for c in live)
    report = low.prove_lowering(families=[], include_live=True)
    assert report.entries and all(e["status"] == "proved" for e in report.entries)
    assert report.entries[0]["shape"]["out_dtypes"] == ["int64", "float64"]
    assert report.entries[0]["outputs"] == ["int64", "float64", "bool"]
    assert all(v > 0 for v in cols["x"].values())
    low.clear_live_programs()
    pw.internals.parse_graph.G.clear()


def test_own_copies_of_the_reference_arithmetic():
    for d in (1, 32, 127, 128, 129, 255, 256, 384, 1000):
        assert low.lane_pad(d) == jlow.lane_pad(d)
    for block, array in (((8, 128), (64, 1024)), ((8, 10), (64, 100)), ((8, 10), (8, 10)),
                         ((3, 128), (64, 128)), ((3, 128), (3, 128)), ((4,), (4,)),
                         ((8, 128), (8, 128, 1))):
        outcomes = []
        for mod in (low, jlow):
            try:
                mod.check_tpu_block_rules(block, array)
                outcomes.append(None)
            except ValueError as exc:
                outcomes.append((exc.rule, str(exc)))
        assert outcomes[0] == outcomes[1], (block, array)
    for spec in ("paged_attention:head_dim=129,b=4", "block_topk", "x:k=1"):
        assert low.parse_shape_spec(spec) == jlow.parse_shape_spec(spec)
    for bad in (":k=1", "x:k", "x:k=one"):
        with pytest.raises(ValueError):
            low.parse_shape_spec(bad)
