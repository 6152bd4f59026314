"""The port's observability plane on the CPU: its registry, exposition,
tracer, journal, fault plan and Tick Scope subset against the JAX
package's. The same sequential requests through both schedulers give the
same ``pathway_generate_*`` series (names, labels, counter values) and the
same span names; ``kill=decode:N`` parses and fires as in the reference and
the scheduler reports every step to the plan; ``peak_flops`` keys on the
CUDA device's name; the torch gauges never initialise CUDA.

Tolerance: counters and counts are compared exactly."""

import json
import time

import pytest

from pathway_tpu.generate.scheduler import DecodeScheduler as JaxScheduler
from pathway_tpu.generate.scheduler import GenerateConfig as JaxConfig
from pathway_tpu.generate.scheduler import GenerationRequest as JaxRequest
from pathway_tpu.observability import REGISTRY as JAX_REGISTRY
from pathway_tpu.observability import exposition as jax_expo
from pathway_tpu.observability import tracing as jax_tracing
from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig, GenerationRequest
from pathway_tpu_torch.observability import (
    REGISTRY,
    get_tracer,
    install_torch_metrics,
    journal,
    parse_exposition,
    parse_traceparent,
    validate_chrome_trace,
    validate_exposition,
)
from pathway_tpu_torch.observability import tickscope
from pathway_tpu_torch.testing import faults
from pathway_tpu_torch.xpacks.llm import decoder as dec

_SHAPE = dict(
    n_pages=32, page_size=8, max_batch=4, max_len=96, max_new_tokens=8,
    dim=64, n_layers=1, n_heads=2, head_dim=32, ffn_dim=128,
)


def _series(text: str, parse, replica: str) -> dict:
    """{(sample name, sorted labels): value} of one replica's generate
    series in an exposition."""
    fams = parse(text)
    fams = fams[0] if isinstance(fams, tuple) else fams
    out = {}
    for fam in (fams.values() if isinstance(fams, dict) else fams):
        for smp in fam.samples:
            if smp.name.startswith("pathway_generate_") and smp.labels.get("replica") == replica:
                out[(smp.name, tuple(sorted(smp.labels.items())))] = smp.value
    return out


def _drive(make, request, label: str) -> None:
    """Sequential requests (each waits for the last, so the steps are the
    same in both packages) plus one that expires before decode."""
    s = make(label)
    try:
        for i, text in enumerate(["hello there", "what is seven?", "x"]):
            r = request(
                f"{label}{i}", dec.encode_text(text), deadline=time.monotonic() + 60,
                max_new_tokens=5, traceparent="00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
            )
            s.submit(r)
            assert r.wait(60)["status"] == 200
        late = request(f"{label}late", dec.encode_text("late"), deadline=time.monotonic() - 1, max_new_tokens=5)
        s.submit(late)
        assert late.wait(30)["status"] == 504
    finally:
        s.stop()


def test_generate_series_match_the_reference():
    label = "obs-parity"
    _drive(lambda lb: DecodeScheduler(GenerateConfig(**_SHAPE), device="cpu", replica_label=lb), GenerationRequest, label)
    _drive(lambda lb: JaxScheduler(JaxConfig(**_SHAPE, kernel="ref"), replica_label=lb), JaxRequest, label)
    text = REGISTRY.render()
    assert validate_exposition(text) == []
    port = _series(text, parse_exposition, label)
    ref = _series(JAX_REGISTRY.render(), jax_expo.parse_exposition, label)
    assert set(port) == set(ref)
    names = {name for name, _l in port}
    assert {
        "pathway_generate_tokens_total", "pathway_generate_requests_total",
        "pathway_generate_decode_steps_total", "pathway_generate_page_pool_occupancy",
        "pathway_generate_ttft_seconds_count",
    } <= names
    for key, value in port.items():
        if not key[0].startswith("pathway_generate_ttft_seconds_bucket") and "_sum" not in key[0]:
            assert value == ref[key], key
    steps = port[("pathway_generate_decode_steps_total", (("replica", label),))]
    sampled = port[("pathway_generate_tokens_total", (("kind", "sampled"), ("replica", label)))]
    assert sampled == 15 and steps == sum(len(dec.encode_text(t)) + 4 for t in ["hello there", "what is seven?", "x"])
    outcomes = {dict(lbl)["outcome"]: v for (n, lbl), v in port.items() if n == "pathway_generate_requests_total"}
    assert outcomes == {"ok": 3, "expired_queued": 1}
    # the unlabeled batch-size histogram and the help strings exist in both
    for fam in ("pathway_generate_decode_batch_size", "pathway_generate_dropped_mid_decode_total"):
        assert f"# HELP {fam}" in text
        help_line = next(ln for ln in text.splitlines() if ln.startswith(f"# HELP {fam} "))
        assert help_line in JAX_REGISTRY.render()


def test_generate_span_names_match_the_reference():
    label = "obs-spans"
    get_tracer().clear()
    _drive(lambda lb: DecodeScheduler(GenerateConfig(**_SHAPE), device="cpu", replica_label=lb), GenerationRequest, label)
    _drive(lambda lb: JaxScheduler(JaxConfig(**_SHAPE, kernel="ref"), replica_label=lb), JaxRequest, label)

    def names(tracer) -> dict:
        out: dict = {}
        for r in tracer.spans():
            if r.attributes.get("replica") == label:
                out[r.name] = out.get(r.name, 0) + 1
        return out

    port, ref = names(get_tracer()), names(jax_tracing.get_tracer())
    assert set(port) == set(ref) == {"generate.decode_step", "generate.prefill"}
    assert port == ref  # one span per step, one prefill span per request
    prefill = [r for r in get_tracer().spans() if r.name == "generate.prefill" and r.attributes.get("replica") == label]
    assert {r.trace_id for r in prefill} == {"ab" * 16}  # parented into the request's trace
    assert validate_chrome_trace(get_tracer().chrome_trace()) == []
    assert parse_traceparent("00-" + "ab" * 16 + "-" + "cd" * 8 + "-01").trace_id == "ab" * 16


def test_memory_provider_and_roofline():
    tickscope.reset()
    s = DecodeScheduler(GenerateConfig(**_SHAPE), device="cpu", replica_label="obs-mem")
    try:
        r = GenerationRequest("m", dec.encode_text("memory"), deadline=time.monotonic() + 60, max_new_tokens=3)
        s.submit(r)
        assert r.wait(60)["status"] == 200
        parts = tickscope.memory_snapshot()["owners"]["generate:obs-mem"]
        assert parts["k_pool_device"] == parts["v_pool_device"] == s.k_pool.numel() * 4
        assert {"pages_arrangement", "seqs_arrangement", "host_mirror"} <= set(parts)
        rl = tickscope.roofline()
        assert rl.samples("paged_attention") == s.stats()["decode_steps"]
        fam = rl.snapshot()["paged_attention"]
        assert fam["flops_total"] > 0 and fam["mfu"] > 0
        text = REGISTRY.render()
        assert 'pathway_tickscope_resident_bytes{owner="generate:obs-mem",part="k_pool_device"}' in text
        assert validate_exposition(text) == []
    finally:
        s.stop()
        tickscope.reset()
    assert "generate:obs-mem" not in tickscope.memory_snapshot()["owners"]


def test_mid_decode_drop_is_journaled():
    s = DecodeScheduler(GenerateConfig(**{**_SHAPE, "max_len": 160}), device="cpu", replica_label="obs-drop")
    try:
        def hold(_tok, _done):
            if not held:
                held.append(1)
                time.sleep(max(r.deadline - time.monotonic(), 0.0) + 0.05)

        held: list = []
        r = GenerationRequest("d", dec.encode_text("x" * 30), deadline=time.monotonic() + 2.0, max_new_tokens=64, on_token=hold)
        s.submit(r)
        assert r.wait(60)["status"] == 504
    finally:
        s.stop()
    events = [
        e for e in journal().tail(256)
        if e["kind"] == "mid-decode-drop" and e["data"].get("replica") == "obs-drop"
    ]
    assert len(events) == 1 and events[0]["data"]["dropped"] == 1
    text = REGISTRY.render()
    assert 'pathway_generate_dropped_mid_decode_total{replica="obs-drop"} 1' in text
    assert 'pathway_generate_requests_total{replica="obs-drop",outcome="dropped_mid_decode"} 1' in text


def test_fault_kill_decode_parse_and_fire(monkeypatch):
    plan = faults.FaultPlan("kill=decode:3", pid=0, incarnation=0)
    died = []
    monkeypatch.setattr(faults.FaultPlan, "_exit", lambda self, what: died.append(what))
    plan.on_decode_step(1)
    plan.on_decode_step(2)
    assert not died
    plan.on_decode_step(3)
    assert died and "decode step 3" in died[0]
    plan.on_decode_step(4)
    assert len(died) == 1  # fires once
    # engine-tick kills ignore the decode counter
    faults.FaultPlan("kill=tick:1", pid=0, incarnation=0).on_decode_step(10)
    assert len(died) == 1
    # incarnation scoping: the takeover process runs fault-free
    faults.FaultPlan("kill=decode:1", pid=0, incarnation=1).on_decode_step(5)
    assert len(died) == 1
    with pytest.raises(faults.FaultSpecError):
        faults.FaultPlan("kill=decode:1,at:head", pid=0, incarnation=0)
    assert faults.FAULT_EXIT == 23


def test_fault_plan_reads_the_env(monkeypatch):
    faults.reset()
    monkeypatch.setenv("PATHWAY_FAULTS", "kill=decode:7")
    try:
        plan = faults.active()
        assert plan is not None and faults.active() is plan
    finally:
        faults.reset()
        monkeypatch.delenv("PATHWAY_FAULTS")
        faults.reset()
    assert faults.active() is None


def test_scheduler_reports_decode_steps_to_fault_plan(monkeypatch):
    seen = []
    plan = faults.FaultPlan("kill=decode:999999", pid=0, incarnation=0)
    monkeypatch.setattr(faults, "active", lambda: plan)
    real = plan.on_decode_step
    monkeypatch.setattr(plan, "on_decode_step", lambda n: (seen.append(n), real(n)))
    s = DecodeScheduler(GenerateConfig(**_SHAPE), device="cpu", replica_label="fp")
    try:
        r = GenerationRequest("f", dec.encode_text("count me"), deadline=time.monotonic() + 60, max_new_tokens=3)
        s.submit(r)
        assert r.wait(60)["status"] == 200
        assert seen == list(range(1, s.stats()["decode_steps"] + 1))
    finally:
        s.stop()


@pytest.mark.parametrize(
    "name,peak",
    [
        ("NVIDIA H100 80GB HBM3", 989e12),
        ("NVIDIA H100 PCIe", 756e12),
        ("NVIDIA A10G", 756e12),
    ],
)
def test_peak_flops_keys_on_the_cuda_device_name(monkeypatch, name, peak):
    monkeypatch.delenv("PATHWAY_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(tickscope, "_cuda_device_name", lambda: name)
    assert tickscope.peak_flops() == peak
    monkeypatch.setenv("PATHWAY_PEAK_FLOPS", "1.5e12")
    assert tickscope.peak_flops() == 1.5e12


def test_peak_flops_without_cuda_is_the_cpu_estimate(monkeypatch):
    import os

    monkeypatch.delenv("PATHWAY_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(tickscope, "_cuda_device_name", lambda: None)
    assert tickscope.peak_flops() == (os.cpu_count() or 1) * 32e9


def test_torch_metrics_never_initialise_cuda():
    import torch

    from pathway_tpu_torch import _build

    install_torch_metrics()
    install_torch_metrics()  # idempotent
    before = torch.cuda.is_initialized()
    text = REGISTRY.render()
    assert torch.cuda.is_initialized() == before
    assert validate_exposition(text) == []
    info = next(ln for ln in text.splitlines() if ln.startswith("pathway_build_info{"))
    assert f'torch="{torch.__version__}"' in info
    if not before:
        assert 'platform="uninitialized"' in info and "pathway_torch_local_devices 0" in text
    assert f"pathway_torch_kernel_builds_total {_build.stats['builds']}" in text


def test_embedder_and_index_hooks():
    import numpy as np

    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    tickscope.reset()
    emb = SentenceTransformerEmbedder(model="obs-embed", device="cpu", dim=16, depth=1, heads=2, max_len=16)
    vecs = emb.embed_batch(["a b c", "d e", "f"])
    text = REGISTRY.render()
    assert 'pathway_embed_docs_total{model="obs-embed"} 3' in text
    assert 'pathway_embed_batch_seconds_count{model="obs-embed"} 1' in text
    assert any(r.name == "embed.batch" and r.attributes.get("model") == "obs-embed" for r in get_tracer().spans())
    index = TpuDenseKnnIndex(dimensions=16, device="cpu")
    for i, v in enumerate(vecs):
        index.upsert(i, np.asarray(v), None)
    index.search([(vecs[0], 2, None)])
    assert tickscope.roofline().samples("topk") == 1
    tickscope.reset()


def test_journal_postmortem_has_threads(tmp_path):
    path = journal().postmortem("test", directory=str(tmp_path))
    bundle = json.loads(open(path).read())
    assert "=== thread dump" in bundle["threads"] and bundle["reason"] == "test"
