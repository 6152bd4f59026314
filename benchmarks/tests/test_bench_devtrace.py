"""The traced run's arithmetic on a made-up trace: busy time as the union
of device intervals, idle gaps named by the host's innermost span, the
profiler's block_topk seconds, all on the harness's clock."""

import pytest

from benchmarks.harness import devtrace, drive


def test_merge_and_gaps():
    busy = devtrace.merge([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert busy == [(0, 3), (5, 8)]
    assert devtrace.gaps_of(busy, 0, 10) == [(3, 5), (8, 10)]
    assert devtrace.gaps_of([], 2, 4) == [(2, 4)]


def test_idle_is_named_by_the_innermost_covering_span():
    spans = [("pathway.run", 0, 100), ("op.GroupByNode_15", 10, 30), ("embed.batch", 40, 45)]
    gaps = [(15, 25), (41, 43), (60, 70), (190, 210), (12, 14)]
    got = devtrace.idle_by_host(gaps, spans)
    assert got["op.GroupByNode_15"] == pytest.approx(12e-9)
    assert got["embed.batch"] == pytest.approx(2e-9)
    assert got["pathway.run"] == pytest.approx(10e-9)
    assert got["no span: the engine waits for input"] == pytest.approx(20e-9)


def test_readings_on_a_made_up_trace():
    t = devtrace.DeviceTrace()
    t.align_ns = 1_000_000_000  # the marker launched at host 1.0 s ...
    rec = drive.Record(t0=1.0, t1=2.0)
    us = lambda host_s: (host_s * 1e9 - t.align_ns) / 1000 + 500.0  # noqa: E731 ... is at 500 us in the trace
    rec.trace = {"events": [
        {"cat": "kernel", "name": "void at::native::spin_kernel(long)", "ts": 500.0, "dur": 10.0},
        {"cat": "kernel", "name": "block_topk_kernel<float>", "ts": us(1.1), "dur": 100_000.0},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": us(1.15), "dur": 100_000.0},
        {"cat": "kernel", "name": "gemm", "ts": us(1.9), "dur": 200_000.0},  # runs past the window
    ]}
    rec.spans = [("op.GroupByNode_15", int(1.3e9), int(0.5e9), {})]
    rec.host_spans = [("python.gc.gen2", 1.82, 1.88)]
    got = t.readings(rec)
    assert got["window_s"] == pytest.approx(1.0)
    assert got["busy_s"] == pytest.approx(0.15 + 0.1, abs=1e-6)  # [1.1, 1.25] and [1.9, 2.0]
    assert got["block_topk_s"] == pytest.approx(0.1, abs=1e-6)
    idle = dict(got["idle_gaps"])
    assert idle["op.GroupByNode_15"] == pytest.approx(0.65, abs=1e-6)  # [1.25, 1.9], middle in the op
    assert idle["no span: the engine waits for input"] == pytest.approx(0.1, abs=1e-6)  # [1.0, 1.1]
