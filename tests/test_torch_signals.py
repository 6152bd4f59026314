"""The port's SLO signals (``pathway_tpu_torch.observability.signals``)
against the JAX package's: the same metric histories, fed to a registry of
each package and sampled under the same injected clock, give the same
rings, snapshots and burn rates to 1e-12; the knobs, the process-global
sampler and its thread behave alike."""

import math

import numpy as np
import pytest

from pathway_tpu.observability import registry as jreg
from pathway_tpu.observability import signals as jsig
from pathway_tpu_torch.observability import registry as treg
from pathway_tpu_torch.observability import signals as tsig

SIDES = {"port": (treg, tsig), "jax": (jreg, jsig)}
TOL = 1e-12


class _Clock:
    """A wall and a monotonic clock the test steps by hand."""

    def __init__(self, wall=1.7e9, mono=1000.0):
        self.wall, self.mono = wall, mono

    def time(self):
        return self.wall

    def monotonic(self):
        return self.mono

    def step(self, dt, wall_dt=None):
        self.mono += dt
        self.wall += dt if wall_dt is None else wall_dt


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for _reg, sig in SIDES.values():
        monkeypatch.setattr(sig, "time", c)
    return c


def _metrics(reg_mod):
    r = reg_mod.MetricsRegistry()
    return r, {
        "shed": r.counter("pathway_serving_shed_total", "shed", ("route",)),
        "adm": r.counter("pathway_serving_admitted_total", "admitted", ("route",)),
        "tok": r.counter("pathway_generate_tokens_total", "tokens"),
        "queue": r.gauge("pathway_serving_queue_depth", "queue", ("route",)),
        "stale": r.gauge("pathway_replica_staleness_seconds", "staleness", ("replica",)),
        "rinfl": r.gauge("pathway_router_replica_inflight", "inflight", ("replica",)),
        "sinfl": r.gauge("pathway_serving_inflight", "inflight", ("route",)),
        "kv": r.gauge("pathway_generate_page_pool_occupancy", "occupancy"),
        "tick": r.gauge("pathway_last_tick_seconds", "tick"),
        "ttft": r.histogram("pathway_generate_ttft_seconds", "ttft",
                            buckets=reg_mod.log_linear_buckets(1e-4, 10.0, 4)),
        "op": r.histogram("pathway_operator_tick_seconds", "op", ("node",)),
        "knn": r.histogram("pathway_knn_query_seconds", "knn", ("kind",)),
        "hits": r.counter("pathway_engine_compile_cache_hits_total", "hits"),
        "miss": r.counter("pathway_engine_compile_cache_misses_total", "misses"),
    }


def _feed(m, step, rng):
    """One step's metric movement, the same draws for both packages."""
    m["shed"].labels("/q").inc(float(rng.integers(0, 5)))
    m["adm"].labels("/q").inc(float(rng.integers(1, 50)))
    m["adm"].labels("/r").inc(float(rng.integers(0, 3)))
    m["tok"].inc(float(rng.integers(0, 400)))
    m["queue"].labels("/q").set(float(rng.integers(0, 30)))
    m["queue"].labels("/r").set(float(rng.integers(0, 3)))
    m["stale"].labels("0").set(float(rng.random()))
    m["stale"].labels("1").set(float(rng.random() * 2))
    m["rinfl"].labels("0").set(float(rng.integers(0, 8)))
    m["sinfl"].labels("/q").set(float(rng.integers(0, 8)))
    m["kv"].set(float(rng.random()))
    m["tick"].set(float(rng.random() * 0.05))
    for _ in range(int(rng.integers(1, 6))):
        m["ttft"].observe(float(rng.lognormal(-3, 1)))
        m["op"].labels(f"n{int(rng.integers(0, 3))}").observe(float(rng.random() * 0.01))
        m["knn"].labels("dense").observe(float(rng.random() * 0.002))
    if step % 3:
        m["hits"].inc(float(rng.integers(0, 10)))
    m["miss"].inc(float(rng.integers(0, 2)))


def _close(a, b, path="") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        if math.isinf(a) or math.isinf(b):
            assert a == b, (path, a, b)
        else:
            assert abs(a - b) <= TOL * max(1.0, abs(a)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _drive(clock, steps, seed, env=None, monkeypatch=None, wall_step=None):
    out = {}
    for name, (reg_mod, sig) in SIDES.items():
        clock.wall, clock.mono = 1.7e9, 1000.0
        reg, m = _metrics(reg_mod)
        s = sig.SignalSampler(interval_s=0.5, depth=16, registry=reg)
        rng = np.random.default_rng(seed)
        snaps = []
        for i in range(steps):
            _feed(m, i, rng)
            s.sample_once()
            snap = s.snapshot(series_points=5)
            snap.pop("running")
            snaps.append(snap)
            clock.step(0.5 + 0.1 * (i % 3), wall_step)
        out[name] = (snaps, s)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rings_and_snapshots_equal_the_reference(clock, seed, monkeypatch):
    monkeypatch.setenv("PATHWAY_SLO_WINDOW_S", "2.5")
    out = _drive(clock, 24, seed)
    (tsnaps, ts), (jsnaps, js) = out["port"], out["jax"]
    _close(tsnaps, jsnaps)
    last = tsnaps[-1]["signals"]
    # every signal has a source here but ranks: no autoscale controller is
    # armed, so pathway_autoscale_ranks does not exist yet
    assert {k for k, v in last.items() if v["n"]} == set(last) - {"ranks"}
    assert last["ranks"]["n"] == 0
    # an armed controller's pathway_autoscale_ranks feeds the ranks signal
    import importlib

    ranks = {}
    for name, (reg_mod, sig) in SIDES.items():
        reg = reg_mod.MetricsRegistry()
        auto = importlib.import_module(sig.__name__.split(".")[0] + ".autoscale")
        auto.AutoscaleController(auto.CallbackActuator(lambda m: None), ranks=3, registry=reg)
        sampler = sig.SignalSampler(interval_s=0.5, depth=16, registry=reg)
        sampler.sample_once()
        got = sampler.snapshot(series_points=5)["signals"]["ranks"]
        ranks[name] = {k: got[k] for k in ("unit", "last", "n", "window_avg")}
    assert ranks["port"] == ranks["jax"] == {"unit": "ranks", "last": 3.0, "n": 1, "window_avg": 3.0}
    assert [d.name for d in tsig.SIGNALS] == [d.name for d in jsig.SIGNALS]
    for name in ts.rings:
        _close(ts.rings[name].points(), js.rings[name].points())
        _close(ts.rings[name].window_max(1.0), js.rings[name].window_max(1.0))


SLO_ENVS = [
    {"PATHWAY_SLO_SHED_RATE": "0.05", "PATHWAY_SLO_TOK_S": "300"},
    {"PATHWAY_SLO_TTFT_P99_MS": "80", "PATHWAY_SLO_KNN_P50_MS": "0.5",
     "PATHWAY_SLO_TICK_P99_MS": "5"},
    {"PATHWAY_SLO_WFQ_BACKLOG": "10", "PATHWAY_SLO_STALENESS_S": "0.9",
     "PATHWAY_SLO_REPLICA_OCCUPANCY": "6", "PATHWAY_SLO_KV_OCCUPANCY": "0.5",
     "PATHWAY_SLO_COMPILE_HIT_RATE": "0.9"},
    {"PATHWAY_SLO_SHED_RATE": "not-a-number", "PATHWAY_SLO_TOK_S": "0"},
]


@pytest.mark.parametrize("env", SLO_ENVS, ids=["shed_tok", "latency", "capacity", "bad_and_zero"])
def test_burn_rates_equal_the_reference(clock, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PATHWAY_SLO_WINDOW_S", "3")
    out = _drive(clock, 12, 5)
    (_t, ts), (_j, js) = out["port"], out["jax"]
    got, want = ts.burn_rates(), js.burn_rates()
    _close(got, want)
    _close(tsig.slo_targets(), jsig.slo_targets())
    assert set(got) == {tsig.SLO_KNOBS[k][0] for k, v in env.items()
                        if v not in ("not-a-number",)}


def test_a_stepped_wall_clock_moves_no_rate(clock, monkeypatch):
    """Rates and windows ride the monotonic clock: a wall clock that
    jumps back an hour each step changes only the shown timestamps."""
    monkeypatch.setenv("PATHWAY_SLO_TOK_S", "100")
    steady = _drive(clock, 10, 3)
    jumpy = _drive(clock, 10, 3, wall_step=-3600.0)
    for name in SIDES:
        a, b = steady[name][0][-1], jumpy[name][0][-1]
        for sig in a["signals"]:
            _close(a["signals"][sig]["window_avg"], b["signals"][sig]["window_avg"])
        _close(a["slo"], b["slo"])
    _close(jumpy["port"][0], jumpy["jax"][0])


def test_ring_arithmetic_equals_the_reference():
    for depth in (1, 2, 5):
        t, j = tsig.SignalRing(depth), jsig.SignalRing(depth)
        assert t.last() is None and t.window_avg(10) is None and t.window_max(10) is None
        for i in range(9):
            for r in (t, j):
                r.append(100.0 + i, 10.0 + 0.25 * i, (i * 7) % 5 - 1.5)
            _close(t.series(), j.series())
            _close(t.series(limit=2), j.series(limit=2))
            _close(t.points(), j.points())
            for w in (0.0, 0.3, 1.0, 100.0):
                _close(t.window_avg(w), j.window_avg(w))
                _close(t.window_max(w), j.window_max(w))
                _close(t.window_avg(w, now_mono=50.0), j.window_avg(w, now_mono=50.0))
            assert len(t) == len(j)


def test_sampler_knobs_and_process_global_sampler(monkeypatch):
    monkeypatch.setenv("PATHWAY_SIGNALS_INTERVAL_MS", "20")
    monkeypatch.setenv("PATHWAY_SIGNALS_DEPTH", "7")
    monkeypatch.setenv("PATHWAY_SLO_WINDOW_S", "9")
    for _reg, sig in SIDES.values():
        s = sig.SignalSampler()
        assert (s.interval_s, s.depth, s.window_s) == (0.05, 7, 9.0)  # 20 ms floors at 50
    monkeypatch.setenv("PATHWAY_SIGNALS_INTERVAL_MS", "bogus")
    monkeypatch.setenv("PATHWAY_SIGNALS_DEPTH", "bogus")
    assert tsig.SignalSampler().interval_s == jsig.SignalSampler().interval_s == 1.0
    assert tsig.SignalSampler().depth == jsig.SignalSampler().depth == 600
    monkeypatch.setenv("PATHWAY_SIGNALS_INTERVAL_MS", "50")
    tsig.reset_sampler()
    try:
        monkeypatch.setenv("PATHWAY_SIGNALS", "0")
        assert tsig.arm_sampler() is None and tsig.get_sampler() is None
        assert not tsig.signals_enabled()
        monkeypatch.setenv("PATHWAY_SIGNALS", "1")
        s = tsig.arm_sampler()
        assert s is tsig.get_sampler() is tsig.arm_sampler()
        deadline = 100
        while s.snapshot()["samples"] < 2 and deadline:
            import time

            time.sleep(0.05)
            deadline -= 1
        snap = s.snapshot()
        assert snap["running"] and snap["samples"] >= 2
    finally:
        tsig.reset_sampler()
    assert tsig.get_sampler() is None
