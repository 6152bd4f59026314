"""The port's Flux Pilot (``pathway_tpu_torch/autoscale/``) held against the
JAX package's on the CPU: the reference's ``tests/test_autoscale.py`` cases,
each run through both packages with equal outcomes.

* The policy: every decision of the brute-force grid, and of the reference's
  hand-picked observations, is the same ``Decision`` (action, target,
  reason) in both packages; a scale-down never fires under burn.
* ``AutoscaleConfig.from_env``: the same config from the same env.
* The controller over a scripted sampler: the ranks after every step, the
  journal's ``autoscale-*`` events and the ``pathway_autoscale_*`` metrics
  are equal in both packages (saw-tooth, cooldown serialization, rollback,
  rank-seconds, predictive scale-up).
* The forecaster: ``forecast``, ``lead_crossing`` and ``state`` are equal
  on the same observations, exactly.
* The plane doctor's ``autoscale-coverage`` findings, with and without an
  armed controller, are equal.
* The e2e loop of the reference: a real persisted store resized 1 → 2 on a
  surge and 2 → 1 on the drain through ``reshard_stores``, with the same
  journal in both packages and the original arranged rows restored.

Every case runs on virtual time: ``step(now)`` is given the clock."""

from __future__ import annotations

import importlib
import math
import time

import pytest

from pathway_tpu_torch.internals import parse_graph as port_parse_graph

PACKAGES = ("pathway_tpu", "pathway_tpu_torch")

_VARS = (
    "PATHWAY_AUTOSCALE_MIN_RANKS", "PATHWAY_AUTOSCALE_MAX_RANKS", "PATHWAY_AUTOSCALE_UP_WINDOW_S",
    "PATHWAY_AUTOSCALE_DOWN_WINDOW_S", "PATHWAY_AUTOSCALE_COOLDOWN_S", "PATHWAY_AUTOSCALE_LOW_WATER",
    "PATHWAY_AUTOSCALE_STEP", "PATHWAY_AUTOSCALE_HORIZON_S", "PATHWAY_AUTOSCALE_INTERVAL_MS",
    "PATHWAY_SLO_SHED_RATE", "PATHWAY_SLO_STALENESS_S", "PATHWAY_SLO_TOK_S", "PATHWAY_SLO_TTFT_P99_MS",
    "PATHWAY_JOURNAL_PATH", "PATHWAY_SERVING_SHARD_MAP", "PATHWAY_TENANT_QOS",
)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _reset(pkg):
    _mod(pkg, "observability.journal").reset_journal()
    _mod(pkg, "observability.signals").reset_sampler()
    _mod(pkg, "autoscale").reset_controller()


@pytest.fixture(autouse=True)
def _pilot_env(monkeypatch):
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATHWAY_DCN_SECRET", "flux-pilot-test-secret")
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    for pkg in PACKAGES:
        _reset(pkg)
    yield
    for pkg in PACKAGES:
        _reset(pkg)
    port_parse_graph.G.clear()


def _both(fn, *args):
    """``fn(pkg, *args)`` for both packages (each from a fresh journal,
    sampler and controller); the outcomes must be equal."""
    got = {}
    for pkg in PACKAGES:
        _reset(pkg)
        got[pkg] = fn(pkg, *args)
    assert got["pathway_tpu_torch"] == got["pathway_tpu"], got
    return got["pathway_tpu_torch"]


def _cfg(pkg, **kw):
    base = dict(min_ranks=1, max_ranks=4, up_window_s=15.0, down_window_s=120.0, cooldown_s=60.0,
                low_water=0.5, step=1, horizon_s=30.0)
    base.update(kw)
    return _mod(pkg, "autoscale").AutoscaleConfig(**base)


class _Sampler:
    """A scripted burn source behind the sampler's ``burn_rates()``."""

    def __init__(self, burn=None):
        self.burn = burn

    def burn_rates(self):
        if self.burn is None:
            return {}
        return {"shed_rate": {"target": 0.01, "direction": "max", "window_avg": self.burn * 0.01,
                              "burn": self.burn}}


def _d(decision):
    return (decision.action, decision.target_ranks, decision.reason)


def _journal(pkg, kinds=None):
    return [(e["kind"], e["detail"].split(" in ")[0], {k: v for k, v in e["data"].items() if k != "seconds"})
            for e in _mod(pkg, "observability.journal").journal().events(kinds=kinds)]


def _metric(reg, name):
    return reg.get(name).labels().value


# --- the policy -------------------------------------------------------------------


def _brute_force(pkg):
    a = _mod(pkg, "autoscale")
    policy = a.AutoscalePolicy(_cfg(pkg))
    out = []
    for burn in (None, 0.1, 0.5, 0.9, 1.0, 1.0001, 1.01, 1.5, 3.0, 50.0):
        for high_for in (0.0, 5.0, 15.0, 300.0):
            for drained_for in (0.0, 120.0, 100000.0):
                for predicted in (None, 0.1, 0.49, 1.2, 9.0):
                    for cooldown in (0.0, 10.0):
                        for in_flight in (False, True):
                            for ranks in (1, 2, 3, 4):
                                d = policy.decide(a.PlaneObservation(
                                    mono=1000.0, ranks=ranks, max_burn=burn, burn_high_for_s=high_for,
                                    drained_for_s=drained_for, predicted_burn=predicted,
                                    cooldown_remaining_s=cooldown, action_in_flight=in_flight))
                                if burn is not None and burn > 1.0:
                                    assert d.action != a.DOWN, (burn, d)
                                out.append(_d(d))
    return out


def test_policy_down_never_fires_under_burn_brute_force():
    got = _both(_brute_force)
    assert len(got) == 10 * 4 * 3 * 5 * 2 * 2 * 4
    assert {a for a, _t, _r in got} == {"hold", "up", "down"}


def _hand_picked(pkg):
    a = _mod(pkg, "autoscale")
    up = a.AutoscalePolicy(_cfg(pkg, up_window_s=15.0))
    down = a.AutoscalePolicy(_cfg(pkg, down_window_s=120.0, low_water=0.5))
    pinned = a.AutoscalePolicy(_cfg(pkg, min_ranks=2, max_ranks=2))
    obs = a.PlaneObservation
    hot = dict(max_burn=5.0, burn_high_for_s=1000.0)
    cases = [
        (up, obs(mono=0.0, ranks=1, max_burn=2.0, burn_high_for_s=5.0)),
        (up, obs(mono=0.0, ranks=1, max_burn=2.0, burn_high_for_s=15.0)),
        (up, obs(mono=0.0, ranks=1, max_burn=0.4, predicted_burn=1.3)),
        (down, obs(mono=0.0, ranks=2, max_burn=0.2, drained_for_s=60.0)),
        (down, obs(mono=0.0, ranks=2, max_burn=0.8, drained_for_s=500.0)),
        (down, obs(mono=0.0, ranks=2, max_burn=0.2, drained_for_s=130.0, predicted_burn=0.8)),
        (down, obs(mono=0.0, ranks=2, max_burn=0.2, drained_for_s=130.0, predicted_burn=1.4)),
        (down, obs(mono=0.0, ranks=2, max_burn=0.2, drained_for_s=130.0, predicted_burn=0.3)),
        (up, obs(mono=0.0, ranks=2, max_burn=None)),
        (up, obs(mono=0.0, ranks=2, cooldown_remaining_s=1.0, **hot)),
        (up, obs(mono=0.0, ranks=2, action_in_flight=True, **hot)),
        (up, obs(mono=0.0, ranks=4, **hot)),
        (up, obs(mono=0.0, ranks=1, max_burn=0.1, drained_for_s=1000.0)),
        (pinned, obs(mono=0.0, ranks=2, **hot)),
    ]
    return [_d(policy.decide(o)) for policy, o in cases]


def test_policy_hand_picked_observations():
    """The reference's sustained/forecast up, long-drain down, blind,
    cooldown, in-flight, bounds and pinned cases."""
    got = _both(_hand_picked)
    assert [a for a, _t, _r in got] == ["hold", "up", "up", "hold", "hold", "hold", "up", "down", "hold",
                                        "hold", "hold", "hold", "hold", "hold"]
    assert "predicted" in got[2][2] and got[7][1] == 1


def _config_from_env(pkg, monkeypatch):
    a = _mod(pkg, "autoscale")
    with monkeypatch.context() as m:
        for k, v in (("MIN_RANKS", "2"), ("MAX_RANKS", "8"), ("UP_WINDOW_S", "5"), ("LOW_WATER", "0.25"),
                     ("COOLDOWN_S", "-3"), ("STEP", "0")):
            m.setenv(f"PATHWAY_AUTOSCALE_{k}", v)
        first = a.AutoscaleConfig.from_env()
        m.setenv("PATHWAY_AUTOSCALE_MAX_RANKS", "lots")
        garbage = a.AutoscaleConfig.from_env()
    given = a.AutoscaleConfig.from_env({"PATHWAY_AUTOSCALE_LOW_WATER": "7"})
    return [tuple(vars(c).values()) for c in (first, garbage, given, a.AutoscaleConfig())]


def test_config_from_env(monkeypatch):
    first, garbage, given, default = _both(_config_from_env, monkeypatch)
    assert first[:3] == (2, 8, 5.0) and first[4] == 0.0 and first[5] == 0.25 and first[6] == 1
    assert garbage[1] == 4 and given[5] == 0.99 and default == (1, 4, 15.0, 120.0, 60.0, 0.5, 1, 30.0)


# --- the controller ---------------------------------------------------------------


def _controller(pkg, actuator, ranks, sampler, **kw):
    a = _mod(pkg, "autoscale")
    reg = _mod(pkg, "observability.registry").MetricsRegistry()
    return a.AutoscaleController(actuator, ranks=ranks, sampler=sampler, registry=reg, **kw), reg


def _sawtooth(pkg):
    a = _mod(pkg, "autoscale")
    sampler = _Sampler()
    ctrl, reg = _controller(pkg, a.CallbackActuator(lambda m: None), 2, sampler,
                            config=_cfg(pkg, up_window_s=15.0, down_window_s=120.0, cooldown_s=30.0))
    actions = []
    for s in range(600):
        sampler.burn = 1.6 if (s // 10) % 2 == 0 else 0.2
        actions.append(_d(ctrl.step(1000.0 + s)))
    return actions, ctrl.resizes, ctrl.ranks, _metric(reg, "pathway_autoscale_flaps_total")


def test_controller_sawtooth_never_flaps():
    _actions, resizes, ranks, flaps = _both(_sawtooth)
    assert resizes == 0 and ranks == 2 and flaps == 0.0


def _cooldown(pkg):
    a = _mod(pkg, "autoscale")
    ctrl, reg = _controller(pkg, a.CallbackActuator(lambda m: None), 1, _Sampler(burn=3.0),
                            config=_cfg(pkg, up_window_s=15.0, cooldown_s=30.0, max_ranks=4))
    sizes = []
    for s in range(200):
        ctrl.step(1000.0 + s)
        sizes.append(ctrl.ranks)
    return sizes, _metric(reg, "pathway_autoscale_cooldown_holds_total"), _journal(pkg)


def test_controller_cooldown_serializes_scale_ups():
    sizes, holds, events = _both(_cooldown)
    assert sizes[-1] == 4 and all(b - a in (0, 1) for a, b in zip(sizes, sizes[1:]))
    ups = [s for s, (a, b) in enumerate(zip(sizes, sizes[1:])) if b > a]
    assert all(b - a >= 30 for a, b in zip(ups, ups[1:])) and holds > 0
    assert [k for k, _d, _data in events] == ["autoscale-decision", "autoscale-applied"] * 3


def _rollback(pkg):
    a = _mod(pkg, "autoscale")

    def failing(m):
        raise RuntimeError("ferry died mid-transfer")

    ctrl, reg = _controller(pkg, a.CallbackActuator(failing), 1, _Sampler(burn=2.0),
                            config=_cfg(pkg, up_window_s=2.0, cooldown_s=60.0))
    for s in range(20):
        ctrl.step(1000.0 + s)
    return ctrl.ranks, ctrl.resizes, _metric(reg, "pathway_autoscale_rollbacks_total"), _journal(pkg)


def test_controller_rollback_journals_and_locks_out():
    """The failed resize is journaled and arms the cooldown: the burn stays
    high for 18 more seconds, and no second attempt is made."""
    ranks, resizes, rollbacks, events = _both(_rollback)
    assert ranks == 1 and resizes == 0 and rollbacks == 1.0
    assert [k for k, _d, _data in events] == ["autoscale-decision", "autoscale-rollback"]
    assert events[1][2]["from_ranks"] == 1 and events[1][2]["to_ranks"] == 2


def _rank_seconds(pkg):
    a = _mod(pkg, "autoscale")
    ctrl, reg = _controller(pkg, a.CallbackActuator(lambda m: None), 3, _Sampler(burn=0.6), config=_cfg(pkg))
    for s in range(11):
        ctrl.step(1000.0 + s)
    return _metric(reg, "pathway_autoscale_rank_seconds_total"), reg.get("pathway_autoscale_ranks").labels().current()


def test_controller_rank_seconds_integrates():
    rank_seconds, ranks = _both(_rank_seconds)
    assert rank_seconds == pytest.approx(30.0) and ranks == 3


# --- the forecaster -----------------------------------------------------------------


def _diurnal_burn(t: float, period: float = 240.0) -> float:
    return 0.2 + 1.1 * max(0.0, math.sin(2 * math.pi * t / period))


def _trend(pkg):
    f = _mod(pkg, "autoscale").LoadForecaster(tau_s=10.0)
    for s in range(120):
        f.observe(float(s), 0.2 + 0.005 * s)
    return f.forecast(60.0, 119.0), f.lead_crossing(1.0, 120.0, 119.0), f.state(), f.forecast(0.0)


def test_predictor_trend_leads_a_ramp():
    ahead, lead, _state, _now = _both(_trend)
    assert ahead > 0.2 + 0.005 * 119 + 0.15 and 0 < lead < 120.0


def _diurnal(pkg):
    period = 240.0
    f = _mod(pkg, "autoscale").LoadForecaster(tau_s=20.0, period_s=period, buckets=48)
    t = 0.0
    while t < 2 * period:
        f.observe(t, _diurnal_burn(t, period))
        t += 2.0
    now = 2 * period + 5.0
    return ([f.forecast(h, now) for h in (0.0, 10.0, 40.0, 400.0)], f.lead_crossing(1.0, 120.0, now),
            f.state())


def test_predictor_diurnal_profile_gives_lead_time():
    forecasts, lead, state = _both(_diurnal)
    assert _diurnal_burn(2 * 240.0 + 5.0) < 0.5 and forecasts[2] > 1.0 and lead is not None
    assert state["profile_coverage"] == 1.0


def _seeded(pkg):
    ring = _mod(pkg, "observability.signals").SignalRing(64)
    for s in range(32):
        ring.append(1000.0 + s, 100.0 + s, 0.1 * s)
    f = _mod(pkg, "autoscale").LoadForecaster(tau_s=5.0)
    f.seed(ring.points())
    return f.state(), _mod(pkg, "autoscale").LoadForecaster().forecast(10.0)


def test_predictor_seeds_from_signal_ring():
    state, empty = _both(_seeded)
    assert state["observations"] == 32 and abs(state["level"] - 3.1) < 0.5 and state["slope"] > 0
    assert empty is None


def _predictive(pkg):
    a = _mod(pkg, "autoscale")
    period = 240.0
    predictor = a.LoadForecaster(tau_s=20.0, period_s=period, buckets=48)
    for s in range(0, int(2 * period), 2):
        predictor.observe(float(s), _diurnal_burn(float(s), period))
    sampler = _Sampler()
    ctrl, _reg = _controller(pkg, a.CallbackActuator(lambda m: None), 1, sampler,
                             config=_cfg(pkg, up_window_s=15.0, cooldown_s=20.0, horizon_s=40.0),
                             predictor=predictor)
    up_at = None
    for s in range(int(2 * period), int(2 * period) + 120):
        sampler.burn = _diurnal_burn(float(s), period)
        if ctrl.step(float(s)).action == a.UP:
            up_at = (s, sampler.burn)
            break
    return up_at, _journal(pkg, ["autoscale-decision"]), ctrl.status()["predictor"]


def test_controller_predictive_scale_up_fires_before_the_surge():
    up_at, decisions, _pred = _both(_predictive)
    assert up_at is not None and up_at[1] < 1.0
    assert decisions[-1][2]["predicted_burn"] > 1.0 and decisions[-1][2]["max_burn"] < 1.0


# --- the plane doctor and the process-global controller -------------------------------


def _coverage(pkg, monkeypatch):
    a = _mod(pkg, "autoscale")
    run = _mod(pkg, "analysis.doctor").run_plane_doctor
    reg = _mod(pkg, "observability.registry").MetricsRegistry()

    def hits():
        return sorted((d.severity.name, d.message) for d in run(rules=["autoscale-coverage"])
                      .by_rule("autoscale-coverage"))

    out = []
    with monkeypatch.context() as m:
        m.setenv("PATHWAY_SERVING_SHARD_MAP", "127.0.0.1:9001|127.0.0.1:9002")
        out.append(hits())  # resizable, nothing armed
        a.arm_controller(a.CallbackActuator(lambda n: None), ranks=1, config=_cfg(pkg), registry=reg)
        out.append(hits())  # armed, but blind: no SLO target
        m.setenv("PATHWAY_SLO_SHED_RATE", "0.01")
        out.append(hits())  # armed and watching
        a.arm_controller(a.CallbackActuator(lambda n: None), ranks=2, config=_cfg(pkg, min_ranks=2, max_ranks=2),
                         registry=reg)
        out.append(hits())  # pinned
    return out


def test_autoscale_coverage_findings(monkeypatch):
    unwatched, blind, watched, pinned = _both(_coverage, monkeypatch)
    assert [s for s, _m in unwatched] == ["WARNING"] and "no Flux Pilot controller" in unwatched[0][1]
    assert [s for s, _m in blind] == ["WARNING"] and "zero PATHWAY_SLO_" in blind[0][1]
    assert watched == [] and [s for s, _m in pinned] == ["INFO"] and "pinned" in pinned[0][1]


def _arm_and_reset(pkg):
    a = _mod(pkg, "autoscale")
    before = a.get_controller()
    c = a.arm_controller(a.CallbackActuator(lambda m: None), ranks=1, config=_cfg(pkg),
                         registry=_mod(pkg, "observability.registry").MetricsRegistry())
    same = a.get_controller() is c
    st = c.status()
    a.reset_controller()
    return before, same, st, a.get_controller()


def test_arm_and_reset_global_controller():
    before, same, st, after = _both(_arm_and_reset)
    assert before is None and same and after is None
    assert st["armed"] and st["ranks"] == 1 and st["actuator"] == "callback" and not st["running"]


def _started(pkg):
    """``start()`` runs ``step`` on its own thread at the configured cadence
    until ``stop()``."""
    a = _mod(pkg, "autoscale")
    seen = []
    c = a.arm_controller(a.CallbackActuator(seen.append), ranks=1, start=True, interval_s=0.02,
                         config=_cfg(pkg, up_window_s=0.0, cooldown_s=1000.0), sampler=_Sampler(burn=2.0),
                         registry=_mod(pkg, "observability.registry").MetricsRegistry())
    deadline = time.monotonic() + 10
    while not seen and time.monotonic() < deadline:
        time.sleep(0.02)
    running = c.status()["running"]
    c.stop()
    return seen, running, c.status()["running"], c.ranks


def test_started_controller_steps_on_its_thread():
    seen, running, after, ranks = _both(_started)
    assert seen == [2] and running and not after and ranks == 2


# --- the e2e loop over a real store -------------------------------------------------------


def _e2e(pkg, tmp):
    from test_torch_elastic import COUNTS, WORDS, _arranged_rows, _persisted_wordcount, _write_words

    a = _mod(pkg, "autoscale")
    reshard_stores = _mod(pkg, "elastic.mesh").reshard_stores
    (tmp / "in").mkdir(parents=True)
    _write_words(tmp / "in" / "w.jsonl", WORDS)
    _persisted_wordcount(pkg, tmp, COUNTS)
    src = str(tmp / "pstorage")
    before = _arranged_rows(pkg, src)
    roots = {1: [src]}

    def resize(m: int) -> None:
        new = [str(tmp / f"r{m}_{i}") for i in range(m)]
        reshard_stores(roots[max(roots)], new, via_wire=False)
        roots[m] = new

    sampler = _Sampler()
    ctrl, reg = _controller(pkg, a.CallbackActuator(resize, label="reshard_stores"), 1, sampler,
                            config=_cfg(pkg, max_ranks=2, up_window_s=2.0, down_window_s=4.0, cooldown_s=1.0))
    trail = []
    t = 1000.0
    for burn, steps in ((3.0, 6), (0.1, 10)):
        sampler.burn = burn
        for _ in range(steps):
            trail.append(_d(ctrl.step(t)))
            t += 1.0
    ev = _mod(pkg, "observability.journal").journal().events(
        kinds=["autoscale-decision", "autoscale-applied", "autoscale-rollback"])
    assert ev[1]["data"]["seconds"] > 0
    commits = _mod(pkg, "observability.journal").journal().events(kinds=["reshard-commit"])
    assert len(commits) == 2 and all(c["data"]["transfer_seconds"] > 0 for c in commits)
    after = _arranged_rows(pkg, roots[1][0])
    assert after == before
    return (trail, ctrl.ranks, ctrl.resizes, _journal(pkg, ["autoscale-decision", "autoscale-applied",
                                                            "autoscale-rollback"]),
            _metric(reg, "pathway_autoscale_rollbacks_total"), sorted(after.items()))


def test_autoscale_e2e_resizes_real_store_and_preserves_state(tmp_path):
    """A surge scales the store 1 → 2 through ``reshard_stores``, the drain
    scales it 2 → 1; both transitions are journaled (decision before
    applied, no rollback) and the final store holds the original rows."""
    trail, ranks, resizes, events, rollbacks, _rows = _both(lambda pkg: _e2e(pkg, tmp_path / pkg))
    assert ranks == 1 and resizes == 2 and rollbacks == 0
    assert [k for k, _d, _data in events] == ["autoscale-decision", "autoscale-applied"] * 2
    assert [data["action"] for _k, _d, data in events] == ["up", "up", "down", "down"]
