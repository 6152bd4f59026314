"""The ``.dt`` namespace of the port (``DateTimeNamespace``) and its
rendering of datetimes against the JAX package's: every method over naive
and UTC datetimes, durations and numbers parsed from the same seeded
strings, one graph under both packages, the update streams pinned (keys,
diffs, times and values exact; floats within ``FLOAT_TOL``). The
datetimes span 1960 to 2123 with nanosecond parts, around a DST change
in Europe/Warsaw; a method called on a column of the wrong type is
refused alike. ``.dt`` needs pandas, so it runs on the CPU only where
pandas is missing, as on the card's machine. The JAX side runs with
``PATHWAY_COMPILED_TICK=0``."""

import datetime

import numpy as np
import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.internals import parse_graph as port_parse_graph
from torch_parity import assert_outcomes_equal, assert_streams_equal, markdown, outcomes, streams

PACKAGES = {"jax": jpw, "port": tpw}
FMT = "%Y-%m-%dT%H:%M:%S.%f"


@pytest.fixture(autouse=True)
def _fresh_graphs(monkeypatch):
    monkeypatch.setenv("PATHWAY_COMPILED_TICK", "0")
    port_parse_graph.G.clear()
    yield
    port_parse_graph.G.clear()


def _stamps(seed, n=24):
    """Seeded datetime strings with nanoseconds, the fixed ones of the
    reference's suite first (leap day, DST night, far past and future)."""
    fixed = ["1960-02-03T08:00:00.123456789", "2008-02-29T08:00:00.000000000",
             "2023-03-26T01:59:59.999999999", "2023-03-26T02:30:00.000000001",
             "2023-10-29T02:30:00.500000000", "2123-03-31T23:00:00.000000001"]
    rng = np.random.default_rng(seed)
    base = datetime.datetime(1990, 1, 1)
    out = list(fixed)
    for _ in range(n - len(fixed)):
        d = base + datetime.timedelta(seconds=int(rng.integers(0, 60 * 365 * 86400)))
        out.append(d.strftime("%Y-%m-%dT%H:%M:%S") + f".{int(rng.integers(0, 10**9)):09d}")
    return out


def _table(pw, seed=71, utc=False):
    rng = np.random.default_rng(seed + 1)
    stamps = _stamps(seed)
    rows = []
    for i, s in enumerate(stamps):
        other = stamps[(i * 7 + 3) % len(stamps)]
        suffix = ["+00:00", "-02:00", "+05:30"][i % 3] if utc else ""
        rows.append((i + 1, s + suffix, other + suffix, int(rng.integers(-10**6, 10**6)),
                     float(rng.normal() * 1e4), 2 + 2 * (i % 3), 1))
    t = pw.debug.table_from_markdown(markdown(["s", "o", "n", "x"], rows))
    fmt = FMT + ("%z" if utc else "")
    return t.with_columns(a=t.s.dt.strptime(fmt), b=t.o.dt.strptime(fmt))


FIELDS = ["nanosecond", "microsecond", "millisecond", "second", "minute", "hour", "day", "month",
          "year", "weekday"]


@pytest.mark.parametrize("utc", [False, True])
@pytest.mark.parametrize("field", FIELDS)
def test_field(field, utc):
    def build(pw):
        t = _table(pw, utc=utc)
        return t.select(v=getattr(t.a.dt, field)())

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want)


@pytest.mark.parametrize("utc", [False, True])
@pytest.mark.parametrize("unit", ["ns", "us", "ms", "s"])
def test_timestamp(unit, utc):
    def build(pw):
        t = _table(pw, utc=utc)
        return t.select(v=t.a.dt.timestamp(unit=unit))

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want)


def test_timestamp_without_unit_warns_alike():
    for pw in PACKAGES.values():
        t = _table(pw)
        with pytest.deprecated_call():
            t.select(v=t.a.dt.timestamp())


STRFTIME = ["%Y-%m-%d %H:%M:%S", "%a %A %w %d %b %B %m %y", "%H %I %p %M %S", "%f", "%3f|%6f|%9f",
            "%j %U %W", "%Y-%m-%dT%H:%M:%S.%f", "%%Y %%f", "%s"]


@pytest.mark.parametrize("utc", [False, True])
@pytest.mark.parametrize("fmt", STRFTIME)
def test_strftime(fmt, utc):
    def build(pw):
        t = _table(pw, utc=utc)
        return t.select(v=t.a.dt.strftime(fmt + (" %z" if utc else "")))

    got, want = outcomes(PACKAGES, build)
    assert_outcomes_equal(got, want)


@pytest.mark.parametrize("case", ["naive_dot_f", "naive_3f", "utc_z", "utc_colon_z", "wrong_format",
                                  "bare_f", "utc_declared_no_offset"])
def test_strptime(case):
    def build(pw):
        if case == "naive_dot_f":
            data, fmt = ["2023-03-25 16:43:21.000123", "1960-02-03 08:00:00.5"], "%Y-%m-%d %H:%M:%S.%f"
        elif case == "naive_3f":
            data, fmt = ["2023-03-25T16:43:21.123", "2008-02-29T00:00:00.999"], "%Y-%m-%dT%H:%M:%S.%3f"
        elif case == "utc_z":
            data, fmt = ["2023-03-25 16:43:21+0200", "1999-12-31 23:59:59-0130"], "%Y-%m-%d %H:%M:%S%z"
        elif case == "utc_colon_z":
            data, fmt = ["2023-03-25T16:43:21+02:00", "2000-01-01T00:00:00-05:00"], "%Y-%m-%dT%H:%M:%S%:z"
        elif case == "wrong_format":
            data, fmt = ["2023/03/25"], "%Y-%m-%d"
        elif case == "bare_f":
            data, fmt = ["2023-03-25 16:43:21 123"], "%Y-%m-%d %H:%M:%S %f"
        else:
            data, fmt = ["2023-03-25 16:43:21"], "%Y-%m-%d %H:%M:%S"
        rows = [(i + 1, d.replace(" ", "_"), 2, 1) for i, d in enumerate(data)]
        t = pw.debug.table_from_markdown(markdown(["s"], rows))
        t = t.select(s=pw.apply(lambda s: s.replace("_", " "), t.s))
        kw = {"contains_timezone": True} if case == "utc_declared_no_offset" else {}
        return t.select(v=t.s.dt.strptime(fmt, **kw))

    got, want = outcomes(PACKAGES, build, terminate_on_error=False)
    assert_outcomes_equal(got, want)


ZONES = ["Europe/Warsaw", "America/New_York", "Asia/Kolkata", "UTC"]


@pytest.mark.parametrize("zone", ZONES)
@pytest.mark.parametrize("op", ["to_utc", "to_naive_in_timezone", "add_duration_in_timezone",
                                "subtract_duration_in_timezone", "subtract_date_time_in_timezone"])
def test_timezone_method(op, zone):
    def build(pw):
        t = _table(pw, utc=op == "to_naive_in_timezone")
        d = datetime.timedelta(hours=3, minutes=17)
        if op == "to_utc":
            v = t.a.dt.to_utc(from_timezone=zone)
        elif op == "to_naive_in_timezone":
            v = t.a.dt.to_naive_in_timezone(timezone=zone)
        elif op == "add_duration_in_timezone":
            v = t.a.dt.add_duration_in_timezone(d, timezone=zone)
        elif op == "subtract_duration_in_timezone":
            v = t.a.dt.subtract_duration_in_timezone(d, timezone=zone)
        else:
            v = t.a.dt.subtract_date_time_in_timezone(t.b, timezone=zone)
        return t.select(v=v)

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want)


PERIODS = {"td_90s": datetime.timedelta(seconds=90), "td_1ms": datetime.timedelta(milliseconds=1),
           "h": "h", "D": "D", "2h3min": "2h3min", "s": "s"}


@pytest.mark.parametrize("utc", [False, True])
@pytest.mark.parametrize("period", list(PERIODS))
@pytest.mark.parametrize("method", ["round", "floor"])
def test_round_and_floor(method, period, utc):
    def build(pw):
        t = _table(pw, utc=utc)
        return t.select(v=getattr(t.a.dt, method)(PERIODS[period]))

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want)


DURATION_FIELDS = ["nanoseconds", "microseconds", "milliseconds", "seconds", "minutes", "hours", "days",
                   "weeks"]


@pytest.mark.parametrize("field", DURATION_FIELDS)
def test_duration_field(field):
    def build(pw):
        t = _table(pw)
        return t.select(d=getattr((t.a - t.b).dt, field)(), e=getattr((t.b - t.a).dt, field)())

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want)


@pytest.mark.parametrize("col", ["n", "x"])
@pytest.mark.parametrize("unit", ["W", "D", "days", "h", "hours", "m", "min", "s", "sec", "ms",
                                  "us", "ns", "nanos", "fortnight"])
def test_to_duration(unit, col):
    def build(pw):
        t = _table(pw)
        num = t.n // 100 if col == "n" else t.x  # weeks of the ints stay inside int64 nanoseconds
        return t.select(v=num.dt.to_duration(unit), w=(t.a + num.dt.to_duration(unit)))

    got, want = outcomes(PACKAGES, build, terminate_on_error=False)
    assert_outcomes_equal(got, want)


@pytest.mark.parametrize("utc", [False, True])
@pytest.mark.parametrize("unit", ["ns", "us", "ms", "s"])
def test_from_timestamp(unit, utc):
    def build(pw):
        t = _table(pw)
        num = t.n * 1_000_003 if unit in ("ns", "us") else t.n
        if utc:
            return t.select(v=num.dt.utc_from_timestamp(unit=unit), f=t.x.dt.utc_from_timestamp(unit=unit))
        return t.select(v=num.dt.from_timestamp(unit=unit), f=t.x.dt.from_timestamp(unit=unit))

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want)


@pytest.mark.parametrize("call", ["year_of_int", "to_duration_of_datetime", "strptime_of_int",
                                  "to_utc_of_utc", "seconds_of_datetime"])
def test_wrong_type_is_refused_alike(call):
    def build(pw):
        t = _table(pw)
        v = {
            "year_of_int": lambda: t.n.dt.year(),
            "to_duration_of_datetime": lambda: t.a.dt.to_duration("s"),
            "strptime_of_int": lambda: t.n.dt.strptime("%Y"),
            "to_utc_of_utc": lambda: t.a.dt.to_utc("UTC").dt.to_utc("UTC"),
            "seconds_of_datetime": lambda: t.a.dt.seconds(),
        }[call]()
        return t.select(v=v)

    got, want = outcomes(PACKAGES, build)
    assert isinstance(want, tuple), want
    assert_outcomes_equal(got, want)


@pytest.mark.parametrize("utc", [False, True])
def test_datetimes_render_as_the_reference_does(utc):
    """to_string and a cast to str render a datetime T-separated with 9
    nanosecond digits (and +0000 when aware); arithmetic and comparisons
    with durations stay datetimes."""

    def build(pw):
        t = _table(pw, utc=utc)
        late = t.a + datetime.timedelta(days=1, microseconds=7)
        return t.select(
            s=t.a.to_string(),
            c=pw.cast(str, t.a),
            d=(t.a - t.b).to_string(),
            later=late,
            before=t.a < t.b,
            gap=late - t.a,
        )

    got, want = streams(PACKAGES, build)
    assert_streams_equal(got, want)
