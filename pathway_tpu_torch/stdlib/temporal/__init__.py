"""``pw.temporal`` — the port's own copy of
``pathway_tpu/stdlib/temporal/__init__.py``: windows, behaviors and the
interval, asof, asof-now and window joins, each submodule loaded on first
use."""

import importlib

__all__ = [
    "Interval",
    "IntervalJoinResult",
    "WindowJoinResult",
    "AsofJoinResult",
    "AsofNowJoinResult",
    "windowby",
    "tumbling",
    "sliding",
    "session",
    "intervals_over",
    "Window",
    "interval",
    "interval_join",
    "interval_join_inner",
    "interval_join_left",
    "interval_join_right",
    "interval_join_outer",
    "window_join",
    "window_join_inner",
    "window_join_left",
    "window_join_right",
    "window_join_outer",
    "asof_join",
    "asof_join_left",
    "asof_join_right",
    "asof_join_outer",
    "asof_now_join",
    "asof_now_join_inner",
    "asof_now_join_left",
    "common_behavior",
    "exactly_once_behavior",
    "CommonBehavior",
    "ExactlyOnceBehavior",
    "Direction",
    "utils",
    "utc_now",
    "inactivity_detection",
    "TimestampSchema",
]

_locations = {
    "Interval": "_interval_join",
    "IntervalJoinResult": "_interval_join",
    "WindowJoinResult": "_window_join",
    "AsofJoinResult": "_asof_join",
    "AsofNowJoinResult": "_asof_now_join",
    "windowby": "_window",
    "tumbling": "_window",
    "sliding": "_window",
    "session": "_window",
    "intervals_over": "_window",
    "Window": "_window",
    "interval": "_interval_join",
    "interval_join": "_interval_join",
    "interval_join_inner": "_interval_join",
    "interval_join_left": "_interval_join",
    "interval_join_right": "_interval_join",
    "interval_join_outer": "_interval_join",
    "window_join": "_window_join",
    "window_join_inner": "_window_join",
    "window_join_left": "_window_join",
    "window_join_right": "_window_join",
    "window_join_outer": "_window_join",
    "asof_join": "_asof_join",
    "asof_join_left": "_asof_join",
    "asof_join_right": "_asof_join",
    "asof_join_outer": "_asof_join",
    "asof_now_join": "_asof_now_join",
    "asof_now_join_inner": "_asof_now_join",
    "asof_now_join_left": "_asof_now_join",
    "common_behavior": "temporal_behavior",
    "exactly_once_behavior": "temporal_behavior",
    "CommonBehavior": "temporal_behavior",
    "ExactlyOnceBehavior": "temporal_behavior",
    "Direction": "_asof_join",
}


def __getattr__(name: str):
    if name in ("utils", "time_utils"):
        mod = importlib.import_module(f"pathway_tpu_torch.stdlib.temporal.{name}")
        globals()[name] = mod
        return mod
    if name in ("utc_now", "inactivity_detection", "TimestampSchema"):
        mod = importlib.import_module(
            "pathway_tpu_torch.stdlib.temporal.time_utils"
        )
        obj = getattr(mod, name)
        globals()[name] = obj
        return obj
    if name in _locations:
        mod = importlib.import_module(
            f"pathway_tpu_torch.stdlib.temporal.{_locations[name]}"
        )
        obj = getattr(mod, name)
        globals()[name] = obj
        return obj
    raise AttributeError(name)
