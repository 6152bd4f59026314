"""The port's own copy of ``pathway_tpu/stdlib/temporal/time_utils.py``. Wall-clock helper streams: utc_now + inactivity detection
(reference: python/pathway/stdlib/temporal/time_utils.py). Both build
``DateTimeUtc`` values, which need pandas: they run on the CPU only where
pandas is missing, as on the card's machine."""

from __future__ import annotations

import datetime
import time
from functools import cache

from pathway_tpu_torch import io
from pathway_tpu_torch.internals import schema as schema_mod
from pathway_tpu_torch.internals.datetime_types import DateTimeUtc


class TimestampSchema(schema_mod.Schema):
    timestamp_utc: DateTimeUtc


class TimestampSubject(io.python.ConnectorSubject):
    def __init__(self, refresh_rate: datetime.timedelta) -> None:
        super().__init__()
        self._refresh_rate = refresh_rate

    def run(self) -> None:
        while not getattr(self, "_stop_requested", False):
            now_utc = DateTimeUtc.from_datetime(
                datetime.datetime.now(datetime.timezone.utc)
            )
            self.next(timestamp_utc=now_utc)
            self.commit()
            time.sleep(self._refresh_rate.total_seconds())


@cache
def utc_now(refresh_rate: datetime.timedelta = datetime.timedelta(seconds=60)):
    """A live table with a single stream of current-UTC-timestamp rows,
    refreshed every `refresh_rate`."""
    return io.python.read(
        TimestampSubject(refresh_rate=refresh_rate),
        schema=TimestampSchema,
    )


def inactivity_detection(
    event_time_column,
    allowed_inactivity_period: datetime.timedelta,
    refresh_rate: datetime.timedelta = datetime.timedelta(seconds=1),
    instance=None,
):
    """Detect periods with no events: returns `(inactivities,
    resumed_activities)` — `inactive_t` marks the last timestamp before an
    inactivity longer than `allowed_inactivity_period` (per `instance` if
    given), `resumed_t` the first event after it (reference:
    stdlib/temporal/time_utils.py inactivity_detection)."""
    import pathway_tpu_torch as pw

    events_t = event_time_column.table.select(
        t=event_time_column, instance=instance
    )

    now_t = utc_now(refresh_rate=refresh_rate)
    latest_t = (
        events_t.groupby(pw.this.instance)
        .reduce(pw.this.instance, latest_t=pw.reducers.max(pw.this.t))
        .filter(
            pw.this.latest_t
            > DateTimeUtc.from_datetime(
                datetime.datetime.now(datetime.timezone.utc)
            )
        )  # filter to avoid alerts during backfilling
    )
    inactivities = (
        now_t.asof_now_join(latest_t)
        .select(pw.left.timestamp_utc, pw.right.instance, pw.right.latest_t)
        .filter(
            pw.this.latest_t + allowed_inactivity_period
            < pw.this.timestamp_utc
        )
        .groupby(pw.this.latest_t, pw.this.instance)
        .reduce(pw.this.latest_t, pw.this.instance)
        .select(instance=pw.this.instance, inactive_t=pw.this.latest_t)
    )

    latest_inactivity = inactivities.groupby(pw.this.instance).reduce(
        pw.this.instance, inactive_t=pw.reducers.latest(pw.this.inactive_t)
    )
    resumed_activities = (
        events_t.asof_now_join(
            latest_inactivity, events_t.instance == latest_inactivity.instance
        )
        .select(pw.left.t, pw.left.instance, pw.right.inactive_t)
        .groupby(pw.this.inactive_t, pw.this.instance)
        .reduce(pw.this.instance, resumed_t=pw.reducers.min(pw.this.t))
    )
    if instance is None:
        inactivities = inactivities.without("instance")
        resumed_activities = resumed_activities.without("instance")
    return inactivities, resumed_activities
