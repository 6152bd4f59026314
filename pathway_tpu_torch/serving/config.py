"""Serving QoS configuration — counterpart of ``pathway_tpu/serving/config.py``
(own copy: the port imports nothing of the JAX package).

One ``QoSConfig`` describes the serving QoS policy of one endpoint: how many
requests may queue, how they batch, what deadline budget they carry and how
overload is shed. Every knob has a ``PATHWAY_SERVING_*`` environment override
(``QoSConfig.from_env``); ``PATHWAY_SERVING_ENABLED=1`` puts every REST
endpoint without an explicit ``qos=`` behind the gate.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields, replace

_ENV_PREFIX = "PATHWAY_SERVING_"

# env var name -> (dataclass field, parser)
_ENV_FIELDS = {
    "MAX_QUEUE": ("max_queue", int),
    "MAX_BATCH": ("max_batch_size", int),
    "MAX_WAIT_MS": ("max_wait_ms", float),
    "DEADLINE_MS": ("default_deadline_ms", float),
    "MAX_DEADLINE_MS": ("max_deadline_ms", float),
    "RPS": ("rate_limit_rps", float),
    "BURST": ("rate_limit_burst", float),
    "MAX_INFLIGHT": ("max_inflight", int),
    "MAX_DISPATCHED": ("max_dispatched", int),
    "PRIORITY": ("priority", str),
    "DRAIN_GRACE_S": ("drain_grace_s", float),
}

# only these may be cleared back to None with an empty env value
# (`PATHWAY_SERVING_RPS=`); for mandatory knobs an empty string means
# "no override", matching an unset variable
_NONEABLE_FIELDS = frozenset(
    ("rate_limit_rps", "rate_limit_burst", "max_inflight", "max_dispatched")
)


def serving_enabled_via_env() -> bool:
    """``PATHWAY_SERVING_ENABLED=1`` turns the gate on for every
    rest_connector that was not given an explicit ``qos=``."""
    return os.environ.get(_ENV_PREFIX + "ENABLED", "0").lower() in (
        "1",
        "true",
        "yes",
    )


def plane_knobs() -> dict[str, str]:
    """Snapshot of every ``PATHWAY_*`` knob set in this environment —
    the serving plane's metadata hook for static verification (the
    reference's Plane Doctor lints this surface and records it beside
    its findings)."""
    return {
        k: v
        for k, v in sorted(os.environ.items())
        if k.startswith("PATHWAY_")
    }


def default_bucket_ladder(max_batch_size: int) -> tuple[int, ...]:
    """Power-of-two ladder capped at ``max_batch_size`` — the pad
    ladder a released batch (or a decode step) is padded up to."""
    ladder: list[int] = []
    b = 1
    while b < max_batch_size:
        ladder.append(b)
        b *= 2
    ladder.append(int(max_batch_size))
    return tuple(ladder)


@dataclass(frozen=True)
class QoSConfig:
    """Serving QoS policy for one REST endpoint.

    max_queue: admission bound — requests queued (admitted, not yet
        dispatched into the engine) beyond this shed with 429.
    max_batch_size / max_wait_ms: micro-batcher flush triggers — release
        a batch when this many requests coalesced, or when the oldest
        queued request has waited this long.
    batch_buckets: ladder of release sizes; ``None`` derives the
        power-of-two ladder from max_batch_size.
    default_deadline_ms / max_deadline_ms: deadline budget applied when
        the ``x-pathway-deadline-ms`` header is absent / the cap clamped
        onto client-supplied budgets.
    rate_limit_rps / rate_limit_burst: endpoint token bucket (None = no
        rate limit; burst defaults to max(rps, 1)).
    max_inflight: cap on requests concurrently in flight for this
        endpoint (queued + dispatched, until their response is sent).
    max_dispatched: pipeline-depth window — the batcher releases a new
        batch only while fewer than this many dispatched requests await
        their response, so a slow engine backs pressure up into the
        BOUNDED queue (where it sheds) instead of the unbounded
        InputSession. ``None`` derives ``2 * max_batch_size``.
    priority: "interactive" marks the gate's InputSession so the engine
        tick prefers it over bulk ingest sessions; "bulk" opts out.
    drain_grace_s: how long ``drain()`` waits for in-flight requests
        before giving up and shutting the webserver anyway.
    """

    max_queue: int = 256
    max_batch_size: int = 32
    max_wait_ms: float = 5.0
    batch_buckets: tuple[int, ...] | None = None
    default_deadline_ms: float = 30_000.0
    max_deadline_ms: float = 120_000.0
    rate_limit_rps: float | None = None
    rate_limit_burst: float | None = None
    max_inflight: int | None = None
    max_dispatched: int | None = None
    priority: str = "interactive"
    drain_grace_s: float = 10.0

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if self.priority not in ("interactive", "bulk"):
            raise ValueError("priority must be 'interactive' or 'bulk'")
        if self.batch_buckets is not None:
            bb = tuple(sorted(int(b) for b in self.batch_buckets))
            if not bb or bb[0] < 1:
                raise ValueError("batch_buckets must be positive ints")
            object.__setattr__(self, "batch_buckets", bb)

    def buckets(self) -> tuple[int, ...]:
        return self.batch_buckets or default_bucket_ladder(
            self.max_batch_size
        )

    def bucket_for(self, n: int) -> int:
        """Smallest ladder entry >= n (the shape a batch of n pads to);
        the top rung for oversized n."""
        for b in self.buckets():
            if b >= n:
                return b
        return self.buckets()[-1]

    def dispatch_window(self) -> int:
        if self.max_dispatched is not None:
            return max(int(self.max_dispatched), 1)
        return 2 * self.max_batch_size

    def burst(self) -> float:
        if self.rate_limit_burst is not None:
            return float(self.rate_limit_burst)
        return max(float(self.rate_limit_rps or 0.0), 1.0)

    @classmethod
    def from_env(cls, base: "QoSConfig | None" = None) -> "QoSConfig":
        """``base`` (default: all-defaults config) overridden by any
        ``PATHWAY_SERVING_*`` variables present in the environment."""
        cfg = base if base is not None else cls()
        overrides = {}
        valid = {f.name for f in fields(cls)}
        for env_name, (field_name, parser) in _ENV_FIELDS.items():
            raw = os.environ.get(_ENV_PREFIX + env_name)
            if raw is None or field_name not in valid:
                continue
            if raw == "":
                if field_name in _NONEABLE_FIELDS:
                    overrides[field_name] = None
                continue
            try:
                overrides[field_name] = parser(raw)
            except ValueError:
                raise ValueError(
                    f"{_ENV_PREFIX}{env_name}={raw!r} is not a valid "
                    f"{parser.__name__}"
                ) from None
        return replace(cfg, **overrides) if overrides else cfg
