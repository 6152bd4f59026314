"""Own copy of ``pathway_tpu/io/redpanda.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.redpanda — Redpanda speaks the Kafka protocol; same connector
(upstream Pathway: python/pathway/io/redpanda wraps io/kafka)."""

from pathway_tpu_torch.io.kafka import read, write

__all__ = ["read", "write"]
