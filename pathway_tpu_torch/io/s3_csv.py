"""Own copy of ``pathway_tpu/io/s3_csv.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.s3_csv — CSV-over-S3 convenience wrapper
(upstream Pathway: python/pathway/io/s3_csv wraps io/s3 with format=csv)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io.s3 import AwsS3Settings, read as _s3_read


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    schema: Any = None,
    mode: str = "streaming",
    **kwargs: Any,
):
    return _s3_read(
        path,
        aws_s3_settings=aws_s3_settings,
        format="csv",
        schema=schema,
        mode=mode,
        **kwargs,
    )
