"""Own copy of ``pathway_tpu/io/minio.py``: the same row keys, offsets and
written rows, so stores and outputs cross the two packages.

pw.io.minio — MinIO is S3-compatible; same scanner with a custom
endpoint (upstream Pathway: python/pathway/io/minio wraps io/s3)."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io.s3 import AwsS3Settings, read as _s3_read


class MinIOSettings:
    def __init__(
        self,
        endpoint: str,
        bucket_name: str,
        access_key: str,
        secret_access_key: str,
        *,
        with_path_style: bool = True,
        region: str | None = None,
        **kwargs: Any,
    ):
        self.endpoint = endpoint
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region

    def create_aws_settings(self) -> AwsS3Settings:
        return AwsS3Settings(
            bucket_name=self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            region=self.region,
            endpoint=self.endpoint,
            with_path_style=self.with_path_style,
        )


def read(
    path: str,
    minio_settings: MinIOSettings,
    *,
    format: str = "csv",
    schema: Any = None,
    mode: str = "streaming",
    **kwargs: Any,
):
    return _s3_read(
        path,
        aws_s3_settings=minio_settings.create_aws_settings(),
        format=format,
        schema=schema,
        mode=mode,
        **kwargs,
    )
