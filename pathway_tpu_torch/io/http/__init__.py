"""pw.io.http — REST ingress/egress, the port's copy of
``pathway_tpu/io/http`` (``rest_connector``, ``PathwayWebserver``, ``read``,
``write``). The server runs on the standard library (``_web.py``); the
clients import ``requests`` only when they send."""

from pathway_tpu_torch.io.http._server import (
    EndpointDocumentation,
    EndpointExamples,
    PathwayWebserver,
    rest_connector,
)
from pathway_tpu_torch.io.http._client import read, write

__all__ = [
    "PathwayWebserver",
    "rest_connector",
    "read",
    "write",
    "EndpointDocumentation",
    "EndpointExamples",
]
