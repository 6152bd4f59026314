"""``pathway_tpu/cli.py`` (``spawn`` of a process group, ``--supervise``) is
not ported: ``main`` raises ``NotImplementedError`` naming [mesh], and so
does ``python -m pathway_tpu_torch.cli``."""

from __future__ import annotations

import sys

from pathway_tpu_torch._unported import MESH, unported


def main(argv: list[str] | None = None) -> int:
    raise unported("pathway_tpu_torch.cli (spawn, supervise)", MESH)


if __name__ == "__main__":
    sys.exit(main())
