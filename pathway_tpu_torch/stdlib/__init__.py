"""Standard library of the port — counterpart of ``pathway_tpu/stdlib``:
``indexing``, ``ml``, ``ordered``, ``stateful``, ``statistical``,
``temporal`` and ``utils`` so far, loaded lazily as in the reference. Every
other subpackage of the reference raises ``NotImplementedError`` naming its
ROADMAP item."""

import importlib

from pathway_tpu_torch._unported import STDLIB_NAMES, unported

__all__ = ["indexing", "ml", "ordered", "stateful", "statistical", "temporal", "utils"]


def __getattr__(name: str):
    if name in __all__:
        module = importlib.import_module(f"pathway_tpu_torch.stdlib.{name}")
        globals()[name] = module
        return module
    if name in STDLIB_NAMES:
        raise unported(f"pw.stdlib.{name}", STDLIB_NAMES[name])
    raise AttributeError(name)
