"""Standard library of the port — counterpart of ``pathway_tpu/stdlib``,
every subpackage of the reference, loaded lazily as in the reference."""

import importlib

__all__ = [
    "graphs",
    "indexing",
    "ml",
    "ordered",
    "stateful",
    "statistical",
    "temporal",
    "utils",
    "viz",
]


def __getattr__(name: str):
    if name in __all__:
        module = importlib.import_module(f"pathway_tpu_torch.stdlib.{name}")
        globals()[name] = module
        return module
    raise AttributeError(name)
