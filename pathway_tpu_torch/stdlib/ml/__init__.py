"""pw.stdlib.ml — counterpart of ``pathway_tpu/stdlib/ml``: ``KNNIndex``
and, loaded on first use as in the reference, ``classifiers``,
``smart_table_ops``, ``utils``, ``hmm`` and ``datasets``."""

from pathway_tpu_torch.stdlib.ml import index
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

__all__ = ["index", "KNNIndex", "classifiers", "smart_table_ops", "utils"]


def __getattr__(name: str):
    import importlib

    if name in ("classifiers", "smart_table_ops", "utils", "hmm", "datasets"):
        return importlib.import_module(f"pathway_tpu_torch.stdlib.ml.{name}")
    raise AttributeError(name)
