"""pw.stdlib.ml — counterpart of ``pathway_tpu/stdlib/ml``: ``KNNIndex`` and
``utils``. The LSH classifiers, the fuzzy join (``smart_table_ops``),
``hmm`` and ``datasets`` raise ``NotImplementedError`` naming ROADMAP
[ml-rest]."""

from pathway_tpu_torch._unported import ML_REST, unported
from pathway_tpu_torch.stdlib.ml import index
from pathway_tpu_torch.stdlib.ml.index import KNNIndex

__all__ = ["index", "KNNIndex", "utils"]


def __getattr__(name: str):
    import importlib

    if name == "utils":
        return importlib.import_module("pathway_tpu_torch.stdlib.ml.utils")
    if name in ("classifiers", "smart_table_ops", "hmm", "datasets"):
        raise unported(f"pw.stdlib.ml.{name}", ML_REST)
    raise AttributeError(name)
