"""``pw.stdlib.utils`` — the port's own copy of
``pathway_tpu/stdlib/utils/__init__.py``, whole: ``col``, ``filtering`` and
``AsyncTransformer``. Importing it loads no pandas."""

from pathway_tpu_torch.stdlib.utils import col, filtering
from pathway_tpu_torch.stdlib.utils.async_transformer import AsyncTransformer

__all__ = ["col", "filtering", "AsyncTransformer"]
