"""Expression namespaces (``.dt``, ``.num``, ``.str``, ``.bin``) — counterpart of
``pathway_tpu/internals/expressions``. ``expression.py`` imports each
submodule when its namespace is first used; ``date_time`` imports pandas
only when a ``.dt`` method computes on a value."""

from pathway_tpu_torch.internals.expressions.date_time import DateTimeNamespace
from pathway_tpu_torch.internals.expressions.numerical import NumericalNamespace
from pathway_tpu_torch.internals.expressions.string import BytesNamespace, StringNamespace

__all__ = [
    "DateTimeNamespace",
    "NumericalNamespace",
    "StringNamespace",
    "BytesNamespace",
]
