"""Expression namespaces (``.num``, ``.str``, ``.bin``) — counterpart of
``pathway_tpu/internals/expressions``. ``expression.py`` imports each
submodule when its namespace is first used. The ``.dt`` namespace is not
ported: it and ``DateTimeNamespace`` raise naming [temporal]."""

from pathway_tpu_torch._unported import TEMPORAL, package_getattr
from pathway_tpu_torch.internals.expressions.numerical import NumericalNamespace
from pathway_tpu_torch.internals.expressions.string import BytesNamespace, StringNamespace

__getattr__ = package_getattr(
    "pathway_tpu_torch.internals.expressions", {"DateTimeNamespace": TEMPORAL}
)

__all__ = ["NumericalNamespace", "StringNamespace", "BytesNamespace"]
