"""Pickles that both packages read: the persistence store's input-log
chunks, offsets, state blobs, GroupBy ledger blobs and the object columns of
segment files.

A pickle names every class by module. The port's classes sit under
``pathway_tpu_torch.<path>`` where ``pathway_tpu`` has the same class under
``pathway_tpu.<path>``, and the port never imports ``pathway_tpu``. So:

* :func:`dumps` writes each class or function of this package as
  ``getattr(importlib.import_module("pathway_tpu.<path>"), name)``. A plain
  ``pickle.loads`` in the JAX package then builds its own objects; the port
  never imports the module it names.
* :func:`loads` reads both forms: it maps a ``pathway_tpu.<path>`` global
  (a store the JAX package wrote) and the ``import_module`` call above (a
  store this package wrote) onto ``pathway_tpu_torch.<path>``.

Everything else pickles and loads as the standard library does.
"""

from __future__ import annotations

import importlib
import io
import pickle
import types
from typing import Any

_PORT = "pathway_tpu_torch"
_REF = "pathway_tpu"


def _swap(module: str, src: str, dst: str) -> str | None:
    if module == src or module.startswith(src + "."):
        return dst + module[len(src) :]
    return None


class _ModuleRef:
    """Pickles as ``importlib.import_module(name)``."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __reduce__(self):
        return importlib.import_module, (self.name,)


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj: Any):
        if isinstance(obj, (type, types.FunctionType)):
            qual = getattr(obj, "__qualname__", "")
            ref = _swap(getattr(obj, "__module__", None) or "", _PORT, _REF)
            if ref is not None and qual.isidentifier():
                return getattr, (_ModuleRef(ref), qual)
        return NotImplemented


def dumps(obj: Any, protocol: int | None = None) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=protocol).dump(obj)
    return buf.getvalue()


def _import_port(name: str):
    return importlib.import_module(_swap(name, _REF, _PORT) or name)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "importlib" and name == "import_module":
            return _import_port
        return super().find_class(_swap(module, _REF, _PORT) or module, name)


def loads(data: bytes | memoryview) -> Any:
    return _Unpickler(io.BytesIO(data)).load()
