"""The port's own copy of ``pathway_tpu/internals/reducer_descriptors.py``. Reducer descriptors: bridge between `pw.reducers.*` expressions and engine
accumulators (reference: src/engine/reduce.rs:22-38 Reducer enum +
python/pathway/internals/custom_reducers.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals import expression as expr_mod


@dataclass
class ReducerDescriptor:
    name: str
    kind: str  # engine accumulator kind
    n_args: int = 1
    skip_nones: bool = False
    fn: Callable | None = None
    extra: dict = field(default_factory=dict)
    # return dtype from arg dtypes
    ret: Callable[[list[dt.DType]], dt.DType] | None = None


def reducer_return_dtype(e: expr_mod.ReducerExpression, env) -> dt.DType:
    from pathway_tpu_torch.internals.table import infer_dtype

    desc: ReducerDescriptor = e._reducer
    arg_dtypes = [infer_dtype(a, env) for a in e._args]
    if desc.ret is not None:
        return desc.ret(arg_dtypes)
    return dt.ANY
