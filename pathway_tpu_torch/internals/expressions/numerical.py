"""The port's own copy of ``pathway_tpu/internals/expressions/numerical.py``. `.num` column namespace
(reference surface: python/pathway/internals/expressions/numerical.py)."""

from __future__ import annotations

import numpy as np

from pathway_tpu_torch.internals import dtype as dt
from pathway_tpu_torch.internals.expression import (
    ColumnExpression,
    MethodCallExpression,
)


class NumericalNamespace:
    def __init__(self, expression: ColumnExpression):
        self._expr = expression

    def abs(self):
        return MethodCallExpression(
            "num.abs", abs, dt.ANY, self._expr, vector_fn=np.abs
        )

    def round(self, decimals=0):
        return MethodCallExpression(
            "num.round",
            lambda x, d: round(x, d),
            dt.ANY,
            self._expr,
            decimals,
            vector_fn=lambda x, d: np.round(x, d),
        )

    def fill_na(self, default_value):
        def fn(x):
            if x is None:
                return default_value
            if isinstance(x, float) and x != x:  # NaN
                return default_value
            return x

        return MethodCallExpression(
            "num.fill_na", fn, dt.ANY, self._expr, propagate_none=False
        )
