"""The port's own copy of ``pathway_tpu/stdlib/statistical/__init__.py``. pw.statistical (reference: stdlib/statistical/_interpolate.py)."""

from __future__ import annotations

from enum import Enum
from typing import Any


class InterpolateMode(Enum):
    LINEAR = "linear"


def interpolate(
    table,
    timestamp: Any,
    *values: Any,
    mode: InterpolateMode = InterpolateMode.LINEAR,
):
    """Linear interpolation of missing (None) values along a time ordering
    (reference: stdlib/statistical/_interpolate.py). Each null cell is
    filled between the NEAREST NON-NULL neighbors of its own column in
    timestamp order (nulls between them are skipped over); leading/trailing
    gaps clamp to the first/last known value."""
    import bisect

    from pathway_tpu_torch.stdlib.utils.col import multiapply_all_rows

    assert mode == InterpolateMode.LINEAR
    names = [v.name for v in values]

    def _missing(v):
        # the all-rows bridge goes through pandas, which stores missing
        # optional floats as NaN
        return v is None or (isinstance(v, float) and v != v)

    def fn(ts_col, *val_cols):
        outs = []
        for vc in val_cols:
            pts = sorted(
                (ts_col[i], vc[i])
                for i in range(len(vc))
                if not _missing(vc[i])
            )
            xs = [p[0] for p in pts]
            res = []
            for i in range(len(vc)):
                if not _missing(vc[i]):
                    res.append(vc[i])
                    continue
                t0 = ts_col[i]
                j = bisect.bisect_left(xs, t0)
                left = pts[j - 1] if j > 0 else None
                right = pts[j] if j < len(pts) else None
                if left is None and right is None:
                    res.append(None)
                elif left is None:
                    res.append(float(right[1]))
                elif right is None:
                    res.append(float(left[1]))
                else:
                    w = (t0 - left[0]) / (right[0] - left[0])
                    res.append(left[1] + w * (right[1] - left[1]))
            outs.append(res)
        return outs

    interped = multiapply_all_rows(
        timestamp, *values, fun=fn, result_col_names=names
    )
    # full table returned in the ORIGINAL column order, interpolated
    # columns substituted in place (reference: interpolate returns the
    # full table)
    return table.select(
        **{
            n: (interped[n] if n in names else table[n])
            for n in table.column_names()
        }
    )


__all__ = ["interpolate", "InterpolateMode"]
