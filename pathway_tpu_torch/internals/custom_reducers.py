"""The port's own copy of ``pathway_tpu/internals/custom_reducers.py``. BaseCustomAccumulator — user-defined reducers
(reference: python/pathway/internals/custom_reducers.py)."""

from __future__ import annotations

from typing import Any


class BaseCustomAccumulator:
    """Subclass and implement:

    - ``from_row(cls, row)`` — build an accumulator from one row's values
    - ``update(self, other)`` — merge another accumulator in
    - ``compute_result(self)`` — the output value
    - optionally ``retract(self, other)`` — support retractions
    - optionally ``neutral(cls)`` — empty accumulator
    """

    @classmethod
    def from_row(cls, row: list[Any]) -> "BaseCustomAccumulator":
        raise NotImplementedError

    @classmethod
    def neutral(cls) -> "BaseCustomAccumulator":
        raise NotImplementedError

    def update(self, other: "BaseCustomAccumulator") -> None:
        raise NotImplementedError

    def retract(self, other: "BaseCustomAccumulator") -> None:
        raise NotImplementedError(
            "retraction not supported by this accumulator"
        )

    def compute_result(self) -> Any:
        raise NotImplementedError
