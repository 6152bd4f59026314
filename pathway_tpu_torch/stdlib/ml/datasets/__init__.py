"""Bundled ML datasets: the port's own copy of
``pathway_tpu/stdlib/ml/datasets/__init__.py`` (reference:
stdlib/ml/datasets)."""

from . import classification

__all__ = ["classification"]
