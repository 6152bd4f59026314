"""Smart table ops — the normalized fuzzy join family: the port's own copy
of ``pathway_tpu/stdlib/ml/smart_table_ops/__init__.py`` (reference:
python/pathway/stdlib/ml/smart_table_ops/_fuzzy_join.py:1-711)."""

from pathway_tpu_torch.stdlib.ml.smart_table_ops._fuzzy_join import (
    FuzzyJoinFeatureGeneration,
    FuzzyJoinNormalization,
    JoinNormalization,
    fuzzy_match,
    fuzzy_match_tables,
    fuzzy_match_with_hint,
    fuzzy_self_match,
    smart_fuzzy_join,
    smart_fuzzy_match,
)

__all__ = [
    "FuzzyJoinFeatureGeneration",
    "FuzzyJoinNormalization",
    "JoinNormalization",
    "fuzzy_match",
    "fuzzy_match_tables",
    "fuzzy_match_with_hint",
    "fuzzy_self_match",
    "smart_fuzzy_join",
    "smart_fuzzy_match",
]
