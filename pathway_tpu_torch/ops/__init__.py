"""pathway_tpu_torch.ops — dense KNN with the hand-written block top-k kernel,
ragged paged attention with the hand-written decode kernel, and the plain
torch device ops: IVF (``ops.ivf``), LSH hashing (``ops.lsh``) and the
segment reductions (``ops.segment``) (counterpart of
``pathway_tpu/ops/__init__.py``), and ``sharded_topk`` over a corpus whose
rows are split over a mesh (the block top-k kernel per shard on the card).
The raw kernel wrappers are ``ops.block_topk.block_topk`` and
``ops.paged_attention.paged_attention``; the names ``block_topk`` and
``paged_attention`` here stay the modules."""

from pathway_tpu_torch.ops.block_topk import block_topk_ref, dense_topk_kernel
from pathway_tpu_torch.ops.knn import (
    DeviceCorpus,
    KnnParams,
    cosine_topk,
    dense_topk,
    dense_topk_prepared,
    prepare_corpus,
    sharded_topk,
)
from pathway_tpu_torch.ops.paged_attention import lane_pad, paged_attention_ref
from pathway_tpu_torch.ops.segment import segment_count, segment_mean, segment_sum

__all__ = [
    "KnnParams",
    "dense_topk",
    "cosine_topk",
    "prepare_corpus",
    "dense_topk_prepared",
    "DeviceCorpus",
    "sharded_topk",
    "block_topk_ref",
    "dense_topk_kernel",
    "lane_pad",
    "paged_attention_ref",
    "segment_sum",
    "segment_count",
    "segment_mean",
]
