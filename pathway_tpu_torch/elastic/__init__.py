"""pathway_tpu_torch.elastic — generation-plane resharding (``kv.py``):
splitting a KV snapshot across new owners by the jk-hash ownership. The
segment ferry, the mesh and serving planes' resharding and the two-phase
ownership map are not ported yet."""
