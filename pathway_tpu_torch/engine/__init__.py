"""pathway_tpu_torch.engine — the pieces of ``pathway_tpu/engine`` the port
needs so far: the columnar ``Arrangement`` (KV ledger state), its column
helpers, and the jk-hash ownership function ``shard_of``. The dataflow
engine itself (nodes, runtime, compiled ticks) is not ported yet."""
