"""The plain reference the benchmark judges the port against: plain PyTorch
and Python, importing nothing of ``pathway_tpu_torch``, ``pathway_tpu`` or
JAX. ``tokenizer`` is a frozen copy of the hashing tokenizer the
configurations state, ``encoder`` the sentence encoder's forward in float32,
``topk`` exact cosine top-k."""
