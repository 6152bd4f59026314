"""pathway_tpu_torch — the PyTorch/CUDA port of ``pathway_tpu``.

The JAX package ``pathway_tpu`` is the reference; this package re-implements
its live-RAG retrieval path (tokenizer → sentence encoder → device-resident
corpus → exact dense top-k) on PyTorch, with the fused score + block-top-k
kernel written by hand in CUDA C++ for Hopper (``csrc/block_topk.cu``).

Modules keep the JAX package's paths and public names so each counterpart is
easy to find. The package imports neither ``jax`` nor anything of
``pathway_tpu``: what it needs from the framework-neutral layers (tokenizer,
filter compiler, ``Json``) it keeps as its own copy.

Entry points take ``device=`` and default to ``"cuda"``; without a card they
raise unless the caller passes ``device="cpu"`` explicitly.
"""

from pathway_tpu_torch._device import resolve_device

__version__ = "0.1.0"  # the reference's version: the port tracks it

__all__ = ["resolve_device"]
