"""Extension packs of the port; ``llm`` loads when first asked for, as
``import pathway_tpu_torch.xpacks.llm`` does."""


def __getattr__(name: str):
    if name == "llm":
        import importlib

        module = importlib.import_module("pathway_tpu_torch.xpacks.llm")
        globals()[name] = module
        return module
    raise AttributeError(f"module 'pathway_tpu_torch.xpacks' has no attribute {name!r}")
