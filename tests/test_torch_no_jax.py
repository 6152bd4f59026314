"""pathway_tpu_torch, chip_smoke.py and tools/ stand alone: every module of the port
imports with ``jax``, ``flax`` and ``pathway_tpu`` blocked, and no source
file names them in an import. Without a card, an entry point left on its
default device raises instead of falling back to the CPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pathway_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "pathway_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import pathway_tpu_torch
mods = ["pathway_tpu_torch"]
for info in pkgutil.walk_packages(pathway_tpu_torch.__path__, "pathway_tpu_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print(len(mods))
"""

_DEFAULT_DEVICE_RAISES = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None
import torch
assert not torch.cuda.is_available()
from pathway_tpu_torch.ops.knn import DeviceCorpus
from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex
from pathway_tpu_torch.xpacks.llm._encoder import EncoderRuntime
from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig
from pathway_tpu_torch.xpacks.llm.decoder import DecoderConfig, empty_pools
for make in (
    lambda: TpuDenseKnnIndex(dimensions=8),
    lambda: DeviceCorpus(8),
    lambda: EncoderRuntime(vocab_size=50, dim=8, depth=1, heads=2, max_len=16),
    lambda: SentenceTransformerEmbedder(dim=8, depth=1, heads=2, max_len=16),
    lambda: DecodeScheduler(),
    lambda: DecodeScheduler(GenerateConfig(kernel="ref")),
    lambda: empty_pools(DecoderConfig(), 4),
):
    try:
        make()
    except RuntimeError as e:
        assert "cuda" in str(e).lower()
    else:
        raise AssertionError("default device did not raise without CUDA")
print("ok")
"""


_IMPORT_EACH = """
import importlib, json, sys
for name in {blocked!r}:
    sys.modules[name] = None
ok = []
for mod in {mods!r}:
    importlib.import_module(mod)
    ok.append(mod)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r} and sys.modules[m])
assert not leaked, leaked
print(json.dumps(ok))
"""

# the durability and observability modules, each imported on its own line
# of the check so a failure names it
DURABLE_MODULES = [
    "pathway_tpu_torch.engine.arrangement",
    "pathway_tpu_torch.engine.batch",
    "pathway_tpu_torch.engine.sharded",
    "pathway_tpu_torch.persistence.segments",
    "pathway_tpu_torch.generate.kv_cache",
    "pathway_tpu_torch.elastic.handover",
    "pathway_tpu_torch.elastic.kv",
    "pathway_tpu_torch.observability.registry",
    "pathway_tpu_torch.observability.exposition",
    "pathway_tpu_torch.observability.tracing",
    "pathway_tpu_torch.observability.journal",
    "pathway_tpu_torch.observability.tickscope",
    "pathway_tpu_torch.observability.torch_metrics",
    "pathway_tpu_torch.testing.faults",
]


def _run(code, **fmt):
    return subprocess.run(
        [sys.executable, "-c", code.format(blocked=BLOCKED, **fmt)],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=300,
    )


def test_every_port_module_imports_without_jax():
    r = _run(_IMPORT_ALL)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip().splitlines()[-1]) >= 29


@pytest.fixture(scope="module")
def imported_with_jax_blocked():
    r = _run(_IMPORT_EACH, mods=DURABLE_MODULES)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", DURABLE_MODULES)
def test_durability_module_imports_without_jax(imported_with_jax_blocked, mod):
    assert mod in imported_with_jax_blocked


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & set(BLOCKED)


def test_default_device_raises_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run(_DEFAULT_DEVICE_RAISES)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
