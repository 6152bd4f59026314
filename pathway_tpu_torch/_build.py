"""Build and load the port's CUDA sources.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. Nothing is
built at import time: the first caller of :func:`library` (or
:func:`build_all`, which starts one ``nvcc`` per source in parallel) pays the
build. Libraries land in ``build/pathway_tpu_torch/`` at the repository root,
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused. A failed build raises with the compiler's
output; there is no fallback.

Builds are safe across processes as well as threads: the ranks of one
process group that reach a kernel first at the same moment take an
``fcntl`` lock on ``build/pathway_tpu_torch/.build.lock`` around the
``nvcc`` runs, the one holding it builds, the others find the library on
disk when they get it, and a library only appears under its final name by
an atomic rename of a complete file.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "pathway_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc runs finished in this process and their wall seconds in all (read by
# observability/torch_metrics.py)
stats = {"builds": 0, "seconds": 0.0}


def sources() -> list[str]:
    """Names (file stems) of every CUDA source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for extra in sorted(CSRC.glob("*.cuh")):
        h.update(extra.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, tmp: Path) -> subprocess.Popen:
    tmp.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, tmp: Path, out: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    (out.parent / f"{name}.build.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file


@contextlib.contextmanager
def _build_lock():
    """Exclusive across the processes sharing ``BUILD_DIR`` (``fcntl``):
    the ranks of a group never run ``nvcc`` on the same outputs at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Build every named source (default: all) that is not built yet, one
    ``nvcc`` process per source, all started together. Returns the wall
    seconds each build took (0.0 for a library already on disk, or built
    meanwhile by another process holding the build lock)."""
    names = sources() if names is None else names
    with _build_lock():
        return _build_unlocked(names)


def _build_unlocked(names: list[str]) -> dict[str, float]:
    t0 = time.perf_counter()
    running = {}
    for name in names:
        out = _target(name)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            running[name] = (tmp, out, _start(name, tmp))
    seconds = {name: 0.0 for name in names}
    try:
        for name, (tmp, out, proc) in running.items():
            _finish(name, tmp, out, proc)
            seconds[name] = time.perf_counter() - t0
            stats["builds"] += 1
            stats["seconds"] += seconds[name]
    finally:  # a failed build stops the others
        for _tmp, _out, proc in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return seconds


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the last build of ``name``, or "" if none is on disk."""
    p = BUILD_DIR / f"{name}.build.log"
    return p.read_text() if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            out = _target(name)
            if not out.exists():
                build_all([name])
            lib = ctypes.CDLL(str(out))
            _loaded[name] = lib
        return lib
