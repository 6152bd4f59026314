"""Loader for the native host hasher (``native/pathway_native.cc``) — the
port's own copy of ``pathway_tpu/internals/native.py``.

The first call of :func:`get_native` builds the source once with g++ (a
few seconds) into ``build/pathway_tpu_torch/`` at the repository root and
loads it by path as ``pathway_tpu_torch._native``. Nothing is built at
import. The extension keeps the configured ``Pointer`` type in C static
state, so the port never shares the JAX package's ``.so``: one process may
hold both packages, each with its own copy. Every caller has a
pure-Python path that gives the same keys, so a missing toolchain costs
speed, never correctness. ``PATHWAY_NO_NATIVE=1`` turns it off.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

from pathway_tpu_torch._build import BUILD_DIR

MODULE = "pathway_tpu_torch._native"
SOURCE = Path(__file__).resolve().parents[2] / "native" / "pathway_native.cc"

_native = None
_tried = False
# the compiler's output of the last build that failed (read by chip_smoke.py)
build_log = ""


def target() -> Path:
    """Where the extension is built."""
    return BUILD_DIR / ("_native" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))


def _build() -> bool:
    """Compile to a per-process temp file and swap it in atomically: a
    failed build never clobbers a working library, and processes that
    build at once never interleave their linker writes."""
    global build_log
    if not SOURCE.exists():
        build_log = f"{SOURCE} is missing"
        return False
    out = target()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    include = sysconfig.get_paths()["include"]
    cmd = [
        "g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
        f"-I{include}", str(SOURCE), "-o", str(tmp),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0 or not tmp.exists():
            build_log = res.stdout + res.stderr
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        build_log = repr(e)
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load():
    """The extension module at :func:`target`, or None if it does not load."""
    path = str(target())
    loader = importlib.machinery.ExtensionFileLoader(MODULE, path)
    spec = importlib.util.spec_from_file_location(MODULE, path, loader=loader)
    if spec is None:
        return None
    try:
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
    except ImportError:
        return None
    sys.modules[MODULE] = mod
    return mod


def get_native():
    """The configured native module, or None."""
    global _native, _tried
    if _native is not None or _tried:
        return _native
    _tried = True
    if os.environ.get("PATHWAY_NO_NATIVE"):
        return None
    # stale-library guard: rebuild when the source is newer than the
    # library, so an old build never masks new entry points (callers
    # feature-check them with hasattr)
    out = target()
    try:
        if out.exists() and SOURCE.stat().st_mtime > out.stat().st_mtime:
            _build()
    except OSError:
        pass
    mod = _load() if out.exists() else None
    if mod is None:
        if not _build():
            return None
        mod = _load()
        if mod is None:
            return None
    from pathway_tpu_torch.internals import api

    mod.configure(api.Pointer, api._value_bytes, api._SALT)
    # self-check: native keys must equal the pure-Python ones, or state
    # persisted by one path would not resume under the other
    probe = (None, True, 7, 2.5, "x", b"y", (1, "z"), api.Pointer(3))
    if mod.hash_value(probe) != api._hash_bytes(api._value_bytes(probe)):
        return None
    _native = mod
    return _native
