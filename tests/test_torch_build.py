"""The port's kernel build (``pathway_tpu_torch/_build.py``) is safe across
processes: two processes that reach the same library at once — the ranks
of a group on first use — run the compiler once between them (the
``fcntl`` build lock) and both load one complete library (the atomic
rename). A stub compiler stands in for ``nvcc`` here: it builds a tiny
shared library with the host's C compiler and writes it out slowly, in
two halves, so that a race without the lock would show."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from torch_group import ROOT, run_procs

_STUB_NVCC = textwrap.dedent(
    """\
    #!{python}
    import os, subprocess, sys, time
    out = sys.argv[sys.argv.index("-o") + 1]
    with open(os.environ["STUB_LOG"], "a") as f:
        f.write(out + "\\n")
    src = out + ".c"
    with open(src, "w") as f:
        f.write("int stub_answer(void) {{ return 42; }}\\n")
    subprocess.check_call(["{cc}", "-shared", "-fPIC", "-o", out + ".real", src])
    data = open(out + ".real", "rb").read()
    with open(out, "wb") as f:  # slowly: a reader racing this sees half a file
        f.write(data[: len(data) // 2])
        f.flush()
        time.sleep(1.5)
        f.write(data[len(data) // 2 :])
    os.remove(out + ".real")
    os.remove(src)
    """
)

_LOADER = textwrap.dedent(
    """
    import os, sys, time
    from pathlib import Path
    from pathway_tpu_torch import _build
    _build.BUILD_DIR = Path(os.environ["STUB_BUILD_DIR"])
    # both processes start the build at the same instant
    while time.time() < float(os.environ["STUB_GO"]):
        time.sleep(0.005)
    lib = _build.library("block_topk")
    print("ANSWER", lib.stub_answer(), _build.stats["builds"], flush=True)
    """
)


def test_two_processes_build_once_and_load_one_complete_library(tmp_path):
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
    if cc is None:
        pytest.skip("no host C compiler to stand in for nvcc")
    import time

    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(_STUB_NVCC.format(python=sys.executable, cc=cc))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    loader = tmp_path / "loader.py"
    loader.write_text(_LOADER)
    env = {**os.environ, "PATH": f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}", "PYTHONPATH": ROOT,
           "STUB_LOG": str(log), "STUB_BUILD_DIR": str(tmp_path / "build"), "STUB_GO": str(time.time() + 8)}
    procs, outs = run_procs([([sys.executable, str(loader)], env)] * 2, timeout=120)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    answers = sorted(ln.split()[1:] for out in outs for ln in out.splitlines() if ln.startswith("ANSWER"))
    # one process built (1 build), the other found the library on disk (0)
    assert answers == [["42", "0"], ["42", "1"]], outs
    built = log.read_text().splitlines()
    assert len(built) == 1, built
    libs = sorted(p.name for p in (tmp_path / "build").iterdir() if p.suffix == ".so")
    assert len(libs) == 1 and libs[0].startswith("libblock_topk-"), libs
    assert not [p for p in (tmp_path / "build").iterdir() if p.suffix == ".tmp"]


def test_build_lock_is_taken_around_builds(tmp_path, monkeypatch):
    """``build_all`` holds the lock while it builds: a second holder in
    this process would block (``flock`` is per open file), so the lock file
    exists and a non-blocking try from another process fails meanwhile."""
    from pathway_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    probe = textwrap.dedent(
        f"""
        import fcntl, sys
        f = open({str(tmp_path / '.build.lock')!r}, "w")
        try:
            fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            print("LOCKED")
        else:
            print("FREE")
        """
    )
    seen = []

    def fake_build(names):
        seen.append(subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True).stdout.strip())
        return {n: 0.0 for n in names}

    monkeypatch.setattr(_build, "_build_unlocked", fake_build)
    assert _build.build_all(["block_topk"]) == {"block_topk": 0.0}
    assert seen == ["LOCKED"]
    seen.clear()
    fake_build([])  # outside build_all: free
    assert seen == ["FREE"]
