"""Helpers of the two-process tests of the port (``test_torch_distributed.py``,
``test_torch_dcn.py``, ``test_torch_cli.py``): a process group of either
package started on the CPU with its own deadline, whose children are
killed when the helper returns; the ``RESULT`` lines they print; the worker
prelude that imports the package ``PW_PKG`` names. It imports neither
package."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every worker starts with this: the package under test from PW_PKG
# (pathway_tpu_torch by default), the JAX one pinned to the CPU
PRELUDE = textwrap.dedent(
    """
    import importlib, json, os, pathlib, sys, threading, time
    PKG = os.environ.get("PW_PKG", "pathway_tpu_torch")
    if PKG == "pathway_tpu":
        import jax
        jax.config.update("jax_platforms", "cpu")
    pw = importlib.import_module(PKG)
    N = int(os.environ.get("PATHWAY_PROCESSES", "1"))
    PID = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    """
)


def worker(body: str) -> str:
    return PRELUDE + textwrap.dedent(body)


def group_env(n: int, pid: int, port: int, pkg: str = "pathway_tpu_torch") -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(
        PATHWAY_PROCESSES=str(n),
        PATHWAY_PROCESS_ID=str(pid),
        PATHWAY_DCN_PORT=str(port),
        PATHWAY_DCN_SECRET=f"test-job-secret-{port}",
        JAX_PLATFORMS="cpu",
        CUDA_VISIBLE_DEVICES="",
        PW_PKG=pkg,
        PYTHONPATH=ROOT,
    )
    return env


def run_procs(cmds_envs, timeout: float = 150.0) -> tuple[list, list[str]]:
    """Start one process per (argv, env) and wait for all of them until one
    shared deadline; every child still running at the deadline, or when
    this returns or raises, is killed. Returns (procs, outputs): each
    output is the process's stdout, then its stderr — read apart, so a log
    line never lands inside a result line."""
    procs = []
    outs = [""] * len(cmds_envs)
    deadline = time.monotonic() + timeout
    try:
        for argv, env in cmds_envs:
            procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                err = (err or "") + f"\n[killed at the {timeout:.0f}s deadline]"
            outs[i] = (out or "") + (err or "")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


def spawn_group(script, n: int, port: int, extra_env=None, timeout: float = 150.0,
                pkg: str = "pathway_tpu_torch") -> tuple[list, list[str]]:
    """``n`` ranks of ``script``; ``extra_env(pid)`` adds to each rank's env."""
    runs = []
    for pid in range(n):
        env = group_env(n, pid, port, pkg)
        if extra_env:
            env.update(extra_env(pid) or {})
        runs.append(([sys.executable, str(script)], env))
    return run_procs(runs, timeout)


def results(procs, outs, tag: str = "RESULT") -> list:
    """The JSON of every ``<tag> ...`` line, rank by rank; every rank must
    have exited 0."""
    got = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid={pid} exited {p.returncode}:\n{out[-4000:]}"
        for line in out.splitlines():
            if line.startswith(tag + " "):
                got.append(json.loads(line[len(tag) + 1:]))
    return got
