#!/usr/bin/env python3
"""Where one paged-attention launch spends its device time, stage by stage.

    python3 tools/paged_attention_stages.py

Needs one CUDA card and nvcc. Builds copies of
``pathway_tpu_torch/csrc/paged_attention.cu`` that return early after each
stage of the kernel (an empty kernel, the first loads, the chunk loop, the
merge of the 8 warp states, the split partials with their fence and atomic
count, and the whole kernel) into ``build/ablation/``. A stage's work is kept
alive by a store that a runtime condition never takes. Each copy runs at the
generation phase's recorded-step shape (B = 8 bucket, six 150-token
sequences, H = 4, P = 16, Dp = 128, 16-page tables) for S = 1 and S = 4
splits, and the script prints one JSON line per copy with its device time
per launch from torch.profiler, beside the card's nvidia-smi name and power
limit. The difference between two neighbouring stages is what that stage
adds to the launch.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

KEEP = "  if (n_pages > 0) {{ if (sm_scale == 12345.f) out[threadIdx.x] = {}; return; }}\n"
ANCHORS = {  # stage -> (text in the source, what to insert before / after it)
    "empty": ("  const int bh = blockIdx.x;\n", "  if (sm_scale != 12345.f) return;\n", "before"),
    "first_loads": ("  float m = NEG;\n", KEEP.format("qr[0].x + pids[0] + ntok"), "before"),
    "chunks": ("  if (lane == 0) {\n    m_s[warp] = m;", KEEP.format("m + l + acc[0].x"), "before"),
    "warp_merge": ("  // this split's partial", KEEP.format("mx + denom + acc_s[threadIdx.x]"), "before"),
    "split_partials": ("  if (!last) return;\n", "  return;\n", "replace"),
}


def variants(src: str) -> dict[str, str]:
    out = {}
    for stage, (anchor, text, where) in ANCHORS.items():
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor of stage {stage!r} not found once in the source")
        new = {"before": text + anchor, "after": anchor + text, "replace": text}[where]
        out[stage] = src.replace(anchor, new)
    out["whole"] = src
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_attention_stages: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import device_times, kernel_device_ms
    from pathway_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    out_dir = ROOT / "build" / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "paged_attention.cu").read_text()
    procs = {}
    for stage, text in variants(src).items():
        cu, so = out_dir / f"pa_{stage}.cu", out_dir / f"libpa_{stage}.so"
        cu.write_text(text)
        procs[stage] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    libs = {}
    for stage, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for stage {stage}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.pathway_paged_attention.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        libs[stage] = lib

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, p, dp, n_pages, max_pages = 8, 4, 16, 128, 65, 16
    k = torch.randn(n_pages, h, p, dp, generator=g, device=dev)
    v = torch.randn(n_pages, h, p, dp, generator=g, device=dev)
    q = torch.randn(b, h, dp, generator=g, device=dev)
    pt = torch.randint(1, n_pages, (b, max_pages), generator=g, device=dev, dtype=torch.int32)
    sl = torch.tensor([150] * 6 + [0, 0], dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for stage, lib in libs.items():
        row = {"stage": stage, "nvidia_smi": smi}
        for splits in (1, 4):
            out = torch.empty(max(256, b * h * dp), device=dev)  # >= one block's threads
            part = torch.empty(b, h, splits, dp + 2, device=dev)
            counters = torch.zeros(b * h, dtype=torch.int32, device=dev)

            def launch():
                err = lib.pathway_paged_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), pt.data_ptr(), sl.data_ptr(),
                    out.data_ptr(), part.data_ptr(), counters.data_ptr(), b, h, p, dp, n_pages,
                    max_pages, splits, 32**-0.5, stream,
                )
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            launch()
            torch.cuda.synchronize()
            row[f"device_us_S{splits}"] = 1e3 * kernel_device_ms(
                device_times(launch), "paged_decode_kernel", 20
            )
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
