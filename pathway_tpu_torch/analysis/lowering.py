"""The Hopper launch ledger: device-free launch proofs for the port's
kernels — counterpart of ``pathway_tpu/analysis/lowering.py`` (the TPU
Lowering Ledger), with its API.

The reference proves that each Pallas kernel and each compiled-tick program
lowers for the TPU (Mosaic) without a device. The port's kernels are CUDA
C++ for ``sm_90a``, built by ``nvcc`` at first use on the card, so what can
be proved without a GPU is that every launch the wrappers would make fits
Hopper's limits, from the wrappers' own arithmetic:

1. **Static gate** per case: dynamic shared memory per block at most
   227 KB (:data:`SMEM_LIMIT_BYTES`), at most 1024 threads per block, the
   grid within ``(2**31 - 1, 65535, 65535)``; ``block_topk``'s bytes come
   from ``ops/block_topk.py`` ``_query_tile``/``_smem_bytes`` and
   ``paged_attention``'s from ``ops/paged_attention.py`` ``split_count`` —
   the numbers the wrappers launch with, not a second formula. The
   counterpart of the reference's ``validate_lowering`` is the paged
   kernel's vector width: a pool lane width ``Dp`` outside the built
   widths (``KERNEL_DP``) is refused. Violations raise
   :class:`LoweringRuleViolation` naming the rule.
2. **Segment programs** (families ``tick_forge`` and ``tick_forge_live``):
   each compiled-tick program runs on ``meta`` tensors — shapes and dtypes,
   no data, no device — and every output must come back with the batch's
   row count and numpy's result dtype for that column.
3. **Content-addressed manifest**: :func:`write_manifest` writes a sha256
   per case over the kernel source's bytes plus the launch configuration
   (a segment: over its lowered op list), so a changed kernel, launch or
   program shows as a changed hash. Its default place is
   ``build/pathway_tpu_torch/launch_ledger.json``.

``engine/compile.py`` registers each segment program it builds at runtime
via :func:`register_program`, so a live process proves its actual compiled
ticks too (family ``tick_forge_live``).

``lane_pad`` and ``check_tpu_block_rules`` remain as own copies of the
reference's pure arithmetic (the TPU's (8, 128) tile rule).

Module-level imports stay light (no torch): ``pathway_tpu_torch.analysis``
imports this module.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Callable, Iterable

from pathway_tpu_torch.analysis.diagnostics import Diagnostic, Severity

# the TPU's vector-layout geometry (own copy of the reference's rule)
SUBLANE = 8
LANE = 128

# Hopper (sm_90) launch limits: the opt-in dynamic shared memory per block
# (227 KB), threads per block, grid dimensions
SMEM_LIMIT_BYTES = 232448
MAX_THREADS_PER_BLOCK = 1024
MAX_GRID = (2**31 - 1, 65535, 65535)
# streaming multiprocessors of the H100 SXM, the card the paged kernel's
# split count is stated for (its wrapper reads the card's own count)
HOPPER_SMS = 132

PLATFORM = "sm_90a"
MANIFEST_NAME = "launch_ledger.json"

# rule ids a finding/manifest entry can name
RULE_8X128 = "mosaic-8x128"
RULE_LAUNCH = "hopper-launch"
RULE_SMEM = "smem-budget"
RULE_THREADS = "block-threads"
RULE_GRID = "grid-limits"
RULE_VECTOR = "vector-width"
RULE_SHAPE = "kernel-shape"
RULE_META = "meta-dtypes"

_CSRC = Path(__file__).resolve().parent.parent / "csrc"


def default_manifest_path() -> str:
    """``build/pathway_tpu_torch/launch_ledger.json`` at the repository
    root, beside the built kernels."""
    from pathway_tpu_torch._build import BUILD_DIR

    return str(BUILD_DIR / MANIFEST_NAME)


class LoweringRuleViolation(ValueError):
    """A statically-decidable launch rule was violated.

    Subclasses ``ValueError`` so callers gating on ``ValueError`` keep
    working; carries the stable rule id so findings name the rule."""

    def __init__(self, rule: str, message: str):
        super().__init__(message)
        self.rule = rule


def lane_pad(d: int) -> int:
    """``d`` padded up to the TPU lane width (multiple of 128) — the pool
    width rule the paged KV layout keeps across both packages."""
    return -(-int(d) // LANE) * LANE


def check_tpu_block_rules(block_shape, array_shape) -> None:
    """Own copy of the reference's Mosaic rule: the last two dims of a
    block must be divisible by (8, 128) respectively, or equal the
    corresponding overall-array dims. Raises
    :class:`LoweringRuleViolation` otherwise."""
    if len(block_shape) != len(array_shape):
        raise LoweringRuleViolation(
            RULE_8X128,
            f"block rank {len(block_shape)} != array rank "
            f"{len(array_shape)}",
        )
    if len(block_shape) < 2:
        return
    checks = (
        (block_shape[-2], array_shape[-2], SUBLANE),
        (block_shape[-1], array_shape[-1], LANE),
    )
    for blk_dim, arr_dim, align in checks:
        if blk_dim % align != 0 and blk_dim != arr_dim:
            raise LoweringRuleViolation(
                RULE_8X128,
                f"block shape {tuple(block_shape)} vs array "
                f"{tuple(array_shape)}: dim {blk_dim} is neither "
                f"divisible by {align} nor equal to the array dim "
                f"{arr_dim}",
            )


def check_launch(launch: dict) -> None:
    """Hopper's limits on one launch configuration
    (``{"grid": [x, y, z], "threads": n, "smem_bytes": s}``; a launch that
    sizes its grid on the card states its largest as ``grid_max``)."""
    smem = int(launch["smem_bytes"])
    if smem > SMEM_LIMIT_BYTES:
        raise LoweringRuleViolation(
            RULE_SMEM,
            f"{smem} bytes of dynamic shared memory per block exceed "
            f"Hopper's {SMEM_LIMIT_BYTES}",
        )
    threads = int(launch["threads"])
    if not 1 <= threads <= MAX_THREADS_PER_BLOCK:
        raise LoweringRuleViolation(
            RULE_THREADS,
            f"{threads} threads per block, limit {MAX_THREADS_PER_BLOCK}",
        )
    grid = launch["grid"] if "grid" in launch else launch["grid_max"]
    grid = list(grid) + [1] * (3 - len(grid))
    for axis, (g, lim) in enumerate(zip(grid, MAX_GRID)):
        if not 1 <= int(g) <= lim:
            raise LoweringRuleViolation(
                RULE_GRID, f"grid {tuple(grid)}: axis {axis} is {g}, limit {lim}"
            )


# ---------------------------------------------------------------------------
# kernel-family registry


@dataclasses.dataclass
class LoweringCase:
    """One provable shape of one kernel family.

    ``build`` returns the proof's record: a kernel's launch configuration
    (``grid``, ``threads``, ``smem_bytes``, ...), or a segment program's
    lowered op list (``ops``) and outputs; it raises
    :class:`LoweringRuleViolation` when the case cannot launch. ``expect``
    is "lower" for shapes that must prove and "reject" for shapes the gate
    must refuse (a gate that stops rejecting a known-bad shape is itself a
    regression). ``source`` is the kernel source whose bytes enter the
    case's hash. ``x64`` is kept for the reference's signature (torch has
    64-bit types without a switch)."""

    family: str
    name: str
    shape: dict
    build: Callable[[], dict] | None = None
    static_check: Callable[[], None] | None = None
    expect: str = "lower"  # "lower" | "reject"
    source: str | None = None
    x64: bool = False


# family name -> provider returning that family's built-in case ladder
FAMILIES: dict[str, Callable[[], list[LoweringCase]]] = {}
# family name -> builder turning a user shape dict into one LoweringCase
FAMILY_SHAPES: dict[str, Callable[[dict], LoweringCase]] = {}


def kernel_family(name: str):
    """Register a kernel family's built-in case provider."""

    def deco(fn):
        FAMILIES[name] = fn
        return fn

    return deco


def family_shape(name: str):
    """Register a family's user-shape case builder (``--prove-shape``)."""

    def deco(fn):
        FAMILY_SHAPES[name] = fn
        return fn

    return deco


def parse_shape_spec(spec: str) -> tuple[str, dict]:
    """``"paged_attention:head_dim=129,b=4"`` -> (family, {dims}).
    Values parse as ints."""
    family, _, rest = spec.partition(":")
    family = family.strip()
    if not family:
        raise ValueError(f"empty family in shape spec {spec!r}")
    shape: dict = {}
    if rest.strip():
        for part in rest.split(","):
            key, sep, val = part.partition("=")
            if not sep:
                raise ValueError(
                    f"bad shape spec {spec!r}: expected key=value, "
                    f"got {part!r}"
                )
            try:
                shape[key.strip()] = int(val)
            except ValueError:
                raise ValueError(
                    f"bad shape spec {spec!r}: {val!r} is not an int"
                ) from None
    return family, shape


def case_for_shape(family: str, shape: dict) -> LoweringCase:
    if family not in FAMILY_SHAPES:
        raise ValueError(
            f"unknown kernel family {family!r}; "
            f"registered: {sorted(FAMILY_SHAPES)}"
        )
    case = FAMILY_SHAPES[family](dict(shape))
    # a user-supplied shape is an assertion it should ship: the gate
    # refusing it is an ERROR finding, never an expected rejection
    case.expect = "lower"
    return case


# --- block_topk -------------------------------------------------------------


def block_topk_launch(b: int, d: int, n: int, k: int, bf16: bool = False) -> dict:
    """The launch ``ops/block_topk.py`` makes for [B, D] queries over an
    [N, D] corpus: the query tile and shared memory from the wrapper's own
    ``_query_tile``/``_smem_bytes``, and the largest grid it can take.
    ``csrc/block_topk.cu`` ``launch`` gives each of the ``ceil(B / tile)``
    query tiles between 1 and N/1024 blocks, as many as one wave of the
    card holds, so ``grid_max`` is ``[N/1024, ceil(B / tile), 1]``."""
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.knn import BLK

    if not (n > 0 and bt.supported(n, k) and 1 <= k):
        raise LoweringRuleViolation(
            RULE_SHAPE,
            f"block_topk needs N % {BLK} == 0, N > 0 and 1 <= k <= {BLK}; "
            f"got N={n}, k={k}",
        )
    try:
        qt = bt._query_tile(b, d, k, bf16)
    except ValueError as exc:
        smem = bt._smem_bytes(1, d, k, bf16)
        raise LoweringRuleViolation(
            RULE_SMEM,
            f"{exc}: one query needs {smem} bytes of shared memory per "
            f"block, Hopper allows {SMEM_LIMIT_BYTES}",
        ) from None
    return {
        "grid_max": [n // BLK, -(-b // qt), 1],
        "threads": bt._BLOCK_THREADS,
        "smem_bytes": bt._smem_bytes(qt, d, k, bf16),
        "query_tile": qt,
        "dtype": "bf16" if bf16 else "f32",
    }


def _topk_case(
    b: int, d: int, n: int, k: int, bf16: bool = False, expect: str = "lower"
) -> LoweringCase:
    def build():
        launch = block_topk_launch(b, d, n, k, bf16)
        check_launch(launch)
        return {"launch": launch}

    return LoweringCase(
        "block_topk",
        f"b{b}_d{d}_n{n}_k{k}_{'bf16' if bf16 else 'f32'}",
        {"b": b, "d": d, "n": n, "k": k, "bf16": int(bf16)},
        build=build,
        expect=expect,
        source="block_topk.cu",
    )


# the B ladder of the main path (1 .. the standing-query batches of the
# live graphs) x the k of every caller, both corpus dtypes, at D = 384
TOPK_B = (1, 16, 32, 256, 2048, 16384, 32768)
TOPK_K = (1, 3, 9, 10, 40, 1024)
TOPK_D = 384
TOPK_N = 1 << 20


@kernel_family("block_topk")
def _topk_cases() -> list[LoweringCase]:
    cases = [
        _topk_case(b, TOPK_D, TOPK_N, k, bf16)
        for bf16 in (False, True)
        for k in TOPK_K
        for b in TOPK_B
    ]
    # planted: a row too wide for even a one-query tile beside the corpus
    # ring (> 227 KB of shared memory) must stay refused
    cases.append(_topk_case(1, 32768, 1024, 10, expect="reject"))
    return cases


@family_shape("block_topk")
def _topk_shape(shape: dict) -> LoweringCase:
    return _topk_case(
        shape.pop("b", 16),
        shape.pop("d", TOPK_D),
        shape.pop("n", TOPK_N),
        shape.pop("k", 10),
        bool(shape.pop("bf16", 0)),
    )


# --- paged_attention --------------------------------------------------------


def paged_attention_launch(
    b: int, h: int, p: int, dp: int, max_pages: int, sms: int = HOPPER_SMS
) -> dict:
    """The launch ``ops/paged_attention.py`` makes: ``split_count`` splits
    per (b, h), a grid of (B * H, S) blocks of the kernel's warps, and one
    int per page of a split in shared memory (``csrc/paged_attention.cu``
    ``launch``). A pool lane width outside the built widths is refused —
    the kernel reads each row in 128-lane vectors."""
    from pathway_tpu_torch.ops import paged_attention as pa

    if dp not in pa.KERNEL_DP:
        raise LoweringRuleViolation(
            RULE_VECTOR,
            f"paged_attention pool width Dp={dp} is not one of the built "
            f"vector widths {pa.KERNEL_DP} (lane_pad(head_dim) to a "
            f"multiple of {LANE}, at most {pa.KERNEL_DP[-1]})",
        )
    if min(b, h, p, max_pages) < 1:
        raise LoweringRuleViolation(
            RULE_SHAPE, "paged_attention needs B, H, P, max_pages >= 1"
        )
    s = pa.split_count(b * h, max_pages, p, dp, sms)
    pps = -(-max_pages // s)
    return {
        "grid": [b * h, s, 1],
        "threads": pa._WARPS * 32,
        "smem_bytes": pps * 4,
        "splits": s,
        "pages_per_split": pps,
    }


def _paged_case(
    b: int, h: int, p: int, dp: int, n_pages: int, max_pages: int
) -> LoweringCase:
    from pathway_tpu_torch.ops.paged_attention import KERNEL_DP

    def build():
        launch = paged_attention_launch(b, h, p, dp, max_pages)
        check_launch(launch)
        return {"launch": launch}

    return LoweringCase(
        "paged_attention",
        f"b{b}_h{h}_p{p}_dp{dp}_mp{max_pages}",
        {
            "b": b,
            "h": h,
            "p": p,
            "head_dim": dp,
            "n_pages": n_pages,
            "max_pages": max_pages,
        },
        build=build,
        expect="lower" if dp in KERNEL_DP else "reject",
        source="paged_attention.cu",
    )


@kernel_family("paged_attention")
def _paged_cases() -> list[LoweringCase]:
    return [
        # the decoder's defaults: a generation step's B = 8 bucket and a
        # replica's /generate at B = 1 (H = 4, P = 16, Dp = 128, 16 pages)
        _paged_case(8, 4, 16, 128, 64, 16),
        _paged_case(1, 4, 16, 128, 64, 16),
        # the parity grid's corners (256-page tables over 1025 pages)
        _paged_case(64, 32, 8, 256, 1025, 256),
        _paged_case(1, 1, 16, 128, 1025, 256),
        # long context: one sequence over 4096 pages
        _paged_case(1, 32, 16, 128, 4097, 4096),
        # planted: a head_dim that is not lane-padded must stay refused
        _paged_case(8, 4, 16, 129, 32, 8),
    ]


@family_shape("paged_attention")
def _paged_shape(shape: dict) -> LoweringCase:
    return _paged_case(
        shape.pop("b", 8),
        shape.pop("h", 4),
        shape.pop("p", 16),
        shape.pop("head_dim", shape.pop("dp", 128)),
        shape.pop("n_pages", 32),
        shape.pop("max_pages", 8),
    )


# --- tick_forge (compiled segment programs) --------------------------------


def prove_program(fn: Callable, arg_structs: tuple, out_dtypes=None) -> dict:
    """Run a segment program on ``meta`` tensors (``arg_structs``: one
    ``(shape, numpy dtype)`` per device input) and record every torch call
    it makes. Every output must keep the batch's row count, and the
    columns (``out_dtypes``, numpy's result dtypes, when given) their
    dtype. Returns ``{"ops": [...], "outputs": [...]}``."""
    import numpy as np
    import torch
    from torch.overrides import TorchFunctionMode

    from pathway_tpu_torch.engine.compile import _torch_dtype

    ops: list[str] = []

    class _Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", str(func))
            if isinstance(out, torch.Tensor):
                ops.append(f"{name}->{str(out.dtype).removeprefix('torch.')}")
            else:
                ops.append(name)
            return out

    tensors = tuple(
        torch.empty(tuple(shape), dtype=_torch_dtype(np.dtype(d)), device="meta")
        for shape, d in arg_structs
    )
    rows = tensors[0].shape[0] if tensors else 0
    with _Record():
        outs = fn(*tensors)
    outputs = []
    for i, t in enumerate(outs):
        if tuple(t.shape) != (rows,):
            raise LoweringRuleViolation(
                RULE_META, f"output {i} has shape {tuple(t.shape)}, not ({rows},)"
            )
        if out_dtypes is not None and i < len(out_dtypes):
            want = _torch_dtype(np.dtype(out_dtypes[i]))
            if t.dtype != want:
                raise LoweringRuleViolation(
                    RULE_META,
                    f"output {i} is {t.dtype}, numpy's result dtype is "
                    f"{np.dtype(out_dtypes[i])}",
                )
        outputs.append(str(t.dtype).removeprefix("torch."))
    return {"ops": ops, "outputs": outputs}


def _forge_case(rows: int) -> LoweringCase:
    def build():
        import numpy as np

        import pathway_tpu_torch as pw
        from pathway_tpu_torch.engine.compile import _build_program
        from pathway_tpu_torch.engine.nodes import ALL_NODES

        # declare a canonical stateless chain (map + filter, the shapes
        # plan_segments fuses) without leaking nodes into the caller's
        # declared graph
        n0 = len(ALL_NODES)
        try:
            t = pw.debug.table_from_rows(
                pw.schema_from_types(x=int, y=float), [(1, 1.0)]
            )
            mapped = t.select(
                z=pw.this.x * 2 + 1, w=pw.this.y * 0.5 + pw.this.y
            )
            filt = mapped.filter(pw.this.z > 0)
            chain = [mapped._node, filt._node]
            external = list(chain[0].inputs[0].column_names)
            dtypes = {
                "x": np.dtype("int64"),
                "y": np.dtype("float64"),
            }
            prog = _build_program(chain, external, dtypes)
        finally:
            del ALL_NODES[n0:]
        args = tuple(((rows,), dtypes[c]) for c in prog.in_cols)
        return prove_program(prog.fn, args, prog.out_dtypes)

    return LoweringCase(
        "tick_forge",
        f"map_filter_rows{rows}",
        {"rows": rows, "cols": 2},
        build=build,
        x64=True,
    )


@kernel_family("tick_forge")
def _forge_cases() -> list[LoweringCase]:
    # three rungs of the pow2 row-bucket ladder engine/compile.py pads
    # batches onto (row_bucket): floor, a mid rung, a large rung
    return [_forge_case(8), _forge_case(1024), _forge_case(8192)]


@family_shape("tick_forge")
def _forge_shape(shape: dict) -> LoweringCase:
    return _forge_case(shape.pop("rows", 1024))


# --- live segment programs -------------------------------------------------

# segment programs the running engine registered (engine/compile.py
# SegmentRunner._program_for): proven under family "tick_forge_live"
_LIVE_PROGRAMS: dict[str, LoweringCase] = {}
_LIVE_CAP = 64


def register_program(
    name: str,
    fn: Callable,
    arg_structs: tuple,
    *,
    x64: bool = True,
    meta: dict | None = None,
) -> None:
    """Record a segment program for device-free proving: ``arg_structs``
    holds one ``(shape, numpy dtype)`` per device input, ``meta`` may name
    the outputs' numpy dtypes (``out_dtypes``). Called by the engine after
    each successful segment build; bounded, idempotent per name, and never
    raises (the ledger must not be able to take the tick down)."""
    try:
        if len(_LIVE_PROGRAMS) >= _LIVE_CAP and name not in _LIVE_PROGRAMS:
            return
        args = tuple(arg_structs)
        meta = dict(meta or {})
        out_dtypes = meta.get("out_dtypes")
        _LIVE_PROGRAMS[name] = LoweringCase(
            "tick_forge_live",
            name,
            meta,
            build=lambda: prove_program(fn, args, out_dtypes),
            x64=x64,
        )
    except Exception:  # pragma: no cover - defensive: never break the tick
        pass


def live_cases() -> list[LoweringCase]:
    return [_LIVE_PROGRAMS[k] for k in sorted(_LIVE_PROGRAMS)]


def clear_live_programs() -> None:
    _LIVE_PROGRAMS.clear()


# ---------------------------------------------------------------------------
# the prover


@dataclasses.dataclass
class LoweringReport:
    """Outcome of one :func:`prove_lowering` pass: per-case manifest
    entries plus Doctor-style findings for anything that violated a rule
    or failed to prove."""

    platform: str
    entries: list[dict] = dataclasses.field(default_factory=list)
    findings: list[Diagnostic] = dataclasses.field(default_factory=list)

    def by_status(self, status: str) -> list[dict]:
        return [e for e in self.entries if e["status"] == status]

    def to_manifest(self) -> dict:
        entries = sorted(
            self.entries, key=lambda e: (e["family"], e["case"])
        )
        body = json.dumps(entries, sort_keys=True, default=str)
        return {
            "version": 1,
            "platform": self.platform,
            "smem_limit_bytes": SMEM_LIMIT_BYTES,
            "max_threads_per_block": MAX_THREADS_PER_BLOCK,
            "content_sha256": hashlib.sha256(
                body.encode("utf-8")
            ).hexdigest(),
            "cases": entries,
        }


def _case_hash(case: LoweringCase, record: dict) -> str:
    h = hashlib.sha256()
    if case.source is not None:
        h.update((_CSRC / case.source).read_bytes())
    h.update(json.dumps(record, sort_keys=True, default=str).encode("utf-8"))
    return h.hexdigest()


def _condense(exc: BaseException, limit: int = 300) -> str:
    """First line of the deepest cause."""
    root = exc
    while root.__cause__ is not None:
        root = root.__cause__
    msg = f"{type(root).__name__}: {root}".splitlines()[0]
    return msg[:limit]


def prove_lowering(
    families: Iterable[str] | None = None,
    cases: Iterable[LoweringCase] | None = None,
    platform: str = PLATFORM,
    include_live: bool = True,
) -> LoweringReport:
    """Prove every selected case device-free and return the report.

    Per case: the case's static check and its build (the launch
    configuration under Hopper's limits, or the segment program on meta
    tensors) run; expected-reject cases must be refused (a case that
    proves is a gate regression, an ERROR), and a refusal of an
    expected-lower case is an ERROR finding naming the kernel, shape and
    violated rule. A proved case records its launch or op list and a
    sha256 over the kernel source's bytes plus that record."""
    selected: list[LoweringCase]
    if cases is not None:
        selected = list(cases)
    else:
        fams = sorted(FAMILIES) if families is None else list(families)
        unknown = sorted(set(fams) - set(FAMILIES))
        if unknown:
            raise ValueError(
                f"unknown kernel family id(s) {unknown}; "
                f"registered: {sorted(FAMILIES)}"
            )
        selected = []
        for fam in fams:
            selected.extend(FAMILIES[fam]())
        if include_live:
            selected.extend(live_cases())

    report = LoweringReport(platform=platform)
    for case in selected:
        entry: dict = {
            "family": case.family,
            "case": case.name,
            "shape": dict(case.shape),
            "expect": case.expect,
        }
        report.entries.append(entry)

        violation: LoweringRuleViolation | None = None
        record: dict | None = None
        failure: BaseException | None = None
        try:
            if case.static_check is not None:
                case.static_check()
            if case.build is not None:
                record = case.build()
        except LoweringRuleViolation as exc:
            violation = exc
        except Exception as exc:
            failure = exc

        if case.expect == "reject":
            if violation is None:
                entry["status"] = "gate-regression"
                report.findings.append(
                    Diagnostic(
                        RULE_LAUNCH,
                        Severity.ERROR,
                        f"{case.family} {case.name} {case.shape}: the "
                        "launch gate no longer rejects this known-bad shape",
                        fix_hint="restore the check in "
                        "analysis/lowering.py (check_launch / the family's "
                        "launch function)",
                        data={
                            "family": case.family,
                            "case": case.name,
                            "shape": dict(case.shape),
                        },
                    )
                )
            else:
                entry["status"] = "rejected"
                entry["rule"] = violation.rule
                entry["reason"] = str(violation)
            continue

        if violation is not None:
            entry["status"] = "gate-rejected"
            entry["rule"] = violation.rule
            entry["reason"] = str(violation)
            report.findings.append(
                Diagnostic(
                    RULE_LAUNCH,
                    Severity.ERROR,
                    f"kernel {case.family} shape {case.shape} rejected "
                    f"by the launch gate (rule {violation.rule}): "
                    f"{violation}",
                    fix_hint="shrink the query tile or the row width, or "
                    "lane-pad the head_dim — see analysis/lowering.py",
                    data={
                        "family": case.family,
                        "case": case.name,
                        "shape": dict(case.shape),
                        "rule": violation.rule,
                    },
                )
            )
            continue

        if failure is not None:
            entry["status"] = "proof-failed"
            entry["error"] = _condense(failure)
            report.findings.append(
                Diagnostic(
                    RULE_LAUNCH,
                    Severity.ERROR,
                    f"kernel {case.family} shape {case.shape} could not be "
                    f"proved for {platform}: {_condense(failure)}",
                    data={
                        "family": case.family,
                        "case": case.name,
                        "shape": dict(case.shape),
                        "rule": RULE_LAUNCH,
                    },
                )
            )
            continue

        if record is None:
            entry["status"] = "static-only"
            continue
        entry["status"] = "proved"
        launch = record.get("launch")
        if launch is not None:
            entry["launch"] = launch
            entry["smem_bytes"] = launch["smem_bytes"]
            entry["smem_frac"] = round(launch["smem_bytes"] / SMEM_LIMIT_BYTES, 4)
        if "ops" in record:
            entry["ops"] = len(record["ops"])
            entry["outputs"] = record["outputs"]
        entry["sha256"] = _case_hash(case, record)
    return report


def write_manifest(report: LoweringReport, path: str | None = None) -> str:
    """Write the content-addressed manifest and return its path
    (default :func:`default_manifest_path`)."""
    path = default_manifest_path() if path is None else str(path)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    doc = report.to_manifest()
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    return path


__all__ = [
    "FAMILIES",
    "LoweringCase",
    "LoweringReport",
    "LoweringRuleViolation",
    "block_topk_launch",
    "check_launch",
    "check_tpu_block_rules",
    "kernel_family",
    "family_shape",
    "lane_pad",
    "paged_attention_launch",
    "prove_lowering",
    "register_program",
    "write_manifest",
]
