"""Continuous-batching decode scheduler — counterpart of
``pathway_tpu/generate/scheduler.py``.

One scheduler per generation replica. Requests are admitted through the EDF
:class:`~pathway_tpu_torch.serving.batcher.MicroBatcher` (an expired request
is 504'd without ever touching the device), join the active set BETWEEN
decode steps, and from then on every step advances every active sequence by
one token, the batch padded up the power-of-two ladder (``qos.bucket_for``).

Prefill IS decode: a joining sequence's prompt tokens are fed one per step
through the same ``decode_step`` (logits ignored until the prompt is
consumed), so there is exactly one code path and a restored run continues
the same computation. ``generate.prefill`` spans cover admission -> first
sampled token; ``generate.decode_step`` spans cover each step.

Deadline propagation drops expired generations MID-decode: before every step
the scheduler sweeps the active set, answers 504 and reclaims the
sequence's pages into the pool and retracts its ledger rows — never another
step for a dead deadline (``pathway_generate_dropped_mid_decode_total``). A
request the page pool cannot cover yet waits and joins when pages free.

Durability: every ``snapshot_every`` steps the scheduler mirrors the pages
that changed since the last mirror (pages fully written earlier are
immutable, so bytes written scale with churn) plus per-sequence resume
metadata into the :class:`~pathway_tpu_torch.generate.kv_cache.KvLedger`,
then writes the incremental segment snapshot. The mirror gathers the dirty
pages on the card (``index_select`` along the page axis) and pulls them with
one ``.cpu()`` for K and one for V. ``restore=`` rebuilds pools, page tables and sequence
state from the newest manifest (one ``index_copy_`` per pool); decoding
continues where the snapshot left off and — greedy or seeded sampling being
deterministic — reproduces the uninterrupted run's tokens. The snapshot
format is the reference's, so either package restores the other's.

Observability: the reference's seven ``pathway_generate_*`` metrics, the
page-pool occupancy gauge, the ``generate:<label>`` memory provider, the
``paged_attention`` roofline, the ``mid-decode-drop`` journal event, and
``faults.active().on_decode_step(n)`` after every step
(``PATHWAY_FAULTS="kill=decode:N"``).

Device: the parameters and the K/V pools live on ``device`` (default
``"cuda"``; without a card that raises unless the caller passes ``"cpu"``).
``kernel="auto"`` runs the hand-written paged-attention kernel when the pools
are on CUDA and the plain version on the CPU; ``"ref"`` and ``"cuda"`` force
one. Step inputs go to the device as int32 tensors and the logits come back
with ``.cpu()``, which is where each step synchronises with the card;
``step_seconds`` keeps the wall time of recent steps, measured across that
sync.

``generate_enabled_via_env`` (``PATHWAY_GENERATE=1``) arms the stage on a
read replica; ``generate/serving.py`` mounts the ``/generate`` route.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from pathway_tpu_torch._device import resolve_device
from pathway_tpu_torch.generate.kv_cache import KvLedger, PagePool
from pathway_tpu_torch.observability import tickscope, tracing
from pathway_tpu_torch.observability.journal import record as journal_record
from pathway_tpu_torch.testing import faults
from pathway_tpu_torch.serving.admission import DeadlineExceeded, ShedError
from pathway_tpu_torch.serving.batcher import MicroBatcher
from pathway_tpu_torch.serving.config import QoSConfig

_ENV_PREFIX = "PATHWAY_GENERATE_"
DEFAULT_PAGES = 64
KERNELS = ("auto", "ref", "cuda")


def generate_enabled_via_env() -> bool:
    """``PATHWAY_GENERATE=1`` arms the generation stage on a replica
    (serving/replica.py main) — off keeps the read plane byte-identical
    to the pre-generation topology."""
    return os.environ.get("PATHWAY_GENERATE", "0").lower() in (
        "1",
        "true",
        "yes",
    )


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(_ENV_PREFIX + name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{_ENV_PREFIX}{name}={raw!r} is not an int") from None


@dataclass(frozen=True)
class GenerateConfig:
    """Generation-stage policy: decoder shape + page pool + scheduler
    knobs.  Every knob has a ``PATHWAY_GENERATE_*`` override."""

    n_pages: int = DEFAULT_PAGES
    page_size: int = 16
    max_batch: int = 8
    max_new_tokens: int = 32  # default per request (body may lower it)
    max_len: int = 256  # hard per-sequence token bound (pages permitting)
    snapshot_every: int = 0  # decode steps between snapshots; 0 = off
    store_root: str | None = None
    kernel: str = "auto"  # auto | ref | cuda
    decoder_seed: int = 0
    dim: int = 128
    n_layers: int = 2
    n_heads: int = 4
    head_dim: int = 32
    ffn_dim: int = 256

    @classmethod
    def from_env(cls) -> "GenerateConfig":
        kernel = os.environ.get(_ENV_PREFIX + "KERNEL", "") or "auto"
        if kernel not in KERNELS:
            raise ValueError(f"{_ENV_PREFIX}KERNEL={kernel!r} must be auto|ref|cuda")
        return cls(
            n_pages=_env_int("PAGES", DEFAULT_PAGES),
            page_size=_env_int("PAGE_SIZE", 16),
            max_batch=_env_int("MAX_BATCH", 8),
            max_new_tokens=_env_int("MAX_TOKENS", 32),
            max_len=_env_int("MAX_LEN", 256),
            snapshot_every=_env_int("SNAPSHOT_EVERY", 0),
            store_root=os.environ.get(_ENV_PREFIX + "STORE") or None,
            kernel=kernel,
            decoder_seed=_env_int("SEED", 0),
        )

    def decoder_config(self):
        from pathway_tpu_torch.xpacks.llm.decoder import DecoderConfig

        return DecoderConfig(
            dim=self.dim,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            head_dim=self.head_dim,
            ffn_dim=self.ffn_dim,
            max_len=self.max_len,
            page_size=self.page_size,
        )


class GenerationRequest:
    """One admitted-or-not generation crossing the scheduler.  Exposes
    ``deadline`` for the micro-batcher's EDF heap and a ``wait()`` the
    caller blocks on."""

    def __init__(
        self,
        request_id: str,
        prompt_tokens: list[int],
        *,
        deadline: float,
        max_new_tokens: int,
        tenant: str | None = None,
        tenant_class: str | None = None,
        temperature: float = 0.0,
        top_k: int = 40,
        seed: int = 0,
        on_token: Callable[[int, bool], None] | None = None,
        traceparent: str | None = None,
    ):
        self.request_id = request_id
        self.prompt_tokens = list(prompt_tokens)
        self.deadline = float(deadline)
        self.order = self.deadline  # MicroBatcher heap key (plain EDF)
        self.max_new_tokens = int(max_new_tokens)
        self.tenant = tenant
        self.tenant_class = tenant_class
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.on_token = on_token
        self.traceparent = traceparent
        self.created_at = time.monotonic()
        self.done = threading.Event()
        self.result: dict | None = None
        # optional completion hook, called AFTER result/done are set
        self.on_done: Callable[[], None] | None = None

    def finish(self, result: dict) -> None:
        self.result = result
        self.done.set()
        if self.on_done is not None:
            try:
                self.on_done()
            except Exception:
                pass

    def wait(self, timeout: float | None = None) -> dict | None:
        self.done.wait(timeout)
        return self.result


@dataclass
class _Seq:
    """One in-flight sequence: request plumbing + decode cursor."""

    seq_id: int
    req: GenerationRequest | None
    tokens: list[int]  # prompt + generated so far
    prompt_len: int
    max_new: int
    temperature: float
    top_k: int
    seed: int
    pages: list[int] = field(default_factory=list)
    n_fed: int = 0  # tokens written into the KV cache
    n_mirrored: int = 0  # tokens covered by the ledger mirror
    generated: list[int] = field(default_factory=list)
    trace_ctx: Any = None  # parsed parent SpanContext (or None)
    first_token_at: float | None = None
    deadline: float = 0.0
    tenant: str | None = None

    @property
    def next_token(self) -> int:
        return self.tokens[self.n_fed]

    def meta(self, now: float) -> dict:
        """Resumable snapshot metadata (deadlines persist as REMAINING
        budget — monotonic clocks do not survive a process). Python scalars
        and lists only, in the reference's key order: the dict is pickled
        into the snapshot, which either package must read."""
        return {
            "seq_id": int(self.seq_id),
            "tokens": [int(t) for t in self.tokens],
            "prompt_len": int(self.prompt_len),
            "max_new": int(self.max_new),
            "temperature": float(self.temperature),
            "top_k": int(self.top_k),
            "seed": int(self.seed),
            "n_fed": int(self.n_fed),
            "n_generated": len(self.generated),
            "remaining_ms": max((self.deadline - now) * 1000.0, 0.0),
            "tenant": self.tenant,
            "n_pages": len(self.pages),
        }


_M: dict | None = None


def _metrics() -> dict:
    global _M
    if _M is None:
        from pathway_tpu_torch.observability import REGISTRY

        _M = {
            "tokens": REGISTRY.counter(
                "pathway_generate_tokens_total",
                "tokens generated, by replica and kind (sampled = "
                "returned to a client; prefill = prompt tokens fed "
                "through the decode path)",
                labelnames=("replica", "kind"),
            ),
            "batch": REGISTRY.histogram(
                "pathway_generate_decode_batch_size",
                "live sequences per decode step (before pad-ladder "
                "padding)",
            ),
            "occupancy": REGISTRY.gauge(
                "pathway_generate_page_pool_occupancy",
                "fraction of the KV page pool in use, by replica",
                labelnames=("replica",),
            ),
            "dropped": REGISTRY.counter(
                "pathway_generate_dropped_mid_decode_total",
                "generations dropped MID-decode by deadline "
                "propagation (504, pages reclaimed), by replica",
                labelnames=("replica",),
            ),
            "requests": REGISTRY.counter(
                "pathway_generate_requests_total",
                "generation requests, by replica and outcome",
                labelnames=("replica", "outcome"),
            ),
            "ttft": REGISTRY.histogram(
                "pathway_generate_ttft_seconds",
                "admission -> first sampled token, by replica",
                labelnames=("replica",),
            ),
            "steps": REGISTRY.counter(
                "pathway_generate_decode_steps_total",
                "decode steps executed, by replica",
                labelnames=("replica",),
            ),
        }
    return _M


def _numel(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v) for v in tree)
    return int(tree.numel())


class DecodeScheduler:
    """Continuous-batching decode loop over the paged KV cache."""

    def __init__(
        self,
        config: GenerateConfig | None = None,
        *,
        qos: QoSConfig | None = None,
        replica_label: str = "0",
        restore: bool = True,
        ledger: Any = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or GenerateConfig.from_env()
        if self.config.kernel not in KERNELS:
            raise ValueError(f"unknown kernel {self.config.kernel!r}; expected one of {KERNELS}")
        # PATHWAY_SERVING_* overrides apply (deadline budget/clamp, queue
        # bound, ...)
        self.qos = qos or QoSConfig.from_env(
            QoSConfig(max_batch_size=self.config.max_batch, max_wait_ms=2.0)
        )
        self.label = str(replica_label)
        self.dcfg = self.config.decoder_config()
        from pathway_tpu_torch.convert import decoder_params_to_torch
        from pathway_tpu_torch.xpacks.llm import decoder as dec

        self._dec = dec
        self.params = decoder_params_to_torch(
            dec.init_params(self.dcfg, seed=self.config.decoder_seed), self.device
        )
        self.k_pool, self.v_pool = dec.empty_pools(
            self.dcfg, self.config.n_pages, device=self.device
        )
        self.pool = PagePool(self.config.n_pages)
        self.ledger = KvLedger()
        if self.config.kernel == "auto":
            self.kernel = "cuda" if self.device.type == "cuda" else "ref"
        else:
            self.kernel = self.config.kernel
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._active: list[_Seq] = []
        self._staged: list[GenerationRequest] = []
        self._waiting: list[GenerationRequest] = []
        self._seq_counter = 0
        self._step_count = 0
        self._n_params: int | None = None  # roofline: counted on demand
        self._stopping = False
        # out-of-thread snapshot(): executed AT the step boundary by the
        # decode thread — decode_step writes the pools in place
        # (index_put_) on the decode thread's stream, so another thread
        # reading them mid-step would copy half-written pages
        self._snap_waiters: list = []
        self.finished: dict[str, dict] = {}  # request_id -> result (bounded)
        # wall seconds of recent decode steps (inputs to the device, the
        # step, logits back to the host)
        self.step_seconds: collections.deque[float] = collections.deque(maxlen=4096)
        self.restored_seqs = 0
        m = _metrics()
        self._m_tokens = m["tokens"]
        self._m_batch = m["batch"]
        self._m_dropped = m["dropped"].labels(self.label)
        self._m_requests = m["requests"]
        self._m_ttft = m["ttft"].labels(self.label)
        self._m_steps = m["steps"].labels(self.label)
        ref = weakref.ref(self)
        m["occupancy"].labels(self.label).set_function(
            lambda: s.pool.occupancy() if (s := ref()) is not None else 0.0
        )
        if restore and self.config.store_root:
            self._restore(self.config.store_root)
        # Tenant Weave past the admission gate: with a tenant ledger
        # attached (duck-typed: admit/refund/commit/note_dispatched), every
        # submitted generation carries the ledger's WFQ virtual-finish tag
        # and the batcher's heap orders by (vfinish, deadline). None keeps
        # plain EDF.
        self.tenant_ledger = ledger

        # Tick Scope memory provider: device KV page pools, the KvLedger
        # arrangements and the host mirror under owner "generate:<label>"
        # (weakref: a dead scheduler drops out at the next pull)
        def _generate_memory(r=ref):
            s = r()
            if s is None:
                return {}
            parts = dict(s.ledger.resident_bytes())
            parts["k_pool_device"] = s.k_pool.nbytes
            parts["v_pool_device"] = s.v_pool.nbytes
            return parts

        tickscope.register_memory_provider(f"generate:{self.label}", _generate_memory)
        self.batcher = MicroBatcher(
            self.qos,
            dispatch=self._dispatch,
            reject=self._reject,
            capacity=self._slots_free,
            name=f"pw-generate-{self.label}",
            # requests carry their own heap key: plain EDF (deadline),
            # or the ledger-stamped (vfinish, deadline) WFQ tag
            order=lambda r: r.order,
        )
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"pw-decode-{self.label}"
        )
        self._thread.start()

    # --- admission --------------------------------------------------------

    def pages_needed(self, req: GenerationRequest) -> int:
        total = len(req.prompt_tokens) + req.max_new_tokens
        return -(-total // self.config.page_size)

    def submit(self, req: GenerationRequest) -> None:
        """Admit one generation request (raises ShedError when it can
        never be served, or when the queue is full)."""
        total = len(req.prompt_tokens) + req.max_new_tokens
        if total > self.config.max_len:
            raise ShedError(
                400,
                f"prompt+max_tokens ({total}) exceeds the decoder bound "
                f"({self.config.max_len})",
                0.0,
            )
        if self.pages_needed(req) > self.pool.capacity:
            raise ShedError(
                503,
                f"request needs {self.pages_needed(req)} KV pages; the "
                f"pool holds {self.pool.capacity} "
                "(raise PATHWAY_GENERATE_PAGES)",
                1.0,
            )
        with self._lock:
            if self._stopping:
                raise ShedError(503, "generation scheduler stopped", 1.0)
            backlog = len(self._waiting) + len(self._staged)
        # the EDF heap is part of the backlog: with the active set full
        # the batcher never dispatches, so without this term the queue
        # bound could never fire
        backlog += len(self.batcher)
        ledger = self.tenant_ledger
        tag = None
        if ledger is not None:
            # may shed 429 tenant_rate: fairness holds at the decode door
            tag = ledger.admit(req.tenant, req.tenant_class)
            req.order = (tag, req.deadline)
        if backlog >= self.qos.max_queue:
            if ledger is not None:
                # never entered the queue: give the fair-share token back
                ledger.refund(req.tenant, req.tenant_class, tag)
            self._m_requests.labels(self.label, "shed_queue").inc()
            raise ShedError(429, "generation queue full", 0.5)
        self.batcher.put(req)
        if ledger is not None:
            ledger.commit(req.tenant)

    def _slots_free(self) -> int:
        # dispatch capacity for the batcher: free active-set slots
        with self._lock:
            return max(
                self.config.max_batch
                - len(self._active)
                - len(self._staged)
                - len(self._waiting),
                0,
            )

    def _dispatch(self, reqs: list) -> None:
        # batcher flush thread: sequences JOIN BETWEEN steps — stage them
        # and let the decode loop fold them in at its boundary
        if self.tenant_ledger is not None:
            for r in reqs:
                # advance WFQ virtual time at dispatch: later arrivals
                # floor here, so an idle tenant cannot bank credit
                self.tenant_ledger.note_dispatched(r.order)
        with self._lock:
            self._staged.extend(reqs)
            self._cond.notify()

    def _reject(self, req: Any, exc: BaseException) -> None:
        if isinstance(exc, DeadlineExceeded):
            self._m_requests.labels(self.label, "expired_queued").inc()
            req.finish({"status": 504, "error": "deadline expired before decode started"})
        else:
            self._m_requests.labels(self.label, "shed_queue").inc()
            status = getattr(exc, "status", 503)
            req.finish({"status": status, "error": str(exc) or "shed"})

    # --- the decode loop --------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while (
                    not self._stopping
                    and not self._active
                    and not self._staged
                    and not self._waiting
                    and not self._snap_waiters
                ):
                    self._cond.wait(0.5)
                last_round = self._stopping and not self._active
            self._serve_snapshot_waiters()
            if last_round:
                return
            try:
                self._step()
            except Exception:
                logging.getLogger("pathway_tpu_torch").exception(
                    "generate: decode step failed; dropping the batch"
                )
                with self._lock:
                    doomed, self._active = self._active, []
                for s in doomed:
                    self._finish_seq(
                        s, {"status": 500, "error": "decode step failed"}, outcome="error"
                    )

    def _sweep_expired(self, now: float) -> None:
        """Deadline propagation MID-decode: expired actives answer 504
        and their pages return to the pool before any further step."""
        with self._lock:
            dead = [s for s in self._active if s.deadline < now]
            self._active = [s for s in self._active if s.deadline >= now]
            dead_wait = [r for r in self._waiting if r.deadline < now]
            self._waiting = [r for r in self._waiting if r.deadline >= now]
        if dead:
            # a mid-decode deadline drop is an incident (a client saw a 504
            # after tokens were minted): one journal event per sweep
            journal_record(
                "mid-decode-drop",
                f"{len(dead)} generation(s) dropped mid-decode by deadline propagation",
                replica=self.label,
                dropped=len(dead),
                tokens_lost=sum(len(s.generated) for s in dead),
            )
        for s in dead:
            self._m_dropped.inc()
            self._finish_seq(
                s,
                {
                    "status": 504,
                    "error": "deadline expired mid-decode",
                    "tokens": len(s.generated),
                },
                outcome="dropped_mid_decode",
            )
        for r in dead_wait:
            self._m_requests.labels(self.label, "expired_queued").inc()
            r.finish({"status": 504, "error": "deadline expired waiting for KV pages"})

    def _admit_staged(self) -> None:
        """Fold staged + page-starved requests into the active set (at
        the step boundary, never mid-step)."""
        with self._lock:
            incoming = self._waiting + self._staged
            self._waiting, self._staged = [], []
        for req in incoming:
            with self._lock:
                room = len(self._active) < self.config.max_batch
            pages = self.pool.try_alloc(self.pages_needed(req)) if room else None
            if pages is None:
                with self._lock:
                    self._waiting.append(req)  # retried next boundary
                continue
            with self._lock:
                self._seq_counter += 1
                seq_id = self._seq_counter
            seq = _Seq(
                seq_id=seq_id,
                req=req,
                tokens=[int(t) for t in req.prompt_tokens],
                prompt_len=len(req.prompt_tokens),
                max_new=req.max_new_tokens,
                temperature=req.temperature,
                top_k=req.top_k,
                seed=req.seed,
                pages=pages,
                trace_ctx=tracing.parse_traceparent(req.traceparent),
                deadline=req.deadline,
                tenant=req.tenant,
            )
            with self._lock:
                self._active.append(seq)

    def _page_table_rows(self, seqs: list[_Seq], bucket: int) -> np.ndarray:
        pt = np.zeros((bucket, self.dcfg.max_pages), np.int32)
        for i, s in enumerate(seqs):
            pt[i, : len(s.pages)] = s.pages
        return pt

    def _step(self) -> None:
        now = time.monotonic()
        self._sweep_expired(now)
        self._admit_staged()
        with self._lock:
            batch = list(self._active[: self.config.max_batch])
        if not batch:
            return
        bucket = self.qos.bucket_for(len(batch))
        tokens = np.zeros(bucket, np.int32)
        positions = np.zeros(bucket, np.int32)
        seq_lens = np.zeros(bucket, np.int32)
        for i, s in enumerate(batch):
            tokens[i] = s.next_token
            positions[i] = s.n_fed
            seq_lens[i] = s.n_fed + 1
        pt = self._page_table_rows(batch, bucket)

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        span = tracing.get_tracer().span(
            "generate.decode_step", replica=self.label, batch=len(batch), bucket=bucket
        )
        with span:
            t0 = time.perf_counter()
            logits, self.k_pool, self.v_pool = self._dec.decode_step(
                self.params,
                dev(tokens),
                dev(positions),
                self.k_pool,
                self.v_pool,
                dev(pt),
                dev(seq_lens),
                cfg=self.dcfg,
                kernel=self.kernel,
            )
            host_logits = logits.cpu().numpy()
            wall = time.perf_counter() - t0
        self.step_seconds.append(wall)
        self._roofline(bucket, int(seq_lens.sum()), wall)
        self._m_batch.observe(len(batch))
        self._m_steps.inc()
        finished: list[tuple[_Seq, dict]] = []
        for i, s in enumerate(batch):
            s.n_fed += 1
            if s.n_fed < s.prompt_len:
                # still feeding the prompt: prefill work shows in the token
                # accounting (it dominates TTFT cost)
                self._m_tokens.labels(self.label, "prefill").inc()
                continue
            tok = self._dec.sample_token(
                host_logits[i],
                temperature=s.temperature,
                top_k=s.top_k,
                seed=s.seed,
                step=len(s.generated),
            )
            if s.first_token_at is None:
                s.first_token_at = time.monotonic()
                ttft = s.first_token_at - (s.req.created_at if s.req is not None else now)
                self._m_ttft.observe(ttft)
                # prefill completion marker: admission -> first sampled
                # token, parented into the request's trace (emitted at
                # completion, so no context outlives a loop iteration)
                with tracing.get_tracer().span(
                    "generate.prefill",
                    parent=s.trace_ctx,
                    root=s.trace_ctx is None,
                    replica=self.label,
                    prompt_tokens=s.prompt_len,
                    ttft_ms=round(ttft * 1000.0, 3),
                ):
                    pass
            s.generated.append(tok)
            s.tokens.append(tok)
            self._m_tokens.labels(self.label, "sampled").inc()
            done = (
                tok == self._dec.EOS
                or len(s.generated) >= s.max_new
                or s.n_fed + 1 >= self.config.max_len
            )
            if s.req is not None and s.req.on_token is not None:
                try:
                    s.req.on_token(tok, done)
                except Exception:
                    pass
            if done:
                finished.append(
                    (
                        s,
                        {
                            "status": 200,
                            "tokens": list(s.generated),
                            "text": self._dec.decode_tokens(s.generated),
                            "token_count": len(s.generated),
                        },
                    )
                )
        with self._lock:
            self._step_count += 1
            step_n = self._step_count
            done_ids = {id(s) for s, _ in finished}
            self._active = [s for s in self._active if id(s) not in done_ids]
        for s, result in finished:
            self._finish_seq(s, result, outcome="ok")
        if finished:
            self.batcher.notify()  # active-set slots freed
        if (
            self.config.snapshot_every > 0
            and self.config.store_root
            and step_n % self.config.snapshot_every == 0
        ):
            self.snapshot()
        plan = faults.active()
        if plan is not None:
            plan.on_decode_step(step_n)

    def _roofline(self, bucket: int, ctx: int, wall: float) -> None:
        """Tick Scope roofline, family "paged_attention": one decode step at
        this bucket. Analytic FLOPs: 2 * params * batch for the products,
        plus the attention over the live context."""
        rl = tickscope.roofline()
        key = f"decode_b{bucket}_{self.kernel}"
        if not rl.known("paged_attention", key):
            if self._n_params is None:
                self._n_params = _numel(self.params)
            d = self.dcfg
            flops = 2.0 * self._n_params * bucket + 4.0 * d.n_layers * d.n_heads * d.head_dim * ctx
            rl.register("paged_attention", key, flops, source="analytic")
        rl.observe("paged_attention", key, wall)

    def _finish_seq(self, seq: _Seq, result: dict, *, outcome: str) -> None:
        """Answer + reclaim: pages return to the pool and the ledger
        retracts the sequence's rows the moment it leaves the plane."""
        with self._lock:  # vs stop(): exactly one side frees
            pages, seq.pages = seq.pages, []
        if pages:
            self.pool.free(pages)
        self.ledger.drop_seq(seq.seq_id)
        self._m_requests.labels(self.label, outcome).inc()
        if seq.req is not None:
            seq.req.finish(result)
            rid = seq.req.request_id
        else:
            rid = f"restored-{seq.seq_id}"
        self.finished[rid] = result
        while len(self.finished) > 256:
            self.finished.pop(next(iter(self.finished)))

    # --- durability -------------------------------------------------------

    def _mirror(self) -> None:
        """Mirror pages that changed since the last mirror (earlier pages
        are immutable once full) + resume metadata into the ledger."""
        now = time.monotonic()
        p = self.config.page_size
        with self._lock:
            # pages captured under the SAME lock _finish_seq swaps them
            # under: a snapshot racing a completion must never read a
            # reclaimed (possibly reallocated) page
            actives = [(s, list(s.pages)) for s in self._active]
        dirty: list[tuple[int, int]] = []  # (seq_id, logical page)
        pids: list[int] = []
        for s, pages in actives:
            if not pages:
                continue  # finished between capture and here
            last = max(s.n_fed - 1, 0) // p
            if s.n_fed > 0 and last < len(pages):
                for page_idx in range(s.n_mirrored // p, last + 1):
                    dirty.append((s.seq_id, page_idx))
                    pids.append(pages[page_idx])
        if pids:
            # gather the dirty pages on the card, one pull for K and one
            # for V: [L, n_dirty, H, P, Dp] f32
            idx = torch.tensor(pids, dtype=torch.long, device=self.k_pool.device)
            k_host = self.k_pool.index_select(1, idx).cpu().numpy()
            v_host = self.v_pool.index_select(1, idx).cpu().numpy()
            for j, (seq_id, page_idx) in enumerate(dirty):
                self.ledger.put_page(seq_id, page_idx, k_host[:, j].copy(), v_host[:, j].copy())
        for s, pages in actives:
            if pages:
                s.n_mirrored = s.n_fed
                self.ledger.put_seq(s.seq_id, s.meta(now))

    def _snapshot_inline(self) -> dict | None:
        root = self.config.store_root
        if not root:
            return None
        self._mirror()
        return self.ledger.snapshot(root)

    def _serve_snapshot_waiters(self) -> None:
        with self._lock:
            waiters, self._snap_waiters = self._snap_waiters, []
        for holder, ev in waiters:
            try:
                holder["result"] = self._snapshot_inline()
            except Exception as exc:
                holder["error"] = exc
            ev.set()

    def snapshot(self, timeout: float = 30.0) -> dict | None:
        """Mirror + write the incremental arrangement snapshot; returns
        ``{"bytes_written", "segments_written"}`` (None without a
        ``store_root``).

        Safe from any thread: an out-of-thread call is executed AT the next
        step boundary by the decode thread (decode_step writes the pools in
        place, so another thread must never read them mid-step); the decode
        thread's own periodic call runs inline."""
        if threading.current_thread() is self._thread or not self._thread.is_alive():
            return self._snapshot_inline()
        holder: dict = {}
        ev = threading.Event()
        with self._cond:
            self._snap_waiters.append((holder, ev))
            self._cond.notify()
        if not ev.wait(timeout):
            raise TimeoutError("decode loop did not reach a step boundary in time")
        if "error" in holder:
            raise holder["error"]
        return holder.get("result")

    def _restore(self, root: str) -> None:
        """Rebuild pools, page tables and sequence state from the newest
        manifest under ``root`` (no manifest: start empty). Runs in
        ``__init__`` on the caller's thread, before the decode thread."""
        led = KvLedger.restore(root)
        if led is None:
            return
        self.ledger = led
        now = time.monotonic()
        pages = led.live_pages()
        got = self.pool.try_alloc(len(pages))
        if got is None:  # pool shrank across the restart
            raise RuntimeError(
                "KV page pool too small to restore the snapshot "
                f"(needs > {self.pool.capacity} pages)"
            )
        assigned = dict(zip(pages, got))
        if pages:
            # the restored pages built on the host, written to the device
            # pools with one index_copy_ each along the page axis
            k = np.stack([np.asarray(kp, np.float32) for kp, _vp, _i in pages.values()], axis=1)
            v = np.stack([np.asarray(vp, np.float32) for _kp, vp, _i in pages.values()], axis=1)
            idx = torch.tensor(got, dtype=torch.long, device=self.k_pool.device)
            self.k_pool.index_copy_(1, idx, torch.from_numpy(k).to(self.k_pool.device))
            self.v_pool.index_copy_(1, idx, torch.from_numpy(v).to(self.v_pool.device))
        for seq_id, meta in led.live_seqs().items():
            n_fed = int(meta["n_fed"])
            n_pages_owned = int(
                meta.get("n_pages", -(-max(n_fed, 1) // self.config.page_size))
            )
            page_ids: list[int] = []
            for page_idx in range(n_pages_owned):
                pid = assigned.get((seq_id, page_idx))
                if pid is None:
                    # a page the mirror had not covered yet (or reserved
                    # but never written): fresh allocation
                    fresh = self.pool.try_alloc(1)
                    if fresh is None:
                        raise RuntimeError("KV page pool too small to restore")
                    pid = fresh[0]
                page_ids.append(pid)
            gen_count = int(meta["n_generated"])
            toks = [int(t) for t in meta["tokens"]]
            seq = _Seq(
                seq_id=seq_id,
                req=None,  # the client died with the old process
                tokens=toks,
                prompt_len=int(meta["prompt_len"]),
                max_new=int(meta["max_new"]),
                temperature=float(meta["temperature"]),
                top_k=int(meta["top_k"]),
                seed=int(meta["seed"]),
                pages=page_ids,
                n_fed=n_fed,
                n_mirrored=n_fed,
                generated=toks[len(toks) - gen_count :] if gen_count else [],
                deadline=now + float(meta["remaining_ms"]) / 1000.0,
                tenant=meta.get("tenant"),
            )
            self._seq_counter = max(self._seq_counter, seq_id)
            self._active.append(seq)
        self.restored_seqs = len(self._active)

    # --- introspection / lifecycle ---------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "active_seqs": len(self._active),
                "waiting": len(self._waiting) + len(self._staged),
                "decode_steps": self._step_count,
                "free_pages": self.pool.free_pages,
                "page_capacity": self.pool.capacity,
                "kernel": self.kernel,
            }

    def drain(self, timeout: float = 30.0) -> bool:
        """Finish everything admitted; returns False on timeout."""
        deadline = time.monotonic() + timeout
        self.batcher.drain()
        while time.monotonic() < deadline:
            with self._lock:
                idle = not self._active and not self._staged and not self._waiting
            if idle and not len(self.batcher):
                return True
            time.sleep(0.02)
        return False

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            doomed = self._active + self._waiting + self._staged
            self._active, self._waiting, self._staged = [], [], []
            self._cond.notify()
        self.batcher.close(reject_queued=ShedError(503, "generation scheduler stopped", 1.0))
        for item in doomed:
            req = item.req if isinstance(item, _Seq) else item
            if isinstance(item, _Seq):
                with self._lock:
                    pages, item.pages = item.pages, []
                if pages:
                    self.pool.free(pages)
            if req is not None:
                req.finish({"status": 503, "error": "scheduler stopped"})
        self._thread.join(timeout=5.0)
