"""Drives the port along its main path, as the README's user script does:
``pw.io.python`` subjects -> the ``SentenceTransformerEmbedder`` UDF ->
``DataIndex`` over ``TpuKnn`` (the block top-k kernel) ->
``pw.io.subscribe``.

One general traffic generator reads the traffic file. Its sources run side
by side, each in a thread of its own:

* queries through the query subject (``next()``; the subject autocommits
  after ``autocommit_ms``), either ``clients`` > 0, a closed loop in which
  each client sends its next query from the reply's callback, or
  ``arrivals``, an open loop sending at Poisson times of a fixed rate;
* ``ingest``: passages in commits of ``commit_rows``, the next commit as
  soon as fewer than ``max_unfinished`` commits are unfinished, or every
  ``period_s`` seconds. Right after each commit one probe query, a copy of
  one of the commit's passages, is committed; the commit is finished when
  the probe's reply ranks one of the commit's passages first.

A key the generator does not implement refuses the traffic file.

Before the window the configuration's prefilled vectors are loaded and the
traffic runs ``warmup_s`` seconds (and ``warmup_commits`` commits), so every
shape the window uses has run once; that is set-up. The window lasts
``seconds``; then nothing new is sent, and what was sent in it is waited
for, a minute at most.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmarks.harness import textgen, weights as weights_mod

DRAIN_S = 60.0
PROBE_QID = 1 << 40
TRAFFIC_KEYS = {"what", "clients", "arrivals", "autocommit_ms", "warmup_s", "pool", "judged_replies",
                "ingest"}
ARRIVAL_KEYS = {"process", "rate_per_s"}
INGEST_KEYS = {"commit_rows", "max_unfinished", "period_s", "warmup_commits"}


def check_traffic(traffic: dict) -> None:
    """Refuse a traffic file that asks for what the generator does not do."""

    def known(part: dict, keys: set, where: str) -> None:
        extra = sorted(set(part) - keys)
        if extra:
            raise ValueError(f"traffic{where}: the generator implements no {extra}")

    known(traffic, TRAFFIC_KEYS, "")
    arrivals, ingest = traffic.get("arrivals"), traffic.get("ingest")
    if traffic.get("clients") and arrivals:
        raise ValueError("traffic: clients (a closed loop) and arrivals (an open loop) exclude each other")
    if arrivals:
        known(arrivals, ARRIVAL_KEYS, ".arrivals")
        if arrivals.get("process") != "poisson" or not arrivals.get("rate_per_s", 0) > 0:
            raise ValueError("traffic.arrivals: only poisson arrivals at a rate_per_s > 0")
    if ingest:
        known(ingest, INGEST_KEYS, ".ingest")
        if ("max_unfinished" in ingest) == ("period_s" in ingest):
            raise ValueError("traffic.ingest: give one of max_unfinished and period_s")
    if not (traffic.get("clients") or arrivals or ingest):
        raise ValueError("traffic: no clients, arrivals or ingest: nothing to send")


def torch_seed(seed: int, stream: int) -> int:
    return int(textgen.seed_seq(seed, stream).generate_state(1, np.uint64)[0]) % (1 << 63)


# the seeded streams of one run
WEIGHTS, CORPUS, QUERIES, PASSAGES, PROBES = range(5)
ARRIVALS = 7  # (6 is the judge's sample)


def corpus_blocks(cfg: dict, seed: int, device):
    """The prefilled corpus as (first row, [rows, D] unit f32) blocks made
    on the device, the same for the program and the reference."""
    idx = cfg["index"]
    rows, d, step = idx["prefilled_rows"], cfg["encoder"]["hidden_size"], idx["prefill_commit_rows"]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, CORPUS))
    for lo in range(0, rows, step):
        v = torch.randn(min(step, rows - lo), d, generator=gen, device=device)
        yield lo, v / v.norm(dim=-1, keepdim=True)


@contextlib.contextmanager
def loaded_weights(encoder_module):
    """The port's only way to an encoder is a checkpoint on disk or its own
    seeded init; the benchmark's weights are made on the device, so the
    seeded init (a numpy draw of every parameter) is skipped while the
    embedder is built and the weights are copied in afterwards."""
    init = encoder_module.init_weights
    encoder_module.init_weights = lambda module, seed: module
    try:
        yield
    finally:
        encoder_module.init_weights = init


@dataclass
class Record:
    """What the run observed, on the harness's clock (perf_counter s)."""

    setup_s: float = 0.0
    t0: float = 0.0
    t1: float = 0.0
    sent: dict = field(default_factory=dict)  # qid -> (t, text, words)
    replies: dict = field(default_factory=dict)  # qid -> (t, pids, scores, keys)
    passages: list = field(default_factory=list)  # every passage text; pid = prefilled_rows + i
    passage_words: list = field(default_factory=list)
    commits: list = field(default_factory=list)  # (t, first pid, end pid, probe qid, probe pid)
    probe_done: dict = field(default_factory=dict)  # probe qid -> (t, ok)
    committed_at_reply: dict = field(default_factory=dict)  # probe qid -> end pid committed by then
    ticks: tuple = (0, 0)
    node_ns: tuple = ({}, {})
    embed_nodes: set = field(default_factory=set)
    index_nodes: set = field(default_factory=set)
    spans: list = field(default_factory=list)  # (name, start perf ns, dur ns, attributes)
    host_spans: list = field(default_factory=list)  # the harness's own: (name, t start, t end)
    query_vecs: dict = field(default_factory=dict)  # qid -> the program's query embedding
    passage_vecs: dict = field(default_factory=dict)  # pid -> the program's passage embedding
    topk_launches: tuple = ({}, {})  # the window's block_topk launches by (B, k) and by N
    memory_peak_bytes: int = 0
    prefilled_rows: int = 0
    trace: dict | None = None
    failure: BaseException | None = None


def together(*calls) -> None:
    """Run the calls side by side, each in a thread; re-raise the first failure."""
    failures: list[BaseException] = []

    def guarded(call):
        try:
            call()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            failures.append(e)

    threads = [threading.Thread(target=guarded, args=(c,), daemon=True) for c in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failures:
        raise failures[0]


class _Queries:
    """Queries through the query subject; a reply frees its request."""

    def __init__(self, rec: Record, subject, stream: textgen.TextStream):
        self.rec, self.subject, self.stream = rec, subject, stream
        self.next_qid = 0
        self.outstanding: set[int] = set()
        self.cv = threading.Condition()

    def send(self) -> None:
        texts, words = self.stream.take(1)
        with self.cv:
            qid = self.next_qid
            self.next_qid += 1
            self.outstanding.add(qid)
        self.rec.sent[qid] = (time.perf_counter(), texts[0], words[0])
        self.subject.next(qid=qid, q=texts[0])

    def on_reply(self, qid: int) -> None:
        with self.cv:
            self.outstanding.discard(qid)
            self.cv.notify_all()

    def wait_idle(self, timeout: float) -> None:
        with self.cv:
            self.cv.wait_for(lambda: not self.outstanding, timeout=timeout)


class _ClosedLoop(_Queries):
    """``clients`` clients, each sending its next query on its reply."""

    def __init__(self, rec, subject, stream, clients: int):
        super().__init__(rec, subject, stream)
        self.clients = clients
        self.sending = False

    def on_reply(self, qid: int) -> None:
        super().on_reply(qid)
        if self.sending:
            self.send()

    def run_for(self, seconds: float) -> None:
        self.sending = True
        for _ in range(self.clients):
            self.send()
        time.sleep(seconds)
        self.sending = False


class _OpenLoop(_Queries):
    """Queries at Poisson times: the gaps cycle through permutations of one
    fixed multiset (the exponential's quantiles at the rate), the same for
    every seed, which only orders them."""

    def __init__(self, rec, subject, stream, arrivals: dict, pool: int, order_seq):
        super().__init__(rec, subject, stream)
        rate = float(arrivals["rate_per_s"])
        self.gaps = -np.log1p(-(np.arange(pool) + 0.5) / pool) / rate
        self.rng = np.random.default_rng(order_seq)
        self._order: list[float] = []

    def run_for(self, seconds: float) -> None:
        at = time.perf_counter()
        end = at + seconds
        while True:
            if not self._order:
                self._order = list(self.rng.permutation(self.gaps))
            at += self._order.pop()
            if at >= end:
                return
            pause = at - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
            self.send()


class _Feeder:
    def __init__(self, rec: Record, passages_subject, probe_subject, stream, probe_rng, ingest: dict):
        self.rec, self.ps, self.qs, self.stream = rec, passages_subject, probe_subject, stream
        self.rng, self.rows = probe_rng, ingest["commit_rows"]
        self.ahead, self.period = ingest.get("max_unfinished"), ingest.get("period_s")
        self.unfinished: set[int] = set()
        self.committed_end = rec.prefilled_rows  # the pid after the last committed passage
        self.cv = threading.Condition()

    def commit_one(self) -> None:
        if self.ahead:
            with self.cv:
                self.cv.wait_for(lambda: len(self.unfinished) < self.ahead, timeout=DRAIN_S)
        rec = self.rec
        texts, words = self.stream.take(self.rows)
        first = rec.prefilled_rows + len(rec.passages)
        rec.passages.extend(texts)
        rec.passage_words.extend(words)
        t_push = time.perf_counter()
        for j, text in enumerate(texts):
            self.ps.next(pid=first + j, text=text)
        qid = PROBE_QID + len(rec.commits)
        pick = first + int(self.rng.integers(0, self.rows))
        text = rec.passages[pick - rec.prefilled_rows]
        with self.cv:
            self.unfinished.add(qid)
        t = time.perf_counter()
        self.ps.commit()
        self.committed_end = first + self.rows
        rec.commits.append((t, first, first + self.rows, qid, pick))
        rec.sent[qid] = (time.perf_counter(), text, rec.passage_words[pick - rec.prefilled_rows])
        self.qs.next(qid=qid, q=text)
        self.qs.commit()
        rec.host_spans.append(("feeder.push_and_commit", t_push, time.perf_counter()))

    def commits(self, count: int) -> None:
        for _ in range(count):
            self.commit_one()

    def run_for(self, seconds: float) -> None:
        start = time.perf_counter()
        end, i = start + seconds, 0
        while True:
            if self.period:
                at = start + i * self.period
                if at >= end:
                    return
                time.sleep(max(0.0, at - time.perf_counter()))
            elif time.perf_counter() >= end:
                return
            self.commit_one()
            i += 1

    def on_reply(self, qid: int, pids) -> None:
        rec = self.rec
        commit = rec.commits[qid - PROBE_QID]
        ok = len(pids) > 0 and commit[1] <= pids[0] < commit[2]
        rec.probe_done[qid] = (time.perf_counter(), ok)
        rec.committed_at_reply[qid] = self.committed_end
        with self.cv:
            self.unfinished.discard(qid)
            self.cv.notify_all()

    def wait_idle(self, timeout: float) -> None:
        with self.cv:
            self.cv.wait_for(lambda: not self.unfinished, timeout=timeout)


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, tracer_hooks=None) -> Record:
    """Build the pipeline, run set-up, the window and the drain; return
    what was observed. The program's state is released before returning."""
    check_traffic(traffic)
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec, ExternalIndexNode
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.observability import tracing
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.stdlib.indexing import DataIndex, TpuKnn
    from pathway_tpu_torch.xpacks.llm import _encoder, embedders

    dev = torch.device(device)
    enc, idx = cfg["encoder"], cfg["index"]
    rec = Record(prefilled_rows=idx.get("prefilled_rows", 0))
    w = weights_mod.make(enc, torch_seed(seed, WEIGHTS), dev)
    with loaded_weights(_encoder):
        emb = embedders.SentenceTransformerEmbedder(
            device=dev, dim=enc["hidden_size"], depth=enc["num_hidden_layers"],
            heads=enc["num_attention_heads"], max_len=enc["max_seq_length"])
    if type(emb.tokenizer).__name__ != "HashingTokenizer" or emb.tokenizer.vocab_size != enc["vocab_size"]:
        raise RuntimeError(f"the embedder chose {emb.tokenizer!r}, not the configured hashing tokenizer")
    if enc["intermediate_size"] != 4 * enc["hidden_size"]:
        raise RuntimeError("the port's encoder has a feed-forward of 4 x hidden_size only")
    emb.runtime.model.load_state_dict(w)
    del w

    parse_graph.G.clear()
    tracer = tracing.get_tracer()
    tracer.clear()

    class Passage(pw.Schema):
        pid: int = pw.column_definition(primary_key=True)
        text: str

    class Vector(pw.Schema):
        pid: int = pw.column_definition(primary_key=True)
        vec: np.ndarray

    class Query(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        q: str

    finished = threading.Event()

    class Idle(pw.io.python.ConnectorSubject):
        def run(self):
            finished.wait()

    class QuerySubject(pw.io.python.ConnectorSubject):
        def run(self):
            try:
                drive(self)
            except BaseException as e:  # noqa: BLE001 - re-raised after pw.run
                rec.failure = e
            finally:
                finished.set()

    parts, vec_subject, passage_subject = [], None, None
    if rec.prefilled_rows:
        vec_subject = Idle()
        vecs = pw.io.python.read(vec_subject, schema=Vector, autocommit_duration_ms=None)
        parts.append(vecs.select(vec=pw.this.vec, pid=pw.this.pid))
    ingest = traffic.get("ingest")
    if ingest:
        passage_subject = Idle()
        texts = pw.io.python.read(passage_subject, schema=Passage, autocommit_duration_ms=None)
        parts.append(texts.select(vec=emb(pw.this.text), pid=pw.this.pid))
    corpus = parts[0]
    for extra in parts[1:]:
        corpus = corpus.concat_reindex(extra)
    index = DataIndex(corpus, TpuKnn(corpus.vec, dimensions=enc["hidden_size"],
                                     reserved_space=idx["reserved_space"], device=device))
    query_subject = QuerySubject()
    queries = pw.io.python.read(query_subject, schema=Query,
                                autocommit_duration_ms=traffic["autocommit_ms"])
    qv = queries.select(qid=pw.this.qid, v=emb(pw.this.q))
    answers = index.query_as_of_now(qv.v, number_of_matches=idx["k"]).select(
        qid=pw.left.qid, ids=pw.right._pw_index_reply_id,
        scores=pw.right._pw_index_reply_score, pid=pw.right.pid)
    embed_tables = [qv] + ([parts[-1]] if ingest else [])

    loop = feeder = None
    qstream = textgen.TextStream(textgen.seed_seq(seed, QUERIES), cfg["queries"], traffic["pool"])
    if traffic.get("clients"):
        loop = _ClosedLoop(rec, query_subject, qstream, traffic["clients"])
    elif traffic.get("arrivals"):
        loop = _OpenLoop(rec, query_subject, qstream, traffic["arrivals"], traffic["pool"],
                         textgen.seed_seq(seed, ARRIVALS))
    if ingest:
        pstream = textgen.TextStream(textgen.seed_seq(seed, PASSAGES), cfg["passages"], traffic["pool"])
        feeder = _Feeder(rec, passage_subject, query_subject, pstream,
                         np.random.default_rng(textgen.seed_seq(seed, PROBES)), ingest)

    def on_reply(key, row, is_addition, **_time):
        if not is_addition or row["qid"] in rec.replies:
            return
        qid = row["qid"]
        pids = tuple(int(p) for p in row["pid"])
        rec.replies[qid] = (time.perf_counter(), pids, tuple(row["scores"]), tuple(row["ids"]))
        if qid >= PROBE_QID:
            feeder.on_reply(qid, pids)
        else:
            loop.on_reply(qid)

    pw.io.subscribe(answers, on_change=on_reply)

    # the embeddings the index was handed, for judging the index apart
    # from the encoder
    def on_query_vec(key, row, is_addition, **_time):
        if is_addition:
            rec.query_vecs[row["qid"]] = row["v"]

    pw.io.subscribe(qv, on_change=on_query_vec)
    if ingest:
        def on_passage_vec(key, row, is_addition, **_time):
            if is_addition:
                rec.passage_vecs[row["pid"]] = row["vec"]

        pw.io.subscribe(parts[-1], on_change=on_passage_vec)

    def engine_index():
        rt = parse_graph.G.runtime
        return next(ex.index for ex in rt.execs.values() if isinstance(ex, ExternalIndexExec))

    def wait_for(cond, what: str, timeout: float = 600.0) -> None:
        end = time.perf_counter() + timeout
        while not cond():
            if time.perf_counter() > end:
                raise RuntimeError(f"timed out waiting for {what}")
            time.sleep(0.001)

    def load_prefill() -> None:
        ix = engine_index()
        for lo, block in corpus_blocks(cfg, seed, dev):
            host = block.cpu().numpy()
            for j in range(host.shape[0]):
                vec_subject.next(pid=lo + j, vec=host[j])
            vec_subject.commit()
            target = lo + host.shape[0]
            wait_for(lambda: len(ix) >= target, "a prefill commit")

    def drive(_subject) -> None:
        rt = parse_graph.G.runtime
        if rec.prefilled_rows:
            load_prefill()
        sources = [s for s in (loop, feeder) if s]
        warmups = [lambda: loop.run_for(traffic["warmup_s"])] if loop else []
        if feeder:
            warmups.append(lambda: feeder.commits(ingest["warmup_commits"]))
        together(*warmups)
        for source in sources:
            source.wait_idle(DRAIN_S)
        if trace:
            tracer_hooks.start()
        snap0 = (rt.stats.ticks, dict(rt.stats.node_ns), Counter(bt.block_topk.shapes),
                 Counter(bt.block_topk.corpus_rows))
        rec.t0 = time.perf_counter()
        rec.setup_s = rec.t0 - t_start
        together(*(lambda s=s: s.run_for(seconds) for s in sources))
        rec.t1 = time.perf_counter()
        snap1 = (rt.stats.ticks, dict(rt.stats.node_ns), Counter(bt.block_topk.shapes),
                 Counter(bt.block_topk.corpus_rows))
        if trace:
            tracer_hooks.stop(rec)
        for source in sources:
            source.wait_idle(DRAIN_S)
        rec.ticks = (snap0[0], snap1[0])
        rec.node_ns = (snap0[1], snap1[1])
        rec.topk_launches = (dict(snap1[2] - snap0[2]), dict(snap1[3] - snap0[3]))
        rec.embed_nodes = {t._node.id for t in embed_tables}
        rec.index_nodes = {n.id for n in rt.order if isinstance(n, ExternalIndexNode)}

    gc_started: list[float] = []

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start":
            gc_started.append(time.perf_counter())
        elif gc_started:
            rec.host_spans.append((f"python.gc.gen{info['generation']}", gc_started.pop(),
                                   time.perf_counter()))

    gc.callbacks.append(on_gc)
    try:
        pw.run(autocommit_duration_ms=traffic["autocommit_ms"])
    finally:
        gc.callbacks.remove(on_gc)
    if rec.failure is not None:
        raise rec.failure
    anchor = tracing._ANCHOR_NS
    rec.spans = [(s.name, s.start_unix_ns - anchor, s.duration_ns, dict(s.attributes))
                 for s in tracer.spans()]
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    # release the program's state before the reference runs
    parse_graph.G.clear()
    if hasattr(parse_graph.G, "last_runtime"):
        parse_graph.G.last_runtime = None
    del emb, index, corpus, parts, queries, qv, answers, embed_tables
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec
