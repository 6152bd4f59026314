#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pathway_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a, one process per
source, all started together), then runs nineteen phases, printing one JSON
object per phase:

1. device         — nvidia-smi name/power limit, toolchain versions, build seconds.
2. kernel parity  — every kernel against its plain PyTorch version on the card.
                    block_topk: B in {1, 16, 64}, D = 384, N = 1024 * {1, 64, 1024},
                    k in {1, 10, 40, 1024}, f32 and bf16 corpora with exact ties,
                    invalid rows and fully invalid blocks; then random unit
                    vectors at the path shapes (B = 1 and 16 with k = 10, B = 32
                    with k = 3). paged_attention: B in
                    {1, 8, 64} x H in {1, 4, 32} x P in {8, 16} x Dp in {128, 256},
                    256 pages per table (contexts up to 4096 tokens) drawn from a
                    1025-page pool, ragged seq_lens with 0, P, P+1, full and < 0.
3. main path      — the live-RAG retrieval path at full default width:
                    SentenceTransformerEmbedder (vocab 30522, dim 384, depth 6,
                    heads 6, max_len 512, bf16, seeded init) embeds 4096 seeded
                    documents; TpuDenseKnnIndex(cosine, reserved 1<<20) holds them
                    beside ~1M seeded unit vectors; 64 query texts are answered in
                    batches of 1 and 16 (k = 10) plus one filtered batch. The
                    results are checked against kernel="torch" on the same index.
4. engine         — the same retrieval through the dataflow engine, as a user
                    writes it (``import pathway_tpu_torch as pw``): documents and
                    precomputed vectors stream in through pw.io.python (4096
                    documents in 16 commits of 256 through the embedder UDF at
                    the phase-3 width, 1,044,480 seeded unit vectors in commits
                    of 65,536, joined by concat_reindex), DataIndex over
                    TpuKnn(device="cuda", kernel auto) answers queries that
                    arrive as rows (64 ticks of B = 1, 8 of B = 16, k = 10),
                    then 16 live ticks of 64 new documents and a query for one
                    of them, then one tick retracting 64 documents and queries
                    for them; pw.io.subscribe collects the replies. Every
                    batch is one ConnectorSubject.commit() and one tick. Checked:
                    every reply against a direct TpuDenseKnnIndex.search on a
                    separate index holding the same rows (up to near ties), a
                    copied query finds its document first, a live document is
                    visible at rank 1 on the next tick, no retracted document
                    comes back, one kernel launch per index search at B = 1
                    and B = 16, one tick per commit, the embedder on cuda.
                    Prints ingest, embed, reply and update-to-visible times,
                    ticks per stage, and the corpus re-upload per dirty tick
                    (from the knn.corpus_upload span). Then 64 more B = 1
                    queries with Tick Scope's recorder on for every other
                    one: the reply p50 with it on and off, in one window.
5. vector store   — the RAG product layer as a user writes it: 32,768 documents
                    arrive as bytes through pw.io.python in 16 commits of 2048;
                    VectorStoreServer(device="cuda") parses (Utf8Parser), splits
                    (TokenCountSplitter(20, 60): 78,185 chunks), embeds (the
                    phase-3 embedder) and indexes them; query rows go through
                    retrieve_query (64 ticks of B = 1, 8 of B = 16 whose replies
                    also go through CrossEncoderReranker at its defaults and
                    rerank_topk_filter, 4 filtered ticks of B = 16, k = 10),
                    then 16 live ticks of 64 documents and a query for one of
                    them, one statistics_query, one filtered inputs_query and
                    8 asks through BaseRAGQuestionAnswerer(EchoChat()). Checked:
                    every reply against a plain-torch index holding the store's
                    rows (up to near ties), copied queries find their chunk
                    first, filters hold, file_count equals the chunks, the
                    inputs are exactly the matching paths, every kept rerank
                    score within RERANK_TOL of a direct forward_ids of the same
                    pairs, every echoed answer holds its retrieved texts,
                    block_topk launches equal the searches per shape, one tick
                    per commit. Prints embed, reply, update-to-visible and
                    rerank figures, engine seconds per operator, beside the
                    card's nvidia-smi name and power limit.
                    Phases 4-6 also print Tick Scope's split of their query
                    ticks (the engine's and the store's B = 1 and B = 16
                    ticks, the insert and remove ticks of the sequential
                    POSTs): seconds and rows in/out per operator type, and
                    the critical path of the slowest tick.
6. rest           — VectorStoreServer.run_server answering /v1/retrieve over
                    HTTP: the vector store phase's corpus (the same 32,768
                    documents in 16 commits of 2048, 78,185 chunks, the same
                    embedder, device="cuda") served ungated by run_server on
                    one port and, in the same graph, through a Surge Gate
                    (rest_connector with QoSConfig(max_batch_size=16,
                    max_wait_ms=5, max_queue=64) wired to retrieve_query) on
                    another. Stdlib http.client clients in a child process
                    (this script with --rest-client) send: 64 POST and 8 GET
                    one at a time, 4 filtered POST (k = 40 in the kernel),
                    16 clients x 8 ungated and 16 x 16 gated on keep-alive
                    connections, a burst of 256 at the gate, 16 requests with
                    a 1 ms budget, /v1/statistics, /v1/inputs and /_schema,
                    16 live commits of 64 documents each followed by a query
                    for one of them, stale reads through a stale responder
                    while the engine is marked recovering, and 16 requests in
                    flight when each server drains. Checked: every 200 reply
                    against a direct search, with the vector the embedder
                    computed for that request, of a plain-torch copy of the
                    store's index (up to near ties); an insert and a remove
                    tick per sequential request; the burst answered 200, or
                    429/503 with Retry-After, within its deadline; the 1 ms
                    requests 504 with no search; stale reads 200 with
                    x-pathway-stale and the fresh reads' documents, 503 past
                    x-pathway-max-staleness-ms 0; every drained request
                    answered, then connects refused. Prints reply p50 / p99 /
                    max per group, requests/s at 16 clients, the server's
                    pathway_rest_request_seconds p50, the HTTP overhead over
                    the vector store phase's B = 1 reply, update-to-visible,
                    the 429/503/504 counts and block_topk launches per shape.
7. persistence    — the first 9,216 of the vector store phase's documents
                    (cut from 32,768) written as files (tmp + rename) into a
                    folder, 12 batches of 768 (cut from 16), read by
                    pw.io.fs.read(format="binary", mode="streaming") into
                    VectorStoreServer(device="cuda") with
                    persistence_config=Config.simple_config(Backend.filesystem)
                    (a snapshot every 8 commits). A child (this script with
                    --persist-child) runs it with PATHWAY_FAULTS="kill=tick:10",
                    one tick per batch, and must exit 23 after batch 9.
                    Restart 1 restores the operator snapshot (batches 1-8),
                    replays the log tail (batch 9), seeks the scanner, reads
                    batch 10 again, answers one query (time to the first
                    correct reply), ingests the 2 remaining batches, answers
                    8 B = 1 (cut from 64) and 2 B = 16 queries (the vector
                    store phase's texts copied from those documents), then
                    1 write (cut from 4) of 64
                    documents, followed by a query for one of them,
                    then the 8 B = 1 texts again. Restart 2 adds no file
                    and asks the 8 again. Checked:
                    exit 23; restored from a snapshot with a non-empty
                    replayed tail, then none; the index holds each chunk of
                    the 12,288 documents exactly once (its keys against the
                    keys pw.io.fs and the two flattens give each chunk, whose
                    texts are the vector store phase's); every reply against a
                    direct search of a plain-torch copy of the index with the
                    vector the embedder computed for it (up to near ties);
                    restart 1's replies against the never-killed run's: a
                    search of the vector store phase's corpus vectors over
                    the chunks of the same documents (up to near ties within
                    CROSS_RUN_TOL);
                    restart 2's replies equal restart 1's last ones; restart
                    2 embeds its queries and no document; launches per shape.
                    Prints the kill tick and the files indexed, restore
                    seconds (operators, log tail ticks and rows, seek), time
                    to the first correct reply with the corpus upload's share,
                    snapshots (ms, bytes), the store's size, ingest chunks/s
                    beside the vector store phase's, update-to-visible and
                    reply p50 / max.
8. index kinds    — the other index kinds on the card, in four parts.
                    (a) DocumentStore over HybridIndexFactory([TantivyBM25Factory(),
                    BruteForceKnnFactory(the phase-3 embedder, device="cuda")]):
                    the first 16,384 of the vector store phase's documents
                    (cut from 32,768; 8 commits of 2048, Utf8Parser,
                    TokenCountSplitter(20, 60)), 16 B = 1 and 1
                    B = 16 queries (k = 10), then 4 live writes of 64
                    documents, each followed by a query for one of them.
                    Checked: every reply against a direct computation — the
                    reference's BM25 written out here over the same chunks,
                    a direct dense search (kernel="torch") on a copy of the
                    store's dense index, fused by RRF (k = 60) — ranked by
                    fused score with the same chunks at each score (a dense
                    near tie is read back from the fused scores and allowed),
                    a copied query finds its chunk first, block_topk launches
                    equal the dense searches per shape. (b) DataIndex over
                    IvfKnn(device="cuda") at its defaults (704 clusters, 27
                    probes at 500,000 rows) through the engine: the first
                    500,000 rows of bench.py's accelerator IVF mixture
                    (1,000,000 x 384 f32, 2000 centres, noise 0.35,
                    default_rng(7); cut from all of it beside the
                    observability phase) in commits of 65,536 via
                    pw.io.python, then 16 B = 1 and 1 B = 16 queries
                    (k = 10); the index trains once. Checked: every score is its row's cosine - 1
                    (numpy, 1e-5), replies descend, every key's cluster is
                    among the query's probes (numpy, from the index's
                    centroids), recall@10 >= 0.95 against the exact top-10
                    (block_topk over the same rows). (c) IvfDeviceIndex at
                    bench.py's shape (n_probe None, spill 2, its 50 queries):
                    recall@10 >= 0.95, no duplicate id in a reply. (d) DataIndex
                    over LshKnn(dimensions=384, device="cuda") at the reference
                    defaults over the mixture's first 32,768 rows (cut: one
                    device call and one sync per upserted row), 16 queries:
                    the card's bucket ids equal the CPU's but within 1e-4 x
                    bucket_length of a cell edge, every key shares a bucket
                    with its query, every score is -|q - v|^2; the segment ops
                    on 1,048,576 values into 4096 segments (some empty, ids out
                    of range), f32 and int32, against numpy. Prints reply p50 /
                    max per batch size, update-to-visible, BM25 ms per query,
                    RRF us per tick, IVF train / assign s, recall, per-row LSH
                    upsert us, and each device op's ms against its bound.
9. components     — a live semantic-components pipeline as a user writes it:
                    16,384 seeded documents in 2,048 families of 8 (each
                    variant drops, swaps or replaces 2 words of the one
                    before) arrive through pw.io.python in one commit, the
                    phase-3 embedder embeds them, DataIndex over
                    TpuKnn(device="cuda") holds them, and every document asks
                    the live index (query, not query_as_of_now) for its 9
                    nearest neighbours, so every corpus change answers all the
                    standing queries again in one block_topk batch; pairs
                    scoring at least -0.08 (cosine 0.92), self-pairs dropped,
                    are edges; pw.iterate propagates the minimum label to a
                    fixpoint; pw.sql("SELECT label, COUNT(*) AS size FROM
                    comps GROUP BY label") counts each component. Then 4
                    commits (cut from 8) of 256 new documents and 128
                    deletions (the middle variants of 64 families), each
                    one tick. Checked after
                    every commit: the labels equal scipy's connected
                    components over the replies the engine emitted
                    (pw.io.subscribe), the sizes equal a bincount of the
                    labels, every reply equals block_topk's plain version on
                    the card over the index's rows (up to near ties), one
                    launch per commit, some deletion splits a family. Prints
                    the seconds to the first fixpoint, the depths iterate
                    reached, update-to-visible p50 / max, the engine's
                    seconds per operator type, and the launches per shape.
10. live classify — a live document classifier as a user writes it
                    (``lc_pipeline``): 32,768 seeded documents with one of 8
                    labels (70% of each one's 16-48 words from its label's
                    64-word slice of the vocabulary) are written as a CSV and
                    streamed in by pw.demo.replay_csv(input_rate=0); the
                    phase-3 embedder embeds them; knn_lsh_classifier_train(
                    type="cosine", device="cuda") indexes them through
                    KNNIndex and block_topk; 2,048 held-out queries arrive
                    from pw.debug.StreamGenerator in 128 batches of 16, are
                    embedded the same way and labelled by the model (k = 3)
                    and by knn_lsh_classify with a separate label table
                    (topic-<label>); pw.live watches the predictions and a
                    subscriber records the update stream (no check runs
                    inside it); the run ends with wait() and snapshot().
                    Checked: one prediction per query; every label and topic
                    equals the majority over block_topk's plain version's
                    top-3 on each index's own prepared corpus and valid rows
                    (a difference only at a near tie at rank 3); 32,768 valid
                    rows per index, on the card; the embedder on the card;
                    launches on every reported shape; the subscriber's final
                    state equals snapshot(); the run did not fail; accuracy
                    above twice chance. Prints the phase's seconds, the
                    training embed docs/s, seconds from pw.live to the final
                    snapshot, accuracy, the update stream's rows (every
                    standing query answered again as the corpus grew),
                    launches per shape and peak memory.
11. windowed index — a recency-bounded live index as a user writes it
                    (``wi_pipeline``): 32,768 seeded documents (synthetic_docs)
                    with an event time rising from 0 to 3600 s with jitter and
                    one of 64 topics, 2% of them sent back past their window's
                    cutoff, arrive through pw.io.python in 32 commits of 1024,
                    one tick each, after one commit of 256 standing queries;
                    the phase-3 embedder embeds both; windowby(t,
                    tumbling(600), instance=topic, common_behavior(delay=60,
                    cutoff=1200, keep_results=False)).reduce(ids=tuple(doc_id))
                    is flattened and joined back to the embedded documents,
                    which DataIndex over TpuKnn(device="cuda") holds, so a
                    document enters the index 60 s after its window starts and
                    leaves 1200 s after it ends; every query asks the live
                    index (query, k = 10), answered again on every change in
                    one block_topk batch (B = 256); on the host, queries
                    interval_join documents of their topic over
                    interval(-300, 0), counted per query. Checked after every
                    commit against ``wi_oracle``, a numpy model of the windows
                    and the behavior: every reply equals the plain top-10 over
                    the live documents (an f32 matmul and torch.topk on the
                    card, up to near ties), the index's valid rows equal the
                    live count, no reply names a document that is not live,
                    the interval-join counts equal numpy's; after the run, the
                    documents that never entered a window are the oracle's
                    frozen ones; launches at B = 256 only, the embedder on the
                    card. Prints update-to-visible p50 / max, the first
                    reply's seconds, the engine's seconds per operator type
                    (the temporal ones apart), the index's rows by commit,
                    launches per shape and peak memory.
12. cdc index     — a live retrieval index kept in step with a SQL table by
                    change-data capture, as a user writes it
                    (``cdc_pipeline``): a SQLite table documents(doc_id
                    INTEGER PRIMARY KEY, topic INTEGER, body TEXT) of 24,576
                    seeded documents (synthetic_docs, 64 topics) streamed by
                    pw.io.sqlite.read(mode="streaming") (it polls PRAGMA
                    data_version and diffs a whole-table snapshot); the
                    phase-3 embedder; DataIndex over TpuKnn(device="cuda",
                    reserved_space=32768); 256 standing queries from
                    pw.io.python ask the live index (k = 10), answered again
                    on every change in one block_topk batch (B = 256); the
                    replies (qid, doc_id, score) go to pw.io.sqlite.write in
                    a second SQLite file. A writer thread with its own
                    connection commits 16 transactions, each inserting 512
                    rows, changing the body of 256 and deleting 256 (the live
                    rows peak at 28,672); each also goes as Postgres-dialect
                    Debezium envelopes, one file per transaction, into a
                    folder that pw.io.debezium.read(input_dir=...) reads in
                    the same graph (not embedded). Checked after every
                    transaction: every reply equals the plain top-10 over the
                    table's rows (an f32 matmul and torch.topk on the card, up
                    to near ties), no reply names a deleted row, a reply
                    naming a row edited in that transaction scores it by its
                    new body's vector, the index's valid rows equal the
                    table's, and the Debezium table equals the SQLite
                    reader's, keys included; after the run, the replies read
                    back from SQLite equal the subscribed ones (__key__, qid,
                    doc_id; scores within 1e-5) and a static read of the
                    table equals the streaming table's final state; launches
                    at B = 256 only, the embedder on the card. Prints
                    update-to-visible p50 / max (the commit to the end of the
                    tick that answered every standing query again), the
                    first reply's seconds, the reader's snapshot-and-diff
                    seconds per change, the Debezium scan's seconds per file
                    read, the SQLite writer's seconds per transaction, the
                    engine's seconds per operator type, the index's rows and
                    capacity by transaction, launches per shape and peak
                    memory.
13. compiled ticks — an event feed whose metadata decides what a live RAG
                    index holds, with PATHWAY_COMPILED_TICK=1 and
                    PATHWAY_COMPILED_DEVICE=cuda (``ct_chain``): 1,048,576
                    seeded rows (doc_id, topic, ts, quality, flags, text) in
                    16 commits of 65,536 through two pw.io.python subjects
                    (one next() per row, keyed by the native hasher),
                    concatenated after promise_are_pairwise_disjoint; a
                    select (a float score and an int bucket) -> a filter on
                    the flags and the score -> a select runs as one compiled
                    segment headed by the ConcatNode (torch ops on the card,
                    one host-to-device and one device-to-host copy a tick),
                    and groupby(topic).reduce(count, sum, avg) over the
                    32,768 survivors runs its partials through
                    semigroup_partials on the card; the survivors' texts
                    (synthetic_docs; the other rows carry a placeholder) go
                    through the phase-3 embedder into
                    TpuKnn(reserved_space=32768), which answers 256 standing
                    queries (k = 10) again after every commit with
                    block_topk (B = 256). Checked after every commit: the
                    chain's rows equal numpy's (keys, diffs and ints exact,
                    floats within CT_FLOAT_TOL), the groupby's counts and
                    sums exact and its means within CT_PARTIALS_TOL, every
                    reply equals the plain top-10 over the survivors so far
                    (up to near ties), the index's valid rows equal the
                    survivors so far, the segment compiled every chain tick
                    on the card with no fallback; the partials ran once a
                    commit; the native hasher is live and its keys equal
                    the pure-Python ones. Then the same commits with
                    PATHWAY_COMPILED_TICK=0 (chain and groupby only, equal
                    results). Prints the chain's seconds per tick compiled
                    and interpreted, the compile misses, hits and seconds,
                    the segment's program and the partials timed alone
                    (host ms, device and copy ms from torch.profiler, their
                    bytes bounds at the memory rate and at the host link's
                    64 GB/s, the interpreter's ms on the same tick), the
                    feed's next() seconds, update-to-visible p50 / max, the
                    first reply, ref_scalars_columns rows/s native and pure
                    Python, the earlier phases' host figures the hasher
                    should move, launches per shape and peak memory.
14. replication   — the replicated read plane: this process is the writer (a
                    persisted DataIndex over TpuKnn(device="cuda") fed the
                    vector store phase's ~80k chunk vectors in 16 commits,
                    PATHWAY_REPL_PORT=0), two
                    ``python -m pathway_tpu_torch.serving.replica`` children
                    on the card hydrate from its store and follow the delta
                    stream (replica 1 with PATHWAY_GENERATE=1), and an
                    in-process FailoverRouter with PATHWAY_ROUTER_CACHE=1
                    fronts them. Checked: 33 encoder queries through each
                    replica and the router against the writer's plain
                    dense_topk (keys up to near ties, scores within
                    REPL_TOL), a fault-killed replica 0 under 16 clients (only
                    200/429/503, none past its deadline) and its re-admission
                    only once ready, 2 live writes at rank 1, cache hits with
                    no replica hop and an evicting write, greedy /generate
                    through a router equal to an in-process scheduler, the
                    router's /fleet/metrics, /fleet/events and /fleet/trace
                    over both live replicas (each replica's series labelled,
                    both members up) and each replica's /debug/signals. Prints
                    hydrate s, replication lag, reply p50 direct and through
                    the router, update-to-visible, failover statuses and
                    retries, re-admission s, cache hit p50, /generate TTFT and
                    tokens/s, each child's launches per shape and peak memory.
15. generation    — ask -> retrieve -> generate: 24 asks are embedded and
                    retrieved (k = 3) on the phase-3 index, each grounded prompt
                    goes to one DecodeScheduler(GenerateConfig()) at the decoder's
                    serving defaults (dim 128, 2 layers, 4 heads, head_dim 32,
                    64 pages of 16, max_batch 8, 32 new tokens; half greedy, half
                    temperature 0.7 / top_k 40), whose every step runs the
                    paged-attention kernel. Checked: every answer, the page pool
                    back to empty, launches == decode steps x layers, the same
                    tokens from a kernel="ref" scheduler, and the logits of one
                    recorded step, kernel against plain.
16. durability    — the same 24 prompts at the same width, with snapshots.
                    A child process (this script with --kill-child) runs them
                    with PATHWAY_GENERATE_SNAPSHOT_EVERY=8, a store in a temp
                    dir and PATHWAY_FAULTS="kill=decode:150"; it must exit 23
                    after step 150 leaving a manifest. A scheduler restores
                    the store (pages bit-equal to the ledger, every sequence
                    completes with the generation phase's tokens, pool back to
                    empty, launches == steps x layers); split_kv_store splits
                    it across two stores whose schedulers resume every
                    sequence exactly once; then one run with the hooks and no
                    snapshots (step p50, tokens/s, the exposition, spans,
                    memory ledger and roofline checked against the run's own
                    counts) and one with a snapshot every 8 steps and one from
                    this thread mid-run (mirror and snapshot ms, bytes and
                    segments per snapshot). Tokens are compared exactly; a
                    difference passes only at a near tie: the uninterrupted
                    run's top-2 logit margin there below GEN_LOGIT_TOL.
17. observability — a monitored live index at the main path's width: the
                    vector store phase's 80,630 chunk vectors with their texts
                    through pw.io.python in 8 commits and a compiled select ->
                    filter chain on a seeded quality column
                    (PATHWAY_COMPILED_TICK=1), 256 new documents through the
                    full-width embedder, DataIndex over TpuKnn(device="cuda"),
                    64 B = 1 and 8 B = 16 query ticks; pw.run(with_http_server=
                    True, diagnostics="warn") with the signal sampler every
                    200 ms. Checked: every reply against the plain top-10
                    (kernel="torch") over the live rows; /metrics (ticks, the
                    knn histogram and counter moved by this phase, the device
                    memory gauges), /debug/graph (one row per node, the chain's
                    segment 8 compiled ticks and no fallback), /debug/tick,
                    /debug/threads, /debug/signals, /debug/profile (block_topk's
                    kernel in a torch.profiler trace of the B = 16 burst; 409
                    for a concurrent capture, 400 for seconds=0),
                    /debug/autoscale (501, [mesh]); pw.debug.diagnose names the
                    embedder UDF's chain boundary; a faulty graph under
                    diagnostics="error" is refused before its first tick;
                    prove_lowering() proves every launch case but the two
                    planted refusals, the chain's own program among them.
                    Prints the B = 1 reply p50 with the server and sampler on
                    and off in one window, the /metrics scrape p50 under load,
                    the capture's wall seconds, the doctor's ms and
                    prove_lowering's seconds.
18. mesh          — the in-process device mesh: make_mesh(4) puts four shards
                    on cuda:0 (none on the CPU). 1,048,576 seeded unit vectors
                    (D = 384) through pw.io.python in 16 commits into DataIndex
                    over TpuKnn(mesh=mesh), 262,144 rows a shard; 16 B = 1 and
                    4 B = 16 asks (k = 10) of noisy corpus rows, every reply
                    against sharded_topk_ref on the same device slices and the
                    merged top-10 against bf16 dense_topk over the whole corpus
                    (near ties within BF16_TOL), block_topk launched once per
                    shard at N = 262,144; the same asks with the exec's index
                    swapped for an unsharded one loaded from its snapshot.
                    The same run is under PATHWAY_ENGINE_SHARDS=4 (the engine
                    mesh on cuda): a groupby-reduce (count, sum) over 65,536
                    keys joined back to its 1,048,576 rows equals an unsharded
                    run's row for row and numpy's aggregates, the device
                    exchange ran, frontier_syncs is one a tick, the shards'
                    keys are disjoint and cover every key. 1024 texts through
                    SentenceTransformerEmbedder(mesh=mesh) equal the unsharded
                    embedder's within CROSS_RUN_TOL. Prints the per-shard kernel
                    ms, bound and library ms, the reply p50s sharded and
                    unsharded, the exchange and frontier ms per tick.
19. kernels       — per kernel and per path shape: launches on its path, ms
                    (CUDA events) and device ms (torch.profiler), its plain
                    version's ms, the bound and what sets it, the bytes it must
                    move, and the ms of the library call(s) computing the same
                    function (the yardstick). block_topk: B = 1 and B = 16
                    (k = 10, retrieval, and again on the engine phase's
                    and the vector store's corpora), B = 16 with k = 40 (the
                    filtered batch, oversampled x4, on the retrieval and the
                    vector store corpora), B = 32 (k = 3, the generation
                    phase's 24 asks padded to 32) and every (B, k) the rest
                    phase launched, on its corpus, B = 1 and 16 on the
                    persistence phase's restored corpus and on the hybrid
                    store's dense corpus, B = 16 on the 1M IVF ground truth,
                    every (B, k = 9) of the components phase on its corpus
                    and every (B, k = 3) of the live classify phase on its
                    corpus, B = 256 (k = 10) of the windowed index, of the
                    cdc index and of the compiled ticks' index, each on its
                    corpus at the end, and every (B,
                    k) the replica children launched,
                    on the writer's corpus, and B = 1 and 16 of the
                    observability phase on its corpus, and B = 1 and 16 of the
                    mesh phase on one shard's bf16 slice; at every shape the
                    launch ledger's shared memory (analysis/lowering.py) must
                    equal what the built kernel launched with;
                    paged_attention: the
                    recorded decode step and a long context, each with its
                    split count S (and the replica's /generate launches).

Then, on lines of their own, the kernels table, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no result. It needs one CUDA device and refuses to run
without one.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

SEED = 0
DIM = 384
N_DOCS = 4096
EMBED_BATCH = 256
CORPUS_ROWS = 1 << 20
N_QUERIES = 64
K = 10
KEY_BASE = 10_000_000  # keys of the synthetic unit vectors, disjoint from docs
# the engine phase: the retrieval cell's CORPUS_ROWS (documents + precomputed
# unit vectors) entering through the engine, one commit per tick
ENGINE_DOC_COMMIT = 256
ENGINE_VEC_COMMIT = 1 << 16
ENGINE_B1_TICKS = 64
ENGINE_B16_TICKS = 8
ENGINE_LIVE_TICKS = 16
ENGINE_LIVE_DOCS = 64
ENGINE_RETRACT = 64
# the recorder's cost: B = 1 queries alternating Tick Scope on and off
ENGINE_TICKSCOPE_AB = 64
# the vector store phase: VectorStoreServer over documents that arrive as
# bytes, 16 commits of 2048 (≈2 chunks each, ≈65k chunks)
VS_DOCS = 32768
VS_COMMIT = 2048
VS_MIN_TOKENS, VS_MAX_TOKENS = 20, 60
VS_B1_TICKS = 64
VS_B16_TICKS = 8
VS_FILTER_TICKS = 4
VS_LIVE_TICKS = 16
VS_LIVE_DOCS = 64
VS_ASKS = 8
VS_GROUPS = 4  # document i sits under docs/<i % 4>/; a filter keeps one group
# the rest phase: the vector store phase's corpus served over HTTP by
# VectorStoreServer.run_server (ungated) and a gated rest_connector route
REST_SEQ = 64  # POST /v1/retrieve one at a time (B = 1 in the kernel)
REST_GET = 8
REST_FILTERED = 4  # k = 40 in the kernel after the x4 oversample
REST_CLIENTS = 16  # the concurrency of the concurrent groups
REST_UNGATED_EACH = 8
REST_GATED_EACH = 16
REST_BURST = 256  # the overload burst at the gated route
REST_DEADLINE = 16  # requests with a 1 ms budget: 504, no search
REST_STALE = 4
REST_DRAIN = 16  # requests in flight when each server drains
REST_QOS = {"max_batch_size": 16, "max_wait_ms": 5.0, "max_queue": 64}
# the persistence phase: the vector store phase's documents as files, 16
# batches of 2048, a killed run and two restarts over one store. With one
# tick per batch and a snapshot every 8 commits (the default), a kill at
# the head of tick 10 leaves generation 1 (batches 1-8), a log tail
# (batch 9) and one batch drained but never logged (batch 10).
PERSIST_KILL_TICK = 10
# B = 1 queries per group, cut from the vector store phase's 64 (to 16,
# then to 8 beside the replication phase) to keep the smoke under 900 s:
# every query tick counts toward the snapshot cadence
PERSIST_B1 = 8
# writes of VS_LIVE_DOCS documents, each then queried; cut from 4 to 2, then
# to 1 beside the windowed index phase, to keep the smoke under 950 s (each
# write's commit takes ≈11 s with persistence)
PERSIST_LIVE_WRITES = 1
# the first 12 batches of 768 of the vector store phase's documents: the same
# kill at tick 10, fewer files (cut from 32,768 in batches of 2048 beside
# the cdc index phase, then from 16 batches to 12 beside the observability
# phase; the scanner copies its offsets per file, so the killed run and
# restart 1 shrink faster than the corpus)
PERSIST_COMMIT = 768
PERSIST_DOCS = PERSIST_COMMIT * 12
# B = 16 ticks of the vector store phase's texts from those documents: 2
# (cut from 3 with the batches: 45 of its B = 16 texts come from the first
# 9,216 documents)
PERSIST_B16_TICKS = 2
# index rows reserved: 21,836 chunks + the live write's; kept at the
# 12,288 documents' 29,122 + 64 so the kernel's shape (N = 30,720) stays
PERSIST_CAPACITY = 30 * 1024
# a reply of a restart against the never-killed vector store phase's reply
# to the same text: the same corpus and query vector, but the document
# vectors come from other embedder batches (other GEMM shapes in bf16)
CROSS_RUN_TOL = 5e-3
RERANK_KEEP = 3
# the cross-encoder's scores in the pipeline against a direct forward_ids of
# the same tick's pairs in one batch: the same bf16 model, bucket and device
RERANK_TOL = 1e-3
# kernel vs plain on random unit vectors, |score| <= 1: the D products are
# summed in another order. bf16 inputs are multiplied exactly in f32, so the
# same f32 sum-order tolerance holds for bf16 corpora.
F32_TOL = 1e-5
BF16_TOL = 1e-5
# paged attention, kernel vs plain, absolute: outputs are softmax-weighted
# means of N(0, 1) values; the kernel sums scores and up to 4096 weighted
# rows in another order (per-warp online softmax, merged at the end) than the
# plain version's batched products, so the f32 rounding grows with context
PA_TOL = 1e-5
PA_POOL_PAGES = 1025
PA_MAX_PAGES = 256
# decode-step logits, kernel vs plain attention: the attention differences
# above, carried through 2 layers and the tied-embedding head
GEN_LOGIT_TOL = 1e-4
N_ASKS = 24
RETRIEVE_K = 3
RECORD_STEP = 150  # the decode step whose inputs the phase records
KILL_STEP = 150  # the durability child dies after this decode step
SNAPSHOT_EVERY = 8
FAULT_EXIT = 23  # the fault plan's exit code
# the index kinds phase: a hybrid DocumentStore over the vector store
# phase's documents; IvfKnn, IvfDeviceIndex and LshKnn over bench.py's
# accelerator IVF mixture; the segment ops
# cut from 64 beside the windowed index phase to keep the smoke under 950
# s, then to 16 beside the cdc index phase: the IVF part scores each B = 1
# query on the host, ≈0.4 s
IK_B1 = 16
# cut from 8 to keep the smoke under 900 s, then to 2 beside the windowed
# index phase and to 1 beside the cdc index phase: the IVF part scores each
# query on the host, ≈6 s a B = 16 tick
IK_B16 = 1
IK_LIVE_WRITES = 4
# the hybrid store's documents: the first half of the vector store phase's,
# cut from all 32,768 beside the compiled ticks phase to keep the smoke
# under 950 s (BM25 and the embedder scale with the corpus); its dense
# index keeps the vector store phase's capacity
IK_HYBRID_DOCS = VS_DOCS // 2
RRF_K = 60.0  # HybridIndexFactory's default
IK_IVF_ROWS = 1_000_000
# the engine part's rows: the mixture's first half, cut from all of it
# beside the observability phase to keep the smoke under 950 s (ingest,
# assignment and scoring scale with the rows)
IK_IVF_ENGINE_ROWS = IK_IVF_ROWS // 2
IK_IVF_CENTRES = 2000
IK_IVF_COMMIT = 1 << 16
IK_IVF_DEVICE_QUERIES = 50
IK_RECALL = 0.95  # the reference's bar (tests/test_ivf.py)
# IVF scores (cos - 1 in f32) against numpy's f64; LSH scores -|q - v|^2
# in f32 against f64, relative
IK_SCORE_TOL = 1e-5
IK_LSH_ROWS = 1 << 15  # cut from 1M: LshKnnIndex syncs with the host once per upserted row
IK_LSH_QUERIES = 16
# of bucket_length: a projection this near a cell edge may round to either
# cell between the card's and the CPU's f32 sums
LSH_EDGE = 1e-4
IK_SEG_VALUES = 1 << 20
IK_SEG_SEGMENTS = 4096
# the replication phase: this process writes the vector store phase's
# corpus through a persisted DataIndex with the delta stream armed; two
# replica processes on the card serve it behind a FailoverRouter
REPL_COMMITS = 16  # the snapshot generation the replicas hydrate lands at the last
REPL_LIVE_WRITES = 2
REPL_LIVE_ROWS = 64
REPL_CLIENTS = 16
REPL_EACH = 64  # requests per client while replica 0 dies
REPL_CACHE_REPEATS = 16
REPL_ASKS = 4
REPL_GEN_TOKENS = 16
REPL_DEADLINE_MS = 20_000
# replica scores (the kernel, f32) against the writer's plain dense_topk
# (one f32 matmul) on the same vectors: the D products summed in another
# order, |score| <= 2, as in kernel parity
REPL_TOL = 1e-5
REPL_ENV = ("PATHWAY_DCN_SECRET", "PATHWAY_REPL_PORT", "PATHWAY_REPLICA_DIM",
            "PATHWAY_ROUTER_CACHE", "PATHWAY_ROUTER_CACHE_WRITER")
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # dense, H100 SXM


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def memory_rate() -> tuple[float, str]:
    """Bytes/s of device memory: HBM at clocks.max.memory (MHz), double data
    rate, 5120-bit bus (every H100 variant; 3.35e12 on an H100 SXM)."""
    mhz = float(nvidia_smi("clocks.max.memory").split()[0])
    return mhz * 1e6 * 2 * 5120 / 8, f"nvidia-smi clocks.max.memory {mhz:g} MHz x 5120-bit DDR"


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel from nvcc -Xptxas -v: its name and
    template arguments as mangled, registers, static shared memory, spills."""
    lines, name, spills = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(block_topk_kernel|paged_decode_kernel)I(\w+?)E+v", ln)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
        elif "spill" in ln:
            spills = ln.strip()
        elif "registers" in ln and name:
            lines.append(f"{name}: {ln.split('Used', 1)[1].strip()}; {spills}")
    return lines


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, reps: int = 20) -> dict[str, tuple[int, float]] | None:
    """Run ``fn`` ``reps`` times under torch.profiler: {device kernel or
    copy name: (launches, device ms in all)}, or None when the trace shows
    no device time (the times are a measurement only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {
        e.key: (e.count, e.self_device_time_total / 1e3)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    }
    return out if sum(ms for _n, ms in out.values()) > 0 else None


def kernel_device_ms(times: dict | None, name: str, reps: int) -> float | None:
    """Device ms per call of the kernels whose name contains ``name``."""
    if times is None:
        return None
    return sum(ms for key, (_n, ms) in times.items() if name in key) / reps


# --- phase 2: kernel parity --------------------------------------------------


def grid_corpus(n: int, d: int, dtype: torch.dtype, gen: torch.Generator, dev):
    """Small-integer vectors: every product and sum is exact in f32, so the
    kernel and the plain version must agree bit for bit and ties are exact.
    Duplicated rows, a run of identical rows, ~10% invalid rows and, for
    N >= 64K, two fully invalid 1024-row blocks."""
    c = torch.randint(-3, 4, (n, d), generator=gen, device=dev).to(dtype)
    src = torch.randint(0, n, (n // 4,), generator=gen, device=dev)
    dst = torch.randint(0, n, (n // 4,), generator=gen, device=dev)
    c[dst] = c[src]
    c[: min(n, 512)] = c[0]
    valid = torch.rand(n, generator=gen, device=dev) > 0.1
    if n >= 64 * 1024:
        valid[1024:2048] = False
        valid[5 * 1024 : 6 * 1024] = False
    return c.contiguous(), valid


def kernel_parity(dev) -> dict:
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.knn import dense_topk_prepared

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = 0
    for n in (1024, 64 * 1024, 1024 * 1024):
        for dtype in (torch.float32, torch.bfloat16):
            c, valid = grid_corpus(n, DIM, dtype, gen, dev)
            for b in (1, 16, 64):
                q = torch.randint(-3, 4, (b, DIM), generator=gen, device=dev).to(dtype)
                q[0] = c[0]  # a query equal to the long run of identical rows
                for k in (1, 10, 40, 1024):
                    sc, ix = bt.block_topk(q, c, valid, k)
                    sr, ir = bt.block_topk_ref(q, c, valid, k)
                    torch.cuda.synchronize()
                    what = f"N={n} B={b} k={k} {dtype}"
                    check(torch.equal(ix, ir), f"block indices differ at {what}")
                    check(torch.equal(sc, sr), f"block scores differ at {what}")
                    s2, i2 = bt.dense_topk_kernel(q.float(), c, valid, k)
                    s3, i3 = dense_topk_prepared(
                        q.float(), c, None, valid, k, metric="dot", bf16=dtype == torch.bfloat16
                    )
                    check(torch.equal(i2, i3.to(i2.dtype)), f"merged indices differ at {what}")
                    check(torch.equal(s2, s3), f"merged scores differ at {what}")
                    cases += 1
            del c, valid
    # random unit vectors at the main-path shape: sums are not exact, so the
    # scores agree within F32_TOL and an index may differ only at a near-tie
    exact = 0
    total = 0
    max_err = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).split(".")[-1]
        max_err[name] = 0.0
        c = torch.randn(CORPUS_ROWS, DIM, generator=gen, device=dev)
        c = (c / c.norm(dim=-1, keepdim=True)).to(dtype)
        valid = torch.rand(CORPUS_ROWS, generator=gen, device=dev) > 0.01
        for b, k in ((1, K), (16, K), (32, RETRIEVE_K)):
            q = torch.randn(b, DIM, generator=gen, device=dev)
            q = (q / q.norm(dim=-1, keepdim=True)).to(dtype)
            sc, ix = bt.block_topk(q, c, valid, k)
            sr, ir = bt.block_topk_ref(q, c, valid, k)
            err = float((sc - sr).abs().max())
            max_err[name] = max(max_err[name], err)
            check(err <= tol, f"random scores differ by {err} ({name}, B={b})")
            full = torch.where(valid[None, :], q.float() @ c.float().T, -float("inf"))
            got = torch.gather(full, 1, ix.reshape(b, -1).long()).reshape(ix.shape)
            check(bool(((got - sr).abs() <= tol).all()), f"kernel picked a wrong row ({name})")
            exact += int((ix == ir).sum())
            total += ix.numel()
        del c, valid
    return {
        "phase": "kernel parity",
        "grid_cases": cases,
        "grid_check": "indices and scores bit-equal, kernel vs block_topk_ref and merged vs dense_topk_prepared",
        "random_max_abs_err": max_err,
        "random_tol": {"float32": F32_TOL, "bfloat16": BF16_TOL},
        "random_index_equal_fraction": exact / total,
        "paged_attention": paged_parity(dev),
    }


def paged_parity(dev) -> dict:
    """The paged-attention kernel against paged_attention_ref over the grid
    B x H x P x Dp, 256-page tables over a 1025-page pool, random values
    in every lane (pad lanes included) and ragged lengths with the edges."""
    from pathway_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cases, max_err, zero_rows = 0, 0.0, 0
    for dp in (128, 256):
        for p in (8, 16):
            for h in (1, 4, 32):
                k = torch.randn(PA_POOL_PAGES, h, p, dp, generator=gen, device=dev)
                v = torch.randn(PA_POOL_PAGES, h, p, dp, generator=gen, device=dev)
                full = PA_MAX_PAGES * p
                for b in (1, 8, 64):
                    q = torch.randn(b, h, dp, generator=gen, device=dev)
                    pt = torch.randint(
                        1, PA_POOL_PAGES, (b, PA_MAX_PAGES), generator=gen, device=dev,
                        dtype=torch.int32,
                    )
                    sl = torch.randint(
                        0, full + 1, (b,), generator=gen, device=dev, dtype=torch.int32
                    )
                    edges = torch.tensor([0, p, p + 1, full, -3], dtype=torch.int32, device=dev)
                    if b == 1:
                        sl[0] = edges[cases % 4]
                    else:
                        sl[:5] = edges
                    got = pa.paged_attention(q, k, v, pt, sl, sm_scale=32**-0.5)
                    ref = pa.paged_attention_ref(q, k, v, pt, sl, sm_scale=32**-0.5)
                    torch.cuda.synchronize()
                    what = f"B={b} H={h} P={p} Dp={dp}"
                    err = float((got - ref).abs().max())
                    max_err = max(max_err, err)
                    check(err <= PA_TOL, f"paged attention differs by {err} at {what}")
                    empty = sl <= 0
                    check(bool((got[empty] == 0).all()), f"an empty row is not exactly 0 at {what}")
                    zero_rows += int(empty.sum())
                    cases += 1
                del k, v
    return {
        "cases": cases,
        "pool_pages": PA_POOL_PAGES,
        "max_pages": PA_MAX_PAGES,
        "max_abs_err": max_err,
        "tol": PA_TOL,
        "empty_rows_exactly_zero": zero_rows,
    }


# --- phase 3: main path -------------------------------------------------------


def synthetic_docs(n: int, rng: np.random.Generator) -> list[str]:
    # an array, not a list: rng.choice draws the same words from either,
    # but converts a list anew on every call
    words = np.array([f"term{i}" for i in range(20000)])
    return [
        f"doc {i}: " + " ".join(rng.choice(words, size=int(rng.integers(24, 200))))
        for i in range(n)
    ]


def build_index_state(doc_vecs: np.ndarray, dev) -> dict:
    """Index state holding the documents (keys 0..N_DOCS-1, with metadata)
    and seeded unit vectors under keys KEY_BASE.. up to CORPUS_ROWS rows."""
    host = np.empty((CORPUS_ROWS, DIM), dtype=np.float32)
    host[:N_DOCS] = doc_vecs
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    step = 1 << 17
    for lo in range(N_DOCS, CORPUS_ROWS, step):
        hi = min(lo + step, CORPUS_ROWS)
        v = torch.randn(hi - lo, DIM, generator=gen, device=dev)
        host[lo:hi] = (v / v.norm(dim=-1, keepdim=True)).cpu().numpy()
    keys = list(range(N_DOCS)) + list(range(KEY_BASE, KEY_BASE + CORPUS_ROWS - N_DOCS))
    return {
        "metadata": {i: {"doc": i, "group": i % 8} for i in range(N_DOCS)},
        "corpus": {
            "dim": DIM,
            "capacity": CORPUS_ROWS,
            "host": host,
            "valid_host": np.ones(CORPUS_ROWS, dtype=bool),
            "free": [],
            "slot_of": dict(zip(keys, range(CORPUS_ROWS))),
            "key_of": dict(zip(range(CORPUS_ROWS), keys)),
        },
    }


def doc_path(i: int) -> str:
    """The ``path`` of document i of the store phases' corpus."""
    return f"docs/{i % VS_GROUPS}/{i:06d}.txt"


def snapshot_index(ix, dev):
    """A separate plain-torch index holding the rows of the store's index."""
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex

    state = ix.state_dict()
    c = dict(state["corpus"], host=state["corpus"]["host"].copy(),
             valid_host=state["corpus"]["valid_host"].copy())
    m = TpuDenseKnnIndex(dimensions=DIM, metric="cosine", reserved_space=c["capacity"],
                         kernel="torch", device=dev)
    m.load_state({"metadata": dict(state["metadata"]), "corpus": c})
    return m


def same_up_to_near_ties(a: tuple, b: tuple, tol: float) -> bool:
    """Two result rows agree: equal lengths, scores within tol position by
    position, and a key differs only where its score is within tol of the
    other row's score at that position (a near-tie the sum order decides)."""
    if len(a) != len(b):
        return False
    sb = dict(b)
    for i, ((ka, sa), (kb, s_b)) in enumerate(zip(a, b)):
        if abs(sa - s_b) > tol:
            return False
        if ka != kb and not (ka in sb and abs(sb[ka] - s_b) <= tol) and abs(sa - b[-1][1]) > tol:
            return False
    return True


def main_path(dev) -> tuple[dict, dict]:
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    rng = np.random.default_rng(SEED)
    docs = synthetic_docs(N_DOCS, rng)
    copied = rng.choice(N_DOCS, size=N_QUERIES // 2, replace=False)
    queries = [docs[i] for i in copied] + [
        "what does " + " ".join(rng.choice([f"term{i}" for i in range(20000)], size=12))
        for _ in range(N_QUERIES - len(copied))
    ]
    in_group3 = [i for i in range(N_DOCS) if i % 8 == 3][:16]
    filtered = [docs[i] for i in in_group3]

    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    torch.cuda.reset_peak_memory_stats()  # the parity phase's peak is not the path's
    t0 = time.perf_counter()
    emb = SentenceTransformerEmbedder(device=dev)  # seeded init, seed 0
    check(emb.get_embedding_dimension() == DIM, "embedding width")
    emb.embed_batch(docs[:EMBED_BATCH])  # warm-up (kernel selection, allocator)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    vecs = []
    for lo in range(0, N_DOCS, EMBED_BATCH):
        vecs.extend(emb.embed_batch(docs[lo : lo + EMBED_BATCH]))
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t1
    doc_vecs = np.stack(vecs)
    t2 = time.perf_counter()
    for lo in range(0, N_DOCS, EMBED_BATCH):  # the host share of embedding
        emb.tokenizer.encode_batch(docs[lo : lo + EMBED_BATCH], emb.runtime.max_len)
    tokenize_s = time.perf_counter() - t2
    check(doc_vecs.shape == (N_DOCS, DIM), "doc embedding shape")
    check(bool(np.isfinite(doc_vecs).all()), "non-finite doc embedding")
    check(bool(np.allclose(np.linalg.norm(doc_vecs, axis=1), 1.0, atol=1e-2)), "embeddings not unit")

    state = build_index_state(doc_vecs, dev)
    index = TpuDenseKnnIndex(dimensions=DIM, metric="cosine", reserved_space=CORPUS_ROWS, device=dev)
    index.load_state(state)
    check(len(index) == CORPUS_ROWS, "index size")
    index.search([(doc_vecs[0], K, None)])  # uploads + prepares the corpus once
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    results: dict[int, list] = {}
    latency: dict[int, dict] = {}
    for bs in (1, 16):
        search_ms, query_ms, rows = [], [], []
        for lo in range(0, N_QUERIES, bs):
            t_q = time.perf_counter()
            qv = emb.embed_batch(queries[lo : lo + bs])
            t_s = time.perf_counter()
            res = index.search([(v, K, None) for v in qv])
            t_e = time.perf_counter()  # search() returns host results: synchronized
            search_ms.append((t_e - t_s) * 1e3)
            query_ms.append((t_e - t_q) * 1e3)
            rows.extend(res)
        results[bs] = rows
        latency[bs] = {
            "search_p50_ms": float(np.percentile(search_ms, 50)),
            "search_p99_ms": float(np.percentile(search_ms, 99)),
            "query_p50_ms": float(np.percentile(query_ms, 50)),
            "qps": bs * len(query_ms) / (sum(query_ms) / 1e3),
        }
    fvecs = emb.embed_batch(filtered)
    fres = index.search([(v, K, "group == `3`") for v in fvecs])
    torch.cuda.synchronize()
    launches = bt.block_topk.launches
    shapes = dict(bt.block_topk.shapes)

    check(launches > 0, "the main path never launched the block_topk kernel")
    for qi, doc in enumerate(copied):
        for bs in (1, 16):
            key, score = results[bs][qi][0]
            check(key == doc and abs(score) < 1e-2, f"query copied from doc {doc} returned {key} ({score})")
    for row, doc in zip(fres, in_group3):
        check(len(row) > 0 and row[0][0] == doc, f"filtered query for doc {doc} returned {row[:1]}")
        check(all(k % 8 == 3 and k < N_DOCS for k, _s in row), "filter let a non-matching key through")
    for bs in (1, 16):
        check(all(len(r) == K for r in results[bs]), "a query returned fewer than k results")

    torch_index = TpuDenseKnnIndex(
        dimensions=DIM, metric="cosine", reserved_space=CORPUS_ROWS, kernel="torch", device=dev
    )
    torch_index.load_state(state)
    launches_before = bt.block_topk.launches
    qv = emb.embed_batch(queries)
    ref = torch_index.search([(v, K, None) for v in qv])
    ref_f = torch_index.search([(v, K, "group == `3`") for v in fvecs])
    check(bt.block_topk.launches == launches_before, 'kernel="torch" launched the kernel')
    got = index.search([(v, K, None) for v in qv])
    exact = sum(
        [k for k, _s in a] == [k for k, _s in b] for a, b in zip(got + fres, ref + ref_f)
    )
    check(
        all(same_up_to_near_ties(a, b, F32_TOL) for a, b in zip(got + fres, ref + ref_f)),
        'kernel results differ from kernel="torch"',
    )
    del torch_index

    phase = {
        "phase": "main path",
        "docs": N_DOCS,
        "corpus_rows": len(index),
        "embed_docs_per_s": N_DOCS / embed_s,
        "embed_batch": EMBED_BATCH,
        "embed_s": embed_s,
        "tokenize_s": tokenize_s,
        "setup_s": setup_s,
        "search": {f"B={bs}": latency[bs] for bs in (1, 16)},
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "results_keys_equal_torch_path": exact,
        "results_compared": len(ref) + len(ref_f),
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    prep, _c2, valid = index.corpus.prepared_arrays("cosine", bf16=False)
    batches = {bs: torch.from_numpy(np.stack(qv[:bs])).to(dev) for bs in (1, 16)}
    batches["filtered"] = torch.from_numpy(np.stack(fvecs)).to(dev)
    return phase, {
        "prep": prep, "valid": valid, "queries": batches, "launches": launches,
        "shapes": shapes, "index": index, "emb": emb,
    }


# --- phase 4: engine ----------------------------------------------------------


def operator_s(rt, since: dict | None = None) -> dict[str, float]:
    """Engine seconds per operator type (runtime stats), over the whole run
    or since the ``node_ns`` snapshot ``since``; largest first."""
    out: dict[str, float] = {}
    for node in rt.order:
        ns = rt.stats.node_ns.get(node.id, 0) - (since or {}).get(node.id, 0)
        out[type(node).__name__] = out.get(type(node).__name__, 0.0) + ns / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def operator_s_by_node(rt, since: dict | None = None, top: int = 12) -> list[dict]:
    """Engine seconds per operator instance since the ``node_ns`` snapshot
    ``since``: node id, type, the user line that declared it and its output
    columns; the ``top`` largest."""
    out = []
    for node in rt.order:
        ns = rt.stats.node_ns.get(node.id, 0) - (since or {}).get(node.id, 0)
        if ns > 0:
            where = f"{os.path.basename(node.trace[0])}:{node.trace[1]}" if node.trace else None
            out.append({"id": node.id, "op": type(node).__name__, "declared_at": where,
                        "columns": list(node.column_names)[:4], "s": ns / 1e9})
    return sorted(out, key=lambda r: -r["s"])[:top]


def wait_until(cond, what: str, timeout: float = 300.0) -> None:
    t_end = time.perf_counter() + timeout
    while not cond():
        check(time.perf_counter() < t_end, f"timed out waiting for {what}")
        time.sleep(0.0005)


def tick_anatomy(rt, t0_ns: int, t1_ns: int) -> dict:
    """Tick Scope's split of the ticks that began between two
    perf_counter_ns stamps: seconds and rows in/out per operator type, the
    share of the ticks' wall the operators account for (over 1 when the
    worker pool runs operators side by side), and the critical path of the
    slowest of those ticks, operator by operator."""
    scope = rt._tickscope
    recs = [r for r in scope.records() if t0_ns <= r.start_ns <= t1_ns]
    check(bool(recs), "Tick Scope recorded none of the ticks in the window")
    ops: dict[str, dict] = {}
    for rec in recs:
        for nid, a, b, rows_in, rows_out, _compiled in rec.entries:
            d = ops.setdefault(scope._names[nid].rsplit("_", 1)[0], {"s": 0.0, "rows_in": 0, "rows_out": 0})
            d["s"] += (b - a) / 1e9
            d["rows_in"] += rows_in
            d["rows_out"] += rows_out
    wall_s = sum(r.tick_ns for r in recs) / 1e9
    slow = max(recs, key=lambda r: r.tick_ns)
    total_s, path = scope.record_critical_path(slow)
    ms = {e[0]: (e[2] - e[1]) / 1e6 for e in slow.entries}
    return {
        "ticks": len(recs),
        "tick_ms_p50": float(np.percentile([r.tick_ns / 1e6 for r in recs], 50)),
        "operators_share_of_tick_wall": sum(d["s"] for d in ops.values()) / wall_s,
        "operator_s": dict(sorted(ops.items(), key=lambda kv: -kv[1]["s"])),
        "slowest_tick_ms": slow.tick_ns / 1e6,
        "slowest_critical_path": [{"op": scope._names[n], "ms": ms[n]} for n in path],
        "slowest_critical_path_ms": total_s * 1e3,
        "slowest_critical_path_share": total_s / (slow.tick_ns / 1e9),
    }


def engine(dev) -> tuple[dict, dict]:
    """The user script of the port's README on the card: documents and
    precomputed vectors stream in through pw.io.python, the embedder UDF
    runs inside the engine's ticks, DataIndex over TpuKnn answers queries
    that arrive as rows, pw.io.subscribe collects the replies. Each batch of
    rows is pushed with next() (or _remove()) and handed over by one
    commit(), which the engine takes as one tick; the driver waits for that
    tick to end before it commits again."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.internals.api import ref_scalar
    from pathway_tpu_torch.observability.tracing import get_tracer
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.stdlib.indexing import DataIndex, TpuKnn
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    rng = np.random.default_rng(SEED + 7)
    n_vec = CORPUS_ROWS - N_DOCS
    docs = synthetic_docs(N_DOCS + ENGINE_LIVE_TICKS * ENGINE_LIVE_DOCS, rng)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    vec_host = torch.randn(n_vec, DIM, generator=gen, device=dev)
    vec_host = (vec_host / vec_host.norm(dim=-1, keepdim=True)).cpu().numpy()
    n_static = ENGINE_B1_TICKS + 16 * ENGINE_B16_TICKS
    static_docs = rng.choice(N_DOCS, size=n_static, replace=False)
    retracted = [int(i) for i in rng.choice(N_DOCS, size=ENGINE_RETRACT, replace=False)]
    doc_key = lambda i: int(ref_scalar(ref_scalar(i), 0))  # noqa: E731 (concat_reindex side 0)

    parse_graph.G.clear()
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    tracer = get_tracer()
    check(tracer.enabled, "tracing is off (PATHWAY_TRACING=0): the re-upload is read from its span")
    tracer.clear()

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str
        meta: str

    class VecSchema(pw.Schema):
        vid: int = pw.column_definition(primary_key=True)
        vec: np.ndarray
        meta: str

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        q: str

    finished = threading.Event()
    failure: list[BaseException] = []

    class Idle(pw.io.python.ConnectorSubject):
        """Fed from the query subject's thread; ends with the traffic."""

        def run(self):
            finished.wait()

    doc_subject, vec_subject = Idle(), Idle()

    emb = SentenceTransformerEmbedder(device=dev)  # full width, bf16, seeded
    # the batches are the commits: no autocommit takes a part of one while
    # its rows are still being pushed
    texts = pw.io.python.read(doc_subject, schema=DocSchema, autocommit_duration_ms=None)
    vecs = pw.io.python.read(vec_subject, schema=VecSchema, autocommit_duration_ms=None)
    corpus = texts.select(vec=emb(pw.this.text), meta=pw.this.meta).concat_reindex(
        vecs.select(vec=pw.this.vec, meta=pw.this.meta)
    )
    # room for the live documents: the corpus never doubles mid-run
    knn = TpuKnn(corpus.vec, corpus.meta, dimensions=DIM, reserved_space=CORPUS_ROWS
                 + ENGINE_LIVE_TICKS * ENGINE_LIVE_DOCS, device=dev)
    index = DataIndex(corpus, knn)

    replies: dict[int, dict] = {}
    updates: list[tuple[float, tuple]] = []
    qvecs: dict[int, np.ndarray] = {}

    def on_reply(key, row, time, is_addition):
        # the first reply is the answer as of the query's tick; later
        # updates re-join the data columns (a retracted match's meta
        # becomes None), the ids and scores stay
        if is_addition:
            updates.append((_now(), row["meta"]))
            if row["qid"] not in replies:
                replies[row["qid"]] = {"t": _now(), "ids": tuple(int(i) for i in row["ids"]),
                                       "scores": row["scores"], "meta": row["meta"]}

    def on_query_vec(key, row, time, is_addition):
        if is_addition:
            qvecs[row["qid"]] = row["v"]

    _now = time.perf_counter
    stamps: dict[str, float] = {}
    commits: dict[int, float] = {}
    record: dict = {"update_ms": [], "tickscope_ab": []}
    n_commits = [0]
    stage_ticks: dict[str, int] = {}
    windows: dict[str, list[int]] = {}

    class QuerySubject(pw.io.python.ConnectorSubject):
        def run(self):
            try:
                drive(self)
            except BaseException as e:  # noqa: BLE001 — re-raised after pw.run
                failure.append(e)
            finally:
                finished.set()

    def engine_index() -> TpuDenseKnnIndex:
        rt = parse_graph.G.runtime
        return next(ex.index for ex in rt.execs.values() if isinstance(ex, ExternalIndexExec))

    def commit(subject, cond, what: str) -> None:
        """Hand the subject's staged rows to the engine, then wait until
        cond() holds and the commit's tick has ended."""
        subject.commit()
        n_commits[0] += 1
        goal, rt = n_commits[0], parse_graph.G.runtime
        wait_until(lambda: cond() and rt.stats.ticks >= goal, what)

    def stage(name: str, t0: int) -> None:
        stage_ticks[name] = parse_graph.G.runtime.stats.ticks - t0

    def ask(subject, qid_texts: list[tuple[int, str]]) -> None:
        for qid, text in qid_texts:
            subject.next(qid=qid, q=text)
        t0 = _now()
        for qid, _t in qid_texts:
            commits[qid] = t0
        commit(subject, lambda: all(q in replies for q, _t in qid_texts), "a query's reply")

    def drive(qs) -> None:
        ix = record["index"] = engine_index()
        ticks = lambda: parse_graph.G.runtime.stats.ticks  # noqa: E731
        # corpus: 16 commits of 256 documents, then the vectors in commits
        # of ENGINE_VEC_COMMIT, each row through ConnectorSubject.next
        stamps["ingest0"], t0 = _now(), ticks()
        for lo in range(0, N_DOCS, ENGINE_DOC_COMMIT):
            for i in range(lo, lo + ENGINE_DOC_COMMIT):
                doc_subject.next(doc_id=i, text=docs[i], meta=f"doc:{i}")
            commit(doc_subject, lambda: len(ix) >= lo + ENGINE_DOC_COMMIT, "a document commit")
        stamps["docs_in"] = _now()
        stage("docs", t0)
        stamps["push_s"], t0 = 0.0, ticks()
        for lo in range(0, n_vec, ENGINE_VEC_COMMIT):
            tp = _now()
            for j in range(lo, min(lo + ENGINE_VEC_COMMIT, n_vec)):
                vec_subject.next(vid=j, vec=vec_host[j], meta=f"vec:{j}")
            stamps["push_s"] += _now() - tp
            commit(vec_subject, lambda: len(ix) >= N_DOCS + min(lo + ENGINE_VEC_COMMIT, n_vec),
                   "a vector commit")
        stamps["ingest1"] = _now()
        stage("vectors", t0)
        # traffic: B = 1, then B = 16, queries copied from documents
        qid, t0 = 0, ticks()
        windows["B=1"] = [time.perf_counter_ns()]
        for i in range(ENGINE_B1_TICKS):
            d = int(static_docs[i])
            ask(qs, [(qid, docs[d])])
            qid += 1
        windows["B=1"].append(time.perf_counter_ns())
        stage("queries_B=1", t0)
        t0 = ticks()
        windows["B=16"] = [time.perf_counter_ns()]
        for t in range(ENGINE_B16_TICKS):
            lo = ENGINE_B1_TICKS + 16 * t
            ask(qs, [(qid + j, docs[int(static_docs[lo + j])]) for j in range(16)])
            qid += 16
        windows["B=16"].append(time.perf_counter_ns())
        stage("queries_B=16", t0)
        # the recorder's cost in one window: the B = 1 texts again, the
        # recorder on for even and off for odd queries
        t0, scope = ticks(), parse_graph.G.runtime._tickscope
        for i in range(ENGINE_TICKSCOPE_AB):
            scope.enabled = i % 2 == 0
            ask(qs, [(qid, docs[int(static_docs[i])])])
            record["tickscope_ab"].append((scope.enabled, qid))
            qid += 1
        scope.enabled = True
        stage("queries_B=1_tickscope_on_off", t0)
        stamps["static_q"] = qid
        record["mirror"] = snapshot(ix)
        static = sorted(q for q in qvecs if q < qid)
        record["static_ref"] = [
            r for lo in range(0, len(static), 16)
            for r in mirror_search(record["mirror"], [qvecs[q] for q in static[lo:lo + 16]])
        ]
        # live updates: a commit of 64 new documents, then a query for one
        # of them; visible = from that commit to the query's reply
        t0 = ticks()
        for t in range(ENGINE_LIVE_TICKS):
            lo = N_DOCS + t * ENGINE_LIVE_DOCS
            for i in range(lo, lo + ENGINE_LIVE_DOCS):
                doc_subject.next(doc_id=i, text=docs[i], meta=f"doc:{i}")
            tc = _now()
            n0 = CORPUS_ROWS + t * ENGINE_LIVE_DOCS
            commit(doc_subject, lambda: len(ix) >= n0 + ENGINE_LIVE_DOCS, "a live commit")
            target = lo + (t * 7) % ENGINE_LIVE_DOCS
            ask(qs, [(qid, docs[target])])
            record["update_ms"].append((replies[qid]["t"] - tc) * 1e3)
            record.setdefault("live", []).append((qid, target))
            mirror_add(record["mirror"], ix, range(lo, lo + ENGINE_LIVE_DOCS), doc_key)
            record.setdefault("live_ref", []).extend(mirror_search(record["mirror"], [qvecs[qid]]))
            qid += 1
        stage("live_docs_and_queries", t0)
        # one commit retracting 64 documents (the subject's _remove, as in
        # the reference), then queries for them
        stamps["retract"], t0 = _now(), ticks()
        for i in retracted:
            doc_subject._remove(ref_scalar(i), {"doc_id": i, "text": docs[i], "meta": f"doc:{i}"})
        commit(doc_subject, lambda: len(ix) == CORPUS_ROWS + ENGINE_LIVE_TICKS * ENGINE_LIVE_DOCS
               - ENGINE_RETRACT, "the retraction")
        stage("retraction", t0)
        stamps["retract_q"], t0 = qid, ticks()
        for lo in range(0, ENGINE_RETRACT, 16):
            ask(qs, [(qid + j, docs[retracted[lo + j]]) for j in range(16)])
            qid += 16
        stage("retraction_queries", t0)
        for i in retracted:
            record["mirror"].remove(doc_key(i))
        record["retract_ref"] = [
            r for lo in range(stamps["retract_q"], qid, 16)
            for r in mirror_search(record["mirror"], [qvecs[q] for q in range(lo, lo + 16)])
        ]
        stamps["queries"] = qid

    def snapshot(ix) -> TpuDenseKnnIndex:
        """A separate index holding the engine index's rows (host copies)."""
        state = ix.state_dict()
        c = dict(state["corpus"], host=state["corpus"]["host"].copy(),
                 valid_host=state["corpus"]["valid_host"].copy())
        m = TpuDenseKnnIndex(dimensions=DIM, metric="cosine", reserved_space=c["capacity"], device=dev)
        m.load_state({"metadata": dict(state["metadata"]), "corpus": c})
        return m

    def mirror_add(m, ix, doc_ids, key_of) -> None:
        for i in doc_ids:
            k = key_of(i)
            m.upsert(k, ix.corpus.host[ix.corpus.slot_of[k]].copy(), ix.metadata[k])

    def mirror_search(m, vs: list) -> list:
        before = bt.block_topk.launches, bt.block_topk.shapes.copy()
        out = m.search([(v, K, None) for v in vs])
        bt.block_topk.launches, bt.block_topk.shapes = before  # not the path's
        return out

    queries = pw.io.python.read(QuerySubject(), schema=QuerySchema, autocommit_duration_ms=None)
    qv = queries.select(qid=pw.this.qid, v=emb(pw.this.q))
    answers = index.query_as_of_now(qv.v, number_of_matches=K).select(
        qid=pw.left.qid,
        ids=pw.right._pw_index_reply_id,
        scores=pw.right._pw_index_reply_score,
        meta=pw.right.meta,
    )
    pw.io.subscribe(qv, on_change=on_query_vec)
    pw.io.subscribe(answers, on_change=on_reply)
    t_run = _now()
    pw.run()  # raises if an operator recorded an error (a kernel failure included)
    run_s = _now() - t_run
    if failure:
        raise failure[0]
    launches = bt.block_topk.launches
    shapes = dict(bt.block_topk.shapes)
    peak = torch.cuda.max_memory_allocated()
    rt = parse_graph.G.last_runtime

    # checks
    n_q = stamps["queries"]
    check(sorted(replies) == list(range(n_q)), "a query is missing from the replies")
    # every reply against a separate index holding the same rows as the
    # engine's at that reply (searched in the query subject's thread, engine idle)
    static = range(stamps["static_q"])
    # exact key order per group; the rest differ only at near ties
    exact = {"static": 0, "live": 0, "retraction": 0}
    for q, ref in zip(static, record["static_ref"]):
        got = tuple(zip(replies[q]["ids"], replies[q]["scores"]))
        check(same_up_to_near_ties(got, ref, F32_TOL), f"query {q}: engine reply differs from direct search")
        exact["static"] += [k for k, _s in got] == [k for k, _s in ref]
        d = int(static_docs[q if q < n_static else q - n_static])
        check(replies[q]["meta"][0] == f"doc:{d}", f"query {q} copied from doc {d} got {replies[q]}")
    for (q, target), ref in zip(record["live"], record["live_ref"]):
        got = tuple(zip(replies[q]["ids"], replies[q]["scores"]))
        check(replies[q]["meta"][0] == f"doc:{target}", f"live query {q} missed its new doc {target}")
        check(same_up_to_near_ties(got, ref, F32_TOL), f"live query {q} differs from direct search")
        exact["live"] += [k for k, _s in got] == [k for k, _s in ref]
    gone = {f"doc:{i}" for i in retracted}
    late = [meta for t, meta in updates if t >= stamps["retract"]]
    check(bool(late) and not any(gone & set(meta) for meta in late),
          "a reply emitted after the retraction carries a retracted document")
    for q, ref in zip(range(stamps["retract_q"], n_q), record["retract_ref"]):
        got = tuple(zip(replies[q]["ids"], replies[q]["scores"]))
        check(not gone & set(replies[q]["meta"]), f"query {q} returned a retracted document")
        check(same_up_to_near_ties(got, ref, F32_TOL), f"query {q} after the retraction differs")
        exact["retraction"] += [k for k, _s in got] == [k for k, _s in ref]
    del record["mirror"]
    check(emb.runtime.device.type == "cuda", f"the embedder ran on {emb.runtime.device}")
    check(shapes.get((1, K), 0) > 0 and shapes.get((16, K), 0) > 0,
          f"block_topk did not run at B=1 and B=16 on the engine path: {dict(shapes)}")
    searches = (ENGINE_B1_TICKS + ENGINE_B16_TICKS + ENGINE_TICKSCOPE_AB + ENGINE_LIVE_TICKS
                + ENGINE_RETRACT // 16)
    check(launches == searches, f"{launches} kernel launches for {searches} index searches")
    # one tick per commit, and the final tick that closes the run
    check(rt.stats.ticks == n_commits[0] + 1, f"{rt.stats.ticks} ticks for {n_commits[0]} commits")
    # the whole corpus went up again on the first search after each tick
    # that changed it: after the ingest, each live commit and the retraction
    # (uploads inside the engine's knn.search spans, not the check's index)
    spans = tracer.spans()
    searches_ids = {sp.span_id for sp in spans if sp.name == "knn.search"}
    uploads = [sp for sp in spans if sp.name == "knn.corpus_upload" and sp.parent_id in searches_ids]
    check(len(uploads) == ENGINE_LIVE_TICKS + 2, f"{len(uploads)} corpus uploads")
    upload_ms = [sp.duration_ns / 1e6 for sp in uploads]

    def lat(qs):
        ms = [(replies[q]["t"] - commits[q]) * 1e3 for q in qs]
        return {"p50": float(np.percentile(ms, 50)), "max": float(np.max(ms)), "n": len(ms)}

    ingest_s = stamps["ingest1"] - stamps["ingest0"]
    b1 = range(ENGINE_B1_TICKS)
    b16 = range(ENGINE_B1_TICKS, n_static)
    ab = {on: [q for e, q in record["tickscope_ab"] if e == on] for on in (True, False)}
    phase = {
        "phase": "engine",
        "rows": CORPUS_ROWS,
        "docs": N_DOCS,
        "commits": {"docs": N_DOCS // ENGINE_DOC_COMMIT, "doc_rows": ENGINE_DOC_COMMIT,
                    "vectors": -(-n_vec // ENGINE_VEC_COMMIT), "vector_rows": ENGINE_VEC_COMMIT},
        "ingest_s": ingest_s,
        "ingest_rows_per_s": CORPUS_ROWS / ingest_s,
        "embed_docs_per_s": N_DOCS / (stamps["docs_in"] - stamps["ingest0"]),
        "vector_rows_per_s": n_vec / (stamps["ingest1"] - stamps["docs_in"]),
        # where ingest goes: the subject's next() calls, and the engine's
        # seconds per operator type over the whole run (runtime stats)
        "vector_next_s": stamps["push_s"],
        "operator_s": operator_s(rt),
        "query_reply_p50_ms": {"B=1": lat(b1)["p50"], "B=16": lat(b16)["p50"]},
        "query_reply_max_ms": {"B=1": lat(b1)["max"], "B=16": lat(b16)["max"]},
        # Tick Scope's own cost: alternate B = 1 queries in one window
        "b1_reply_ms_tickscope_on_off": {"on": lat(ab[True]), "off": lat(ab[False])},
        # the query ticks, operator by operator (Tick Scope)
        "query_ticks": {g: tick_anatomy(rt, *w) for g, w in windows.items()},
        "update_to_visible_ms": {"p50": float(np.percentile(record["update_ms"], 50)),
                                 "max": float(np.max(record["update_ms"])), "n": len(record["update_ms"])},
        "reupload_ms": {"p50": float(np.percentile(upload_ms, 50)),
                        "max": float(np.max(upload_ms)), "n": len(upload_ms)},
        "reupload_bytes": int(np.median([sp.attributes["bytes"] for sp in uploads])),
        "ticks": rt.stats.ticks,
        "ticks_by_stage": stage_ticks,
        "run_s": run_s,
        "queries": n_q,
        "replies_keys_equal_direct_search": sum(exact.values()),
        "replies_keys_equal_direct_search_by_group": exact,
        "replies_compared": len(static) + len(record["live"]) + ENGINE_RETRACT,
        "replies_compared_by_group": {"static": len(static), "live": len(record["live"]),
                                      "retraction": ENGINE_RETRACT},
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "embedder_device": str(emb.runtime.device),
        "peak_allocated_bytes": peak,
    }
    prep, _c2, valid = record["index"].corpus.prepared_arrays("cosine", bf16=False)
    batches = {
        1: torch.from_numpy(np.stack([qvecs[0]])).to(dev),
        16: torch.from_numpy(np.stack([qvecs[q] for q in b16[:16]])).to(dev),
    }
    parse_graph.G.clear()
    return phase, {"prep": prep, "valid": valid, "queries": batches,
                   "launches": launches, "shapes": shapes}


# --- phase 5: vector store ----------------------------------------------------


def vector_store(dev, smi: str) -> tuple[dict, dict]:
    """The RAG product layer as a user writes it, on the card: documents
    arrive as bytes through pw.io.python; VectorStoreServer parses them
    (Utf8Parser), splits them (TokenCountSplitter), embeds the chunks
    (SentenceTransformerEmbedder at full width) and indexes them
    (USearchKnn on cuda: the block top-k kernel answers every retrieval).
    Query rows go through retrieve_query; the B = 16 replies also through
    CrossEncoderReranker and rerank_topk_filter; asks through
    BaseRAGQuestionAnswerer(EchoChat()). Every batch is one commit() and
    one tick; the feeding thread waits for that tick before it commits again."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.llms import EchoChat
    from pathway_tpu_torch.xpacks.llm.parsers import Utf8Parser
    from pathway_tpu_torch.xpacks.llm.question_answering import BaseRAGQuestionAnswerer
    from pathway_tpu_torch.xpacks.llm.rerankers import CrossEncoderReranker, rerank_topk_filter
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    rng = np.random.default_rng(SEED + 11)
    n_all = VS_DOCS + VS_LIVE_TICKS * VS_LIVE_DOCS
    docs = synthetic_docs(n_all, rng)

    # the chunks the store will index, split here on the host to know the
    # corpus size per commit and to copy queries from
    splitter = TokenCountSplitter(min_tokens=VS_MIN_TOKENS, max_tokens=VS_MAX_TOKENS)
    chunks_of = [[c for c, _m in splitter.split(d)] for d in docs]
    upto = np.cumsum([len(c) for c in chunks_of])  # chunks of documents 0..i
    n_static = VS_B1_TICKS + 16 * VS_B16_TICKS + 16 * VS_FILTER_TICKS + VS_ASKS
    qdocs = [int(d) for d in rng.choice(VS_DOCS, size=n_static, replace=False)]
    live_targets = [VS_DOCS + t * VS_LIVE_DOCS + (t * 7) % VS_LIVE_DOCS for t in range(VS_LIVE_TICKS)]
    wanted = {chunks_of[d][0] for d in qdocs + live_targets}
    capacity = -(-int(upto[-1]) // 1024) * 1024  # the corpus never doubles mid-run

    parse_graph.G.clear()
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    qvec: dict[str, np.ndarray] = {}
    rerank_calls: list[tuple[int, float]] = []

    class RecordingEmbedder(SentenceTransformerEmbedder):
        """Keeps the vector of each query text it embeds (for the direct
        search of the checks)."""

        def embed_batch(self, texts):
            out = super().embed_batch(texts)
            for t, v in zip(texts, out):
                if t in wanted:
                    qvec[t] = v
            return out

    class TimedReranker(CrossEncoderReranker):
        """Times each batched scoring call (one per tick's pairs)."""

        def _score_batch(self, docs_, queries_):
            t0 = time.perf_counter()
            out = super()._score_batch(docs_, queries_)  # returns host floats
            rerank_calls.append((len(docs_), time.perf_counter() - t0))
            return out

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        data: bytes
        _metadata: pw.Json

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        query: str
        k: int
        metadata_filter: str | None = pw.column_definition(default_value=None, dtype=str)
        filepath_globpattern: str | None = pw.column_definition(default_value=None, dtype=str)
        rerank: bool

    class StatsSchema(pw.Schema):
        sid: int = pw.column_definition(primary_key=True)

    finished = threading.Event()
    failure: list[BaseException] = []

    class Idle(pw.io.python.ConnectorSubject):
        """Fed from the feeder's thread; ends with the traffic."""

        def run(self):
            finished.wait()

    class Feeder(pw.io.python.ConnectorSubject):
        def run(self):
            try:
                drive(self)
            except BaseException as e:  # noqa: BLE001 — re-raised after pw.run
                failure.append(e)
            finally:
                finished.set()

    doc_subject, stats_subject, inputs_subject, ask_subject = Idle(), Idle(), Idle(), Idle()
    t0 = time.perf_counter()
    emb = RecordingEmbedder(device=dev)  # full width, bf16, seeded
    init_s = {"embedder": time.perf_counter() - t0}
    t0 = time.perf_counter()
    reranker = TimedReranker(device=dev)  # dim 256, depth 4, heads 4, max_len 512
    init_s["reranker"] = time.perf_counter() - t0
    documents = pw.io.python.read(doc_subject, schema=DocSchema, autocommit_duration_ms=None)
    store = VectorStoreServer(
        documents, embedder=emb, parser=Utf8Parser(), splitter=splitter,
        index_params={"reserved_space": capacity}, device=dev,
    )
    queries = pw.io.python.read(Feeder(), schema=QuerySchema, autocommit_duration_ms=None)
    retrieved = store.retrieve_query(queries)
    replied = queries.with_columns(result=retrieved.with_universe_of(queries).result)
    pairs = replied.filter(pw.this.rerank).select(
        qid=pw.this.qid, query=pw.this.query,
        doc=pw.apply_with_type(lambda r: [d["text"] for d in r.value], list, pw.this.result),
    ).flatten(pw.this.doc)
    scored = pairs.select(qid=pw.this.qid, doc=pw.this.doc, score=reranker(pw.this.doc, pw.this.query))
    top = scored.groupby(pw.this.qid).reduce(
        pw.this.qid, docs=pw.reducers.tuple(pw.this.doc), scores=pw.reducers.tuple(pw.this.score)
    ).select(qid=pw.this.qid, top=rerank_topk_filter(pw.this.docs, pw.this.scores, RERANK_KEEP))
    stats = store.statistics_query(
        pw.io.python.read(stats_subject, schema=StatsSchema, autocommit_duration_ms=None)
    )
    inputs = store.inputs_query(
        pw.io.python.read(inputs_subject, schema=store.InputsQuerySchema, autocommit_duration_ms=None)
    )
    answerer = BaseRAGQuestionAnswerer(EchoChat(), store, search_topk=K)
    asks = pw.io.python.read(ask_subject, schema=answerer.AnswerQuerySchema, autocommit_duration_ms=None)
    answers = asks.select(prompt=pw.this.prompt, result=answerer.answer_query(asks).with_universe_of(asks).result)

    _now = time.perf_counter
    replies: dict[int, tuple[float, list]] = {}
    ranked: dict[int, tuple[float, tuple]] = {}
    text_of: dict[int, str] = {}
    results: dict[str, list] = {"stats": [], "inputs": [], "answers": []}

    def on_reply(key, row, time, is_addition):
        if is_addition and row["qid"] not in replies:
            replies[row["qid"]] = (_now(), row["result"].value)

    def on_top(key, row, time, is_addition):
        if is_addition:
            ranked[row["qid"]] = (_now(), row["top"])

    def on_chunk(key, row, time, is_addition):
        if is_addition:
            text_of[int(key)] = row["text"]

    pw.io.subscribe(replied, on_change=on_reply)
    pw.io.subscribe(top, on_change=on_top)
    pw.io.subscribe(store._graph["chunked_docs"], on_change=on_chunk)
    for name, table in (("stats", stats), ("inputs", inputs), ("answers", answers)):
        pw.io.subscribe(
            table,
            on_change=lambda key, row, time, is_addition, out=results[name]: is_addition
            and out.append(row),
        )

    commits: dict[int, float] = {}
    n_commits = [0]
    stamps: dict[str, float] = {}
    record: dict = {"update_ms": [], "ticks": {}}
    windows: dict[str, list[int]] = {}

    def commit(subject, cond, what: str) -> float:
        subject.commit()
        t = _now()
        n_commits[0] += 1
        goal, rt = n_commits[0], parse_graph.G.runtime
        wait_until(lambda: cond() and rt.stats.ticks >= goal, what)
        return t

    def ask(qs, rows: list[tuple]) -> None:
        """rows: (qid, text, k, filter, rerank)."""
        for qid, text, k, flt, rerank in rows:
            qs.next(qid=qid, query=text, k=k, metadata_filter=flt, filepath_globpattern=None,
                    rerank=rerank)
        t = commit(qs, lambda: all(r[0] in replies for r in rows)
                   and all(r[0] in ranked for r in rows if r[4]), "a query's reply")
        for r in rows:
            commits[r[0]] = t

    def drive(qs) -> None:
        rt = parse_graph.G.runtime
        execs = sorted((ex for ex in rt.execs.values() if isinstance(ex, ExternalIndexExec)),
                       key=lambda ex: ex.node.id)
        ix = record["index"] = execs[0].index  # retrieve_query's (built before the answerer's)
        ticks = lambda: rt.stats.ticks  # noqa: E731
        stamps["ingest0"], t0 = _now(), ticks()
        for lo in range(0, VS_DOCS, VS_COMMIT):
            for i in range(lo, lo + VS_COMMIT):
                doc_subject.next(doc_id=i, data=docs[i].encode(), _metadata={"path": doc_path(i)})
            commit(doc_subject, lambda: len(ix) >= upto[lo + VS_COMMIT - 1], "a document commit")
        stamps["ingest1"] = _now()
        record["ticks"]["docs"] = ticks() - t0
        qid, it, t0 = 0, iter(qdocs), ticks()
        groups: dict[str, list] = {"B=1": [], "B=16": [], "filtered": []}
        windows["B=1"] = [time.perf_counter_ns()]
        for _ in range(VS_B1_TICKS):
            d = next(it)
            ask(qs, [(qid, chunks_of[d][0], K, None, False)])
            groups["B=1"].append((qid, d, None))
            qid += 1
        windows["B=1"].append(time.perf_counter_ns())
        record["ticks"]["queries_B=1"] = ticks() - t0
        t0 = ticks()
        windows["B=16 reranked"] = [time.perf_counter_ns()]
        for _ in range(VS_B16_TICKS):
            rows = []
            for j in range(16):
                d = next(it)
                rows.append((qid + j, chunks_of[d][0], K, None, True))
                groups["B=16"].append((qid + j, d, None))
            ask(qs, rows)
            record.setdefault("rerank_ticks", []).append([r[0] for r in rows])
            qid += 16
        windows["B=16 reranked"].append(time.perf_counter_ns())
        record["ticks"]["queries_B=16_reranked"] = ticks() - t0
        t0 = ticks()
        for _ in range(VS_FILTER_TICKS):
            rows = []
            for j in range(16):
                d = next(it)
                flt = f"globmatch('docs/{d % VS_GROUPS}/*', path)"
                rows.append((qid + j, chunks_of[d][0], K, flt, False))
                groups["filtered"].append((qid + j, d, flt))
            ask(qs, rows)
            qid += 16
        record["ticks"]["queries_filtered"] = ticks() - t0
        mirror = snapshot_index(ix, dev)
        record["static_ref"] = {
            q: mirror.search([(qvec[chunks_of[d][0]], K, flt)])[0]
            for rows in groups.values() for q, d, flt in rows
        }
        record["groups"] = groups
        del mirror
        # live: a commit of 64 new documents, then a query for one of them
        t0, record["live_ns0"] = ticks(), dict(rt.stats.node_ns)
        for t in range(VS_LIVE_TICKS):
            lo = VS_DOCS + t * VS_LIVE_DOCS
            for i in range(lo, lo + VS_LIVE_DOCS):
                doc_subject.next(doc_id=i, data=docs[i].encode(), _metadata={"path": doc_path(i)})
            tc = commit(doc_subject, lambda: len(ix) >= upto[lo + VS_LIVE_DOCS - 1], "a live commit")
            target = live_targets[t]
            ask(qs, [(qid, chunks_of[target][0], K, None, False)])
            record["update_ms"].append((replies[qid][0] - tc) * 1e3)
            mirror = snapshot_index(ix, dev)
            record.setdefault("live", []).append(
                (qid, target, mirror.search([(qvec[chunks_of[target][0]], K, None)])[0]))
            del mirror
            qid += 1
        record["ticks"]["live_docs_and_queries"] = ticks() - t0
        record["live_operator_s"] = operator_s(rt, record["live_ns0"])
        record["live_operator_s_by_node"] = operator_s_by_node(rt, record["live_ns0"])
        t0 = ticks()
        stats_subject.next(sid=0)
        commit(stats_subject, lambda: bool(results["stats"]), "the statistics reply")
        inputs_subject.next(metadata_filter="globmatch('docs/1/*', path)", filepath_globpattern=None)
        commit(inputs_subject, lambda: bool(results["inputs"]), "the inputs reply")
        for a in range(VS_ASKS):
            d = next(it)
            ask_subject.next(prompt=chunks_of[d][0], filters=None, model=None, return_context_docs=True)
            commit(ask_subject, lambda: len(results["answers"]) > a, "an answer")
        record["ticks"]["statistics_inputs_asks"] = ticks() - t0
        stamps["queries"] = qid

    t_run = _now()
    pw.run()  # raises if an operator recorded an error (a kernel failure included)
    run_s = _now() - t_run
    if failure:
        raise failure[0]
    launches = bt.block_topk.launches
    shapes = dict(bt.block_topk.shapes)
    peak = torch.cuda.max_memory_allocated()
    rt = parse_graph.G.last_runtime
    n_chunks = int(upto[-1])

    # checks
    check(len(text_of) == n_chunks, f"{len(text_of)} chunks indexed, {n_chunks} expected")
    check(sorted(replies) == list(range(stamps["queries"])), "a query is missing from the replies")
    exact: dict[str, int] = {}
    for group, rows in record["groups"].items():
        exact[group] = 0
        for q, d, flt in rows:
            got = tuple((r["text"], -r["dist"]) for r in replies[q][1])
            ref = tuple((text_of[key], score) for key, score in record["static_ref"][q])
            check(same_up_to_near_ties(got, ref, F32_TOL), f"{group} query {q}: reply differs from direct search")
            exact[group] += [t for t, _s in got] == [t for t, _s in ref]
            check(got[0][0] == chunks_of[d][0] and abs(got[0][1]) < 1e-2,
                  f"{group} query {q} copied from a chunk of doc {d} got {got[:1]}")
            # a filter keeps what passes among the 4k best (the reference's
            # oversample), so a filtered reply may hold fewer than k
            check(len(got) == K or (flt is not None and len(got) > 0),
                  f"{group} query {q} returned {len(got)} of {K}")
            if flt is not None:
                check(all(r["metadata"]["path"].startswith(f"docs/{d % VS_GROUPS}/") for r in replies[q][1]),
                      f"filtered query {q} let a non-matching path through")
    exact["live"] = 0
    for q, target, ref_rows in record["live"]:
        got = tuple((r["text"], -r["dist"]) for r in replies[q][1])
        ref = tuple((text_of[key], score) for key, score in ref_rows)
        check(got[0][0] == chunks_of[target][0], f"live query {q} missed its new doc {target}")
        check(same_up_to_near_ties(got, ref, F32_TOL), f"live query {q} differs from direct search")
        exact["live"] += [t for t, _s in got] == [t for t, _s in ref]
    (stat,) = [r["result"].value for r in results["stats"]]
    check(stat["file_count"] == n_chunks, f"statistics file_count {stat['file_count']} for {n_chunks} chunks")
    (inp,) = [r["result"].value for r in results["inputs"]]
    want = {doc_path(i) for i in range(n_all) if i % VS_GROUPS == 1}
    got_paths = [m["path"] for m in inp]
    check(len(got_paths) == len(set(got_paths)) and set(got_paths) == want,
          f"inputs_query under the filter: {len(got_paths)} paths, {len(want)} expected")
    check(len(results["answers"]) == VS_ASKS, "an ask is missing an answer")
    for row in results["answers"]:
        ans = row["result"].value
        ctx = ans["context_docs"]
        check(len(ctx) == K and row["prompt"] == ctx[0]["text"], "an answer's first context is not its chunk")
        check(all(c["text"] in ans["response"] for c in ctx), "an echoed answer misses a retrieved text")
    # rerank: every kept score against a direct forward of the tick's pairs
    rerank_err = 0.0
    tokenize_ms = []  # the host share of a rerank call: its pairs' tokenization
    for tick_qids in record["rerank_ticks"]:
        pair_q, pair_t = [], []
        for q in tick_qids:
            query = chunks_of[next(d for qq, d, _f in record["groups"]["B=16"] if qq == q)][0]
            for r in replies[q][1]:
                pair_q.append((q, r["text"]))
                pair_t.append(reranker._pair_text(r["text"], query))
        t0 = time.perf_counter()
        ids, mask = reranker.tokenizer.encode_batch(pair_t, reranker.runtime.max_len)
        tokenize_ms.append((time.perf_counter() - t0) * 1e3)
        direct = dict(zip(pair_q, reranker.runtime.forward_ids(ids, mask).tolist()))
        for q in tick_qids:
            kept_docs, kept_scores = ranked[q][1]
            want_top = sorted(((s, t) for (qq, t), s in direct.items() if qq == q), key=lambda p: -p[0])
            check(len(kept_docs) == RERANK_KEEP, f"rerank of query {q} kept {len(kept_docs)}")
            for t, s in zip(kept_docs, kept_scores):
                rerank_err = max(rerank_err, abs(s - direct[(q, t)]))
            check(all(abs(s - ws) <= RERANK_TOL for s, (ws, _t) in zip(kept_scores, want_top)),
                  f"rerank of query {q} kept other scores than the direct forward's top {RERANK_KEEP}")
    check(rerank_err <= RERANK_TOL, f"reranked scores differ from a direct forward by {rerank_err}")
    check(emb.runtime.device.type == "cuda" and reranker.runtime.device.type == "cuda",
          "the embedder or the reranker left the card")
    want_shapes = {(1, K): VS_B1_TICKS + VS_LIVE_TICKS + VS_ASKS, (16, K): VS_B16_TICKS,
                   (16, 4 * K): VS_FILTER_TICKS}
    check(shapes == want_shapes, f"block_topk launches by shape {shapes}, searches {want_shapes}")
    check(launches == sum(want_shapes.values()), f"{launches} kernel launches for the searches")
    check(rt.stats.ticks == n_commits[0] + 1, f"{rt.stats.ticks} ticks for {n_commits[0]} commits")

    def lat(rows):
        ms = [(replies[q][0] - commits[q]) * 1e3 for q, *_r in rows]
        return float(np.percentile(ms, 50)), float(np.max(ms))

    ingest_s = stamps["ingest1"] - stamps["ingest0"]
    pairs_n, rerank_s = sum(n for n, _s in rerank_calls), sum(s for _n, s in rerank_calls)
    rerank_reply = [(ranked[q][0] - commits[q]) * 1e3 for qs_ in record["rerank_ticks"] for q in qs_]
    groups = record["groups"]
    phase = {
        "phase": "vector store",
        "nvidia_smi": smi,
        # the seeded (flax-equal, numpy) init of each encoder, on the host
        "embedder_init_s": init_s["embedder"],
        "reranker_init_s": init_s["reranker"],
        "docs": VS_DOCS,
        "live_docs": VS_LIVE_TICKS * VS_LIVE_DOCS,
        "chunks": n_chunks,
        "corpus_capacity": capacity,
        "ingest_s": ingest_s,
        "embed_chunks_per_s": int(upto[VS_DOCS - 1]) / ingest_s,
        "retrieve_reply_p50_ms": {g: lat(rows)[0] for g, rows in groups.items()},
        "retrieve_reply_max_ms": {g: lat(rows)[1] for g, rows in groups.items()},
        "update_to_visible_ms": {"p50": float(np.percentile(record["update_ms"], 50)),
                                 "max": float(np.max(record["update_ms"])), "n": len(record["update_ms"])},
        "rerank_pairs": pairs_n,
        "rerank_pairs_per_s": pairs_n / rerank_s,
        "rerank_p50_ms": float(np.percentile([s * 1e3 for _n, s in rerank_calls], 50)),
        "rerank_tokenize_p50_ms": float(np.percentile(tokenize_ms, 50)),
        "rerank_reply_p50_ms": float(np.percentile(rerank_reply, 50)),
        "rerank_max_abs_err": rerank_err,
        "replies_keys_equal_direct_search": sum(exact.values()),
        "replies_keys_equal_direct_search_by_group": exact,
        "replies_compared": sum(len(r) for r in groups.values()) + len(record["live"]),
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "ticks": rt.stats.ticks,
        "ticks_by_stage": record["ticks"],
        # the query ticks, operator by operator (Tick Scope)
        "query_ticks": {g: tick_anatomy(rt, *w) for g, w in windows.items()},
        # the engine's seconds per operator type: the whole run, and the
        # 16 live ticks alone (what update-to-visible waits on)
        "operator_s": operator_s(rt),
        "live_operator_s": record["live_operator_s"],
        "live_operator_s_by_node": record["live_operator_s_by_node"],
        "run_s": run_s,
        "peak_allocated_bytes": peak,
    }
    prep, _c2, valid = record["index"].corpus.prepared_arrays("cosine", bf16=False)

    def batch(rows):
        return torch.from_numpy(np.stack([qvec[chunks_of[d][0]] for _q, d, _f in rows])).to(dev)

    # the never-killed run's replies, by query text, for the persistence phase
    by_text = {g: [(chunks_of[d][0], tuple((r["text"], -r["dist"]) for r in replies[q][1])) for q, d, _f in rows]
               for g, rows in groups.items() if g != "filtered"}
    # each slot's chunk text: the persistence phase searches this corpus as the never-killed run's
    slot_texts = [text_of.get(k) for k in record["index"].corpus.keys_for_slots(np.arange(len(valid)))]
    out = {"prep": prep, "valid": valid, "launches": launches, "shapes": shapes, "replies_by_text": by_text,
           "slot_texts": slot_texts,
           "corpus": (docs, chunks_of, upto),  # the rest and persistence phases serve the same corpus
           "queries": {1: batch(groups["B=1"][:1]), 16: batch(groups["B=16"][:16]),
                       "filtered": batch(groups["filtered"][:16])}}
    parse_graph.G.clear()
    return phase, out


# --- phase 6: rest ------------------------------------------------------------


def rest_client() -> int:
    """The rest phase's HTTP clients, in a process of their own so that
    their Python does not share the server's interpreter lock. One JSON
    command per stdin line: {"port": p, "clients": [[request, ...], ...],
    "new_connection": bool}, a request being [id, method, target, body or
    null, headers]. Each client list runs in its own thread, its requests
    one after another on one keep-alive connection (a new connection each
    with new_connection). Answers two stdout lines: {"sent": n} once every
    client has sent its first request, then {"replies": [[id, status,
    headers, body, sent, done], ...]}, the stamps from time.monotonic()
    (one clock for every process of the machine). A failed connection
    answers status "conn"."""
    import http.client

    for line in sys.stdin:
        cmd = json.loads(line)
        lists = cmd["clients"]
        replies: list = []
        lock = threading.Lock()
        started = threading.Barrier(len(lists))
        first_sent = threading.Semaphore(0)

        def client(reqs: list) -> None:
            conn = None
            started.wait()
            for n, (rid, method, target, body, headers) in enumerate(reqs):
                if conn is None or cmd["new_connection"]:
                    conn = http.client.HTTPConnection("127.0.0.1", cmd["port"], timeout=120)
                t0 = time.monotonic()
                try:
                    conn.request(method, target, body=body, headers=headers)
                    if n == 0:
                        first_sent.release()
                    resp = conn.getresponse()
                    raw = resp.read()
                    hdrs = {k.lower(): v for k, v in resp.getheaders()}
                    data = json.loads(raw) if hdrs.get("content-type", "").startswith("application/json") \
                        else raw.decode(errors="replace")
                    rep = [rid, resp.status, hdrs, data, t0, time.monotonic()]
                except (OSError, http.client.HTTPException) as e:
                    if n == 0:
                        first_sent.release()
                    rep = [rid, "conn", {}, repr(e), t0, time.monotonic()]
                    conn.close()
                    conn = None
                with lock:
                    replies.append(rep)
                if cmd["new_connection"] and conn is not None:
                    conn.close()
            if conn is not None:
                conn.close()

        threads = [threading.Thread(target=client, args=(reqs,)) for reqs in lists]
        for t in threads:
            t.start()
        for _ in lists:
            first_sent.acquire()
        print(json.dumps({"sent": len(lists)}), flush=True)
        for t in threads:
            t.join()
        print(json.dumps({"replies": replies}), flush=True)
    return 0


class RestClients:
    """The parent's side of ``rest_client``: one child process for the
    whole phase."""

    def __init__(self):
        import queue

        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rest-client"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        )
        self.lines: queue.Queue = queue.Queue()
        self.reader = threading.Thread(target=lambda: [self.lines.put(ln) for ln in self.proc.stdout], daemon=True)
        self.reader.start()

    def _line(self, key: str) -> object:
        import queue

        try:
            msg = json.loads(self.lines.get(timeout=300))
        except queue.Empty:
            raise AssertionError("the REST client process did not answer") from None
        check(key in msg, f"the REST client process answered {msg}")
        return msg[key]

    def start(self, port: int, lists: list, new_connection: bool = False) -> None:
        """Send the requests; returns once every client sent its first."""
        self.proc.stdin.write(json.dumps({"port": port, "clients": lists, "new_connection": new_connection}) + "\n")
        self.proc.stdin.flush()
        self._line("sent")

    def finish(self) -> list:
        return self._line("replies")

    def run(self, port: int, lists: list, new_connection: bool = False) -> list:
        self.start(port, lists, new_connection)
        return self.finish()

    def close(self) -> None:
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def refused(port: int) -> bool:
    import socket

    try:
        socket.create_connection(("127.0.0.1", port), timeout=5).close()
    except ConnectionRefusedError:
        return True
    return False


def rest(dev, smi: str, vs_b1_p50_ms: float, corpus: tuple) -> tuple[dict, dict]:
    """VectorStoreServer.run_server answering /v1/retrieve over HTTP on the
    card: the vector store phase's corpus (the same 32,768 seeded
    documents in 16 commits of 2048 through pw.io.python, the same
    full-width embedder, device="cuda"), served ungated by run_server on one
    port and, in the same graph, through a Surge Gate (a gated
    rest_connector wired to retrieve_query) on another. Stdlib http.client
    clients in a child process send the groups of REST_GROUPS; every 200
    reply of /v1/retrieve is checked against a direct search, with the
    vector the embedder computed for that request, of a plain-torch copy
    of the store's index."""
    import urllib.parse

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import errors, parse_graph
    from pathway_tpu_torch.io.http import PathwayWebserver, rest_connector
    from pathway_tpu_torch.observability import REGISTRY
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.serving import QoSConfig, degrade, drain_all, gates
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.parsers import Utf8Parser
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    t_phase = time.perf_counter()
    stage_s: dict[str, float] = {}
    t_mark = [t_phase]

    def mark(stage: str) -> None:
        now = time.perf_counter()
        stage_s[stage], t_mark[0] = now - t_mark[0], now

    clients = RestClients()  # starts while the corpus loads
    docs, chunks_of, upto = corpus  # the vector store phase's documents and their chunks
    splitter = TokenCountSplitter(min_tokens=VS_MIN_TOKENS, max_tokens=VS_MAX_TOKENS)
    capacity = -(-int(upto[-1]) // 1024) * 1024
    n_asks = (2 + REST_SEQ + REST_GET + REST_FILTERED + REST_CLIENTS * (REST_UNGATED_EACH + REST_GATED_EACH)
              + REST_BURST + REST_DEADLINE + REST_STALE + 2 * REST_DRAIN)
    qdocs = iter(int(d) for d in np.random.default_rng(SEED + 13).choice(VS_DOCS, size=n_asks, replace=False))
    mark("clients_and_queries")

    parse_graph.G.clear()
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    qvec: dict[str, np.ndarray] = {}
    recording = threading.Event()

    class RecordingEmbedder(SentenceTransformerEmbedder):
        """Keeps the first vector it computes for each text once the corpus
        is loaded: a request's insert tick embeds its query before the
        remove tick embeds it again."""

        def embed_batch(self, texts):
            out = super().embed_batch(texts)
            if recording.is_set():
                for t, v in zip(texts, out):
                    qvec.setdefault(t, v)
            return out

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        data: bytes
        _metadata: pw.Json

    finished = threading.Event()

    class Idle(pw.io.python.ConnectorSubject):
        def run(self):
            finished.wait()

    doc_subject = Idle()
    emb = RecordingEmbedder(device=dev)
    mark("embedder_init")
    documents = pw.io.python.read(doc_subject, schema=DocSchema, autocommit_duration_ms=None)
    store = VectorStoreServer(
        documents, embedder=emb, parser=Utf8Parser(), splitter=splitter,
        index_params={"reserved_space": capacity}, device=dev,
    )
    text_of: dict[int, str] = {}
    meta_of: dict[int, dict] = {}

    def on_chunk(key, row, time, is_addition):
        if is_addition:
            text_of[int(key)], meta_of[int(key)] = row["text"], row["metadata"].value

    pw.io.subscribe(store._graph["chunked_docs"], on_change=on_chunk)
    port_a, port_b = free_port(), free_port()
    qos = QoSConfig(**REST_QOS)
    gated_ws = PathwayWebserver("127.0.0.1", port_b)
    gated_q, gated_writer = rest_connector(
        webserver=gated_ws, route="/v1/retrieve", schema=store.RetrieveQuerySchema,
        methods=("GET", "POST"), delete_completed_queries=True, qos=qos,
    )
    gated_res = store.retrieve_query(gated_q)
    gated_writer(gated_res.select(query_id=gated_res.id, result=gated_res.result))
    err0 = errors.error_count()
    run_thread = store.run_server("127.0.0.1", port_a, threaded=True)
    wait_until(lambda: parse_graph.G.runtime is not None, "the runtime")
    rt = parse_graph.G.runtime
    wait_until(lambda: not refused(port_a) and not refused(port_b), "the two listeners", 60)
    execs = sorted((ex for ex in rt.execs.values() if isinstance(ex, ExternalIndexExec)), key=lambda ex: ex.node.id)
    check(len(execs) == 2, f"{len(execs)} index execs, expected the gated and the ungated retrieve")
    ix = execs[0].index
    mark("graph_and_servers_up")
    t0 = time.perf_counter()
    for lo in range(0, VS_DOCS, VS_COMMIT):
        for i in range(lo, lo + VS_COMMIT):
            doc_subject.next(doc_id=i, data=docs[i].encode(), _metadata={"path": doc_path(i)})
        doc_subject.commit()
        goal = upto[lo + VS_COMMIT - 1]
        wait_until(lambda: all(len(ex.index) >= goal for ex in execs), "a document commit")
    ingest_s = time.perf_counter() - t0
    recording.set()
    mark("ingest")

    # --- requests ------------------------------------------------------------
    asked: dict[int, dict] = {}  # request id -> what it asked

    def req(group: str, port: int, k: int = K, flt: str | None = None, method: str = "POST",
            headers: dict | None = None, d: int | None = None, text: str | None = None) -> list:
        d = next(qdocs) if d is None and text is None else d
        text = chunks_of[d][0] if text is None else text
        rid = len(asked)
        asked[rid] = {"group": group, "doc": d, "text": text, "k": k, "filter": flt, "port": port}
        if method == "GET":
            target = "/v1/retrieve?" + urllib.parse.urlencode({"query": text, "k": k})
            return [rid, "GET", target, None, headers or {}]
        body = {"query": text, "k": k, **({"metadata_filter": flt} if flt else {})}
        return [rid, "POST", "/v1/retrieve", json.dumps(body), {"Content-Type": "application/json", **(headers or {})}]

    replies: dict[str, list] = {}
    ticks: dict[str, int] = {}

    def settled() -> None:
        """Wait until the gate is idle and no tick ran for 0.3 s: a reply
        reaches its client before the remove tick that follows it."""
        wait_until(lambda: all(g.inflight == 0 and g.queue_depth == 0 for g in gates()), "the gate to go idle")
        n = -1
        while n != rt.stats.ticks:
            n = rt.stats.ticks
            time.sleep(0.3)

    def lockstep(group: str, n: int, make) -> None:
        """One request at a time, from a quiet engine; the next goes once
        the last one's insert and remove ticks both ran."""
        settled()
        t_first = rt.stats.ticks
        for _ in range(n):
            t_before = rt.stats.ticks
            replies.setdefault(group, []).extend(clients.run(port_a, [[make()]]))
            wait_until(lambda: rt.stats.ticks >= t_before + 2, "a request's remove tick")
        ticks[group] = rt.stats.ticks - t_first

    def filtered() -> list:
        d = next(qdocs)
        return req("filtered", port_a, flt=f"globmatch('docs/{d % VS_GROUPS}/*', path)", d=d)

    replies["warmup"] = clients.run(port_a, [[req("warmup", port_a)]]) + clients.run(port_b, [[req("warmup", port_b)]])
    seq_window = [time.perf_counter_ns()]
    lockstep("ungated sequential POST", REST_SEQ, lambda: req("ungated sequential POST", port_a))
    seq_window.append(time.perf_counter_ns())
    server_hist = REGISTRY.get("pathway_rest_request_seconds").labels("/v1/retrieve")
    server_p50_sequential_ms = server_hist.quantile(0.5) * 1e3
    lockstep("ungated sequential GET", REST_GET, lambda: req("ungated sequential GET", port_a, method="GET"))
    lockstep("filtered", REST_FILTERED, filtered)
    mark("sequential")
    replies["ungated concurrent"] = clients.run(
        port_a, [[req("ungated concurrent", port_a) for _ in range(REST_UNGATED_EACH)] for _ in range(REST_CLIENTS)])
    replies["gated concurrent"] = clients.run(
        port_b, [[req("gated concurrent", port_b) for _ in range(REST_GATED_EACH)] for _ in range(REST_CLIENTS)])
    mark("concurrent")
    replies["overload"] = clients.run(port_b, [[req("overload", port_b)] for _ in range(REST_BURST)],
                                      new_connection=True)
    mark("overload")

    # deadline: a 1 ms budget must end in 504 and reach no search
    knn_queries = REGISTRY.get("pathway_knn_queries_total").labels(type(ix).__name__)
    expired = REGISTRY.get("pathway_serving_deadline_expired_total")
    settled()
    before = (bt.block_topk.launches, knn_queries.value)
    exp0 = {s: expired.labels(s).value for s in ("gate", "knn")}
    replies["deadline"] = clients.run(
        port_b, [[req("deadline", port_b, headers={"x-pathway-deadline-ms": "1"})] for _ in range(REST_DEADLINE)])
    settled()
    deadline_searches = (bt.block_topk.launches - before[0], knn_queries.value - before[1])
    deadline_expired = {s: expired.labels(s).value - exp0[s] for s in exp0}

    # the store's other routes and the OpenAPI document
    n_static = int(upto[VS_DOCS - 1])
    (stats,) = clients.run(port_a, [[[-1, "POST", "/v1/statistics", "{}", {}]]])
    (inputs,) = clients.run(port_a, [[[-2, "POST", "/v1/inputs",
                                       json.dumps({"metadata_filter": "globmatch('docs/1/*', path)"}), {}]]])
    (schema,) = clients.run(port_a, [[[-3, "GET", "/_schema", None, {}]]])
    mark("deadline_and_store_routes")
    static_mirror = snapshot_index(ix, dev)

    # live: 64 new documents, then a REST query for one of them
    update_ms, live = [], []
    for t in range(VS_LIVE_TICKS):
        lo = VS_DOCS + t * VS_LIVE_DOCS
        for i in range(lo, lo + VS_LIVE_DOCS):
            doc_subject.next(doc_id=i, data=docs[i].encode(), _metadata={"path": doc_path(i)})
        tc = time.monotonic()
        doc_subject.commit()
        goal = upto[lo + VS_LIVE_DOCS - 1]
        wait_until(lambda: all(len(ex.index) >= goal for ex in execs), "a live commit")
        target = VS_DOCS + t * VS_LIVE_DOCS + (t * 7) % VS_LIVE_DOCS
        qvec.pop(chunks_of[target][0], None)  # the live commit embedded it as a document
        (rep,) = clients.run(port_a, [[req("live", port_a, d=target)]])
        update_ms.append((rep[5] - tc) * 1e3)
        mirror = snapshot_index(ix, dev)
        live.append((rep, mirror.search([(qvec[chunks_of[target][0]], K, None)])[0]))
        del mirror
    post_mirror = snapshot_index(ix, dev)
    mark("live")

    # stale reads while the engine "recovers", answered by a stale responder
    def responder(values: dict):
        vec = emb.embed_batch([values["query"]])[0]
        (matches,) = degrade.stale_knn_search([(vec, int(values.get("k") or 3), None)])
        return [{"text": text_of[key], "metadata": meta_of[key], "dist": -float(s)} for key, s in matches]

    stale_docs = [next(qdocs) for _ in range(REST_STALE)]
    replies["stale fresh"] = clients.run(port_b, [[req("stale fresh", port_b, d=d) for d in stale_docs]])
    degrade.register_stale_responder("/v1/retrieve", responder)
    launches_before_stale = bt.block_topk.launches
    degrade.enter_recovery("chip smoke")
    try:
        stale = clients.run(port_b, [[req("stale", port_b, d=d) for d in stale_docs]])
        (bounded,) = clients.run(port_b, [[req("stale bounded", port_b, d=stale_docs[0],
                                              headers={"x-pathway-max-staleness-ms": "0"})]])
    finally:
        degrade.exit_recovery("chip smoke")
    stale_launches = bt.block_topk.launches - launches_before_stale
    mark("stale")

    # drain: 16 requests in flight at each server, then drain it
    inflight = REGISTRY.get("pathway_rest_inflight_requests").labels("/v1/retrieve")

    admitted = REGISTRY.get("pathway_serving_admitted_total").labels("/v1/retrieve")

    def drained(port: int, group: str, in_flight, drain) -> tuple[list, bool]:
        """Drain once all REST_DRAIN requests are in flight: inside their
        handlers (ungated), or admitted past the gate."""
        n0 = in_flight()
        clients.start(port, [[req(group, port)] for _ in range(REST_DRAIN)], new_connection=True)
        wait_until(lambda: in_flight() - n0 >= REST_DRAIN, f"{group}: the requests in flight", 60)
        idle = drain()
        return clients.finish(), idle

    replies["drain ungated"], idle_a = drained(
        port_a, "drain ungated", lambda: inflight.current() + server_hist.count, store.drain)
    replies["drain gated"], idle_b = drained(
        port_b, "drain gated", lambda: admitted.value, lambda: drain_all(grace_s=30))
    refused_after = (refused(port_a), refused(port_b))
    mark("drain")
    finished.set()
    rt.stop()
    run_thread.join(timeout=60)
    clients.close()
    check(not run_thread.is_alive(), "the server's run did not stop")
    err = errors.first_exception_since(err0)
    if err is not None:
        raise err if isinstance(err, BaseException) else RuntimeError(err)
    launches, shapes = bt.block_topk.launches, dict(bt.block_topk.shapes)
    peak = torch.cuda.max_memory_allocated()

    # --- checks --------------------------------------------------------------
    def as_rows(body: list) -> tuple:
        return tuple((r["text"], -r["dist"]) for r in body)

    checked: dict[str, int] = {}
    exact: dict[str, int] = {}
    statuses: dict[str, dict] = {}

    def check_reply(rep: list, ref_matches) -> None:
        rid, status, _h, body = rep[:4]
        a = asked[rid]
        got = as_rows(body)
        ref = tuple((text_of[key], score) for key, score in ref_matches)
        check(same_up_to_near_ties(got, ref, F32_TOL), f"{a['group']} request {rid}: reply differs from direct search")
        checked[a["group"]] = checked.get(a["group"], 0) + 1
        exact[a["group"]] = exact.get(a["group"], 0) + ([t for t, _s in got] == [t for t, _s in ref])
        if a["doc"] is not None:
            check(got[0][0] == chunks_of[a["doc"]][0] and abs(got[0][1]) < 1e-2,
                  f"{a['group']} request {rid} copied from doc {a['doc']} got {got[:1]}")
        check(len(got) == a["k"] or (a["filter"] is not None and len(got) > 0),
              f"{a['group']} request {rid} returned {len(got)} of {a['k']}")
        if a["filter"] is not None:
            check(all(r["metadata"]["path"].startswith(f"docs/{a['doc'] % VS_GROUPS}/") for r in body),
                  f"filtered request {rid} let a non-matching path through")

    for group, reps in replies.items():
        statuses[group] = dict(sorted(Counter(str(r[1]) for r in reps).items()))
        mirror = post_mirror if group in ("stale fresh", "drain ungated", "drain gated") else static_mirror
        for rep in reps:
            if rep[1] == 200:
                a = asked[rep[0]]
                check_reply(rep, mirror.search([(qvec[a["text"]], a["k"], a["filter"])])[0])
    for group in ("warmup", "ungated sequential POST", "ungated sequential GET", "filtered", "ungated concurrent",
                  "gated concurrent", "stale fresh", "drain ungated", "drain gated"):
        check(statuses[group] == {"200": len(replies[group])}, f"{group}: statuses {statuses[group]}")
    for group in ("ungated sequential POST", "ungated sequential GET", "filtered"):
        n = len(replies[group])
        check(ticks[group] == 2 * n, f"{group}: {ticks[group]} ticks for {n} requests, expected an insert "
                                     "and a remove tick each")
    check(set(statuses["overload"]) <= {"200", "429", "503"}, f"overload statuses {statuses['overload']}")
    for rep in replies["overload"]:
        if rep[1] in (429, 503):
            check(float(rep[2]["retry-after"]) >= 0.0 and rep[3]["error"].startswith("request shed"),
                  f"overload shed without Retry-After: {rep}")
    overload_max_s = max(r[5] - r[4] for r in replies["overload"])
    check(overload_max_s < qos.default_deadline_ms / 1000.0, f"an overload reply took {overload_max_s} s")
    check(statuses["deadline"] == {"504": REST_DEADLINE}, f"deadline statuses {statuses['deadline']}")
    check(deadline_searches == (0, 0), f"the expired requests reached a search: {deadline_searches}")
    for rep, ref_matches in live:
        check(rep[1] == 200, f"live request {rep[0]}: status {rep[1]}")
        check_reply(rep, ref_matches)
    for fresh, st in zip(replies["stale fresh"], stale):
        check(st[1] == 200 and st[2].get("x-pathway-stale") == "true", f"stale read {st[:3]}")
        check(same_up_to_near_ties(as_rows(st[3]), as_rows(fresh[3]), F32_TOL),
              f"stale read {st[0]} returned other documents than fresh")
    check(bounded[1] == 503 and bounded[2].get("x-pathway-stale") == "true", f"bounded stale read {bounded[:3]}")
    check(stale_launches == REST_STALE, f"{stale_launches} launches for {REST_STALE} stale reads")
    check(idle_a and idle_b and refused_after == (True, True),
          f"drain: idle {idle_a, idle_b}, refused after {refused_after}")
    stat = stats[3]
    check(stats[1] == 200 and stat["file_count"] == n_static, f"statistics {stats[:2]} {stat}")
    want = {doc_path(i) for i in range(VS_DOCS) if i % VS_GROUPS == 1}
    got_paths = [m["path"] for m in inputs[3]]
    check(inputs[1] == 200 and len(got_paths) == len(set(got_paths)) and set(got_paths) == want,
          f"/v1/inputs under the filter: {len(got_paths)} paths, {len(want)} expected")
    check(schema[1] == 200 and {"/v1/retrieve", "/v1/statistics", "/v1/inputs"} <= set(schema[3]["paths"]),
          "the OpenAPI document misses a route")
    check(all(ex.index is not None and len(ex.index) == len(ix) for ex in execs), "the two indexes differ")
    check(emb.runtime.device.type == "cuda", "the embedder left the card")

    def lat(group: str) -> dict:
        ms = [(r[5] - r[4]) * 1e3 for r in replies[group] if r[1] == 200]
        return {"p50": float(np.percentile(ms, 50)), "p99": float(np.percentile(ms, 99)),
                "max": float(np.max(ms)), "n": len(ms)}

    def rps(group: str) -> float:
        reps = replies[group]
        return len(reps) / (max(r[5] for r in reps) - min(r[4] for r in reps))

    every = [str(r[1]) for reps in replies.values() for r in reps]
    latency = {g: lat(g) for g in replies if any(r[1] == 200 for r in replies[g])}
    latency["live"] = {"p50": float(np.percentile([(r[5] - r[4]) * 1e3 for r, _m in live], 50)),
                       "max": float(max((r[5] - r[4]) * 1e3 for r, _m in live)), "n": len(live)}
    phase = {
        "phase": "rest",
        "nvidia_smi": smi,
        "docs": VS_DOCS,
        "chunks": int(upto[-1]),
        "corpus_capacity": capacity,
        "ingest_s": ingest_s,
        "reply_ms_by_group": latency,
        "requests_per_s_at_16": {"ungated": rps("ungated concurrent"), "gated": rps("gated concurrent")},
        "server_request_p50_ms": {"sequential": server_p50_sequential_ms,
                                  "whole_phase": server_hist.quantile(0.5) * 1e3},
        "http_overhead_p50_ms": latency["ungated sequential POST"]["p50"] - vs_b1_p50_ms,
        "vector_store_b1_reply_p50_ms": vs_b1_p50_ms,
        "update_to_visible_ms": {"p50": float(np.percentile(update_ms, 50)), "max": float(np.max(update_ms)),
                                 "n": len(update_ms)},
        "status_counts": {s: every.count(s) for s in ("429", "503", "504")},
        "statuses_by_group": statuses,
        "overload_max_reply_s": overload_max_s,
        "deadline_expired_by_stage": deadline_expired,
        "deadline_block_topk_launches_and_knn_queries": list(deadline_searches),
        "ticks_per_ungated_request": {g: ticks[g] / len(replies[g]) for g in ticks},
        # the insert and remove ticks of the sequential POSTs, operator by
        # operator (Tick Scope): what the engine spends per request
        "sequential_post_ticks": tick_anatomy(rt, *seq_window),
        "stale_headers": {k: stale[0][2].get(k) for k in ("x-pathway-stale", "x-pathway-staleness-seconds")},
        "replies_checked_by_group": checked,
        "replies_keys_equal_direct_search_by_group": exact,
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "ticks": rt.stats.ticks,
        "operator_s": operator_s(rt),
        "peak_allocated_bytes": peak,
        "stage_s": stage_s,
        "phase_s": time.perf_counter() - t_phase,
    }
    prep, _c2, valid = ix.corpus.prepared_arrays("cosine", bf16=False)
    gated_texts = [asked[r[0]]["text"] for r in replies["gated concurrent"]]
    queries = {b: torch.from_numpy(np.stack([qvec[t] for t in gated_texts[:b]])).to(dev)
               for b in sorted({b for b, _k in shapes})}
    out = {"prep": prep, "valid": valid, "launches": launches, "shapes": shapes, "queries": queries}
    parse_graph.G.clear()
    return phase, out


# --- phase 7: persistence -----------------------------------------------------


def store_docs() -> list[str]:
    """The store phases' documents (the vector store phase's seeded draw)."""
    return synthetic_docs(VS_DOCS + VS_LIVE_TICKS * VS_LIVE_DOCS, np.random.default_rng(SEED + 11))


def doc_file(folder: str, i: int) -> str:
    return os.path.join(folder, str(i % VS_GROUPS), f"{i:06d}.txt")


def write_docs(folder: str, docs: list[str], ids) -> None:
    """Each document as a file, written beside the watched folder and
    renamed into it: the scanner never meets a half-written file."""
    staging = folder + ".staging"
    os.makedirs(staging, exist_ok=True)
    for i in ids:
        path = doc_file(folder, i)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = os.path.join(staging, f"{i:06d}.tmp")
        with open(tmp, "w") as f:
            f.write(docs[i])
        os.replace(tmp, path)


def expected_chunk_keys(folder: str, ids, chunks_of) -> dict[int, str]:
    """The row key of every chunk of documents ``ids`` read from ``folder``
    by pw.io.fs (binary: the key hashes the path), mapped to its text:
    VectorStoreServer's two flattens key chunk j of a document as
    hash(hash(doc key, 0), j)."""
    from pathway_tpu_torch.internals.api import ptr_column, ref_scalar, ref_scalars_columns

    ids = list(ids)
    k0 = np.array([int(ref_scalar(doc_file(folder, i))) for i in ids], dtype=np.uint64)
    k1 = np.asarray(ref_scalars_columns([ptr_column(k0), np.zeros(len(ids), np.int64)], len(ids)),
                    dtype=np.uint64)
    counts = np.array([len(chunks_of[i]) for i in ids])
    idx = np.concatenate([np.arange(c) for c in counts])
    keys = ref_scalars_columns([ptr_column(np.repeat(k1, counts)), idx], int(counts.sum()))
    texts = [c for i in ids for c in chunks_of[i]]
    return dict(zip((int(k) for k in keys), texts))


def persist_graph(folder: str, store: str, emb, subject, dev):
    """The phase's graph, identical in every run over one store (the
    operator snapshot is restored by graph position): pw.io.fs over the
    folder → VectorStoreServer(device) → retrieve_query over the query rows
    of ``subject``. Returns the reply table and the persistence config."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm.parsers import Utf8Parser
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        query: str
        k: int
        metadata_filter: str | None = pw.column_definition(default_value=None, dtype=str)
        filepath_globpattern: str | None = pw.column_definition(default_value=None, dtype=str)

    documents = pw.io.fs.read(folder, format="binary", mode="streaming", with_metadata=True)
    server = VectorStoreServer(
        documents, embedder=emb, parser=Utf8Parser(),
        splitter=TokenCountSplitter(min_tokens=VS_MIN_TOKENS, max_tokens=VS_MAX_TOKENS),
        index_params={"reserved_space": PERSIST_CAPACITY}, device=dev,
    )
    queries = pw.io.python.read(subject, schema=QuerySchema, autocommit_duration_ms=None)
    replied = queries.with_columns(result=server.retrieve_query(queries).with_universe_of(queries).result)
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(store))
    return replied, cfg


def store_index(rt):
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec

    return next(ex.index for ex in rt.execs.values() if isinstance(ex, ExternalIndexExec))


def write_batch_as_one_tick(rt, folder: str, docs: list[str], ids: range) -> None:
    """Write a batch of files with the fs scanner's wake-up held until it
    has queued them all, then wake the engine once: the batch is one tick,
    as a commit of the vector store phase is (the run's autocommit must not
    tick on its own)."""
    sess = next(n.source.session for n in rt.order
                if type(getattr(n, "source", None)).__name__ == "_FsStreamingSource")
    wake, sess._wake = sess._wake, None
    write_docs(folder, docs, ids)
    wait_until(lambda: len(sess._rows) >= len(ids), "the scanner to queue a batch")
    sess._wake = wake
    wake()


def persist_child(folder: str, store: str, progress: str) -> int:
    """The persistence phase's killed run, armed with PATHWAY_FAULTS: the
    documents' files go into the folder batch by batch. The child holds
    the scanner's wake-up until a whole batch is queued, so each batch is
    one tick, and writes the next batch once the index holds this one;
    ``progress`` records the batches indexed. kill=tick:PERSIST_KILL_TICK
    ends the process at the head of a tick: returning (exit code 1) means
    it never fired."""
    t_start, t_wall = time.perf_counter(), time.time()
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    dev = torch.device("cuda", 0)
    docs = store_docs()
    upto = json.loads(Path(progress).read_text())["upto"]  # the parent's split of the documents
    failure: list[BaseException] = []

    class Feeder(pw.io.python.ConnectorSubject):
        def run(self):
            try:
                rt = parse_graph.G.runtime
                ix = store_index(rt)
                done = {"graph_s": time.perf_counter() - t_start, "batch_s": [], "start_wall": t_wall}
                for b in range(PERSIST_DOCS // PERSIST_COMMIT):
                    lo, hi = b * PERSIST_COMMIT, (b + 1) * PERSIST_COMMIT
                    t0 = time.perf_counter()
                    write_batch_as_one_tick(rt, folder, docs, range(lo, hi))
                    t1 = time.perf_counter()
                    wait_until(lambda: len(ix) >= upto[hi - 1] and rt.stats.ticks > b, "a batch's tick")
                    # seconds to write and queue the batch, then to index it
                    done["batch_s"].append([t1 - t0, time.perf_counter() - t1])
                    done.update(batches=b + 1, ticks=rt.stats.ticks, wall=time.time())
                    Path(progress).write_text(json.dumps(done))
            except BaseException as e:  # noqa: BLE001 — reported after pw.run
                failure.append(e)
            finally:
                parse_graph.G.runtime.stop()

    replied, cfg = persist_graph(folder, store, SentenceTransformerEmbedder(device=dev), Feeder(), dev)
    pw.io.subscribe(replied, on_change=lambda **kw: None)
    # the batches are the ticks: no autocommit wakes the loop in between
    pw.run(persistence_config=cfg, autocommit_duration_ms=3_600_000)
    print(f"chip_smoke: the fault never fired ({failure})", file=sys.stderr)
    return 1


def persistence(dev, smi: str, vs_phase: dict, vs_data: dict, corpus: tuple) -> tuple[dict, dict]:
    """Kill and restart of a persisted VectorStoreServer fed by pw.io.fs.
    The first PERSIST_DOCS of the vector store phase's documents go into a
    folder as files, 12 batches of PERSIST_COMMIT. A child (this script with --persist-child) runs
    the graph with PATHWAY_FAULTS=kill=tick:PERSIST_KILL_TICK and must
    exit 23 after batch 9: operator snapshot generation 1 covers batches
    1-8 (snapshot_every 8), the log tail batch 9, batch 10 was drained
    but never logged. Restart 1: a fresh graph over the same store
    restores the snapshot, replays the tail, seeks the scanner past the
    logged files, re-reads batch 10; one query is answered (time to the
    first correct reply), the remaining 2 batches arrive, then PERSIST_B1
    B = 1 and PERSIST_B16_TICKS B = 16 queries (the vector store phase's
    texts copied from those documents) and PERSIST_LIVE_WRITES live writes
    of 64 documents, each followed by a query that must find one at rank 1.
    Restart 2 adds no file: the B = 1 queries again, and no document chunk
    may reach the embedder. Restart 1's replies are held against the
    never-killed run's: the vector store phase's corpus vectors, searched
    over the chunks of the same documents."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.observability.tracing import get_tracer
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    now = time.perf_counter
    t_phase = now()
    docs, chunks_of, upto = corpus
    work = tempfile.mkdtemp(prefix="pw_persist_")
    folder, store, progress = os.path.join(work, "docs"), os.path.join(work, "store"), os.path.join(work, "p.json")
    os.makedirs(folder)
    env = dict(os.environ, PATHWAY_FAULTS=f"kill=tick:{PERSIST_KILL_TICK}")
    Path(progress).write_text(json.dumps({"upto": [int(u) for u in upto[:PERSIST_DOCS]]}))
    log = os.path.join(work, "child.log")
    t0, wall0 = time.perf_counter(), time.time()
    with open(log, "w") as out:
        child = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--persist-child", folder, store,
                                progress], env=env, stdout=out, stderr=subprocess.STDOUT, timeout=900)
    killed_s, wall1 = time.perf_counter() - t0, time.time()
    check(child.returncode == FAULT_EXIT, f"the killed run exited {child.returncode}: {Path(log).read_text()[-3000:]}")
    killed = json.loads(Path(progress).read_text())
    on_disk = sum(len(f) for _r, _d, f in os.walk(folder))
    check(killed["batches"] == PERSIST_KILL_TICK - 1 and killed["ticks"] == PERSIST_KILL_TICK - 1,
          f"the killed run indexed {killed} before the kill at tick {PERSIST_KILL_TICK}")
    want = expected_chunk_keys(folder, range(PERSIST_DOCS), chunks_of)
    check(len(want) == int(upto[PERSIST_DOCS - 1]), "the host's chunk keys collide")
    # the vector store phase's query texts copied from the documents indexed here
    persisted = {c for d in range(PERSIST_DOCS) for c in chunks_of[d]}
    by_text = {g: [x for x in rows if x[0] in persisted] for g, rows in vs_data["replies_by_text"].items()}
    by_text["B=16"] = by_text["B=16"][:16 * PERSIST_B16_TICKS]
    check(len(by_text["B=1"]) >= PERSIST_B1 and len(by_text["B=16"]) == 16 * PERSIST_B16_TICKS,
          f"{len(by_text['B=1'])} B = 1 and {len(by_text['B=16'])} B = 16 texts from the persisted documents")
    b1_texts = by_text["B=1"][:PERSIST_B1]
    # the never-killed run's corpus, restricted to the chunks of those documents
    vs_prep = vs_data["prep"]
    vs_live = vs_data["valid"] & torch.tensor([t in persisted for t in vs_data["slot_texts"]], device=dev)

    def never_killed(qvec: np.ndarray) -> tuple:
        q = torch.tensor(qvec, dtype=torch.float32, device=dev)
        sc = (vs_prep @ (q / q.norm())).masked_fill_(~vs_live, -float("inf"))
        v, ix = torch.topk(sc, K)
        return tuple((vs_data["slot_texts"][j], float(x) - 1.0) for j, x in zip(ix.tolist(), v.double().tolist()))
    tracer = get_tracer()
    check(tracer.enabled, "tracing is off (PATHWAY_TRACING=0): the corpus upload is read from its span")
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()

    wanted = {t for g in by_text.values() for t, _r in g} | {
        chunks_of[VS_DOCS + t * VS_LIVE_DOCS + (t * 7) % VS_LIVE_DOCS][0] for t in range(PERSIST_LIVE_WRITES)}

    def run(restart: int):
        """One restart over the store; returns what the run recorded."""
        parse_graph.G.clear()
        tracer.clear()
        embedded = [0]  # texts through the embedder

        class CountingEmbedder(SentenceTransformerEmbedder):
            """Counts the texts it embeds and keeps the last vector of each
            query text (a query embeds after the chunk it copies)."""

            def embed_batch(self, texts):
                out = super().embed_batch(texts)
                embedded[0] += len(texts)
                for t, v in zip(texts, out):
                    if t in wanted:
                        rec["qvec"][t] = v
                return out

        rec: dict = {"qvec": {}, "replies": {}, "commits": {}, "update_ms": [], "live": []}
        failure: list[BaseException] = []
        n_commits = [0]

        class Feeder(pw.io.python.ConnectorSubject):
            def run(self):
                try:
                    drive(self)
                except BaseException as e:  # noqa: BLE001 — re-raised after pw.run
                    failure.append(e)
                finally:
                    parse_graph.G.runtime.stop()

        def ask(qs, rows: list[tuple[int, str]]) -> None:
            for qid, text in rows:
                qs.next(qid=qid, query=text, k=K, metadata_filter=None, filepath_globpattern=None)
            qs.commit()
            t = time.perf_counter()
            n_commits[0] += 1
            for qid, _t in rows:
                rec["commits"][qid] = t
            wait_until(lambda: all(q in rec["replies"] for q, _t in rows), "a query's reply")

        def drive(qs) -> None:
            rt = parse_graph.G.runtime
            ix = rec["index"] = store_index(rt)
            qid = restart * 1_000_000  # the query log persists too: fresh keys per run
            if restart == 1:
                # the unlogged batch is read again, then the first query
                on_disk_docs = PERSIST_KILL_TICK * PERSIST_COMMIT
                wait_until(lambda: len(ix) >= upto[on_disk_docs - 1], "the re-read of the unlogged batch")
                rec["reread_s"] = time.perf_counter() - rec["t_run"]
                text = by_text["B=1"][0][0]
                ask(qs, [(qid, text)])
                rec["first_upload_ms"] = [sp.duration_ns / 1e6 for sp in tracer.spans()
                                          if sp.name == "knn.corpus_upload"]
                rec["first"] = (qid, text, snapshot_index(ix, dev))
                qid += 1
                t0 = time.perf_counter()
                for lo in range(on_disk_docs, PERSIST_DOCS, PERSIST_COMMIT):
                    write_batch_as_one_tick(rt, folder, docs, range(lo, lo + PERSIST_COMMIT))
                    wait_until(lambda: len(ix) >= upto[lo + PERSIST_COMMIT - 1], "a batch in the index")
                rec["ingest"] = (int(upto[PERSIST_DOCS - 1] - upto[on_disk_docs - 1]), time.perf_counter() - t0)
            rec["keys"] = set(ix.keys())
            groups: dict[str, list] = {}
            rec["groups"], rec["ref"] = groups, {}

            def b1(group: str) -> None:
                nonlocal qid
                groups[group] = []
                for text, _r in b1_texts:
                    ask(qs, [(qid, text)])
                    groups[group].append((qid, text))
                    qid += 1

            def refs(group: str) -> None:
                mirror = snapshot_index(ix, dev)
                rec["ref"].update({q: mirror.search([(rec["qvec"][t], K, None)])[0] for q, t in groups[group]})

            if restart == 1:
                b1("B=1")
                b16 = by_text["B=16"]
                groups["B=16"] = []
                for lo in range(0, len(b16), 16):
                    rows = [(qid + j, b16[lo + j][0]) for j in range(16)]
                    ask(qs, rows)
                    groups["B=16"].extend(rows)
                    qid += 16
                refs("B=1")
                refs("B=16")
                for t in range(PERSIST_LIVE_WRITES):
                    lo = VS_DOCS + t * VS_LIVE_DOCS
                    tc = time.perf_counter()
                    write_docs(folder, docs, range(lo, lo + VS_LIVE_DOCS))
                    # the persisted documents' chunks and the live writes' so far
                    goal = int(upto[PERSIST_DOCS - 1] + upto[lo + VS_LIVE_DOCS - 1] - upto[VS_DOCS - 1])
                    wait_until(lambda: len(ix) >= goal, "a live write")
                    target = lo + (t * 7) % VS_LIVE_DOCS
                    ask(qs, [(qid, chunks_of[target][0])])
                    rec["update_ms"].append((rec["replies"][qid][0] - tc) * 1e3)
                    mirror = snapshot_index(ix, dev)
                    rec["live"].append((qid, target, mirror.search([(rec["qvec"][chunks_of[target][0]], K, None)])[0]))
                    del mirror
                    qid += 1
            # the B = 1 texts over the final corpus: what restart 2 must repeat
            b1("B=1 final")
            refs("B=1 final")

        emb = CountingEmbedder(device=dev)
        replied, cfg = persist_graph(folder, store, emb, Feeder(), dev)

        def on_reply(key, row, time, is_addition):
            if is_addition and row["qid"] not in rec["replies"]:
                rec["replies"][row["qid"]] = (now(), tuple((r["text"], -r["dist"]) for r in row["result"].value))

        pw.io.subscribe(replied, on_change=on_reply)
        rec["t_run"] = time.perf_counter()
        # as in the killed run: only the scanner and the queries wake the engine
        pw.run(persistence_config=cfg, autocommit_duration_ms=3_600_000)  # raises on an operator error
        rec["run_s"] = time.perf_counter() - rec["t_run"]
        if failure:
            raise failure[0]
        rt = parse_graph.G.last_runtime
        # where the run went: inside ticks (Tick Scope), and the snapshots
        # taken after them
        rec["tick_wall_s"] = sum(r.tick_ns for r in rt._tickscope.records()) / 1e9
        rec["recovery"] = rt.persistence_driver
        rec["embedded"] = embedded[0]
        rec["ticks"] = rt.stats.ticks
        return rec

    r1 = run(1)
    r2 = run(2)
    launches, shapes = bt.block_topk.launches, dict(bt.block_topk.shapes)
    peak = torch.cuda.max_memory_allocated()

    # checks
    d1, d2 = r1["recovery"], r2["recovery"]
    check(d1.restored_from_snapshot and d1.replayed_events > 0,
          f"restart 1: restored {d1.restored_from_snapshot}, {d1.replayed_events} events replayed")
    check(d1.replayed_ticks == 1 and d1.replayed_rows == PERSIST_COMMIT,
          f"restart 1 replayed {d1.replayed_ticks} ticks, {d1.replayed_rows} rows: batch 9 expected")
    check(d2.restored_from_snapshot and d2.replayed_events == 0,
          f"restart 2: restored {d2.restored_from_snapshot}, {d2.replayed_events} events replayed")
    text_of = dict(want)
    text_of.update(expected_chunk_keys(folder, range(VS_DOCS, VS_DOCS + PERSIST_LIVE_WRITES * VS_LIVE_DOCS),
                                       chunks_of))
    for r, keys in ((r1, set(want)), (r2, set(text_of))):
        check(r["keys"] == keys, f"the index holds {len(r['keys'])} chunks; "
              f"{len(keys - r['keys'])} missing, {len(r['keys'] - keys)} unexpected")
    check(Counter(want.values()) == Counter(c for d in range(PERSIST_DOCS) for c in chunks_of[d]),
          "the chunk texts differ from the vector store phase's")
    q1, text, mirror = r1["first"]
    got = r1["replies"][q1][1]
    ref = tuple((text_of[k], s) for k, s in mirror.search([(r1["qvec"][text], K, None)])[0])
    check(same_up_to_near_ties(got, ref, F32_TOL), "restart 1's first reply differs from direct search")
    del mirror
    exact, cross = {}, {"compared": 0, "keys_equal": 0, "max_score_diff": 0.0}
    for name, r in (("restart 1", r1), ("restart 2", r2)):
        for g, rows in r["groups"].items():
            for q, t in rows:
                got = r["replies"][q][1]
                ref = tuple((text_of[k], s) for k, s in r["ref"][q])
                check(same_up_to_near_ties(got, ref, F32_TOL), f"{name} {g} query {q}: reply differs from direct search")
                exact[f"{name} {g}"] = exact.get(f"{name} {g}", 0) + ([a for a, _s in got] == [a for a, _s in ref])
                check(got[0][0] == t, f"{name} {g} query {q} did not find its own chunk first: {got[:1]}")
                if g in ("B=1", "B=16") and name == "restart 1":  # the never-killed run's corpus
                    vs = never_killed(r["qvec"][t])
                    check(same_up_to_near_ties(got, vs, CROSS_RUN_TOL),
                          f"{name} {g} query {q}: reply differs from the never-killed run's")
                    cross["compared"] += 1
                    cross["keys_equal"] += [a for a, _s in got] == [a for a, _s in vs]
                    cross["max_score_diff"] = max(cross["max_score_diff"],
                                                  max(abs(a - b) for (_x, a), (_y, b) in zip(got, vs)))
    for (q, t), (q2, t2) in zip(r1["groups"]["B=1 final"], r2["groups"]["B=1 final"]):
        a, b = r1["replies"][q][1], r2["replies"][q2][1]
        check(t == t2 and [x for x, _s in a] == [x for x, _s in b]
              and max(abs(x - y) for (_p, x), (_q, y) in zip(a, b)) <= F32_TOL,
              f"restart 2 answered {t[:40]!r} otherwise than restart 1")
    for q, target, ref_rows in r1["live"]:
        got = r1["replies"][q][1]
        check(got[0][0] == chunks_of[target][0], f"live query {q} missed its new document {target}")
        check(same_up_to_near_ties(got, tuple((text_of[k], s) for k, s in ref_rows), F32_TOL),
              f"live query {q} differs from direct search")
    n_asked2 = len(r2["groups"]["B=1 final"])
    check(r2["embedded"] == n_asked2, f"restart 2 embedded {r2['embedded']} texts for {n_asked2} queries: "
          "a document chunk went through the embedder again")
    want_shapes = {(1, K): 1 + 3 * PERSIST_B1 + PERSIST_LIVE_WRITES, (16, K): PERSIST_B16_TICKS}
    check(shapes == want_shapes, f"block_topk launches by shape {shapes}, searches {want_shapes}")

    def lat(r, rows):
        ms = [(r["replies"][q][0] - r["commits"][q]) * 1e3 for q, _t in rows]
        return {"p50": float(np.percentile(ms, 50)), "max": float(np.max(ms)), "n": len(ms)}

    snaps = d1.snapshots + d2.snapshots
    store_bytes = sum(os.path.getsize(os.path.join(r, f)) for r, _d, fs in os.walk(store) for f in fs)
    first_s = r1["replies"][q1][0] - r1["t_run"]
    ingest_chunks, ingest_s = r1["ingest"]
    phase = {
        "phase": "persistence",
        "nvidia_smi": smi,
        "docs": PERSIST_DOCS,
        "chunks": int(upto[PERSIST_DOCS - 1]),
        "killed_run": {"kill_tick": PERSIST_KILL_TICK, "exit_code": child.returncode,
                       "batches_indexed": killed["batches"], "files_indexed": killed["batches"] * PERSIST_COMMIT,
                       "files_on_disk": on_disk, "s": killed_s, "graph_s": killed["graph_s"],
                       # the child's clock against this one: spawn to its start, last batch to exit
                       "spawn_to_start_s": killed["start_wall"] - wall0, "last_batch_to_exit_s": wall1 - killed["wall"],
                       "batch_write_and_queue_s": [w for w, _i in killed["batch_s"]],
                       "batch_index_s": [i for _w, i in killed["batch_s"]]},
        "restore_s": {"operators": d1.restore_seconds, "log_tail_replay": d1.replay_seconds,
                      "log_tail_ticks": d1.replayed_ticks, "log_tail_rows": d1.replayed_rows,
                      "offset_seek": d1.seek_seconds, "recovery_total": d1.recovery_seconds,
                      "second_restart_operators": d2.restore_seconds},
        "first_correct_reply_s": {"from_restart": first_s, "reread_unlogged_batch_s": r1["reread_s"],
                                  "first_search_corpus_upload_ms": sum(r1["first_upload_ms"])},
        "snapshots": {"n": len(snaps), "ms": [s * 1e3 for s, _b in snaps], "bytes": [b for _s, b in snaps],
                      "ms_p50": float(np.percentile([s * 1e3 for s, _b in snaps], 50)),
                      "bytes_p50": float(np.percentile([b for _s, b in snaps], 50))},
        "store_bytes_on_disk": store_bytes,
        "ingest_chunks_per_s": ingest_chunks / ingest_s,
        "ingest_chunks": ingest_chunks,
        "vector_store_embed_chunks_per_s": vs_phase["embed_chunks_per_s"],
        "update_to_visible_ms": {"p50": float(np.percentile(r1["update_ms"], 50)),
                                 "max": float(np.max(r1["update_ms"])), "n": len(r1["update_ms"])},
        "reply_ms": {f"{name} {g}": lat(r, rows) for name, r in (("restart 1", r1), ("restart 2", r2))
                     for g, rows in r["groups"].items()},
        "replies_keys_equal_direct_search": exact,
        "replies_vs_never_killed_run": cross,
        "cross_run_tol": CROSS_RUN_TOL,
        "second_restart_texts_embedded": r2["embedded"],
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "ticks": {"restart 1": r1["ticks"], "restart 2": r2["ticks"]},
        "run_s": {"restart 1": r1["run_s"], "restart 2": r2["run_s"]},
        "tick_wall_s": {"restart 1": r1["tick_wall_s"], "restart 2": r2["tick_wall_s"]},
        "snapshot_s": {"restart 1": sum(x for x, _b in d1.snapshots), "restart 2": sum(x for x, _b in d2.snapshots)},
        "peak_allocated_bytes": peak,
        "phase_s": time.perf_counter() - t_phase,
    }
    prep, _c2, valid = r2["index"].corpus.prepared_arrays("cosine", bf16=False)
    q16 = [r1["qvec"][t] for _q, t in r1["groups"]["B=16"][:16]]
    out = {"prep": prep, "valid": valid, "launches": launches, "shapes": shapes,
           "queries": {1: torch.from_numpy(np.stack(q16[:1])).to(dev), 16: torch.from_numpy(np.stack(q16)).to(dev)}}
    parse_graph.G.clear()
    shutil.rmtree(work, ignore_errors=True)
    return phase, out


# --- phase 8: index kinds -----------------------------------------------------


def bm25_tokens(text: str) -> list[str]:
    return [w.lower() for w in re.findall(r"\w+", str(text), re.UNICODE)]


class DirectBm25:
    """The reference's BM25 (``_index_impls.py`` ``Bm25Index.search``,
    k1 1.2, b 0.75) written out over the chunk texts, fed in the index's
    insertion order so that equal scores rank in the same order."""

    def __init__(self):
        self.postings: dict[str, dict[int, int]] = {}
        self.doc_len: dict[int, int] = {}

    def add(self, key: int, text: str) -> None:
        toks = bm25_tokens(text)
        tf: dict[str, int] = {}
        for t in toks:
            tf[t] = tf.get(t, 0) + 1
        self.doc_len[key] = len(toks)
        for t, c in tf.items():
            self.postings.setdefault(t, {})[key] = c

    def search(self, query: str, k: int) -> list[tuple[int, float]]:
        k1, b, n = 1.2, 0.75, len(self.doc_len)
        avg = sum(self.doc_len.values()) / n
        scores: dict[int, float] = {}
        for t in bm25_tokens(query):
            plist = self.postings.get(t)
            if not plist:
                continue
            idf = math.log(1 + (n - len(plist) + 0.5) / (len(plist) + 0.5))
            for doc, tf in plist.items():
                dl = self.doc_len[doc] or 1
                scores[doc] = scores.get(doc, 0.0) + idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avg))
        return sorted(scores.items(), key=lambda kv: -kv[1])[:k]


def rrf_scores(replies: list[list[tuple[int, float]]]) -> dict[int, float]:
    """Reciprocal-rank fusion, k = 60, replies in the inner indexes' order."""
    fused: dict[int, float] = {}
    for reply in replies:
        for rank, (key, _s) in enumerate(reply):
            fused[key] = fused.get(key, 0.0) + 1.0 / (RRF_K + rank + 1)
    return fused


def check_fused(got: list[tuple[int, float]], bm: list, dense: list, dense_score, what: str) -> bool:
    """A hybrid reply against BM25 (exact) and the direct dense search:
    ranked by fused score, the same documents at each fused score. Where the
    dense side met a near tie, its ranks are read back from the fused
    scores (fused - the BM25 part = 1 / (61 + dense rank)) and held against
    the direct search up to near ties. Returns whether it was exact."""
    check(all(a[1] >= b[1] for a, b in zip(got, got[1:])), f"{what}: not ranked by fused score")
    want = rrf_scores([bm, dense])
    if dict(got) == want and len(got) == len(want):
        return True
    bpart = {key: 1.0 / (RRF_K + r + 1) for r, (key, _s) in enumerate(bm)}
    check(set(bpart) <= {key for key, _f in got}, f"{what}: a BM25 match is missing")
    ranks = {}
    for key, f in got:
        x = f - bpart.get(key, 0.0)
        if x > 1e-12:
            r = round(1.0 / x - RRF_K - 1)
            check(abs(1.0 / (RRF_K + r + 1) - x) < 1e-12 and r not in ranks, f"{what}: fused score {f} of {key}")
            ranks[r] = key
    check(sorted(ranks) == list(range(len(dense))), f"{what}: dense ranks {sorted(ranks)}")
    got_dense = tuple((ranks[r], dense_score(ranks[r])) for r in range(len(dense)))
    check(same_up_to_near_ties(got_dense, tuple(dense), F32_TOL), f"{what}: dense side differs from direct search")
    return False


def hybrid_store(dev) -> tuple[dict, dict]:
    """(a) DocumentStore over HybridIndexFactory([TantivyBM25Factory(),
    BruteForceKnnFactory(the full-width embedder)]): the first
    IK_HYBRID_DOCS of the vector store phase's documents in commits of
    2048, queries at B = 1 and B = 16, live writes each followed by a query
    for one of their documents."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.stdlib.indexing import (
        BruteForceKnnFactory,
        HybridIndexFactory,
        TantivyBM25Factory,
        hybrid_index,
    )
    from pathway_tpu_torch.stdlib.indexing._index_impls import Bm25Index, TpuDenseKnnIndex
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder
    from pathway_tpu_torch.xpacks.llm.parsers import Utf8Parser
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    docs = store_docs()
    splitter = TokenCountSplitter(min_tokens=VS_MIN_TOKENS, max_tokens=VS_MAX_TOKENS)
    chunks_of = [[c for c, _m in splitter.split(d)] for d in docs]
    upto = np.cumsum([len(c) for c in chunks_of])
    capacity = -(-int(upto[-1]) // 1024) * 1024  # the vector store phase's

    def chunks_through(i: int) -> int:
        """Chunks the store holds once document i is in: the first
        IK_HYBRID_DOCS documents, then the live writes' (ids from VS_DOCS)."""
        if i < VS_DOCS:
            return int(upto[i])
        return int(upto[IK_HYBRID_DOCS - 1] + upto[i] - upto[VS_DOCS - 1])

    rng = np.random.default_rng(SEED + 13)
    qdocs = [int(d) for d in rng.choice(IK_HYBRID_DOCS, size=IK_B1 + 16 * IK_B16, replace=False)]
    live_targets = [VS_DOCS + t * VS_LIVE_DOCS + (t * 7) % VS_LIVE_DOCS for t in range(IK_LIVE_WRITES)]
    wanted = {chunks_of[d][0] for d in qdocs + live_targets}

    parse_graph.G.clear()
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    qvec: dict[str, np.ndarray] = {}
    bm25_calls: list[tuple[int, float]] = []
    rrf_us: list[float] = []

    class RecordingEmbedder(SentenceTransformerEmbedder):
        def embed_batch(self, texts):
            out = super().embed_batch(texts)
            for t, v in zip(texts, out):
                if t in wanted:
                    qvec[t] = v
            return out

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        data: bytes
        _metadata: pw.Json

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        query: str
        k: int
        metadata_filter: str | None = pw.column_definition(default_value=None, dtype=str)
        filepath_globpattern: str | None = pw.column_definition(default_value=None, dtype=str)

    Idle, feeder, failure = driven_subjects(pw, lambda qs: drive(qs))
    emb = RecordingEmbedder(device=dev)  # full width, bf16, seeded
    doc_subject = Idle()
    documents = pw.io.python.read(doc_subject, schema=DocSchema, autocommit_duration_ms=None)
    store = DocumentStore(
        documents,
        retriever_factory=HybridIndexFactory([
            TantivyBM25Factory(),
            BruteForceKnnFactory(embedder=emb, reserved_space=capacity, device=dev),
        ]),
        parser=Utf8Parser(),
        splitter=splitter,
    )
    queries = pw.io.python.read(feeder, schema=QuerySchema, autocommit_duration_ms=None)
    replied = queries.with_columns(result=store.retrieve_query(queries).with_universe_of(queries).result)
    _now = time.perf_counter
    replies: dict[int, tuple[float, list]] = {}
    # a chunk is named by its document's path and its text: a one-word
    # tail chunk may repeat in another document
    text_of: dict[int, str] = {}
    path_of: dict[int, str] = {}

    def on_reply(key, row, time, is_addition):
        if is_addition and row["qid"] not in replies:
            replies[row["qid"]] = (_now(), row["result"].value)

    def on_chunk(key, row, time, is_addition):
        if is_addition:
            text_of[int(key)] = row["text"]
            path_of[int(key)] = row["metadata"].value["path"]

    pw.io.subscribe(replied, on_change=on_reply)
    pw.io.subscribe(store._graph["chunked_docs"], on_change=on_chunk)
    commits: dict[int, float] = {}
    n_commits = [0]
    record: dict = {"update_ms": [], "live": []}
    stamps: dict[str, float] = {}
    fuse = hybrid_index.rrf

    def timed_rrf(replies_, k):
        t0 = _now()
        out = fuse(replies_, k)
        rrf_us.append((_now() - t0) * 1e6)
        return out

    def commit(subject, cond, what: str) -> float:
        return commit_tick(subject, cond, what, n_commits)

    def ask(qs, rows: list[tuple[int, str]]) -> None:
        for qid, text in rows:
            qs.next(qid=qid, query=text, k=K, metadata_filter=None, filepath_globpattern=None)
        t = commit(qs, lambda: all(q in replies for q, _t in rows), "a hybrid reply")
        for q, _t in rows:
            commits[q] = t

    def dense_expected(dense_ix, rows) -> dict:
        """The direct dense search (kernel="torch") of each query on a copy
        of the store's dense index, and a scorer of any of its rows."""
        mirror = snapshot_index(dense_ix, dev)
        host, slot_of = mirror.corpus.host, mirror.corpus.slot_of
        out = {}
        for q, d in rows:
            text = chunks_of[d][0]
            qn = qvec[text] / np.linalg.norm(qvec[text])

            def dense_score(key, qn=qn):
                v = host[slot_of[key]]
                return float(np.dot(qn, v / np.linalg.norm(v))) - 1.0

            out[q] = (list(mirror.search([(qvec[text], K, None)])[0]), dense_score)
        return out

    def drive(qs) -> None:
        rt = parse_graph.G.runtime
        execs = [ex for ex in rt.execs.values() if isinstance(ex, ExternalIndexExec)]
        bm25 = next(ex.index for ex in execs if isinstance(ex.index, Bm25Index))
        dense_ix = next(ex.index for ex in execs if isinstance(ex.index, TpuDenseKnnIndex))
        search = bm25.search

        def timed_search(qs_):
            t0 = _now()
            out = search(qs_)
            bm25_calls.append((len(qs_), (_now() - t0) * 1e3))
            return out

        bm25.search = timed_search
        stamps["ingest0"] = _now()
        for lo in range(0, IK_HYBRID_DOCS, VS_COMMIT):
            for i in range(lo, lo + VS_COMMIT):
                doc_subject.next(doc_id=i, data=docs[i].encode(), _metadata={"path": doc_path(i)})
            commit(doc_subject, lambda: len(dense_ix) >= upto[lo + VS_COMMIT - 1]
                   and len(bm25.docs) >= upto[lo + VS_COMMIT - 1], "a document commit")
        stamps["ingest1"] = _now()
        qid, it = 0, iter(qdocs)
        groups: dict[str, list] = {"B=1": [], "B=16": []}
        for _ in range(IK_B1):
            d = next(it)
            ask(qs, [(qid, chunks_of[d][0])])
            groups["B=1"].append((qid, d))
            qid += 1
        for _ in range(IK_B16):
            rows = [(qid + j, next(it)) for j in range(16)]
            ask(qs, [(q, chunks_of[d][0]) for q, d in rows])
            groups["B=16"].extend(rows)
            qid += 16
        record["groups"] = groups
        # the BM25 side is computed after the run, over the index's first n
        # documents in its insertion order (documents are only added here)
        record["static_ref"] = (len(bm25.docs), dense_expected(dense_ix, [r for g in groups.values() for r in g]))
        for t in range(IK_LIVE_WRITES):
            lo = VS_DOCS + t * VS_LIVE_DOCS
            for i in range(lo, lo + VS_LIVE_DOCS):
                doc_subject.next(doc_id=i, data=docs[i].encode(), _metadata={"path": doc_path(i)})
            tc = commit(doc_subject, lambda: len(dense_ix) >= chunks_through(lo + VS_LIVE_DOCS - 1), "a live write")
            ask(qs, [(qid, chunks_of[live_targets[t]][0])])
            record["update_ms"].append((replies[qid][0] - tc) * 1e3)
            record["live"].append((qid, live_targets[t], len(bm25.docs),
                                   dense_expected(dense_ix, [(qid, live_targets[t])])[qid]))
            qid += 1
        stamps["queries"] = qid
        record["bm25_order"] = list(bm25.docs)
        record["prep"] = dense_ix.corpus.prepared_arrays("cosine", bf16=False)

    hybrid_index.rrf = timed_rrf
    t_run = _now()
    try:
        pw.run()
    finally:
        hybrid_index.rrf = fuse
    run_s = _now() - t_run
    if failure:
        raise failure[0]
    launches, shapes = bt.block_topk.launches, dict(bt.block_topk.shapes)
    rt = parse_graph.G.last_runtime
    n_chunks = chunks_through(VS_DOCS + IK_LIVE_WRITES * VS_LIVE_DOCS - 1)
    check(len(text_of) == n_chunks, f"{len(text_of)} chunks indexed, {n_chunks} expected")
    key_of = {(path_of[k], t): k for k, t in text_of.items()}
    check(len(key_of) == len(text_of), "two chunks of one document share a text: replies cannot name them")
    first_chunk = lambda d: key_of[(doc_path(d), chunks_of[d][0])]  # noqa: E731
    check(sorted(replies) == list(range(stamps["queries"])), "a hybrid query is missing from the replies")
    direct, order = DirectBm25(), record["bm25_order"]

    def bm25_at(n: int, text: str) -> list:
        for key in order[len(direct.doc_len):n]:
            direct.add(key, text_of[key])
        return direct.search(text, K)

    t0 = _now()
    exact = {"B=1": 0, "B=16": 0, "live": 0}
    n_static, static_dense = record["static_ref"]
    for group, rows in record["groups"].items():
        for q, d in rows:
            got = [(key_of[(r["metadata"]["path"], r["text"])], r["score"]) for r in replies[q][1]]
            dense, dense_score = static_dense[q]
            exact[group] += check_fused(got, bm25_at(n_static, chunks_of[d][0]), dense, dense_score,
                                        f"hybrid {group} query {q}")
            check(got[0][0] == first_chunk(d), f"hybrid query {q} did not find its own chunk first")
    for q, target, n_docs, (dense, dense_score) in record["live"]:
        got = [(key_of[(r["metadata"]["path"], r["text"])], r["score"]) for r in replies[q][1]]
        check(got[0][0] == first_chunk(target), f"live hybrid query {q} missed its new document")
        exact["live"] += check_fused(got, bm25_at(n_docs, chunks_of[target][0]), dense, dense_score,
                                     f"live hybrid query {q}")
    direct_s = _now() - t0
    want_shapes = {(1, K): IK_B1 + IK_LIVE_WRITES, (16, K): IK_B16}
    check(shapes == want_shapes, f"hybrid block_topk launches by shape {shapes}, searches {want_shapes}")
    check(rt.stats.ticks == n_commits[0] + 1, f"{rt.stats.ticks} ticks for {n_commits[0]} commits")

    def lat(rows):
        ms = [(replies[q][0] - commits[q]) * 1e3 for q, *_r in rows]
        return {"p50": float(np.percentile(ms, 50)), "max": float(np.max(ms)), "n": len(ms)}

    ingest_s = stamps["ingest1"] - stamps["ingest0"]
    per_query = [ms / n for n, ms in bm25_calls]
    phase = {
        "chunks": n_chunks,
        "corpus_capacity": capacity,
        "ingest_s": ingest_s,
        "ingest_chunks_per_s": int(upto[IK_HYBRID_DOCS - 1]) / ingest_s,
        "docs": IK_HYBRID_DOCS,
        "reply_ms": {g: lat(rows) for g, rows in record["groups"].items()},
        "update_to_visible_ms": {"p50": float(np.percentile(record["update_ms"], 50)),
                                 "max": float(np.max(record["update_ms"])), "n": len(record["update_ms"])},
        "bm25_search_ms_per_query": {"p50": float(np.percentile(per_query, 50)), "max": float(np.max(per_query)),
                                     "calls": len(bm25_calls)},
        "rrf_fusion_us_per_tick": {"p50": float(np.percentile(rrf_us, 50)), "max": float(np.max(rrf_us)),
                                   "n": len(rrf_us)},
        "direct_check_s": direct_s,
        "replies_exact": exact,
        "replies_compared": sum(len(r) for r in record["groups"].values()) + len(record["live"]),
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "ticks": rt.stats.ticks,
        "run_s": run_s,
    }
    prep, _c2, valid = record["prep"]
    groups = record["groups"]

    def batch(rows):
        return torch.from_numpy(np.stack([qvec[chunks_of[d][0]] for _q, d in rows])).to(dev)

    out = {"prep": prep, "valid": valid, "launches": launches, "shapes": shapes,
           "queries": {1: batch(groups["B=1"][:1]), 16: batch(groups["B=16"][:16])}}
    parse_graph.G.clear()
    return phase, out


def ivf_mixture() -> dict:
    """bench.py's accelerator IVF corpus (``_bench_ivf``): 2000 centres,
    noise 0.35, ``default_rng(7)``, 1M x 384 f32, its 50 queries; then the
    engine part's queries from the same stream."""
    rng = np.random.default_rng(7)
    n = IK_IVF_ROWS
    centers = rng.normal(size=(IK_IVF_CENTRES, DIM)).astype(np.float32)
    asn = rng.integers(0, len(centers), size=n)
    corpus = (centers[asn] + 0.35 * rng.normal(size=(n, DIM))).astype(np.float32)
    dq = corpus[rng.choice(n, IK_IVF_DEVICE_QUERIES)] + 0.1 * rng.normal(
        size=(IK_IVF_DEVICE_QUERIES, DIM)).astype(np.float32)
    n_eng = IK_B1 + 16 * IK_B16
    eq = corpus[rng.choice(n, n_eng)] + 0.1 * rng.normal(size=(n_eng, DIM)).astype(np.float32)
    return {"corpus": corpus, "device_queries": dq, "engine_queries": eq}


def exact_top10(dev, corpus: np.ndarray, queries: np.ndarray) -> tuple[np.ndarray, dict]:
    """The exact cosine top-10 row ids of every query over the whole corpus,
    by the block top-k kernel in batches of 16 (the corpus padded to whole
    blocks with invalid rows)."""
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.knn import BLK, _normalize

    n = corpus.shape[0]
    pad = -(-n // BLK) * BLK
    prep = torch.zeros(pad, DIM, device=dev)
    prep[:n] = _normalize(torch.from_numpy(corpus).to(dev))
    valid = torch.zeros(pad, dtype=torch.bool, device=dev)
    valid[:n] = True
    before = bt.block_topk.launches, bt.block_topk.shapes.copy()
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    ids = []
    for lo in range(0, len(queries), 16):
        q = queries[lo:lo + 16]
        q = np.concatenate([q, np.repeat(q[:1], 16 - len(q), axis=0)])
        _s, ix = bt.dense_topk_kernel(torch.from_numpy(q).to(dev), prep, valid, K, metric="cosine")
        ids.append(ix[: min(16, len(queries) - lo)].cpu().numpy())
    gt = {"prep": prep, "valid": valid, "launches": bt.block_topk.launches,
          "shapes": dict(bt.block_topk.shapes), "queries": {16: torch.from_numpy(queries[:16]).to(dev)}}
    bt.block_topk.launches, bt.block_topk.shapes = before
    return np.concatenate(ids), gt


def driven_subjects(pw, drive):
    """The connector subjects of a phase: an ``Idle`` class (its subjects
    are fed from the driving thread and end with it) and the subject that
    runs ``drive(subject)``. An exception in ``drive`` lands in ``failure``,
    to be raised after ``pw.run``."""
    finished = threading.Event()
    failure: list[BaseException] = []

    class Idle(pw.io.python.ConnectorSubject):
        def run(self):
            finished.wait()

    class Feeder(pw.io.python.ConnectorSubject):
        def run(self):
            try:
                drive(self)
            except BaseException as e:  # noqa: BLE001 — re-raised after pw.run
                failure.append(e)
            finally:
                finished.set()

    return Idle, Feeder(), failure


def commit_tick(subject, cond, what: str, n_commits: list) -> float:
    """Hand the subject's rows to the engine (one tick), then wait until
    cond() holds and that tick has ended; returns the commit's time."""
    from pathway_tpu_torch.internals import parse_graph

    subject.commit()
    t = time.perf_counter()
    n_commits[0] += 1
    goal, rt = n_commits[0], parse_graph.G.runtime
    wait_until(lambda: cond() and rt.stats.ticks >= goal, what)
    return t


def vector_index_run(make_inner, rows: np.ndarray, commit_rows: int, queries: np.ndarray,
                     batches: list[int], instrument) -> dict:
    """DataIndex over ``make_inner(vecs.vec)`` through the engine: ``rows``
    through pw.io.python in commits of ``commit_rows`` (a tick each), then
    ``queries`` in ticks of the sizes in ``batches`` (k = 10).
    ``instrument(index)`` runs before the first row. Returns the index
    object, each query's reply (data row ids, keys, scores) and
    commit-to-reply ms, the ingest seconds, ticks and run seconds."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.stdlib.indexing import DataIndex

    parse_graph.G.clear()

    class VecSchema(pw.Schema):
        vid: int = pw.column_definition(primary_key=True)
        vec: np.ndarray

    class QSchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        qv: np.ndarray

    _now = time.perf_counter
    replies: dict[int, tuple] = {}
    out: dict = {"replies": replies, "reply_ms": {}}
    n_commits = [0]

    def drive(qs) -> None:
        rt = parse_graph.G.runtime
        ix = out["index"] = next(ex.index for ex in rt.execs.values() if isinstance(ex, ExternalIndexExec))
        instrument(ix)
        t0 = _now()
        for lo in range(0, len(rows), commit_rows):
            for j in range(lo, min(lo + commit_rows, len(rows))):
                vec_subject.next(vid=j, vec=rows[j])
            commit_tick(vec_subject, lambda: True, "a vector commit", n_commits)
        out["ingest_s"] = _now() - t0
        qid = 0
        for b in batches:
            tick = list(range(qid, qid + b))
            for q in tick:
                qs.next(qid=q, qv=queries[q])
            t = commit_tick(qs, lambda: all(q in replies for q in tick), "a query's reply", n_commits)
            for q in tick:
                out["reply_ms"][q] = (replies[q][0] - t) * 1e3
            qid += b

    Idle, feeder, failure = driven_subjects(pw, drive)
    vec_subject = Idle()
    vecs = pw.io.python.read(vec_subject, schema=VecSchema, autocommit_duration_ms=None)
    qs_table = pw.io.python.read(feeder, schema=QSchema, autocommit_duration_ms=None)
    res = DataIndex(vecs, make_inner(vecs.vec)).query_as_of_now(qs_table.qv, number_of_matches=K).select(
        qid=pw.left.qid, vids=pw.right.vid, ids=pw.right._pw_index_reply_id,
        scores=pw.right._pw_index_reply_score)

    def on_reply(key, row, time, is_addition):
        if is_addition and row["qid"] not in replies:
            replies[row["qid"]] = (_now(), row["vids"], row["ids"], row["scores"])

    pw.io.subscribe(res, on_change=on_reply)
    t_run = _now()
    pw.run()
    out["run_s"] = _now() - t_run
    if failure:
        raise failure[0]
    out["replies"] = {q: r[1:] for q, r in replies.items()}
    out["ticks"] = parse_graph.G.last_runtime.stats.ticks
    check(out["ticks"] == n_commits[0] + 1, f"{out['ticks']} ticks for {n_commits[0]} commits")
    parse_graph.G.clear()
    return out


def timed(obj, name: str, into: list, scale: float = 1.0) -> None:
    """Wrap the method ``name`` of ``obj`` to append each call's seconds x
    ``scale`` to ``into``."""
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        result = fn(*a, **kw)
        into.append((time.perf_counter() - t0) * scale)
        return result

    setattr(obj, name, wrapper)


def ivf_engine(dev, mix: dict, truth: np.ndarray) -> dict:
    """(b) DataIndex over IvfKnn(device="cuda") through the engine: the
    mixture's first IK_IVF_ENGINE_ROWS rows in commits of 65,536 via
    pw.io.python, then IK_B1
    B = 1 and IK_B16 B = 16 queries (the index trains once, at the first); checked
    against numpy and the exact top-10."""
    from pathway_tpu_torch.stdlib.indexing import IvfKnn

    corpus, eq = mix["corpus"][:IK_IVF_ENGINE_ROWS], mix["engine_queries"]
    n = corpus.shape[0]
    timing: dict[str, list] = {"train_s": [], "assign_s": [], "score_ms": []}

    def instrument(ix) -> None:
        train = ix._maybe_train

        def maybe_train():  # times the calls that train, not the ones that return early
            before, t0 = ix.centroids, time.perf_counter()
            train()
            if ix.centroids is not before:
                timing["train_s"].append(time.perf_counter() - t0)

        ix._maybe_train = maybe_train
        timed(ix, "_flush_assign", timing["assign_s"])
        timed(ix, "_score", timing["score_ms"], 1e3)

    run = vector_index_run(lambda col: IvfKnn(col, dimensions=DIM, device=dev), corpus, IK_IVF_COMMIT, eq,
                           [1] * IK_B1 + [16] * IK_B16, instrument)
    ix, replies = run["index"], run["replies"]
    check(len(timing["train_s"]) == 1 and ix._trained_size == n, f"IVF trained {len(timing['train_s'])} times")
    c = ix.centroids
    n_clusters = max(8, int(round(math.sqrt(n) / 8)) * 8)  # the defaults: 1000 clusters, 32 probes at 1M
    n_probe = max(1, int(round(math.sqrt(n_clusters))))
    check(c.shape == (n_clusters, DIM), f"IVF centroids {c.shape}")
    c2 = np.sum(c * c, axis=1)
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    hits, score_err = 0, 0.0
    for q in range(len(eq)):
        vids, ids, scores = replies[q]
        check(len(vids) == K, f"IVF query {q} returned {len(vids)} of {K}")
        check(all(a >= b for a, b in zip(scores, scores[1:])), f"IVF query {q}: not in descending order")
        qn = eq[q] / np.linalg.norm(eq[q])
        want = cn[list(vids)].astype(np.float64) @ qn.astype(np.float64) - 1.0
        score_err = max(score_err, float(np.max(np.abs(want - np.asarray(scores)))))
        d = c2 - 2.0 * (qn.astype(np.float32)[None, :] @ c.T)[0]
        probes = set(np.argpartition(d, n_probe - 1)[:n_probe].tolist())
        check(all(ix.key_cluster[int(k)] in probes for k in ids), f"IVF query {q}: a key outside its probes")
        hits += len(set(int(v) for v in vids) & set(truth[q].tolist()))
    check(score_err <= IK_SCORE_TOL, f"IVF scores differ from numpy's cosine - 1 by {score_err}")
    recall = hits / (len(eq) * K)
    check(recall >= IK_RECALL, f"IVF recall@10 {recall} through the engine")

    def lat(qids):
        ms = [run["reply_ms"][q] for q in qids]
        return {"p50": float(np.percentile(ms, 50)), "max": float(np.max(ms)), "n": len(ms)}

    out = {
        "rows": n, "clusters": int(c.shape[0]), "n_probe": n_probe,
        "ingest_s": run["ingest_s"], "ingest_rows_per_s": n / run["ingest_s"],
        "train_s": timing["train_s"][0],
        "assign_s": max(timing["assign_s"]),  # the flush of every key after training
        "first_reply_ms": run["reply_ms"][0],
        "reply_ms": {"B=1": lat(range(1, IK_B1)), "B=16": lat(range(IK_B1, len(eq)))},
        "host_score_ms_per_query": {"p50": float(np.percentile(timing["score_ms"], 50)),
                                    "max": float(np.max(timing["score_ms"]))},
        "recall_at_10": recall, "max_score_err": score_err, "ticks": run["ticks"], "run_s": run["run_s"],
    }
    return out


def ivf_device(dev, mix: dict, truth: np.ndarray) -> tuple[dict, object]:
    """(c) IvfDeviceIndex at bench.py's accelerator shape: 1M x 384,
    n_probe None, spill 2, its 50 queries."""
    from pathway_tpu_torch.ops.ivf import IvfDeviceIndex

    corpus, dq = mix["corpus"], mix["device_queries"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ix = IvfDeviceIndex(corpus, n_probe=None, spill=2, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ix.query(dq[0], K)  # warm-up
    lat, hits = [], 0
    for i, q in enumerate(dq):
        t0 = time.perf_counter()
        _s, ids = ix.query(q, K)
        lat.append((time.perf_counter() - t0) * 1e3)
        check(len(ids) == K and len(set(ids.tolist())) == K, f"IvfDeviceIndex query {i}: {len(ids)} ids, duplicates")
        hits += len(set(ids.tolist()) & set(truth[i].tolist()))
    recall = hits / (len(dq) * K)
    check(recall >= IK_RECALL, f"IvfDeviceIndex recall@10 {recall}")
    out = {"rows": corpus.shape[0], "clusters": ix.n_clusters, "n_probe": ix.n_probe, "spill": ix.spill,
           "corpus_bytes_on_device": ix.corpus_dev.numel() * 4, "build_s": build_s,
           "query_ms": {"p50": float(np.percentile(lat, 50)), "max": float(np.max(lat)), "n": len(lat)},
           "recall_at_10": recall}
    return out, ix


def lsh_index(dev, mix: dict) -> tuple[dict, object]:
    """(d) DataIndex over LshKnn(dimensions=384, device="cuda") at the
    reference defaults over the mixture's first IK_LSH_ROWS rows (one commit),
    then 16 queries at B = 1, each near one of those rows."""
    from pathway_tpu_torch.ops.lsh import lsh_buckets
    from pathway_tpu_torch.stdlib.indexing import LshKnn

    rows = mix["corpus"][:IK_LSH_ROWS]
    # queries near rows of the indexed part: a row plus the mixture's 0.1 query noise
    rng = np.random.default_rng(SEED + 19)
    eq = rows[rng.choice(IK_LSH_ROWS, IK_LSH_QUERIES)] + 0.1 * rng.normal(size=(IK_LSH_QUERIES, DIM)).astype(np.float32)
    upsert_s: list[float] = []
    run = vector_index_run(lambda col: LshKnn(col, dimensions=DIM, device=dev), rows, IK_LSH_ROWS, eq,
                           [1] * IK_LSH_QUERIES, lambda ix: timed(ix, "upsert", upsert_s))
    ix, replies = run["index"], run["replies"]
    # the card's bucket ids (the index's tables) against the port's plain
    # CPU computation; a row may differ only where its projection is within
    # LSH_EDGE x bucket_length of a cell edge (f32 sums in another order)
    keys = list(ix.vectors)
    card = {key: [0] * ix.n_or for key in keys}
    for t, table in enumerate(ix.buckets):
        for b, members in table.items():
            for key in members:
                card[key][t] = b
    x = torch.from_numpy(np.stack([ix.vectors[k] for k in keys]))
    planes, offsets = ix.planes.cpu(), ix.offsets.cpu()
    cpu = lsh_buckets(x, planes, offsets, ix.bucket_length).numpy()
    cells = (torch.einsum("nd,oad->noa", x, planes) + offsets[None]) / ix.bucket_length
    edge = ((cells - torch.round(cells)).abs() < LSH_EDGE).flatten(1).any(dim=1).numpy()
    differ = np.array([card[k] != cpu[i].tolist() for i, k in enumerate(keys)])
    check(not (differ & ~edge).any(), f"{int((differ & ~edge).sum())} LSH rows hash otherwise away from an edge")
    # replies: each key shares a bucket with its query, each score is -|q - v|^2
    score_err = 0.0
    for q in range(IK_LSH_QUERIES):
        vids, ids, scores = replies[q]
        qb = ix._bucket_ids(eq[q][None])[0]
        check(len(ids) > 0, f"LSH query {q} found no candidate")
        for key, vid, s in zip(ids, vids, scores):
            check(any(int(key) in ix.buckets[t].get(int(b), ()) for t, b in enumerate(qb)),
                  f"LSH query {q}: key {key} shares no bucket with the query")
            want = -float(np.sum((eq[q].astype(np.float64) - rows[vid]) ** 2))
            score_err = max(score_err, abs(want - s) / abs(want))
        check(all(a >= b for a, b in zip(scores, scores[1:])), f"LSH query {q}: not in descending order")
    check(score_err <= IK_SCORE_TOL, f"LSH scores differ from -|q - v|^2 by {score_err} (relative)")
    return {"rows": IK_LSH_ROWS, "n_or": ix.n_or, "n_and": int(ix.planes.shape[1]),
            "bucket_length": ix.bucket_length, "ingest_s": run["ingest_s"],
            "upsert_us_per_row": sum(upsert_s) / IK_LSH_ROWS * 1e6,
            "bucket_rows_differ_from_cpu": int(differ.sum()), "bucket_rows_near_an_edge": int(edge.sum()),
            "queries": IK_LSH_QUERIES, "matches": sum(len(r[0]) for r in replies.values()),
            "max_score_rel_err": score_err}, ix


def op_row(name: str, shape: str, ms: float, nbytes: float, ops: float, rate: float) -> dict:
    t_bytes = nbytes / rate * 1e3
    t_ops = ops / PEAK_OPS_PER_S["float32"] * 1e3
    return {"op": name, "shape": shape, "ms": ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes, "ops": ops}


def device_ops(dev, mix: dict, ivf_ix, lsh_ix, rate: float) -> tuple[list[dict], dict]:
    """The plain-torch device ops under the index kinds (not TPU kernels):
    time per call against its bound, and the segment ops against numpy on
    1,048,576 values into 4096 segments (some empty, a few ids out of
    range), f32 and int32."""
    from pathway_tpu_torch.ops import segment as seg
    from pathway_tpu_torch.ops.ivf import _assign_impl
    from pathway_tpu_torch.ops.lsh import lsh_buckets

    rows = []
    x = torch.from_numpy(mix["corpus"][:262_144]).to(dev)
    c = ivf_ix.cent_dev
    n, cl = x.shape[0], c.shape[0]
    rows.append(op_row("ivf._assign_impl", f"[{n}, {DIM}] x [{cl}, {DIM}]", cuda_ms(lambda: _assign_impl(x, c), 5),
                       (n + cl) * DIM * 4 + n * 8, 2.0 * n * cl * DIM, rate))
    del x
    bucket = 1 << 15
    idx = torch.randint(0, ivf_ix.corpus_dev.shape[0], (bucket,), device=dev)
    valid = torch.ones(bucket, dtype=torch.bool, device=dev)
    q = torch.from_numpy(mix["device_queries"][0]).to(dev)
    rows.append(op_row("IvfDeviceIndex._fine", f"bucket {bucket}, D {DIM}, k {K}",
                       cuda_ms(lambda: ivf_ix._fine(q, idx, valid, K)), bucket * (DIM * 4 + 9) + DIM * 4,
                       2.0 * bucket * DIM, rate))
    o, a = lsh_ix.planes.shape[:2]
    for nr in (1, IK_LSH_ROWS):
        v = torch.from_numpy(mix["corpus"][:nr]).to(dev)
        rows.append(op_row("lsh_buckets", f"[{nr}, {DIM}], n_or {o}, n_and {a}",
                           cuda_ms(lambda: lsh_buckets(v, lsh_ix.planes, lsh_ix.offsets, lsh_ix.bucket_length)),
                           (nr + o * a) * DIM * 4 + o * a * 4 + nr * o * 4, 2.0 * nr * o * a * DIM, rate))
    rng = np.random.default_rng(SEED + 17)
    ids = rng.integers(0, IK_SEG_SEGMENTS, size=IK_SEG_VALUES)
    ids[ids % 97 == 0] += 1  # every 97th segment stays empty
    ids[:8] = [-1, -5, IK_SEG_SEGMENTS, IK_SEG_SEGMENTS + 3, 0, 1, 2, 3]  # out of range: dropped
    ids = ids.astype(np.int32)
    keep = (ids >= 0) & (ids < IK_SEG_SEGMENTS)
    empty = np.bincount(ids[keep], minlength=IK_SEG_SEGMENTS) == 0
    check(empty.any(), "no empty segment")
    ids_t = torch.from_numpy(ids).to(dev)
    errs = {}
    for dtype in (np.float32, np.int32):
        vals = (rng.normal(size=IK_SEG_VALUES) * 1000).astype(dtype)
        vals_t = torch.from_numpy(vals).to(dev)
        kv, ki = vals[keep], ids[keep]
        info = np.iinfo(np.int32)
        lo_id, hi_id = (-np.inf, np.inf) if dtype == np.float32 else (info.min, info.max)
        s = np.zeros(IK_SEG_SEGMENTS, np.float64)
        np.add.at(s, ki, kv.astype(np.float64))
        scale = np.zeros(IK_SEG_SEGMENTS, np.float64)  # sum of |v|: what f32 rounding scales with
        np.add.at(scale, ki, np.abs(kv.astype(np.float64)))
        cnt = np.bincount(ki, minlength=IK_SEG_SEGMENTS)
        mx = np.full(IK_SEG_SEGMENTS, lo_id, dtype)
        np.maximum.at(mx, ki, kv)
        mn = np.full(IK_SEG_SEGMENTS, hi_id, dtype)
        np.minimum.at(mn, ki, kv)
        want = {"segment_sum": (s, scale), "segment_mean": (s / np.maximum(cnt, 1), scale / np.maximum(cnt, 1)),
                "segment_max": (mx, None), "segment_min": (mn, None)}
        name = np.dtype(dtype).name
        for op, (ref, sc) in want.items():
            fn = getattr(seg, op)
            got = fn(vals_t, ids_t, IK_SEG_SEGMENTS).cpu().numpy()
            if sc is None:
                check(np.array_equal(got, ref), f"{op} {name} differs from numpy")
                err = 0.0
            else:
                err = float(np.max(np.abs(got.astype(np.float64) - ref) / np.maximum(sc, 1.0)))
                # an int sum is exact; a float sum or mean runs in another order
                check(err == 0.0 if (dtype == np.int32 and op == "segment_sum") else err <= 1e-5,
                      f"{op} {name} differs from numpy by {err}")
            errs[f"{op} {name}"] = err
            rows.append(op_row(op, f"{IK_SEG_VALUES} {name} -> {IK_SEG_SEGMENTS} segments",
                               cuda_ms(lambda fn=fn: fn(vals_t, ids_t, IK_SEG_SEGMENTS)),
                               IK_SEG_VALUES * 8 + IK_SEG_SEGMENTS * 4, float(IK_SEG_VALUES), rate))
    got = seg.segment_count(ids_t, IK_SEG_SEGMENTS).cpu().numpy()
    check(np.array_equal(got, np.bincount(ids[keep], minlength=IK_SEG_SEGMENTS)), "segment_count differs")
    rows.append(op_row("segment_count", f"{IK_SEG_VALUES} -> {IK_SEG_SEGMENTS} segments",
                       cuda_ms(lambda: seg.segment_count(ids_t, IK_SEG_SEGMENTS)),
                       IK_SEG_VALUES * 4 + IK_SEG_SEGMENTS * 4, float(IK_SEG_VALUES), rate))
    return rows, {"empty_segments": int(empty.sum()), "dropped_ids": int((~keep).sum()), "rel_err": errs}


def index_kinds(dev, smi: str, rate: float) -> tuple[dict, dict]:
    """Phase 8: the other index kinds on the card — (a) a hybrid
    DocumentStore, (b) IvfKnn through the engine at 500,000 x 384, (c)
    IvfDeviceIndex at bench.py's shape, (d) LshKnn and the segment ops."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hybrid, hybrid_data = hybrid_store(dev)
    hybrid["part_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mix = ivf_mixture()
    mixture_s = time.perf_counter() - t0
    # each part's exact top-10 over the rows it indexes
    eng_truth, _gt = exact_top10(dev, mix["corpus"][:IK_IVF_ENGINE_ROWS], mix["engine_queries"])
    truth, gt = exact_top10(dev, mix["corpus"], mix["device_queries"])
    t0 = time.perf_counter()
    ivf = ivf_engine(dev, mix, eng_truth)
    ivf["part_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf_dev, ivf_ix = ivf_device(dev, mix, truth)
    ivf_dev["part_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lsh, lsh_ix = lsh_index(dev, mix)
    lsh["part_s"] = time.perf_counter() - t0
    ops, seg_check = device_ops(dev, mix, ivf_ix, lsh_ix, rate)
    del ivf_ix, lsh_ix, mix
    phase = {
        "phase": "index kinds",
        "nvidia_smi": smi,
        "hybrid_document_store": hybrid,
        "ivf_knn_engine": ivf,
        "ivf_device_index": ivf_dev,
        "lsh_knn": lsh,
        "segment_ops": seg_check,
        "device_ops": ops,
        "mixture_s": mixture_s,
        "ground_truth_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(gt["shapes"].items())},
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "phase_s": time.perf_counter() - t_phase,
    }
    return phase, {"hybrid": hybrid_data, "ground_truth": gt}


# --- phase 9: components ------------------------------------------------------

CC_FAMILIES = 2048
CC_FAMILY = 8  # near-duplicate variants per family
CC_WORDS = 24  # words of a family's first variant
CC_EDITS = 2  # drops, swaps or substitutions from one variant to the next
CC_K = 9  # neighbours per document, itself included
# score = cosine - 1: the full-width seeded encoder puts neighbouring
# variants of a family above this and unrelated documents below it
CC_THRESHOLD = -0.08
CC_COMMITS = 4  # cut from 8 beside the compiled ticks phase to keep the smoke under 950 s
CC_INSERTS = 256  # per commit: 32 new families
CC_DELETES = 128  # per commit: variants 3 and 4 of 64 families


def cc_family_docs(rng: np.random.Generator, vocab: np.ndarray, families: int, first: int) -> list[tuple[int, str]]:
    """Families of CC_FAMILY variants: each variant drops, swaps or replaces
    CC_EDITS words of the one before, so a family drifts along a chain."""
    out = []
    for f in range(families):
        words = list(rng.choice(vocab, size=CC_WORDS))
        for v in range(CC_FAMILY):
            out.append((first + f * CC_FAMILY + v, " ".join(words)))
            words = list(words)
            for _ in range(CC_EDITS):
                r = rng.random()
                if r < 1 / 3 and len(words) > 2:
                    del words[int(rng.integers(len(words)))]
                elif r < 2 / 3:
                    i, j = rng.integers(len(words), size=2)
                    words[i], words[j] = words[j], words[i]
                else:
                    words[int(rng.integers(len(words)))] = str(rng.choice(vocab))
    return out


def cc_components(pw, edges):
    """Minimum-label propagation to a fixpoint with pw.iterate: each
    vertex's label becomes the least vertex id it reaches. Each vertex
    links to itself, so a step's minimum keeps its own label; a link's join
    row keeps the link's id (no new keys inside the body)."""
    both = edges.select(a=edges.u, b=edges.w).concat_reindex(edges.select(a=edges.w, b=edges.u))
    verts = both.groupby(both.a).reduce(v=both.a)
    links = both.concat_reindex(verts.select(a=verts.v, b=verts.v))
    labels0 = verts.select(verts.v, label=verts.v)

    def step(labels):
        nb = links.join(labels, links.a == labels.v, id=links.id).select(v=links.b, label=labels.label)
        return nb.groupby(nb.v).reduce(nb.v, label=pw.reducers.min(nb.label))

    return pw.iterate(step, labels=labels0)


def components(dev, smi: str) -> tuple[dict, dict]:
    """A live semantic-components pipeline as a user writes it: documents
    stream in through pw.io.python, the full-width embedder UDF embeds them,
    DataIndex over TpuKnn(device=dev) holds them, and every document asks
    the live index (query, not query_as_of_now) for its CC_K nearest
    neighbours, so all the standing queries are answered again in one
    block_topk batch whenever the corpus changes. The pairs scoring at
    least CC_THRESHOLD (self-pairs dropped) are a graph's edges, pw.iterate
    labels its connected components, pw.sql counts their sizes. One commit
    of every family, then CC_COMMITS commits of CC_INSERTS new documents
    and CC_DELETES deletions, each one tick. After every commit: the
    labels equal scipy's connected components over the replies the engine
    emitted (captured with pw.io.subscribe), the sizes equal a bincount of
    those labels, and every reply equals block_topk's plain version on the
    device over the index's own rows, up to near ties."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.internals.api import ref_scalar
    from pathway_tpu_torch.internals.iterate import IterateExec
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.block_topk import block_topk_ref
    from pathway_tpu_torch.ops.knn import stable_topk
    from pathway_tpu_torch.stdlib.indexing import DataIndex, TpuKnn
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = np.array(["".join(rng.choice(letters, size=int(rng.integers(3, 9)))) for _ in range(20000)])
    n_docs = CC_FAMILIES * CC_FAMILY
    per_commit = CC_INSERTS // CC_FAMILY
    initial = cc_family_docs(rng, vocab, CC_FAMILIES, 0)
    inserts = [cc_family_docs(rng, vocab, per_commit, n_docs + c * CC_INSERTS) for c in range(CC_COMMITS)]
    # deletions: variants 3 and 4 of CC_DELETES / 2 initial families per commit,
    # which cuts a family's chain in the middle
    doomed = rng.permutation(CC_FAMILIES)[: CC_COMMITS * CC_DELETES // 2].reshape(CC_COMMITS, -1)
    text_of = dict(initial + [d for ins in inserts for d in ins])
    key_doc = {int(ref_scalar(d)): d for d in text_of}

    parse_graph.G.clear()
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    torch.cuda.reset_peak_memory_stats()

    class DocSchema(pw.Schema):
        doc: int = pw.column_definition(primary_key=True)
        text: str

    failure: list[BaseException] = []
    pair_state: dict[int, tuple] = {}
    label_state: dict[int, tuple] = {}
    size_state: dict[int, tuple] = {}

    def keep(state, cols):
        def on_change(key, row, time, is_addition):
            if is_addition:
                state[int(key)] = tuple(row[c] for c in cols)
            elif state.get(int(key)) == tuple(row[c] for c in cols):
                del state[int(key)]

        return on_change

    record: dict = {"update_s": [], "depths": [], "ops": [], "near_ties": 0, "replies_exact": 0,
                    "replies": 0, "splits": 0, "components": [], "edges": []}

    class DocSubject(pw.io.python.ConnectorSubject):
        def run(self):
            try:
                drive(self)
            except BaseException as e:  # noqa: BLE001 — re-raised after pw.run
                failure.append(e)

    def commit(subject) -> float:
        rt = parse_graph.G.runtime
        goal = rt.stats.ticks + 1
        since = dict(rt.stats.node_ns)
        t0 = time.perf_counter()
        subject.commit()
        wait_until(lambda: rt.stats.ticks >= goal, "a components commit's tick", timeout=600.0)
        dt_s = time.perf_counter() - t0
        record["ops"].append(operator_s(rt, since))
        ex = next(e for e in rt.execs.values() if isinstance(e, IterateExec))
        record["depths"].append((ex._final_depth or 0) + 1)
        return dt_s

    def plain_replies(live: list[int]) -> dict[int, list[tuple[int, float]]]:
        """Each live document's CC_K neighbours by block_topk's plain
        version on the device, over the engine index's own rows."""
        ix = next(e.index for e in parse_graph.G.runtime.execs.values() if isinstance(e, ExternalIndexExec))
        prep, _c2, valid = ix.corpus.prepared_arrays("cosine", bf16=False)
        # a deletion that left its row valid would be a neighbour on both sides
        check(int(valid.sum()) == len(live), f"the index holds {int(valid.sum())} valid rows, {len(live)} live")
        slots = torch.tensor([ix.corpus.slot_of[int(ref_scalar(d))] for d in live], device=prep.device)
        out = {}
        for lo in range(0, len(live), 4096):
            q = prep[slots[lo:lo + 4096]]
            sc, ixs = block_topk_ref(q, prep, valid, CC_K)
            scores, pos = stable_topk(sc.reshape(len(q), -1), CC_K)
            idx = torch.gather(ixs.reshape(len(q), -1), 1, pos).cpu().numpy()
            scores = scores.double().cpu().numpy() - 1.0
            for r, d in enumerate(live[lo:lo + 4096]):
                out[d] = [(key_doc[ix.corpus.key_of[int(s)]], float(v)) for s, v in zip(idx[r], scores[r])]
        record["corpus_rows"] = int(prep.shape[0])
        return out

    def verify(live: set[int], stage: str) -> None:
        replies: dict[int, list[tuple[int, float]]] = {}
        for u, w, s in pair_state.values():
            replies.setdefault(u, []).append((w, s))
        check(set(replies) == live, f"{stage}: replies for {len(replies)} documents, {len(live)} live")
        dead = {w for _u, w, _s in pair_state.values()} - live
        check(not dead, f"{stage}: {len(dead)} deleted documents are still neighbours in the replies")
        plain = plain_replies(sorted(live))
        for u, got in replies.items():
            got = tuple(sorted(got, key=lambda p: -p[1]))
            want = tuple(plain[u])
            check(same_up_to_near_ties(got, want, F32_TOL),
                  f"{stage}: document {u}'s reply {got} differs from the plain top-k {want}")
            record["replies_exact"] += [d for d, _s in got] == [d for d, _s in want]
            record["replies"] += 1
        uw = np.array([(u, w) for u, w, s in pair_state.values() if s >= CC_THRESHOLD and u != w], dtype=np.int64)
        n = max(text_of) + 1
        _, comp = connected_components(sp.coo_matrix((np.ones(len(uw)), (uw[:, 0], uw[:, 1])), shape=(n, n)),
                                       directed=False)
        verts = np.unique(uw)
        least: dict[int, int] = {}
        for v in verts.tolist():  # ascending: the first vertex of a component is its label
            least.setdefault(int(comp[v]), v)
        want_labels = {v: least[int(comp[v])] for v in verts.tolist()}
        got_labels = {v: lab for v, lab in label_state.values()}
        check(got_labels == want_labels, f"{stage}: component labels differ from scipy's "
              f"({sum(got_labels.get(v) != l for v, l in want_labels.items())} of {len(want_labels)})")
        counts = np.bincount(np.array(list(want_labels.values()), dtype=np.int64))
        want_sizes = {lab: int(c) for lab, c in enumerate(counts.tolist()) if c}
        check(dict(size_state.values()) == want_sizes, f"{stage}: SQL sizes differ from the labels' bincount")
        record["components"].append(len(want_sizes))
        record["edges"].append(len(uw) // 2)

    def family_parts(vs: list[int]) -> int:
        """How many components hold the vertices vs (an isolated one, which
        no edge reaches, is a component of its own)."""
        label_of = {v: lab for v, lab in label_state.values()}
        return len({label_of.get(v, ("alone", v)) for v in vs})

    def drive(subject) -> None:
        for d, text in initial:
            subject.next(doc=d, text=text)
        first_s = commit(subject)
        record["first_fixpoint_s"] = first_s
        live = {d for d, _t in initial}
        t0 = time.perf_counter()
        verify(live, "initial")
        record["verify_s"] = [time.perf_counter() - t0]
        for c in range(CC_COMMITS):
            for d, text in inserts[c]:
                subject.next(doc=d, text=text)
            gone = [int(f) * CC_FAMILY + v for f in doomed[c] for v in (3, 4)]
            for d in gone:
                subject._remove(ref_scalar(d), {"doc": d, "text": text_of[d]})
            # the survivors of each family losing its middle: one component
            # before the commit, several after it is a split
            kept = [[int(f) * CC_FAMILY + v for v in (0, 1, 2, 5, 6, 7)] for f in doomed[c]]
            before = [family_parts(vs) for vs in kept]
            record["update_s"].append(commit(subject))
            live = (live | {d for d, _t in inserts[c]}) - set(gone)
            t0 = time.perf_counter()
            verify(live, f"commit {c + 1}")
            record["verify_s"].append(time.perf_counter() - t0)
            record["splits"] += sum(b == 1 and family_parts(vs) > 1 for b, vs in zip(before, kept))
        record["live"] = len(live)

    emb = SentenceTransformerEmbedder(device=dev)
    docs = pw.io.python.read(DocSubject(), schema=DocSchema, autocommit_duration_ms=None)
    docs = docs.with_columns(vec=emb(pw.this.text))
    knn = TpuKnn(docs.vec, dimensions=emb.runtime.dim,
                 reserved_space=n_docs + CC_COMMITS * CC_INSERTS, device=dev)
    index = DataIndex(docs, knn)
    hits = index.query(docs.vec, number_of_matches=CC_K, collapse_rows=False)
    pairs = hits.select(u=pw.left.doc, w=pw.right.doc, score=pw.right._pw_index_reply_score)
    edges = pairs.filter((pairs.score >= CC_THRESHOLD) & (pairs.u != pairs.w))
    comps = cc_components(pw, edges)
    sizes = pw.sql("SELECT label, COUNT(*) AS size FROM comps GROUP BY label", comps=comps)
    pw.io.subscribe(pairs, on_change=keep(pair_state, ("u", "w", "score")))
    pw.io.subscribe(comps, on_change=keep(label_state, ("v", "label")))
    pw.io.subscribe(sizes, on_change=keep(size_state, ("label", "size")))
    pw.run()  # raises if an operator recorded an error (a kernel failure included)
    if failure:
        raise failure[0]
    launches = bt.block_topk.launches
    shapes = dict(bt.block_topk.shapes)
    rt = parse_graph.G.last_runtime
    check(rt.stats.ticks == CC_COMMITS + 2, f"{rt.stats.ticks} ticks for {CC_COMMITS + 1} commits")
    # one search of every standing query per commit, all of them in one batch
    check(launches == CC_COMMITS + 1, f"{launches} block_topk launches for {CC_COMMITS + 1} commits")
    check(emb.runtime.device.type == "cuda", f"the embedder ran on {emb.runtime.device}")
    check(record["splits"] > 0, "no deletion split a family's component")
    upd = [s * 1e3 for s in record["update_s"]]
    ex = next(e for e in rt.execs.values() if isinstance(e, IterateExec))
    phase = {
        "phase": "components",
        "nvidia_smi": smi,
        "docs": n_docs,
        "families": CC_FAMILIES,
        "family_size": CC_FAMILY,
        "k": CC_K,
        "threshold": CC_THRESHOLD,
        "commits": {"initial": n_docs, "updates": CC_COMMITS, "inserts": CC_INSERTS, "deletes": CC_DELETES},
        "first_fixpoint_s": record["first_fixpoint_s"],
        "first_tick_operator_s": record["ops"][0],
        "update_tick_operator_s_p50_commit": record["ops"][1 + CC_COMMITS // 2],
        "iterate_depths_by_commit": record["depths"],
        "iterate_depths_max": max(record["depths"]),
        "iterate_depth_runtimes_kept": len(ex._depths),
        "update_to_visible_ms": {"p50": float(np.percentile(upd, 50)), "max": float(np.max(upd)), "n": len(upd)},
        "components_by_commit": record["components"],
        "edges_by_commit": record["edges"],
        "families_split_by_deletes": record["splits"],
        "replies_compared": record["replies"],
        "replies_keys_equal_plain": record["replies_exact"],
        "verify_s": record["verify_s"],
        "live_docs": record["live"],
        "ticks": rt.stats.ticks,
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "embedder_device": str(emb.runtime.device),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "phase_s": time.perf_counter() - t_phase,
    }
    ix = next(e.index for e in rt.execs.values() if isinstance(e, ExternalIndexExec))
    prep, _c2, valid = ix.corpus.prepared_arrays("cosine", bf16=False)
    # the batch each shape saw: every live document's own row, zero-padded
    # to the index's power-of-two batch as its search pads it
    live_rows = prep[torch.tensor(sorted(ix.corpus.slot_of.values()), device=prep.device)]
    queries = {}
    for b, _k in shapes:
        q = torch.zeros(b, prep.shape[1], dtype=prep.dtype, device=prep.device)
        q[: min(b, len(live_rows))] = live_rows[:b]
        queries[b] = q
    parse_graph.G.clear()
    return phase, {"prep": prep, "valid": valid, "queries": queries, "launches": launches, "shapes": shapes}


# --- phase 10: live classify --------------------------------------------------

LC_DOCS = 32768
LC_QUERIES = 2048
LC_BATCH = 16  # StreamGenerator batches: 128 of 16 queries
LC_LABELS = 8
LC_K = 3
LC_LABEL_WORDS = 64  # each label's own slice of the vocabulary
LC_SHARED_WORDS = 2000  # words every label draws from
LC_OWN = 0.7  # the share of a document's words from its label's slice
LC_WAIT_S = 600.0


def lc_docs(seed: int, n: int, first: int = 0) -> list[tuple[int, int, str]]:
    """n labelled documents (id, label, text) of 16-48 words: each word is
    from the label's own slice of a seeded vocabulary with probability
    LC_OWN, else from the shared slice, so labels are separable by cosine.
    The vocabulary is the same for every seed."""
    vrng = np.random.default_rng(SEED + 12)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = np.array(["".join(vrng.choice(letters, size=int(vrng.integers(4, 10))))
                      for _ in range(LC_LABELS * LC_LABEL_WORDS + LC_SHARED_WORDS)])
    shared = vocab[LC_LABELS * LC_LABEL_WORDS:]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        label = int(rng.integers(LC_LABELS))
        own = vocab[label * LC_LABEL_WORDS:(label + 1) * LC_LABEL_WORDS]
        size = int(rng.integers(16, 49))
        mine = rng.random(size) < LC_OWN
        words = np.where(mine, rng.choice(own, size=size), rng.choice(shared, size=size))
        out.append((first + i, label, " ".join(words)))
    return out


def lc_write_csv(path: str, docs: list[tuple[int, int, str]]) -> None:
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["doc", "label", "text"])
        w.writerows(docs)


def lc_majority(labels):
    """The classifier's vote (stdlib/ml/classifiers ``majority``): the most
    frequent label, a tie going to the largest ``str``."""
    if not labels:
        return None
    counts = Counter(labels)
    return max(counts.items(), key=lambda kv: (kv[1], str(kv[0])))[0]


def lc_pipeline(pw, csv_path: str, queries: list[tuple[int, int, str]], emb, dim: int, device: str):
    """A live document classifier as a user writes it: pw.demo.replay_csv
    streams the labelled documents in, ``emb`` embeds them, the kNN
    classifier trains on them (cosine, so the index searches with
    block_topk), and queries arriving from pw.debug.StreamGenerator in
    batches of LC_BATCH are labelled by the majority of their LC_K nearest
    documents, once by the trained model and once by knn_lsh_classify with
    a separate label table (``topic-<label>``). Returns the table pw.live
    watches: each query's id, vector and both labels."""
    from importlib import import_module

    classifiers = import_module(pw.__name__ + ".stdlib.ml.classifiers")

    class Doc(pw.Schema):
        doc: int = pw.column_definition(primary_key=True)
        label: int
        text: str

    class Query(pw.Schema):
        query: int
        text: str

    train = pw.demo.replay_csv(csv_path, schema=Doc, input_rate=0)
    vectors = train.select(train.label, data=emb(train.text))
    model = classifiers.knn_lsh_classifier_train(vectors, type="cosine", d=dim, device=device)
    batches = [[{"query": q, "text": t} for q, _label, t in queries[i:i + LC_BATCH]]
               for i in range(0, len(queries), LC_BATCH)]
    asked = pw.debug.StreamGenerator().table_from_list_of_batches(batches, Query)
    qv = asked.select(asked.query, data=emb(asked.text))
    pred = model(qv, k=LC_K)
    topics = train.select(label=pw.apply(lambda label: f"topic-{label}", train.label))
    named = classifiers.knn_lsh_classify(model, topics, qv, LC_K)
    return qv.select(qv.query, qv.data, predicted=pred.predicted_label, topic=named.predicted_label)


def live_classify(dev, smi: str) -> tuple[dict, dict]:
    """A live document classifier on the card, as a user writes it: the
    labelled documents stream in through pw.demo.replay_csv, the full-width
    embedder embeds them, knn_lsh_classifier_train(type="cosine",
    device=dev) indexes them through KNNIndex and block_topk, and queries
    from pw.debug.StreamGenerator are labelled by the trained model and by
    knn_lsh_classify with a separate label table; pw.live watches the
    predictions while the run goes on (``lc_pipeline``). A subscriber only
    records; every check runs after ``wait()``, which raises what the run's
    thread raised. Checked: one prediction per query; each label (and each
    topic) equals the majority over block_topk's plain version's top
    LC_K on each index's own prepared corpus and valid rows, a difference
    allowed only at a near tie at rank LC_K; each index holds LC_DOCS
    valid rows on the card; the embedder on the card; launches on every
    reported shape; the subscriber's final state equals the snapshot; the
    run did not fail; accuracy against the true labels above twice chance."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.engine.nodes import InputNode
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.internals.api import ref_scalar
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.block_topk import block_topk_ref
    from pathway_tpu_torch.ops.knn import _normalize, stable_topk
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    t_phase = time.perf_counter()
    docs = lc_docs(SEED + 13, LC_DOCS)
    queries = lc_docs(SEED + 14, LC_QUERIES, first=LC_DOCS)
    label_of_key = {int(ref_scalar(d)): label for d, label, _t in docs}
    truth = {q: label for q, label, _t in queries}
    workdir = tempfile.mkdtemp(prefix="live_classify_")
    csv_path = os.path.join(workdir, "train.csv")
    lc_write_csv(csv_path, docs)

    parse_graph.G.clear()
    emb = SentenceTransformerEmbedder(device=dev)
    out = lc_pipeline(pw, csv_path, queries, emb, emb.runtime.dim, dev.type)
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    events: list[tuple[float, int, bool, int]] = []
    state: dict[int, tuple] = {}

    def follow(key, row, t, is_addition):
        # records only: no check runs inside a subscriber
        events.append((time.perf_counter(), t, is_addition, row["query"]))
        vals = (row["query"], row["predicted"], row["topic"])
        if is_addition:
            state[int(key)] = vals
        elif state.get(int(key)) == vals:
            del state[int(key)]

    t_live = time.perf_counter()
    lt = pw.live(out)
    lt.subscribe(follow)
    finished = lt.wait(LC_WAIT_S)  # raises what the run's thread raised
    check(finished, f"the live run did not finish in {LC_WAIT_S} s")
    check(not lt.failed, f"the live run failed: {lt.error!r}")
    _frontier, rows = lt.snapshot()
    launches, shapes = bt.block_topk.launches, dict(bt.block_topk.shapes)
    rt = lt._runtime

    check(len(rows) == LC_QUERIES and {r[0] for r in rows.values()} == set(truth),
          f"{len(rows)} predictions for {LC_QUERIES} queries")
    check(state == {int(k): (r[0], r[2], r[3]) for k, r in rows.items()},
          "the subscriber's final state differs from snapshot()")
    check(emb.runtime.device.type == "cuda", f"the embedder ran on {emb.runtime.device}")
    indexes = [e.index for e in rt.execs.values() if isinstance(e, ExternalIndexExec)]
    check(len(indexes) == 2, f"{len(indexes)} indexes, not the model's and the label table's")
    order = sorted(rows)
    qv = _normalize(torch.tensor(np.stack([np.asarray(rows[k][1], dtype=np.float32) for k in order]),
                                 device=dev))
    near_ties, plain = 0, {}
    for which, ix in zip(("predicted", "topic"), indexes):
        prep, _c2, valid = ix.corpus.prepared_arrays("cosine", bf16=False)
        check(prep.device.type == "cuda", f"the {which} index's corpus is on {prep.device}")
        check(int(valid.sum()) == LC_DOCS, f"the {which} index holds {int(valid.sum())} valid rows")
        keys_ref, scores_ref = [], []
        for lo in range(0, len(order), 512):
            q = qv[lo:lo + 512].to(prep.dtype)
            sc, ixs = block_topk_ref(q, prep, valid, LC_K + 1)
            s, pos = stable_topk(sc.reshape(len(q), -1), LC_K + 1)
            slots = torch.gather(ixs.reshape(len(q), -1), 1, pos).cpu().numpy()
            keys_ref += [[ix.corpus.key_of[int(x)] for x in r] for r in slots]
            scores_ref += s.double().cpu().numpy().tolist()
        plain[which] = keys_ref
        # one index's labels are ints, the other's topic-<int>: the model
        # labels by the first, knn_lsh_classify by the second
        col = 2 if which == "predicted" else 3
        for k, keys, s in zip(order, keys_ref, scores_ref):
            want = lc_majority([label_of_key[x] for x in keys[:LC_K]])
            if which == "topic":
                want = f"topic-{want}"
            if rows[k][col] != want:
                check(abs(s[LC_K - 1] - s[LC_K]) <= F32_TOL,
                      f"query {rows[k][0]}: {which} {rows[k][col]!r}, the plain top-{LC_K} votes {want!r}")
                near_ties += 1
    check(plain["predicted"] == plain["topic"], "the two indexes' plain top-k differ")
    check(launches > 0 and all(n > 0 for n in shapes.values()), f"block_topk launches {shapes}")
    ready_s = time.perf_counter() - t_live
    accuracy = float(np.mean([rows[k][2] == truth[rows[k][0]] for k in order]))
    check(accuracy > 2.0 / LC_LABELS, f"accuracy {accuracy} is not above twice chance")

    # the update stream: every standing query answered again as the corpus grew
    retracted = {q for _w, _t, add, q in events if not add}
    times = sorted({t for _w, t, _a, _q in events})
    first_seen = {}
    for wall, _t, add, q in events:
        if add:
            first_seen.setdefault(q, wall)
    # the training documents' embedder: the node that makes (label, data)
    # from the rows pw.demo reads
    embed = [n for n in rt.order if list(n.column_names) == ["label", "data"]
             and any(isinstance(i, InputNode) for i in n.inputs)]
    check(len(embed) == 1, f"{len(embed)} nodes embed the training documents")
    train_embed_s = rt.stats.node_ns.get(embed[0].id, 0) / 1e9
    phase = {
        "phase": "live classify",
        "nvidia_smi": smi,
        "docs": LC_DOCS,
        "queries": LC_QUERIES,
        "query_batches": LC_QUERIES // LC_BATCH,
        "labels": LC_LABELS,
        "k": LC_K,
        "accuracy": accuracy,
        "near_ties": near_ties,
        "live_to_final_snapshot_s": ready_s,
        "train_embed_s": train_embed_s,
        "embed_docs_per_s": LC_DOCS / train_embed_s,
        "updates": {
            "rows": len(events),
            "insertions": sum(1 for e in events if e[2]),
            "retractions": len(events) - sum(1 for e in events if e[2]),
            "queries_answered_again": len(retracted),
            "logical_times": len(times),
            "first_prediction_s": min(first_seen.values()) - t_live if first_seen else None,
        },
        "ticks": rt.stats.ticks,
        "operator_s": operator_s(rt),
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "embedder_device": str(emb.runtime.device),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "phase_s": time.perf_counter() - t_phase,
    }
    lt.stop()
    prep, _c2, valid = indexes[0].corpus.prepared_arrays("cosine", bf16=False)
    batch = {}
    for b, _k in shapes:
        # the batch each shape saw: the standing queries, zero-padded to the
        # index's power-of-two batch as its search pads it
        q = torch.zeros(b, prep.shape[1], dtype=prep.dtype, device=prep.device)
        q[: min(b, len(qv))] = qv[:b].to(prep.dtype)
        batch[b] = q
    shutil.rmtree(workdir, ignore_errors=True)
    parse_graph.G.clear()
    return phase, {"prep": prep, "valid": valid, "queries": batch, "launches": launches, "shapes": shapes}


# --- phase 11: windowed index -------------------------------------------------

WI_DOCS = 32768
WI_COMMITS = 32  # commits of 1024 documents, one tick each
WI_TOPICS = 64
WI_QUERIES = 256  # standing queries, answered again on every change
WI_K = 10
WI_SPAN = 3600  # event times 0..WI_SPAN seconds, rising with jitter
WI_JITTER = 20
WI_WINDOW = 600  # tumbling windows, one set per topic
WI_DELAY = 60  # a window becomes visible WI_DELAY after it starts ...
WI_CUTOFF = 1200  # ... and is retracted WI_CUTOFF after it ends
WI_LATE = 0.02  # the share of documents that arrive past their window's cutoff
WI_JOIN = (-300, 0)  # the host leg: a query's topic in the 5 minutes up to its time
WI_RESERVED = 1 << 15  # the live documents peak past 16,384: the next power of two


def wi_stream(seed: int, n: int, commits: int, topics: int, queries: int) -> dict:
    """A news feed of ``n`` seeded documents in ``commits`` equal commits:
    event times rising from 0 to WI_SPAN with jitter, a topic each, and a
    WI_LATE share (drawn from the last third) sent far enough back that
    the freeze drops them; plus ``queries`` standing queries with a time
    and a topic. Texts from ``synthetic_docs``."""
    rng = np.random.default_rng(seed)
    base = np.arange(n, dtype=np.int64) * WI_SPAN // n
    t = np.clip(base + rng.integers(-WI_JITTER, WI_JITTER + 1, n), 0, WI_SPAN)
    late = rng.choice(np.flatnonzero(base >= 2 * WI_SPAN // 3), size=int(round(WI_LATE * n)),
                      replace=False)
    # end + cutoff at most base - 200: behind the watermark of the commit before
    t[late] = base[late] - WI_CUTOFF - WI_WINDOW - 200 - rng.integers(0, 400, len(late))
    texts = synthetic_docs(n + queries, rng)
    return {
        "t": t, "topic": rng.integers(0, topics, n), "late": np.sort(late),
        "commit": np.arange(n) * commits // n, "commits": commits, "text": texts[:n],
        "q_t": rng.integers(0, WI_SPAN + 1, queries), "q_topic": rng.integers(0, topics, queries),
        "q_text": texts[n:],
    }


def wi_oracle(t: np.ndarray, commit: np.ndarray, commits: int) -> tuple[list[np.ndarray], int]:
    """The live documents after each commit, and how many the freeze
    dropped, for tumbling(WI_WINDOW) under common_behavior(WI_DELAY,
    WI_CUTOFF, keep_results=False), written out in numpy from the
    reference's semantics (stdlib/temporal/temporal_behavior.py:91-135 and
    the Buffer, Freeze and Forget execs). Each commit is one tick; every
    watermark is global, over all topics. A document of window [s, e):
    the freeze drops it if e + cutoff is at most the largest time it let
    through in earlier ticks; the forget, in a tick that brings rows,
    retracts every document it holds with e + cutoff at most the largest
    time of earlier ticks; the buffer holds a document until the largest
    time it has seen, this tick's included, reaches s + delay."""
    start = t - t % WI_WINDOW
    gone_at = start + WI_WINDOW + WI_CUTOFF
    show_at = start + WI_DELAY
    frozen = np.zeros(len(t), dtype=bool)
    passed = np.zeros(len(t), dtype=bool)
    forgotten = np.zeros(len(t), dtype=bool)
    released = np.zeros(len(t), dtype=bool)
    mark = None  # the largest time let through in earlier ticks
    live = []
    for c in range(commits):
        now = commit == c
        if mark is not None:
            frozen |= now & (gone_at <= mark)
        accepted = now & ~frozen
        if accepted.any():
            if mark is not None:
                forgotten |= passed & (gone_at <= mark)
            passed |= accepted
            top = int(t[accepted].max())
            mark = top if mark is None else max(mark, top)
        if mark is not None:
            released |= passed & ~forgotten & (show_at <= mark)
        live.append(np.flatnonzero(released & ~forgotten))
    return live, int(frozen.sum())


def wi_pipeline(pw, docs, queries, emb, dim: int, knn_kw: dict) -> dict:
    """A recency-bounded live index as a user writes it: ``docs`` (doc_id,
    t, topic, text) are embedded; tumbling windows of WI_WINDOW per topic
    under common_behavior(delay=WI_DELAY, cutoff=WI_CUTOFF,
    keep_results=False) collect their ids; the windows' members, flattened
    and joined back to the embedded documents, are what DataIndex over
    TpuKnn holds, so a document enters the index with its window and
    leaves with it; every query (qid, t, topic, text) asks the live index
    for its WI_K nearest documents. The host leg counts, per query, the
    documents of its topic in the WI_JOIN interval before its time
    (interval_join). Returns the tables: embedded, asked, windows, pairs,
    counts."""
    from importlib import import_module

    indexing = import_module(pw.__name__ + ".stdlib.indexing")
    embedded = docs.select(docs.doc_id, vec=emb(docs.text))
    windows = docs.windowby(
        docs.t,
        window=pw.temporal.tumbling(duration=WI_WINDOW),
        instance=docs.topic,
        behavior=pw.temporal.common_behavior(delay=WI_DELAY, cutoff=WI_CUTOFF, keep_results=False),
    ).reduce(ids=pw.reducers.tuple(pw.this.doc_id), n=pw.reducers.count())
    members = windows.flatten(windows.ids)
    live = members.join(embedded, members.ids == embedded.doc_id).select(
        doc_id=embedded.doc_id, vec=embedded.vec)
    knn = indexing.TpuKnn(live.vec, dimensions=dim, reserved_space=WI_RESERVED, **knn_kw)
    asked = queries.select(queries.qid, vec=emb(queries.text))
    pairs = indexing.DataIndex(live, knn).query(asked.vec, number_of_matches=WI_K, collapse_rows=False).select(
        qid=pw.left.qid, doc_id=pw.right.doc_id, score=pw.right._pw_index_reply_score)
    near = queries.interval_join(docs, queries.t, docs.t, pw.temporal.interval(*WI_JOIN),
                                 queries.topic == docs.topic).select(qid=pw.left.qid)
    counts = near.groupby(near.qid).reduce(near.qid, n=pw.reducers.count())
    return {"embedded": embedded, "asked": asked, "windows": windows, "pairs": pairs, "counts": counts}


def wi_counts(s: dict, upto: int) -> dict[int, int]:
    """numpy's interval-join counts over the documents of commits 0..upto:
    per query, the documents of its topic with q_t + lower <= t <= q_t + upper."""
    seen = s["commit"] <= upto
    out = {}
    for q, (qt, topic) in enumerate(zip(s["q_t"], s["q_topic"])):
        n = int(np.sum(seen & (s["topic"] == topic) & (s["t"] >= qt + WI_JOIN[0]) & (s["t"] <= qt + WI_JOIN[1])))
        if n:
            out[q] = n
    return out


def wi_plain(vecs: np.ndarray, qvecs: dict, live: np.ndarray, dev) -> dict[int, tuple]:
    """Each query's plain top-WI_K over the live documents' vectors (rows
    of ``vecs`` by document id): one
    f32 matmul of the normalized vectors on ``dev`` and torch.topk, scores
    as the index reports them (cosine - 1)."""
    if not len(live):
        return {q: () for q in qvecs}
    c = torch.tensor(vecs[live], dtype=torch.float32, device=dev)
    qs = sorted(qvecs)
    q = torch.tensor(np.stack([qvecs[x] for x in qs]), dtype=torch.float32, device=dev)
    c = c / c.norm(dim=-1, keepdim=True)
    q = q / q.norm(dim=-1, keepdim=True)
    s, ix = torch.topk(q @ c.T, min(WI_K, len(live)), dim=-1)
    s, ix = (s.double() - 1.0).cpu().numpy(), ix.cpu().numpy()
    return {x: tuple((int(live[j]), float(v)) for j, v in zip(ix[r], s[r])) for r, x in enumerate(qs)}


def windowed_index(dev, smi: str) -> tuple[dict, dict]:
    """A recency-bounded live retrieval index on the card, as a user writes
    it (``wi_pipeline``): WI_DOCS seeded documents stream in through
    pw.io.python in WI_COMMITS commits, one tick each, after one commit of
    WI_QUERIES standing queries; the full-width embedder embeds both; the
    windows and the behavior decide which documents the index holds;
    DataIndex over TpuKnn(device=dev) answers every standing query again
    on every change, with block_topk. After every commit: every reply
    equals the plain top-WI_K over the live documents of ``wi_oracle``, up
    to near ties; the index holds as many valid rows as there are live
    documents; no reply names a document that is not live; the
    interval-join counts equal numpy's. After the run: the documents that
    never entered a window are as many as the oracle's frozen ones."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    _now = time.perf_counter
    t_phase = _now()
    s = wi_stream(SEED + 17, WI_DOCS, WI_COMMITS, WI_TOPICS, WI_QUERIES)
    lives, frozen = wi_oracle(s["t"], s["commit"], WI_COMMITS)
    parse_graph.G.clear()
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    torch.cuda.reset_peak_memory_stats()

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        t: int
        topic: int
        text: str

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        t: int
        topic: int
        text: str

    qvecs: dict[int, np.ndarray] = {}
    pair_state: dict[int, tuple] = {}
    count_state: dict[int, int] = {}
    entered: set[int] = set()
    record: dict = {"update_s": [], "ops": [], "rows": [], "near_ties": 0, "replies_exact": 0, "replies": 0,
                    "first_reply": None, "verify_s": 0.0}
    n_commits = [0]

    def on_vec(into):
        def on_change(key, row, time, is_addition):
            if is_addition:
                into[row["doc_id"] if "doc_id" in row else row["qid"]] = np.asarray(row["vec"], dtype=np.float32)

        return on_change

    def on_pair(key, row, time, is_addition):
        if record["first_reply"] is None and is_addition and row["doc_id"] is not None:
            record["first_reply"] = _now()
        vals = (row["qid"], row["doc_id"], row["score"])
        if is_addition:
            pair_state[int(key)] = vals
        elif pair_state.get(int(key)) == vals:
            del pair_state[int(key)]

    def on_count(key, row, time, is_addition):
        if is_addition:
            count_state[row["qid"]] = row["n"]
        elif count_state.get(row["qid"]) == row["n"]:
            del count_state[row["qid"]]

    def on_window(key, row, time, is_addition):
        if is_addition:
            entered.update(row["ids"])

    def verify(c: int) -> None:
        live = lives[c]
        rt = parse_graph.G.runtime
        ix = next(e.index for e in rt.execs.values() if isinstance(e, ExternalIndexExec))
        _prep, _c2, valid = ix.corpus.prepared_arrays("cosine", bf16=False)
        check(valid.device.type == "cuda", f"the index's corpus is on {valid.device}")
        check(int(valid.sum()) == len(live),
              f"commit {c}: the index holds {int(valid.sum())} valid rows, {len(live)} documents are live")
        record["rows"].append(len(live))
        replies: dict[int, list] = {q: [] for q in qvecs}
        for q, d, sc in pair_state.values():
            if d is not None:  # the row of a query the index could not answer
                replies[q].append((d, sc))
        alive = set(live.tolist())
        dead = {d for q, d, _s in pair_state.values() if d is not None} - alive
        check(not dead, f"commit {c}: {len(dead)} documents that are not live are in the replies")
        plain = wi_plain(vecs, qvecs, live, dev)
        for q, got in replies.items():
            got = tuple(sorted(got, key=lambda p: (-p[1], p[0])))
            check(same_up_to_near_ties(got, plain[q], F32_TOL),
                  f"commit {c}: query {q}'s reply {got} differs from the plain top-{WI_K} {plain[q]}")
            exact = [d for d, _s in got] == [d for d, _s in plain[q]]
            record["replies_exact"] += exact
            record["near_ties"] += not exact
            record["replies"] += 1
        check(count_state == wi_counts(s, c), f"commit {c}: the interval-join counts differ from numpy's")

    def drive(subject) -> None:
        rt = parse_graph.G.runtime
        for q in range(WI_QUERIES):
            q_subject.next(qid=q, t=int(s["q_t"][q]), topic=int(s["q_topic"][q]), text=s["q_text"][q])
        commit_tick(q_subject, lambda: len(qvecs) == WI_QUERIES, "the standing queries' tick", n_commits)
        for c in range(WI_COMMITS):
            for i in np.flatnonzero(s["commit"] == c).tolist():
                subject.next(doc_id=i, t=int(s["t"][i]), topic=int(s["topic"][i]), text=s["text"][i])
            since = dict(rt.stats.node_ns)
            t0 = commit_tick(subject, lambda: True, "a document commit's tick", n_commits)
            record["update_s"].append(_now() - t0)
            record["ops"].append(operator_s(rt, since))
            t0 = _now()
            verify(c)
            record["verify_s"] += _now() - t0

    Idle, feeder, failure = driven_subjects(pw, drive)
    q_subject = Idle()
    t0 = _now()
    emb = SentenceTransformerEmbedder(device=dev)
    embedder_init_s = _now() - t0
    vecs = np.zeros((WI_DOCS, emb.runtime.dim), dtype=np.float32)  # by document id
    docs = pw.io.python.read(feeder, schema=DocSchema, autocommit_duration_ms=None)
    queries = pw.io.python.read(q_subject, schema=QuerySchema, autocommit_duration_ms=None)
    out = wi_pipeline(pw, docs, queries, emb, emb.runtime.dim, {"device": dev.type})
    pw.io.subscribe(out["embedded"], on_change=on_vec(vecs))
    pw.io.subscribe(out["asked"], on_change=on_vec(qvecs))
    pw.io.subscribe(out["pairs"], on_change=on_pair)
    pw.io.subscribe(out["counts"], on_change=on_count)
    pw.io.subscribe(out["windows"], on_change=on_window)
    t_run = _now()
    pw.run()  # raises if an operator recorded an error (a kernel failure included)
    run_s = _now() - t_run
    if failure:
        raise failure[0]
    rt = parse_graph.G.last_runtime
    launches, shapes = bt.block_topk.launches, dict(bt.block_topk.shapes)
    check(rt.stats.ticks == WI_COMMITS + 2, f"{rt.stats.ticks} ticks for {WI_COMMITS + 1} commits")
    check(WI_DOCS - len(entered) == frozen,
          f"{WI_DOCS - len(entered)} documents never entered a window, the oracle froze {frozen}")
    check(launches >= WI_COMMITS and set(shapes) == {(WI_QUERIES, WI_K)},
          f"block_topk launches {launches} by shape {shapes}")
    check(emb.runtime.device.type == "cuda", f"the embedder ran on {emb.runtime.device}")
    upd = [x * 1e3 for x in record["update_s"]]
    by_type = operator_s(rt)
    phase = {
        "phase": "windowed index",
        "nvidia_smi": smi,
        "docs": WI_DOCS,
        "commits": WI_COMMITS,
        "topics": WI_TOPICS,
        "queries": WI_QUERIES,
        "k": WI_K,
        "window": {"tumbling": WI_WINDOW, "delay": WI_DELAY, "cutoff": WI_CUTOFF, "keep_results": False},
        "late_docs": len(s["late"]),
        "frozen_docs": frozen,
        "update_to_visible_ms": {"p50": float(np.percentile(upd, 50)), "max": float(np.max(upd)), "n": len(upd)},
        "first_reply_s": record["first_reply"] - t_run,
        "operator_s": by_type,
        "temporal_operator_s": {k: v for k, v in by_type.items()
                                if k in ("BufferNode", "FreezeNode", "ForgetNode", "IntervalJoinNode")},
        "update_tick_operator_s_p50_commit": record["ops"][WI_COMMITS // 2],
        "index_rows_by_commit": record["rows"],
        "replies_compared": record["replies"],
        "replies_keys_equal_plain": record["replies_exact"],
        "near_ties": record["near_ties"],
        "ticks": rt.stats.ticks,
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "embedder_device": str(emb.runtime.device),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "embedder_init_s": embedder_init_s,
        "run_s": run_s,
        "verify_s": record["verify_s"],
        "phase_s": _now() - t_phase,
    }
    ix = next(e.index for e in rt.execs.values() if isinstance(e, ExternalIndexExec))
    prep, _c2, valid = ix.corpus.prepared_arrays("cosine", bf16=False)
    qs = torch.tensor(np.stack([qvecs[q] for q in sorted(qvecs)]), device=prep.device)
    qs = (qs / qs.norm(dim=-1, keepdim=True)).to(prep.dtype)
    parse_graph.G.clear()
    return phase, {"prep": prep, "valid": valid, "queries": {WI_QUERIES: qs}, "launches": launches,
                   "shapes": shapes}


# --- phase 12: cdc index ------------------------------------------------------

CDC_DOCS = 24576  # rows of the source table before the first transaction
CDC_TXNS = 16
CDC_INSERTS = 512  # per transaction
CDC_EDITS = 256  # rows whose body changes: the old key gets a new vector
CDC_DELETES = 256
CDC_TOPICS = 64
CDC_QUERIES = 256  # standing queries, answered again on every change
CDC_K = WI_K  # 10: wi_plain's top-k is this phase's plain version too
CDC_RESERVED = 1 << 15  # the live rows peak at 24,576 + 16 * 256 = 28,672
CDC_WAIT_S = 120.0


def cdc_stream(seed: int, docs: int, txns: int, inserts: int, edits: int, deletes: int, topics: int,
               queries: int) -> dict:
    """A seeded table of ``docs`` rows (doc_id -> (topic, body), bodies from
    ``synthetic_docs``) and ``txns`` transactions, each inserting ``inserts``
    new rows, changing the body of ``edits`` live rows and deleting
    ``deletes`` others; ``live`` holds the table after each one. Plus
    ``queries`` query texts."""
    rng = np.random.default_rng(seed)
    texts = synthetic_docs(docs + txns * (inserts + edits) + queries, rng)
    table = {i: (int(rng.integers(0, topics)), texts[i]) for i in range(docs)}
    initial, out, lives = dict(table), [], []
    nxt = docs  # the next unused text, and the next doc_id
    next_id = docs
    for _c in range(txns):
        picked = rng.choice(np.array(sorted(table)), size=edits + deletes, replace=False)
        txn = {"insert": [], "edit": [], "delete": []}
        for i in sorted(int(x) for x in picked[:edits]):
            txn["edit"].append((i, table[i][0], table[i][1], texts[nxt]))
            table[i] = (table[i][0], texts[nxt])
            nxt += 1
        for i in sorted(int(x) for x in picked[edits:]):
            txn["delete"].append((i, *table.pop(i)))
        for _j in range(inserts):
            row = (int(rng.integers(0, topics)), texts[nxt])
            txn["insert"].append((next_id, *row))
            table[next_id] = row
            nxt += 1
            next_id += 1
        out.append(txn)
        lives.append(dict(table))
    return {"initial": initial, "txns": out, "live": lives, "q_text": texts[-queries:]}


def cdc_create(path: str, rows: dict) -> None:
    """The source table ``documents(doc_id INTEGER PRIMARY KEY, topic
    INTEGER, body TEXT)`` holding ``rows``."""
    import sqlite3

    conn = sqlite3.connect(path)
    with conn:
        conn.execute("CREATE TABLE documents (doc_id INTEGER PRIMARY KEY, topic INTEGER, body TEXT)")
        conn.executemany("INSERT INTO documents VALUES (?, ?, ?)", [(i, *r) for i, r in sorted(rows.items())])
    conn.close()


def cdc_apply(conn, txn: dict) -> None:
    """One transaction of ``cdc_stream`` on the writer's own connection (the
    reader's ``PRAGMA data_version`` moves only for another connection's
    commits)."""
    with conn:
        conn.executemany("INSERT INTO documents VALUES (?, ?, ?)", txn["insert"])
        conn.executemany("UPDATE documents SET body = ? WHERE doc_id = ?",
                         [(new, i) for i, _t, _old, new in txn["edit"]])
        conn.executemany("DELETE FROM documents WHERE doc_id = ?", [(i,) for i, *_r in txn["delete"]])


def debezium_envelopes(rows: dict | None = None, txn: dict | None = None) -> list[str]:
    """Postgres-dialect Debezium envelopes, one JSON line each: a snapshot
    read (op "r") of ``rows``, or the changes of one transaction (inserts
    "c", body changes "u" with before and after, deletes "d")."""
    def row(i, topic, body):
        return {"doc_id": i, "topic": topic, "body": body}

    def line(op, before, after):
        return json.dumps({"payload": {"before": before, "after": after, "op": op}})

    if rows is not None:
        return [line("r", None, row(i, *r)) for i, r in sorted(rows.items())]
    return ([line("c", None, row(*r)) for r in txn["insert"]]
            + [line("u", row(i, t, old), row(i, t, new)) for i, t, old, new in txn["edit"]]
            + [line("d", row(*r), None) for r in txn["delete"]])


def cdc_publish(folder: str, name: str, lines: list[str]) -> None:
    """A message file written beside the watched folder and renamed into it."""
    tmp = os.path.join(os.path.dirname(folder), f".{name}.tmp")
    with open(tmp, "w") as f:
        f.write("".join(x + "\n" for x in lines))
    os.replace(tmp, os.path.join(folder, name))


def cdc_pipeline(pw, db_path: str, cdc_dir: str, queries, emb, dim: int, knn_kw: dict, reply_db: str) -> dict:
    """A live retrieval index kept in step with a SQL table, as a user writes
    it: ``pw.io.sqlite.read`` streams the ``documents`` table's changes, the
    embedder embeds each body, DataIndex over TpuKnn holds the vectors and
    every query (qid, text) asks the live index for its CDC_K nearest rows;
    the replies (qid, doc_id, score) go back into SQL through
    ``pw.io.sqlite.write``. The table's Debezium change stream in
    ``cdc_dir`` is read into the same graph (``pw.io.debezium``), not
    embedded. Returns the tables: docs, embedded, asked, pairs, changes."""
    from importlib import import_module

    indexing = import_module(pw.__name__ + ".stdlib.indexing")

    class Doc(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        topic: int
        body: str

    docs = pw.io.sqlite.read(db_path, "documents", schema=Doc, mode="streaming")
    embedded = docs.select(docs.doc_id, vec=emb(docs.body))
    knn = indexing.TpuKnn(embedded.vec, dimensions=dim, reserved_space=CDC_RESERVED, **knn_kw)
    asked = queries.select(queries.qid, vec=emb(queries.text))
    pairs = indexing.DataIndex(embedded, knn).query(asked.vec, number_of_matches=CDC_K, collapse_rows=False).select(
        qid=pw.left.qid, doc_id=pw.right.doc_id, score=pw.right._pw_index_reply_score)
    pw.io.sqlite.write(pairs, reply_db, "replies")
    changes = pw.io.debezium.read(input_dir=cdc_dir, schema=Doc)
    return {"docs": docs, "embedded": embedded, "asked": asked, "pairs": pairs, "changes": changes,
            "schema": Doc}


def sqlite_rows(path: str, table: str) -> list[tuple]:
    import sqlite3

    conn = sqlite3.connect(path)
    try:
        return conn.execute(f'SELECT * FROM "{table}"').fetchall()  # noqa: S608
    finally:
        conn.close()


def signed64(key: int) -> int:
    """A row key as ``pw.io.sqlite.write`` stores it: SQLite integers are signed."""
    return key - (1 << 64) if key >= 1 << 63 else key


def cdc_index(dev, smi: str) -> tuple[dict, dict]:
    """A live retrieval index fed by change-data capture, on the card, as a
    user writes it (``cdc_pipeline``): a SQLite table of CDC_DOCS seeded
    documents, streamed by ``pw.io.sqlite.read``; the full-width embedder;
    DataIndex over TpuKnn(device=dev); CDC_QUERIES standing queries from
    pw.io.python, answered again on every change in one block_topk batch;
    the replies written back with ``pw.io.sqlite.write``. A writer with its
    own connection commits CDC_TXNS transactions, and each also goes as
    Debezium envelopes (one file per transaction) into a folder that
    ``pw.io.debezium.read`` reads in the same graph. After every
    transaction: every reply equals the plain top-CDC_K over the live rows
    (up to near ties), no reply names a deleted row, a reply naming a row
    edited in it scores the row by its new body's vector, the index holds
    as many valid rows as the table, and the Debezium table equals the
    SQLite reader's, keys included. After the run: the replies read back
    from SQLite equal the subscribed ones, and a static read of the table
    equals the streaming table's final state."""
    import sqlite3

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.internals.api import ref_scalar
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    _now = time.perf_counter
    t_phase = _now()
    s = cdc_stream(SEED, CDC_DOCS, CDC_TXNS, CDC_INSERTS, CDC_EDITS, CDC_DELETES, CDC_TOPICS, CDC_QUERIES)
    work = tempfile.mkdtemp(prefix="pw_cdc_")
    src_db, reply_db, cdc_dir = (os.path.join(work, n) for n in ("documents.db", "replies.db", "cdc"))
    os.makedirs(cdc_dir)
    cdc_create(src_db, s["initial"])
    cdc_publish(cdc_dir, "000000.jsonl", debezium_envelopes(rows=s["initial"]))
    parse_graph.G.clear()
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    torch.cuda.reset_peak_memory_stats()

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        text: str

    def keyed(rows: dict) -> dict[int, tuple]:
        return {int(ref_scalar(i)): (i, *r) for i, r in rows.items()}

    lock = threading.Lock()
    doc_state: dict[int, tuple] = {}
    cdc_state: dict[int, tuple] = {}
    pair_state: dict[int, tuple] = {}
    qvecs: dict[int, np.ndarray] = {}
    # the state each source's table must reach, and the tick in which it did
    start = keyed(s["initial"])
    expect = {"docs": {"rows": start, "tick": None}, "cdc": {"rows": start, "tick": None}}
    record: dict = {"update_s": [], "ops": [], "rows": [], "capacity": [], "writer_s": [], "near_ties": 0,
                    "replies_exact": 0, "replies": 0, "edited_in_replies": 0, "first_reply": None,
                    "verify_s": 0.0, "poll_s": [], "scan_s": []}

    def state_of(into: dict, goal: dict):
        def on_change(key, row, time, is_addition):
            vals = (row["doc_id"], row["topic"], row["body"])
            with lock:
                if is_addition:
                    into[int(key)] = vals
                elif into.get(int(key)) == vals:
                    del into[int(key)]

        def on_time_end(_t):
            with lock:
                if goal["tick"] is None and into == goal["rows"]:
                    goal["tick"] = parse_graph.G.runtime.stats.ticks  # the tick in progress

        return on_change, on_time_end

    def on_vec(key, row, time, is_addition):
        if is_addition:  # an edit's new vector, whatever the order of its -1 and +1
            if "doc_id" in row:
                vecs[row["doc_id"]] = np.asarray(row["vec"], dtype=np.float32)
            else:
                qvecs[row["qid"]] = np.asarray(row["vec"], dtype=np.float32)

    def on_pair(key, row, time, is_addition):
        if record["first_reply"] is None and is_addition and row["doc_id"] is not None:
            record["first_reply"] = _now()
        vals = (row["qid"], row["doc_id"], row["score"])
        with lock:
            if is_addition:
                pair_state[int(key)] = vals
            elif pair_state.get(int(key)) == vals:
                del pair_state[int(key)]

    def ended(goal: dict) -> bool:
        return goal["tick"] is not None and parse_graph.G.runtime.stats.ticks > goal["tick"]

    def verify(c: int, edited: dict) -> None:
        live = s["live"][c] if c >= 0 else s["initial"]
        rt = parse_graph.G.runtime
        ix = next(e.index for e in rt.execs.values() if isinstance(e, ExternalIndexExec))
        _prep, _c2, valid = ix.corpus.prepared_arrays("cosine", bf16=False)
        check(valid.device.type == "cuda", f"the index's corpus is on {valid.device}")
        check(int(valid.sum()) == len(live),
              f"transaction {c}: the index holds {int(valid.sum())} valid rows, the table {len(live)}")
        record["rows"].append(len(live))
        record["capacity"].append(ix.corpus.capacity)
        with lock:
            check(doc_state == cdc_state, f"transaction {c}: the Debezium table differs from the SQLite reader's")
            pairs = list(pair_state.values())
        replies: dict[int, list] = {q: [] for q in qvecs}
        for q, d, sc in pairs:
            check(d is not None, f"transaction {c}: query {q} has no reply")
            replies[q].append((d, sc))
        dead = {d for _q, d, _s in pairs} - set(live)
        check(not dead, f"transaction {c}: {len(dead)} deleted rows are in the replies")
        plain = wi_plain(vecs, qvecs, np.array(sorted(live)), dev)
        for q, got in replies.items():
            got = tuple(sorted(got, key=lambda p: (-p[1], p[0])))
            check(same_up_to_near_ties(got, plain[q], F32_TOL),
                  f"transaction {c}: query {q}'s reply {got} differs from the plain top-{CDC_K} {plain[q]}")
            exact = [d for d, _s in got] == [d for d, _s in plain[q]]
            record["replies_exact"] += exact
            record["near_ties"] += not exact
            record["replies"] += 1
            qn = qvecs[q] / np.linalg.norm(qvecs[q])
            for d, sc in got:
                if d in edited:  # scored by the new body's vector, not the old one's
                    old, new = (v / np.linalg.norm(v) for v in (edited[d], vecs[d]))
                    s_old, s_new = float(qn @ old) - 1.0, float(qn @ new) - 1.0
                    check(abs(sc - s_new) <= F32_TOL and not np.array_equal(old, new),
                          f"transaction {c}: edited row {d} scores {sc}; its new body {s_new}, its old {s_old}")
                    record["edited_in_replies"] += 1

    def drive(q_subject) -> None:
        rt = parse_graph.G.runtime
        try:
            for q, text in enumerate(s["q_text"]):
                q_subject.next(qid=q, text=text)
            q_subject.commit()
            wait_until(lambda: len(qvecs) == CDC_QUERIES and all(ended(g) for g in expect.values()),
                       "the initial table in both sources", CDC_WAIT_S)
            wait_until(lambda: sum(d is not None for _q, d, _s in list(pair_state.values())) == CDC_QUERIES * CDC_K,
                       "the standing queries' replies", CDC_WAIT_S)
            verify(-1, {})
            writer = sqlite3.connect(src_db)  # the writer's own connection
            for c, txn in enumerate(s["txns"]):
                edited = {i: vecs[i].copy() for i, *_r in txn["edit"]}
                goal = keyed(s["live"][c])
                with lock:
                    for g in expect.values():
                        g.update(rows=goal, tick=None)
                since = dict(rt.stats.node_ns)
                t0 = _now()
                cdc_apply(writer, txn)
                cdc_publish(cdc_dir, f"{c + 1:06d}.jsonl", debezium_envelopes(txn=txn))
                # commit -> the end of the tick that answered every standing query again
                wait_until(lambda: ended(expect["docs"]), f"transaction {c} in the replies", CDC_WAIT_S)
                record["update_s"].append(_now() - t0)
                wait_until(lambda: ended(expect["cdc"]), f"transaction {c} in the Debezium table", CDC_WAIT_S)
                record["ops"].append(operator_s(rt, since))
                wid = record["writer_node"].id
                record["writer_s"].append((rt.stats.node_ns.get(wid, 0) - since.get(wid, 0)) / 1e9)
                t1 = _now()
                verify(c, edited)
                record["verify_s"] += _now() - t1
            writer.close()
        finally:
            rt.stop()  # the SQLite and Debezium sources never end on their own

    Idle, feeder, failure = driven_subjects(pw, drive)
    t0 = _now()
    emb = SentenceTransformerEmbedder(device=dev)
    embedder_init_s = _now() - t0
    vecs = np.zeros((CDC_DOCS + CDC_TXNS * CDC_INSERTS, emb.runtime.dim), dtype=np.float32)  # by doc_id
    queries = pw.io.python.read(feeder, schema=QuerySchema, autocommit_duration_ms=None)
    out = cdc_pipeline(pw, src_db, cdc_dir, queries, emb, emb.runtime.dim, {"device": dev.type}, reply_db)
    record["writer_node"] = parse_graph.G.outputs[-1]  # pw.io.sqlite.write's
    for table, into, goal in ((out["docs"], doc_state, expect["docs"]), (out["changes"], cdc_state, expect["cdc"])):
        on_change, on_time_end = state_of(into, goal)
        pw.io.subscribe(table, on_change=on_change, on_time_end=on_time_end)
    pw.io.subscribe(out["embedded"], on_change=on_vec)
    pw.io.subscribe(out["asked"], on_change=on_vec)
    pw.io.subscribe(out["pairs"], on_change=on_pair)
    # the host layers of the sources: the reader's snapshot and diff per
    # change, the Debezium folder scan per file read
    reader, scanner = out["docs"]._node.source, out["changes"]._node.source
    poll, scan = reader._poll, scanner._scan

    def timed_poll(conn):
        sig, t = reader._data_version, _now()
        poll(conn)
        if reader._data_version != sig:
            record["poll_s"].append(_now() - t)

    def timed_scan():
        n, t = sum(scanner._offsets.values()), _now()
        scan()
        if sum(scanner._offsets.values()) != n:
            record["scan_s"].append(_now() - t)

    reader._poll, scanner._scan = timed_poll, timed_scan
    t_run = _now()
    pw.run()  # raises if an operator recorded an error (a kernel failure included)
    run_s = _now() - t_run
    if failure:
        raise failure[0]
    rt = parse_graph.G.last_runtime
    launches, shapes = bt.block_topk.launches, dict(bt.block_topk.shapes)
    check(launches >= CDC_TXNS and set(shapes) == {(CDC_QUERIES, CDC_K)},
          f"block_topk launches {launches} by shape {shapes}")
    check(emb.runtime.device.type == "cuda", f"the embedder ran on {emb.runtime.device}")
    check(len(record["update_s"]) == CDC_TXNS, f"{len(record['update_s'])} of {CDC_TXNS} transactions ran")
    # the replies as pw.io.sqlite.write left them: __key__ is the row key's signed form
    written = {key: (q, d, sc) for q, d, sc, key in sqlite_rows(reply_db, "replies")}
    final = {signed64(k): v for k, v in pair_state.items()}
    check(set(written) == set(final), f"{len(written)} replies read back from SQLite, {len(final)} subscribed; "
          f"{len(set(final) - set(written))} missing, {len(set(written) - set(final))} unexpected")
    check(all(written[k][:2] == v[:2] and abs(written[k][2] - v[2]) <= F32_TOL for k, v in final.items()),
          "the replies read back from SQLite differ from the subscribed ones")
    ix = next(e.index for e in rt.execs.values() if isinstance(e, ExternalIndexExec))
    prep, _c2, valid = ix.corpus.prepared_arrays("cosine", bf16=False)
    qs = torch.tensor(np.stack([qvecs[q] for q in sorted(qvecs)]), device=prep.device)
    qs = (qs / qs.norm(dim=-1, keepdim=True)).to(prep.dtype)
    parse_graph.G.clear()
    static = pw.io.sqlite.read(src_db, "documents", schema=out["schema"], mode="static")
    keys, cols = pw.debug.table_to_dicts(static)
    got = {int(k): (cols["doc_id"][k], cols["topic"][k], cols["body"][k]) for k in keys}
    check(got == doc_state, f"a static read of the table ({len(got)} rows) differs from the streaming table's "
          f"final state ({len(doc_state)} rows)")
    parse_graph.G.clear()
    upd = [x * 1e3 for x in record["update_s"]]
    by_type = operator_s(rt)
    phase = {
        "phase": "cdc index",
        "nvidia_smi": smi,
        "docs": CDC_DOCS,
        "transactions": CDC_TXNS,
        "per_transaction": {"inserts": CDC_INSERTS, "edits": CDC_EDITS, "deletes": CDC_DELETES},
        "queries": CDC_QUERIES,
        "k": CDC_K,
        "update_to_visible_ms": {"p50": float(np.percentile(upd, 50)), "max": float(np.max(upd)), "n": len(upd)},
        "first_reply_s": record["first_reply"] - t_run,
        "sqlite_poll_s": {"p50": float(np.percentile(record["poll_s"], 50)), "max": float(np.max(record["poll_s"])),
                          "n": len(record["poll_s"])},
        "debezium_scan_s": {"p50": float(np.percentile(record["scan_s"], 50)),
                            "max": float(np.max(record["scan_s"])), "n": len(record["scan_s"])},
        "sqlite_writer_s_by_transaction": record["writer_s"],
        "operator_s": by_type,
        "update_tick_operator_s_p50_transaction": record["ops"][CDC_TXNS // 2],
        "index_rows_by_transaction": record["rows"],
        "index_capacity_by_transaction": record["capacity"],
        "replies_compared": record["replies"],
        "replies_keys_equal_plain": record["replies_exact"],
        "near_ties": record["near_ties"],
        "edited_rows_in_replies": record["edited_in_replies"],
        "replies_written": len(written),
        "ticks": rt.stats.ticks,
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "embedder_device": str(emb.runtime.device),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "embedder_init_s": embedder_init_s,
        "run_s": run_s,
        "verify_s": record["verify_s"],
        "phase_s": _now() - t_phase,
    }
    shutil.rmtree(work, ignore_errors=True)
    return phase, {"prep": prep, "valid": valid, "queries": {CDC_QUERIES: qs}, "launches": launches,
                   "shapes": shapes}


# --- phase 13: compiled ticks -------------------------------------------------

CT_ROWS = 1 << 20
CT_COMMITS = 16  # one tick each, of CT_ROWS // CT_COMMITS rows, alternating the two subjects
CT_TOPICS = 64
CT_SURVIVORS = 1 << 15  # rows that pass the filter in all: the index's reservation
CT_QUERIES = 256  # standing queries, answered again on every commit
CT_K = WI_K
CT_T0 = 1_700_000_000  # event times: one day of seconds from here
CT_SPAN = 86_400
CT_TMID = CT_T0 + CT_SPAN // 2
# the chain's floats against numpy's: the same float64 operations, one per
# lowered node, so they come out equal; relative, the bound the check holds
CT_FLOAT_TOL = 1e-12
# the groupby's float partials: the card adds a group's scores in the order
# its atomics land, numpy in row order; relative
CT_PARTIALS_TOL = 1e-9
CT_WAIT_S = 120.0
# the card's host link, one direction (PCIe Gen5 x16): the copies' bound
CT_LINK_BYTES_PER_S = 64e9
CT_ENV = ("PATHWAY_COMPILED_TICK", "PATHWAY_COMPILED_DEVICE", "PATHWAY_COMPILED_GROUPBY",
          "PATHWAY_COMPILED_MIN_ROWS")


def ct_score(flags: np.ndarray, quality: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """The chain's score in numpy, operation by operation as ``ct_chain``
    writes it."""
    return np.where((flags & 4) == 4, quality * 1.25, quality) - np.abs(ts - CT_TMID).astype(np.float64) * 1e-7


def ct_bucket(quality: np.ndarray, topic: np.ndarray) -> np.ndarray:
    return (quality * 16.0).astype(np.int64) + topic * 16


def ct_stream(seed: int, rows: int, commits: int, topics: int, survivors: int, queries: int) -> dict:
    """A seeded event feed: doc_id (the primary key), topic, ts, quality,
    flags and text per row; the score threshold that lets exactly
    ``survivors`` rows through the filter (halfway between two scores);
    the passing rows carry ``synthetic_docs`` texts, the others a
    placeholder. Plus ``queries`` query texts."""
    rng = np.random.default_rng(seed)
    cols = {
        "doc_id": np.arange(rows, dtype=np.int64),
        "topic": rng.integers(0, topics, rows),
        "ts": CT_T0 + rng.integers(0, CT_SPAN, rows),
        "quality": rng.random(rows),
        "flags": rng.integers(0, 16, rows),
    }
    score = ct_score(cols["flags"], cols["quality"], cols["ts"])
    eligible = (cols["flags"] & 3) == 3
    top = np.sort(score[eligible])[::-1]
    threshold = float((top[survivors - 1] + top[survivors]) / 2)
    passed = eligible & (score > threshold)
    texts = synthetic_docs(survivors + queries, rng)
    text = np.full(rows, "n/a", dtype=object)
    text[passed] = texts[:survivors]
    return {"cols": {**cols, "text": text}, "threshold": threshold, "passed": passed, "score": score,
            "bucket": ct_bucket(cols["quality"], cols["topic"]),
            "commit": np.arange(rows) // (rows // commits), "q_text": texts[survivors:]}


def ct_chain(pw, a, b, threshold: float) -> dict:
    """The compiled chain as a user writes it: two feeds of disjoint keys
    concatenated (``concat`` after ``promise_are_pairwise_disjoint``, so a
    ConcatNode heads the segment: ``concat_reindex`` would derive Pointer
    keys), a select computing a float score and an int bucket, a filter on
    the flags and the score, a select carrying the survivors' columns, and
    groupby(topic).reduce(count, sum, avg) over them. Returns the tables."""
    pw.universes.promise_are_pairwise_disjoint(a, b)
    feed = a.concat(b)
    scored = feed.select(
        feed.doc_id, feed.topic, feed.text, feed.flags,
        score=pw.if_else((feed.flags & 4) == 4, feed.quality * 1.25, feed.quality)
        - pw.cast(float, abs(feed.ts - CT_TMID)) * 1e-7,
        bucket=pw.cast(int, feed.quality * 16.0) + feed.topic * 16,
    )
    kept = scored.filter(((scored.flags & 3) == 3) & (scored.score > threshold))
    survivors = kept.select(kept.doc_id, kept.topic, kept.bucket, kept.score, kept.text)
    stats = survivors.groupby(survivors.topic).reduce(
        survivors.topic, n=pw.reducers.count(), total=pw.reducers.sum(survivors.bucket),
        mean=pw.reducers.avg(survivors.score))
    return {"feed": feed, "scored": scored, "kept": kept, "survivors": survivors, "stats": stats}


def ct_expected(s: dict, c: int) -> tuple[dict, dict]:
    """numpy's survivors of commit ``c`` (doc_id -> (topic, bucket, score,
    text)) and the groupby over commits 0..c (topic -> (n, total, mean))."""
    idx = np.flatnonzero(s["passed"])
    commit, topic = s["commit"][idx], s["cols"]["topic"][idx]
    now = idx[commit == c]
    surv = {int(i): (int(s["cols"]["topic"][i]), int(s["bucket"][i]), float(s["score"][i]), s["cols"]["text"][i])
            for i in now}
    upto = commit <= c
    t = topic[upto]
    n = np.bincount(t, minlength=CT_TOPICS)
    total = np.zeros(CT_TOPICS, dtype=np.int64)
    np.add.at(total, t, s["bucket"][idx][upto])
    sums = np.bincount(t, weights=s["score"][idx][upto], minlength=CT_TOPICS)
    stats = {int(k): (int(n[k]), int(total[k]), float(sums[k] / n[k])) for k in np.flatnonzero(n)}
    return surv, stats


def ct_feed(s: dict, c: int, subject) -> float:
    """Push commit ``c``'s rows into ``subject`` (one ``next()`` each); the
    seconds it took."""
    t0 = time.perf_counter()
    lo, hi = np.flatnonzero(s["commit"] == c)[[0, -1]]
    cols = {k: v[lo:hi + 1].tolist() for k, v in s["cols"].items()}
    for d, tp, ts, q, f, tx in zip(cols["doc_id"], cols["topic"], cols["ts"], cols["quality"], cols["flags"],
                                   cols["text"]):
        subject.next(doc_id=d, topic=tp, ts=ts, quality=q, flags=f, text=tx)
    return time.perf_counter() - t0


def ct_run(pw, s: dict, with_index: bool, emb, dev, on_commit) -> dict:
    """Build the chain (and, ``with_index``, the live index behind it) in a
    fresh graph and drive it: the standing queries' commit, then
    CT_COMMITS commits alternating the two subjects, each one tick;
    ``on_commit(c, rt, out, record)`` runs after each commit's tick. Returns
    the tables, the runtime and the record."""
    from importlib import import_module

    from pathway_tpu_torch.internals import parse_graph

    indexing = import_module(pw.__name__ + ".stdlib.indexing")

    class RowSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        topic: int
        ts: int
        quality: float
        flags: int
        text: str

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        text: str

    parse_graph.G.clear()
    record: dict = {"update_s": [], "next_s": [], "chain_s": [], "ticks_before": 0}
    n_commits = [0]

    def drive(subject_a) -> None:
        rt = parse_graph.G.runtime
        if with_index:
            for q, text in enumerate(s["q_text"]):
                q_subject.next(qid=q, text=text)
            commit_tick(q_subject, lambda: len(record["qvecs"]) == CT_QUERIES, "the standing queries' tick",
                        n_commits)
        record["ticks_before"] = rt.stats.ticks
        chain = [t._node.id for t in (out["feed"], out["scored"], out["kept"], out["survivors"])]
        for c in range(CT_COMMITS):
            subject = subject_a if c % 2 == 0 else subject_b
            record["next_s"].append(ct_feed(s, c, subject))
            since = dict(rt.stats.node_ns)
            t0 = commit_tick(subject, lambda: True, f"commit {c}'s tick", n_commits)
            record["update_s"].append(time.perf_counter() - t0)
            record["chain_s"].append(sum(rt.stats.node_ns.get(i, 0) - since.get(i, 0) for i in chain) / 1e9)
            on_commit(c, rt, out, record)

    Idle, feeder, failure = driven_subjects(pw, drive)
    subject_b, q_subject = Idle(), Idle()
    a = pw.io.python.read(feeder, schema=RowSchema, autocommit_duration_ms=None)
    b = pw.io.python.read(subject_b, schema=RowSchema, autocommit_duration_ms=None)
    out = ct_chain(pw, a, b, s["threshold"])
    if with_index:
        record["qvecs"] = {}
        survivors = out["survivors"]
        out["embedded"] = survivors.select(survivors.doc_id, vec=emb(survivors.text))
        knn = indexing.TpuKnn(out["embedded"].vec, dimensions=emb.runtime.dim, reserved_space=CT_SURVIVORS,
                              device=dev.type)
        queries = pw.io.python.read(q_subject, schema=QuerySchema, autocommit_duration_ms=None)
        out["asked"] = queries.select(queries.qid, vec=emb(queries.text))
        out["pairs"] = indexing.DataIndex(out["embedded"], knn).query(
            out["asked"].vec, number_of_matches=CT_K, collapse_rows=False).select(
            qid=pw.left.qid, doc_id=pw.right.doc_id, score=pw.right._pw_index_reply_score)
    return {"out": out, "record": record, "failure": failure}


def compiled_ticks(dev, smi: str, rate: float, earlier: dict) -> tuple[dict, dict]:
    """Compiled ticks on the card, as a user turns them on
    (PATHWAY_COMPILED_TICK=1, PATHWAY_COMPILED_DEVICE=cuda): CT_ROWS
    seeded rows in CT_COMMITS commits through two pw.io.python subjects
    concatenated into one table; ``ct_chain``'s select -> filter -> select
    runs as one compiled segment (torch ops on the card) and its groupby's
    partials through ``semigroup_partials`` on the card; the survivors'
    texts go through the full-width embedder into TpuKnn(reserved_space=
    CT_SURVIVORS), which answers CT_QUERIES standing queries again after
    every commit with block_topk. After every commit: the chain's output
    equals numpy's (``ct_expected``: keys, diffs and ints exact, floats
    within CT_FLOAT_TOL), the groupby's ints exact and its means within
    CT_PARTIALS_TOL, every reply equals the plain top-CT_K over the
    survivors so far (up to near ties), the index's valid rows equal the
    survivors so far, and the segment compiled every chain tick with no
    fallback. Then the same commits with PATHWAY_COMPILED_TICK=0 (the chain
    and the groupby only) for the interpreter's seconds, and the segment's
    program and the partials timed alone against their bounds."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import compile as ct_compile
    from pathway_tpu_torch.engine.batch import DiffBatch
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import api, native, parse_graph
    from pathway_tpu_torch.observability import REGISTRY
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    _now = time.perf_counter
    t_phase = _now()
    nat = native.get_native()
    check(nat is not None, f"the native hasher did not build or load: {native.build_log}")
    s = ct_stream(SEED + 23, CT_ROWS, CT_COMMITS, CT_TOPICS, CT_SURVIVORS, CT_QUERIES)
    per = CT_ROWS // CT_COMMITS
    # the feed's row keys, native and pure Python, on one commit
    ids = s["cols"]["doc_id"][:per]
    t0 = _now()
    keys_native = api.ref_scalars_columns([ids], per)
    native_s = _now() - t0
    saved_native = api._native_mod
    api._native_mod = None
    try:
        t0 = _now()
        keys_python = api.ref_scalars_columns([ids], per)
        python_s = _now() - t0
    finally:
        api._native_mod = saved_native
    check(np.array_equal(keys_native, keys_python), "the native and pure-Python keys of one commit differ")
    saved_env = {k: os.environ.get(k) for k in CT_ENV}
    for k in CT_ENV:
        os.environ.pop(k, None)
    os.environ.update(PATHWAY_COMPILED_TICK="1", PATHWAY_COMPILED_DEVICE=dev.type)
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    partial_calls0 = ct_compile.semigroup_partials.calls
    metrics0 = REGISTRY.render()
    torch.cuda.reset_peak_memory_stats()
    t0 = _now()
    emb = SentenceTransformerEmbedder(device=dev)
    embedder_init_s = _now() - t0
    vecs = np.zeros((CT_SURVIVORS, emb.runtime.dim), dtype=np.float32)  # by survivor rank
    rank_of = {int(d): r for r, d in enumerate(np.flatnonzero(s["passed"]).tolist())}
    lock = threading.Lock()
    surv_rows: list = []
    stat_state: dict[int, tuple] = {}
    pair_state: dict[int, tuple] = {}
    checks = {"rows": 0, "floats_bitwise": 0, "replies": 0, "replies_exact": 0, "near_ties": 0,
              "index_rows": [], "verify_s": 0.0, "first_reply": None}

    def on_surv(key, row, time, is_addition):
        with lock:
            surv_rows.append((int(key), is_addition, row["doc_id"], row["topic"], row["bucket"], row["score"],
                              row["text"]))

    def on_stat(key, row, time, is_addition):
        vals = (row["n"], row["total"], row["mean"])
        with lock:
            if is_addition:
                stat_state[row["topic"]] = vals
            elif stat_state.get(row["topic"]) == vals:
                del stat_state[row["topic"]]

    def on_vec(key, row, time, is_addition):
        if is_addition:
            if "doc_id" in row:
                vecs[rank_of[row["doc_id"]]] = np.asarray(row["vec"], dtype=np.float32)
            else:
                run["record"]["qvecs"][row["qid"]] = np.asarray(row["vec"], dtype=np.float32)

    def on_pair(key, row, time, is_addition):
        if checks["first_reply"] is None and is_addition and row["doc_id"] is not None:
            checks["first_reply"] = _now()
        vals = (row["qid"], row["doc_id"], row["score"])
        with lock:
            if is_addition:
                pair_state[int(key)] = vals
            elif pair_state.get(int(key)) == vals:
                del pair_state[int(key)]

    def check_chain(c: int, rows: list, stats: dict) -> None:
        want, want_stats = ct_expected(s, c)
        check(len(rows) == len(want) and all(add for _k, add, *_r in rows),
              f"commit {c}: the chain emitted {len(rows)} rows, numpy keeps {len(want)}")
        for key, _add, d, topic, bucket, score, text in rows:
            w = want.get(d)
            check(w is not None and key == int(api.ref_scalar(d)), f"commit {c}: row {d} (key {key}) is not numpy's")
            check((topic, bucket, text) == (w[0], w[1], w[3]), f"commit {c}: row {d} {(topic, bucket)} vs {w[:2]}")
            check(abs(score - w[2]) <= CT_FLOAT_TOL * abs(w[2]), f"commit {c}: row {d} scores {score}, numpy {w[2]}")
            checks["floats_bitwise"] += score == w[2]
        checks["rows"] += len(rows)
        check(set(stats) == set(want_stats), f"commit {c}: the groupby's topics differ from numpy's")
        for t, (n, total, mean) in stats.items():
            wn, wt, wm = want_stats[t]
            check((n, total) == (wn, wt), f"commit {c}: topic {t} counts {(n, total)}, numpy {(wn, wt)}")
            check(abs(mean - wm) <= CT_PARTIALS_TOL * abs(wm), f"commit {c}: topic {t} mean {mean}, numpy {wm}")

    def on_commit(c: int, rt, out, record) -> None:
        t1 = _now()
        with lock:
            rows, stats, pairs = list(surv_rows), dict(stat_state), list(pair_state.values())
            surv_rows.clear()
        check_chain(c, rows, stats)
        seg = rt.compiled_plan.by_tail[out["survivors"]._node.id]
        check(seg.compiled_ticks == c + 1 and seg.fallback_ticks == 0,
              f"commit {c}: the segment compiled {seg.compiled_ticks} ticks, fell back {seg.fallback_ticks}")
        upto = np.flatnonzero(s["passed"] & (s["commit"] <= c))
        live = np.array([rank_of[int(d)] for d in upto])
        ix = next(e.index for e in rt.execs.values() if isinstance(e, ExternalIndexExec))
        _prep, _c2, valid = ix.corpus.prepared_arrays("cosine", bf16=False)
        check(valid.device.type == "cuda", f"the index's corpus is on {valid.device}")
        check(int(valid.sum()) == len(live), f"commit {c}: the index holds {int(valid.sum())} rows, {len(live)} survive")
        checks["index_rows"].append(len(live))
        qvecs = record["qvecs"]
        replies: dict[int, list] = {q: [] for q in qvecs}
        for q, d, sc in pairs:
            check(d is not None, f"commit {c}: query {q} has no reply")
            replies[q].append((rank_of[d], sc))
        plain = wi_plain(vecs, qvecs, live, dev)
        for q, got in replies.items():
            got = tuple(sorted(got, key=lambda p: (-p[1], p[0])))
            check(same_up_to_near_ties(got, plain[q], F32_TOL),
                  f"commit {c}: query {q}'s reply {got} differs from the plain top-{CT_K} {plain[q]}")
            exact = [d for d, _s in got] == [d for d, _s in plain[q]]
            checks["replies_exact"] += exact
            checks["near_ties"] += not exact
            checks["replies"] += 1
        checks["verify_s"] += _now() - t1

    try:
        run = ct_run(pw, s, True, emb, dev, on_commit)
        out = run["out"]
        pw.io.subscribe(out["survivors"], on_change=on_surv)
        pw.io.subscribe(out["stats"], on_change=on_stat)
        pw.io.subscribe(out["embedded"], on_change=on_vec)
        pw.io.subscribe(out["asked"], on_change=on_vec)
        pw.io.subscribe(out["pairs"], on_change=on_pair)
        t_run = _now()
        pw.run()  # raises if an operator recorded an error (a device fault included)
        run_s = _now() - t_run
        if run["failure"]:
            raise run["failure"][0]
        rt, rec = parse_graph.G.last_runtime, run["record"]
        launches, shapes = bt.block_topk.launches, dict(bt.block_topk.shapes)
        partial_calls = ct_compile.semigroup_partials.calls - partial_calls0
        metrics1 = REGISTRY.render()
        check(len(rec["update_s"]) == CT_COMMITS, f"{len(rec['update_s'])} of {CT_COMMITS} commits ran")
        check(rt.stats.ticks == rec["ticks_before"] + CT_COMMITS + 1,
              f"{rt.stats.ticks - rec['ticks_before']} ticks for {CT_COMMITS} commits")
        segs = rt.compiled_plan.segments
        seg = rt.compiled_plan.by_tail[out["survivors"]._node.id]
        check(seg.concat_head and seg.device.type == "cuda", f"the segment's head {seg.head}, device {seg.device}")
        check([n.id for n in seg.nodes] == [t._node.id for t in (out["feed"], out["scored"], out["kept"],
                                                                  out["survivors"])],
              f"the segment holds {seg.nodes}")
        check(seg.fallback_ticks == 0 and not seg._journaled_reasons,
              f"the chain's segment fell back ({seg._journaled_reasons})")
        seg_ticks = (seg.compiled_ticks, seg.fallback_ticks)  # before the timing below adds its own
        # every other segment's fallbacks, by reason: DataIndex's query
        # prep (the query vector passed through and a constant k) plans as
        # a segment, as in the reference, and can never lower
        # ("constant-only computation")
        fallbacks = {r: series(metrics1, "pathway_engine_compile_fallbacks_total", reason=r)
                     - series(metrics0, "pathway_engine_compile_fallbacks_total", reason=r)
                     for x in segs for r in x._journaled_reasons}
        other = [{"nodes": [type(n).__name__ for n in x.nodes], "columns": list(x.tail.column_names),
                  "compiled_ticks": x.compiled_ticks, "fallback_ticks": x.fallback_ticks,
                  "reasons": sorted(x._journaled_reasons)} for x in segs if x is not seg]
        check(partial_calls == CT_COMMITS, f"the groupby's partials ran {partial_calls} times on the card")
        check(checks["rows"] == CT_SURVIVORS, f"{checks['rows']} rows survived, numpy keeps {CT_SURVIVORS}")
        check(launches >= CT_COMMITS and set(shapes) == {(CT_QUERIES, CT_K)},
              f"block_topk launches {launches} by shape {shapes}")
        check(emb.runtime.device.type == "cuda", f"the embedder ran on {emb.runtime.device}")
        compiled_stats = dict(stat_state)
        ix = next(e.index for e in rt.execs.values() if isinstance(e, ExternalIndexExec))
        prep, _c2, valid = ix.corpus.prepared_arrays("cosine", bf16=False)
        qvecs = rec["qvecs"]
        qs = torch.tensor(np.stack([qvecs[q] for q in sorted(qvecs)]), device=prep.device)
        qs = (qs / qs.norm(dim=-1, keepdim=True)).to(prep.dtype)
        peak = torch.cuda.max_memory_allocated()

        # the segment's program and the partials alone, on one commit's tick
        head = {c: s["cols"][c][:per] for c in seg.external_cols}
        batch = DiffBatch(keys_native, np.ones(per, dtype=np.int64), head)
        first = np.flatnonzero(s["passed"][:per])
        topics, codes = np.unique(s["cols"]["topic"][first], return_inverse=True)
        codes, nu = codes.astype(np.int64), len(topics)
        p_args = [None, s["bucket"][first], s["score"][first]]
        p_diffs = np.ones(len(first), dtype=np.int64)

        def host_ms(fn, reps=10) -> float:
            fn()
            torch.cuda.synchronize()
            t0 = _now()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (_now() - t0) / reps * 1e3

        def run_seg():
            return seg._run_compiled(batch)

        seg_ms = host_ms(run_seg)
        seg_times = device_times(run_seg, reps=10)
        interp_ms = host_ms(lambda: seg._interpret(0, [[batch], []]), reps=3)
        part_ms = host_ms(lambda: ct_compile.semigroup_partials(codes, p_diffs, p_args, nu))

        def host_partials():  # GroupByExec's np.add.at path on the same inputs
            counts = np.zeros(nu, dtype=np.int64)
            np.add.at(counts, codes, p_diffs)
            for a in p_args[1:]:
                part = np.zeros(nu, dtype=a.dtype)
                np.add.at(part, codes, a * p_diffs)

        host_part_ms = host_ms(host_partials)
        part_times = device_times(lambda: ct_compile.semigroup_partials(codes, p_diffs, p_args, nu), reps=10)
        got = seg._run_compiled(batch)[0]
        check(np.array_equal(got.columns["bucket"], s["bucket"][first])
              and np.allclose(got.columns["score"], s["score"][first], rtol=CT_FLOAT_TOL, atol=0),
              "the timed program's output differs from numpy's")
        prog = next(v for v in seg._cache.values() if v is not seg._FALLBACK)
        dtypes = {c: head[c].dtype for c in head}
        in_bytes = per * sum(dtypes[c].itemsize for c in prog.in_cols)
        out_bytes = per * prog.out_row_bytes
        nb, gb = ct_compile.row_bucket(len(first)), ct_compile.row_bucket(nu)
        p_in, p_out = nb * 8 * 4, gb * 8 * 3  # codes, diffs, 2 args; count and 2 partials

        def dev_split(times):
            """(device ms, copy ms, kernel launches) per call of 10 profiled."""
            if times is None:
                return None, None, None
            copy = sum(ms for k, (_n, ms) in times.items() if "Memcpy" in k) / 10
            launches = sum(n for k, (n, _ms) in times.items() if "Memcpy" not in k) / 10
            return sum(ms for _n, ms in times.values()) / 10 - copy, copy, launches

        seg_dev, seg_copy, seg_launches = dev_split(seg_times)
        part_dev, part_copy, part_launches = dev_split(part_times)
        device_ops = [
            {"name": "compiled segment (select -> filter -> select)", "rows": per, "in_cols": prog.in_cols,
             "ops_per_row": prog.n_ops, "ms": seg_ms, "device_ms": seg_dev, "copy_ms": seg_copy,
             "launches_per_call": seg_launches,
             "bytes": in_bytes + out_bytes, "bound_ms": (in_bytes + out_bytes) / rate * 1e3,
             "copy_bound_ms": (in_bytes + out_bytes) / CT_LINK_BYTES_PER_S * 1e3,
             "interpreter_ms": interp_ms, "kernels": seg_times},
            {"name": "semigroup_partials (count, sum, avg)", "rows": len(first), "groups": nu, "ms": part_ms,
             "device_ms": part_dev, "copy_ms": part_copy, "launches_per_call": part_launches,
             "interpreter_ms": host_part_ms, "bytes": p_in + p_out,
             "bound_ms": (p_in + p_out) / rate * 1e3, "copy_bound_ms": (p_in + p_out) / CT_LINK_BYTES_PER_S * 1e3,
             "kernels": part_times},
        ]
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    # the same commits on the interpreter: the chain and the groupby only
    stat_state.clear()
    surv_rows.clear()
    interp = ct_run(pw, s, False, None, dev, lambda c, rt, out, record: None)
    pw.io.subscribe(interp["out"]["survivors"], on_change=on_surv)
    pw.io.subscribe(interp["out"]["stats"], on_change=on_stat)
    pw.run()
    if interp["failure"]:
        raise interp["failure"][0]
    check(parse_graph.G.last_runtime.compiled_plan is None, "the interpreted run planned segments")
    check(len(surv_rows) == CT_SURVIVORS, f"the interpreter kept {len(surv_rows)} rows")
    check(set(stat_state) == set(compiled_stats) and all(
        stat_state[t][:2] == compiled_stats[t][:2]
        and abs(stat_state[t][2] - compiled_stats[t][2]) <= CT_PARTIALS_TOL * abs(compiled_stats[t][2])
        for t in stat_state), "the interpreted groupby differs from the compiled one")
    parse_graph.G.clear()
    upd = [x * 1e3 for x in rec["update_s"]]
    hits = series(metrics1, "pathway_engine_compile_cache_hits_total") - series(
        metrics0, "pathway_engine_compile_cache_hits_total")
    misses = series(metrics1, "pathway_engine_compile_cache_misses_total") - series(
        metrics0, "pathway_engine_compile_cache_misses_total")
    lower_s = series(metrics1, "pathway_engine_compile_seconds_sum") - series(
        metrics0, "pathway_engine_compile_seconds_sum")
    phase = {
        "phase": "compiled ticks",
        "nvidia_smi": smi,
        "rows": CT_ROWS,
        "commits": CT_COMMITS,
        "rows_per_tick": per,
        "survivors": CT_SURVIVORS,
        "threshold": s["threshold"],
        "queries": CT_QUERIES,
        "k": CT_K,
        "segment": [type(n).__name__ for n in seg.nodes],
        "segments": len(segs),
        "compiled_ticks": seg_ticks[0],
        "fallback_ticks": seg_ticks[1],
        "other_segments": other,
        "fallbacks_by_reason": fallbacks,
        "compile": {"misses": misses, "hits": hits, "lowering_s": lower_s},
        "semigroup_partials_calls": partial_calls,
        "segment_device": str(seg.device),
        "chain_s_per_tick": {"compiled": rec["chain_s"], "interpreted": interp["record"]["chain_s"]},
        "chain_ms_p50": {"compiled": float(np.percentile(rec["chain_s"], 50)) * 1e3,
                         "interpreted": float(np.percentile(interp["record"]["chain_s"], 50)) * 1e3},
        "device_ops": device_ops,
        "next_s_per_commit": {"p50": float(np.percentile(rec["next_s"], 50)), "sum": float(np.sum(rec["next_s"]))},
        "feed_rows_per_s": CT_ROWS / float(np.sum(rec["next_s"])),
        "update_to_visible_ms": {"p50": float(np.percentile(upd, 50)), "max": float(np.max(upd)), "n": len(upd)},
        "first_reply_s": checks["first_reply"] - t_run,
        "ref_scalars_columns_rows_per_s": {"native": per / native_s, "python": per / python_s, "rows": per},
        "hasher_moves": earlier,
        "chain_rows_checked": checks["rows"],
        "chain_floats_bitwise_equal": checks["floats_bitwise"],
        "replies_compared": checks["replies"],
        "replies_keys_equal_plain": checks["replies_exact"],
        "near_ties": checks["near_ties"],
        "index_rows_by_commit": checks["index_rows"],
        "operator_s": operator_s(rt),
        "ticks": rt.stats.ticks,
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(shapes.items())},
        "embedder_device": str(emb.runtime.device),
        "peak_allocated_bytes": peak,
        "embedder_init_s": embedder_init_s,
        "run_s": run_s,
        "verify_s": checks["verify_s"],
        "phase_s": _now() - t_phase,
    }
    # the observability phase embeds with this embedder: no second seeded init
    return phase, {"prep": prep, "valid": valid, "queries": {CT_QUERIES: qs}, "launches": launches,
                   "shapes": shapes, "embedder": emb}


# --- phase 14: replication ----------------------------------------------------


class ReplicaChild:
    """One ``python -m pathway_tpu_torch.serving.replica`` process on the
    card, its output read by a thread: ``ready`` (the HTTP port) once it
    prints REPLICA-READY."""

    def __init__(self, env: dict):
        import queue

        self.started = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pathway_tpu_torch.serving.replica"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(Path(__file__).resolve().parent),
        )
        self.lines: list[str] = []
        self.events: queue.Queue = queue.Queue()

        def read() -> None:
            for ln in self.proc.stdout:
                self.lines.append(ln.rstrip("\n"))
                if ln.startswith("REPLICA-"):
                    self.events.put(ln.strip())

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()

    def ready(self, timeout: float = 180.0) -> tuple[int, float]:
        """The child's HTTP port and the seconds from spawn to READY."""
        import queue

        try:
            ln = self.events.get(timeout=timeout)
        except queue.Empty:
            raise AssertionError(f"a replica never became ready: {self.tail()}") from None
        check(ln.startswith("REPLICA-READY "), f"a replica answered {ln!r}: {self.tail()}")
        return int(ln.split()[1]), time.perf_counter() - self.started

    def tail(self) -> str:
        return " | ".join(self.lines[-12:])

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)


def http_json(port: int, method: str, target: str, body: dict | None = None,
              headers: dict | None = None, timeout: float = 60.0) -> tuple[int, dict, object]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, target, body=None if body is None else json.dumps(body),
                     headers={"content-type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        data = json.loads(raw) if hdrs.get("content-type", "").startswith("application/json") else raw
        return resp.status, hdrs, data
    finally:
        conn.close()


def stream_generate(port: int, body: dict) -> dict:
    """POST /generate with ``stream: true``, reading the NDJSON lines as
    they arrive: time to the first token line, tokens, seconds."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/generate", body=json.dumps(body), headers={"content-type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200, f"streamed /generate answered {resp.status}")
        ttft, last = None, {}
        for raw in iter(resp.readline, b""):
            last = json.loads(raw)
            if "token" in last and ttft is None:
                ttft = (time.perf_counter() - t0) * 1e3
        check(last.get("done") and "error" not in last, f"the stream ended {last}")
        return {"ttft_ms": ttft, "tokens": last["token_count"], "s": time.perf_counter() - t0}
    finally:
        conn.close()


def fleet_views(router_port: int, ports: list[int]) -> dict:
    """The router's /fleet/metrics, /fleet/events and /fleet/trace over
    both live replicas, and each replica's /debug/signals: every one answers
    200; the federated exposition parses with each replica's series labelled
    by its member name and both members up; the merged journal and the
    stitched trace name both replicas."""
    from pathway_tpu_torch.observability.exposition import parse_exposition
    from pathway_tpu_torch.observability.tracing import validate_chrome_trace

    out: dict = {}
    status, body, ms = get_url(router_port, "/fleet/metrics")
    check(status == 200, f"/fleet/metrics answered {status}: {body[:200]!r}")
    fams, errs = parse_exposition(body.decode())
    check(not errs, f"/fleet/metrics does not parse: {errs[:3]}")
    up = {s.labels["member"]: s.value for s in fams["pathway_fleet_member_up"].samples}
    members = sorted(m for m in up if m != "router")
    check(len(members) == 2 and all(up[m] == 1.0 for m in members), f"fleet members up: {up}")
    series_by = Counter(s.labels.get("member") for f in fams.values() for s in f.samples)
    check(all(series_by[m] > 1 for m in members), f"a replica's series are not labelled: {dict(series_by)}")
    out["metrics"] = {"ms": ms, "families": len(fams), "series_by_member": dict(series_by)}
    status, body, ms = get_url(router_port, "/fleet/events")
    check(status == 200 and sorted(json.loads(body)["members"]) == members,
          f"/fleet/events answered {status}: {body[:200]!r}")
    out["events"] = {"ms": ms, "events": len(json.loads(body)["events"])}
    status, body, ms = get_url(router_port, "/fleet/trace")
    doc = json.loads(body)
    check(status == 200 and not validate_chrome_trace(doc)
          and sorted(doc["otherData"]["members"]) == sorted(["router"] + members),
          f"/fleet/trace answered {status}: {doc.get('otherData')}")
    out["trace"] = {"ms": ms, "events": len(doc["traceEvents"])}
    for i, port in enumerate(ports):
        status, body, _ms = get_url(port, "/debug/signals?series=3")
        check(status == 200 and json.loads(body)["enabled"], f"replica {i} /debug/signals answered {status}")
        out[f"replica{i}_signals_samples"] = json.loads(body)["samples"]
    return out


def replication(dev, smi: str, vs_data: dict) -> tuple[dict, dict]:
    """The replicated read plane on the card (``parallel/replicate.py``,
    ``serving/replica.py``, ``serving/router.py``, ``serving/result_cache.py``,
    ``generate/serving.py``). The WRITER is this process: a DataIndex over
    TpuKnn(device=dev) at D = 384 fed the vector store phase's corpus (its
    normalized chunk vectors, in REPL_COMMITS commits) with
    pw.run(persistence_config=...) into a temp store and PATHWAY_REPL_PORT=0.
    Two REPLICAS are ``python -m pathway_tpu_torch.serving.replica``
    children on the card (PATHWAY_REPLICA_DEVICE=cuda) that hydrate from
    that store and follow the delta stream; replica 1 also serves
    /generate at GenerateConfig()'s width. A FailoverRouter with
    PATHWAY_ROUTER_CACHE=1 (its cache on the writer's stream) is in this
    process. Checked: (1) every replica and the router answer the encoder
    queries with keys equal to the writer's plain dense_topk on the same
    corpus up to near ties and scores within REPL_TOL; (2) after each of
    REPL_LIVE_WRITES writes a new chunk is rank 1 through both replicas and
    the router; (3) under REPL_CLIENTS concurrent clients replica 0 dies by
    PATHWAY_FAULTS=kill=replica:0,tick:T (exit 23) and every request gets
    200, 503 or 429 inside its deadline; its restart is re-admitted only
    once its health says ready and caught up; (4) a repeated query is a
    cache hit with no replica hop; a write entering its top-k evicts it and
    the next reply equals a replica's; (5) greedy /generate asks through a
    router equal an in-process DecodeScheduler's tokens on the same
    retrieved matches and seed."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig, GenerationRequest
    from pathway_tpu_torch.generate.serving import assemble_prompt
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.observability import REGISTRY
    from pathway_tpu_torch.xpacks.llm import decoder as dec
    from pathway_tpu_torch.ops.knn import dense_topk
    from pathway_tpu_torch.parallel import replicate
    from pathway_tpu_torch.persistence.backends import FilesystemStore
    from pathway_tpu_torch.serving.replica import hydrate_index_state
    from pathway_tpu_torch.serving.router import FailoverRouter
    from pathway_tpu_torch.stdlib.indexing import DataIndex, TpuKnn
    from pathway_tpu_torch.xpacks.llm.decoder import encode_text

    t_phase = time.perf_counter()
    vecs = vs_data["prep"][vs_data["valid"]].float().cpu().numpy()
    n = vecs.shape[0]
    enc = torch.cat([vs_data["queries"][1], vs_data["queries"][16], vs_data["queries"]["filtered"]])
    queries = enc.float().cpu().numpy()
    rng = np.random.default_rng(SEED + 41)
    fresh = rng.normal(size=(REPL_LIVE_WRITES * REPL_LIVE_ROWS + 1, DIM)).astype(np.float32)
    fresh /= np.linalg.norm(fresh, axis=1, keepdims=True)
    capacity = -(-(n + REPL_LIVE_WRITES * REPL_LIVE_ROWS + 64) // 1024) * 1024
    workdir = tempfile.mkdtemp(prefix="pw-repl-")
    store = os.path.join(workdir, "pstorage")
    saved_env = {k: os.environ.get(k) for k in REPL_ENV}
    os.environ.update({
        "PATHWAY_DCN_SECRET": os.urandom(16).hex(), "PATHWAY_REPL_PORT": "0",
        "PATHWAY_REPLICA_DIM": str(DIM),
    })
    replicate.reset_publisher()
    parse_graph.G.clear()
    children: list[ReplicaChild] = []
    router = gen_router = sched = clients = None
    kernels: list[dict] = []
    replica_rows: set[int] = set()
    finished = threading.Event()

    class DocSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        vec: np.ndarray

    class Idle(pw.io.python.ConnectorSubject):
        def run(self):
            finished.wait()

    docs_subject, q_subject = Idle(), Idle()
    docs = pw.io.python.read(docs_subject, schema=DocSchema, autocommit_duration_ms=None)
    qs = pw.io.python.read(q_subject, schema=DocSchema, autocommit_duration_ms=None)
    index = DataIndex(docs, TpuKnn(docs.vec, dimensions=DIM, reserved_space=capacity, device=dev))
    pw.io.null.write(index.query_as_of_now(qs.vec, number_of_matches=K).select(d=pw.right.doc_id))
    cfg = pw.persistence.Config.simple_config(pw.persistence.Backend.filesystem(store),
                                              snapshot_every=REPL_COMMITS)
    failure: list[BaseException] = []

    def run() -> None:
        try:
            pw.run(persistence_config=cfg)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failure.append(e)

    run_thread = threading.Thread(target=run, daemon=True)
    run_thread.start()
    wait_until(lambda: parse_graph.G.runtime is not None or failure, "the writer's runtime")
    check(not failure, f"the writer failed: {failure}")
    rt = parse_graph.G.runtime
    n_commits = [rt.stats.ticks]

    def commit(rows: list[tuple[int, np.ndarray]]) -> float:
        """One commit of rows (one tick); returns the commit's stamp."""
        for doc_id, v in rows:
            docs_subject.next(doc_id=doc_id, vec=v)
        t0 = time.perf_counter()
        docs_subject.commit()
        n_commits[0] += 1
        wait_until(lambda: rt.stats.ticks >= n_commits[0] or failure, "a writer tick")
        check(not failure, f"the writer failed: {failure}")
        return t0

    try:
        t0 = time.perf_counter()
        for part in np.array_split(np.arange(n), REPL_COMMITS):
            commit([(int(i), vecs[i]) for i in part])
        ingest_s = time.perf_counter() - t0
        pub = replicate.publisher()
        check(pub is not None and pub.newest_tick() >= 0, "PATHWAY_REPL_PORT armed no delta publisher")
        got = None

        def snapshot_done() -> bool:
            nonlocal got
            got = hydrate_index_state(FilesystemStore(store))
            return got is not None

        wait_until(snapshot_done, "the writer's first snapshot generation", timeout=120)
        wix = next(ex.index for ex in rt.execs.values() if isinstance(ex, ExternalIndexExec))
        check(len(wix) == n, f"the writer's index holds {len(wix)} rows, not {n}")
        snap_tick = got[1]
        # ring entries at or after the snapshot tick: each replica applies
        # them at subscription, so its T-th applied tick is the next write
        backlog = sum(1 for t, _b in list(pub._ring) if t >= snap_tick)

        def plain(qv: np.ndarray, k: int) -> list[tuple]:
            """The writer's corpus through ops/knn.py's plain dense_topk."""
            c = wix.corpus
            host = torch.from_numpy(c.host).to(dev)
            valid = torch.from_numpy(c.valid_host).to(dev)
            s, ix = dense_topk(torch.from_numpy(np.atleast_2d(qv)).to(dev), host, valid, k,
                               metric="cosine", bf16=False)
            s, ix = (s.double() - 1.0).cpu().numpy(), ix.cpu().numpy()
            return [tuple((c.key_of[int(j)], float(x)) for x, j in zip(sr, jr) if j >= 0)
                    for sr, jr in zip(s, ix)]

        ports = [free_port(), free_port()]
        base_env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(Path(__file__).resolve().parent)] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
            PATHWAY_REPLICA_STORE=store, PATHWAY_REPL_PORT=str(pub.port),
            PATHWAY_REPLICA_DEVICE=dev.type, PATHWAY_REPLICA_DIM=str(DIM))
        base_env.pop("PATHWAY_FAULTS", None)
        envs = [
            dict(base_env, PATHWAY_REPLICA_ID="0", PATHWAY_REPLICA_HTTP_PORT=str(ports[0]),
                 PATHWAY_FAULTS=f"kill=replica:0,tick:{backlog + 1}"),
            dict(base_env, PATHWAY_REPLICA_ID="1", PATHWAY_REPLICA_HTTP_PORT=str(ports[1]),
                 PATHWAY_GENERATE="1"),
        ]
        t0 = time.perf_counter()
        children = [ReplicaChild(e) for e in envs]
        spawn_to_ready = []
        for ch, port in zip(children, ports):
            got_port, secs = ch.ready()
            check(got_port == port, f"a replica bound {got_port}, not {port}")
            spawn_to_ready.append(secs)
        health = [http_json(p, "GET", "/replica/health")[2] for p in ports]
        wait_until(lambda: all(http_json(p, "GET", "/replica/health")[2]["ready"] for p in ports),
                   "the replicas to catch up", timeout=120)
        caught_up_s = time.perf_counter() - t0
        check(all(h["hydrated_gen"] >= 0 for h in health), f"a replica did not hydrate: {health}")
        check(all(h["corpus_docs"] == n for h in health), f"replica corpora {[h['corpus_docs'] for h in health]}")
        hydrate_s = [float(ln.split("=", 1)[1]) for ch in children for ln in ch.lines
                     if ln.startswith("replica hydrate_s=")]

        os.environ.update({"PATHWAY_ROUTER_CACHE": "1",
                           "PATHWAY_ROUTER_CACHE_WRITER": f"127.0.0.1:{pub.port}"})
        router = FailoverRouter([f"http://127.0.0.1:{p}" for p in ports], health_interval_ms=100).start()
        check(router.cache is not None, "PATHWAY_ROUTER_CACHE=1 built no result cache")
        wait_until(lambda: all(ep.ready for ep in router.endpoints) and router.cache.applied_tick >= 0,
                   "the router to admit both replicas", timeout=60)
        clients = RestClients()

        def req(rid, vec, k=K, target="/query", extra=None):
            return [rid, "POST", target, json.dumps({"vec": [float(x) for x in vec], "k": k, **(extra or {})}),
                    {"content-type": "application/json", "x-pathway-deadline-ms": str(REPL_DEADLINE_MS)}]

        def matches(rep) -> tuple:
            return tuple((int(a), float(b)) for a, b in rep[3]["matches"])

        # (1) reads: each replica directly, then through the router (misses
        # that prime the cache), then the same bodies again (hits)
        want = plain(queries, K)
        exact, lat = {}, {}
        for name, port in (("replica0", ports[0]), ("replica1", ports[1]), ("router", router.port),
                           ("router_cache_hit", router.port)):
            reps = clients.run(port, [[req(i, q) for i, q in enumerate(queries)]])
            reps.sort(key=lambda r: r[0])
            check(all(r[1] == 200 for r in reps), f"{name}: statuses {[r[1] for r in reps]}")
            for r in reps:
                check(same_up_to_near_ties(matches(r), want[r[0]], REPL_TOL),
                      f"{name}: query {r[0]} answered {matches(r)[:3]}, plain {want[r[0]][:3]}")
            exact[name] = sum(1 for r in reps if [m[0] for m in matches(r)] == [m[0] for m in want[r[0]]])
            lat[name] = [(r[5] - r[4]) * 1e3 for r in reps]
            if name == "router_cache_hit":
                check(all(r[2].get("x-pathway-cache") == "hit" for r in reps), "a repeated read missed the cache")
        kernels_before_kill = http_json(ports[0], "GET", "/replica/kernels")[2]
        fleet = fleet_views(router.port, ports)
        # (3) failover: clients load the router; the next tick kills replica 0
        retries0 = series(REGISTRY.render(), "pathway_router_retries_total")
        lists = [[req(c * REPL_EACH + i, queries[(c * REPL_EACH + i) % len(queries)])
                  for i in range(REPL_EACH)] for c in range(REPL_CLIENTS)]
        clients.start(router.port, lists)
        t_kill = time.monotonic()
        commit([(n, fresh[-1])])
        rc0 = children[0].proc.wait(timeout=60)
        t_dead = time.monotonic()
        reps = clients.finish()
        check(rc0 == FAULT_EXIT, f"replica 0 exited {rc0}, not {FAULT_EXIT}: {children[0].tail()}")
        statuses = Counter(r[1] for r in reps)
        check(set(statuses) <= {200, 429, 503}, f"failover statuses {dict(statuses)}")
        over = [r for r in reps if (r[5] - r[4]) * 1e3 > REPL_DEADLINE_MS + 1000]
        check(not over, f"{len(over)} requests outlived their deadline")
        served_by = Counter(r[2].get("x-pathway-replica") for r in reps if r[1] == 200)
        retries = series(REGISTRY.render(), "pathway_router_retries_total") - retries0
        wait_until(lambda: router.endpoints[0].ejected, "the router to eject replica 0", timeout=30)
        # its restart on the same port, without the fault: re-admitted only
        # once its health says ready and caught up
        t_restart = time.perf_counter()
        children[0] = ReplicaChild({k: v for k, v in envs[0].items() if k != "PATHWAY_FAULTS"})
        children[0].ready()
        readmit = None
        while readmit is None:
            check(time.perf_counter() - t_restart < 120, "replica 0 was never re-admitted")
            if not router.endpoints[0].ejected:
                h = http_json(ports[0], "GET", "/replica/health")[2]
                check(h["ready"] and h["applied_tick"] >= pub.newest_tick(),
                      f"replica 0 re-admitted before it was ready: {h}")
                readmit = time.perf_counter() - t_restart
            time.sleep(0.01)
        # the restarted process's first search pays its CUDA context and
        # the corpus upload: measured here, not inside update-to-visible
        t1 = time.perf_counter()
        check(http_json(ports[0], "POST", "/query", {"vec": queries[0].tolist(), "k": K})[0] == 200,
              "the restarted replica 0 did not answer")
        first_read_ms = (time.perf_counter() - t1) * 1e3
        # (2) live writes: a new chunk at rank 1 through both replicas and
        # the router; the stream's lag from publish to each replica's
        # applied tick
        published: dict[int, float] = {}
        publish = pub.publish

        def stamped(tick, batches):
            published.setdefault(tick, time.monotonic())
            publish(tick, batches)

        pub.publish = stamped
        update_ms, lag_ms = [], []

        def follow():
            """Poll both replicas' health from before the next commit until
            each shows a tick past the writer's newest now; join() adds
            publish -> first poll showing it, per replica, to lag_ms."""
            prev, done = pub.newest_tick(), {}

            def poll() -> None:
                t_end = time.perf_counter() + 60
                while len(done) < 2 and time.perf_counter() < t_end:
                    for port in ports:
                        if port not in done and http_json(port, "GET", "/replica/health")[2]["applied_tick"] > prev:
                            done[port] = time.monotonic()

            th = threading.Thread(target=poll)
            th.start()

            def join() -> None:
                th.join(timeout=90)
                check(len(done) == 2, "a replica never applied the writer's tick")
                lag_ms.extend((t - published[pub.newest_tick()]) * 1e3 for t in done.values())

            return join

        for w in range(REPL_LIVE_WRITES):
            rows = [(n + 1 + w * REPL_LIVE_ROWS + j, fresh[w * REPL_LIVE_ROWS + j]) for j in range(REPL_LIVE_ROWS)]
            probe = rows[REPL_LIVE_ROWS // 2][1]
            joined = follow()
            t0 = commit(rows)
            pkey = plain(probe, 1)[0][0][0]
            seen: dict[int, float] = {}
            while len(seen) < 2:
                for port in ports:
                    if port not in seen:
                        st, _h, body = http_json(port, "POST", "/query", {"vec": probe.tolist(), "k": K})
                        if st == 200 and body["matches"] and int(body["matches"][0][0]) == pkey:
                            seen[port] = (time.perf_counter() - t0) * 1e3
                check(time.perf_counter() - t0 < 60, "a live write never became visible at a replica")
            update_ms.append(max(seen.values()))
            joined()
            st, _h, body = http_json(router.port, "POST", "/query", {"vec": probe.tolist(), "k": K})
            check(st == 200 and int(body["matches"][0][0]) == pkey and abs(body["matches"][0][1]) <= REPL_TOL,
                  f"write {w}: the router answered {st} {body}")
        # (4) the result cache: a hit is no replica hop; a write into the
        # entry's top-k evicts it; the next reply equals a replica's
        cache = router.cache
        qbody = {"vec": [float(x) for x in queries[0]], "k": K}
        st, _h, first = http_json(router.port, "POST", "/query", qbody)
        check(st == 200, f"the cache's first read answered {st}")
        before = [http_json(p, "GET", "/metrics")[2] for p in ports]
        hits_before = series(REGISTRY.render(), "pathway_router_requests_total", replica="cache")
        hit_ms = []
        for _ in range(REPL_CACHE_REPEATS):
            t1 = time.perf_counter()
            st, h2, again = http_json(router.port, "POST", "/query", qbody)
            hit_ms.append((time.perf_counter() - t1) * 1e3)
            check(st == 200 and h2.get("x-pathway-cache") == "hit" and again == first, "a repeat missed the cache")
        after = [http_json(p, "GET", "/metrics")[2] for p in ports]
        hops = sum(series(a.decode(), "pathway_replica_requests_total") -
                   series(b.decode(), "pathway_replica_requests_total") for a, b in zip(after, before))
        check(hops == 0, f"cache hits made {hops} replica hops")
        hits = series(REGISTRY.render(), "pathway_router_requests_total", replica="cache") - hits_before
        check(hits == REPL_CACHE_REPEATS, f"{hits} cache hits counted, {REPL_CACHE_REPEATS} asked")
        entries = len(cache)
        qn = (queries[0] / np.linalg.norm(queries[0])).astype(np.float32)
        joined = follow()
        t0 = commit([(n + 1 + REPL_LIVE_WRITES * REPL_LIVE_ROWS, qn)])
        wait_until(lambda: len(cache) < entries, "the cache to evict the covering entry", timeout=30)
        evict_ms = (time.perf_counter() - t0) * 1e3
        joined()
        st, h3, after_write = http_json(router.port, "POST", "/query", qbody)
        check(st == 200 and h3.get("x-pathway-cache") != "hit", "the evicted entry still answered")
        st, _h, direct = http_json(ports[1], "POST", "/query", qbody)
        check(after_write == direct, "the reply after eviction differs from a replica's")
        check(abs(after_write["matches"][0][1]) <= REPL_TOL, "the written chunk is not rank 1 after eviction")
        pub.publish = publish
        # (5) /generate on replica 1: streamed for TTFT, then greedy asks
        # through a router against an in-process scheduler
        ttft, tok_s = [], []
        for i in range(REPL_ASKS):
            got_s = stream_generate(ports[1], {"prompt": f"ask {i} about the corpus", "vec": queries[i].tolist(),
                                               "k": 3, "max_tokens": REPL_GEN_TOKENS, "seed": i, "stream": True})
            ttft.append(got_s["ttft_ms"])
            tok_s.append(got_s["tokens"] / got_s["s"])
        gen_router = FailoverRouter([f"http://127.0.0.1:{ports[1]}"], health_interval_ms=100, cache=None).start()
        wait_until(lambda: gen_router.endpoints[0].ready, "the generation router", timeout=60)
        sched = DecodeScheduler(GenerateConfig(), replica_label="repl-ref", device=dev)
        gen_equal, gen_ms = 0, []
        # the same asks decode in process with the same tokens as replica
        # 1's: one of their steps is the paged kernel's /generate shape
        with StepRecorder(dec) as recorder:
            for i in range(REPL_ASKS):
                prompt = f"ask {i} about the corpus"
                t1 = time.perf_counter()
                st, _h, body = http_json(gen_router.port, "POST", "/generate",
                                         {"prompt": prompt, "vec": queries[i].tolist(), "k": 3,
                                          "max_tokens": REPL_GEN_TOKENS, "seed": i},
                                         headers={"x-pathway-deadline-ms": str(REPL_DEADLINE_MS)})
                gen_ms.append((time.perf_counter() - t1) * 1e3)
                check(st == 200, f"/generate through the router answered {st}: {body}")
                retrieved = tuple((int(a), float(b)) for a, b in body["retrieved"])
                check(same_up_to_near_ties(retrieved, plain(queries[i], 3)[0], REPL_TOL),
                      f"ask {i} retrieved {retrieved}")
                tokens = encode_text(assemble_prompt(prompt, body["retrieved"]))
                ref = GenerationRequest(f"ref-{i}", tokens[: sched.config.max_len - REPL_GEN_TOKENS],
                                        deadline=time.monotonic() + 120, max_new_tokens=REPL_GEN_TOKENS, seed=i)
                sched.submit(ref)
                res = ref.wait(120)
                check(res is not None and res["status"] == 200, f"the in-process scheduler answered {res}")
                check(res["tokens"] == body["tokens"], f"ask {i}: /generate {body['tokens']}, in process {res['tokens']}")
                gen_equal += 1
        check(recorder.step is not None, f"the in-process asks took {recorder.calls} decode steps")
        kernels = [kernels_before_kill] + [http_json(p, "GET", "/replica/kernels")[2] for p in ports]
        # the rows each replica's kernel scans: its corpus grows by
        # doubling from the index's reservation as hydration re-upserts
        replica_rows = {h["corpus_bytes"] // (DIM * 4 + 1)
                        for h in (http_json(p, "GET", "/replica/health")[2] for p in ports)}
        check(len(replica_rows) == 1, f"the replicas hold corpora of {replica_rows} rows")
        if dev.type == "cuda":
            # each child searched through the kernel, and replica 1's
            # /generate decoded through the paged kernel
            check(all(kern["block_topk"] > 0 for kern in kernels), f"a replica never launched block_topk: {kernels}")
            check(kernels[2]["paged_attention"] > 0, "/generate on replica 1 never launched paged_attention")
        phase = {
            "phase": "replication",
            "nvidia_smi": smi,
            "rows": n,
            "fleet": fleet,
            "ingest_s": ingest_s,
            "snapshot_tick": snap_tick,
            "ring_backlog_at_subscribe": backlog,
            "spawn_to_ready_s": spawn_to_ready,
            "spawn_to_caught_up_s": caught_up_s,
            "hydrate_s": hydrate_s,
            "replication_lag_ms": {"p50": float(np.percentile(lag_ms, 50)), "max": float(np.max(lag_ms)),
                                   "n": len(lag_ms)},
            "reply_p50_ms": {k: float(np.percentile(v, 50)) for k, v in lat.items()},
            "reply_max_ms": {k: float(np.max(v)) for k, v in lat.items()},
            "router_overhead_p50_ms": float(np.percentile(lat["router"], 50) -
                                            np.percentile(lat["replica1"], 50)),
            "keys_equal_plain": exact,
            "queries": len(queries),
            "update_to_visible_ms": update_ms,
            "cache_hit_p50_ms": float(np.percentile(hit_ms, 50)),
            "cache_evict_ms": evict_ms,
            "failover": {
                "requests": len(reps), "status_counts": {str(k): v for k, v in statuses.items()},
                "served_by": dict(served_by), "router_retries": retries,
                "kill_s_after_load_start": t_dead - t_kill,
                "load_s": max(r[5] for r in reps) - min(r[4] for r in reps),
                "kill_inside_load": t_dead < max(r[5] for r in reps),
                "readmit_s": readmit,
                "restarted_first_read_ms": first_read_ms,
            },
            "generate": {"asks": REPL_ASKS, "tokens_equal_in_process": gen_equal,
                         "ttft_p50_ms": float(np.percentile(ttft, 50)),
                         "tokens_per_s_p50": float(np.percentile(tok_s, 50)),
                         "through_router_p50_ms": float(np.percentile(gen_ms, 50))},
            "replica_kernels": kernels,
            "replica_corpus_rows": min(replica_rows),
            "peak_allocated_bytes": {"writer": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
                                     "replicas": [k.get("peak_allocated_bytes") for k in kernels]},
            "phase_s": time.perf_counter() - t_phase,
        }
    finally:
        for ch in children:
            ch.stop()
        for r in (router, gen_router):
            if r is not None:
                r.stop()
        if sched is not None:
            sched.stop()
        if clients is not None:
            clients.close()
        finished.set()
        if parse_graph.G.runtime is not None:
            parse_graph.G.runtime.stop()
        run_thread.join(timeout=60)
        replicate.reset_publisher()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(workdir, ignore_errors=True)
        parse_graph.G.clear()
    # the writer's corpus padded with invalid rows to the replicas' size:
    # the shape the replicas' launches had
    wprep, _c2, wvalid = wix.corpus.prepared_arrays("cosine", bf16=False)
    rows = max(min(replica_rows), wprep.shape[0])
    prep = torch.zeros(rows, DIM, dtype=wprep.dtype, device=wprep.device)
    valid = torch.zeros(rows, dtype=torch.bool, device=wprep.device)
    prep[: wprep.shape[0]], valid[: wprep.shape[0]] = wprep, wvalid
    shapes: Counter = Counter()
    for kern in kernels:
        for shape, cnt in kern["block_topk_by_shape"].items():
            b, k = (int(x.split("=")[1]) for x in shape.split(","))
            shapes[(b, k)] += cnt
    batch = {}
    for b, _k in shapes:
        # the batch each shape saw: an encoder query, zero-padded to the
        # index's power-of-two batch as its search pads it
        q = torch.zeros(b, DIM, dtype=prep.dtype, device=prep.device)
        q[0] = torch.from_numpy(queries[0]).to(prep.device, prep.dtype)
        batch[b] = q
    return phase, {"prep": prep, "valid": valid, "shapes": shapes, "queries": batch,
                   "paged_launches": sum(kern["paged_attention"] for kern in kernels),
                   "generate_step": recorder.step}


# --- phase 15: generation -----------------------------------------------------


class StepRecorder:
    """Wraps decoder.decode_step for one scheduler run: passes every call
    through, and keeps the inputs (and copies of the pools as they were
    before the call) of the RECORD_STEP-th step."""

    def __init__(self, dec):
        self.dec, self.orig, self.calls, self.step = dec, dec.decode_step, 0, None

    def __enter__(self):
        self.dec.decode_step = self
        return self

    def __exit__(self, *exc):
        self.dec.decode_step = self.orig

    def __call__(self, params, tokens, positions, k_pool, v_pool, pt, sl, **kw):
        self.calls += 1
        if self.calls == RECORD_STEP:
            self.step = {
                "params": params, "tokens": tokens.clone(), "positions": positions.clone(),
                "k_pool": k_pool.clone(), "v_pool": v_pool.clone(), "pt": pt.clone(),
                "sl": sl.clone(), "cfg": kw["cfg"],
            }
        return self.orig(params, tokens, positions, k_pool, v_pool, pt, sl, **kw)


def replay(step: dict, kernel: str):
    """decode_step on the recorded inputs (fresh copies of the pools)."""
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    logits, _k, _v = dec.decode_step(
        step["params"], step["tokens"], step["positions"], step["k_pool"].clone(),
        step["v_pool"].clone(), step["pt"], step["sl"], cfg=step["cfg"], kernel=kernel,
    )
    return logits


def prefix_logits(params, dcfg, tokens: list[int], kernel: str, dev) -> np.ndarray:
    """Logits after feeding ``tokens`` one by one to a lone sequence."""
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    k, v = dec.empty_pools(dcfg, dcfg.max_pages + 1, device=dev)
    pt = torch.arange(1, dcfg.max_pages + 1, dtype=torch.int32, device=dev)[None]

    def one(x: int) -> torch.Tensor:
        return torch.tensor([x], dtype=torch.int32, device=dev)

    for i, t in enumerate(tokens):
        logits, k, v = dec.decode_step(
            params, one(t), one(i), k, v, pt, one(i + 1), cfg=dcfg, kernel=kernel
        )
    return logits[0].cpu().numpy()


def sampling(i: int) -> dict:
    """Ask i's sampling: even asks greedy, odd ones seeded top-k samples."""
    return dict(temperature=0.7, top_k=40, seed=SEED + i) if i % 2 else {}


def run_requests(sched, prompts: list[list[int]]) -> tuple[list[dict], list[float], float]:
    """Submit every prompt (even ones greedy, odd ones seeded top-k samples)
    and wait: (results, time to first token per request, wall seconds)."""
    from pathway_tpu_torch.generate import GenerationRequest

    first: dict[int, float] = {}
    reqs = []
    t0 = time.perf_counter()
    for i, prompt in enumerate(prompts):
        def on_token(_tok, _done, i=i):
            first.setdefault(i, time.monotonic())

        req = GenerationRequest(
            f"ask-{i}", prompt, deadline=time.monotonic() + 600.0,
            max_new_tokens=sched.config.max_new_tokens, on_token=on_token, **sampling(i),
        )
        sched.submit(req)
        reqs.append(req)
    results = [r.wait(600.0) for r in reqs]
    wall = time.perf_counter() - t0
    check(all(r is not None for r in results), "a generation request never finished")
    ttft = [first[i] - r.created_at for i, r in enumerate(reqs) if i in first]
    return results, ttft, wall


def layer_inputs(step: dict, li: int = 0) -> tuple:
    """The paged-attention call of layer ``li`` in the recorded step: a
    seeded q of its shape, and the step's pools, page table and lengths."""
    k, v = step["k_pool"][li], step["v_pool"][li]
    gen = torch.Generator(device=k.device).manual_seed(SEED + 4)
    q = torch.randn(step["tokens"].shape[0], k.shape[1], k.shape[3], generator=gen, device=k.device)
    return q, k, v, step["pt"], step["sl"]


def step_anatomy(step: dict) -> dict:
    """Where one decode step at the recorded shape goes: its host wall time
    (inputs already on the card, logits back with .cpu()), the kernel's
    CUDA-event time over back-to-back launches, and from a torch.profiler
    trace the kernel's own device time per step and the card's busy time
    per step (every device kernel and copy)."""
    from pathway_tpu_torch.ops import paged_attention as pa
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    k_pool, v_pool = step["k_pool"].clone(), step["v_pool"].clone()

    def one_step():
        logits, _k, _v = dec.decode_step(
            step["params"], step["tokens"], step["positions"], k_pool, v_pool, step["pt"],
            step["sl"], cfg=step["cfg"], kernel="cuda",
        )
        return logits.cpu()

    for _ in range(5):
        one_step()
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        one_step()
    replay_ms = (time.perf_counter() - t0) / reps * 1e3
    q, k, v, pt, sl = layer_inputs(step)
    kernel_ms = cuda_ms(lambda: pa.paged_attention(q, k, v, pt, sl, sm_scale=1.0), iters=200)
    times = device_times(one_step)
    busy_ms = None if times is None else sum(ms for _n, ms in times.values()) / 20
    return {
        "replay_step_ms": replay_ms,
        "kernel_event_ms": kernel_ms,
        "kernel_device_ms_per_step": kernel_device_ms(times, "paged_decode_kernel", 20),
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share_of_replay_step": None if busy_ms is None else busy_ms / replay_ms,
        "device_ops_per_step": None if times is None else sum(n for n, _ms in times.values()) / 20,
    }


def generation(dev, main: dict) -> tuple[dict, dict]:
    from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig, assemble_prompt
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops import paged_attention as pa
    from pathway_tpu_torch.xpacks.llm import decoder as dec

    emb, index = main["emb"], main["index"]
    rng = np.random.default_rng(SEED + 2)
    words = [f"term{i}" for i in range(20000)]
    asks = [f"what does {' '.join(rng.choice(words, size=4))} mean?" for _ in range(N_ASKS)]
    cfg = GenerateConfig()

    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    pa.paged_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vecs = emb.embed_batch(asks)
    matches = index.search([(v, RETRIEVE_K, None) for v in vecs])
    topk_shapes = dict(bt.block_topk.shapes)
    prompts = [dec.encode_text(assemble_prompt(a, m)) for a, m in zip(asks, matches)]
    retrieve_s = time.perf_counter() - t0
    sched = DecodeScheduler(cfg, device=dev)
    try:
        with StepRecorder(dec) as rec:
            results, ttft, wall = run_requests(sched, prompts)
        stats = sched.stats()
        launches = pa.paged_attention.launches
        topk_launches = bt.block_topk.launches
        in_use = sched.pool.in_use
        step_ms = np.array(sched.step_seconds) * 1e3
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        sched.stop()

    check(all(len(m) == RETRIEVE_K for m in matches), "an ask retrieved fewer than k docs")
    check(topk_launches > 0, "retrieval never launched the block_topk kernel")
    check(stats["kernel"] == "cuda", f"the default scheduler chose kernel {stats['kernel']!r}")
    for i, r in enumerate(results):
        check(r["status"] == 200, f"ask {i} answered {r}")
        n = r["token_count"]
        check(
            n == cfg.max_new_tokens or (0 < n < cfg.max_new_tokens and r["tokens"][-1] == dec.EOS),
            f"ask {i} returned {n} tokens",
        )
    check(in_use == 0, f"{in_use} KV pages still in use after every request finished")
    steps = stats["decode_steps"]
    check(
        launches == steps * cfg.n_layers,
        f"paged_attention launched {launches} times over {steps} steps x {cfg.n_layers} layers",
    )
    check(rec.step is not None, "fewer decode steps than the recorded one")

    # the same requests through a scheduler on the plain attention
    ref_sched = DecodeScheduler(replace(cfg, kernel="ref"), device=dev)
    try:
        ref_results, _ttft, ref_wall = run_requests(ref_sched, prompts)
    finally:
        ref_sched.stop()
    check(pa.paged_attention.launches == launches, 'kernel="ref" launched the kernel')
    equal = sum(a["tokens"] == b["tokens"] for a, b in zip(results, ref_results))
    diverged = []
    for i, (a, b) in enumerate(zip(results, ref_results)):
        if a["tokens"] == b["tokens"]:
            continue
        # tokens may part only where the two attentions' logits, equal
        # within GEN_LOGIT_TOL, sit on a near-tie: replay that prefix alone
        at = next(j for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"])) if x != y)
        prefix = prompts[i] + a["tokens"][:at]
        zc = prefix_logits(sched.params, sched.dcfg, prefix, "cuda", dev)
        zr = prefix_logits(sched.params, sched.dcfg, prefix, "ref", dev)
        gap = float(np.abs(zc - zr).max())
        check(gap <= GEN_LOGIT_TOL, f"ask {i}: logits differ by {gap} where tokens part")
        if i % 2 == 0:  # greedy: both choices within the tolerance of the top
            top = float(zr.max())
            tie = max(top - zr[a["tokens"][at]], top - zr[b["tokens"][at]])
            check(tie <= 2 * GEN_LOGIT_TOL, f"ask {i}: greedy tokens part {tie} below the top")
        diverged.append({"ask": i, "at": at, "logit_gap": gap})

    step = rec.step
    lc, lr = replay(step, "cuda"), replay(step, "ref")
    step_err = float((lc - lr).abs().max())
    check(step_err <= GEN_LOGIT_TOL, f"recorded step: logits differ by {step_err}")
    shape = (step["tokens"].shape[0], cfg.decoder_config().vocab_size)
    check(bool(torch.isfinite(lc).all()) and lc.shape == shape, "recorded step: bad logits")
    anatomy = step_anatomy(step)
    pa.paged_attention.launches = launches  # the replays above are not the path's

    generated = sum(r["token_count"] for r in results)
    step_p50 = float(np.percentile(step_ms, 50))
    phase = {
        "phase": "generation",
        "asks": N_ASKS,
        "retrieve_k": RETRIEVE_K,
        "retrieve_s": retrieve_s,
        "prompt_tokens": [min(len(p) for p in prompts), max(len(p) for p in prompts)],
        "config": {k: getattr(cfg, k) for k in (
            "dim", "n_layers", "n_heads", "head_dim", "ffn_dim", "max_len", "page_size",
            "n_pages", "max_batch", "max_new_tokens")},
        "generated_tokens": generated,
        "fed_tokens": sum(len(p) for p in prompts) + generated,
        "wall_s": wall,
        "tokens_per_s": generated / wall,
        "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
        "ttft_max_ms": float(np.max(ttft)) * 1e3,
        "decode_steps": steps,
        "step_p50_ms": step_p50,
        "step_p99_ms": float(np.percentile(step_ms, 99)),
        "paged_attention_launches": launches,
        "block_topk_launches": topk_launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(topk_shapes.items())},
        "peak_device_gib": peak_gib,
        "ref_wall_s": ref_wall,
        "ref_tokens_equal": equal,
        "ref_diverged_at_near_ties": diverged,
        "recorded_step": {
            "bucket": int(step["tokens"].shape[0]),
            "seq_lens": step["sl"].tolist(),
            "logits_max_abs_err": step_err,
            "tol": GEN_LOGIT_TOL,
        },
        "step_anatomy": anatomy,
        "kernel_share_of_step_p50": cfg.n_layers * anatomy["kernel_event_ms"] / step_p50,
        "kernel_device_share_of_step_p50": None if anatomy["kernel_device_ms_per_step"] is None
        else anatomy["kernel_device_ms_per_step"] / step_p50,
        "device_busy_share_of_step_p50": None if anatomy["device_busy_ms_per_step"] is None
        else anatomy["device_busy_ms_per_step"] / step_p50,
    }
    # the retrieval batch as the index hands it to the kernel: padded to 32
    asks_q = np.zeros((1 << (N_ASKS - 1).bit_length(), DIM), dtype=np.float32)
    asks_q[:N_ASKS] = np.stack(vecs)
    return phase, {
        "step": step, "launches": launches, "topk_shapes": topk_shapes,
        "asks": torch.from_numpy(asks_q).to(dev), "prompts": prompts, "results": results,
        "params": sched.params, "dcfg": sched.dcfg,
    }


# --- phase 16: durability -----------------------------------------------------


def kill_child(prompts_path: str) -> int:
    """The durability phase's child: the generation phase's prompts through
    a DecodeScheduler configured from PATHWAY_GENERATE_* and armed with
    PATHWAY_FAULTS, which ends this process after its decode step. Returns
    (exit code 1) only if the fault never fired."""
    from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig

    prompts = json.loads(Path(prompts_path).read_text())
    sched = DecodeScheduler(GenerateConfig.from_env(), replica_label="child")
    run_requests(sched, prompts)
    print(f"chip_smoke: the fault never fired ({sched.stats()})", file=sys.stderr)
    return 1


def top2_margin(params, dcfg, prefix: list[int], dev) -> float:
    from pathway_tpu_torch.ops import paged_attention as pa

    before = pa.paged_attention.launches
    z = np.sort(prefix_logits(params, dcfg, prefix, "cuda", dev))
    pa.paged_attention.launches = before  # this replay is not the path's
    return float(z[-1] - z[-2])


def compare_tokens(got: list[int], ask: int, gen: dict, dev, near_ties: list) -> None:
    """Tokens of a resumed sequence against the generation phase's answer
    to the same ask: equal, or parting only where the uninterrupted run's
    top-2 logit margin is below GEN_LOGIT_TOL (a near tie another bucket's
    sum order may decide); anything else fails."""
    want = gen["results"][ask]["tokens"]
    if got == want:
        return
    at = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y), min(len(got), len(want)))
    margin = top2_margin(gen["params"], gen["dcfg"], gen["prompts"][ask] + want[:at], dev)
    check(margin < GEN_LOGIT_TOL, f"ask {ask}: tokens part at step {at} with top-2 margin {margin}")
    near_ties.append({"ask": ask, "at": at, "top2_margin": margin})


def asks_by_prompt(prompts: list[list[int]]) -> dict:
    """(prompt tokens, seed, temperature) -> ask index, as run_requests
    submits them (GenerationRequest defaults: seed 0, temperature 0)."""
    out = {}
    for i, p in enumerate(prompts):
        s = sampling(i)
        out.setdefault((tuple(p), s.get("seed", 0), s.get("temperature", 0.0)), i)
    return out


def ask_of(meta: dict, index: dict) -> int:
    prompt = tuple(meta["tokens"][: meta["prompt_len"]])
    return index[(prompt, meta["seed"], meta["temperature"])]


class HeldRestore:
    """While open, every new DecodeScheduler restores (timed) and its decode
    loop idles, so the restored pools can be read before any step writes
    them; closing lets the loops decode."""

    def __init__(self):
        from pathway_tpu_torch.generate import DecodeScheduler

        self.cls, self.seconds = DecodeScheduler, []
        self.step, self.restore = DecodeScheduler._step, DecodeScheduler._restore

    def __enter__(self):
        def timed(sched, root):
            t0 = time.perf_counter()
            self.restore(sched, root)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)

        self.cls._step = lambda sched: time.sleep(0.002)
        self.cls._restore = timed
        return self

    def __exit__(self, *exc):
        self.cls._step, self.cls._restore = self.step, self.restore


def pages_bit_equal(sched, led) -> int:
    """Every restored page in the scheduler's pools against the ledger's
    bytes; returns the number of pages compared."""
    by_seq = {s.seq_id: s for s in sched._active}
    n = 0
    for (seq_id, page_idx), (k, v, _ident) in led.live_pages().items():
        pid = by_seq[seq_id].pages[page_idx]
        check(sched.k_pool[:, pid].cpu().numpy().tobytes() == k.tobytes(), f"K page {seq_id}/{page_idx} differs")
        check(sched.v_pool[:, pid].cpu().numpy().tobytes() == v.tobytes(), f"V page {seq_id}/{page_idx} differs")
        n += 1
    return n


def wait_finished(scheds: list, n: int, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while sum(len(s.finished) for s in scheds) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    check(sum(len(s.finished) for s in scheds) == n, "a restored sequence never completed")


def resumed_tokens(sched, metas: dict, index: dict, gen: dict, dev, near_ties: list) -> set:
    """Check every restored sequence's answer; returns their seq ids."""
    done = set()
    for rid, res in sched.finished.items():
        check(rid.startswith("restored-") and res["status"] == 200, f"restored answer {rid}: {res}")
        seq_id = int(rid.split("-", 1)[1])
        compare_tokens(res["tokens"], ask_of(metas[seq_id], index), gen, dev, near_ties)
        done.add(seq_id)
    return done


def span_count(tracer, name: str, label: str) -> int:
    return sum(1 for r in tracer.spans() if r.name == name and r.attributes.get("replica") == label)


def series(text: str, name: str, **labels) -> float:
    from pathway_tpu_torch.observability import parse_exposition

    fams, errors = parse_exposition(text)
    check(not errors, f"exposition parse errors: {errors[:3]}")
    return sum(
        smp.value for fam in fams.values() for smp in fam.samples
        if smp.name == name and all(smp.labels.get(k) == v for k, v in labels.items())
    )


def durability(dev, gen: dict) -> dict:
    from pathway_tpu_torch import _build
    from pathway_tpu_torch.elastic.kv import split_kv_store
    from pathway_tpu_torch.generate import DecodeScheduler, GenerateConfig, KvLedger
    from pathway_tpu_torch.observability import (
        REGISTRY,
        get_tracer,
        install_torch_metrics,
        tickscope,
        validate_exposition,
    )
    from pathway_tpu_torch.ops import paged_attention as pa

    prompts, index = gen["prompts"], asks_by_prompt(gen["prompts"])
    cfg = GenerateConfig()
    tmp = Path(tempfile.mkdtemp(prefix="pw-durability-"))
    near_ties: list = []
    pa.paged_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        # 1. the real kill: a child process dies by the fault plan
        store = tmp / "store"
        (tmp / "prompts.json").write_text(json.dumps(prompts))
        built_before = sorted(os.listdir(_build.BUILD_DIR))
        env = dict(
            os.environ, PATHWAY_GENERATE_SNAPSHOT_EVERY=str(SNAPSHOT_EVERY),
            PATHWAY_GENERATE_STORE=str(store), PATHWAY_FAULTS=f"kill=decode:{KILL_STEP}",
        )
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--kill-child", str(tmp / "prompts.json")],
            env=env, capture_output=True, text=True, timeout=300,
        )
        child_s = time.perf_counter() - t0
        check(child.returncode == FAULT_EXIT, f"child exited {child.returncode}:\n{child.stderr[-3000:]}")
        check(f"decode step {KILL_STEP}" in child.stderr, "the child did not die by kill=decode")
        check((store / "manifest.json").exists(), "the killed child left no manifest")
        check(sorted(os.listdir(_build.BUILD_DIR)) == built_before, "the child rebuilt a kernel")
        led = KvLedger.restore(str(store))
        metas = led.live_seqs()
        check(len(metas) > 0, "the child's last snapshot holds no sequence")

        # 2. restore on the card
        with HeldRestore() as held:
            restored = DecodeScheduler(replace(cfg, store_root=str(store)), replica_label="restored")
            check(restored.restored_seqs == len(metas), f"restored {restored.restored_seqs} of {len(metas)}")
            pages_checked = pages_bit_equal(restored, led)
        try:
            wait_finished([restored], len(metas))
            check(resumed_tokens(restored, metas, index, gen, dev, near_ties) == set(metas), "restore lost a sequence")
            restored_steps = restored.stats()["decode_steps"]
            check(restored.pool.in_use == 0, "pages still in use after the restored sequences finished")
            check(
                pa.paged_attention.launches == restored_steps * cfg.n_layers,
                f"{pa.paged_attention.launches} launches over {restored_steps} restored steps",
            )
        finally:
            restored.stop()

        # 3. resharding: two new owners resume every sequence exactly once
        owners = [str(tmp / "owner0"), str(tmp / "owner1")]
        split = split_kv_store(str(store), owners)
        with HeldRestore():
            scheds = [
                DecodeScheduler(replace(cfg, store_root=o), replica_label=f"owner{i}")
                for i, o in enumerate(owners)
            ]
        try:
            wait_finished(scheds, len(metas))
            parts = [resumed_tokens(s, metas, index, gen, dev, near_ties) for s in scheds]
            check(not (parts[0] & parts[1]) and parts[0] | parts[1] == set(metas), "resharding lost or doubled a sequence")
            owner_steps = sum(s.stats()["decode_steps"] for s in scheds)
        finally:
            for s in scheds:
                s.stop()

        # 4. the hooks without periodic snapshots, one snapshot from this
        # thread mid-run, and what the hooks report
        install_torch_metrics()
        get_tracer().clear()
        tickscope.reset()
        oob_store = tmp / "out-of-thread"
        hooks = DecodeScheduler(replace(cfg, store_root=str(oob_store)), replica_label="hooks")
        box: dict = {}
        runner = threading.Thread(target=lambda: box.update(out=run_requests(hooks, prompts)))
        try:
            runner.start()
            while hooks.stats()["decode_steps"] < KILL_STEP and runner.is_alive():
                time.sleep(0.001)
            t0 = time.perf_counter()
            oob = hooks.snapshot()  # from this thread: served at a step boundary
            oob_ms = (time.perf_counter() - t0) * 1e3
            oob_at = hooks.stats()["decode_steps"]
            check(oob is not None and oob["bytes_written"] > 0, f"out-of-thread snapshot wrote {oob}")
            runner.join(600)
            results, ttft, wall = box["out"]
            st = hooks.stats()
            mem = tickscope.memory_snapshot()["owners"]["generate:hooks"]
            check(mem["k_pool_device"] == hooks.k_pool.numel() * 4, "memory ledger: wrong K pool bytes")
            check(mem["v_pool_device"] == hooks.v_pool.numel() * 4, "memory ledger: wrong V pool bytes")
            text = REGISTRY.render()
            hooks_ms = np.array(hooks.step_seconds) * 1e3
        finally:
            hooks.stop()
        for i, r in enumerate(results):
            check(r["status"] == 200, f"hooks run: ask {i} answered {r}")
            compare_tokens(r["tokens"], i, gen, dev, near_ties)
        errors = validate_exposition(text)
        check(not errors, f"exposition invalid: {errors[:3]}")
        steps = st["decode_steps"]
        sampled = sum(r["token_count"] for r in results)
        check(series(text, "pathway_generate_decode_steps_total", replica="hooks") == steps, "steps counter")
        check(series(text, "pathway_generate_tokens_total", replica="hooks", kind="sampled") == sampled, "tokens counter")
        check(span_count(get_tracer(), "generate.decode_step", "hooks") == steps, "one span per decode step")
        check(tickscope.roofline().samples("paged_attention") == steps, "roofline samples")
        peak = tickscope.peak_flops()
        kind = torch.cuda.get_device_name(0).lower()
        want = next((p for key, p in tickscope._PEAK_TABLE.items() if key in kind), None)
        check(peak == want, f"peak_flops() {peak} is not the table's entry for {kind!r}")

        # the ledger the out-of-thread snapshot left restores
        oob_led = KvLedger.restore(str(oob_store))
        oob_metas = oob_led.live_seqs()
        check(len(oob_metas) > 0, "the out-of-thread snapshot holds no sequence")
        with HeldRestore():
            from_oob = DecodeScheduler(replace(cfg, store_root=str(oob_store)), replica_label="oob")
            check(from_oob.restored_seqs == len(oob_metas), "the out-of-thread snapshot did not restore")
            pages_bit_equal(from_oob, oob_led)
        try:
            wait_finished([from_oob], len(oob_metas))
            resumed_tokens(from_oob, oob_metas, index, gen, dev, near_ties)
            oob_steps = from_oob.stats()["decode_steps"]
        finally:
            from_oob.stop()

        # 5. a snapshot every 8 steps: mirror and snapshot costs
        snaps = DecodeScheduler(
            replace(cfg, store_root=str(tmp / "snapshots"), snapshot_every=SNAPSHOT_EVERY),
            replica_label="snapshots",
        )
        snap_ms, mirror_ms, written = [], [], []
        inline, mirror = snaps._snapshot_inline, snaps._mirror

        def timed_mirror():
            t = time.perf_counter()
            mirror()
            mirror_ms.append((time.perf_counter() - t) * 1e3)

        def timed_snapshot():
            t = time.perf_counter()
            out = inline()
            snap_ms.append((time.perf_counter() - t) * 1e3)
            written.append(out)
            return out

        snaps._mirror, snaps._snapshot_inline = timed_mirror, timed_snapshot
        try:
            snap_results, _ttft, snap_wall = run_requests(snaps, prompts)
            snap_step_ms = np.array(snaps.step_seconds) * 1e3
            snap_steps = snaps.stats()["decode_steps"]
        finally:
            snaps.stop()
        for i, r in enumerate(snap_results):
            check(r["status"] == 200, f"snapshot run: ask {i} answered {r}")
            compare_tokens(r["tokens"], i, gen, dev, near_ties)
        check(len(written) == snap_steps // SNAPSHOT_EVERY, f"{len(written)} snapshots over {snap_steps} steps")

        launches = pa.paged_attention.launches
        all_steps = restored_steps + owner_steps + steps + snap_steps + oob_steps
        check(launches == all_steps * cfg.n_layers, f"{launches} launches over {all_steps} steps")
        stats = torch.cuda.memory_stats()
        return {
            "phase": "durability",
            "kill": {
                "step": KILL_STEP, "snapshot_every": SNAPSHOT_EVERY, "exit_code": child.returncode,
                "child_s": child_s, "manifest_seqs": len(metas),
                "manifest_pages": len(led.live_pages()),
            },
            "restore": {
                "restored_seqs": len(metas), "pages_bit_equal": pages_checked,
                "restore_s": held.seconds[0], "decode_steps": restored_steps,
            },
            "reshard": {
                "seqs_per_owner": [d["seqs"] for d in split["destinations"]],
                "bytes_per_owner": [d["snapshot"]["bytes_written"] for d in split["destinations"]],
                "decode_steps": owner_steps,
            },
            "hooks_no_snapshots": {
                "decode_steps": steps, "step_p50_ms": float(np.percentile(hooks_ms, 50)),
                "tokens_per_s": sampled / wall, "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
                "exposition_valid": True, "decode_step_spans": steps,
                "out_of_thread_snapshot": {
                    "at_step": oob_at, "ms": oob_ms, "seqs": len(oob_metas),
                    "bytes": oob["bytes_written"], "segments": oob["segments_written"],
                    "restored_decode_steps": oob_steps,
                },
                "roofline_paged_attention": tickscope.roofline().snapshot()["paged_attention"],
                "peak_flops": peak, "memory_generate_hooks": mem,
            },
            "snapshots_every_8": {
                "decode_steps": snap_steps, "step_p50_ms": float(np.percentile(snap_step_ms, 50)),
                "tokens_per_s": sum(r["token_count"] for r in snap_results) / snap_wall,
                "snapshots": len(written),
                "mirror_ms_p50": float(np.percentile(mirror_ms, 50)),
                "mirror_ms_max": float(np.max(mirror_ms)),
                "snapshot_ms_p50": float(np.percentile(snap_ms, 50)),
                "snapshot_ms_max": float(np.max(snap_ms)),
                "bytes_per_snapshot_p50": float(np.percentile([w["bytes_written"] for w in written], 50)),
                "bytes_per_snapshot_max": max(w["bytes_written"] for w in written),
                "segments_per_snapshot_p50": float(np.percentile([w["segments_written"] for w in written], 50)),
                "segments_per_snapshot_max": max(w["segments_written"] for w in written),
            },
            "paged_attention_launches": launches,
            "tokens_compared": "exact; a difference passes only at a near tie",
            "near_ties": near_ties,
            "tol": GEN_LOGIT_TOL,
            "peak_allocated_bytes": stats.get("allocated_bytes.all.peak"),
            "peak_reserved_bytes": stats.get("reserved_bytes.all.peak"),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --- phase 17: observability --------------------------------------------------

OB_COMMITS = 8  # commits of the vector store phase's chunk vectors, one tick each
OB_NEW_DOCS = 256  # new documents through the embedder, in one commit
OB_B1 = 64  # B = 1 query ticks, the server and sampler on and off in blocks
OB_AB_BLOCK = 4  # queries per on/off block
OB_B16_TICKS = 8  # B = 16 query ticks under the scraper and the profile capture
OB_B16_SCRAPED = 4  # B = 16 query ticks under the scraper alone, before them
OB_B16_CONTROL = 4  # B = 16 query ticks with neither, before and again after
OB_B16_ALL = OB_B16_TICKS + OB_B16_SCRAPED + 2 * OB_B16_CONTROL
# /metrics is scraped every OB_SCRAPE_S under load: 60 times as often as a
# common 15 s Prometheus interval, so a burst of a few seconds holds enough
# scrapes for a p50, and what the replies pay for them bounds a real
# scraper's cost from above
OB_SCRAPE_S = 0.25
OB_PROFILE_S = 1.0
OB_SIGNALS_MS = 200
OB_ENV = ("PATHWAY_COMPILED_TICK", "PATHWAY_COMPILED_DEVICE", "PATHWAY_SIGNALS_INTERVAL_MS",
          "PATHWAY_SIGNALS", "PATHWAY_FLEET_MEMBERS")


def ob_quality(n: int) -> np.ndarray:
    """The seeded quality column the compiled select -> filter chain reads."""
    return np.random.default_rng(SEED + 61).random(n)


def ob_kept(quality: np.ndarray) -> np.ndarray:
    """numpy's answer to the chain's filter: q2 = quality * 2.0 - 0.5 > 0."""
    return quality * 2.0 - 0.5 > 0.0


def get_url(port: int, target: str, timeout: float = 60.0) -> tuple[int, bytes, float]:
    """(status, body, wall ms) of one GET on this host."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{target}", timeout=timeout) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, body, (time.perf_counter() - t0) * 1e3


def observability(dev, smi: str, vs_data: dict, emb) -> tuple[dict, dict]:
    """The rest of observability on the card, over a monitored live index
    at the main path's width: the vector store phase's chunk vectors (with
    their texts) arrive through pw.io.python in OB_COMMITS commits and pass
    a compiled select -> filter chain on a seeded quality column
    (PATHWAY_COMPILED_TICK=1 on the card); OB_NEW_DOCS new documents go
    through the full-width embedder (the compiled ticks phase's); the rows go
    into DataIndex over TpuKnn(device="cuda"); OB_B1 B = 1 and OB_B16_ALL
    B = 16 query ticks are embedded by the same UDF. The run is
    pw.run(with_http_server=True, diagnostics="warn") with the signal
    sampler every OB_SIGNALS_MS. Checked, each raising: every reply equals the
    plain top-K (kernel="torch") over the live rows up to near ties; the
    index holds exactly the rows numpy keeps; /metrics parses, its ticks
    equal the runtime's, its knn histogram and query counter moved by this
    phase's query ticks and queries, and its device-memory gauges name the
    card; /debug/graph has one row per node and the chain's segment tail
    OB_COMMITS compiled ticks and no fallback; /debug/tick names the last
    tick's critical path; /debug/threads shows the runtime's thread;
    /debug/signals has tick_ms and knn_p50_ms points; /debug/profile
    captures block_topk's kernel on the card during the B = 16 burst, a
    concurrent capture answers 409 and seconds=0 answers 400;
    /debug/autoscale answers 501 naming [mesh]; pw.debug.diagnose reports
    compile-boundary at the embedder's node; a faulty graph under
    diagnostics="error" raises GraphDoctorError before its first tick;
    prove_lowering() proves every case but the two planted refusals and
    holds the chain's own segment program. The B = 1 replies alternate
    between the server and sampler on and off in blocks of OB_AB_BLOCK; the
    B = 16 ticks run with neither the scraper nor the capture, under a
    scraper every OB_SCRAPE_S, under the scraper and the capture, and with
    neither again, so each block's reply p50 is read against the control."""
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.analysis import GraphDoctorError, lowering
    from pathway_tpu_torch.engine.compile import row_bucket
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import api, parse_graph
    from pathway_tpu_torch.internals.monitoring_server import start_http_server
    from pathway_tpu_torch.observability import debug, signals
    from pathway_tpu_torch.observability.exposition import parse_exposition
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.stdlib.indexing import DataIndex, TpuKnn

    _now = time.perf_counter
    t_phase = _now()
    valid_slots = torch.nonzero(vs_data["valid"]).flatten().cpu().numpy()
    vecs = vs_data["prep"][vs_data["valid"]].float().cpu().numpy()
    texts = [vs_data["slot_texts"][i] for i in valid_slots]
    n = len(texts)
    quality = ob_quality(n)
    keep = ob_kept(quality)
    parts = np.array_split(np.arange(n), OB_COMMITS)
    rng = np.random.default_rng(SEED + 62)
    news = synthetic_docs(OB_NEW_DOCS, rng)
    news_q = ob_quality(n + OB_NEW_DOCS)[n:]
    q_rows = [int(i) for i in rng.choice(n, size=OB_B1 + 16 * OB_B16_ALL, replace=False)]
    check(all(t is not None for t in texts), "a live slot of the vector store has no text")
    saved_env = {k: os.environ.get(k) for k in OB_ENV}
    for k in OB_ENV:
        os.environ.pop(k, None)
    os.environ.update(PATHWAY_COMPILED_TICK="1", PATHWAY_COMPILED_DEVICE=dev.type,
                      PATHWAY_SIGNALS_INTERVAL_MS=str(OB_SIGNALS_MS))
    signals.reset_sampler()
    lowering.clear_live_programs()
    parse_graph.G.clear()
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()

    class ChunkSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str
        quality: float
        vec: np.ndarray

    class NewSchema(pw.Schema):
        doc_id: int = pw.column_definition(primary_key=True)
        text: str
        quality: float

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        q: str

    finished = threading.Event()
    failure: list[BaseException] = []
    record: dict = {"ab": [], "b16": [], "burst_s": Counter(), "scrape_ms": [], "profile": {}}

    class Idle(pw.io.python.ConnectorSubject):
        def run(self):
            finished.wait()

    class QuerySubject(pw.io.python.ConnectorSubject):
        def run(self):
            try:
                drive(self)
            except BaseException as e:  # noqa: BLE001 — re-raised after pw.run
                failure.append(e)
            finally:
                finished.set()

    chunk_subject, new_subject = Idle(), Idle()
    chunks = pw.io.python.read(chunk_subject, schema=ChunkSchema, autocommit_duration_ms=None)
    fresh = pw.io.python.read(new_subject, schema=NewSchema, autocommit_duration_ms=None)
    # the compiled chain: a select computing q2 beside the passed-through
    # columns, then the filter on it
    kept = chunks.select(pw.this.doc_id, pw.this.text, pw.this.vec,
                         q2=pw.this.quality * 2.0 - 0.5).filter(pw.this.q2 > 0.0)
    # the embedder UDF cuts a chain: the doctor names it
    embedded = fresh.select(pw.this.doc_id, pw.this.text, vec=emb(pw.this.text),
                            q2=pw.this.quality * 2.0 - 0.5)
    pw.universes.promise_are_pairwise_disjoint(kept, embedded)
    live = kept.concat(embedded)
    index = DataIndex(live, TpuKnn(live.vec, dimensions=DIM,
                                   reserved_space=n + OB_NEW_DOCS + 1024, device=dev))
    queries = pw.io.python.read(QuerySubject(), schema=QuerySchema, autocommit_duration_ms=None)
    qv = queries.select(qid=pw.this.qid, v=emb(pw.this.q))
    answers = index.query_as_of_now(qv.v, number_of_matches=K).select(
        qid=pw.left.qid, ids=pw.right._pw_index_reply_id, scores=pw.right._pw_index_reply_score)
    replies: dict[int, dict] = {}
    qvecs: dict[int, np.ndarray] = {}
    commits: dict[int, float] = {}

    def on_reply(key, row, time, is_addition):
        if is_addition and row["qid"] not in replies:
            replies[row["qid"]] = {"t": _now(), "ids": tuple(int(i) for i in row["ids"]),
                                   "scores": tuple(float(s) for s in row["scores"])}

    def on_query_vec(key, row, time, is_addition):
        if is_addition:
            qvecs[row["qid"]] = np.asarray(row["v"], dtype=np.float32)

    pw.io.subscribe(qv, on_change=on_query_vec)
    pw.io.subscribe(answers, on_change=on_reply)
    n_commits = [0]

    def commit(subject, cond, what: str) -> None:
        subject.commit()
        n_commits[0] += 1
        goal, rt = n_commits[0], parse_graph.G.runtime
        wait_until(lambda: cond() and rt.stats.ticks >= goal, what)

    def ask(qs, rows: list[tuple[int, str]]) -> None:
        for qid, text in rows:
            qs.next(qid=qid, q=text)
        t0 = _now()
        for qid, _t in rows:
            commits[qid] = t0
        commit(qs, lambda: all(q in replies for q, _t in rows), "a query's reply")

    def metrics(port: int) -> dict:
        status, body, _ms = get_url(port, "/metrics")
        check(status == 200, f"/metrics answered {status}")
        fams, errs = parse_exposition(body.decode())
        check(not errs, f"/metrics does not parse: {errs[:3]}")
        return fams

    def sample_sum(fams: dict, name: str, suffix: str = "", **labels) -> float:
        fam = fams.get(name)
        check(fam is not None, f"/metrics has no {name}")
        return sum(s.value for s in fam.samples if s.name == name + suffix
                   and all(s.labels.get(k) == v for k, v in labels.items()))

    def drive(qs) -> None:
        rt = parse_graph.G.runtime
        ix = record["index"] = next(ex.index for ex in rt.execs.values()
                                   if isinstance(ex, ExternalIndexExec))
        srv = rt.http_server
        check(srv is not None, "pw.run(with_http_server=True) attached no server")
        port = record["port"] = srv.server_address[1]
        t0 = _now()
        for part in parts:
            for i in part:
                chunk_subject.next(doc_id=int(i), text=texts[i], quality=float(quality[i]), vec=vecs[i])
            goal = int(keep[: part[-1] + 1].sum())
            commit(chunk_subject, lambda: len(ix) >= goal, "a chunk commit")
        for j, text in enumerate(news):
            new_subject.next(doc_id=n + j, text=text, quality=float(news_q[j]))
        goal = int(keep.sum()) + OB_NEW_DOCS
        commit(new_subject, lambda: len(ix) >= goal, "the embedded documents")
        record["ingest_s"] = _now() - t0
        before = metrics(port)
        record["knn_before"] = (
            sample_sum(before, "pathway_knn_query_seconds", "_count", index="TpuDenseKnnIndex"),
            sample_sum(before, "pathway_knn_queries_total", index="TpuDenseKnnIndex"),
        )
        # B = 1: the server and the sampler on, then off, in blocks; a
        # restarted server may bind another port, and the routes follow it
        qid = 0
        on = True
        for i in range(OB_B1):
            want_on = (i // OB_AB_BLOCK) % 2 == 0
            if want_on != on:
                if want_on:
                    srv = start_http_server(rt)  # re-arms the sampler
                    check(rt.http_server is srv, "the restarted server is not the runtime's")
                    port = record["port"] = srv.server_address[1]
                else:
                    srv.shutdown()
                    signals.get_sampler().stop()
                on = want_on
            ask(qs, [(qid, texts[q_rows[i]])])
            record["ab"].append((on, qid))
            qid += 1
        if not on:
            srv = start_http_server(rt)
            port = record["port"] = srv.server_address[1]
        record["server"] = srv
        # the B = 16 ticks: a control block, a block under a /metrics
        # scraper, the burst under the scraper and a profile capture, and
        # the control block again
        stop = threading.Event()

        def burst(label: str, ticks: int) -> None:
            nonlocal qid
            t0 = _now()
            for _t in range(ticks):
                ask(qs, [(qid + j, texts[q_rows[qid + j]]) for j in range(16)])
                record["b16"].append((label, qid))
                qid += 16
            record["burst_s"][label] += _now() - t0

        def scrape() -> None:
            while not stop.is_set():
                status, _body, ms = get_url(port, "/metrics")
                check(status == 200, f"/metrics answered {status} under load")
                record["scrape_ms"].append(ms)
                stop.wait(OB_SCRAPE_S)

        def profile() -> None:
            t0 = _now()
            record["profile"]["first"] = get_url(
                port, f"/debug/profile?seconds={OB_PROFILE_S}&device={dev.type}")
            record["profile"]["wall_s"] = _now() - t0

        burst("control", OB_B16_CONTROL)
        scraper = threading.Thread(target=scrape, daemon=True)
        profiler = threading.Thread(target=profile, daemon=True)
        scraper.start()
        burst("scraped", OB_B16_SCRAPED)
        profiler.start()
        wait_until(debug._profile_lock.locked, "the profile capture to start", timeout=30.0)
        record["profile"]["second"] = get_url(port, f"/debug/profile?seconds=1&device={dev.type}")
        record["profile"]["zero"] = get_url(port, "/debug/profile?seconds=0")
        burst("captured", OB_B16_TICKS)
        profiler.join(60)
        stop.set()
        scraper.join(60)
        burst("control", OB_B16_CONTROL)
        record["queries"] = qid
        # the routes, once the traffic is over
        after = metrics(port)
        record["metrics"] = {
            "ticks_total": sample_sum(after, "pathway_ticks_total"),
            "runtime_ticks": rt.stats.ticks,
            "knn_query_ticks": sample_sum(after, "pathway_knn_query_seconds", "_count",
                                          index="TpuDenseKnnIndex") - record["knn_before"][0],
            "knn_queries": sample_sum(after, "pathway_knn_queries_total",
                                      index="TpuDenseKnnIndex") - record["knn_before"][1],
            "device_memory": sorted({(s.labels["device"], s.labels["kind"])
                                     for s in after["pathway_device_memory_bytes"].samples}),
            "build_backend": sorted({(s.labels["platform"], s.labels["backend"])
                                     for s in after["pathway_build_info"].samples}),
        }
        for route in ("/debug/graph", "/debug/tick", "/debug/threads", "/debug/signals?series=5",
                      "/debug/autoscale", "/status"):
            record[route] = get_url(port, route)

    pw_run_t0 = _now()
    pw.run(with_http_server=True, diagnostics="warn")
    run_s = _now() - pw_run_t0
    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    if failure:
        raise failure[0]
    launches, shapes = bt.block_topk.launches, dict(bt.block_topk.shapes)
    rt = parse_graph.G.last_runtime
    ix = record["index"]

    # replies against the plain top-K over the live rows
    plain = snapshot_index(ix, dev)
    want_keys = {int(api.ref_scalar(i)) for i in np.flatnonzero(keep)} | {
        int(api.ref_scalar(n + j)) for j in range(OB_NEW_DOCS)}
    got_keys = set(int(k) for k in ix.corpus.slot_of)
    check(got_keys == want_keys, f"the index holds {len(got_keys)} rows, numpy keeps {len(want_keys)}")
    exact, near = 0, 0
    before = bt.block_topk.launches, bt.block_topk.shapes.copy()
    for lo in range(0, record["queries"], 16):
        qs_ = list(range(lo, min(lo + 16, record["queries"])))
        ref = plain.search([(qvecs[q], K, None) for q in qs_])
        for q, r in zip(qs_, ref):
            got = tuple(zip(replies[q]["ids"], replies[q]["scores"]))
            want = tuple((int(k), float(s)) for k, s in r)
            if [k for k, _s in got] == [k for k, _s in want]:
                exact += 1
            else:
                check(same_up_to_near_ties(got, want, 1e-4), f"query {q}: {got} != plain {want}")
                near += 1
    bt.block_topk.launches, bt.block_topk.shapes = before
    # the routes
    m = record["metrics"]
    check(m["ticks_total"] == m["runtime_ticks"], f"pathway_ticks_total {m['ticks_total']} != {m['runtime_ticks']}")
    check(m["knn_query_ticks"] == OB_B1 + OB_B16_ALL,
          f"pathway_knn_query_seconds counted {m['knn_query_ticks']} query ticks")
    check(m["knn_queries"] == record["queries"], f"pathway_knn_queries_total moved by {m['knn_queries']}")
    if dev.type == "cuda":
        check((f"cuda:{dev.index or 0}", "bytes_limit") in m["device_memory"],
              f"the device memory gauges do not name the card: {m['device_memory']}")
        check(m["build_backend"] == [("cuda", torch.cuda.get_device_name(dev))],
              f"pathway_build_info names {m['build_backend']}")
    status, body, _ms = record["/debug/graph"]
    graph = json.loads(body)
    check(status == 200 and [r["id"] for r in graph] == [nd.id for nd in rt.order],
          "/debug/graph has not one row per node")
    chain_seg = rt.compiled_plan.segment_of(kept._node.id)
    check(chain_seg is not None, "the select -> filter chain is no compiled segment")
    seg_tail = next((r for r in graph if r["id"] == chain_seg.tail.id), None)
    check(seg_tail is not None and seg_tail.get("segment_tail"), f"/debug/graph has no tail row: {seg_tail}")
    check(seg_tail["compiled_ticks"] == OB_COMMITS and seg_tail["fallback_ticks"] == 0,
          f"the chain's segment: {seg_tail}")
    status, body, _ms = record["/debug/tick"]
    tick = json.loads(body)
    path = (tick.get("last") or {}).get("critical_path") or {}
    check(status == 200 and path.get("stages"), f"/debug/tick names no critical path: {path}")
    status, body, _ms = record["/debug/threads"]
    check(status == 200 and b"'MainThread'" in body, "/debug/threads does not show the runtime's thread")
    status, body, _ms = record["/debug/signals?series=5"]
    sig = json.loads(body)
    check(status == 200 and sig["enabled"] and sig["signals"]["tick_ms"]["n"] > 0
          and sig["signals"]["knn_p50_ms"]["n"] > 0, f"/debug/signals rings: {sig.get('signals')}")
    status, body, _ms = record["/debug/autoscale"]
    check(status == 501 and b"[mesh]" in body, f"/debug/autoscale answered {status} {body[:120]!r}")
    prof = record["profile"]
    status, body, _ms = prof["first"]
    check(status == 200, f"/debug/profile answered {status}: {body[:200]!r}")
    captured = json.loads(body)
    check(prof["second"][0] == 409, f"a concurrent capture answered {prof['second'][0]}")
    check(prof["zero"][0] == 400, f"seconds=0 answered {prof['zero'][0]}")
    with open(captured["trace_file"], encoding="utf-8") as fh:
        trace = json.load(fh)
    kernels = Counter(e.get("name", "") for e in trace["traceEvents"]
                      if str(e.get("cat", "")).lower() == "kernel")
    topk_events = sum(c for name, c in kernels.items() if "block_topk_kernel" in name)
    if dev.type == "cuda":
        check(captured["device"] == "cuda" and "CUDA" in captured["activities"], f"capture {captured}")
        check(topk_events > 0, f"the profile shows no block_topk kernel: {list(kernels)[:8]}")
    record["server"].shutdown()
    signals.reset_sampler()
    # the doctor over the declared graph, and a faulty graph refused
    t0 = _now()
    report = pw.debug.diagnose(answers)
    doctor_ms = (_now() - t0) * 1e3
    boundary = [d for d in report.by_rule("compile-boundary") if d.node is embedded._node]
    check(boundary and "UDF" in boundary[0].message,
          f"no compile-boundary at the embedder: {[d.message for d in report.by_rule('compile-boundary')]}")
    parse_graph.G.clear()
    started = threading.Event()

    class Never(pw.io.python.ConnectorSubject):
        def run(self):
            started.set()
            self.close()

    class KV(pw.Schema):
        k: str
        v: int

    stream = pw.io.python.read(Never(), schema=KV)
    pw.io.null.write(stream.groupby(pw.this.k).reduce(pw.this.k, s=pw.reducers.sum(pw.this.v)))
    try:
        pw.run(diagnostics="error")
    except GraphDoctorError as e:
        refused = [d.rule for d in e.report if d.severity.name != "INFO"]
    else:
        raise AssertionError("diagnostics='error' ran a faulty graph")
    check(parse_graph.G.runtime is None and not started.is_set(), "the faulty graph ticked")
    parse_graph.G.clear()
    # the launch ledger, with the chain's own program among its live cases
    t0 = _now()
    ledger = lowering.prove_lowering()
    prove_s = _now() - t0
    statuses = Counter(e["status"] for e in ledger.entries)
    rejected = sorted(e["family"] for e in ledger.by_status("rejected"))
    check(not ledger.findings and rejected == ["block_topk", "paged_attention"]
          and statuses["proved"] == len(ledger.entries) - 2, f"the launch ledger: {dict(statuses)}")
    seg = next((e for e in ledger.entries if e["family"] == "tick_forge_live"
                and "q2" in e["shape"].get("out_cols", [])), None)
    check(seg is not None and seg["shape"]["rows"] in {row_bucket(len(p)) for p in parts},
          f"the ledger has no program of the chain: {[e['case'] for e in ledger.entries if e['family'] == 'tick_forge_live']}")
    check(launches > 0 or dev.type == "cpu", "block_topk never ran in the observability phase")
    ab = {flag: [(replies[q]["t"] - commits[q]) * 1e3 for f, q in record["ab"] if f == flag]
          for flag in (True, False)}
    lat = lambda xs: {"p50": float(np.percentile(xs, 50)), "max": float(np.max(xs)), "n": len(xs)}  # noqa: E731
    phase = {
        "phase": "observability",
        "nvidia_smi": smi,
        "rows": {"chunks": n, "kept": int(keep.sum()), "embedded": OB_NEW_DOCS},
        "b1_reply_ms_server_sampler_on_off": {"on": lat(ab[True]), "off": lat(ab[False])},
        "b16_reply_ms_control_scraped_captured": {
            label: lat([(replies[q + j]["t"] - commits[q + j]) * 1e3
                        for f, q in record["b16"] if f == label for j in range(16)])
            for label in ("control", "scraped", "captured")},
        "metrics_scrape_ms_under_load": {**lat(record["scrape_ms"]), "every_s": OB_SCRAPE_S},
        "profile_capture_wall_s": prof["wall_s"],
        "profile": {"device_events": captured["device_events"], "block_topk_events": topk_events,
                    "kernels": len(kernels)},
        "doctor_ms": doctor_ms,
        "doctor_findings": dict(Counter(d.rule for d in report)),
        "faulty_graph_refused_by": sorted(set(refused)),
        "prove_lowering_s": prove_s,
        "ledger_cases": dict(statuses),
        "chain_segment": seg_tail,
        "signals_samples": sig["samples"],
        "metrics": m,
        "replies_keys_equal_plain": exact,
        "near_ties": near,
        "ingest_s": record["ingest_s"],
        "burst_s": dict(record["burst_s"]),
        "ticks": rt.stats.ticks,
        "block_topk_launches": launches,
        "block_topk_launches_by_shape": {f"B={b},k={k}": c for (b, k), c in sorted(shapes.items())},
        "run_s": run_s,
        "phase_s": _now() - t_phase,
    }
    q = {1: torch.from_numpy(qvecs[0][None, :]).to(dev),
         16: torch.from_numpy(np.stack([qvecs[OB_B1 + j] for j in range(16)])).to(dev)}
    prep, _c2, valid = ix.corpus.prepared_arrays("cosine", bf16=False)
    return phase, {"prep": prep, "valid": valid, "queries": q, "launches": launches, "shapes": shapes}



# --- phase 18: mesh -----------------------------------------------------------

MESH_SHARDS = 4
MESH_ROWS = 1 << 20  # the sharded index's corpus; the engine part's rows
MESH_TICKS = 16  # commits of MESH_ROWS // MESH_TICKS rows, one tick each
MESH_B1 = 16  # B = 1 asks
MESH_B16 = 4  # B = 16 asks
MESH_KEYS = 1 << 16  # group keys, MESH_KEYS // MESH_TICKS new ones a tick
MESH_REVISIT = 256  # rows a tick whose key is one of the previous tick's
MESH_TEXTS = 1024
MESH_NOISE = 0.05  # a query is a corpus row plus this much noise, renormalised
MESH_ENV = ("PATHWAY_ENGINE_SHARDS", "PATHWAY_MESH_DEVICE")


def mesh_rows(seed: int, rows: int, ticks: int, keys: int, revisit: int) -> dict:
    """The engine part's numeric rows: tick t holds the keys [t * kpt,
    (t + 1) * kpt) (kpt = keys / ticks) in turn, but its first ``revisit``
    rows go to keys of tick t - 1, whose aggregates (and joined rows) are
    retracted and restated; values in [-1000, 1000)."""
    rng = np.random.default_rng(seed)
    per, kpt = rows // ticks, keys // ticks
    g = np.empty(rows, np.int64)
    for t in range(ticks):
        block = t * kpt + np.arange(per) % kpt
        if t:
            block[:revisit] = (t - 1) * kpt + np.arange(revisit)
        g[t * per:(t + 1) * per] = block
    return {"g": g, "v": rng.integers(-1000, 1000, size=rows)}


def mesh_run(pw, s: dict, ticks: int, vecs, asks, index_of, swap=None) -> dict:
    """One run of the mesh phase's graph: rows (rid, g, v[, vec]) through
    pw.io.python in ``ticks`` commits; a groupby-reduce (count, sum) over g
    joined back to its input rows; with ``vecs``, DataIndex over the inner
    index ``index_of(table)`` answering ``asks`` (lists of (qid, vector)),
    each one commit, and with ``swap`` the same asks again after
    ``swap(exec)`` replaced the exec's index. Returns the joined rows' final
    state by key, the replies with their commit-to-reply seconds, and the
    runtime."""
    from pathway_tpu_torch.engine.index_node import ExternalIndexExec
    from pathway_tpu_torch.internals import parse_graph
    from pathway_tpu_torch.ops import block_topk as bt

    _now = time.perf_counter
    n = len(s["g"])
    per = n // ticks
    finished = threading.Event()
    failure: list[BaseException] = []
    rec: dict = {"rows": {}, "replies": {}, "next_s": [], "tick_s": [], "ask_launches": [],
                 "ask_rows": [], "swapped_launches": [], "swapped_rows": []}
    parse_graph.G.clear()

    class RowSchema(pw.Schema):
        rid: int = pw.column_definition(primary_key=True)
        g: int
        v: int

    class VecRowSchema(RowSchema):
        vec: np.ndarray

    class QuerySchema(pw.Schema):
        qid: int = pw.column_definition(primary_key=True)
        vec: np.ndarray

    class Idle(pw.io.python.ConnectorSubject):
        def run(self):
            finished.wait()

    row_subject = Idle()
    n_commits = [0]

    def commit(subject, cond, what: str) -> None:
        subject.commit()
        n_commits[0] += 1
        goal, rt = n_commits[0], parse_graph.G.runtime
        wait_until(lambda: cond() and rt.stats.ticks >= goal, what)

    def ask_all(qs, into: str, rows_into: str) -> None:
        for group in asks:
            before, rows_before = bt.block_topk.launches, bt.block_topk.corpus_rows.copy()
            for qid, v in group:
                qs.next(qid=qid + into_offset[into], vec=v)
            t0 = _now()
            ids = [qid + into_offset[into] for qid, _v in group]
            commit(qs, lambda: all(q in rec["replies"] for q in ids), "a query's reply")
            for q in ids:
                rec["replies"][q]["s"] = rec["replies"][q]["t"] - t0
            rec[into].append(bt.block_topk.launches - before)
            rec[rows_into].append(dict(bt.block_topk.corpus_rows - rows_before))

    into_offset = {"ask_launches": 0, "swapped_launches": 1 << 20}

    def drive(qs) -> None:
        g, v = s["g"].tolist(), s["v"].tolist()
        for t in range(ticks):
            tp = _now()
            if vecs is None:
                for j in range(t * per, (t + 1) * per):
                    row_subject.next(rid=j, g=g[j], v=v[j])
            else:
                for j in range(t * per, (t + 1) * per):
                    row_subject.next(rid=j, g=g[j], v=v[j], vec=vecs[j])
            tc = _now()
            rec["next_s"].append(tc - tp)
            commit(row_subject, lambda: True, "a row commit")
            rec["tick_s"].append(_now() - tc)
        if vecs is None:
            return
        ask_all(qs, "ask_launches", "ask_rows")
        if swap is not None:
            rt = parse_graph.G.runtime
            ex = next(e for e in rt.execs.values() if isinstance(e, ExternalIndexExec))
            rec["sharded_index"] = ex.index
            swap(ex)
            ask_all(qs, "swapped_launches", "swapped_rows")

    class QuerySubject(pw.io.python.ConnectorSubject):
        def run(self):
            try:
                drive(self)
            except BaseException as e:  # noqa: BLE001 — re-raised after pw.run
                failure.append(e)
            finally:
                finished.set()

    schema = RowSchema if vecs is None else VecRowSchema
    rows = pw.io.python.read(row_subject, schema=schema, autocommit_duration_ms=None)
    nums = rows.select(rid=pw.this.rid, g=pw.this.g, v=pw.this.v)
    agg = nums.groupby(nums.g).reduce(nums.g, c=pw.reducers.count(), s=pw.reducers.sum(nums.v))
    joined = agg.join(nums, agg.g == nums.g).select(rid=pw.right.rid, g=pw.right.g, v=pw.right.v,
                                                     c=pw.left.c, s=pw.left.s)

    def on_row(key, row, time, is_addition):
        k = int(key)
        vals = (row["rid"], row["g"], row["v"], row["c"], row["s"])
        if is_addition:
            rec["rows"][k] = vals
        elif rec["rows"].get(k) == vals:
            del rec["rows"][k]

    pw.io.subscribe(joined, on_change=on_row)
    queries = pw.io.python.read(QuerySubject(), schema=QuerySchema, autocommit_duration_ms=None)
    # the query subject drives both sources: keep it in every graph
    pw.io.subscribe(queries, on_change=lambda key, row, time, is_addition: None)
    if vecs is not None:
        from pathway_tpu_torch.stdlib.indexing import DataIndex

        index = DataIndex(rows, index_of(rows))
        answers = index.query_as_of_now(queries.vec, number_of_matches=K).select(
            qid=pw.left.qid, ids=pw.right._pw_index_reply_id, scores=pw.right._pw_index_reply_score)

        def on_reply(key, row, time, is_addition):
            if is_addition and row["qid"] not in rec["replies"]:
                rec["replies"][row["qid"]] = {"t": _now(), "ids": tuple(int(i) for i in row["ids"]),
                                              "scores": tuple(float(x) for x in row["scores"])}

        pw.io.subscribe(answers, on_change=on_reply)
    t0 = _now()
    pw.run()
    rec["run_s"] = _now() - t0
    if failure:
        raise failure[0]
    rec["runtime"] = parse_graph.G.last_runtime
    return rec


def mesh_plain_child(out: str, rows: int, ticks: int, keys: int, revisit: int) -> int:
    """The mesh phase's unsharded engine run, in a process of its own beside
    the sharded run (no engine mesh, no card): the same rows through the
    same graph; writes the joined rows' final state to ``out``.npz and its
    run figures to ``out``.json."""
    import pathway_tpu_torch as pw

    for k in MESH_ENV:
        os.environ.pop(k, None)
    s = mesh_rows(SEED + 73, rows, ticks, keys, revisit)
    rec = mesh_run(pw, s, ticks, None, [], None)
    rt = rec.pop("runtime")
    rows = rec["rows"]
    np.savez(out, keys=np.fromiter(rows.keys(), dtype=np.uint64, count=len(rows)),
             vals=np.array(list(rows.values()), dtype=np.int64).reshape(-1, 5))
    with open(out + ".json", "w") as f:
        json.dump({"run_s": rec["run_s"], "tick_s": rec["tick_s"], "next_s": rec["next_s"],
                   "ticks": rt.stats.ticks, "frontier_syncs": rt.frontier_syncs,
                   "engine_mesh": rt.engine_mesh is not None}, f)
    return 0


def mesh(dev, smi: str, rate: float, emb) -> tuple[dict, dict]:
    """The in-process device mesh on the card: make_mesh(MESH_SHARDS) puts
    its shards round-robin over the cards there are (all on cuda:0 here).
    (a) A sharded live index at the main path's width: MESH_ROWS seeded unit
    vectors (D = 384) through pw.io.python in MESH_TICKS commits into
    DataIndex over TpuKnn(mesh=mesh), MESH_B1 B = 1 and MESH_B16 B = 16
    asks (k = 10) of noisy corpus rows; every reply against
    sharded_topk_ref on the same device slices and the merged top-10
    against bf16 dense_topk over the whole corpus, up to near ties within
    BF16_TOL; each search launches block_topk once per shard at N =
    MESH_ROWS / MESH_SHARDS. The same asks again with the exec's index
    swapped for an unsharded TpuDenseKnnIndex loaded from its snapshot give
    the unsharded reply times on the same corpus. (b) The same run is under
    PATHWAY_ENGINE_SHARDS=MESH_SHARDS (get_engine_mesh on cuda): the rows'
    numeric columns feed a groupby-reduce (count, sum) over MESH_KEYS keys
    joined back to its rows, whose final state must equal an unsharded run's
    (a child process running the same graph on the same rows meanwhile,
    ``--mesh-plain-child``) row for row and numpy's aggregates; the device
    exchange ran,
    frontier_syncs is one per tick, the shards' key sets are disjoint and
    cover every key. (c) MESH_TEXTS texts through
    SentenceTransformerEmbedder(mesh=mesh) against the unsharded embedder
    ``emb`` (the same seeded weights) within CROSS_RUN_TOL. Prints the
    per-shard kernel ms against its bound and the library call, the reply
    p50s sharded and unsharded, the exchange and frontier ms per tick."""
    _now = time.perf_counter
    t_phase = _now()
    # the unsharded engine run, meanwhile, in a process of its own
    tmp = tempfile.mkdtemp(prefix="pw_mesh_")
    child_out = os.path.join(tmp, "plain")
    env = {k: v for k, v in os.environ.items() if k not in MESH_ENV}
    env["CUDA_VISIBLE_DEVICES"] = ""
    with open(child_out + ".log", "w") as log:
        sizes = [str(x) for x in (MESH_ROWS, MESH_TICKS, MESH_KEYS, MESH_REVISIT)]
        child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-plain-child", child_out,
                                  *sizes], env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        return mesh_phase(dev, smi, rate, emb, child, child_out, t_phase)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_phase(dev, smi: str, rate: float, emb, child, child_out: str, t_phase: float) -> tuple[dict, dict]:
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine import runtime as runtime_mod
    from pathway_tpu_torch.engine import sharded as sharded_mod
    from pathway_tpu_torch.observability import REGISTRY
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.knn import BLK, _normalize, dense_topk, sharded_topk_ref
    from pathway_tpu_torch.parallel import make_mesh
    from pathway_tpu_torch.parallel.mesh import reset_engine_mesh
    from pathway_tpu_torch.stdlib.indexing import TpuKnn
    from pathway_tpu_torch.stdlib.indexing._index_impls import TpuDenseKnnIndex
    from pathway_tpu_torch.xpacks.llm.embedders import SentenceTransformerEmbedder

    _now = time.perf_counter
    m = make_mesh(MESH_SHARDS, device=dev.type)
    placement = [str(d) for d in m.shard_devices()]
    print(f"mesh: {MESH_SHARDS} shards on {placement}", flush=True)
    # dev is the card (cuda:0): no shard may sit on the CPU
    check(all(d == dev for d in m.shard_devices()), f"a mesh shard is not on {dev}: {placement}")
    per_shard = MESH_ROWS // MESH_SHARDS

    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    vecs = torch.randn(MESH_ROWS, DIM, generator=gen, device=dev)
    vecs = (vecs / vecs.norm(dim=-1, keepdim=True)).cpu().numpy()
    rng = np.random.default_rng(SEED + 72)
    src = rng.choice(MESH_ROWS, size=MESH_B1 + 16 * MESH_B16, replace=False)
    qv = vecs[src] + MESH_NOISE * rng.standard_normal((len(src), DIM)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    asks = [[(i, qv[i])] for i in range(MESH_B1)] + [
        [(MESH_B1 + 16 * b + j, qv[MESH_B1 + 16 * b + j]) for j in range(16)] for b in range(MESH_B16)]
    s = mesh_rows(SEED + 73, MESH_ROWS, MESH_TICKS, MESH_KEYS, MESH_REVISIT)

    # the exchange and the frontier consensus, timed where they run
    timing = {"exchange_s": Counter(), "exchange_bytes": Counter(), "frontier_s": []}
    route_device, consensus = sharded_mod._ShardRouter._route_device, runtime_mod.Runtime._frontier_consensus

    def timed_route(router, b, dest, numeric_cols):
        t0 = _now()
        out = route_device(router, b, dest, numeric_cols)
        tick = pw.internals.parse_graph.G.runtime.stats.ticks
        timing["exchange_s"][tick] += _now() - t0
        # int32 words a row: key and diff (2 each), then each column's
        width = 4 + sum(max(1, a.dtype.itemsize // 4) for arrs, _sp in numeric_cols for a in arrs)
        timing["exchange_bytes"][tick] += 2 * 4 * width * len(b)  # up and back down
        return out

    def timed_consensus(rt, t):
        t0 = _now()
        out = consensus(rt, t)
        timing["frontier_s"].append(_now() - t0)
        return out

    def exchanges(transport: str) -> float:
        fam = REGISTRY.get("pathway_shard_exchanges_total")
        return 0.0 if fam is None else fam.labels(transport).value

    def swap(ex) -> None:
        plain = TpuDenseKnnIndex(dimensions=DIM, metric="cosine", reserved_space=MESH_ROWS, device=dev)
        plain.load_state(ex.index.state_dict())
        ex.index = plain

    saved_env = {k: os.environ.get(k) for k in MESH_ENV}
    os.environ.update(PATHWAY_ENGINE_SHARDS=str(MESH_SHARDS), PATHWAY_MESH_DEVICE=dev.type)
    reset_engine_mesh()
    sharded_mod._ShardRouter._route_device = timed_route
    runtime_mod.Runtime._frontier_consensus = timed_consensus
    bt.block_topk.launches = 0
    bt.block_topk.shapes.clear()
    bt.block_topk.corpus_rows.clear()
    dev_ex0 = exchanges("device")
    try:
        sharded = mesh_run(pw, s, MESH_TICKS, vecs, asks, lambda t: TpuKnn(
            t.vec, dimensions=DIM, reserved_space=MESH_ROWS, mesh=m, device=dev), swap=swap)
    finally:
        sharded_mod._ShardRouter._route_device = route_device
        runtime_mod.Runtime._frontier_consensus = consensus
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset_engine_mesh()
    device_exchanges = exchanges("device") - dev_ex0
    ix = sharded.pop("sharded_index")
    rt = sharded.pop("runtime")
    t_wait = _now()
    rc = child.wait(timeout=600)
    child_wait_s = _now() - t_wait
    if rc != 0:
        with open(child_out + ".log") as f:
            print(f.read()[-4000:], file=sys.stderr)
    check(rc == 0, f"the unsharded engine run exited {rc}")
    with open(child_out + ".json") as f:
        plain = json.load(f)
    got = np.load(child_out + ".npz")
    plain["rows"] = dict(zip(got["keys"].tolist(), map(tuple, got["vals"].tolist())))

    # (a) the sharded index
    check(ix.mesh is m and ix.corpus.sharding is not None, "the index is not sharded over the mesh")
    slices, valids = ix.corpus.device_arrays()
    check(len(slices) == MESH_SHARDS and all(c.shape[0] == per_shard for c in slices),
          f"the corpus slices are {[tuple(c.shape) for c in slices]}")
    check(len(ix) == MESH_ROWS, f"the sharded index holds {len(ix)} rows")
    keys_of = np.array([ix.corpus.key_of[i] for i in range(MESH_ROWS)], dtype=object)
    whole, whole_valid = torch.cat(slices), torch.cat(valids)
    exact = near = 0
    for qid in range(len(src)):
        for off, what in ((0, "sharded"), (1 << 20, "unsharded")):
            check(qid + off in sharded["replies"], f"ask {qid} has no {what} reply")
    for group in asks:
        q = torch.from_numpy(np.stack([v for _q, v in group])).to(dev)
        sr, ir = sharded_topk_ref(q, slices, valids, K, mesh=m, metric="cosine", bf16=True)
        sw, iw = dense_topk(q, whole, whole_valid, K, metric="cosine", bf16=True)
        sr, ir, sw, iw = (x.cpu().numpy() for x in (sr, ir, sw, iw))
        for row, (qid, _v) in enumerate(group):
            got = tuple(zip(sharded["replies"][qid]["ids"],
                            (x + 1.0 for x in sharded["replies"][qid]["scores"])))
            ref = tuple((int(keys_of[i]), float(x)) for i, x in zip(ir[row], sr[row]))
            ref_whole = tuple((int(keys_of[i]), float(x)) for i, x in zip(iw[row], sw[row]))
            check(same_up_to_near_ties(got, ref, BF16_TOL), f"ask {qid}: reply differs from sharded_topk_ref")
            check(same_up_to_near_ties(ref, ref_whole, BF16_TOL),
                  f"ask {qid}: the merged top-{K} differs from dense_topk over the whole corpus")
            exact += [k for k, _s in got] == [k for k, _s in ref]
            near += [k for k, _s in ref] != [k for k, _s in ref_whole]
    check(all(n_l == MESH_SHARDS for n_l in sharded["ask_launches"]),
          f"a sharded search launched block_topk {sharded['ask_launches']} times, not once per shard")
    check(all(r == {per_shard: MESH_SHARDS} for r in sharded["ask_rows"]),
          f"the per-shard launches scanned {sharded['ask_rows']}, not N = {per_shard}")
    check(all(r == {MESH_ROWS: 1} for r in sharded["swapped_rows"]),
          f"the unsharded index's launches scanned {sharded['swapped_rows']}")
    top1 = sum(sharded["replies"][q]["ids"][0] == int(keys_of[src[q]]) for q in range(len(src)))
    del whole, whole_valid

    # (b) the sharded engine against the unsharded run and numpy
    check(sharded["rows"] == plain["rows"], "the sharded engine's rows differ from the unsharded run's")
    check(len(plain["rows"]) == MESH_ROWS, f"the joined output holds {len(plain['rows'])} rows")
    count = np.bincount(s["g"], minlength=MESH_KEYS)
    total = np.bincount(s["g"], weights=s["v"], minlength=MESH_KEYS).astype(np.int64)
    check(all(c == count[g] and sm == total[g] for _r, g, _v, c, sm in plain["rows"].values()),
          "a joined aggregate differs from numpy's")
    check(rt.engine_mesh is not None and rt.engine_mesh[0].shape == {"data": MESH_SHARDS}
          and all(d.type == dev.type for d in rt.engine_mesh[0].shard_devices()),
          f"the engine mesh is not on {dev.type}")
    check(not plain["engine_mesh"] and plain["frontier_syncs"] == 0, "the unsharded run sharded")
    check(device_exchanges > 0, "pathway_shard_exchanges_total{transport=device} did not move")
    check(rt.frontier_syncs == rt.stats.ticks - 1,
          f"frontier_syncs {rt.frontier_syncs} for {rt.stats.ticks} ticks (one final)")
    # the groupby over g holds the most keys (DataIndex's own group query ids)
    groupbys = [e.shard_group_keys() for e in rt.execs.values()
                if isinstance(e, sharded_mod.ShardedGroupByExec)]
    check(bool(groupbys), "no groupby sharded")
    owned = max(groupbys, key=lambda o: sum(len(x) for x in o))
    check(sum(len(o) for o in owned) == MESH_KEYS and len(set().union(*owned)) == MESH_KEYS,
          "the shards' group keys overlap or miss a key")
    check(all(len(o) > 0 for o in owned), "a shard owns no group key")
    joins = [e for e in rt.execs.values() if isinstance(e, sharded_mod.ShardedJoinExec)]
    check(any(e.router.device_exchanges > 0 for e in joins), "no sharded join took the device exchange")

    # (c) data-parallel batches
    texts = synthetic_docs(MESH_TEXTS, np.random.default_rng(SEED + 74))
    t0 = _now()
    emb_mesh = SentenceTransformerEmbedder(mesh=m, device=dev)
    init_s = _now() - t0
    check(len(emb_mesh.runtime._replicas) == 1, "the mesh encoder holds a copy per shard")
    emb_mesh.embed_batch(texts[:64])  # warm-up
    torch.cuda.synchronize()
    t0 = _now()
    a = np.stack(emb_mesh.embed_batch(texts))
    sharded_embed_s = _now() - t0
    t0 = _now()
    b = np.stack(emb.embed_batch(texts))
    plain_embed_s = _now() - t0
    enc_err = float(np.abs(a - b).max())
    check(a.shape == (MESH_TEXTS, DIM) and bool(np.isfinite(a).all()), "mesh embeddings' shape")
    check(enc_err <= CROSS_RUN_TOL, f"the mesh embedder differs from the unsharded one by {enc_err}")
    del emb_mesh

    # the per-shard kernel against its bound and the library call
    preps, _c2s, pvalids = ix.corpus.prepared_arrays("cosine", bf16=True)
    prep, pvalid = preps[0], pvalids[0]
    kernel = {}
    queries = {}
    for bs, lo in ((1, 0), (16, MESH_B1)):
        q = torch.from_numpy(qv[lo:lo + bs]).to(dev)
        queries[bs] = q
        qn = _normalize(q).to(prep.dtype).contiguous()
        before = bt.block_topk.launches, bt.block_topk.shapes.copy(), bt.block_topk.corpus_rows.copy()
        ms = cuda_ms(lambda: bt.block_topk(qn, prep, pvalid, K))

        def library():
            sc = torch.matmul(qn, prep.T).masked_fill_(~pvalid[None, :], -float("inf"))
            return torch.topk(sc.view(bs, per_shard // BLK, BLK), K, dim=-1)

        library_ms = cuda_ms(library, iters=5)
        plain_ms = cuda_ms(lambda: bt.block_topk_ref(qn, prep, pvalid, K), iters=5)
        bt.block_topk.launches, bt.block_topk.shapes, bt.block_topk.corpus_rows = before
        nbytes = per_shard * DIM * 2 + bs * DIM * 2 + per_shard + bs * (per_shard // BLK) * K * 8
        t_bytes = nbytes / rate * 1e3
        t_ops = 2.0 * bs * per_shard * DIM / PEAK_OPS_PER_S["bfloat16"] * 1e3
        kernel[f"B={bs}"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                             "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                             "bytes": nbytes}

    def p50_ms(offset: int, lo: int, hi: int) -> float:
        return float(np.percentile([sharded["replies"][q + offset]["s"] * 1e3 for q in range(lo, hi)], 50))

    b16 = [MESH_B1 + 16 * b for b in range(MESH_B16)]
    ex_ticks = sorted(timing["exchange_s"])
    phase = {
        "phase": "mesh",
        "nvidia_smi": smi,
        "shards": MESH_SHARDS,
        "placement": placement,
        "corpus_rows": MESH_ROWS,
        "rows_per_shard": per_shard,
        "ticks": MESH_TICKS,
        "sharded_run_s": sharded["run_s"],
        "unsharded_engine_run_s": plain["run_s"],
        "unsharded_child_wait_s": child_wait_s,
        "next_s": float(np.sum(sharded["next_s"])),
        "tick_s_p50": float(np.percentile(sharded["tick_s"], 50)),
        "unsharded_tick_s_p50": float(np.percentile(plain["tick_s"], 50)),
        "reply_p50_ms": {
            "sharded": {"B=1": p50_ms(0, 0, MESH_B1), "B=16": float(np.percentile(
                [sharded["replies"][q]["s"] * 1e3 for q in b16], 50))},
            "unsharded": {"B=1": p50_ms(1 << 20, 0, MESH_B1), "B=16": float(np.percentile(
                [sharded["replies"][q + (1 << 20)]["s"] * 1e3 for q in b16], 50))},
        },
        "replies_equal_sharded_topk_ref": exact,
        "replies_compared": len(src),
        "merged_vs_whole_corpus_near_ties": near,
        "top1_is_the_noisy_row": top1,
        "block_topk_launches_per_search": sharded["ask_launches"],
        "block_topk_rows_per_launch": per_shard,
        "per_shard_kernel": kernel,
        "engine": {
            "rows": MESH_ROWS, "keys": MESH_KEYS, "ticks": rt.stats.ticks,
            "frontier_syncs": rt.frontier_syncs, "device_exchanges": device_exchanges,
            "keys_per_shard": [len(o) for o in owned],
            "rows_equal_unsharded": True,
            "exchange_ms_per_tick": {"p50": float(np.percentile([timing["exchange_s"][t] * 1e3
                                                                 for t in ex_ticks], 50)),
                                     "max": max(timing["exchange_s"][t] * 1e3 for t in ex_ticks),
                                     "ticks": len(ex_ticks)},
            "exchange_bytes_per_tick_p50": float(np.percentile([timing["exchange_bytes"][t]
                                                                for t in ex_ticks], 50)),
            "exchange_copy_bound_ms_p50": float(np.percentile([timing["exchange_bytes"][t]
                                                               for t in ex_ticks], 50)) / CT_LINK_BYTES_PER_S * 1e3,
            "frontier_ms": {"p50": float(np.percentile(timing["frontier_s"], 50)) * 1e3,
                            "max": max(timing["frontier_s"]) * 1e3, "syncs": len(timing["frontier_s"])},
        },
        "encoder": {"texts": MESH_TEXTS, "max_abs_err": enc_err, "tol": CROSS_RUN_TOL, "init_s": init_s,
                    "sharded_embed_s": sharded_embed_s, "unsharded_embed_s": plain_embed_s},
        "phase_s": _now() - t_phase,
    }
    shapes = Counter()
    for group, n in zip(asks, sharded["ask_launches"]):
        shapes[(len(group), K)] += n
    data = {"prep": prep, "valid": pvalid, "queries": queries, "launches": sum(sharded["ask_launches"]),
            "shapes": dict(shapes), "index": ix}
    return phase, data


# --- phase 19: kernel times ---------------------------------------------------


def kernel_times(main: dict, eng: dict, vs: dict, rest: dict, persist: dict, ik: dict, cc: dict,
                 lc: dict, wi: dict, cdc: dict, ct: dict, rep: dict, gen: dict, ob: dict, msh: dict,
                 rate: float, rate_src: str) -> list[dict]:
    from pathway_tpu_torch.analysis import lowering
    from pathway_tpu_torch.ops import block_topk as bt
    from pathway_tpu_torch.ops.knn import BLK, _normalize

    # (B, k, queries, launches of that shape on its path, path, its corpus)
    m_corpus, e_corpus = (main["prep"], main["valid"]), (eng["prep"], eng["valid"])
    v_corpus = (vs["prep"], vs["valid"])
    hyb, gt = ik["hybrid"], ik["ground_truth"]
    h_corpus = (hyb["prep"], hyb["valid"])
    path_shapes = [
        (1, K, main["queries"][1], main["shapes"].get((1, K), 0), "retrieval", m_corpus),
        (16, K, main["queries"][16], main["shapes"].get((16, K), 0), "retrieval", m_corpus),
        (16, 4 * K, main["queries"]["filtered"], main["shapes"].get((16, 4 * K), 0),
         "retrieval (filtered)", m_corpus),
        (1, K, eng["queries"][1], eng["shapes"].get((1, K), 0), "engine", e_corpus),
        (16, K, eng["queries"][16], eng["shapes"].get((16, K), 0), "engine", e_corpus),
        (1, K, vs["queries"][1], vs["shapes"].get((1, K), 0), "vector store", v_corpus),
        (16, K, vs["queries"][16], vs["shapes"].get((16, K), 0), "vector store", v_corpus),
        (16, 4 * K, vs["queries"]["filtered"], vs["shapes"].get((16, 4 * K), 0),
         "vector store (filtered)", v_corpus),
        (32, RETRIEVE_K, gen["asks"], gen["topk_shapes"].get((32, RETRIEVE_K), 0), "generation",
         m_corpus),
        (1, K, persist["queries"][1], persist["shapes"].get((1, K), 0), "persistence (restored)",
         (persist["prep"], persist["valid"])),
        (16, K, persist["queries"][16], persist["shapes"].get((16, K), 0), "persistence (restored)",
         (persist["prep"], persist["valid"])),
        (1, K, hyb["queries"][1], hyb["shapes"].get((1, K), 0), "index kinds (hybrid)", h_corpus),
        (16, K, hyb["queries"][16], hyb["shapes"].get((16, K), 0), "index kinds (hybrid)", h_corpus),
        (16, K, gt["queries"][16], gt["shapes"].get((16, K), 0), "index kinds (IVF ground truth)",
         (gt["prep"], gt["valid"])),
    ] + [
        # every shape the REST phase launched: the gate's micro-batches and
        # the concurrent ungated ticks after the index's pad ladder
        (b, k, rest["queries"][b], n, "rest", (rest["prep"], rest["valid"]))
        for (b, k), n in sorted(rest["shapes"].items())
    ] + [
        # every standing query of the components phase in one batch
        (b, k, cc["queries"][b], n, "components", (cc["prep"], cc["valid"]))
        for (b, k), n in sorted(cc["shapes"].items())
    ] + [
        # the live classifier's standing queries, per index
        (b, k, lc["queries"][b], n, "live classify", (lc["prep"], lc["valid"]))
        for (b, k), n in sorted(lc["shapes"].items())
    ] + [
        # the windowed index's standing queries, on its corpus at the end
        (b, k, wi["queries"][b], n, "windowed index", (wi["prep"], wi["valid"]))
        for (b, k), n in sorted(wi["shapes"].items())
    ] + [
        # the CDC-fed index's standing queries, on its corpus at the end
        (b, k, cdc["queries"][b], n, "cdc index", (cdc["prep"], cdc["valid"]))
        for (b, k), n in sorted(cdc["shapes"].items())
    ] + [
        # the live index behind the compiled feed's standing queries
        (b, k, ct["queries"][b], n, "compiled ticks", (ct["prep"], ct["valid"]))
        for (b, k), n in sorted(ct["shapes"].items())
    ] + [
        # the replica children's reads (k = 10) and /generate's retrieval
        # (k = 3), each one search on the writer's corpus
        (b, k, rep["queries"][b], n, "replication (replica processes)", (rep["prep"], rep["valid"]))
        for (b, k), n in sorted(rep["shapes"].items())
    ] + [
        # the monitored live index's B = 1 and B = 16 query ticks
        (b, k, ob["queries"][b], n, "observability", (ob["prep"], ob["valid"]))
        for (b, k), n in sorted(ob["shapes"].items())
    ] + [
        # the sharded index's searches: one launch per shard, each on its
        # shard's bf16 slice (shard 0's here; the four are the same shape)
        (b, k, msh["queries"][b], n, f"mesh (one shard of {MESH_SHARDS}, bf16)", (msh["prep"], msh["valid"]))
        for (b, k), n in sorted(msh["shapes"].items())
    ]
    per_batch = []
    for bs, k, q, path_launches, path, (prep, valid) in path_shapes:
        n, d = prep.shape
        check(path_launches > 0, f"block_topk never ran at B={bs}, k={k} on the {path} path")
        qn = _normalize(q).to(prep.dtype).contiguous()
        before = bt.block_topk.launches, bt.block_topk.shapes.copy()
        ms = cuda_ms(lambda: bt.block_topk(qn, prep, valid, k))
        times = device_times(lambda: bt.block_topk(qn, prep, valid, k))
        plain_ms = cuda_ms(lambda: bt.block_topk_ref(qn, prep, valid, k), iters=5)

        def library():
            s = torch.matmul(qn, prep.T).masked_fill_(~valid[None, :], -float("inf"))
            return torch.topk(s.view(bs, n // BLK, BLK), k, dim=-1)

        library_ms = cuda_ms(library, iters=5)
        sc, ix = bt.block_topk(qn, prep, valid, k)
        sr, ir = bt.block_topk_ref(qn, prep, valid, k)
        # the launch ledger's shared memory and threads for this (B, k,
        # dtype) are what the built kernel set at this launch, and the grid
        # it took from the card's occupancy lies within the ledger's largest
        bf16 = prep.dtype == torch.bfloat16
        launched = bt.last_launch()
        smem = launched["smem_bytes"]
        ledger = lowering.block_topk_launch(bs, d, n, k, bf16)
        (gx, gy, gz), (mx, my, mz) = launched["grid"], ledger["grid_max"]
        check(smem == ledger["smem_bytes"] and launched["threads"] == ledger["threads"]
              and 1 <= gx <= mx and gy == my and gz == mz == 1,
              f"block_topk launched with {launched}, the ledger says {ledger}")
        # timing launches are not the path's
        bt.block_topk.launches, bt.block_topk.shapes = before
        # a block with no valid row scores -inf in both (the persistence
        # corpus reserves whole blocks ahead of its rows)
        live = torch.isfinite(sr)
        check(torch.equal(torch.isfinite(sc), live), f"block_topk timing inputs disagree on -inf at B={bs}")
        err = float((sc - sr)[live].abs().max())
        check(err <= F32_TOL, f"block_topk timing inputs disagree by {err} at B={bs}")
        elem = prep.element_size()
        bytes_read = n * d * elem + bs * d * elem + n  # corpus, queries, valid
        nbytes = bytes_read + bs * (n // BLK) * k * 8  # + the candidates written
        ops = 2.0 * bs * n * d
        t_bytes = nbytes / rate * 1e3
        t_ops = ops / PEAK_OPS_PER_S[str(prep.dtype).split(".")[-1]] * 1e3
        per_batch.append({
            "B": bs, "N": n, "D": d, "k": k, "dtype": str(prep.dtype).split(".")[-1],
            "path": path, "launches": path_launches, "query_tile": ledger["query_tile"],
            "dynamic_smem_bytes": smem, "launch_grid": launched["grid"],
            "ms": ms, "device_ms": kernel_device_ms(times, "block_topk_kernel", 20),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_read": bytes_read, "bytes": nbytes, "ops": ops, "max_abs_err": err,
        })
    head = per_batch[0]  # B=1: the "KNN p50 @1M x 384" shape
    return [{
        "name": "block_topk",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/block_topk.cu",
        "replaces": "pathway_tpu/ops/pallas_topk.py:69",
        "launches": main["launches"],
        "engine_launches": eng["launches"],
        "engine_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(eng["shapes"].items())},
        "vector_store_launches": vs["launches"],
        "vector_store_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(vs["shapes"].items())},
        "rest_launches": rest["launches"],
        "rest_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(rest["shapes"].items())},
        "persistence_launches": persist["launches"],
        "persistence_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(persist["shapes"].items())},
        "index_kinds_launches": hyb["launches"],
        "index_kinds_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(hyb["shapes"].items())},
        "ivf_ground_truth_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(gt["shapes"].items())},
        "components_launches": cc["launches"],
        "components_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(cc["shapes"].items())},
        "live_classify_launches": lc["launches"],
        "live_classify_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(lc["shapes"].items())},
        "windowed_index_launches": wi["launches"],
        "windowed_index_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(wi["shapes"].items())},
        "cdc_index_launches": cdc["launches"],
        "cdc_index_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(cdc["shapes"].items())},
        "compiled_ticks_launches": ct["launches"],
        "compiled_ticks_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(ct["shapes"].items())},
        "replication_launches": sum(rep["shapes"].values()),
        "replication_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(rep["shapes"].items())},
        "observability_launches": ob["launches"],
        "observability_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(ob["shapes"].items())},
        "mesh_launches": msh["launches"],
        "mesh_launches_by_shape": {f"B={b},k={k}": n for (b, k), n in sorted(msh["shapes"].items())},
        "max_abs_err": max(p["max_abs_err"] for p in per_batch),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_call": "torch.matmul + masked_fill_ + torch.topk per 1024-row block",
        "memory_rate": rate_src,
        "per_batch": per_batch,
    }]


def paged_shape_times(label: str, q, k, v, pt, sl, sm_scale: float, rate: float) -> dict:
    """The paged-attention kernel, its plain version and the library
    yardstick on one set of inputs, with the bound from what they need."""
    import torch.nn.functional as F

    from pathway_tpu_torch.ops import paged_attention as pa

    b, h, dp = q.shape
    _n, _h, p, _dp = k.shape
    ctx = pt.shape[1] * p
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = pa.split_count(b * h, pt.shape[1], p, dp, sms)
    before = pa.paged_attention.launches
    ms = cuda_ms(lambda: pa.paged_attention(q, k, v, pt, sl, sm_scale=sm_scale), iters=100)
    plain_ms = cuda_ms(lambda: pa.paged_attention_ref(q, k, v, pt, sl, sm_scale=sm_scale), iters=10)
    ptl = pt.long()
    mask = (torch.arange(ctx, device=q.device)[None, :] < sl[:, None])[:, None, None, :]

    def library():  # gather the pages, then one fused attention call
        kk = k[ptl].permute(0, 2, 1, 3, 4).reshape(b, h, ctx, dp)
        vv = v[ptl].permute(0, 2, 1, 3, 4).reshape(b, h, ctx, dp)
        return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv, attn_mask=mask, scale=sm_scale)

    library_ms = cuda_ms(library, iters=10)
    times = device_times(lambda: pa.paged_attention(q, k, v, pt, sl, sm_scale=sm_scale))
    got = pa.paged_attention(q, k, v, pt, sl, sm_scale=sm_scale)
    ref = pa.paged_attention_ref(q, k, v, pt, sl, sm_scale=sm_scale)
    pa.paged_attention.launches = before  # timing launches are not the path's
    # the launch ledger's split count and shared memory are this launch's
    from pathway_tpu_torch.analysis import lowering

    launched = pa.last_launch()
    smem = launched["smem_bytes"]
    ledger = lowering.paged_attention_launch(b, h, p, dp, pt.shape[1], sms)
    check(smem == ledger["smem_bytes"] and launched["threads"] == ledger["threads"]
          and launched["grid"] == ledger["grid"] and ledger["splits"] == splits,
          f"paged_attention launched with {launched}, {splits} splits; the ledger says {ledger}")
    n = sl.clamp(0, ctx).long()
    live = int(n.sum())
    # each live K and V row read once, q read and the output written once,
    # the live page-table entries and seq_lens read once
    nbytes = live * h * dp * 4 * 2 + 2 * b * h * dp * 4 + int(((n + p - 1) // p).sum()) * 4 + b * 4
    ops = 4.0 * live * h * dp  # q.k and w.v, 2 operations per multiply-add
    t_bytes = nbytes / rate * 1e3
    t_ops = ops / PEAK_OPS_PER_S["float32"] * 1e3
    return {
        "shape": label, "B": b, "H": h, "P": p, "Dp": dp, "n_pages": k.shape[0],
        "max_pages": pt.shape[1], "splits": splits,
        "dynamic_smem_bytes": smem, "live_tokens": live,
        "ms": ms, "device_ms": kernel_device_ms(times, "paged_decode_kernel", 20),
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "ops": ops, "max_abs_err": float((got - ref).abs().max()),
    }


def paged_kernel_times(gen: dict, rep: dict, rate: float, rate_src: str) -> dict:
    q, k, v, pt, sl = layer_inputs(gen["step"])
    shapes = [paged_shape_times("main path (recorded step, layer 0)", q, k, v, pt, sl, 1.0, rate)]
    # /generate on replica 1: the same asks' decode step, recorded in process
    shapes.append(paged_shape_times("/generate on a replica (recorded step, layer 0)",
                                    *layer_inputs(rep["generate_step"]), 1.0, rate))
    # long context: 32 sequences of 2048 tokens over 4096 scattered pages
    dev = q.device
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    b, h, p, dp, mp = 32, 8, 16, 128, 128
    k = torch.randn(b * mp + 1, h, p, dp, generator=g, device=dev)
    v = torch.randn(b * mp + 1, h, p, dp, generator=g, device=dev)
    q = torch.randn(b, h, dp, generator=g, device=dev)
    pt = (torch.randperm(b * mp, generator=g, device=dev) + 1).to(torch.int32).reshape(b, mp)
    sl = torch.full((b,), mp * p, dtype=torch.int32, device=dev)
    shapes.append(paged_shape_times("long context", q, k, v, pt, sl, 32**-0.5, rate))
    check(all(s["max_abs_err"] <= PA_TOL for s in shapes), "paged attention timing inputs disagree")
    head = shapes[0]
    return {
        "name": "paged_attention",
        "route": "cuda",
        "source": "pathway_tpu_torch/csrc/paged_attention.cu",
        "replaces": "pathway_tpu/ops/paged_attention.py:118",
        "launches": gen["launches"],
        "replication_launches": rep["paged_launches"],
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_call": "two calls: k_pool[page_tables] gather + "
        "torch.nn.functional.scaled_dot_product_attention with a boolean mask",
        "memory_rate": rate_src,
        "per_shape": shapes,
    }


def main() -> int:
    if sys.argv[1:2] == ["--rest-client"]:
        return rest_client()
    if sys.argv[1:2] == ["--mesh-plain-child"]:  # host only: no card needed
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        return mesh_plain_child(sys.argv[2], *map(int, sys.argv[3:7]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from pathway_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the pathway_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Tick Scope keeps every tick of a phase, so a window's ticks are all
    # there when the phase reads them
    os.environ.setdefault("PATHWAY_TICKSCOPE_RING", str(1 << 20))
    if sys.argv[1:2] == ["--kill-child"]:
        return kill_child(sys.argv[2])
    if sys.argv[1:2] == ["--persist-child"]:
        return persist_child(*sys.argv[2:5])
    dev = torch.device("cuda", 0)
    smi = nvidia_smi("name,power.limit")

    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln for name in built for ln in ptxas_report(_build.build_log(name))]
    rate, rate_src = memory_rate()
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s,
        "built": built, "memory_bytes_per_s": rate, "memory_rate_source": rate_src,
        "ptxas": ptxas,
    })
    emit(kernel_parity(dev))
    phase, main_data = main_path(dev)
    emit(phase)
    eng_phase, engine_data = engine(dev)
    emit(eng_phase)
    vs_phase, vs_data = vector_store(dev, smi)
    emit(vs_phase)
    corpus = vs_data.pop("corpus")
    phase, rest_data = rest(dev, smi, vs_phase["retrieve_reply_p50_ms"]["B=1"], corpus)
    emit(phase)
    phase, persist_data = persistence(dev, smi, vs_phase, vs_data, corpus)
    emit(phase)
    del corpus
    phase, ik_data = index_kinds(dev, smi, rate)
    emit(phase)
    cc_phase, cc_data = components(dev, smi)
    emit(cc_phase)
    phase, lc_data = live_classify(dev, smi)
    emit(phase)
    phase, wi_data = windowed_index(dev, smi)
    emit(phase)
    cdc_phase, cdc_data = cdc_index(dev, smi)
    emit(cdc_phase)
    # the host figures the native hasher should move, from the phases above
    hasher = {
        "engine_ingest_s": eng_phase["ingest_s"],
        "engine_vector_next_s": eng_phase["vector_next_s"],
        "engine_operator_s": {k: v for k, v in eng_phase["operator_s"].items()
                              if k in ("ConcatNode", "ReindexNode", "RowwiseNode")},
        "components_first_fixpoint_s": cc_phase["first_fixpoint_s"],
        "cdc_sqlite_poll_s_p50": cdc_phase["sqlite_poll_s"]["p50"],
    }
    phase, ct_data = compiled_ticks(dev, smi, rate, hasher)
    emit(phase)
    phase, repl_data = replication(dev, smi, vs_data)
    emit(phase)
    phase, gen_data = generation(dev, main_data)
    emit(phase)
    emit(durability(dev, gen_data))
    emb = ct_data.pop("embedder")
    phase, ob_data = observability(dev, smi, vs_data, emb)
    emit(phase)
    phase, mesh_data = mesh(dev, smi, rate, emb)
    emit(phase)
    del emb
    kernels = kernel_times(main_data, engine_data, vs_data, rest_data, persist_data, ik_data, cc_data,
                           lc_data, wi_data, cdc_data, ct_data, repl_data, gen_data, ob_data, mesh_data,
                           rate, rate_src) + [
        paged_kernel_times(gen_data, repl_data, rate, rate_src)
    ]
    emit({"phase": "kernels", "kernels": kernels})
    detail = ("per_batch", "per_shape")
    emit({"kernels": [{k: v for k, v in kern.items() if k not in detail} for kern in kernels]})
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
