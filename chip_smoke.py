#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and CUDA.
2. ``build``: nvcc builds the four kernels from ``csrc/`` in parallel
   (with each kernel function's registers, spills and shared memory).
3. ``kernel``: each kernel against its plain PyTorch version on the card at
   the serving path's shapes (the W8A8 matmul bitwise, both of its
   designs, at M = 1, 33, 65 and at the timed M = 32, 256, 2048 over
   Llama-3-8B's four projections, with its achieved rate and bound share;
   the prefill flash kernel at head_dim 128 and at 64, the speculative
   draft's; the attention kernels
   within stated bf16 tolerances; the paged decode kernel also bit for bit
   equal to the contiguous one on mirrored content at page sizes 16, 32,
   64 and 128; then the families' instances: the decode kernels at
   Gemma-7B's (head_dim 256, 16 kv heads, group 1), Gemma-2B's (256, 1, 8)
   and StarCoder2-3B's (128, 2, 12) shapes, K3 equal to K2 bit for bit at
   page 64, and the flash kernel at head_dim 256 with 16 / 16 and 8 / 1
   heads), with kernel, plain and library times and the least time
   the card could take (its bound).  Kernels and library calls are timed
   as CUDA-graph replays (the device's time; an eager loop of a short
   kernel measures the host's launch rate), with the eager time beside
   (``eager_ms``); the decode kernel also at each split count.
4. ``reference``: a small bf16 model (head_dim 128) run through the
   kernels on the card and through the plain versions on the CPU: the
   cold-prefill logits and one append-buffer decode step's logits agree
   element by element within a stated tolerance.
5. ``bert``: BERT at arctic-embed-l's width (2 layers, bf16, random
   weights from seed 0) on the card and on the CPU with the same weights:
   embeddings, and rerank scores of a padded two-segment batch, within
   ``BERT_TOL``.
6. ``embed``: arctic-embed-l at full depth (24 layers, bf16, seed 0) through
   the port's ``GPUEmbedder``: 256 documents of 510 byte tokens (batches of
   32 x 512) and 32 queries; unit-norm finite vectors, each query alone
   within ``EMBED_TOL`` of itself in the batch; ms per 32 x 512 forward
   (CUDA events) beside its FLOP bound, docs/s.
7. ``retrieve``: the exact ``GPUVectorStore``, built by the port's
   ``get_store()`` from the ``AppConfig`` defaults, with 1,000,000 clustered
   bf16 rows of 1024 (drawn on the card from seed 0): 128 queries (64
   planted on corpus rows) at top_k 4 and 10, ids against an f64 brute
   force over the bf16 values (on the card),
   5,000 rows appended through the tail (no rebuild), a masked delete
   (masks only); the scan's device ms per 128-query batch beside its byte
   bound, and the share of ``torch.topk``.
8. ``retriever``: the retrieval chain as ``chains/factory.py`` builds it from
   the ``AppConfig`` defaults (arctic-embed-l, 24 layers, random bf16, seed
   0; the result cache on; no reranker) over that store plus 2,048
   documents of 510 byte tokens.  Cold: 128 queries through
   ``Retriever.retrieve_many`` give the direct calls' hits and scores, none
   degraded, with each trace stage's ms.  Warm: the same 128 are exact-tier
   hits with no BERT forward, scan or ring scan.  The semantic ring at 512 x
   1024 against a numpy f64 reference (argmax and hit/miss).  32 concurrent
   requests through ``get_retrieval_batcher()``, each with its own 2 s
   deadline, logs and trace: none degraded or failed.  The ladder: a
   ``store`` fault serves ``index_fallback`` with the device search's
   ranks (and ``search_fallback`` alone at 1M rows, timed and checked on
   planted queries); without the fallback a warm cache serves
   ``cache_stale``.  Then ``ranking.model_engine`` ``tpu`` (the 24-layer
   cross-encoder): 32 queries at fetch_k 16 rank as a direct
   ``score_pairs`` of their 512 pairs, and a ``reranker`` fault serves
   vector-search order.  The chain and the store are freed after.
9. ``stores``: the compressed and IVF stores over the ``retrieve``
   corpus (its 1M rows, read from the exact store's mirror) and its 128
   queries, each built by ``retrieval.factory.get_vector_store`` with a
   collection's overrides and freed before the next: ``store_int8``,
   ``store_pq`` (``pq_m`` 16, ``rescore_multiplier`` 4), ``store_ivf``,
   ``store_ivf_int8``, ``store_ivf_pq`` (nlist 64, nprobe 16), each with its
   build seconds (train, encode, upload, first sync), device GB,
   ``capacity_stats``, ``scanned_bytes_per_query(10)``, device ms per
   128-query batch as ``search_batch`` chunks it (CUDA events, median of
   12) beside its byte bound, ``search_batch`` ms (host clock, median of 10)
   beside the exact store's timed alike, recall@10 against the exact
   store's top-10 and planted rows ranked first.  Gates: every returned
   score within 1e-4 of the f64 dot of its row's bf16 values (16
   queries); int8 codes bit for bit ``_int8_rows``', recall@10 >= 0.95 and
   64 of 64 planted first; PQ's stage-one scores on the card within
   ``ADC_TOL`` of the same codes and table on the CPU; IVF with nprobe =
   nlist gives the exact store's ids wherever gaps exceed ``RANK_EPS``;
   plain and int8 IVF rank first every planted row in a probed list; a
   deleted source never returns.  ``store_maintenance`` (on ``store_ivf``):
   5,000 appends found from the tail before any fold, a background fold
   under searches (centroids kept, one ``index_swap``, the tail empty),
   then a retrain forced by growth.  ``store_crossover``: exact and IVF at
   131,072 rows and at all rows, and the factory's ``cuda`` crossover.
   ``store_snapshot``: IVF int8 at 16,384 rows saved, loaded on the card
   (the saved store's answers) and on the CPU (the same ids wherever gaps
   exceed ``RANK_EPS``).  ``auto`` from ``APP_*`` builds the IVF store on
   the card with the ``cuda`` crossover.  Then ``stores``: peak device GB,
   peak host RSS, the phase's seconds.
   Then ``fabric``: the sharded fabric over the same rows, built by the
   factory with a collection's overrides (``fabric`` over 4 ``tpu``
   children): the 128 queries' top-10 against the exact store's scan of
   the same rows (how many scores differ and by how much; ids gated at
   every rank whose gap exceeds twice that), each child's device ms and the
   fabric's ``search_batch`` wall beside the exact store's, the merge's
   host ms; 16 threads of 8 queries at once against each alone (scores
   within 1e-4, ids at every rank whose gap exceeds ``RANK_EPS``), with fewer
   fan-out batches than requests (``rag_shard_fanout_batches_total``);
   ``delete_source("doc7")`` removes 1,000 rows and none comes back.
   ``fabric_cold``: shard 2 demoted to host PQ (its seconds, device
   bytes freed at least ``FREED_SHARE`` of their buffers), every score of
   the checked queries within ``COLD_REL_TOL`` (relative) of its row's f64
   product, planted rows on hot shards first, recall@10 overall and on the
   cold shards' truth (reported), the cold scan's ms a query, the byte
   split, prefetches, swaps; promoted back, the exact gate again.
   ``native_store``: the C++ store on one CPU thread over ``NATIVE_ROWS``
   f32 rows: exact ranks equal the port's ``MemoryVectorStore``'s except at
   near ties, IVF (nlist 64, nprobe 16) build seconds, ms a query and
   recall@10 against exact.
10. ``serve``: Llama-3-8B at full width and depth (random int8 weights from
   a seed, int8 contiguous KV), served by the port's Scheduler and HTTP
   front on 127.0.0.1: eight concurrent completions, a streaming chat, two
   prompts sent alone, models, health and metrics.  Launch counts are
   zeroed just before and read just after; every kernel of the path, and
   both designs of the W8A8 kernel, must have launched.  Then the same
   front's ``/v1/embeddings`` (the arctic embedder behind the
   micro-batcher: 32 concurrent single queries, one 64-passage request)
   and ``/v1/ranking`` (an arctic reranker, 16 passages) against direct
   calls, with the ``rag_*`` series showing the queries coalesced.  Then
   one decode chunk at batch 32 is timed, untraced.
11. ``serve_paged``: the same on the paged KV pool (page 64, same params),
   plus a shared-prefix group (a 300-token prompt, then four extensions of
   it): the paged decode kernel must have launched, grafts must be host
   table copies, the shared boundary page must be copied on write, the
   prompts sent alone must give the contiguous server's greedy text, and
   the pool must be all free once the parked segments are dropped.
12. ``pool``: the engine server as a 2-replica pool (``build_server`` with
   ``--replicas 2 --routing-policy prefix --matmul-kernel pallas_w8a8``:
   Llama-3-8B W8A8 from the same seed, one weight tree shared by both
   replicas, each with its own int8 KV cache; the gray-failure layer off
   and the sharded fabric as the store through ``APP_CONFIG_FILE``), in
   six drills that each fail
   the run: ``pool`` (serve's requests through the pool's front, launch
   counts zeroed just before and read just after: K1 in both designs, K2
   and K4; every stream equal to serve's bit for bit, both replicas
   placed, the per-replica, pool and gray families on ``/metrics``, the
   device GB the server added below one tree plus two caches plus 1 GB;
   tokens/s, TTFT p50 and decode tokens/s beside serve's),
   ``pool_failover`` (72 distinct prompts, more than both replicas' slots;
   ``replica:error`` at replica 1 while it holds queued requests: the
   token-less ones finish on the survivor with their cold streams, held
   against a fresh scheduler without the prefix cache, every mid-flight one
   answers 503 or ends ``finish_reason: "error"``, ``/health`` 503
   ``degraded``), ``pool_drain_scale`` (``/admin/scale?replicas=2`` adds
   replica 2, whose bootstrap builds the fabric on the card and warms only
   the shards ``shards_for_replica`` gives it, ``/metrics`` counting one
   hydration; then ``/admin/drain`` of the replica running a generation,
   which finishes there while new requests go to the other, then
   ``/admin/scale?replicas=2`` again under a running stream: device GB and
   the stream's longest gap across it, and a request on the new replica;
   fresh prompts, each stream equal to its cold one), ``pool_debug`` (``/debug/requests`` under the
   caller's ``X-Request-Id``, ``/debug/timeseries``'s engine series), then
   on a second pool over the same params (2 replicas of ``max_batch`` 4 and
   ``max_queue`` 2; the health section's windows cut to seconds through
   ``APP_CONFIG_FILE``) ``pool_gray`` (``replica:latency`` at its replica 1
   ejects it, disarmed it returns through probation) and ``pool_429`` (16
   concurrent completions of distinct prompts: 429s with ``Retry-After``
   in [1, 30], the accepted ones with their cold streams, the rejected
   counter equal to the 429s).
13. ``spec``: speculative decoding on the same params, gamma 4, each step
   driven over the engine front's HTTP routes with its launch counts
   zeroed just before and read just after: ``spec_plain`` (a plain
   scheduler in the same position, serve's 8 completions and streaming
   chat: the baseline for the steps' TTFT and tokens/s), ``spec_ngram``
   (the front's ``--spec-decode``, prompt lookup, contiguous),
   ``spec_fault`` (``spec_draft:error=1`` on that scheduler, one prompt),
   ``spec_draft`` (``--spec-decode --draft-model llama3.2-1b``: a random
   W8A8 draft at full width and ``SPEC_DRAFT_LAYERS`` of its 16 layers,
   paged, page 64) and ``spec_self`` (the target's first 4
   layers as the draft, contiguous): serve's 8 completions and streaming
   chat, the two prompts sent alone, a ~600-token quoting prompt and one
   sampled request (temperature 0.7, top_p 0.9).  Then ``spec_accept``:
   one full-width verify round on each layout whose drafts are the
   target's own continuation (all accepted: gamma + 1 tokens) or carry one
   wrong draft (a partial acceptance), and a second round after it.
   Gates: every greedy spec token is its position's argmax within
   ``SPEC_TIE`` under a teacher-forced forward and every plain one within
   ``PLAIN_TIE``; a spec stream leaves serve's only where the two tokens'
   logits lie within ``PLAIN_TIE``; the adaptive steps' greedy streams
   part from ``spec_ngram``'s only within ``SPEC_TIE`` (their lookahead
   follows when the HTTP requests arrive), and the same three steps rebuilt
   with ``adaptive_gamma=False`` (every round at gamma 4; the first
   ``SPEC_PINNED_PROMPTS`` completions submitted together,
   ``SPEC_PINNED_TOKENS`` greedy tokens, :func:`pinned_streams`) emit
   ``spec_ngram``'s greedy streams bit for bit when neither accepted a
   draft (else within ``SPEC_TIE``); ``spec_plain``'s are serve's; ``spec_accept``
   emits gamma + 1 and 3 tokens, paged = contiguous, its verify logits
   within ``VERIFY_LOGIT_TOL`` of the teacher-forced ones; sampled tokens
   lie in their warped candidate pool; the fault's stream is serve's bit
   for bit with fallbacks and no round; ``/metrics`` engine_spec_* equal
   ``Stats``; K1 and K4 launch in every step, K4 at head_dim 64 in
   ``spec_draft``, K2/K3 only in ``spec_plain`` and ``spec_fault``.  TTFT
   p50, decode tokens/s and the decode chunk's ms beside ``spec_plain``'s
   and serve's, acceptance, tokens per target forward, the final gamma;
   and the verify attention of one layer (B=32, S=5, window 1024) beside
   its byte bound and K2.
14. ``profile`` and ``profile_paged``: the decode chunk of each layout
   traced with torch.profiler (device time by kernel, and the device's
   busy share of the traced call's own span); then ``profile_embed``, one
   32 x 512 arctic-embed-l forward traced the same way.  The traces come
   after every untraced measurement: a trace leaves the process's later
   host work slower.
15. ``chain``: the chain server as ``create_app()`` builds it from the
   ``APP_*`` defaults (Llama-3-8B W8A8 behind ``GPUChatLLM``, random int8,
   seed 0; arctic-embed-l; the exact store; the result cache; no
   reranker), the earlier phases' params freed first, driven over HTTP on
   127.0.0.1 (K4 first held against its plain version at the phase's
   prefill shape, s = 2048).  64 short documents and 4 of ~6 KB uploaded
   through ``/documents``; 16 ``/search`` queries equal to
   ``QAChatbot().document_search`` and to the store's threshold-filtered
   search, bit for bit; the long documents deleted and no longer
   searched; one greedy ``/generate`` whose system turn is the RAG
   template over the hits ``/search`` gave, and whose streamed text is
   the engine's own for the same ids submitted directly; 8 concurrent
   streams and one with the knowledge base off (TTFT, decode tokens/s,
   Server-Timing stages, micro-batches); ``/health``, ``/metrics``, a 504
   at a 1 ms deadline.  Launch counts are zeroed after the build and read
   after these requests: K1, K2 and K4 must have launched, K3 not.  Then
   on the same server, each step zeroing and reading the launches of its
   own requests:
   ``bulk``: 128 documents of 6,000 bytes (numpy seed 0) and two files
   that must fail alone in one ``POST /documents/bulk``, polled through
   ``/documents/status``, with a stream decoding beside it: the job's
   status, the store's growth, 16 ``/search`` equal to the store's own
   search bit for bit, the ``ingest_*`` series equal to the job's numbers;
   chunks/s, embed dispatches, the device's busy share (CUDA events around
   each dispatch), the stream's longest SSE gap, and the serial
   ``/documents`` path's chunks/s on 16 more documents.
   ``collections``: a quota from ``APP_*``, 8 documents bulk-ingested into
   ``?collection=tenant-a`` and one more refused alone; its ``/search``
   equal to that store's search, the default collection's results
   unchanged, 404 for an unknown collection before any SSE byte,
   ``rag_store_rows{collection=...}``, and a knowledge-base ``/generate``
   over ``tenant-a`` that streams the engine's greedy ids.
   ``multi_turn``: a second server with ``MultiTurnChatbot`` over the same
   singletons; turn 1 lands in the memory store (its own store on the
   card), turn 2's prompt holds it, both stream the engine's greedy ids.
   ``profiler``: ``/debug/profiler/start`` (a second start is 409), one
   8-token ``/generate``, ``stop``: the Chrome trace names the W8A8 and
   decode-attention kernels.
16. ``hf_checkpoint`` (inside the K1 shape record, after ``chain``): the
   quantizers held against numpy's ``amax / 127`` bit for bit
   (``check_quantizers``); a Llama-3-8B checkpoint at full width and 4 of
   its 32 layers written from numpy seed 0 in bf16 (four shards, the index, a
   ``LlamaForCausalLM`` ``config.json``; layer i is the base layer rolled
   by i rows) and served by ``build_server`` through ``$GAIE_WEIGHTS_DIR``
   (load seconds, device GB, the host's resident set during the load,
   which may grow by no more than 8 GB); the int8 codes and f32 scales of
   every projection of its first, middle and last layers, the head and the embedding
   equal numpy's quantization of the written arrays bit for bit; greedy
   streams (four completions together, two alone) of the loaded server, of
   a ``Scheduler`` on the numpy-quantized tree and of a paged ``Scheduler``
   on the loaded params are equal, with K1, K2 / K3 and K4 launched on each
   path; then arctic-embed-l-shaped embedder and cross-encoder checkpoints
   (12 of 24 layers, bf16, a 30,522-entry ``vocab.txt``) through
   ``chains.factory``'s ``get_embedder`` / ``get_reranker``: their leaves
   equal the written arrays, the WordPiece ids come from the native
   library and equal the Python path's, 256 documents and 32 queries embed
   unit-norm within ``EMBED_TOL`` of a direct ``GPUEmbedder``, and 32 x 16
   pairs rerank in two segments within ``BERT_TOL`` of a direct
   ``score_pairs``.  The checkpoints (about 10 GB) live under the
   temporary directory and are deleted at the phase's end.
17. ``families`` (inside the K1 shape record, after ``hf_checkpoint``):
   Gemma-2B, Gemma-7B, StarCoder2-3B and Mixtral-8x7B.  Each at full width
   and 2 layers, random W8A8 from seed 5 (Mixtral's experts bf16), through
   the kernels on the card and the plain versions on the CPU: the
   cold-prefill, one append-buffer decode step's and the cacheless
   forward's logits within ``FAMILY_TOL``, fewer than 1 token in 8 routed
   to other experts; for Mixtral also the router's and experts' float
   products within ``MOE_PRODUCT_TOL`` and the top-k on planted ties equal
   to the CPU's (``families_reference``; every comparison is read before
   the phase fails, and the error names each one beyond its bound).  Each
   served through ``build_server(["--model", <HF id>, ...])`` at full
   width and a quarter of its depth (Mixtral at 2 of its 32 layers: 5.6 GB of
   bf16 experts; ``FAMILY_SERVED_LAYERS``), random int8 from seed 0: the 20- and 650-token prompts sent
   together, then each alone, must emit the same 32 greedy ids; Gemma-2B
   and StarCoder2-3B also on the paged pool (a ``Scheduler`` on the same
   params), whose ids must equal the contiguous ones; K1, the layout's
   decode kernel at the family's instance and K4 at its head_dim must
   launch (``families_serve``: load s, device GB, TTFT p50, decode
   tokens/s).  Then seeded 2-layer HF checkpoints of Gemma-7B (tied head),
   StarCoder2-3B (biases, LayerNorm) and Mixtral (experts) written with
   ``save_safetensors`` and served by ``build_server`` through
   ``$GAIE_WEIGHTS_DIR``: int8 codes and scales against numpy's
   quantization, float leaves against the written arrays, two completions
   with K1, K2 and K4 launched (``families_checkpoint``).
18. ``xla_path`` (inside the K1 shape record, after ``families``): the
   reference engine's default serving path, bf16 weights over the bf16 KV
   cache.  K4 in its warm regime (a 256-token chunk at positions 256 and
   1792 against 1024 and 2048 cache slots, at head_dim 128 and 64) against
   its plain version within ``FLASH_TOL``, beside SDPA; the bf16 decode
   attention's ms per layer at B=32 against its byte bound, at a bucket's
   window and at the whole cache, and whether a row's bits move with the
   window (``xla_decode_attention``); whether a row's bf16 product moves
   with the rows beside it, through one ``torch.mm`` and through the port's
   fixed 128-row blocks, and what the blocks cost (``xla_row_blocks``);
   Llama-3-8B at full width and 2
   layers, random bf16 from seed 11, card vs CPU over a cold prefill, a
   warm chunk, 8 decode steps and a verify block, logits and cache within
   ``XLA_TOL``, and two planted faults that must fail it
   (``xla_reference``); ``build_server --matmul-kernel xla`` at full width
   and ``XLA_SERVED_LAYERS`` of 32 layers
   (random bf16 from seed 0, max_batch 32, max_len 2048): the ``serve``
   requests, the 20- and 650-token prompts alone emit the batch's ids, a
   shared-prefix graft, ``/metrics`` reports ``xla``, only K4 launches
   (``xla_serve``); ``--kv-layout paged`` on ``xla`` logs the int8
   override and serves through K3 and K4 (``xla_serve_paged``); the bf16
   1B draft (``--spec-decode --draft-model llama3.2-1b``) beside a plain
   scheduler, gated as ``spec`` is (``xla_spec_draft``); ``LlamaGenerator``
   against the scheduler (alone prompts, and the graft against a cold
   prefill), ``SpeculativeGenerator`` against ``LlamaGenerator``, each
   equal or parted only at a near tie under a teacher-forced forward, and
   a W8A8 ``LlamaGenerator`` over an int8 cache launching K1, K2 and K4
   (``xla_generators``).
19. The ``mesh`` group (after the K1 shape check), two ranks on this
   card: rank 0 is this process and rank 1 a follower process spawned at
   the script's start (``parallel.runtime``), every collective staged
   through a host buffer both ranks map (``parallel.comm.SharedLine``).  ``mesh_serve``: Llama-3-8B at full
   width and ``MESH_LAYERS`` of 32 layers, random weight-only int8 from
   ``MESH_SEED`` with an int8 cache, ``MeshSpec(tensor=2)``: a single-device
   scheduler on the same draw serves ``serve``'s 8 completions and
   streaming chat through the engine front (the baseline), then the mesh
   scheduler on the contiguous cache (K2, K4) and on the paged pool (K3,
   K4); a probe (a cold prefill of a 140-token prompt and 8 decode steps)
   holds the mesh's hidden states within ``MESH_HIDDEN_TOL`` and its
   logits within ``MESH_LOGIT_TOL`` of the single device's, and two
   planted faults (``MESH_PROBE_FAULTS``) must fail both; greedy streams
   equal the single device's up to its first top-2 gap below twice
   ``MESH_LOGIT_TOL`` (each stream's first near tie and the steps the gate
   covers printed); the ranks' digests of every token they sampled are
   equal; each rank launched K2 or K3, and K4.  Before the group, K2, K3
   and K4 are held against their plain versions at a rank's shapes
   (``check_mesh_rank``).
   Printed: TTFT p50, decode tokens/s beside the single device's, a
   decode chunk's ms, collectives, staged MB and collective ms a step,
   each rank's device GB.  ``mesh_seq``: one attention layer at
   Llama-3-8B's heads over ``MESH_SEQ_LEN`` tokens, ring and Ulysses at
   ``MeshSpec(seq=2)`` against K4 over the whole sequence, each within
   ``FLASH_TOL`` (Ulysses launches K4 on each rank, and each rank's K4
   call is held against the plain attention on its inputs).  ``mesh_moe``:
   Mixtral-8x7B's width at ``MESH_MOE_LAYERS`` layers over
   ``MeshSpec(expert=2)`` against the single-device forward within
   ``MESH_MOE_TOL`` (bit for bit); a planted missing expert must fail it.
   ``mesh_train``: Llama-3-8B's width at ``MESH_TRAIN_LAYERS`` layers, bf16,
   remat, AdamW at ``MESH_TRAIN_LR``, one step of 4 x 1,024 tokens on one
   device, then on ``tensor=2``, ``fsdp=2`` and ``pipe=2`` (4
   microbatches): the loss, the grad norm and the share of each updated
   leaf's elements more than 0.1 x lr from the single device's within
   ``MESH_TRAIN_TOL``, a planted fault a mesh failing them
   (``MESH_TRAIN_FAULTS``), K4 exactly ``MESH_TRAIN_K4`` times a rank;
   printed: step ms, tokens/s, collectives, staged MB and collective ms,
   device GB a rank.  ``mesh_train_moe``: Mixtral-8x7B's width at 1 layer
   over ``expert=2``, capacity dispatch: loss and grad norm bit for bit
   (``MESH_MOE_TRAIN_TOL``), each of ``MESH_MOE_TRAIN_FAULTS`` planted must
   fail them, K4 twice a rank.  ``mesh_ckpt``: a 1-layer
   Llama-3-8B-width train state saved by its ``tensor=2`` ranks in the
   port's checkpoint format, loaded onto ``fsdp=2`` (each rank reading
   only its half) and onto one device, every leaf bit for bit on both
   ranks of both meshes; ``Scheduler(mesh=tensor=2)`` serves a chat
   completion from it (``RankParams("sharded")``), K2 once a decode step
   and K4 once a prefill chunk on both ranks; printed: write and read s and GB/s, each rank's host RSS.
   ``mesh_fault``: the follower killed mid-decode; the
   request fails with ``error`` well inside the group timeout, a later
   one fails at once, the scheduler reads unhealthy, the script goes on.
20. The model services (after the ``mesh`` group): K4 held against its
   plain version at the VLM's prefill blocks (b = 1, s = 228 and 249 from
   position 0, t = s + 96, 32 / 8 heads, head_dim 128: ``kernel`` lines,
   ``regime`` ``vlm_prefill``), then
   ``vision_reference``: ViT-B/16 (12 layers, every leaf from numpy seed 21)
   on the card and on the CPU: patchify bit for bit, the bf16 features
   within ``VIT_TOL``, the same weights in f32 within ``VIT_F32_TOL``, and
   two planted faults (patchify with patch rows and columns swapped, tanh
   GELU) that must fail the f32 gate; the VLM at full width (ViT-B +
   Llama-3-8B at ``VISION_REF_LAYERS`` of 32 layers, bf16): the prefix,
   the prefill's last logits and 8 greedy decode steps' logits (fed the
   card's ids on both sides) within ``XLA_TOL``.
   ``multimodal``: ``create_app()`` with ``MULTIMODAL_ENV`` (the
   multimodal chain, the VLM on the card, the echo LLM, arctic-embed-l,
   the exact store) and a seeded HF ``vit/`` checkpoint under
   ``$GAIE_WEIGHTS_DIR/vlm-base``, over HTTP: a PDF (text, an aligned
   table, a running header and footer, a FlateDecode RGB chart, a
   FlateDecode gray photo) and a PPTX (text, notes through the rels, an
   image where PIL imports) through ``POST /documents``.  Gates: the loaded
   ViT leaves equal the written arrays bit for bit; the chunks' kinds are
   text, table, chart and image; every caption chunk is the analyst's
   decoded ids, and every id its position's argmax within ``PLAIN_TIE``
   under one teacher-forced forward; ``/search`` on a caption equals the
   store's own search bit for bit; a knowledge-base ``/generate`` streams;
   ``DELETE /documents`` removes every chunk; K4 launched.  Then
   ``vision_serve`` on that server's ``GPUVisionAnalyst(model_name=
   "vlm-base")`` (the checkpoint's ViT-B, Llama-3-8B at 32 layers, random
   bf16 from seed 0) and its generations for the report (the drawn chart
   described and tabled, the drawn photo described): K4 launched 32 times
   each, all at head_dim 128 (counts zeroed just before the report's
   upload, read just after); a batch of the two images gives each image's
   ids alone, or leaves them only where the two tokens' logits lie within
   ``PLAIN_TIE``; the ViT encode's ms at batch 1 and 8 beside its FLOP
   bound, the prefill's ms, the decode step's ms as replays of the
   analyst's captured graph and as one eager step (CUDA events), and a
   first decode's eager step plus capture on a line of its own (host
   clock).  Then ``caption_beside_llm``: the same server's configuration
   with the in-process LLM (``APP_LLM_MODELENGINE=tpu``: Llama-3-8B W8A8
   behind ``GPUChatLLM``, its tick thread on the card) streams greedy
   ``/generate`` requests back to back while the report is uploaded to a
   fresh analyst, whose graphs are therefore captured beside the LLM's
   work.  Gates: the streams ran from before the upload to after it, none
   failed or degraded, and each one's ids equal the engine's for the same
   prompt submitted alone; two captures; the captions' ids and every
   chunk equal those of the echo server's upload of the same report.
   ``speech_reference``: Conformer-S, FastSpeech-S and wav2vec2-base (f32,
   every leaf from numpy seed 31) on the card and on the CPU: log-mel, the
   ASR logits, the TTS mel, frame counts and durations, the wav2vec2
   logits within ``SPEECH_TOL``, CTC ids equal wherever the top-2 gap
   exceeds twice the tolerance, Griffin-Lim after 1 and 30 iterations
   within ``GL_SPREAD`` times the CPU's own change under a one-ulp change
   of its input; a planted transposed filterbank must fail the log-mel
   gate.
   ``speech_serve``: the speech service in process on 127.0.0.1
   (Conformer-S, FastSpeech-S, random f32): TTS to WAV to
   ``/v1/audio/transcriptions`` equal to a direct ``transcribe`` of the
   same PCM; the WebSocket stream, fed in frames, equal to a direct
   ``StreamingTranscriber`` fed the same frames; streaming TTS frames equal
   to each segment's ``synthesize``; voices, health, the 400 on empty
   input; then a seeded wav2vec2-base checkpoint through ``GAIE_W2V2_DIR``:
   ``wav2vec2-ctc`` in ``/health``, its logits within 1e-5 of a forward
   on the tree mapped from the written arrays, its transcript their
   decode.  TTS real-time factor, ASR ms per second of audio, ms from
   ``end`` to ``done``.
21. Training on one card (after ``speech_serve``): ``train``: K4's
   autograd wrapper (``ops/flash_attention.py::FlashAttentionFunction``:
   the kernel forward, a backward by recomputing the plain attention)
   against the plain attention's autograd at the training shape (b = 4,
   s = 1,024, 32 / 8 heads, head_dim 128): the forward within
   ``FLASH_TOL``, dq / dk / dv equal to its autograd bit for bit (the
   wrapper's backward is that autograd: a plumbing check), timed beside its
   bound and SDPA (a ``kernel`` line, ``regime`` ``train``); then
   Llama-3-8B at full width and ``TRAIN_LAYERS`` of 32 layers (bf16, remat,
   AdamW, random from a seed) on one seeded 4 x 1,024 batch: the first
   step's loss, grad norm and attention projections' gradient norms with
   K4 against the same step with the plain attention swapped in by this
   script (``TRAIN_STEP_TOL``), every gradient finite and the attention
   projections' non-zero (a dropped gradient through K4 fails here), K4
   launched twice a layer (the forward and the remat recompute); three
   planted faults (``TRAIN_FAULTS``: K4's output one bf16 ulp up, a
   backward without the causal mask, dk dropped) must each fail those
   gates; ``TRAIN_STEPS`` steps whose loss falls (step ms, tokens/s, peak
   memory, TFLOP/s against 989).
   ``lora``: LoRA SFT (rank 8 on wq wk wv wo) of the full 32-layer
   Llama-3-8B drawn on the card (bf16, frozen), 4 x 512, ``LORA_STEPS``
   steps: the loss falls, the base bit for bit, ``merge_lora``'s forward
   equal to ``apply_lora``'s bit for bit (a plumbing check: the same
   arithmetic), ``save_lora`` then ``load_lora`` bit for bit.
   ``train_losses``: the contrastive loss (arctic-embed-l), the VLM's
   caption loss (vlm-base, its decoder at ``TRAIN_LAYERS``) and
   FastSpeech-S's loss: each at 2 layers card against CPU (``LOSS_TOL``),
   planted faults on the card failing that gate (``LOSS_FAULTS``: a
   passage mask one token short, the caption's positions restarting at 0
   after the image prefix, transposed patches, f32 products read as
   TF32), then ``LOSS_STEPS`` steps whose loss falls, the counts zeroed
   just before each model's steps (K4 exactly once a decoder layer a step
   in the VLM's, no kernel in the others).
   ``streaming``: 10 s of seeded audio FM-modulated at 250 kHz through
   ``streaming.dsp.FMReceiverChain`` on the card in 65,536-sample blocks
   against the same chain on the CPU (PCM within 1 LSB, the 1 kHz test
   tone recovered, the real-time factor), then UDP end to end
   (``replay_iq`` -> ``UDPSource`` -> the chain -> ``ASRSink`` on
   Conformer-S -> the streaming server -> ``StreamingChains`` on
   arctic-embed-l and a ``GPUVectorStore`` on the card, the echo LLM):
   the finals are stored with their timestamps in both stores and
   ``/generate`` streams an SSE answer.
22. ``durable``: durability with ``python -m
   generativeaiexamples_tpu_torch.server`` processes (echo LLM,
   arctic-embed-l, the exact store, cache off): 32 documents bulk-ingested
   and one deleted, 16 searches recorded, SIGKILL; the restart replays the
   WAL (rows, sources, version and the 16 searches equal, bit for bit);
   SIGTERM cuts a final snapshot and the next start replays nothing (the
   same 16 searches); a bulk job killed mid-way resumes at the next start
   with every file landing once (the final snapshot's chunks by source,
   no chunk id twice).  Beside it, on a thread of its own (the two share
   only the card), ``durable_fabric``: the same with
   ``APP_VECTORSTORE_NAME=fabric`` (4 ``tpu`` shards through the
   ``APP_FABRIC_*`` keys), 16 documents and a snapshot every 3 WAL
   records (one more delete if the last record falls on a snapshot), to
   the SIGKILL restart only: it restores the snapshot and replays at least
   one WAL record after it, the searches equal those before the kill, and
   every shard's child is restored on the card (the recovery event's
   ``shard_devices``).

Then the ``kernels`` summary line (each kernel's ``launches`` from its
serving phase, ``pool_launches`` from ``pool``, ``chain_launches`` from ``chain``, ``step_launches`` from
the steps after it, ``spec_launches`` from each ``spec`` step,
``hf_launches`` from each path of ``hf_checkpoint``,
``families_launches`` from each family's paths, ``xla_path_launches``
from each part of ``xla_path``, ``mesh_launches`` from each layout of
``mesh_serve``, ``mesh_train``, ``mesh_train_moe`` and ``mesh_ckpt`` by
rank, ``services_launches`` from ``vision_serve``
and ``multimodal``, ``training_launches`` from ``train``'s steps, ``lora``'s
steps and each model's steps in ``train_losses`` (``contrastive``,
``vlm_caption``, ``tts``); K4's line carries its training-shape timings
in ``train``, at a ``tensor=2`` training rank's heads in
``mesh_train_rank``, its warm-regime timings in ``warm``,
its VLM prefill timings in ``vlm_prefill``, its
head_dim-64 timing and ``spec_draft`` launches in ``hd64`` and its
head_dim-256 timings and ``families`` launches in ``hd256``; K2's and
K3's lines carry their new instances' timings and ``families`` launches
in ``instances``, null for a layout the phase did not serve that family on),
the ``nvidia-smi`` line, and last ``{"ok": true,
"device": {...}}``.
It needs one CUDA card and the repository's ``generativeaiexamples_tpu_torch``
package beside it; without either it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import logging
import math
import os
import queue
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): used for each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12  # outside the tensor cores: the PQ scans' table sums

# Stated tolerances of the attention kernels against their plain versions
# (bf16 outputs; the kernel rounds unnormalized softmax weights to bf16
# where the plain version rounds normalized ones, and sums in another order).
DECODE_TOL = dict(atol=5e-3, rtol=2e-2)
FLASH_TOL = dict(atol=1e-2, rtol=2e-2)
# The small bf16 model's f32 logits, card kernels against CPU plain
# versions: the attention kernels' bf16 roundings carried through two
# layers, the head and the final norm (logits of magnitude up to ~2).
REFERENCE_TOL = dict(atol=5e-2, rtol=2e-2)
# BERT in bf16, card against CPU on the same weights: cuBLAS and the CPU's
# GEMM round bf16 results after sums in other orders, carried through two
# layers (unit-norm embeddings; rerank logits of magnitude ~0.5).
BERT_TOL = dict(atol=2e-2, rtol=2e-2)
# A query embedded alone (a batch of 4) and inside a batch of 32, 24 bf16
# layers: cuBLAS may choose another algorithm, and order of sums, per M.
EMBED_TOL = dict(atol=1e-2, rtol=0)
# Score gap below which two ranks may swap between the card's f32 sums of
# bf16 products and an f64 brute force over the same bf16 values (a sum of
# 1024 products of unit vectors in f32 is off by ~1e-6).
RANK_EPS = 1e-4

REPLACES = {
    "qmm": "generativeaiexamples_tpu/ops/qmm.py:264",
    "decode_attention": "generativeaiexamples_tpu/ops/decode_attention.py:689",
    "flash_attention": "generativeaiexamples_tpu/ops/flash_attention.py:125",
    "paged_decode_attention": "generativeaiexamples_tpu/ops/decode_attention.py:1030",
}


_T0 = time.perf_counter()


_EMIT_LOCK = threading.Lock()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``at_s`` is the seconds since the script started.
    Phases that run side by side print whole lines."""
    line = json.dumps({"phase": phase, "at_s": round(time.perf_counter() - _T0, 1), **fields})
    with _EMIT_LOCK:
        print(line, flush=True)


def side_by_side(*phases) -> None:
    """Run each of ``phases`` (calls without arguments) on its own thread
    and wait for all; the first failure is raised after every phase has
    ended."""
    errors: list = []

    def run(phase):
        try:
            phase()
        except BaseException as exc:  # noqa: BLE001 - raised below, after the join
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(phase,)) for phase in phases]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n_variants: int, iters: int, warmup: int = 2, graph: bool = False) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` launches, cycling over
    ``n_variants`` input copies so the inputs do not sit in the 50 MB L2.
    With ``graph`` the launches are captured into one CUDA graph and timed
    as its replay: the device's time alone, where a short kernel would
    otherwise be timed at the host's launch rate."""
    import torch

    for i in range(warmup):
        fn(i % n_variants)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(i % n_variants)
        g.replay()
        torch.cuda.synchronize()
        run = g.replay
    else:
        def run():
            for i in range(iters):
                fn(i % n_variants)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    """Input copies to cycle so the working set exceeds L2 several times."""
    return max(1, min(8, math.ceil(160e6 / max(nbytes, 1))))


def tolerance_use(out, ref, atol: float, rtol: float) -> float:
    """Largest |out - ref| / (atol + rtol * |ref|): below 1 passes, and the
    distance from 1 is the margin."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


def _short_name(mangled: str) -> str:
    """``qmm_decode<32,1>`` from an Itanium-mangled kernel name: the last
    length-prefixed identifier of the nested name, then its integer
    template arguments."""
    import re

    i, name = 3 if mangled.startswith("_ZN") else 2, None
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if name is None:
        return mangled[:60]
    args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[i:])
    return name + (f"<{','.join(re.findall(r'L[a-z](\d+)E', args.group(1)))}>" if args else "")


def ptxas_summary(log: str) -> dict:
    """Registers, shared memory and spills per kernel function from
    ``nvcc -Xptxas -v`` output, keyed by a short name (``qmm_decode<32,1>``)."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = _short_name(entry.group(1))
            out[name] = ""
        elif name and ("spill" in line or "Used" in line):
            out[name] = (out[name] + "; " if out[name] else "") + line.split(":", 1)[-1].strip()
    return out


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


QMM_PROJECTIONS = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w_gu", 4096, 28672), ("w_down", 14336, 4096))
QMM_TIMED_M = (32, 256, 2048)  # a decode step, a warm chunk, a cold batch
QMM_CHECKED_M = (1, 33, 65)  # the designs' edges, checked bit for bit only


def achieved(nbytes: float, ops: float, ms: float, by: str) -> dict:
    """What a kernel reached, in the unit of what bounds it."""
    if by == "bytes":
        return {"achieved_gb_per_s": nbytes / ms / 1e6}
    return {"achieved_tops": ops / ms / 1e9}


def check_qmm(torch, dev, log):
    """K1 at Llama-3-8B's four projections: bit for bit against its plain
    version at every M of QMM_TIMED_M and QMM_CHECKED_M, timed at
    QMM_TIMED_M beside its bound, the plain version and ``torch._int_mm``.
    Returns the summary entry (one decode step's four projections at
    M=32) with the layer's sums at each timed M."""
    from generativeaiexamples_tpu_torch.ops import qmm

    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for m in QMM_TIMED_M + QMM_CHECKED_M:
        timed = m in QMM_TIMED_M
        for name, k, n in QMM_PROJECTIONS:
            wbytes = n * k
            nv = copies_for(wbytes + m * k) if timed else 1
            ws = [torch.randint(-127, 128, (n, k), dtype=torch.int8, device=dev, generator=gen) for _ in range(nv)]
            wscale = torch.rand(n, device=dev, generator=gen) * 1e-3 + 1e-4
            xs = [torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
            qs = [qmm.quantize_activations(x) for x in xs]
            out = qmm.qmm_cuda(qs[0][0], qs[0][1], ws[0], wscale, n, torch.bfloat16)
            again = qmm.qmm_cuda(qs[0][0], qs[0][1], ws[0], wscale, n, torch.bfloat16)
            ref = qmm.qmm_plain(qs[0][0], qs[0][1], ws[0], wscale, n, torch.bfloat16)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                diff = (out.float() - ref.float()).abs().max().item()
                raise AssertionError(f"qmm {name} M={m}: kernel differs from plain (max {diff})")
            if not torch.equal(out, again):
                raise AssertionError(f"qmm {name} M={m}: two calls in a row differ")
            plan = qmm.qmm_plan(m, n, k)
            if not timed:
                emit("kernel", kernel="qmm", proj=name, m=m, k=k, n=n, design=plan.design, bitwise_equal=True)
                del ws, xs, qs, out, again, ref
                continue
            # Kernel and library call timed as graph replays (device time;
            # a 5 µs product launched from Python is host-bound), and the
            # kernel also eagerly, at the rate the host can launch it.
            iters = 20 if m <= 256 else 10
            k_ms = time_ms(lambda i: qmm.qmm_cuda(qs[i][0], qs[i][1], ws[i], wscale, n, torch.bfloat16), nv, iters,
                           graph=True)
            eager_ms = time_ms(lambda i: qmm.qmm_cuda(qs[i][0], qs[i][1], ws[i], wscale, n, torch.bfloat16), nv,
                               iters)
            p_ms = time_ms(lambda i: qmm.qmm_plain(qs[i][0], qs[i][1], ws[i], wscale, n, torch.bfloat16), nv, 3, 1)
            try:
                wt = [w.t() for w in ws]
                lib_ms = time_ms(lambda i: torch._int_mm(qs[i][0], wt[i]), nv, iters, graph=True)
            except RuntimeError as exc:  # the yardstick only; the port never calls it
                log.append(f"_int_mm {name} M={m}: {exc}")
                lib_ms = None
            nbytes, ops = m * k + n * k + m * 4 + n * 4 + m * n * 2, 2.0 * m * n * k
            b_ms, b_by = bound(nbytes, ops, INT8_OPS)
            row = dict(proj=name, m=m, k=k, n=n, design=plan.design, grid=list(plan.grid), split=plan.split,
                       tile_n=plan.tile_n,
                       ms=k_ms, eager_ms=eager_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       bound_share=b_ms / k_ms, **achieved(nbytes, ops, k_ms, b_by), max_abs_err=0.0,
                       bytes=nbytes, ops=ops)
            rows.append(row)
            emit("kernel", kernel="qmm", **row)
            del ws, xs, qs, out, again, ref
            torch.cuda.empty_cache()
    layers = {}
    for m in QMM_TIMED_M:
        sel = [r for r in rows if r["m"] == m]
        lib = [r["library_ms"] for r in sel]
        layer = dict(ms=sum(r["ms"] for r in sel), eager_ms=sum(r["eager_ms"] for r in sel),
                     plain_ms=sum(r["plain_ms"] for r in sel),
                     library_ms=None if None in lib else sum(lib), bound_ms=sum(r["bound_ms"] for r in sel),
                     bound_by="bytes" if all(r["bound_by"] == "bytes" for r in sel) else "operations")
        layer["bound_share"] = layer["bound_ms"] / layer["ms"]
        layer.update(achieved(sum(r["bytes"] for r in sel), sum(r["ops"] for r in sel), layer["ms"],
                              layer["bound_by"]))
        emit("kernel", kernel="qmm", proj="layer (four projections)", m=m, **layer)
        layers[m] = layer
    # The summary entry: one decode step's four projections of one layer
    # at batch 32 (each is one launch; a step makes 4 per layer).
    return dict(layers[32], max_abs_err=0.0,
                shape="one layer's wqkv+wo+w_gu+w_down at M=32 (per-shape rows in the kernel lines)",
                layer_ms_by_m={m: v["ms"] for m, v in layers.items()},
                layer_library_ms_by_m={m: v["library_ms"] for m, v in layers.items()})


class QmmShapes:
    """Records the operand shapes of every K1 launch while it is entered
    (it wraps ``qmm.qmm_cuda``, which ``q_matmul`` calls), so that
    ``check_qmm_shapes`` can hold each against the plain version."""

    def __init__(self):
        from generativeaiexamples_tpu_torch.ops import qmm

        self._qmm, self._launch, self.seen = qmm, qmm.qmm_cuda, set()

    def __enter__(self):
        def recording(xq, a_scale, w, w_scale, n, out_dtype):
            self.seen.add((xq.shape[0], xq.shape[1], w.shape[0], n, out_dtype))
            return self._launch(xq, a_scale, w, w_scale, n, out_dtype)

        self._qmm.qmm_cuda = recording
        return self

    def __exit__(self, *exc):
        self._qmm.qmm_cuda = self._launch


QMM_PLAIN_ROWS = 8192  # rows of the f64 plain product at a time


def check_qmm_shapes(torch, dev, shapes, worst_m: int) -> None:
    """K1 bit for bit against its plain version at every shape the serving
    phases launched it with, and at ``worst_m`` (the largest cold batch the
    admission budget lets through: ``max_batch`` prompts bucketed to
    ``max_len``) for each projection seen at a wide M.  Operands are full
    range int8; the plain version runs on row blocks (it is row-wise)."""
    from generativeaiexamples_tpu_torch.ops import qmm

    shapes = set(shapes) | {(worst_m, k, n_pad, n, dt) for m, k, n_pad, n, dt in shapes if m > qmm.DECODE_MAX_M}
    gen = torch.Generator(device=dev).manual_seed(3)
    t0 = time.perf_counter()
    for m, k_pad, n_pad, n, dtype in sorted(shapes, key=lambda s: s[:4]):
        w = torch.randint(-127, 128, (n_pad, k_pad), dtype=torch.int8, device=dev, generator=gen)
        w_scale = torch.rand(n_pad, device=dev, generator=gen) * 1e-3 + 1e-4
        xq = torch.randint(-127, 128, (m, k_pad), dtype=torch.int8, device=dev, generator=gen)
        a_scale = torch.rand(m, 1, device=dev, generator=gen) * 1e-2 + 1e-3
        out = qmm.qmm_cuda(xq, a_scale, w, w_scale, n, dtype)
        for r in range(0, m, QMM_PLAIN_ROWS):
            ref = qmm.qmm_plain(xq[r:r + QMM_PLAIN_ROWS], a_scale[r:r + QMM_PLAIN_ROWS], w, w_scale, n, dtype)
            if not torch.equal(out[r:r + QMM_PLAIN_ROWS], ref):
                diff = (out[r:r + QMM_PLAIN_ROWS].float() - ref.float()).abs().max().item()
                raise AssertionError(f"qmm M={m} K={k_pad} N={n}: kernel differs from plain at rows {r}+ (max {diff})")
        del w, xq, out, ref
    torch.cuda.empty_cache()
    ms = sorted({s[0] for s in shapes})
    emit("kernel", kernel="qmm", check="every serving shape", shapes=len(shapes), m=ms, worst_m=worst_m,
         designs=sorted({qmm.qmm_plan(m, 4096, 4096).design for m in ms}), bitwise_equal=True,
         seconds=time.perf_counter() - t0)


def check_decode(torch, dev):
    from generativeaiexamples_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(2)
    L, KH, B, T, HD, G, C = 4, 8, 32, 2048, 128, 4, 8
    window, count = 1024, 5
    q = torch.randn(B, KH * G, HD, device=dev, generator=gen).to(torch.bfloat16)
    k8 = torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=gen)
    v8 = torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=gen)
    ks = (torch.rand(L, KH, B, T, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16)
    vs = (torch.rand(L, KH, B, T, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16)
    ab = (
        torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=gen),
        torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=gen),
        (torch.rand(L, KH, B, C, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
        (torch.rand(L, KH, B, C, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
    )
    lengths = torch.randint(1, window - C, (B,), device=dev, generator=gen, dtype=torch.int32)
    lengths[0] = 0  # an empty lane
    lengths[1] = T - 1  # a lane pinned at max_len - 1: read only up to window
    lengths[2] = window
    summary = None
    for with_ab in (False, True):
        append = (*ab, count) if with_ab else None
        out = da.decode_attention_cuda(q, k8, v8, ks, vs, 1, lengths, append, window)
        ref = da.decode_gqa_attention_plain(q, k8, v8, ks, vs, 1, lengths, append, window=window)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        use = tolerance_use(out, ref, **DECODE_TOL)
        torch.testing.assert_close(out, ref, **DECODE_TOL)
        if not with_ab and out[0].any():
            raise AssertionError("decode_attention: an empty lane must give exact zeros")
        again = da.decode_attention_cuda(q, k8, v8, ks, vs, 1, lengths, append, window)
        if not torch.equal(out, again):
            raise AssertionError("decode_attention: two calls in a row differ")
        k_ms = time_ms(lambda i: da.decode_attention_cuda(q, k8, v8, ks, vs, i, lengths, append, window), L, 50,
                       graph=True)
        eager_ms = time_ms(lambda i: da.decode_attention_cuda(q, k8, v8, ks, vs, i, lengths, append, window), L, 50)
        p_ms = time_ms(lambda i: da.decode_gqa_attention_plain(q, k8, v8, ks, vs, i, lengths, append, window=window), L, 5, 1)
        slots = lengths.clamp(0, window).sum().item() + (B * count if with_ab else 0)
        nbytes = slots * KH * (2 * HD + 2 * 2) + q.numel() * 2 * 2 + B * 4
        b_ms, b_by = bound(nbytes, 4.0 * slots * G * KH * HD, BF16_FLOPS)
        row = dict(append=with_ab, b=B, t=T, window=window, splits=da.decode_plan(B, KH), ms=k_ms, eager_ms=eager_ms,
                   plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / k_ms,
                   max_abs_err=err, tolerance=DECODE_TOL, tolerance_use=use)
        if with_ab:
            row["splits_sweep_ms"] = decode_splits_sweep(torch, da, q, k8, v8, ks, vs, lengths, append, window, L)
        emit("kernel", kernel="decode_attention", **row)
        if with_ab:
            summary = dict(row, shape=f"B={B} KH={KH} G={G} T={T} window={window} append C={C} count={count}")
    del k8, v8, ks, vs, ab
    torch.cuda.empty_cache()
    return summary


def decode_splits_sweep(torch, da, q, k8, v8, ks, vs, lengths, append, window, n_layers) -> dict:
    """K2's graph-timed ms at each split count, the plan's choice replaced
    for the sweep only (``BLOCKS_PER_SM`` in ``ops/decode_attention.py``
    comes from it); each must still match the plain version."""
    planner = da.decode_plan
    out = {}
    ref = da.decode_gqa_attention_plain(q, k8, v8, ks, vs, 1, lengths, append, window=window)
    try:
        for splits in (1, 2, 4, 8):
            da.decode_plan = lambda *_a, _s=splits: _s
            torch.testing.assert_close(da.decode_attention_cuda(q, k8, v8, ks, vs, 1, lengths, append, window), ref,
                                       **DECODE_TOL)
            out[splits] = time_ms(lambda i: da.decode_attention_cuda(q, k8, v8, ks, vs, i, lengths, append, window),
                                  n_layers, 50, graph=True)
    finally:
        da.decode_plan = planner
    return out


def paged_mirror(torch, cache, own, pt, gen, share=None):
    """Pool leaves and a table holding each row's first ``own[b]`` slots
    (whole pages) of the contiguous ``cache`` on pool pages taken in a
    shuffled order; the rest of each table row is the garbage page 0.
    ``share=(src, dst, m)`` points row dst's first m entries at row src's
    pages (the contiguous rows must agree there)."""
    k8 = cache[0]
    n_layers, n_kv, b, t, _ = k8.shape
    n_slot = -(-t // pt)
    total = b * n_slot + 1
    perm = (torch.randperm(total - 1, generator=gen) + 1).tolist()
    table = torch.zeros(b, n_slot, dtype=torch.int32)
    for r in range(b):
        n_pages = -(-own[r] // pt)
        table[r, :n_pages] = torch.tensor(perm[:n_pages], dtype=torch.int32)
        del perm[:n_pages]
    if share is not None:
        src, dst, m = share
        table[dst, :m] = table[src, :m]
    leaves = [torch.zeros((n_layers, n_kv, total * pt) + tuple(c.shape[4:]), dtype=c.dtype, device=c.device)
              for c in cache]
    for r in range(b):
        n = -(-own[r] // pt) * pt
        pos = torch.arange(n)
        flat = (table[r, pos // pt].long() * pt + pos % pt).to(k8.device)
        for leaf, c in zip(leaves, cache):
            leaf[:, :, flat] = c[:, :, r, :n]
    return leaves, table.to(k8.device)


def check_paged_decode(torch, dev):
    """K3 at the serving shapes, at page sizes 16, 32, 64 and 128: within
    DECODE_TOL of its plain version, and equal bit for bit to K2 on the
    same content mirrored into a contiguous cache."""
    from generativeaiexamples_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(6)
    L, KH, B, T, HD, G, C = 4, 8, 32, 2048, 128, 4, 8
    window, count = 1024, 5
    q = torch.randn(B, KH * G, HD, device=dev, generator=gen).to(torch.bfloat16)
    cache = [
        torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=gen),
        torch.randint(-127, 128, (L, KH, B, T, HD), dtype=torch.int8, device=dev, generator=gen),
        (torch.rand(L, KH, B, T, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
        (torch.rand(L, KH, B, T, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
    ]
    ab = (
        torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=gen),
        torch.randint(-127, 128, (L, KH, B, C, HD), dtype=torch.int8, device=dev, generator=gen),
        (torch.rand(L, KH, B, C, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
        (torch.rand(L, KH, B, C, device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16),
    )
    lengths = torch.randint(1, window - C, (B,), device=dev, generator=gen, dtype=torch.int32)
    lengths[0] = 0  # an empty lane
    lengths[1] = T - 1  # pinned at max_len - 1: owns only its window's pages
    lengths[2] = window
    lengths[3], lengths[4] = 600, 700  # rows sharing their first pages
    for c in cache:
        c[:, :, 4] = c[:, :, 3]
    own = lengths.clamp(max=window).tolist()
    shared_tokens = 384
    summary = None
    for pt in (16, 32, 64, 128):
        leaves, table = paged_mirror(torch, cache, own, pt, torch.Generator().manual_seed(pt),
                                     share=(3, 4, shared_tokens // pt))
        for with_ab in ((False, True) if pt == 64 else (True,)):
            append = (*ab, count) if with_ab else None
            out = da.paged_decode_attention_cuda(q, *leaves, 1, lengths, table, append, window, pt)
            ref = da.paged_decode_gqa_attention_plain(q, *leaves, 1, lengths, table, append,
                                                      window=window, page_tokens=pt)
            k2 = da.decode_attention_cuda(q, *cache, 1, lengths, append, window)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            use = tolerance_use(out, ref, **DECODE_TOL)
            torch.testing.assert_close(out, ref, **DECODE_TOL)
            if not torch.equal(out, k2):
                diff = (out.float() - k2.float()).abs().max().item()
                raise AssertionError(f"paged_decode_attention page {pt}: differs from K2 on mirrored content ({diff})")
            if not with_ab and out[0].any():
                raise AssertionError("paged_decode_attention: an empty lane must give exact zeros")
            k_ms = time_ms(lambda i: da.paged_decode_attention_cuda(q, *leaves, i, lengths, table, append, window, pt),
                           L, 50, graph=True)
            eager_ms = time_ms(lambda i: da.paged_decode_attention_cuda(q, *leaves, i, lengths, table, append, window,
                                                                        pt), L, 50)
            k2_ms = time_ms(lambda i: da.decode_attention_cuda(q, *cache, i, lengths, append, window), L, 50,
                            graph=True)
            p_ms = time_ms(lambda i: da.paged_decode_gqa_attention_plain(
                q, *leaves, i, lengths, table, append, window=window, page_tokens=pt), L, 5, 1)
            # Bytes: each distinct pool slot the rows read, once (rows 3 and
            # 4 share pages), each row's table entries, the append buffer,
            # q and the output.  Operations: every row's visible slots.
            visible = lengths.clamp(0, window)
            read = torch.arange(window, device=dev)[None, :] < visible[:, None]
            pool_slots = da.paged_window_index(table, window, pt)[read].unique().numel()
            ab_slots = B * count if with_ab else 0
            table_entries = ((visible + pt - 1) // pt).sum().item()
            nbytes = (pool_slots + ab_slots) * KH * (2 * HD + 2 * 2) + table_entries * 4 + q.numel() * 2 * 2 + B * 4
            b_ms, b_by = bound(nbytes, 4.0 * (visible.sum().item() + ab_slots) * G * KH * HD, BF16_FLOPS)
            row = dict(page_tokens=pt, append=with_ab, b=B, max_len=T, window=window, pool_slots_read=pool_slots,
                       row_slots_read=visible.sum().item(), splits=da.decode_plan(B, KH), ms=k_ms,
                       eager_ms=eager_ms, k2_ms=k2_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       bound_share=b_ms / k_ms, max_abs_err=err,
                       tolerance=DECODE_TOL, tolerance_use=use, equal_to_k2=True)
            emit("kernel", kernel="paged_decode_attention", **row)
            if pt == 64 and with_ab:
                summary = dict(row, shape=f"B={B} KH={KH} G={G} max_len={T} window={window} page {pt}, shuffled "
                                          f"pages, append C={C} count={count}")
        del leaves, table
        torch.cuda.empty_cache()
    del cache, ab
    torch.cuda.empty_cache()
    return summary


def check_flash(torch, dev, log, hd: int = 128, nq: int = 32, nkv: int = 8):
    """K4 at the cold-prefill shape (b=8, s=256, ``nq`` / ``nkv`` heads) at
    head_dim ``hd``: 128 for Llama-3-8B (32 / 8), 64 for the Llama-3.2-1B
    draft, 256 for Gemma-7B (16 / 16) and Gemma-2B (8 / 1)."""
    import torch.nn.functional as F

    from generativeaiexamples_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(3)
    b, s = 8, 256
    nv = 4
    qs = [torch.randn(b, s, nq, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    kks = [torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    vvs = [torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    lengths = torch.tensor([256, 200, 131, 256, 180, 140, 256, 160], dtype=torch.int32, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous()
    pos[5, 140:] = -1  # padded query rows
    out = fa.flash_attention_cuda(qs[0], kks[0], vvs[0], pos, lengths)
    ref = fa.flash_gqa_attention_plain(qs[0], kks[0], vvs[0], pos, lengths)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    use = tolerance_use(out, ref, **FLASH_TOL)
    torch.testing.assert_close(out, ref, **FLASH_TOL)
    if out[5, 140:].any():
        raise AssertionError("flash_attention: padded query rows must give exact zeros")
    if not torch.equal(out, fa.flash_attention_cuda(qs[0], kks[0], vvs[0], pos, lengths)):
        raise AssertionError("flash_attention: two calls in a row differ")
    k_ms = time_ms(lambda i: fa.flash_attention_cuda(qs[i], kks[i], vvs[i], pos, lengths), nv, 20, graph=True)
    eager_ms = time_ms(lambda i: fa.flash_attention_cuda(qs[i], kks[i], vvs[i], pos, lengths), nv, 20)
    p_ms = time_ms(lambda i: fa.flash_gqa_attention_plain(qs[i], kks[i], vvs[i], pos, lengths), nv, 3, 1)
    # SDPA with a boolean mask of the same visibility (its fully masked rows
    # would be NaN where the kernel gives 0; none are fully masked here
    # except the padded rows, whose outputs are not compared).
    t_idx = torch.arange(s, device=dev)
    mask = (t_idx[None, None, :] <= pos[:, :, None]) & (t_idx[None, None, :] < lengths[:, None, None])
    mask = mask[:, None]
    qt = [x.transpose(1, 2) for x in qs]
    kt = [x.transpose(1, 2) for x in kks]
    vt = [x.transpose(1, 2) for x in vvs]
    def sdpa(i):
        return F.scaled_dot_product_attention(qt[i], kt[i], vt[i], attn_mask=mask, enable_gqa=True)

    # The yardstick as graph replays like the kernel, with its eager time
    # beside; if its backend cannot be captured, eagerly over many calls.
    lib_eager_ms = time_ms(sdpa, nv, 200)
    try:
        lib_ms, lib_timing = time_ms(sdpa, nv, 20, graph=True), "graph"
    except RuntimeError as exc:
        log.append(f"SDPA graph capture failed, timed eagerly over 200 calls: {exc}")
        torch.cuda.synchronize()
        lib_ms, lib_timing = lib_eager_ms, "eager, 200 calls"
    visible = int(mask.sum().item()) * nq  # (query, key) pairs attended, all heads
    # Bytes the function needs: q only for real rows (padded rows' outputs
    # are 0 by contract), K/V only up to min(kv_len, max position + 1) per
    # row, the whole output written once, positions and lengths.
    kv_slots = int(torch.minimum(lengths, pos.max(dim=1).values + 1).clamp_min(0).sum().item())
    q_rows = int((pos >= 0).sum().item())
    nbytes = (q_rows * nq * hd + kv_slots * 2 * nkv * hd + b * s * nq * hd) * 2 + b * s * 4 + b * 4
    b_ms, b_by = bound(nbytes, 4.0 * visible * hd, BF16_FLOPS)
    row = dict(b=b, s=s, nq=nq, nkv=nkv, ms=k_ms, eager_ms=eager_ms, plain_ms=p_ms, library_ms=lib_ms,
               library_timing=lib_timing, library_eager_ms=lib_eager_ms, beats_library=k_ms < lib_ms,
               bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / k_ms, max_abs_err=err, tolerance=FLASH_TOL,
               tolerance_use=use)
    emit("kernel", kernel="flash_attention", hd=hd, **row)
    return dict(row, shape=f"b={b} s={s} n_q={nq} n_kv={nkv} hd={hd}, ragged kv lengths, padded rows")


# K2/K3 and K4 at one rank's shapes of ``mesh_serve`` (Llama-3-8B over
# MeshSpec(tensor=2)): 4 of the 8 KV heads, group 4; the prefill's 16 / 4.
MESH_RANK_DECODE, MESH_RANK_FLASH = (128, 4, 4), dict(hd=128, nq=16, nkv=4)
# K4 at a tensor=2 training rank's heads (b = 4, s = 1,024, causal).
MESH_TRAIN_RANK_FLASH = dict(nq=16, nkv=4, regime="mesh_train_rank")


def check_mesh_rank(torch, dev, log) -> dict:
    """K2, K3 and K4 against their plain versions at a tensor=2 rank's
    local shapes (``check_decode_instance``, ``check_flash``)."""
    rows = check_decode_instance(torch, dev, *MESH_RANK_DECODE)
    rows["flash_attention"] = check_flash(torch, dev, log, **MESH_RANK_FLASH)
    return rows


# K2/K3's instances beyond Llama's (128, G <= 8), at the families' shapes:
# (head_dim, kv heads, group) of Gemma-7B, Gemma-2B and StarCoder2-3B.
DECODE_INSTANCE_SHAPES = (("gemma-7b", 256, 16, 1), ("gemma-2b", 256, 1, 8), ("starcoder2-3b", 128, 2, 12))


def check_decode_instance(torch, dev, hd: int, kh: int, g: int) -> dict:
    """K2 and K3 (page 64, shuffled pages) at one of the new instances, at
    the serving shape B=32, window 1024, append C=8: K2 within DECODE_TOL of
    its plain version, K3 equal to K2 bit for bit on mirrored content, each
    timed as graph replays and eagerly beside its plain version and its
    byte bound.  Enough layers are cycled that the windows read exceed the
    L2 several times.  Returns {kernel: row}."""
    from generativeaiexamples_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=dev).manual_seed(20 + hd + kh + g)
    B, T, C, window, count, pt = 32, 2048, 8, 1024, 5, 64
    L = max(2, min(16, math.ceil(160e6 / (B * window // 2 * kh * 2 * hd))))
    q = torch.randn(B, kh * g, hd, device=dev, generator=gen).to(torch.bfloat16)

    def int8_leaves(shape):
        return [torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen) for _ in range(2)] + [
            (torch.rand(shape[:-1], device=dev, generator=gen) * 0.015 + 0.005).to(torch.bfloat16) for _ in range(2)]

    cache = int8_leaves((L, kh, B, T, hd))
    append = (*int8_leaves((L, kh, B, C, hd)), count)
    lengths = torch.randint(1, window - C, (B,), device=dev, generator=gen, dtype=torch.int32)
    lengths[0], lengths[1], lengths[2] = 0, T - 1, window
    leaves, table = paged_mirror(torch, cache, lengths.clamp(max=window).tolist(), pt, torch.Generator().manual_seed(7))
    out = da.decode_attention_cuda(q, *cache, 1, lengths, append, window)
    ref = da.decode_gqa_attention_plain(q, *cache, 1, lengths, append, window=window)
    paged = da.paged_decode_attention_cuda(q, *leaves, 1, lengths, table, append, window, pt)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **DECODE_TOL)
    if not torch.equal(paged, out):
        raise AssertionError(f"paged_decode_attention ({hd}, KH {kh}, G {g}): differs from K2 on mirrored content")
    slots = lengths.clamp(0, window).sum().item() + B * count
    nbytes = slots * kh * (2 * hd + 2 * 2) + q.numel() * 2 * 2 + B * 4
    b_ms, b_by = bound(nbytes, 4.0 * slots * g * kh * hd, BF16_FLOPS)
    common = dict(instance="%dx%d" % da.decode_instance(hd, g), hd=hd, kv_heads=kh, group=g, b=B, t=T,
                  window=window, append_c=C, layers_cycled=L, splits=da.decode_plan(B, kh),
                  max_abs_err=(out.float() - ref.float()).abs().max().item(), tolerance=DECODE_TOL,
                  tolerance_use=tolerance_use(out, ref, **DECODE_TOL), library_ms=None, bound_ms=b_ms, bound_by=b_by)
    rows = {}
    for name, fn, plain in (
        ("decode_attention", lambda i: da.decode_attention_cuda(q, *cache, i, lengths, append, window),
         lambda i: da.decode_gqa_attention_plain(q, *cache, i, lengths, append, window=window)),
        ("paged_decode_attention", lambda i: da.paged_decode_attention_cuda(q, *leaves, i, lengths, table, append,
                                                                            window, pt),
         lambda i: da.paged_decode_gqa_attention_plain(q, *leaves, i, lengths, table, append, window=window,
                                                       page_tokens=pt)),
    ):
        k_ms = time_ms(fn, L, 50, graph=True)
        row = dict(common, ms=k_ms, eager_ms=time_ms(fn, L, 50), plain_ms=time_ms(plain, L, 3, 1),
                   bound_share=b_ms / k_ms, **({"page_tokens": pt, "equal_to_k2": True} if name != "decode_attention"
                                                else {}))
        emit("kernel", kernel=name, **row)
        rows[name] = row
    del cache, leaves, table
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# small reference model: kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------


def _to_device(torch, x, d):
    """A param tree (dicts, dataclass leaves, tensors) copied to device ``d``."""
    if isinstance(x, dict):
        return {k: _to_device(torch, v, d) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return type(x)(**{f: _to_device(torch, getattr(x, f), d) for f in x.__dataclass_fields__})
    return x.to(d) if isinstance(x, torch.Tensor) else x


class ToleranceError(AssertionError):
    """A card-vs-CPU comparison beyond its tolerance; ``fields`` holds
    every comparison's readings."""

    def __init__(self, message: str, fields: dict):
        super().__init__(message)
        self.fields = fields


def card_vs_cpu(torch, dev, cfg, seed: int, s: int, lengths: list, tol: dict, cacheless: bool = False,
                built_on: str = "cpu") -> dict:
    """Random W8A8 params of ``cfg`` from ``seed`` (made on ``built_on``,
    the CPU or the card, and copied to the other) through the kernels on
    the card and through the plain versions on the CPU: the cold-prefill
    logits, then the logits of one append-buffer decode step from the
    CPU's cache, and with ``cacheless`` the cacheless forward's logits,
    each within ``tol``: element by element (``atol`` / ``rtol``), or as a
    share of the logits' size (``rel_rms`` / ``max_abs_frac``).  Returns
    each comparison's largest error and tolerance use; raises
    :class:`ToleranceError`, naming every comparison beyond its tolerance,
    when one is."""
    from generativeaiexamples_tpu_torch.engine.decode import w8a8_params
    from generativeaiexamples_tpu_torch.models import llama

    gen = torch.Generator().manual_seed(seed)
    if built_on == "cpu":
        params_cpu = w8a8_params(cfg, None, device="cpu", generator=gen)
        params_dev = _to_device(torch, params_cpu, dev)
    else:
        params_dev = w8a8_params(cfg, None, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
        params_cpu = _to_device(torch, params_dev, "cpu")
    b = len(lengths)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    lengths = torch.tensor(lengths, dtype=torch.int32)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    routes: dict = {}  # (phase, device) -> each MoE layer's chosen experts

    def forward(phase, d, *args, **kw):
        top_k = llama._top_k

        def recording(probs, k):
            values, idx = top_k(probs, k)
            routes.setdefault((phase, str(d)), []).append(idx.sort(-1).values.reshape(b, -1, k)[:, :s].cpu())
            return values, idx

        llama._top_k = recording
        try:
            return llama.forward(*args, **kw)
        finally:
            llama._top_k = top_k

    prefill, caches, plain = {}, {}, {}
    for d, params in (("cpu", params_cpu), (dev, params_dev)):
        cache = llama.init_kv_cache(cfg, b, 128, device=d)
        hidden, caches[d] = forward("prefill", d, params, cfg, tokens.to(d), pos.to(d), cache, lengths.to(d),
                                    cold_prefill=True)
        prefill[d] = llama.logits(params, hidden).cpu()
        if cacheless:
            hidden, _ = forward("cacheless", d, params, cfg, tokens.to(d), pos.to(d), None, lengths.to(d))
            plain[d] = llama.logits(params, hidden).cpu()
    first = prefill["cpu"][torch.arange(b), lengths.long() - 1].argmax(-1)
    decode = {}
    for d, params in (("cpu", params_cpu), (dev, params_dev)):
        ab_shape = (cfg.n_layers, cfg.n_kv_heads, b, 1, cfg.head_dim)
        ab = tuple(torch.zeros(shape, dtype=dt, device=d) for shape, dt in (
            (ab_shape, torch.int8), (ab_shape, torch.int8),
            (ab_shape[:-1], torch.bfloat16), (ab_shape[:-1], torch.bfloat16)))
        cache = tuple(c.to(d) for c in caches["cpu"])
        hidden, _, _ = forward("decode", d, params, cfg, first[:, None].to(d), lengths[:, None].to(d), cache,
                               lengths.to(d), kv_bucket=64, append_cache=(ab, 0))
        decode[d] = llama.logits(params, hidden).cpu()
    valid = torch.arange(s)[None, :] < lengths[:, None]
    fields, failures = {}, []
    pairs = [("prefill", prefill[dev][valid], prefill["cpu"][valid]), ("decode", decode[dev], decode["cpu"])]
    if cacheless:
        pairs.append(("cacheless", plain[dev][valid], plain["cpu"][valid]))
    for phase, out, ref in pairs:
        if not torch.isfinite(out).all():
            raise AssertionError(f"non-finite {phase} logits on the card")
        fields[f"{phase}_logit_max_abs_err"] = (out - ref).abs().max().item()
        # A MoE token whose experts differ at some layer (a near tie in
        # the router, rounded one way on the card and the other on the
        # CPU) is the same function on either side of a step: its logits
        # are held only to the RMS bound, and fewer than one token in 8
        # may be such (none of the decode step's 2).
        same = torch.ones(out.shape[0], dtype=torch.bool)
        if routes:
            rows = valid if phase != "decode" else torch.ones(b, 1, dtype=torch.bool)
            moved = torch.zeros(rows.shape, dtype=torch.bool)
            for card, cpu in zip(routes[(phase, str(dev))], routes[(phase, "cpu")]):
                moved |= (card != cpu).any(-1)[:, : rows.shape[1]]
            same = ~moved[rows]
            fields[f"{phase}_tokens_routed_elsewhere"] = int((~same).sum())
            if (~same).sum() > same.numel() // 8:
                failures.append(f"{phase}: {int((~same).sum())} of {same.numel()} tokens routed to other experts "
                                "on the card than on the CPU")
        if "rel_rms" in tol:
            rms = ((out - ref).square().mean().sqrt() / ref.square().mean().sqrt()).item()
            frac = ((out - ref)[same].abs().max() / ref.abs().max()).item() if same.any() else 0.0
            fields[f"{phase}_rel_rms_err"] = rms
            fields[f"{phase}_max_err_frac"] = frac
            fields[f"{phase}_tolerance_use"] = max(rms / tol["rel_rms"], frac / tol["max_abs_frac"])
            if fields[f"{phase}_tolerance_use"] > 1:
                failures.append(f"{phase} logits card vs CPU: RMS error {rms:.4f} of the logits' RMS, max error "
                                f"{frac:.4f} of their largest (tokens routed alike), beyond {tol}")
        else:
            fields[f"{phase}_tolerance_use"] = tolerance_use(out, ref, **tol)
            try:
                torch.testing.assert_close(out, ref, **tol)
            except AssertionError as e:
                failures.append(f"{phase}: {e}")
    fields["logit_scale"] = prefill["cpu"][valid].abs().max().item()
    if failures:
        raise ToleranceError("; ".join(failures), fields)
    fields["logit_scale"] = prefill["cpu"][valid].abs().max().item()
    return fields


# The MoE's float products (router and experts: ``float_dot``, f32 sums
# rounded once to bf16), card vs CPU on the same operands: the RMS of the
# difference at most 2^-8 of the product's own.  Two f32 sums of another
# order, each rounded once, differ by at most one bf16 ulp and rarely;
# bf16 partial sums move every element.
MOE_PRODUCT_TOL = 2.0**-8


def moe_products_vs_cpu(torch, dev, cfg, seed: int) -> dict:
    """The MoE's float products and its top-k on the card against the CPU,
    held directly: through the W8A8 logits a wrong float product hides in
    the int8 code flips (``perf_torch/rehearse_family_tol.py``).
    ``float_dot`` at the router's and the experts' shapes on one
    ``MOE_BLOCK_ROWS`` block of random bf16 operands within
    :data:`MOE_PRODUCT_TOL`, and ``_top_k`` over router probabilities on
    a grid of 1/16 (most rows hold ties, many at the top-k edge) equal to
    the CPU's.  Raises :class:`ToleranceError` when either is not."""
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.quant import float_dot

    gen = torch.Generator(device=dev).manual_seed(seed)
    E, d, f, rows = cfg.n_experts, cfg.d_model, cfg.d_ff, llama.MOE_BLOCK_ROWS

    def bf16(*shape, fan_in=1):
        # Made where they are multiplied first (a CPU draw of the experts'
        # 0.9 GB would cost seconds), then copied.
        return (torch.randn(*shape, generator=gen, device=dev) * fan_in**-0.5).to(torch.bfloat16)

    x = bf16(E, rows, d)
    products = {"router": (x[0], bf16(d, E, fan_in=d)), "expert_up": (x, bf16(E, d, f, fan_in=d)),
                "expert_down": (bf16(E, rows, f), bf16(E, f, d, fan_in=f))}
    fields, failures = {}, []
    for name, (a, w) in products.items():
        out = float_dot(a, w).float().cpu()
        ref = float_dot(a.cpu(), w.cpu()).float()
        err = ((out - ref).square().mean().sqrt() / ref.square().mean().sqrt()).item()
        fields[f"{name}_rel_rms_err"] = err
        if not err <= MOE_PRODUCT_TOL:
            failures.append(f"{name} product card vs CPU: RMS error {err:.3g} of its RMS, beyond {MOE_PRODUCT_TOL:.3g}")
    del products, x
    probs = torch.randint(0, 16, (4096, E), generator=torch.Generator().manual_seed(seed)).float() / 16
    values, idx = llama._top_k(probs.to(dev), cfg.n_experts_per_tok)
    ref_values, ref_idx = llama._top_k(probs, cfg.n_experts_per_tok)
    fields["top_k_rows_differing"] = int(((idx.cpu() != ref_idx) | (values.cpu() != ref_values)).any(-1).sum())
    if fields["top_k_rows_differing"]:
        failures.append(f"top-k on tied router probabilities: {fields['top_k_rows_differing']} of 4096 rows "
                        "differ from the CPU's")
    if failures:
        raise ToleranceError("; ".join(failures), fields)
    return fields


def check_reference(torch, dev):
    """A small bf16 model (head_dim 128) through the kernels on the card and
    through the plain versions on the CPU: cold-prefill logits, then the
    logits of one append-buffer decode step from the CPU's cache, each
    within REFERENCE_TOL element by element (:func:`card_vs_cpu`)."""
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=512, d_model=512, n_layers=2, n_heads=8, n_kv_heads=2, head_dim=128,
                            d_ff=1024, max_seq_len=256, rope_theta=10000.0, kv_dtype="int8")
    fields = card_vs_cpu(torch, dev, cfg, 4, 48, [48, 30, 17, 40], REFERENCE_TOL)
    emit("reference", config="d_model=512 n_layers=2 heads=8/2 head_dim=128 bf16", tolerance=REFERENCE_TOL,
         **fields)


# ---------------------------------------------------------------------------
# the retrieval side: BERT, the embedder, the exact vector store
# ---------------------------------------------------------------------------


def bert_flops(cfg, b: int, s: int) -> float:
    """One forward's multiply-adds x 2: the four projections and the MLP of
    every token, and QK^T and PV over every (query, key) pair."""
    per_layer = 2.0 * b * s * (4 * cfg.d_model ** 2 + 2 * cfg.d_model * cfg.d_ff) + 4.0 * b * s * s * cfg.d_model
    return cfg.n_layers * per_layer


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def check_bert(torch, dev) -> None:
    """BERT at arctic-embed-l's width, 2 layers, bf16, random weights from
    seed 0, on the card and on the CPU with the same weights: the pooled
    embeddings of a padded batch, and the rerank scores of the same batch
    with two segments, within BERT_TOL."""
    from generativeaiexamples_tpu_torch.models import bert

    cfg = bert.arctic_embed_l(n_layers=2)
    gen = torch.Generator().manual_seed(0)
    params, head = bert.init_params(cfg, gen, "cpu"), bert.init_rerank_head(cfg, gen, "cpu")
    lengths = [512, 300, 129, 1, 77, 512, 40, 256]
    tokens = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen)
    mask = (torch.arange(512)[None, :] < torch.tensor(lengths)[:, None]).long()
    types = (torch.arange(512)[None, :] >= torch.tensor(lengths)[:, None] // 2).long() * mask
    out = {}
    with torch.inference_mode():
        for d, p, h in (("cpu", params, head), ("card", _to(params, dev), _to(head, dev))):
            args = (tokens.to(p["tok_embed"].device), mask.to(p["tok_embed"].device))
            out[d] = (bert.embed(p, cfg, *args).cpu(),
                      bert.rerank_score(p, h, cfg, *args, types.to(p["tok_embed"].device)).cpu())
    fields = {}
    for i, what in enumerate(("embedding", "rerank_score")):
        got, ref = out["card"][i], out["cpu"][i]
        if not torch.isfinite(got).all():
            raise AssertionError(f"bert: non-finite {what} on the card")
        torch.testing.assert_close(got, ref, **BERT_TOL)
        fields[f"{what}_max_abs_err"] = (got - ref).abs().max().item()
        fields[f"{what}_tolerance_use"] = tolerance_use(got, ref, **BERT_TOL)
    fields["rerank_score_scale"] = out["cpu"][1].abs().max().item()
    emit("bert", config="arctic-embed-l width (d 1024, 16 heads, d_ff 4096), 2 layers, bf16, seed 0",
         batch="8 x 512, lengths " + ",".join(map(str, lengths)), tolerance=BERT_TOL, **fields)


def _texts(seed: int, n: int, n_chars: int) -> list:
    import random

    rng = random.Random(seed)
    return ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz ,.") for _ in range(n_chars)) for _ in range(n)]


def _unit_rows(torch, vecs) -> bool:
    v = torch.as_tensor(vecs)
    return bool(torch.isfinite(v).all()) and bool(((v.norm(dim=1) - 1).abs() < 1e-3).all())


def embed_phase(torch, dev):
    """arctic-embed-l at full depth through the port's embedder.  Returns
    the embedder (``serve`` uses it) and its queries."""
    from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
    from generativeaiexamples_tpu_torch.models import bert

    cfg = bert.arctic_embed_l()
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    embedder = GPUEmbedder(cfg, device=dev)
    n_params = sum(v.numel() for v in embedder.params.values() if torch.is_tensor(v)) + sum(
        v.numel() for v in embedder.params["layers"].values())
    params_gb = (torch.cuda.memory_allocated(dev) - mem0) / 1e9
    docs = _texts(10, 256, 510)  # the splitter's 510-token chunk: BOS + 510 bytes -> a 512 bucket
    queries = _texts(11, 32, 60)
    embedder.embed_documents(docs[:32])  # warm-up: cuBLAS handles and algorithms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    doc_vecs = embedder.embed_documents(docs)
    docs_s = time.perf_counter() - t0
    batch_vecs = embedder.embed_queries(queries)
    alone = [embedder.embed_query(q) for q in queries]
    if len(doc_vecs) != 256 or not _unit_rows(torch, doc_vecs) or not _unit_rows(torch, batch_vecs):
        raise AssertionError("embed: vectors not finite or not of unit norm to 1e-3")
    diff = (torch.tensor(alone) - torch.tensor(batch_vecs)).abs().max().item()
    torch.testing.assert_close(torch.tensor(alone), torch.tensor(batch_vecs), **EMBED_TOL)
    # One 32 x 512 forward, device time by CUDA events (median of 5).
    ids = [embedder.tokenizer.encode(t, add_bos=True) for t in docs[:32]]
    tokens = torch.tensor(ids, device=dev)
    mask = torch.ones_like(tokens)
    tokens = torch.nn.functional.pad(tokens, (0, 512 - tokens.shape[1]))
    mask = torch.nn.functional.pad(mask, (0, 512 - mask.shape[1]))
    times = []
    with torch.inference_mode():
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            bert.embed(embedder.params, cfg, tokens, mask)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    fwd_ms = sorted(times[1:])[2]
    flops = bert_flops(cfg, 32, 512)
    bound_ms = flops / BF16_FLOPS * 1e3
    emit("embed", model="arctic-embed-l", layers=cfg.n_layers, params=n_params, weights="random bf16, seed 0",
         params_device_gb=params_gb, peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         documents=len(docs), doc_tokens=512, docs_per_s=len(docs) / docs_s, embed_documents_s=docs_s,
         forward_ms_32x512=fwd_ms, forward_flops=flops, flop_bound_ms=bound_ms, bound_share=bound_ms / fwd_ms,
         forward_ms_all=times, queries=len(queries), query_alone_vs_batch_max_abs_err=diff, tolerance=EMBED_TOL,
         unit_norm=True)
    return embedder, queries


def _clustered_rows(np, rng, centres, assign, noise: float):
    """Unit rows: a unit centre plus Gaussian noise of norm ~``noise``."""
    d = centres.shape[1]
    rows = centres[assign] + rng.standard_normal((len(assign), d), dtype=np.float32) * np.float32(noise / math.sqrt(d))
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows


def _brute_top(torch, np, corpus, queries, k: int, dev):
    """Top k+1 of an f64 scan over the bf16-rounded corpus and queries,
    on ``dev`` (the host rows uploaded block by block): (scores, rows) per
    query, host arrays."""
    def bf16(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(torch.bfloat16).double()

    q = bf16(queries)
    scores = torch.empty((len(q), len(corpus)), dtype=torch.float64, device=dev)
    for lo in range(0, len(corpus), 65536):
        scores[:, lo:lo + 65536] = q @ bf16(corpus[lo:lo + 65536]).T
    top_s, top = torch.sort(scores, dim=1, descending=True, stable=True)
    return top_s[:, : k + 1].cpu().numpy(), top[:, : k + 1].cpu().numpy()


def _card_corpus(torch, dev, n: int, d: int, seed: int):
    """(corpus (n, d) f32 host rows, centres (1000, d) host) drawn on the
    card from ``seed``: 1,000 unit Gaussian centres, each row a centre plus
    noise of norm ~0.8, unit norm."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    centres = torch.randn((1000, d), generator=gen, device=dev)
    centres /= centres.norm(dim=1, keepdim=True)
    assign = torch.randint(0, 1000, (n,), generator=gen, device=dev)
    corpus = torch.empty((n, d), dtype=torch.float32, pin_memory=dev.type == "cuda")
    for lo in range(0, n, 65536):
        rows = centres[assign[lo:lo + 65536]] + torch.randn((min(65536, n - lo), d), generator=gen, device=dev) * (
            0.8 / math.sqrt(d))
        corpus[lo:lo + 65536].copy_(rows / rows.norm(dim=1, keepdim=True))
    return corpus.numpy(), centres.cpu().numpy()


RETRIEVE_ROWS, RETRIEVE_DIM, RETRIEVE_QUERIES, RETRIEVE_APPEND = 1_000_000, 1024, 128, 5000


def retrieve_phase(torch, dev):
    """The exact store at 1,000,000 x 1024 bf16 rows on the card, built by
    the port's ``get_store()`` from the ``AppConfig`` defaults (the
    ``retriever`` phase's chain searches it, the ``stores`` phase reads its
    corpus).  Returns the store, the 128 queries and the 64 planted rows."""
    import numpy as np

    from generativeaiexamples_tpu_torch.chains import factory
    from generativeaiexamples_tpu_torch.retrieval.base import Chunk
    from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore

    n, d = RETRIEVE_ROWS, RETRIEVE_DIM
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    corpus, centres = _card_corpus(torch, dev, n, d, seed=0)
    chunks = [Chunk(text=f"row {i}", source=f"doc{i // 1000}", id=str(i)) for i in range(n)]
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    store = factory.get_store()
    if not isinstance(store, GPUVectorStore) or store._dtype != torch.bfloat16 or store.device != dev:
        raise AssertionError(f"retrieve: get_store() gave {store!r}, not the exact bf16 store on {dev}")
    t0 = time.perf_counter()
    store.add(chunks, corpus)
    add_s = time.perf_counter() - t0
    del chunks
    corpus = store._mirror._vecs  # the same rows, held once
    # 64 planted queries (a corpus row plus small noise) and 64 fresh points.
    planted = rng.choice(n, 64, replace=False)
    queries = np.concatenate([
        _clustered_rows(np, rng, corpus, planted, 0.1),
        _clustered_rows(np, rng, centres, rng.integers(0, 1000, RETRIEVE_QUERIES - 64), 0.8),
    ])
    t0 = time.perf_counter()
    store.search_batch(queries[:1], 1)  # the first sync: the device build
    build_s = time.perf_counter() - t0
    device_gb = (torch.cuda.memory_allocated(dev) - mem0) / 1e9
    stats = store.capacity_stats()
    results = {}
    for k in (4, 10):
        hits = store.search_batch(queries, k)
        results[k] = hits
        if any(not h or h[0].chunk.id != str(int(r)) for h, r in zip(hits[:64], planted)):
            raise AssertionError(f"retrieve: a planted query's row does not rank first at top_k {k}")
    # Ids against an f64 brute force over the same bf16 values, for 16
    # queries (8 planted): equal wherever the gap below a rank exceeds RANK_EPS.
    sel = np.r_[0:8, 64:72]
    b_scores, b_rows = _brute_top(torch, np, corpus, queries[sel], 10, dev)
    checked = 0
    score_err = 0.0
    for qi, bs, br in zip(sel, b_scores, b_rows):
        got = results[10][qi]
        score_err = max(score_err, max(abs(h.score - s) for h, s in zip(got, bs)))
        for j in range(10):
            if bs[j] - bs[j + 1] > RANK_EPS:
                checked += 1
                if {h.chunk.id for h in got[: j + 1]} != {str(int(r)) for r in br[: j + 1]}:
                    raise AssertionError(f"retrieve: query {qi} top-{j + 1} differs from the f64 brute force")
    if not checked or score_err > 1e-4:
        raise AssertionError(f"retrieve: brute-force check: {checked} ranks checked, score error {score_err}")
    timing = {k: _time_scan(torch, store, queries, k) for k in (4, 10)}
    cap, tail_cap = int(store._device_buf.shape[0]), int(store._tail_buf.shape[0])
    nbytes = (cap + tail_cap) * d * 2 + cap + tail_cap + RETRIEVE_QUERIES * d * 4
    b_ms, b_by = bound(nbytes, 2.0 * RETRIEVE_QUERIES * (cap + tail_cap) * d, BF16_FLOPS)
    # 5,000 new rows ride the tail: each found by a query planted on it.
    buf0 = store._device_buf
    new = _clustered_rows(np, rng, centres, rng.integers(0, 1000, RETRIEVE_APPEND), 0.8)
    store.add([Chunk(text=f"new {i}", source="appended", id=f"new{i}") for i in range(RETRIEVE_APPEND)], new)
    t0 = time.perf_counter()
    found = store.search_batch(_clustered_rows(np, rng, new, np.arange(RETRIEVE_APPEND), 0.1), 1)
    append_search_s = time.perf_counter() - t0
    after = store.capacity_stats()
    if [h[0].chunk.id if h else None for h in found] != [f"new{i}" for i in range(RETRIEVE_APPEND)]:
        raise AssertionError("retrieve: an appended row is not found by its planted query")
    if store._device_buf is not buf0 or after["tail_rows"] != RETRIEVE_APPEND or store._base != n:
        raise AssertionError(f"retrieve: the append rebuilt the main buffer ({after})")
    # A masked delete of one source: only the masks re-upload.
    held = (store._device_buf, store._tail_buf, store._device_valid, store._tail_valid)
    removed = store.delete_source("doc7")
    gone = store.search_batch(_clustered_rows(np, rng, corpus, np.arange(7000, 7064), 0.1), 10)
    if removed != 1000 or any(h.chunk.source == "doc7" for hits in gone for h in hits):
        raise AssertionError("retrieve: a deleted source came back")
    if store._device_buf is not held[0] or store._tail_buf is not held[1] or store._device_valid is held[2]:
        raise AssertionError("retrieve: the delete re-uploaded more than the masks")
    emit("retrieve", rows=n, dim=d, dtype="bfloat16",
         corpus="1000 Gaussian centres + noise, unit norm, drawn on the card from seed 0",
         generate_s=gen_s, add_s=add_s, first_sync_s=build_s, capacity=cap, tail_capacity=tail_cap,
         device_gb=device_gb, store_bytes=stats["bytes"], peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         queries=RETRIEVE_QUERIES, planted_first=True, brute_force_ranks_checked=checked,
         brute_force_max_score_err=score_err, rank_eps=RANK_EPS,
         **{f"top{k}_{key}": v for k, t in timing.items() for key, v in t.items()},
         bound_ms=b_ms, bound_by=b_by, bound_share_top4=b_ms / timing[4]["scan_ms"],
         bound_share_top10=b_ms / timing[10]["scan_ms"], appended=RETRIEVE_APPEND,
         append_found_s=append_search_s, tail_rows=after["tail_rows"], rebuilt=False,
         deleted_rows=removed, delete_uploaded="masks only", max_query_batch=store.max_query_batch)
    return store, queries, planted


def _time_scan(torch, store, queries, k: int) -> dict:
    """A 128-query batch: the device work (the f32 scan of main and tail,
    the masks, ``torch.topk`` of each) timed by CUDA events, median of 12,
    with the main buffer's product alone and ``torch.topk`` alone beside it;
    and ``search_batch`` whole by the host clock (median of 10), host
    selection and result assembly included."""
    from generativeaiexamples_tpu_torch.retrieval.gpu import scores_f32

    snap = store._prepared()
    Q = torch.from_numpy(queries).to(store.device)

    def device_work():
        parts = store.scan(snap, Q)
        return [torch.topk(p, k + 1, dim=1) for p in parts]

    device_work()
    scan_ms = _event_ms(torch, device_work)
    Qc = Q.to(snap[0].dtype)
    product_ms = _event_ms(torch, lambda: scores_f32(Qc, snap[0]))
    parts = store.scan(snap, Q)
    topk_ms = _event_ms(torch, lambda: [torch.topk(p, k + 1, dim=1) for p in parts])
    del parts
    return dict(scan_ms=scan_ms, product_ms=product_ms, topk_ms=topk_ms, topk_share=topk_ms / scan_ms,
                search_batch_ms=_host_ms(lambda: store.search_batch(queries, k)))


# A timed median takes at most this many ms of runs beyond the first
# (at least 3 runs): slow calls (an IVF batch of ~300 ms) are timed fewer
# times than fast ones; no check reads the extra runs.
TIMING_BUDGET_MS = 1000.0


def _runs_for(first_ms: float, n: int) -> int:
    return max(3, min(n, int(TIMING_BUDGET_MS / max(first_ms, 1e-3))))


def _event_ms(torch, fn, n: int = 12) -> float:
    """Median of ``n`` runs of ``fn`` between two CUDA events (fewer where
    one run is slow: ``TIMING_BUDGET_MS``)."""
    out = []
    for i in range(n):
        if i == 1:
            n = min(n, _runs_for(out[0], n))
        if i >= n:
            break
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return sorted(out)[n // 2]


def _host_ms(fn, n: int = 10) -> float:
    """Median of ``n`` runs of ``fn`` by the host clock (fewer where one run
    is slow: ``TIMING_BUDGET_MS``)."""
    out = []
    for i in range(n):
        if i == 1:
            n = min(n, _runs_for(out[0], n))
        if i >= n:
            break
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)[n // 2]


# ---------------------------------------------------------------------------
# the retrieval call chain built from AppConfig (Retriever, cache, ladder)
# ---------------------------------------------------------------------------

CHAIN_DOCS, CHAIN_QUERIES, CHAIN_CONCURRENT, CHAIN_LADDER, CHAIN_RERANK = 2048, 128, 32, 16, 32


class _NoFallback:
    """The store without its host fallback: the ladder's next rung is the
    stale cache."""

    def __init__(self, store):
        self._store = store

    def search_batch(self, embeddings, top_k):
        return self._store.search_batch(embeddings, top_k)

    def version(self):
        return self._store.version()


class _DeviceWork:
    """Counts BERT forwards and store scans while it is entered (each wraps
    the module-level function the path calls)."""

    def __init__(self):
        from generativeaiexamples_tpu_torch.models import bert
        from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore

        self._bert, self._store_cls = bert, GPUVectorStore
        self.forwards = self.scans = 0

    def __enter__(self):
        embed, scan = self._embed, self._scan = self._bert.embed, self._store_cls.scan

        def counted_embed(*a, **k):
            self.forwards += 1
            return embed(*a, **k)

        def counted_scan(*a, **k):
            self.scans += 1
            return scan(*a, **k)

        self._bert.embed = counted_embed
        self._store_cls.scan = staticmethod(counted_scan)
        return self

    def __exit__(self, *exc):
        self._bert.embed = self._embed
        self._store_cls.scan = staticmethod(self._scan)


def _ids(hits):
    return [h.chunk.id for h in hits]


def _same_ranks(got, want, k: int, where: str) -> int:
    """``got`` (top k per query) against ``want`` (top k + 1 of the same
    candidates): equal id sets at every rank whose gap to the next score of
    ``want`` exceeds RANK_EPS, scores within 1e-4.  Returns the ranks
    checked."""
    checked = 0
    for qi, (g, w) in enumerate(zip(got, want)):
        ws = [h.score for h in w] + [-math.inf]
        if len(g) != min(k, len(w)) or any(abs(a.score - b) > 1e-4 for a, b in zip(g, ws)):
            raise AssertionError(f"{where}: query {qi} scores {[h.score for h in g]} != {ws}")
        for j in range(len(g)):
            if ws[j] - ws[j + 1] > RANK_EPS:
                checked += 1
                if set(_ids(g[: j + 1])) != set(_ids(w[: j + 1])):
                    raise AssertionError(f"{where}: query {qi} top-{j + 1} {_ids(g)} != {_ids(w)}")
    return checked


def _requests(n, route="/search"):
    from generativeaiexamples_tpu_torch.cache.log import CacheLog
    from generativeaiexamples_tpu_torch.obs.trace import RequestTrace
    from generativeaiexamples_tpu_torch.resilience.degrade import DegradeLog

    return ([DegradeLog() for _ in range(n)], [CacheLog() for _ in range(n)],
            [RequestTrace(route=route) for _ in range(n)])


def _retrieve(retriever, queries, k=None):
    """One traced ``retrieve_many``: (results, logs, cache logs, traces,
    wall ms)."""
    logs, clogs, traces = _requests(len(queries))
    t0 = time.perf_counter()
    out = retriever.retrieve_many(queries, top_k=k, degrade_logs=logs, cache_logs=clogs, traces=traces)
    return out, logs, clogs, traces, (time.perf_counter() - t0) * 1e3


def _direct(retriever, queries, fetch_k):
    """The same work by direct calls: threshold-filtered device hits."""
    vecs = retriever.embedder.embed_queries(queries)
    return [[h for h in hits if h.score >= retriever.score_threshold]
            for hits in retriever.store.search_batch(vecs, fetch_k)], vecs


def _stage_ms(traces) -> dict:
    """Each stage's ms (summed where a stage repeats) of the first trace:
    the batch's stages are shared, so every member holds the same."""
    out: dict = {}
    for s in traces[0].stages():
        key = s["stage"] + (f"_{s['attrs']['tier']}" if s.get("attrs", {}).get("tier") else "")
        out[key] = out.get(key, 0.0) + s["duration_ms"]
    return out


def _clean_logs(logs, where: str) -> None:
    marked = [log.stages() for log in logs if log]
    if marked:
        raise AssertionError(f"retriever: {where}: degraded {marked}")


def _ring_check(torch, np, dev, cfg) -> dict:
    """The semantic ring at its configured size on the card: 128 lookups
    near stored vectors (cosine ~0.99) and 128 random ones against a numpy
    f64 reference over the same f32 values."""
    from generativeaiexamples_tpu_torch.cache.core import RetrievalCache, _unit

    d, cap = cfg.embeddings.dimensions, cfg.cache.semantic_entries
    rng = np.random.default_rng(2)
    cache = RetrievalCache(d, max_entries=cfg.cache.max_entries, semantic_entries=cap,
                           similarity_threshold=cfg.cache.similarity_threshold, device=dev)
    stored = rng.standard_normal((cap + 88, d)).astype(np.float32)
    stored /= np.linalg.norm(stored, axis=1, keepdims=True)
    t0 = time.perf_counter()
    for i, v in enumerate(stored.tolist()):  # cap + 88 admits: the ring wraps
        cache.admit(f"ring {i}", 4, "rag", 0, v, [], [])
    torch.cuda.synchronize()
    admit_ms = (time.perf_counter() - t0) * 1e3 / len(stored)
    live = stored[88:]
    near = live[rng.integers(0, cap, 128)] + 0.14 / math.sqrt(d) * rng.standard_normal((128, d)).astype(np.float32)
    queries = np.concatenate([near, rng.standard_normal((128, d)).astype(np.float32)])
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    qlist = queries.tolist()
    cache.lookup_semantic_many(qlist[:8], "rag", 0)  # warm-up
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = cache.lookup_semantic_many(qlist, "rag", 0)
        times.append((time.perf_counter() - t0) * 1e3)
    ring = cache._ring.cpu().numpy().astype(np.float64)
    valid = cache._ring_valid.cpu().numpy()
    scored = np.stack([_unit(q) for q in qlist]).astype(np.float64)  # the vectors the cache scores
    sims = np.where(valid[None, :], scored @ ring.T, -np.inf)
    order = np.argsort(-sims, axis=1)
    checked_argmax = checked_hit = 0
    for qi, found in enumerate(got):
        best, second = sims[qi, order[qi, 0]], sims[qi, order[qi, 1]]
        slot = next(i for i, e in enumerate(cache._ring_entries) if e is found[0]) if found is not None else None
        if best - cache.similarity_threshold > RANK_EPS:
            checked_hit += 1
            if found is None:
                raise AssertionError(f"retriever: ring: query {qi} at {best:.6f} missed")
            if best - second > RANK_EPS:
                checked_argmax += 1
                if slot != order[qi, 0]:
                    raise AssertionError(f"retriever: ring: query {qi} took slot {slot}, f64 says {order[qi, 0]}")
            if abs(found[1] - best) > 1e-6:
                raise AssertionError(f"retriever: ring: query {qi} similarity {found[1]} vs f64 {best}")
        elif cache.similarity_threshold - best > RANK_EPS:
            checked_hit += 1
            if found is not None:
                raise AssertionError(f"retriever: ring: query {qi} at {best:.6f} hit")
    hits = sum(g is not None for g in got)
    if hits != 128 or checked_argmax < 128 or checked_hit != 256:
        raise AssertionError(f"retriever: ring: {hits} hits, {checked_argmax} argmaxes, {checked_hit} hit tests")
    ms = sorted(times)[2]
    return dict(ring_shape=[cap, d], ring_admit_ms_per_entry=admit_ms, ring_lookups=len(qlist), ring_hits=hits,
                ring_argmax_checked=checked_argmax,
                ring_hit_tests_checked=checked_hit, ring_lookup_ms_256=ms, ring_lookup_ms_per_query=ms / len(qlist))


def _concurrent_retrievals(np, factory, queries) -> dict:
    """``CHAIN_CONCURRENT`` requests at once through the process-wide
    micro-batcher, each with its own 2 s deadline, logs and trace."""
    from generativeaiexamples_tpu_torch.resilience.deadline import Deadline

    batcher = factory.get_retrieval_batcher()
    before = batcher.stats.snapshot()
    logs, clogs, traces = _requests(len(queries))
    lat, errors = [0.0] * len(queries), []
    start = threading.Barrier(len(queries))

    def one(i):
        start.wait()
        t0 = time.perf_counter()
        try:
            batcher.call((queries[i], 4, logs[i], clogs[i], traces[i]), deadline=Deadline.after_ms(2000),
                         trace=traces[i])
        except Exception as exc:  # reported below: the gate fails
            errors.append(f"{type(exc).__name__}: {exc}")
        lat[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise AssertionError(f"retriever: concurrent: {errors[:3]}")
    _clean_logs(logs, "concurrent")
    after = batcher.stats.snapshot()
    batches = after["batches_total"] - before["batches_total"]
    tiers = [c.tier or "miss" for c in clogs]
    waits = [s["duration_ms"] for tr in traces for s in tr.stages() if s["stage"] == "queue_wait"]
    if len(waits) != len(queries):
        raise AssertionError(f"retriever: concurrent: {len(waits)} queue_wait stages for {len(queries)} requests")
    return dict(concurrent_requests=len(queries), concurrent_batches=batches,
                concurrent_mean_batch=(after["batch_size_sum"] - before["batch_size_sum"]) / batches,
                concurrent_p50_ms=float(np.percentile(lat, 50)), concurrent_p95_ms=float(np.percentile(lat, 95)),
                concurrent_queue_wait_ms_p50=float(np.percentile(waits, 50)),
                concurrent_tiers={t: tiers.count(t) for t in sorted(set(tiers))})


def retriever_phase(torch, dev, store) -> None:
    """The retrieval chain as ``chains/factory.py`` builds it from the
    ``AppConfig`` defaults, over the 1M-row store of ``retrieve``: cold,
    warm, the semantic ring at full size, concurrent requests through the
    micro-batcher, the degradation ladder, and the reranker on."""
    import dataclasses

    import numpy as np

    from generativeaiexamples_tpu_torch.cache.metrics import cache_snapshot
    from generativeaiexamples_tpu_torch.chains import factory
    from generativeaiexamples_tpu_torch.core.configuration import get_config, reset_config_cache
    from generativeaiexamples_tpu_torch.resilience.faults import get_fault_injector, reset_faults
    from generativeaiexamples_tpu_torch.resilience.metrics import reset_resilience
    from generativeaiexamples_tpu_torch.retrieval.base import Chunk

    cfg = get_config()
    t_phase = time.perf_counter()
    retriever = factory.get_retriever()
    embedder, cache, k = retriever.embedder, retriever.cache, retriever.top_k
    if retriever.store is not store or retriever.reranker is not None or cache is None:
        raise AssertionError("retriever: the factory's chain is not the default one over the retrieve store")
    fields = dict(config="AppConfig defaults", embedder=f"arctic-embed-l, {embedder.cfg.n_layers} layers, "
                  f"random bf16, seed 0", top_k=k, score_threshold=retriever.score_threshold,
                  fetch_k_multiplier=retriever.fetch_k_multiplier, cache_exact_entries=cache.max_entries,
                  cache_semantic_entries=cfg.cache.semantic_entries, similarity_threshold=cache.similarity_threshold,
                  store_rows=len(store), rank_eps=RANK_EPS)

    # 2,048 documents of 510 byte tokens: rows a query finds above the
    # threshold (the 1M clustered rows score near 0 against BERT vectors).
    docs = _texts(12, CHAIN_DOCS, 510)
    t0 = time.perf_counter()
    store.add([Chunk(text=t, source=f"rag{i // 64}", id=f"rag{i}") for i, t in enumerate(docs)],
              embedder.embed_documents(docs))
    fields["docs_embed_add_s"] = time.perf_counter() - t0

    # 1. Cold: one embed, one search for 128 distinct queries.  The direct
    # calls run first (they also warm cuBLAS at these shapes).
    queries = _texts(13, CHAIN_QUERIES, 60)
    t0 = time.perf_counter()
    direct, qvecs = _direct(retriever, queries, k + 1)
    direct_ms = (time.perf_counter() - t0) * 1e3
    # How far apart random-weight embeddings lie: cosines between the
    # queries, and each query's gap between its first and second score.
    qv = np.asarray(qvecs)
    cos = (qv @ qv.T)[~np.eye(len(qv), dtype=bool)]
    gaps = np.array([h[0].score - h[1].score for h in direct if len(h) > 1])
    fields.update(query_cosine_min_max=[float(cos.min()), float(cos.max())],
                  top1_gap_min_median=[float(gaps.min()), float(np.median(gaps))])
    reset_resilience()
    with _DeviceWork() as work:
        cold, logs, _, traces, cold_ms = _retrieve(retriever, queries)
    _clean_logs(logs, "cold")
    cold_checked = _same_ranks(cold, direct, k, "retriever: cold vs direct")
    # The same arithmetic on the same inputs: the very same hits and scores.
    if [[(h.chunk.id, h.score) for h in r] for r in cold] != [[(h.chunk.id, h.score) for h in r[:k]] for r in direct]:
        raise AssertionError("retriever: cold: results are not the direct calls' hits and scores")
    stages = _stage_ms(traces)
    t0 = time.perf_counter()
    _direct(retriever, queries, k + 1)
    direct2_ms = (time.perf_counter() - t0) * 1e3
    fields.update(cold_ms=cold_ms, cold_stage_ms=stages, cold_host_ms=cold_ms - sum(stages.values()),
                  cold_forwards=work.forwards, cold_scans=work.scans, cold_ranks_checked=cold_checked,
                  cold_identical_to_direct=True,
                  direct_ms=[direct_ms, direct2_ms], retriever_overhead_ms=cold_ms - direct2_ms,
                  cold_hits_per_query=[min(len(h) for h in cold), max(len(h) for h in cold)])
    if not all(cold):
        raise AssertionError("retriever: cold: a query found nothing above the threshold")

    # 2. Warm: the same queries are exact-tier hits with no device work.
    scans0 = cache_snapshot()["semantic_scan_count"]
    with _DeviceWork() as work:
        warm, logs, clogs, traces, warm_ms = _retrieve(retriever, queries)
    _clean_logs(logs, "warm")
    ring_scans = cache_snapshot()["semantic_scan_count"] - scans0
    if [c.tier for c in clogs] != ["exact"] * len(queries) or work.forwards or work.scans or ring_scans:
        raise AssertionError(f"retriever: warm: tiers {sorted(set(c.tier for c in clogs))}, {work.forwards} "
                             f"forwards, {work.scans} scans, {ring_scans} ring scans")
    if [[(h.chunk.id, h.score) for h in r] for r in warm] != [[(h.chunk.id, h.score) for h in r] for r in cold]:
        raise AssertionError("retriever: warm: results differ from the cold pass")
    fields.update(warm_ms=warm_ms, warm_stage_ms=_stage_ms(traces), warm_forwards=0, warm_scans=0)

    # 3. The semantic ring at its configured size, against f64.
    fields.update(_ring_check(torch, np, dev, cfg))

    # 4. Concurrent requests through the process-wide micro-batcher (a
    # cleared cache: the first batch pays embed and search).
    cache.clear()
    reset_resilience()
    fields.update(_concurrent_retrievals(np, factory, _texts(14, CHAIN_CONCURRENT, 60)))

    # 5. The ladder: a store fault with the host fallback, then without it
    # over a warm cache.
    lq = _texts(15, CHAIN_LADDER, 60)
    cache.clear()
    reset_resilience()
    get_fault_injector().configure("store:error=1")
    fb, logs, _, traces, fb_ms = _retrieve(retriever, lq)
    reset_faults()
    if [log.stages() for log in logs] != [["index_fallback"]] * len(lq):
        raise AssertionError(f"retriever: store fault: marks {[log.stages() for log in logs]}")
    want, _ = _direct(retriever, lq, k + 1)
    fb_checked = _same_ranks(fb, want, k, "retriever: index_fallback vs device search")
    # The fallback alone at 1M rows, on 16 queries planted near corpus rows
    # (the BERT vectors' top scores lie closer together than RANK_EPS).
    rng = np.random.default_rng(3)
    rows = store._mirror._vecs[rng.integers(0, RETRIEVE_ROWS, CHAIN_LADDER)]
    planted = rows + 0.3 / math.sqrt(rows.shape[1]) * rng.standard_normal(rows.shape).astype(np.float32)
    planted /= np.linalg.norm(planted, axis=1, keepdims=True)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        fallback = store.search_fallback(planted, 10)
        times.append((time.perf_counter() - t0) * 1e3)
    planted_checked = _same_ranks(fallback, store.search_batch(planted, 11), 10, "retriever: search_fallback vs device search")
    if planted_checked < 16:
        raise AssertionError(f"retriever: search_fallback: only {planted_checked} ranks checked")
    fields.update(fallback_ranks_checked=fb_checked, fallback_call_ms=fb_ms, fallback_stage_ms=_stage_ms(traces),
                  search_fallback_ms=sorted(times)[1], search_fallback_queries=CHAIN_LADDER, search_fallback_k=10,
                  search_fallback_ranks_checked=planted_checked, admitted_after_fallback=len(cache))
    if len(cache):
        raise AssertionError("retriever: a degraded result was admitted to the cache")
    reset_resilience()
    clean, logs, _, _, _ = _retrieve(retriever, lq)  # warm the cache at k
    _clean_logs(logs, "stale warm-up")
    get_fault_injector().configure("store:error=1")
    stale, logs, clogs, _, _ = _retrieve(dataclasses.replace(retriever, store=_NoFallback(store)), lq, 2 * k)
    reset_faults()
    if [log.stages() for log in logs] != [["cache_stale"]] * len(lq) or {c.tier for c in clogs} != {"stale"}:
        raise AssertionError(f"retriever: stale rung: marks {[log.stages() for log in logs][:2]}")
    if [_ids(h) for h in stale] != [_ids(h) for h in clean]:
        raise AssertionError("retriever: stale rung: not the cached results")
    fields.update(stale_served=len(lq))

    # 6. The reranker on (ranking.model_engine "tpu": the 24-layer arctic
    # cross-encoder, random, seeds 1 and 2) over the same store and embedder.
    os.environ["APP_RANKING_MODELENGINE"] = "tpu"
    reset_config_cache()
    factory.reset_factories(keep=("store", "embedder"))
    try:
        rr = factory.get_retriever()
        fetch_k = k * rr.fetch_k_multiplier
        rq = _texts(16, CHAIN_RERANK, 60)
        got, logs, _, traces, rr_ms = _retrieve(rr, rq)
        _clean_logs(logs, "rerank")
        cands, _ = _direct(rr, rq, fetch_k)
        pairs = [(q, h.chunk.text) for q, hs in zip(rq, cands) for h in hs]
        flat, at, want = rr.reranker.score_pairs(pairs), 0, []
        for hs in cands:
            scored = sorted(zip([flat[at + i] for i in range(len(hs))], range(len(hs))), key=lambda t: -t[0])
            want.append([hs[i].chunk.id for _, i in scored[:k]])
            at += len(hs)
        if [_ids(h) for h in got] != want:
            raise AssertionError("retriever: rerank: order differs from a direct score_pairs")
        fields.update(rerank_pairs=len(pairs), rerank_fetch_k=fetch_k, rerank_call_ms=rr_ms,
                      rerank_stage_ms=_stage_ms(traces))
        # The reranker rung: a fault serves vector-search order.
        rr.cache.clear()
        get_fault_injector().configure("reranker:error=1")
        vec, logs, _, _, _ = _retrieve(rr, lq)
        reset_faults()
        if [log.stages() for log in logs] != [["rerank"]] * len(lq):
            raise AssertionError(f"retriever: reranker fault: marks {[log.stages() for log in logs][:2]}")
        order, _ = _direct(rr, lq, fetch_k)
        if [_ids(h) for h in vec] != [_ids(h[:k]) for h in order]:
            raise AssertionError("retriever: reranker fault: not vector-search order")
        fields.update(rerank_fault_vector_order=True)
    finally:
        del os.environ["APP_RANKING_MODELENGINE"]
        reset_config_cache()
    fields["phase_s"] = time.perf_counter() - t_phase
    emit("retriever", **fields)


# ---------------------------------------------------------------------------
# the compressed and IVF stores over the retrieve corpus
# ---------------------------------------------------------------------------

# Each store line, and the overrides a collection would pass to build it.
STORE_KINDS = (
    ("store_int8", {"backend": "tpu", "quantization": "int8"}),
    ("store_pq", {"backend": "tpu", "quantization": "pq"}),
    ("store_ivf", {"backend": "tpu-ivf"}),
    ("store_ivf_int8", {"backend": "tpu-ivf", "quantization": "int8"}),
    ("store_ivf_pq", {"backend": "tpu-ivf", "quantization": "pq"}),
)
# Queries whose every returned score is held against f64 (8 planted, 8 fresh).
STORE_CHECKED = tuple(range(8)) + tuple(range(64, 72))
STORE_APPEND, STORE_CROSS_ROWS, STORE_SNAPSHOT_ROWS = 5000, 131072, 16384
# The reference's int8 recall gate (tests/test_retrieval.py::TestQuantized).
INT8_RECALL = 0.95
# PQ's ADC scores on the card against the same codes and table on the CPU.
ADC_TOL = 1e-4


class _PeakRSS:
    """The process's largest resident set while entered, sampled every 50 ms."""

    def __enter__(self):
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        page = os.sysconf("SC_PAGE_SIZE")
        while True:
            with open("/proc/self/statm", encoding="ascii") as fh:
                self.peak = max(self.peak, int(fh.read().split()[1]) * page)
            if self._stop.wait(0.05):
                return

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(5)


class _BuildSplit:
    """Seconds of a store's build spent training (IVF k-means, PQ
    codebooks), encoding (int8 quantization, PQ codes) and uploading rows,
    read by wrapping the store module's functions while entered, with the
    device synchronized around each call."""

    # (part, class of the store module or None for a module function, name)
    TARGETS = (("train", None, "_kmeans"), ("train", None, "_train_pq"), ("encode", None, "_pq_encode"),
               ("encode", None, "_int8_rows_t"), ("upload", "GPUVectorStore", "_upload"),
               ("upload", "GPUIVFVectorStore", "_rows_f32"))

    def __init__(self, torch):
        from generativeaiexamples_tpu_torch.retrieval import gpu

        self._torch, self._gpu = torch, gpu
        self.seconds = {"train": 0.0, "encode": 0.0, "upload": 0.0}

    def _timed(self, part, fn):
        def timed(*a, **k):
            self._torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self._torch.cuda.synchronize()
                self.seconds[part] += time.perf_counter() - t0

        return timed

    def __enter__(self):
        self._saved = []
        for part, cls, name in self.TARGETS:
            owner = self._gpu if cls is None else getattr(self._gpu, cls)
            fn = vars(owner)[name]
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._timed(part, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _bf16_f64(torch, np, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).double().numpy()


def _rescoring_error(torch, np, corpus, queries, results) -> float:
    """Largest |score - f64 dot| over every hit of the STORE_CHECKED
    queries: the dot of the bf16 values of the query and of the hit's row."""
    err = 0.0
    for qi in STORE_CHECKED:
        hits = results[qi]
        want = _bf16_f64(torch, np, corpus[[int(h.chunk.id) for h in hits]]) @ _bf16_f64(torch, np, queries[qi])
        err = max(err, float(np.abs(np.array([h.score for h in hits]) - want).max()))
    return err


def _time_store(torch, store, queries, k: int) -> dict:
    """A 128-query batch as ``search_batch`` splits it: the device work of
    every chunk timed by CUDA events (median of 12), and ``search_batch``
    whole by the host clock (median of 10).  The exact store: the scan and
    ``torch.topk`` of main and tail.  Flat compressed stores: stage one,
    ``torch.topk`` of the candidates, the gathered rows rescored, the
    tail.  IVF: the probe (a host sync: the probed lists decide which lists
    each chunk reads, so these events include the host's time between
    launches), each chunk's list scores, top-k, rescoring and tail."""
    import numpy as np

    from generativeaiexamples_tpu_torch.retrieval.gpu import (
        GPUIVFVectorStore, GPUVectorStore, _IVFSnap, _rescore, scores_f32,
    )

    snap = store._prepared()
    Q = torch.from_numpy(queries).to(store.device)
    q, d = Q.shape
    inf = float("-inf")
    # The least bytes the batch moves: each input read once (the corpus
    # part once for all 128 queries; IVF: each list some query probes) and
    # the rescored rows; the products' operations at the bf16 peak.
    if isinstance(snap, _IVFSnap):
        nlist, cap = int(snap.buckets.shape[0]), int(snap.buckets.shape[1])
        isz = snap.buckets.element_size()
        quant = store._two_stage_engages(snap, k)
        chunk = store.query_chunk(snap, k)
        k2 = min(k * store.rescore_multiplier, store.nprobe * cap)
        lists = len(np.unique(GPUIVFVectorStore.probe(snap, Q, store.nprobe)))
        row_bytes = (d + 4 if store.quantization == "int8" else store.pq_m) if quant else d * isz
        nbytes = nlist * d * 4 + lists * cap * (row_bytes + 1) + (q * k2 * d * isz if quant else 0)
        scored = store.nprobe * cap
        tail = snap.tail

        def work():
            probe = GPUIVFVectorStore.probe(snap, Q, store.nprobe)
            probe_t = torch.from_numpy(probe).to(Q.device)
            for lo in range(0, len(Q), chunk):
                Qb = Q[lo : lo + chunk]
                Qc = Qb.to(snap.buckets.dtype)
                S = GPUIVFVectorStore.list_scores(snap, Qb, probe[lo : lo + chunk], quant).view(len(Qb), -1)
                if quant:
                    cpos = torch.topk(S, k2 + 1, dim=1)[1][:, :k2]
                    lists = torch.gather(probe_t[lo : lo + chunk], 1, cpos // cap)
                    torch.topk(_rescore(snap.buckets[lists, cpos % cap], Qc), k + 1, dim=1)
                else:
                    torch.topk(S, k + 1, dim=1)
                torch.topk(scores_f32(Qc, snap.tail).masked_fill_(~snap.tvalid[None, :], inf), k + 1, dim=1)

        shape = dict(query_chunk=chunk, dispatches_per_128=-(-len(Q) // chunk), two_stage=quant)
    else:
        cap, isz = int(snap.buf.shape[0]), snap.buf.element_size()
        quant = store._quant_ready(k, snap)
        k2 = min(k * store.rescore_multiplier, cap) if quant else k
        mqb = store.max_query_batch
        if not quant:
            row_bytes = d * isz
        elif store.quantization == "int8":
            row_bytes = d + 4
        else:
            row_bytes = store.pq_m
        nbytes = cap * (row_bytes + 1) + (q * k2 * d * isz if quant else 0)
        if quant and snap.books is not None:
            nbytes += snap.books.numel() * 4
        scored = cap
        tail = snap.tail

        def work():
            for lo in range(0, len(Q), mqb):
                Qb = Q[lo : lo + mqb]
                if not quant:
                    [torch.topk(p, k + 1, dim=1) for p in GPUVectorStore.scan(snap, Qb)]
                    continue
                Qc = Qb.to(snap.buf.dtype)
                cid = torch.topk(GPUVectorStore.stage_one(snap, Qb), k2 + 1, dim=1)[1][:, :k2]
                torch.topk(_rescore(snap.buf[cid], Qc), k + 1, dim=1)
                torch.topk(scores_f32(Qc, snap.tail).masked_fill_(~snap.tvalid[None, :], inf), k + 1, dim=1)

        shape = dict(query_chunk=mqb, dispatches_per_128=-(-len(Q) // mqb), two_stage=quant)
    nbytes += tail.shape[0] * (d * isz + 1) + q * d * 4
    if quant and store.quantization == "pq":  # a table sum per subspace and row, in f32
        b_ms, b_by = bound(nbytes, q * scored * store.pq_m, F32_FLOPS)
    else:  # bf16 (or int8 cast to bf16) products
        b_ms, b_by = bound(nbytes, 2.0 * q * (scored + tail.shape[0]) * d, BF16_FLOPS)
    work()
    device_ms = _event_ms(torch, work)
    return dict(device_ms=device_ms, search_batch_ms=_host_ms(lambda: store.search_batch(queries, k)),
                candidates=k2, batch_bytes=nbytes, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / device_ms,
                **shape)


def _adc_error(torch, store, Q) -> float:
    """PQ stage-one scores of 4 queries on the card against the same codes,
    codebooks and masks scored on the CPU (largest |difference| over
    finite scores)."""
    from generativeaiexamples_tpu_torch.retrieval.gpu import GPUIVFVectorStore, GPUVectorStore, _IVFSnap

    snap = store._prepared()
    Q4 = Q[:4]
    if isinstance(snap, _IVFSnap):
        probe = GPUIVFVectorStore.probe(snap, Q4, store.nprobe)
        card = GPUIVFVectorStore.list_scores(snap, Q4, probe, True)
        cpu = snap._replace(bvalid=snap.bvalid.cpu(), qbuckets=snap.qbuckets.cpu(), books=snap.books.cpu())
        plain = GPUIVFVectorStore.list_scores(cpu, Q4.cpu(), probe, True)
    else:
        card = GPUVectorStore.stage_one(snap, Q4)
        cpu = snap._replace(valid=snap.valid.cpu(), qbuf=snap.qbuf.cpu(), books=snap.books.cpu())
        plain = GPUVectorStore.stage_one(cpu, Q4.cpu())
    finite = torch.isfinite(plain)
    if not torch.equal(finite, torch.isfinite(card.cpu())):
        raise AssertionError("stores: PQ stage one masks other rows on the card than on the CPU")
    return float((card.cpu()[finite] - plain[finite]).abs().max())


def _nearest_lists(torch, np, store, corpus) -> np.ndarray:
    """Each corpus row's nearest centroid by the f32 inner product, on the
    card in row blocks."""
    from generativeaiexamples_tpu_torch.retrieval.gpu import full_f32

    out = []
    with full_f32(store.device):
        for lo in range(0, len(corpus), 65536):
            rows = torch.from_numpy(np.ascontiguousarray(corpus[lo : lo + 65536])).to(store.device)
            out.append((rows @ store._centroids.t()).argmax(dim=1).cpu().numpy())
    return np.concatenate(out)


def _store_line(torch, np, dev, store, chunks, corpus, queries, planted, truth_ids) -> dict:
    """Build one store from the corpus, search the 128 queries, hold every
    gate of its kind, and return its line's fields."""
    from generativeaiexamples_tpu_torch.retrieval.gpu import GPUIVFVectorStore, _int8_rows

    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    store.add(chunks, corpus)
    add_s = time.perf_counter() - t0
    with _BuildSplit(torch) as split:
        t0 = time.perf_counter()
        store.search_batch(queries[:1], 1)  # the first sync: the device build
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
    ivf = isinstance(store, GPUIVFVectorStore)
    built = store._buckets is not None if ivf else store._device_buf is not None
    compressed = (store._q_buckets if ivf else store._q_buf) is not None
    if not built or compressed != (store.quantization != "none"):
        raise AssertionError(f"stores: {type(store).__name__}({store.quantization}) built no index or compressed copy")
    stats = store.capacity_stats()
    results = store.search_batch(queries, 10)
    recall = float(np.mean([len({h.chunk.id for h in r} & {str(int(i)) for i in t[:10]}) / 10
                            for r, t in zip(results, truth_ids)]))
    first = [bool(r) and r[0].chunk.id == str(int(p)) for r, p in zip(results[:64], planted)]
    rescoring_err = _rescoring_error(torch, np, corpus, queries, results)
    if rescoring_err > 1e-4:
        raise AssertionError(f"stores: {type(store).__name__}({store.quantization}): a returned score is "
                             f"{rescoring_err} from the f64 dot of its row")
    scanned = store.scanned_bytes_per_query(10)
    timing = _time_store(torch, store, queries, 10)
    fields = dict(
        rows=len(store), quantization=store.quantization, pq_m=store.pq_m,
        rescore_multiplier=store.rescore_multiplier, max_query_batch=store.max_query_batch, add_s=add_s,
        first_sync_s=sync_s, **{f"{k}_s": v for k, v in split.seconds.items()},
        other_s=sync_s - sum(split.seconds.values()),
        device_gb=(torch.cuda.memory_allocated(dev) - mem0) / 1e9, capacity_stats=stats,
        scanned_bytes_per_query_top10=scanned,
        # The reference's per-query count times 128 queries: each query reads
        # its whole scan alone (``bound_ms`` counts what the batch shares once).
        per_query_bound_ms=scanned * len(queries) / HBM_BYTES_PER_S * 1e3,
        **timing, recall_at_10=recall, planted_first=sum(first),
        rescoring_max_err=rescoring_err,
    )
    Q = torch.from_numpy(queries).to(dev)
    if store.quantization == "pq":
        err = _adc_error(torch, store, Q)
        if err > ADC_TOL:
            raise AssertionError(f"stores: PQ ADC on the card is {err} from the CPU's")
        fields["adc_card_vs_cpu_max_err"] = err
    if ivf:
        snap = store._prepared()
        cap = int(store._buckets.shape[1])
        nearest = _nearest_lists(torch, np, store, corpus)
        probe = GPUIVFVectorStore.probe(snap, Q[:64], store.nprobe)
        probed = [store._pos_list[int(p)] in probe[i] for i, p in enumerate(planted)]
        fields.update(nlist=store.nlist, nprobe=store.nprobe, bucket_cap=cap, pad_factor=store.nlist * cap / len(store),
                      spilled_rows=int((store._pos_list[: len(nearest)] != nearest).sum()),
                      planted_in_probed_lists=sum(probed), planted_outside_probed_lists=64 - sum(probed))
        if store.quantization != "pq" and any(p and not f for p, f in zip(probed, first)):
            raise AssertionError(f"stores: IVF({store.quantization}): a planted row in a probed list is not first")
    elif store.quantization == "int8":
        m = min(65536, len(corpus))
        codes, scale = _int8_rows(corpus[:m])
        if not (np.array_equal(store._q_buf[:m].cpu().numpy(), codes)
                and np.array_equal(store._q_scale[:m].cpu().numpy(), scale)):
            raise AssertionError("stores: the card's int8 codes are not _int8_rows' bit for bit")
        fields["int8_codes_equal_rows"] = m
        if recall < INT8_RECALL or sum(first) != 64:
            raise AssertionError(f"stores: int8 recall@10 {recall} (gate {INT8_RECALL}), {sum(first)} of 64 planted first")
    return fields


def _all_probed_is_exact(np, store, chunks, queries, truth_s, truth_ids) -> int:
    """nprobe = nlist scores every list: the exact store's ids wherever the
    gap below a rank exceeds RANK_EPS.  Returns the ranks checked."""
    from generativeaiexamples_tpu_torch.retrieval.base import ScoredChunk

    sel = list(STORE_CHECKED)
    nprobe, store.nprobe = store.nprobe, store.nlist
    try:
        got = store.search_batch(queries[sel], 10)
    finally:
        store.nprobe = nprobe
    want = [[ScoredChunk(chunks[int(i)], float(s)) for s, i in zip(truth_s[q], truth_ids[q])] for q in sel]
    return _same_ranks(got, want, 10, "stores: IVF with nprobe = nlist against the exact store")


def _maintenance(torch, np, store, rng) -> dict:
    """IVF upkeep at full size: 5,000 appends searched from the tail, a
    background fold under searches, the swap, then a retrain forced by
    growth (the threshold lowered to the rows at the last train)."""
    from generativeaiexamples_tpu_torch.retrieval.base import Chunk

    events = []
    store.add_mutation_listener(lambda event, info: events.append((event, info)))
    base0, v0, c0 = store._ivf_base, store.version(), store._centroids.clone()
    src = store._mirror._vecs

    def append(tag, count):
        rows = _clustered_rows(np, rng, src, rng.integers(0, base0, count), 0.8)
        store.add([Chunk(text=f"{tag} {i}", source=tag, id=f"{tag}{i}") for i in range(count)], rows)
        return rows

    new = append("appended", STORE_APPEND)
    probes = _clustered_rows(np, rng, new, np.arange(STORE_APPEND), 0.1)
    t0 = time.perf_counter()
    found = store.search_batch(probes, 1)
    append_search_s = time.perf_counter() - t0
    if [h[0].chunk.id if h else None for h in found] != [f"appended{i}" for i in range(STORE_APPEND)]:
        raise AssertionError("store_maintenance: an appended row is not found by its planted query before a fold")
    if store._ivf_base != base0 or store._maintenance_running() or store.capacity_stats()["tail_rows"] != STORE_APPEND:
        raise AssertionError("store_maintenance: 5,000 appends started a fold")

    def under_searches(what):
        """Searches of the first 64 appended rows while a background build
        runs: each must answer with its row first."""
        t0, lat = time.perf_counter(), []
        while True:
            t1 = time.perf_counter()
            hits = store.search_batch(probes[:64], 10)
            lat.append((time.perf_counter() - t1) * 1e3)
            if [h[0].chunk.id if h else None for h in hits] != [f"appended{i}" for i in range(64)]:
                raise AssertionError(f"store_maintenance: a search during the {what} lost an appended row")
            if not store._maintenance_running():
                break
        store.wait_for_maintenance(timeout=600)
        if store._maintenance_running():
            raise AssertionError(f"store_maintenance: the {what} did not finish")
        return dict(seconds=time.perf_counter() - t0, searches=len(lat), search_ms_median=sorted(lat)[len(lat) // 2],
                    search_ms_max=max(lat))

    # The fold: the tail reaches min(max(1024, base / 8), 8192) rows.
    fold_at = min(max(1024, base0 // 8), 8192)
    append("fold", fold_at - STORE_APPEND)
    fold = under_searches("fold")
    swaps = [info for event, info in events if event == "index_swap"]
    if not (torch.equal(store._centroids, c0) and store.version() > v0 and len(swaps) == 1
            and not swaps[0]["trained"] and store.capacity_stats()["tail_rows"] == 0
            and store._ivf_base == base0 + fold_at):
        raise AssertionError(f"store_maintenance: after the fold: swaps {swaps}, tail {store.capacity_stats()}, "
                             f"base {store._ivf_base}")
    # The retrain: 16 more rows sync with the growth threshold at 1.0.
    store.retrain_growth = 1.0
    append("grow", 16)
    retrain = under_searches("retrain")
    swaps = [info for event, info in events if event == "index_swap"]
    if len(swaps) != 2 or not swaps[1]["trained"] or store._last_train_live != swaps[1]["rows"]:
        raise AssertionError(f"store_maintenance: after the retrain: swaps {swaps}")
    return dict(appended=STORE_APPEND, append_found_first=STORE_APPEND, append_search_s=append_search_s,
                fold_at_tail_rows=fold_at, fold=fold, fold_centroids_kept=True, swaps=swaps,
                retrain=retrain, retrain_centroid_shift=float((store._centroids - c0).abs().max()),
                rows_after=len(store), tail_rows_after=store.capacity_stats()["tail_rows"])


def stores_phase(torch, dev, exact, queries, planted) -> None:
    """The compressed and IVF stores over the ``retrieve`` corpus (its 1M
    rows, read from the exact store's mirror) and its 128 queries, each
    built through the port's ``retrieval.factory.get_vector_store`` with a
    collection's overrides and freed before the next; the truth is the
    exact store's top-10 over the same rows."""
    import shutil
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch.core.configuration import reset_config_cache
    from generativeaiexamples_tpu_torch.retrieval import factory as rfactory
    from generativeaiexamples_tpu_torch.retrieval.gpu import GPUIVFVectorStore, GPUVectorStore, _top_rows, scores_f32

    t_phase = time.perf_counter()
    n = RETRIEVE_ROWS
    if exact._base != n:
        raise AssertionError(f"stores: the exact store's main buffer holds {exact._base} rows, not the corpus")
    corpus, chunks = exact._mirror._vecs[:n], exact._mirror._chunks[:n]
    Q = torch.from_numpy(queries).to(dev)
    # The exact store's scan of the corpus rows (its main buffer, unmasked:
    # the new stores hold every row).
    truth_s, truth_ids = _top_rows(scores_f32(Q.to(exact._dtype), exact._device_buf[:n]), 11)
    exact_timing = dict(_time_scan(torch, exact, queries, 10), chunked=_time_store(torch, exact, queries, 10))
    rng = np.random.default_rng(5)
    doc7 = _clustered_rows(np, rng, corpus, np.arange(7000, 7064), 0.1)
    torch.cuda.reset_peak_memory_stats(dev)
    with _PeakRSS() as rss:
        for line, overrides in STORE_KINDS:
            store = rfactory.get_vector_store(device=dev, overrides=overrides)
            fields = _store_line(torch, np, dev, store, chunks, corpus, queries, planted, truth_ids)
            fields.update(exact_device_ms=exact_timing["chunked"]["device_ms"],
                          exact_top10_scan_ms=exact_timing["scan_ms"],
                          exact_search_batch_ms=exact_timing["search_batch_ms"])
            if line == "store_ivf":
                fields["all_probed_ranks_checked"] = _all_probed_is_exact(np, store, chunks, queries, truth_s, truth_ids)
                ivf_full = fields
            removed = store.delete_source("doc7")
            gone = store.search_batch(doc7, 10)
            if removed != 1000 or any(h.chunk.source == "doc7" for hits in gone for h in hits):
                raise AssertionError(f"stores: {line}: a deleted source came back")
            fields["deleted_rows"] = removed
            emit(line, **fields)
            if line == "store_ivf":
                emit("store_maintenance", rows=len(store), **_maintenance(torch, np, store, rng))
            del store
            gc.collect()
            torch.cuda.empty_cache()

        # Exact against IVF at the first 131,072 rows and at all rows.
        cross = {}
        for backend in ("tpu", "tpu-ivf"):
            store = rfactory.get_vector_store(device=dev, overrides={"backend": backend})
            store.add(chunks[:STORE_CROSS_ROWS], corpus[:STORE_CROSS_ROWS])
            store.search_batch(queries[:1], 1)
            if backend == "tpu":
                t = _time_store(torch, store, queries, 10)
                cross["exact"] = dict(device_ms=t["device_ms"], search_batch_ms=t["search_batch_ms"])
                small_truth = store.search_batch(queries, 10)
            else:
                t = _time_store(torch, store, queries, 10)
                got = store.search_batch(queries, 10)
                cross["ivf"] = dict(device_ms=t["device_ms"], search_batch_ms=t["search_batch_ms"],
                                    bucket_cap=int(store._buckets.shape[1]), query_chunk=t["query_chunk"],
                                    recall_at_10=float(np.mean([len({h.chunk.id for h in a} & {h.chunk.id for h in b})
                                                                / 10 for a, b in zip(got, small_truth)])))
            del store
            gc.collect()
            torch.cuda.empty_cache()
        emit("store_crossover", rows=[STORE_CROSS_ROWS, n],
             exact_device_ms=[cross["exact"]["device_ms"], exact_timing["chunked"]["device_ms"]],
             exact_search_batch_ms=[cross["exact"]["search_batch_ms"], exact_timing["search_batch_ms"]],
             ivf_device_ms=[cross["ivf"]["device_ms"], ivf_full["device_ms"]],
             ivf_search_batch_ms=[cross["ivf"]["search_batch_ms"], ivf_full["search_batch_ms"]],
             ivf_recall_at_10=[cross["ivf"]["recall_at_10"], ivf_full["recall_at_10"]],
             ivf_bucket_cap=[cross["ivf"]["bucket_cap"], ivf_full["bucket_cap"]],
             ivf_query_chunk=[cross["ivf"]["query_chunk"], ivf_full["query_chunk"]],
             cuda_crossover_rows=rfactory.crossover_rows(RETRIEVE_DIM, "cuda"))

        # IVF with int8 at 16,384 rows: saved, loaded on the card and on the CPU.
        store = rfactory.get_vector_store(device=dev, overrides={"backend": "tpu-ivf", "quantization": "int8"})
        store.add(chunks[:STORE_SNAPSHOT_ROWS], corpus[:STORE_SNAPSHOT_ROWS])
        before = store.search_batch(queries, 10)
        root = tempfile.mkdtemp(prefix="stores_")
        try:
            t0 = time.perf_counter()
            store.save(root)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            on_card = GPUVectorStore.load(root, device=dev, max_query_batch=store.max_query_batch)
            load_s = time.perf_counter() - t0
            on_cpu = GPUVectorStore.load(root, device="cpu", max_query_batch=store.max_query_batch)
            files = sorted(os.listdir(root))
        finally:
            shutil.rmtree(root, ignore_errors=True)
        for loaded in (on_card, on_cpu):
            if not isinstance(loaded, GPUIVFVectorStore) or loaded._q_buckets is None or loaded._dirty:
                raise AssertionError(f"stores: the snapshot loaded as {type(loaded).__name__} without its index")
        card = on_card.search_batch(queries, 10)
        if [[(h.chunk.id, h.score) for h in r] for r in card] != [[(h.chunk.id, h.score) for h in r] for r in before]:
            raise AssertionError("store_snapshot: the loaded store answers otherwise than the saved one")
        checked = _same_ranks(card, on_cpu.search_batch(queries, 11), 10, "store_snapshot: card against CPU")
        emit("store_snapshot", rows=STORE_SNAPSHOT_ROWS, quantization="int8", files=files, save_s=save_s,
             load_s=load_s, bucket_cap=int(on_card._buckets.shape[1]), card_vs_cpu_ranks_checked=checked,
             loaded_equals_saved=True)
        del store, on_card, on_cpu
        gc.collect()
        torch.cuda.empty_cache()

        # ``auto`` from APP_*: the IVF store on the card with the cuda crossover.
        os.environ["APP_VECTORSTORE_NAME"] = "auto"
        reset_config_cache()
        try:
            auto = rfactory.get_vector_store(device=dev)
        finally:
            del os.environ["APP_VECTORSTORE_NAME"]
            reset_config_cache()
        if not (isinstance(auto, GPUIVFVectorStore) and auto.device == dev
                and auto.min_train_size == rfactory.crossover_rows(RETRIEVE_DIM, "cuda")):
            raise AssertionError(f"stores: auto built {type(auto).__name__} on {auto.device}")
    emit("stores", rows=n, queries=len(queries), auto=f"GPUIVFVectorStore, min_train_size {auto.min_train_size}",
         peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9, peak_host_rss_gb=rss.peak / 1e9,
         phase_s=time.perf_counter() - t_phase)

# ---------------------------------------------------------------------------
# scale-out retrieval: the sharded fabric, its cold tier, the native store
# ---------------------------------------------------------------------------

# One shard goes cold in the drill: each demotion is ~16.5 s of the
# reference's numpy k-means and encoding (PERF.md §4).
FABRIC_SHARDS, FABRIC_COLD = 4, (2,)
FABRIC_THREADS, FABRIC_PER_THREAD = 16, 8
# Every score a cold drill returns, against the f64 product of its row.
COLD_REL_TOL = 1e-5
# A demotion must free at least this share of the demoted children's bytes.
FREED_SHARE = 0.9
# The C++ store is single-threaded: its line keeps well under 30 s by its
# rows (65,536 took 54 s, 32,768 took 22 s on the H100 machine's CPU).
NATIVE_ROWS = 16384


def _rss_gb() -> float:
    with open("/proc/self/statm", encoding="ascii") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


def _against_exact(torch, np, S, results, truth_s, truth_ids, where: str) -> dict:
    """The fabric's top-k against the single exact store's scan ``S`` (b, n
    f32 on the card) of the same rows: how many returned scores differ from
    the single store's score of the same row, and by how much; then the
    returned ids at every rank whose gap to the next truth score exceeds
    twice that difference (every rank with distinct scores when no bit
    moved), as sets of the top ranks."""
    ids = [[int(h.chunk.id) for h in r] for r in results]
    got = np.array([[h.score for h in r] for r in results], dtype=np.float32)
    want = torch.gather(S[: len(results)], 1, torch.tensor(ids, device=S.device)).cpu().numpy()
    diff = np.abs(got - want)
    max_diff = float(diff.max())
    if max_diff > 1e-4:
        raise AssertionError(f"{where}: a returned score is {max_diff} from the single store's score of its row")
    eps = 2.0 * max_diff
    checked = equal = 0
    for q, r in enumerate(ids):
        ts = list(truth_s[q][: len(r) + 1])
        equal += r == [int(i) for i in truth_ids[q][: len(r)]]
        for j in range(len(r)):
            if ts[j] - ts[j + 1] > eps:
                checked += 1
                if set(r[: j + 1]) != {int(i) for i in truth_ids[q][: j + 1]}:
                    raise AssertionError(f"{where}: query {q} top-{j + 1} {r} != {list(truth_ids[q][:len(r)])}")
    return dict(scores_differing=int((diff > 0).sum()), scores_total=int(diff.size), max_score_diff=max_diff,
                ranks_checked=checked, queries_with_the_same_ids=equal)


def fabric_phase(torch, dev, exact, queries, planted) -> None:
    """The sharded fabric over the ``retrieve`` corpus (its 1M rows, read
    from the exact store's mirror), built by the port's factory as a
    collection's overrides ask (``fabric`` over 4 ``tpu`` children), held
    against the exact store's scan of the same rows; then the cold drill
    (a shard demoted to host PQ), promotion, and the fabric freed."""
    import numpy as np

    from generativeaiexamples_tpu_torch.retrieval import factory as rfactory
    from generativeaiexamples_tpu_torch.retrieval.fabric import ShardedVectorStore
    from generativeaiexamples_tpu_torch.retrieval.fabric.metrics import fabric_metrics_lines
    from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore, _top_rows, scores_f32

    t_phase = time.perf_counter()
    n = RETRIEVE_ROWS
    corpus, chunks = exact._mirror._vecs[:n], exact._mirror._chunks[:n]
    Q = torch.from_numpy(queries).to(dev)
    S = scores_f32(Q.to(exact._dtype), exact._device_buf[:n])  # the single store's scan of the corpus rows
    truth_s, truth_ids = _top_rows(S, 11)
    exact_t = _time_store(torch, exact, queries, 10)
    rng = np.random.default_rng(5)
    doc7 = _clustered_rows(np, rng, corpus, np.arange(7000, 7064), 0.1)
    with _PeakRSS() as rss:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(dev)
        fab = rfactory.get_vector_store(device=dev, overrides={"backend": "fabric", "child_backend": "tpu",
                                                               "num_shards": FABRIC_SHARDS})
        try:
            kids = [s.store for s in fab._shards]
            if not isinstance(fab, ShardedVectorStore) or fab.device != dev or not all(
                    isinstance(k, GPUVectorStore) and k.device == dev and k._dtype == torch.bfloat16 for k in kids):
                raise AssertionError(f"fabric: the factory built {fab!r} with {[type(k).__name__ for k in kids]}")
            t0 = time.perf_counter()
            fab.add(chunks, corpus)
            add_s = time.perf_counter() - t0
            rows_per_shard = [len(k) for k in kids]
            t0 = time.perf_counter()
            fab.search_batch(queries[:1], 1)  # the first sync: each child's device build
            torch.cuda.synchronize()
            sync_s = time.perf_counter() - t0
            device_gb = (torch.cuda.memory_allocated(dev) - mem0) / 1e9
            vs_exact = _against_exact(torch, np, S, fab.search_batch(queries, 10), truth_s, truth_ids, "fabric")
            # Timing: each child's device work for the batch (CUDA events, as
            # the stores phase times a store) and the fabric's wall.
            k_shard = fab.shard_k(10)
            shard_t = [_time_store(torch, k, queries, k_shard) for k in kids]
            merge0, calls0 = fab.swap_stats()["merge_s_total"], fab.stats_snapshot()["searches_total"]
            wall_ms = _host_ms(lambda: fab.search_batch(queries, 10))
            merge_ms = (fab.swap_stats()["merge_s_total"] - merge0) * 1e3 / (
                fab.stats_snapshot()["searches_total"] - calls0)
            # 16 threads of 8 queries at once, each against its queries alone.
            parts = [queries[i * FABRIC_PER_THREAD : (i + 1) * FABRIC_PER_THREAD] for i in range(FABRIC_THREADS)]
            alone = [fab.search_batch(p, 11) for p in parts]  # top 11: _same_ranks reads the gap after rank 10
            before = fab.stats_snapshot()
            together = [None] * FABRIC_THREADS
            barrier = threading.Barrier(FABRIC_THREADS)

            def call(i):
                barrier.wait()
                together[i] = fab.search_batch(parts[i], 10)

            threads = [threading.Thread(target=call, args=(i,)) for i in range(FABRIC_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            after = fab.stats_snapshot()
            fanout = {k: after[k] - before[k] for k in ("requests_total", "batches_total", "batch_size_sum")}
            concurrent_ranks = sum(_same_ranks(g, a, 10, f"fabric: thread {i} against alone")
                                   for i, (g, a) in enumerate(zip(together, alone)))
            bits_equal = sum([[(h.chunk.id, h.score) for h in r] for r in g] ==
                             [[(h.chunk.id, h.score) for h in r[:10]] for r in a] for g, a in zip(together, alone))
            metric = {line.split()[0]: float(line.split()[1]) for line in fabric_metrics_lines(fab)
                      if not line.startswith("#")}
            if not (0 < fanout["batches_total"] < fanout["requests_total"]) or \
                    metric["rag_shard_fanout_batches_total"] != after["batches_total"]:
                raise AssertionError(f"fabric: the fan-out did not coalesce: {fanout}")
            removed = fab.delete_source("doc7")
            gone = fab.search_batch(doc7, 10)
            if removed != 1000 or any(h.chunk.source == "doc7" for hits in gone for h in hits):
                raise AssertionError(f"fabric: delete_source removed {removed}, or a deleted row came back")
            emit("fabric", rows=n, shards=FABRIC_SHARDS, child="GPUVectorStore (bf16)",
                 rows_per_shard=rows_per_shard, shard_k=k_shard, add_s=add_s, first_sync_s=sync_s,
                 device_gb=device_gb, capacity_stats=fab.capacity_stats(), against_exact=vs_exact,
                 device_ms=sum(t["device_ms"] for t in shard_t), shard_device_ms=[t["device_ms"] for t in shard_t],
                 bound_ms=sum(t["bound_ms"] for t in shard_t), search_batch_ms=wall_ms, merge_host_ms=merge_ms,
                 exact_device_ms=exact_t["device_ms"], exact_search_batch_ms=exact_t["search_batch_ms"],
                 concurrent=dict(threads=FABRIC_THREADS, queries_each=FABRIC_PER_THREAD, **fanout,
                                 bits_equal_threads=bits_equal, ranks_checked=concurrent_ranks),
                 deleted_rows=removed)

            # The cold drill: a shard to host PQ, searched, promoted back.
            S[:, 7000:8000] = float("-inf")  # doc7 is gone
            truth_s, truth_ids = _top_rows(S, 11)
            doomed = sum(kids[i].capacity_stats()["bytes"] for i in FABRIC_COLD)
            del kids
            gc.collect()
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated(dev)
            demote_s = []
            for i in FABRIC_COLD:
                t0 = time.perf_counter()
                if not fab.demote_shard(i):
                    raise AssertionError(f"fabric_cold: shard {i} did not demote")
                demote_s.append(time.perf_counter() - t0)
            gc.collect()
            freed = m0 - torch.cuda.memory_allocated(dev)
            if fab.cold_shards() != list(FABRIC_COLD) or freed < FREED_SHARE * doomed:
                raise AssertionError(f"fabric_cold: demotion freed {freed} of {doomed} device bytes")
            pf0 = fab.stats_snapshot()
            t0 = time.perf_counter()
            cold = fab.search_batch(queries, 10)
            cold_search_s = time.perf_counter() - t0
            pf1 = fab.stats_snapshot()
            # Every score of the checked queries against the f64 product of
            # its row: the f32 row on a cold shard, the bf16 row on a hot one.
            worst = 0.0
            for qi in STORE_CHECKED:
                for h in cold[qi]:
                    r = int(h.chunk.id)
                    if fab.route(h.chunk.id) in FABRIC_COLD:
                        ref = float(corpus[r].astype(np.float64) @ queries[qi].astype(np.float64))
                    else:
                        ref = float(_bf16_f64(torch, np, corpus[r]) @ _bf16_f64(torch, np, queries[qi]))
                    worst = max(worst, abs(h.score - ref) / abs(ref))
            if worst > COLD_REL_TOL:
                raise AssertionError(f"fabric_cold: a score is {worst} (relative) from the f64 product of its row")
            hot_planted = [(qi, str(int(p))) for qi, p in enumerate(planted)
                           if fab.route(str(int(p))) not in FABRIC_COLD and not 7000 <= p < 8000]
            first = sum(bool(cold[qi]) and cold[qi][0].chunk.id == pid for qi, pid in hot_planted)
            if first != len(hot_planted):
                raise AssertionError(f"fabric_cold: {first} of {len(hot_planted)} planted hot rows first")
            truth10 = [{str(int(i)) for i in t[:10]} for t in truth_ids]
            recall = float(np.mean([len({h.chunk.id for h in r} & t) / 10 for r, t in zip(cold, truth10)]))
            cold_truth = [{i for i in t if fab.route(i) in FABRIC_COLD} for t in truth10]
            found = sum(len({h.chunk.id for h in r} & t) for r, t in zip(cold, cold_truth))
            part = fab._shards[FABRIC_COLD[0]].cold
            scan_ms = _host_ms(lambda: part.scan(queries[0], k_shard, k_shard * fab.rescore_multiplier,
                                                 fab.prefetcher), n=16)
            host_gb = _rss_gb()
            split = fab.scanned_bytes_split(10)
            promote_s = []
            for i in FABRIC_COLD:
                t0 = time.perf_counter()
                fab.promote_shard(i)
                promote_s.append(time.perf_counter() - t0)
            fab.search_batch(queries[:1], 1)
            back = _against_exact(torch, np, S, fab.search_batch(queries, 10), truth_s, truth_ids,
                                  "fabric_cold: promoted")
            emit("fabric_cold", cold_shards=list(FABRIC_COLD), demote_s=demote_s, device_bytes_demoted=doomed,
                 device_bytes_freed=freed, search_batch_s=cold_search_s, cold_scan_ms_per_query=scan_ms,
                 scanned_bytes_split=split,
                 prefetches=pf1["prefetches_total"] - pf0["prefetches_total"],
                 prefetch_bytes=pf1["prefetch_bytes_total"] - pf0["prefetch_bytes_total"],
                 rescored_max_rel_err=worst, planted_hot_first=first, planted_hot=len(hot_planted),
                 recall_at_10=recall, cold_truth_recall=found / max(1, sum(len(t) for t in cold_truth)),
                 cold_truth_rows=sum(len(t) for t in cold_truth), swaps=fab.swap_stats(), promote_s=promote_s,
                 promoted_against_exact=back, device_gb=(torch.cuda.memory_allocated(dev) - mem0) / 1e9,
                 host_rss_gb_cold=host_gb, peak_host_rss_gb=rss.peak / 1e9, phase_s=time.perf_counter() - t_phase)
        finally:
            fab.close()
    del fab, S
    gc.collect()
    torch.cuda.empty_cache()


def native_store_phase(exact, queries) -> None:
    """The C++ CPU store on the card machine's CPU (one thread), over the
    first ``NATIVE_ROWS`` rows of the ``retrieve`` corpus in f32: exact mode against
    the port's ``MemoryVectorStore`` (ranks equal except at near ties), IVF
    (nlist 64, nprobe 16) with recall@10 against exact, build seconds and
    ms a query."""
    import numpy as np

    from generativeaiexamples_tpu_torch.retrieval.memory import MemoryVectorStore
    from generativeaiexamples_tpu_torch.retrieval.native import NativeVectorStore, load_library

    t_phase = time.perf_counter()
    vecs = np.ascontiguousarray(exact._mirror._vecs[:NATIVE_ROWS])
    chunks = exact._mirror._chunks[:NATIVE_ROWS]
    t0 = time.perf_counter()
    load_library()
    lib_s = time.perf_counter() - t0
    plain = MemoryVectorStore(RETRIEVE_DIM)
    plain.add(chunks, vecs)
    ex = NativeVectorStore(RETRIEVE_DIM, index_type="exact")
    ex.add(chunks, vecs)
    t0 = time.perf_counter()
    got = [ex.search(q, 10) for q in queries]
    exact_ms = (time.perf_counter() - t0) * 1e3 / len(queries)
    checked = _same_ranks(got, [plain.search(q, 11) for q in queries], 10, "native_store: exact against memory")
    ivf = NativeVectorStore(RETRIEVE_DIM, index_type="ivf", nlist=64, nprobe=16, ivf_build_threshold=NATIVE_ROWS)
    t0 = time.perf_counter()
    ivf.add(chunks, vecs)  # reaches the threshold: k-means and the lists
    build_s = time.perf_counter() - t0
    if ivf._lib.vs_nlist(ivf._handle) != 64:
        raise AssertionError("native_store: the IVF index was not built")
    t0 = time.perf_counter()
    approx = [ivf.search(q, 10) for q in queries]
    ivf_ms = (time.perf_counter() - t0) * 1e3 / len(queries)
    recall = float(np.mean([len(set(_ids(a)) & set(_ids(e))) / 10 for a, e in zip(approx, got)]))
    emit("native_store", rows=NATIVE_ROWS, dim=RETRIEVE_DIM, queries=len(queries), threads=1,
         library_build_s=lib_s, exact_ms_per_query=exact_ms, exact_ranks_checked=checked, ivf_nlist=64,
         ivf_nprobe=16, ivf_build_s=build_s, ivf_ms_per_query=ivf_ms, ivf_recall_at_10=recall,
         phase_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# serve Llama-3-8B through the port's HTTP front
# ---------------------------------------------------------------------------


def _http(method, url, body=None, headers=None, timeout=600):
    """(status, headers, body bytes) of one request, error statuses included."""
    data = json.dumps(body).encode() if isinstance(body, (dict, list)) else body
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers, exc.read()


def _post(url, body, timeout=600):
    status, _, raw = _http("POST", url, body, timeout=timeout)
    return status, raw.decode()


def _get(url, timeout=60):
    status, _, raw = _http("GET", url, timeout=timeout)
    return status, raw.decode()


def serve_kw(kv_layout: str) -> dict:
    """The engine server's serving settings for one KV layout."""
    from generativeaiexamples_tpu_torch.engine.scheduler import SERVING_DEFAULTS

    paged = dict(kv_layout="paged", kv_page_size=64) if kv_layout == "paged" else {}
    return dict(SERVING_DEFAULTS, **paged)


# Kernels each serving path must launch, and the decode kernel of the other
# layout, which it must not.
PATH_KERNELS = {
    "contiguous": (("qmm", "decode_attention", "flash_attention"), "paged_decode_attention"),
    "paged": (("qmm", "paged_decode_attention", "flash_attention"), "decode_attention"),
}


def make_prompts() -> dict:
    """The serve phases' prompts, the same for both layouts (byte
    tokenizer: BOS + one token per ASCII byte)."""
    import random

    rng = random.Random(0)

    def prompt(n_tokens):
        return "".join(rng.choice("abcdefghijklmnopqrstuvwxyz ,.") for _ in range(n_tokens - 1))

    lengths = [20, 48, 140, 180, 220, 250, 450, 650]
    out = dict(warmup=prompt(24), lengths=lengths)
    out["completions"] = [prompt(n) for n in lengths]
    out["chat"] = prompt(60)
    # A 300-token prompt and four extensions by distinct 20-token suffixes:
    # 300 is not a multiple of the page size, so the boundary page is
    # shared and every extension's first write copies it.
    out["shared"] = prompt(300)
    out["extensions"] = [out["shared"] + prompt(21) for _ in range(4)]
    return out


def _complete(base, prompt, max_tokens=32):
    status, body = _post(base + "/v1/completions", {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0})
    out = json.loads(body)
    if status != 200 or not out["choices"][0]["text"]:
        raise AssertionError(f"completion of a {len(prompt) + 1}-token prompt failed: {status} {body[:300]}")
    return out


def _concurrent(base, prompts):
    results: dict[int, dict] = {}

    def one(i):
        results[i] = _complete(base, prompts[i])

    workers = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for w in workers:
        w.start()
    return workers, results


def serve_rag(torch, base: str, rag) -> dict:
    """``/v1/embeddings`` and ``/v1/ranking`` on the serving front: 32
    concurrent single queries (they must coalesce in the micro-batcher),
    one 64-passage request and one 16-passage ranking, each against a
    direct call.  Returns the phase's fields."""
    batched, reranker, queries = rag
    inner = batched._inner
    snap0 = batched.batcher.stats.snapshot()
    vectors, latency_ms, errors = {}, {}, {}

    def one(i):
        t0 = time.perf_counter()
        try:
            _, body = _post(base + "/v1/embeddings", {"input": queries[i], "input_type": "query"})
        except OSError as exc:  # reported below: the phase fails
            errors[i] = repr(exc)
            return
        latency_ms[i] = (time.perf_counter() - t0) * 1e3
        vectors[i] = json.loads(body)["data"][0]["embedding"]

    workers = [threading.Thread(target=one, args=(i,)) for i in range(len(queries))]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=300)
    if len(vectors) != len(queries):
        raise AssertionError(f"/v1/embeddings: {len(queries) - len(vectors)} query requests failed: {errors}")
    direct = torch.tensor([inner.embed_query(q) for q in queries])
    served = torch.tensor([vectors[i] for i in range(len(queries))])
    torch.testing.assert_close(served, direct, **EMBED_TOL)
    passages = _texts(12, 64, 400)
    status, body = _post(base + "/v1/embeddings", {"input": passages, "input_type": "passage"})
    docs = torch.tensor([d["embedding"] for d in json.loads(body)["data"]])
    docs_direct = torch.tensor(inner.embed_documents(passages))
    torch.testing.assert_close(docs, docs_direct, **EMBED_TOL)
    ranked = passages[:16]
    status, body = _post(base + "/v1/ranking", {"query": {"text": queries[0]}, "passages": [{"text": p} for p in ranked]})
    got = [r["index"] for r in json.loads(body)["rankings"]]
    scores = reranker.score(queries[0], ranked)
    want = sorted(range(len(ranked)), key=lambda i: -scores[i])
    # The reranker's order; two passages whose scores differ by less than
    # the card's run-to-run noise may swap.
    if sorted(got) != list(range(len(ranked))) or any(abs(scores[g] - scores[w]) > 1e-3 for g, w in zip(got, want)):
        raise AssertionError(f"/v1/ranking order {got} is not the reranker's {want}")
    _, metrics = _get(base + "/metrics")
    series = {line.split()[0]: float(line.split()[1]) for line in metrics.splitlines()
              if line.startswith("rag_") and not line.startswith("#")}
    n_req = series["rag_requests_total"] - snap0["requests_total"]
    n_batches = series["rag_batches_total"] - snap0["batches_total"]
    if n_req != len(queries) or not n_batches < len(queries):
        raise AssertionError(f"rag series: {n_req} requests in {n_batches} batches; the queries did not coalesce")
    lat = sorted(latency_ms.values())
    return dict(embed_requests=len(queries), embed_latency_p50_ms=lat[len(lat) // 2],
                embed_latency_p95_ms=lat[int(0.95 * (len(lat) - 1))], rag_batches=n_batches,
                mean_batch_size=(series["rag_embed_batch_size_sum"] - snap0["batch_size_sum"]) / n_batches,
                embed_max_abs_err=(served - direct).abs().max().item(),
                passage_max_abs_err=(docs - docs_direct).abs().max().item(),
                ranking_passages=len(ranked), ranking_equal_to_direct=True)


def make_scheduler(cfg, params, dev, kv_layout):
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler

    return Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8", **serve_kw(kv_layout))


def serve(torch, dev, _cuda, cfg, params, prompts, kv_layout, expect=None, rag=None):
    """Serve Llama-3-8B through the port's HTTP front on one KV layout.

    Launch counts are zeroed just before the requests and read just after:
    eight concurrent completions with a streaming chat beside them, then
    the 20- and 650-token prompts each sent alone (their greedy text must
    equal ``expect``, the other layout's, when given), and on the paged
    layout a shared-prefix group.  With ``rag`` (a ``BatchedEmbedder``, a
    reranker and 32 queries) the front also serves ``/v1/embeddings`` and
    ``/v1/ranking`` (:func:`serve_rag`).  Then the engine stops and one
    decode chunk is timed, untraced.  Returns (launches, texts of the
    prompts sent alone, the chunk's timing, a summary: wall, TTFT p50,
    decode tokens/s and each prompt's emitted ids)."""
    from generativeaiexamples_tpu_torch.engine.paged_kv import PAGE_EVENTS
    from generativeaiexamples_tpu_torch.engine.server import create_engine_app
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer

    paged = kv_layout == "paged"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    sched = make_scheduler(cfg, params, dev, kv_layout)
    tee = StreamTee(sched)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built_gb = torch.cuda.memory_allocated(dev) / 1e9
    server = create_engine_app(sched, get_tokenizer("llama3-8b"), "llama3-8b", "127.0.0.1", 0,
                               embedder=rag[0] if rag else None, reranker=rag[1] if rag else None)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    sched.start()
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    phase = "serve_paged" if paged else "serve"
    try:
        _complete(base, prompts["warmup"], 4)  # first CUDA allocations, cuBLAS handles
        n_ttft0 = len(sched.stats.ttft_recent)
        snap0 = sched.stats.snapshot()
        events0 = dict(PAGE_EVENTS)
        _cuda.reset_launch_counts()
        t_wall = time.perf_counter()
        workers, results = _concurrent(base, prompts["completions"])
        status, body = _post(base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": prompts["chat"]}], "max_tokens": 32,
            "temperature": 0, "stream": True})
        for w in workers:
            w.join(timeout=900)
        wall = time.perf_counter() - t_wall
        events = [line[6:] for line in body.splitlines() if line.startswith("data: ")]
        chat_text = "".join(json.loads(e)["choices"][0]["delta"].get("content", "") for e in events[:-1])
        if status != 200 or events[-1] != "[DONE]" or not chat_text:
            raise AssertionError(f"streaming chat failed: {status} {body[:300]}")
        if len(results) != len(prompts["completions"]):
            raise AssertionError("a completion did not return")
        snap1 = sched.stats.snapshot()
        n_tokens = sum(out["usage"]["completion_tokens"] for out in results.values())
        ttfts = sorted(list(sched.stats.ttft_recent)[n_ttft0:])
        # Sent alone, so the batch shapes are the same on both layouts.  The
        # shortest prompt (below the shared-prefix minimum) must also give
        # the text it gave in the batch.
        alone = {n: _complete(base, prompts["completions"][prompts["lengths"].index(n)])["choices"][0]["text"]
                 for n in (20, 650)}
        if alone[20] != results[0]["choices"][0]["text"]:
            raise AssertionError(f"re-sent prompt diverged:\n{results[0]['choices'][0]['text']!r}\n{alone[20]!r}")
        if expect is not None and alone != expect:
            raise AssertionError(f"{kv_layout} greedy text differs from the other layout's:\n{alone}\n{expect}")
        shared_fields = {}
        if paged:
            hits0 = sched.stats.snapshot()["shared_prefix_hits"]
            _complete(base, prompts["shared"])
            workers, ext = _concurrent(base, prompts["extensions"])
            for w in workers:
                w.join(timeout=900)
            if len(ext) != len(prompts["extensions"]):
                raise AssertionError("a shared-prefix completion did not return")
            shared_fields["shared_prefix_hits"] = sched.stats.snapshot()["shared_prefix_hits"] - hits0
        for path in ("/v1/models", "/health", "/metrics"):
            st, txt = _get(base + path)
            if st != 200 or not txt:
                raise AssertionError(f"{path} returned {st}")
        launches = dict(_cuda.LAUNCHES)
        designs = dict(_cuda.QMM_DESIGN_LAUNCHES)
        want, other = PATH_KERNELS[kv_layout]
        missing = [k for k in want if launches[k] == 0] + [f"qmm {d}" for d, n in designs.items() if n == 0]
        if missing or launches[other]:
            raise AssertionError(f"{kv_layout} path launches: {launches} {designs} (missing {missing}, "
                                 f"{other} must be 0)")
        rag_fields = serve_rag(torch, base, rag) if rag else {}
        snap2 = sched.stats.snapshot()
        page_events = {k: PAGE_EVENTS[k] - events0[k] for k in PAGE_EVENTS}
        if paged:
            if page_events["device_graft_dispatch"] or not page_events["host_grafts"]:
                raise AssertionError(f"paged grafts must be host-only: {page_events}")
            if not page_events["cow_copies"]:
                raise AssertionError(f"no copy-on-write on the shared boundary page: {page_events}")
            if shared_fields["shared_prefix_hits"] < 4:
                raise AssertionError(f"shared-prefix hits {shared_fields['shared_prefix_hits']} < 4")
        decode_tokens = (snap1["tokens_total"] - snap0["tokens_total"]) - (snap1["requests_total"] - snap0["requests_total"])
        decode_s = snap1["decode_s"] - snap0["decode_s"]
        sched.stop()
        pool_fields = {}
        if paged:
            # Every request has finished: dropping the parked segments must
            # leave every page but the garbage page free.
            pool = sched._pool
            pool_fields = {k: snap2[k] for k in ("kv_pages_total", "kv_pages_free", "kv_pages_parked",
                                                  "kv_pages_shared", "kv_cow_breaks", "kv_page_evictions")}
            for seg in list(sched._prefix_index.segments()):
                sched._drop_segment(seg)
            if pool.pages_free != pool.total_pages - 1 or int(pool._refcount.sum()) != 1:
                raise AssertionError(f"pages leaked: {pool.pages_free} free of {pool.total_pages}")
            pool_fields["all_free_after_drain"] = True
        summary = dict(wall_s=wall, ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3 if ttfts else None,
                       decode_tokens_per_s=decode_tokens / decode_s if decode_s else None,
                       tokens_per_s=n_tokens / wall, streams=tee.by_prompt())
        emit(
            phase, model="llama3-8b", layers=cfg.n_layers, d_model=cfg.d_model, weights="random int8, seed 0",
            kv=f"int8 {kv_layout}" + (", page 64" if paged else ""), **serve_kw(kv_layout), cache_build_s=build_s,
            device_gb_after_build=built_gb, requests=len(prompts["completions"]) + 1,
            prompt_tokens=prompts["lengths"], completion_tokens=n_tokens, wall_s=wall,
            ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3 if ttfts else None,
            ttft_max_ms=ttfts[-1] * 1e3 if ttfts else None,
            tokens_per_s=n_tokens / wall, decode_tokens_per_s=decode_tokens / decode_s if decode_s else None,
            decode_chunks=snap1["decode_chunks"] - snap0["decode_chunks"],
            prefill_chunks=snap1["prefill_chunks"] - snap0["prefill_chunks"],
            launches=launches, qmm_design_launches=designs, alone_equal_to_other_layout=True if expect is not None else None,
            resend_equal=True, page_events=page_events if paged else None, **shared_fields, **pool_fields,
            **rag_fields,
            peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        )
        return launches, alone, time_chunk(torch, decode_chunk(torch, dev, sched)), summary
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=30)
        sched._cache = sched._pool = None  # free the KV memory for the next phase


class StreamTee:
    """Records each request a scheduler takes: its prompt ids, sampling
    and emitted ids (the front's own callback still runs)."""

    def __init__(self, sched):
        self.records = []
        submit = sched.submit

        def tee(req):
            ids, on_token = [], req.on_token

            def on_tok(tid):
                ids.append(tid)
                on_token(tid)

            req.on_token = on_tok
            self.records.append((tuple(req.token_ids), req.sampling, ids))
            return submit(req)

        sched.submit = tee

    def by_prompt(self) -> dict:
        return {prompt: list(ids) for prompt, _, ids in self.records}


# ---------------------------------------------------------------------------
# the replica pool on the serving path
# ---------------------------------------------------------------------------

# The engine server as a 2-replica pool: the serve requests' deployment
# behind a router.  Same draw as ``serve``'s params (W8A8, seed 0).
POOL_ARGV = ("--model", "llama3-8b", "--replicas", "2", "--routing-policy", "prefix", "--matmul-kernel",
             "pallas_w8a8", "--max-batch", "32", "--max-len", "2048", "--embedder", "none", "--seed", "0",
             "--host", "127.0.0.1", "--port", "0")
# The health sections, through ``APP_CONFIG_FILE``.  The first pool runs
# without the gray-failure layer: its scorer compares replicas with each
# other, and the drills' own uneven load (one replica idle beside a busy
# one, a fresh replica beside veterans) ejected healthy replicas
# (``PERF.md`` §6).  The gray drill runs on the second, fresh pool, with windows short
# enough that an ejection and a re-admission take seconds; tolerance and
# thresholds stay the defaults.
POOL_MAIN_HEALTH = dict(enabled=False)
POOL_GRAY_HEALTH = dict(window_s=2.0, eject_after_s=1.0, readmit_after_s=1.0, probation_s=2.0, score_smoothing=1.0)
POOL_DRILL_LATENCY_MS = 300  # per tick of replica 1, against ~50 ms idle ticks
# The failover burst: distinct prompts (no prefix-cache hit anywhere, so each
# stream is a cold prefill's), placed least-loaded, more than both
# replicas' 2 x 32 slots; every 6th streams.
POOL_BURST, POOL_BURST_TOKENS, POOL_STREAMED_EVERY = 72, 16, 6
POOL_STREAM_TOKENS = 96  # the stream running across a scale-up
# The 429 drill: a second pool over the same params.
SMALL_POOL = dict(max_batch=4, max_queue=2)
SMALL_BURST = 16
POOL_WAIT_S = 60.0


def _tree_bytes(torch, obj, seen=None) -> int:
    """Bytes of every distinct tensor storage reachable from ``obj`` (dicts,
    sequences and dataclass leaves), each storage counted once."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        storage = obj.untyped_storage()
        if storage.data_ptr() in seen:
            return 0
        seen.add(storage.data_ptr())
        return storage.nbytes()
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif hasattr(obj, "__dataclass_fields__"):
        items = [getattr(obj, f) for f in obj.__dataclass_fields__]
    else:
        return 0
    return sum(_tree_bytes(torch, x, seen) for x in items)


class ReplicaTee:
    """Records what each replica's scheduler takes (the pool's clones for a
    requeue or a hedge too): replica, request id, prompt ids and the ids
    that copy emitted.  ``attach`` wraps replicas added since."""

    def __init__(self):
        self.records: list = []
        self._lock = threading.Lock()

    def attach(self, pool) -> None:
        for r in pool.replicas:
            if getattr(r.scheduler, "_replica_tee", None) is not self:
                self._wrap(r.idx, r.scheduler)

    def _wrap(self, idx, sched) -> None:
        submit = sched.submit

        def tee(req):
            ids, on_token = [], req.on_token

            def on_tok(tid):
                ids.append(tid)
                on_token(tid)

            req.on_token = on_tok
            accepted = submit(req)
            if accepted:
                with self._lock:
                    self.records.append(dict(replica=idx, id=req.id, prompt=tuple(req.token_ids), ids=ids))
            return accepted

        sched.submit = tee
        sched._replica_tee = self

    def since(self, n: int) -> list:
        with self._lock:
            return list(self.records[n:])


def _wait_for(pred, timeout: float, what: str, poll_s: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(poll_s)
    raise AssertionError(f"timed out after {timeout:.0f} s waiting for {what}")


def _check_copies(recs, streams, where: str) -> dict:
    """Group a tee's records by request id: every copy of a request (a hedge
    adds one, its loser is cancelled part-way) emitted a prefix of
    ``serve``'s ids for the prompt, and one copy all of them."""
    by_id: dict = {}
    for rec in recs:
        by_id.setdefault(rec["id"], []).append(rec)
    for rid, copies in by_id.items():
        want = streams.get(copies[0]["prompt"])
        if want is None or any(c["ids"] != want[:len(c["ids"])] for c in copies) or \
                not any(c["ids"] == want for c in copies):
            raise AssertionError(f"{where}: {rid} ({len(copies[0]['prompt'])}-token prompt) on replicas "
                                 f"{[c['replica'] for c in copies]} gave {[c['ids'] for c in copies]}, serve {want}")
    return by_id


def _cold_streams(dev, cfg, params, requests, max_batch: int = 32) -> list:
    """Greedy ids of each ``(prompt ids, max_tokens)``: a fresh W8A8
    scheduler on ``params`` without the prefix cache, so every stream is a
    cold prefill's, whatever rows share its batches (freed after).
    ``max_batch`` must be the served scheduler's: the decode kernels'
    split plan follows the batch's slot count."""
    from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
    from generativeaiexamples_tpu_torch.engine.scheduler import SERVING_DEFAULTS, Request, Scheduler

    ref = Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8",
                    **dict(SERVING_DEFAULTS, prefix_cache="off", max_batch=max_batch))
    out, dones = [], []
    for ids, max_tokens in requests:
        done: "queue.Queue[str]" = queue.Queue()
        out.append([])
        ref.submit(Request(token_ids=list(ids), sampling=SamplingParams(temperature=0.0, max_tokens=max_tokens),
                           on_token=out[-1].append, on_done=done.put))
        dones.append(done)
    ref.start()
    try:
        if [d.get(timeout=600) for d in dones] != ["length"] * len(requests):
            raise AssertionError("the cold reference scheduler failed a request")
    finally:
        ref.stop()
        ref._cache = None
    return out


def _random_prompts(seed: int, n: int, lo: int, hi: int) -> list:
    import random

    rng = random.Random(seed)
    return ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz ,.") for _ in range(rng.randint(lo, hi))) for _ in range(n)]


def _text_of(tokenizer, ids) -> str:
    """The text the engine front returns for ``ids`` (its incremental
    decoder, then the final flush)."""
    from generativeaiexamples_tpu_torch.engine.tokenizer import decode_stream

    piece = decode_stream(tokenizer)
    return "".join(piece(t) for t in ids) + piece(0, final=True)


def _sse_result(raw: str) -> tuple:
    """(concatenated text, last finish_reason) of a completions SSE body."""
    events = [json.loads(line[6:]) for line in raw.splitlines() if line.startswith("data: {")]
    return "".join(e["choices"][0].get("text") or "" for e in events), events[-1]["choices"][0]["finish_reason"]


def _replica_states(base) -> dict:
    _, raw = _get(base + "/admin/replicas")
    return {r["replica"]: r["state"] for r in json.loads(raw)["replicas"]}


def _metric_lines(base) -> list:
    return _get(base + "/metrics")[1].splitlines()


def _metric(lines, name: str) -> float:
    return float(next(line.split()[1] for line in lines if line.split()[0] == name))


class _TimedStream:
    """A streamed completion on a thread, recording each SSE event's arrival."""

    def __init__(self, base, prompt, max_tokens):
        self.times: list = []
        self.raw = ""
        self.status = None
        self.thread = threading.Thread(target=self._run, args=(base, prompt, max_tokens), daemon=True)
        self.thread.start()

    def _run(self, base, prompt, max_tokens):
        body = json.dumps({"prompt": prompt, "max_tokens": max_tokens, "temperature": 0, "stream": True}).encode()
        req = urllib.request.Request(base + "/v1/completions", data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            self.status = resp.status
            chunks = []
            for line in resp:
                if line.startswith(b"data: "):
                    self.times.append(time.perf_counter())
                chunks.append(line.decode())
            self.raw = "".join(chunks)

    def join(self):
        self.thread.join(timeout=600)
        if self.thread.is_alive() or self.status != 200:
            raise AssertionError(f"streamed completion failed: {self.status} {self.raw[:300]}")

    def longest_gap(self, t0: float, t1: float, inside: bool = True) -> float:
        """The longest gap between consecutive events whose span meets
        [t0, t1] (``inside``), or the longest of the others."""
        gaps = [b - a for a, b in zip(self.times, self.times[1:]) if (b >= t0 and a <= t1) == inside]
        return max(gaps, default=0.0)


def _pool_hydration(base, dev, new_idx: int, target: int) -> dict:
    """After the first ``/admin/scale``: the replica bootstrap built the
    store singleton (the sharded fabric, on the card), warmed the shards
    ``shards_for_replica`` gives the new replica, and ``/metrics`` counts
    one hydration."""
    from generativeaiexamples_tpu_torch.chains.factory import peek_store
    from generativeaiexamples_tpu_torch.retrieval.fabric import ShardedVectorStore

    store = peek_store()
    count = _metric(_metric_lines(base), "rag_shard_replica_hydrations_total")
    if not isinstance(store, ShardedVectorStore) or store.device != dev or count != 1:
        raise AssertionError(f"pool_drain_scale: the bootstrap built {store!r}; hydrations {count}")
    warmed = [s.idx for s in store._shards if s.store._device_buf is not None]
    routed = store.shards_for_replica(new_idx, max(target, new_idx + 1))
    if warmed != routed:
        raise AssertionError(f"pool_drain_scale: replica {new_idx} warmed shards {warmed}, not {routed}")
    return dict(store="ShardedVectorStore", shards=store.num_shards, child=type(store._shards[0].store).__name__,
                warmed_shards=warmed, hydrations=count, shard_devices=store.shard_devices())


def pool_phase(torch, dev, _cuda, smi: str, cfg, params, prompts, serve_summary, alone) -> dict:
    """The engine server as a 2-replica pool (``build_server`` with
    ``POOL_ARGV``): Llama-3-8B W8A8 at full width and depth, one weight tree
    shared by both replicas, each with its own int8 KV cache, the
    gray-failure layer off (``POOL_MAIN_HEALTH``).  Six drills, each of
    which fails the run:

    1. ``pool``: ``serve``'s requests through the pool's HTTP front, launch
       counts zeroed just before and read just after (K1 in both designs,
       K2, K4; not K3); every stream equals ``serve``'s bit for bit; both
       replicas placed requests; the per-replica, pool and gray families on
       ``/metrics``; the device GB the server added below one weight tree
       plus two caches plus 1 GB, and both replicas on the same storages.
    2. ``pool_failover``: 72 distinct prompts (no prefix-cache hit), more
       than both replicas' slots; ``replica:error`` at replica 1 while it
       holds queued requests: the token-less ones finish on the survivor
       with their cold streams (a fresh scheduler without the prefix cache
       gives them), every mid-flight one answers 503 or a streamed
       ``finish_reason: "error"``, ``/health`` reads 503 ``degraded``.
    3. ``pool_drain_scale``: ``/admin/scale`` back to 2 (replica 2), then
       ``/admin/drain`` of the replica running a generation (it finishes
       there, new requests place on the other, the drained one detaches),
       then ``/admin/scale`` to 2 again under a running stream (device GB
       and the stream's longest gap across it) and a request on the new
       replica 3; fresh prompts, each stream equal to its cold one.
    4. ``pool_debug``: ``/debug/requests`` under the caller's
       ``X-Request-Id``; ``/debug/timeseries`` with engine series.  The
       pool is freed after it.
    5. ``pool_gray``, on a second pool over the same params (2 replicas,
       ``max_batch`` 4, ``max_queue`` 2, fresh: the scorer compares
       replicas alike; its own TSDB): ``replica:latency`` at its replica 1
       ejects it; disarmed, it comes back through probation; the
       transitions on ``/metrics`` and ``/admin/replicas``.  (A fresh
       replica beside veterans reads as their brownout on the cumulative
       TTFT mean, and an ejection drops the router's mirror: ``PERF.md``.)
    6. ``pool_429``: that pool under a burst of 16 distinct prompts: 429s
       with ``Retry-After`` in [1, 30], the accepted ones with their cold
       streams, the pool's rejected counter equal to the 429s.

    Returns the launches of drill 1."""
    import tempfile

    from generativeaiexamples_tpu_torch.core.configuration import reset_config_cache
    from generativeaiexamples_tpu_torch.engine.replica import EJECTED, HEALTHY, PROBATION, UNHEALTHY, EnginePool
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import build_server, create_engine_app
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.obs.tsdb import Tsdb
    from generativeaiexamples_tpu_torch.resilience.faults import get_fault_injector, reset_faults

    t_phase = time.perf_counter()
    tokenizer = get_tokenizer("llama3-8b")
    streams = serve_summary["streams"]
    config = tempfile.NamedTemporaryFile("w", suffix=".json", delete=False)
    # The sharded fabric as the store: a replica added by /admin/scale
    # hydrates the shards routed to its index.
    json.dump({"health": POOL_MAIN_HEALTH, "vector_store": {"name": "fabric"}}, config)
    config.close()
    os.environ["APP_CONFIG_FILE"] = config.name
    reset_config_cache()
    reset_faults()
    gc.collect()
    torch.cuda.synchronize()
    gb0 = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    server = build_server(list(POOL_ARGV))
    pool = server.scheduler
    build_s = time.perf_counter() - t0
    tee = ReplicaTee()
    tee.attach(pool)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    pool.start()
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    small = small_server = small_thread = None
    try:
        if pool.health_cfg.enabled:
            raise AssertionError(f"the pool did not read the phase's health section: {pool.health_cfg}")
        # -- 1. serve's requests through the pool ------------------------------
        warm = [threading.Thread(target=_complete, args=(base, prompts["warmup"], 4)) for _ in range(2)]
        for w in warm:  # one on each replica: first allocations
            w.start()
        for w in warm:
            w.join(timeout=600)
        stats = [r.scheduler.stats for r in pool.replicas]
        n_ttft0 = [len(s.ttft_recent) for s in stats]
        snap0 = [s.snapshot() for s in stats]
        n_rec = len(tee.records)
        _cuda.reset_launch_counts()
        t_wall = time.perf_counter()
        workers, results = _concurrent(base, prompts["completions"])
        status, body = _post(base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": prompts["chat"]}], "max_tokens": 32, "temperature": 0,
            "stream": True})
        for w in workers:
            w.join(timeout=900)
        wall = time.perf_counter() - t_wall
        launches = dict(_cuda.LAUNCHES)
        designs = dict(_cuda.QMM_DESIGN_LAUNCHES)
        if status != 200 or len(results) != len(prompts["completions"]):
            raise AssertionError(f"pool: a request failed: chat {status} {body[:300]}, {len(results)} completions")
        snap1 = [s.snapshot() for s in stats]
        ttfts = sorted(t for s, n in zip(stats, n_ttft0) for t in list(s.ttft_recent)[n:])
        alone_pool = {n: _complete(base, prompts["completions"][prompts["lengths"].index(n)])["choices"][0]["text"]
                      for n in (20, 650)}
        if alone_pool != alone:
            raise AssertionError(f"pool: the prompts sent alone differ from serve's:\n{alone_pool}\n{alone}")
        checked = len(_check_copies(tee.since(n_rec), streams, "pool"))
        rows = json.loads(_get(base + "/admin/replicas")[1])["replicas"]
        placed = [r["requests_total"] - s["requests_total"] for r, s in zip(rows, snap0)]
        if min(placed) < 1:
            raise AssertionError(f"pool: a replica placed no request: {placed}")
        lines = _metric_lines(base)
        for name in ('engine_replica_requests_total{replica="0"}', 'engine_replica_requests_total{replica="1"}',
                     'engine_replica_queued{replica="1"}', 'engine_replica_score{replica="0"}', "engine_pool_size",
                     "engine_pool_desired_replicas", "engine_pool_ejected_replicas", "rag_hedge_requests_total",
                     "engine_replica_ejections_total", "engine_router_failovers_total"):
            if not any(line.split()[0] == name for line in lines if not line.startswith("#")):
                raise AssertionError(f"pool: /metrics lacks {name}")
        want_k, other = PATH_KERNELS["contiguous"]
        missing = [k for k in want_k if launches[k] == 0] + [f"qmm {d}" for d, n in designs.items() if n == 0]
        if missing or launches[other]:
            raise AssertionError(f"pool path launches: {launches} {designs} (missing {missing}, {other} must be 0)")
        torch.cuda.synchronize()
        added_gb = torch.cuda.memory_allocated(dev) / 1e9 - gb0
        scheds = [r.scheduler for r in pool.replicas]
        tree_gb = _tree_bytes(torch, scheds[0].params) / 1e9
        shared_gb = _tree_bytes(torch, [s.params for s in scheds]) / 1e9
        cache_gb = _tree_bytes(torch, scheds[0]._cache) / 1e9
        if shared_gb != tree_gb or not added_gb < tree_gb + 2 * cache_gb + 1.0:
            raise AssertionError(f"pool memory: +{added_gb:.2f} GB for a {tree_gb:.2f} GB tree ({shared_gb:.2f} GB "
                                 f"across replicas) and two {cache_gb:.2f} GB caches")
        dec = [(b["tokens_total"] - a["tokens_total"]) - (b["requests_total"] - a["requests_total"])
               for a, b in zip(snap0, snap1)]
        dec_s = [b["decode_s"] - a["decode_s"] for a, b in zip(snap0, snap1)]
        n_tokens = sum(out["usage"]["completion_tokens"] for out in results.values())
        tokens_per_s = n_tokens / wall
        emit("pool", nvidia_smi=smi, argv=list(POOL_ARGV), replicas=2, build_s=build_s, requests=len(results) + 1,
             streams_checked=checked, streams_equal_to_serve=True, alone_equal_to_serve=True, placed=placed,
             wall_s=wall, serve_wall_s=serve_summary["wall_s"], tokens_per_s=tokens_per_s,
             serve_tokens_per_s=serve_summary["tokens_per_s"],
             ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3 if ttfts else None, serve_ttft_p50_ms=serve_summary["ttft_p50_ms"],
             decode_tokens_per_s=sum(dec) / max(dec_s) if max(dec_s) else None,
             replica_decode_tokens_per_s=[d / t if t else None for d, t in zip(dec, dec_s)],
             serve_decode_tokens_per_s=serve_summary["decode_tokens_per_s"], launches=launches,
             qmm_design_launches=designs, device_gb_added=added_gb, weight_tree_gb=tree_gb,
             weight_storage_gb_across_replicas=shared_gb, cache_gb_per_replica=cache_gb,
             device_gb=torch.cuda.memory_allocated(dev) / 1e9, failovers=pool.failovers_total,
             hedges_fired=pool.hedger.fired_total)
        if pool.failovers_total:
            raise AssertionError("pool: a replica failed over during the serve requests")

        # -- 2. failover: replica 1 dies holding more requests than slots ------
        burst = _random_prompts(1, POOL_BURST, 48, 160)
        n_rec = len(tee.records)
        answers: dict = {}

        def one(i):
            body = {"prompt": burst[i], "max_tokens": POOL_BURST_TOKENS, "temperature": 0,
                    "stream": i % POOL_STREAMED_EVERY == 0}
            answers[i] = _post(base + "/v1/completions", body, timeout=600)

        workers = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(POOL_BURST)]
        t_burst = time.perf_counter()
        for w in workers:
            w.start()
        r1 = pool.replicas[1].scheduler
        _wait_for(lambda: r1.stats.snapshot()["queued"] > 0 and any(
            p.replica == 1 and p.tokens > 0 for p in list(pool._placements.values())), POOL_WAIT_S,
            "replica 1 with a token emitted and requests queued")
        queued_at_fault = r1.stats.snapshot()["queued"]
        t_fault = time.perf_counter()
        get_fault_injector().configure("replica:error=1,index=1")
        _wait_for(lambda: pool.replicas[1].state == UNHEALTHY, POOL_WAIT_S, "the pool to fail replica 1 over")
        failover_s = time.perf_counter() - t_fault
        reset_faults()
        for w in workers:
            w.join(timeout=600)
        burst_s = time.perf_counter() - t_burst
        if len(answers) != POOL_BURST:
            raise AssertionError(f"pool_failover: {POOL_BURST - len(answers)} requests did not return")
        ids = [tuple(tokenizer.encode(t, add_bos=True)) for t in burst]
        cold = dict(zip(ids, _cold_streams(dev, cfg, params, [(k, POOL_BURST_TOKENS) for k in ids])))
        by_id: dict = {}
        for rec in tee.since(n_rec):
            by_id.setdefault(rec["id"], []).append(rec)
        moved, failed, served = 0, {"503": 0, "stream_error": 0}, 0
        for i, k in enumerate(ids):
            status, raw = answers[i]
            if i % POOL_STREAMED_EVERY == 0:
                text, finish = _sse_result(raw) if status == 200 else ("", None)
                ok, err = (status == 200 and finish in ("length", "stop")), (status == 200 and finish == "error")
            else:
                ok = status == 200
                text = json.loads(raw)["choices"][0]["text"] if ok else ""
                err = status == 503 and json.loads(raw)["error"]["type"] == "engine_error"
            if ok:
                if text != _text_of(tokenizer, cold[k]):
                    raise AssertionError(f"pool_failover: request {i} gave other text than its cold stream")
                served += 1
            elif err:
                failed["stream_error" if i % POOL_STREAMED_EVERY == 0 else "503"] += 1
            else:
                raise AssertionError(f"pool_failover: request {i} answered {status} {raw[:300]}")
        mid_flight = 0
        for rid, recs in by_id.items():
            reps = [r["replica"] for r in recs]
            on_dead = [r for r in recs if r["replica"] == 1]
            if on_dead and reps[-1] != 1 and not on_dead[-1]["ids"]:
                # Held by replica 1 without a token: it finished on the
                # survivor with its cold stream.
                if recs[-1]["ids"] != cold[recs[-1]["prompt"]]:
                    raise AssertionError(f"pool_failover: {rid} moved to replica {reps[-1]} and gave {recs[-1]['ids']}")
                moved += 1
            elif on_dead and on_dead[-1]["ids"] and reps[-1] == 1:
                mid_flight += 1
        status, raw = _get(base + "/health")
        health = json.loads(raw)
        lines = _metric_lines(base)
        if moved < 1 or sum(failed.values()) < 1 or sum(failed.values()) != mid_flight or status != 503 or \
                health["status"] != "degraded" or _metric(lines, "engine_router_failovers_total") < 1:
            raise AssertionError(f"pool_failover: moved {moved}, failed {failed} of {mid_flight} mid-flight, "
                                 f"/health {status} {raw[:300]}")
        snap = pool.snapshot()
        emit("pool_failover", nvidia_smi=smi, fault="replica:error=1,index=1", requests=POOL_BURST,
             max_tokens=POOL_BURST_TOKENS, placed_on_faulted=sum(1 for recs in by_id.values() if recs[0]["replica"] == 1),
             queued_at_fault=queued_at_fault, served_equal_to_cold=served, moved_to_survivor_equal_to_cold=moved,
             mid_flight_failed=failed, failover_s=failover_s, burst_s=burst_s, health_status=status,
             health=health.get("replicas"), failovers_total=snap["router_failovers_total"],
             requeued=snap["router_requeued_total"])

        # -- 3. scale back to 2, drain a replica under a generation, scale again
        t_scale0 = time.perf_counter()
        status, raw = _post(base + "/admin/scale?replicas=2", {})
        first_scale = dict(json.loads(raw), seconds=time.perf_counter() - t_scale0)
        tee.attach(pool)
        if status != 200 or first_scale["added"] != [2]:
            raise AssertionError(f"pool_drain_scale: scale after the failover answered {status} {raw}")
        hydration = _pool_hydration(base, dev, new_idx=2, target=int(POOL_ARGV[POOL_ARGV.index("--replicas") + 1]))
        # Fresh prompts (cold everywhere): a generation, two requests after
        # the drain, a long stream, a request after the second scale-up.
        fresh = _random_prompts(2, 5, 64, 128)
        fresh_ids = [tuple(tokenizer.encode(t, add_bos=True)) for t in fresh]
        n_rec = len(tee.records)
        runner = _TimedStream(base, fresh[0], 32)
        victim = _wait_for(lambda: [p.replica for p in list(pool._placements.values()) if p.tokens > 0], POOL_WAIT_S,
                           "a running generation")[0]
        survivor = 2 if victim == 0 else 0
        status, raw = _post(base + f"/admin/drain?replica={victim}", {})
        drained_state = json.loads(raw)["state"]
        if status != 200 or drained_state not in ("draining", "detached"):
            raise AssertionError(f"pool_drain_scale: drain answered {status} {raw}")
        after = [_complete(base, fresh[i]) for i in (1, 2)]
        runner.join()
        _wait_for(lambda: _replica_states(base)[victim] == "detached", POOL_WAIT_S, f"replica {victim} to detach")
        stream = _TimedStream(base, fresh[3], POOL_STREAM_TOKENS)
        _wait_for(lambda: len(stream.times) > 4, POOL_WAIT_S, f"a running stream on replica {survivor}")
        torch.cuda.synchronize()
        gb_before = torch.cuda.memory_allocated(dev) / 1e9
        t_scale0 = time.perf_counter()
        status, raw = _post(base + "/admin/scale?replicas=2", {})
        t_scale1 = time.perf_counter()
        scaled = json.loads(raw)
        gb_after = torch.cuda.memory_allocated(dev) / 1e9
        tee.attach(pool)
        if status != 200 or scaled != {"size": 2, "added": [3], "drained": []}:
            raise AssertionError(f"pool_drain_scale: scale answered {status} {raw}")
        out = _complete(base, fresh[4])
        stream.join()
        firsts = {}
        for rec in tee.since(n_rec):
            firsts.setdefault(rec["prompt"], rec)
        placed_on = [firsts[k]["replica"] for k in fresh_ids]
        if placed_on != [victim, survivor, survivor, survivor, 3]:
            raise AssertionError(f"pool_drain_scale: drained {victim}; the requests ran on {placed_on}")
        cold = _cold_streams(dev, cfg, params,
                             [(k, POOL_STREAM_TOKENS if i == 3 else 32) for i, k in enumerate(fresh_ids)])
        got = [_sse_result(runner.raw)[0], after[0]["choices"][0]["text"], after[1]["choices"][0]["text"],
               _sse_result(stream.raw)[0], out["choices"][0]["text"]]
        if got != [_text_of(tokenizer, c) for c in cold] or [firsts[k]["ids"] for k in fresh_ids] != cold:
            raise AssertionError(f"pool_drain_scale: a stream differs from its cold one: {got}")
        gaps = [b - a for a, b in zip(stream.times, stream.times[1:])]
        emit("pool_drain_scale", nvidia_smi=smi, first_scale=first_scale, hydration=hydration, drained_replica=victim,
             drain_state=drained_state, placed_on=placed_on, streams_equal_to_cold=True, scale=scaled,
             scale_s=t_scale1 - t_scale0, device_gb_before_scale=gb_before, device_gb_after_scale=gb_after,
             stream_longest_gap_across_scale_s=stream.longest_gap(t_scale0, t_scale1),
             stream_longest_gap_elsewhere_s=stream.longest_gap(t_scale0, t_scale1, inside=False),
             stream_median_gap_s=sorted(gaps)[len(gaps) // 2] if gaps else None, stream_events=len(stream.times),
             states=_replica_states(base))

        # -- 4. the engine's telemetry shell ------------------------------------
        rid = "chip-pool-debug-1"
        status, headers, _ = _http("POST", base + "/v1/completions",
                                   {"prompt": prompts["warmup"], "max_tokens": 4, "temperature": 0},
                                   headers={"X-Request-Id": rid})
        records = json.loads(_get(base + "/debug/requests?limit=50")[1])["requests"]
        mine = [r for r in records if r["request_id"] == rid]
        series = json.loads(_get(base + "/debug/timeseries?series=engine.*&window=5m")[1])["series"]
        engine_series = sorted(series)
        if status != 200 or headers["X-Request-Id"] != rid or len(mine) != 1 or \
                mine[0]["route"] != "/v1/completions" or mine[0]["status"] != 200 or \
                not {"engine.tick_ms", "engine.requests./v1/completions"} <= set(series) or \
                not any(name.startswith("engine.replica.") for name in series):
            raise AssertionError(f"pool_debug: {status} {mine} {engine_series}")
        emit("pool_debug", nvidia_smi=smi, request_id=rid, recorded=mine[0], engine_series=engine_series)
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        pool.stop()
        for r in pool.replicas:  # free the KV memory
            r.scheduler._cache = None
        server = pool = None
        gc.collect()
        torch.cuda.empty_cache()

        # -- the small pool over the same params ----------------------------------
        from generativeaiexamples_tpu_torch.engine.scheduler import SERVING_DEFAULTS

        kw = dict(SERVING_DEFAULTS, **SMALL_POOL)
        with open(config.name, "w") as fh:
            json.dump({"health": POOL_GRAY_HEALTH}, fh)
        reset_config_cache()
        # Its own TSDB: two pools in one process would feed the same
        # per-replica series names (``engine.replica.<i>.*``).
        small = EnginePool([Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8", **kw) for _ in range(2)],
                           policy="prefix", tsdb=Tsdb())
        if small.health_cfg.window_s != POOL_GRAY_HEALTH["window_s"] or not small.health_cfg.enabled:
            raise AssertionError(f"the small pool did not read the gray drill's health section: {small.health_cfg}")
        small_server = create_engine_app(small, tokenizer, "llama3-8b", "127.0.0.1", 0)
        small_thread = threading.Thread(target=small_server.serve_forever, daemon=True)
        small.start()
        small_thread.start()
        base2 = f"http://127.0.0.1:{small_server.server_address[1]}"
        # -- 5. gray failure on the small pool: latency at its replica 1 -------
        _wait_for(lambda: set(_replica_states(base2).values()) == {HEALTHY}, 20.0, "both replicas healthy")
        seen = []

        def note_state():
            state = _replica_states(base2)[1]
            if not seen or seen[-1][0] != state:
                seen.append((state, time.perf_counter() - t_drill))
            return state

        t_drill = time.perf_counter()
        get_fault_injector().configure(f"replica:latency={POOL_DRILL_LATENCY_MS},index=1")
        _wait_for(lambda: note_state() == EJECTED, POOL_WAIT_S, "replica 1's ejection", poll_s=0.1)
        eject_s = time.perf_counter() - t_drill
        lines = _metric_lines(base2)
        ejected_metric = _metric(lines, "engine_pool_ejected_replicas")
        score = _metric(lines, 'engine_replica_score{replica="1"}')
        reset_faults()
        t_readmit = time.perf_counter()
        _wait_for(lambda: note_state() == HEALTHY, POOL_WAIT_S, "replica 1's re-admission", poll_s=0.1)
        restore_s = time.perf_counter() - t_readmit
        lines = _metric_lines(base2)
        states = [s for s, _ in seen]
        if states[-3:] != [EJECTED, PROBATION, HEALTHY] or ejected_metric != 1 or \
                _metric(lines, "engine_replica_ejections_total") < 1 or \
                _metric(lines, "engine_replica_readmissions_total") < 1 or _metric(lines, "engine_pool_ejected_replicas"):
            raise AssertionError(f"pool_gray: transitions {seen}, ejected gauge {ejected_metric}")
        if _replica_states(base2)[0] != HEALTHY:
            raise AssertionError("pool_gray: replica 0 left the healthy state")
        emit("pool_gray", nvidia_smi=smi, fault=f"replica:latency={POOL_DRILL_LATENCY_MS},index=1",
             health=POOL_GRAY_HEALTH,
             transitions=[(s, round(t, 3)) for s, t in seen], eject_s=eject_s, score_at_ejection=score,
             restore_s=restore_s, ejections_total=_metric(lines, "engine_replica_ejections_total"),
             readmissions_total=_metric(lines, "engine_replica_readmissions_total"))

        # -- 6. 429: a burst on the small pool ---------------------------------
        # Distinct fresh prompts: an accepted one is a cold prefill's stream.
        burst = _random_prompts(3, SMALL_BURST, 48, 160)
        answers = {}

        def one_small(i):
            answers[i] = _http("POST", base2 + "/v1/completions", {"prompt": burst[i], "max_tokens": 32, "temperature": 0})

        workers = [threading.Thread(target=one_small, args=(i,), daemon=True) for i in range(SMALL_BURST)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
        served = [i for i, (status, _, _) in sorted(answers.items()) if status == 200]
        cold = dict(zip(served, _cold_streams(dev, cfg, params, [(tokenizer.encode(burst[i], add_bos=True), 32)
                                                                 for i in served], max_batch=SMALL_POOL["max_batch"])))
        retry_after, accepted = [], 0
        for i, (status, headers, raw) in sorted(answers.items()):
            if status == 429:
                retry_after.append(int(headers["Retry-After"]))
            elif status == 200 and json.loads(raw)["choices"][0]["text"] == _text_of(tokenizer, cold[i]):
                accepted += 1
            else:
                raise AssertionError(f"pool_429: request {i} answered {status} {raw[:300]}")
        rejected = small.snapshot()["rejected_total"]
        if not retry_after or not all(1 <= r <= 30 for r in retry_after) or rejected != len(retry_after):
            raise AssertionError(f"pool_429: {len(retry_after)} 429s, Retry-After {retry_after}, counter {rejected}")
        emit("pool_429", nvidia_smi=smi, pool=dict(replicas=2, **SMALL_POOL), burst=SMALL_BURST,
             rejected=len(retry_after), rejected_counter=rejected, retry_after_s=retry_after,
             accepted_equal_to_cold=accepted, phase_s=time.perf_counter() - t_phase)

        return launches
    finally:
        reset_faults()
        for srv, th in ((small_server, small_thread), (server, thread)):
            if srv is not None:  # a drill failed before its own teardown
                srv.shutdown()
                srv.server_close()
                th.join(timeout=30)
        for engine in (small, pool):
            if engine is not None:
                engine.stop()
                for r in engine.replicas:  # free the KV memory for the next phase
                    r.scheduler._cache = None
        os.environ.pop("APP_CONFIG_FILE", None)
        os.unlink(config.name)
        reset_config_cache()
        from generativeaiexamples_tpu_torch.chains.factory import reset_factories

        reset_factories()  # the fabric the bootstrap built


# ---------------------------------------------------------------------------
# speculative decoding on the serving path
# ---------------------------------------------------------------------------

SPEC_GAMMA, SPEC_SELF_LAYERS = 4, 4
# The pinned-lookahead runs behind the bit-for-bit gate: the first prompts
# of ``completions``, submitted together, greedy, this many tokens each.
SPEC_PINNED_PROMPTS, SPEC_PINNED_TOKENS = 4, 16
# The random Llama-3.2-1B draft at full width and 8 of its 16 layers (its
# W8A8 and bf16 twins), so the whole script stays inside its time limit
# beside the scale-out retrieval phases (all 16 until then).
SPEC_DRAFT_LAYERS = 8
# Greedy exactness on the card: plain decode attends through K2, the verify
# pass through plain PyTorch, and the two round differently, so a near-tie
# argmax may flip.  Each greedy token is held to its position's argmax
# under a teacher-forced forward (f32 logits of an independent warm
# forward over the stream, ``teacher_forced_logits``): a speculative
# token within SPEC_TIE, a plain (K2) token within PLAIN_TIE, and where a
# spec stream first leaves the plain one the two tokens' logits lie within
# PLAIN_TIE of each other.  The three speculative steps share the verify
# math: steps that accepted no draft must emit equal greedy streams bit for
# bit, others may part from them only at a near tie (within SPEC_TIE).  A
# full-width round whose drafts are the target's own continuation must
# accept every draft (``spec_accept_round``).  Random Llama-3-8B logits are nearly flat
# (a std of ~1.3 and a median top-2 gap of ~0.2: ``serve_logit_std_mean``,
# ``serve_top2_gap_median``).  Measured on an H100 (PERF.md): spec tokens
# sit up to 0.262 below the teacher-forced argmax, plain ones up to 0.711,
# and a first difference's two logits up to 0.526 apart; planted verify
# faults read as PERF.md records (``perf_torch/rehearse_spec_gates.py``).
SPEC_TIE = 0.35
PLAIN_TIE = 0.9
# ``spec_accept``: the verify pass's f32 logits over its round against the
# teacher-forced forward's, every vocabulary entry (measured 0.079 on an
# H100; 2.8-5.1 under the rehearsed faults).
VERIFY_LOGIT_TOL = 0.25
SPEC_SAMPLED = dict(temperature=0.7, top_p=0.9, max_tokens=32)


def quote_prompt() -> str:
    """About 600 byte tokens: a passage, then an instruction to repeat it
    (the RAG quote-the-context case prompt lookup is for)."""
    import random

    rng = random.Random(1)
    words = [rng.choice(CHAIN_WORDS) for _ in range(200)]
    passage = " ".join(words)[:540]
    return passage + "\n\nRepeat the passage above, word for word:\n" + passage[:12]


def teacher_forced_logits(torch, cfg, params, prompt, stream, chunk: int = 256, mesh=None):
    """f32 logits of each emitted position of ``stream`` after ``prompt``,
    the way the scheduler builds the cache: a cold prefill of the prompt
    (in warm chunks of ``chunk`` when it is longer), then one warm forward
    over the stream's tokens reading the int8 cache.  Returns (n, vocab).
    ``mesh`` (a rank's context) runs one rank's share; every rank then
    holds the whole logits."""
    from generativeaiexamples_tpu_torch.models import llama

    dev = params["final_norm"].device
    n = len(prompt) + len(stream)
    cache = llama.init_kv_cache(llama.local_config(cfg, mesh), 1, n, device=dev)
    ids = torch.tensor([list(prompt) + list(stream)], device=dev)
    with torch.inference_mode():
        plen = len(prompt)
        if plen <= chunk:
            pos = torch.arange(plen, dtype=torch.int32, device=dev)[None]
            hidden, _ = llama.forward(params, cfg, ids[:, :plen], pos, cache,
                                      torch.tensor([plen], dtype=torch.int32, device=dev), cold_prefill=True,
                                      mesh=mesh)
        else:
            for start in range(0, plen, chunk):
                end = min(start + chunk, plen)
                pos = torch.arange(start, end, dtype=torch.int32, device=dev)[None]
                hidden, _ = llama.forward(params, cfg, ids[:, start:end], pos, cache,
                                          torch.tensor([end], dtype=torch.int32, device=dev), mesh=mesh)
        rows = [llama.logits(params, hidden[:, -1:], mesh)[0]]
        if len(stream) > 1:
            pos = torch.arange(plen, n - 1, dtype=torch.int32, device=dev)[None]
            hidden, _ = llama.forward(params, cfg, ids[:, plen:n - 1], pos, cache,
                                      torch.tensor([n - 1], dtype=torch.int32, device=dev), mesh=mesh)
            rows.append(llama.logits(params, hidden, mesh)[0])
        return torch.cat(rows).float()


def check_spec_streams(torch, cfg, params, records, serve_streams, spec: bool = True) -> dict:
    """The greedy and sampled gates over one step's requests (see
    SPEC_TIE; ``spec=False`` for a plain step, whose greedy streams must
    be serve's bit for bit).  Every reading is taken before any gate
    fails.  Returns the step's stream fields."""
    from generativeaiexamples_tpu_torch.engine.sampler import warped_candidates

    differ, compared, worst_deficit, worst_flip = 0, 0, 0.0, 0.0
    sampled_inside, sampled_outside, sampled_margin = 0, 0, None
    plain_deficit, top2_gaps, stds, mean_deficits, failures = 0.0, [], [], [], []
    tie = SPEC_TIE if spec else PLAIN_TIE
    for prompt, sp, ids in records:
        if not ids:
            raise AssertionError(f"a {len(prompt)}-token request emitted nothing")
        logits = teacher_forced_logits(torch, cfg, params, prompt, ids)
        picked = logits[torch.arange(len(ids)), torch.tensor(ids, device=logits.device)]
        if sp.temperature <= 0.0:
            worst_deficit = max(worst_deficit, (logits.max(dim=-1).values - picked).max().item())
            ref = serve_streams.get(prompt)
            if ref is None:
                continue
            compared += 1
            ref_logits = teacher_forced_logits(torch, cfg, params, prompt, ref)
            ref_picked = ref_logits[torch.arange(len(ref)), torch.tensor(ref, device=ref_logits.device)]
            top2 = ref_logits.topk(2, dim=-1).values
            top2_gaps.append(top2[:, 0] - top2[:, 1])
            stds.append(ref_logits.std(dim=-1))
            mean_deficits.append(top2[:, 0] - ref_logits.mean(dim=-1))
            plain_deficit = max(plain_deficit, (ref_logits.max(dim=-1).values - ref_picked).max().item())
            n = min(len(ref), len(ids))
            j = next((i for i in range(n) if ref[i] != ids[i]), None)
            if j is None:
                if len(ref) != len(ids):
                    failures.append(f"a stream of {len(ids)} tokens vs serve's {len(ref)}")
                continue
            differ += 1
            worst_flip = max(worst_flip, abs(logits[j, ids[j]].item() - logits[j, ref[j]].item()))
        else:
            n = len(ids)
            full = lambda v, dt: torch.full((n,), v, dtype=dt, device=logits.device)  # noqa: E731
            cand, probs = warped_candidates(logits, full(sp.temperature, torch.float32),
                                            full(sp.top_p, torch.float32), full(sp.top_k, torch.int32))
            kept = probs > 0
            tok = torch.tensor(ids, device=logits.device)
            inside = ((cand == tok[:, None]) & kept).any(dim=-1)
            # How far inside the pool each token lies: its logit above the
            # pool's smallest kept logit.
            edge = torch.where(kept, torch.gather(logits, 1, cand), torch.full_like(probs, float("inf")))
            margin = (picked - edge.min(dim=-1).values).min().item()
            sampled_margin = margin if sampled_margin is None else min(sampled_margin, margin)
            sampled_inside += int(inside.sum().item())
            sampled_outside += int((~inside).sum().item())
    if worst_deficit > tie:
        failures.append(f"a greedy token {worst_deficit:.4f} below its position's argmax (> {tie})")
    if plain_deficit > PLAIN_TIE:
        failures.append(f"serve's greedy token {plain_deficit:.4f} below its argmax (> PLAIN_TIE)")
    if worst_flip > PLAIN_TIE:
        failures.append(f"a stream leaves serve's with logits {worst_flip:.4f} apart (> PLAIN_TIE)")
    if not spec and differ:
        failures.append(f"{differ} plain greedy streams differ from serve's")
    if sampled_outside:
        failures.append(f"{sampled_outside} sampled tokens outside their warped pool")
    fields = dict(greedy_streams_compared=compared, greedy_streams_differing=differ,
                  greedy_max_argmax_deficit=worst_deficit, serve_max_argmax_deficit=plain_deficit,
                  serve_top2_gap_median=torch.cat(top2_gaps).median().item() if top2_gaps else None,
                  serve_logit_std_mean=torch.cat(stds).mean().item() if stds else None,
                  serve_mean_token_deficit_median=torch.cat(mean_deficits).median().item() if stds else None,
                  greedy_first_difference_logit_gap=worst_flip, sampled_tokens_in_pool=sampled_inside,
                  sampled_tokens_outside_pool=sampled_outside, sampled_min_margin_above_pool_edge=sampled_margin,
                  tie=tie, plain_tie=PLAIN_TIE, failures=failures)
    return fields


SPEC_COUNTERS = ("spec_rounds", "spec_tokens", "spec_proposed", "spec_accepted", "spec_fallbacks")


def _spec_metrics(base, sched) -> dict:
    """``/metrics``' engine_spec_* against the scheduler's Stats."""
    _, text = _get(base + "/metrics")
    series = {line.split()[0]: float(line.split()[1]) for line in text.splitlines()
              if line.startswith("engine_spec_")}
    snap = sched.stats.snapshot()
    names = {f"engine_spec_{k[5:]}_total": k for k in SPEC_COUNTERS}
    names.update(engine_spec_acceptance_ewma="spec_acceptance_ewma", engine_spec_gamma="spec_gamma")
    if set(series) != set(names):
        raise AssertionError(f"/metrics engine_spec_* families {sorted(series)}")
    for name, key in names.items():
        if abs(series[name] - snap[key]) > 1e-3:
            raise AssertionError(f"/metrics {name} {series[name]} != Stats {key} {snap[key]}")
    if snap["spec_accepted"] > snap["spec_proposed"]:
        raise AssertionError(f"spec_accepted {snap['spec_accepted']} > spec_proposed {snap['spec_proposed']}")
    return series


def pinned_streams(sched, prompts, max_tokens: int):
    """Greedy streams of ``prompts`` (token ids) submitted to ``sched`` all
    at once, straight to the scheduler: ``({prompt: ids}, drafts
    accepted)``."""
    import queue

    from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
    from generativeaiexamples_tpu_torch.engine.scheduler import Request

    outs, done = {}, queue.Queue()
    accepted0 = sched.stats.snapshot()["spec_accepted"]
    sched.start()
    try:
        for ids in prompts:
            toks = outs.setdefault(tuple(ids), [])
            sched.submit(Request(token_ids=list(ids), sampling=SamplingParams(max_tokens=max_tokens, temperature=0.0),
                                 on_token=toks.append, on_done=done.put))
        reasons = [done.get(timeout=300) for _ in prompts]
    finally:
        sched.stop()
    if any(r not in ("length", "stop") for r in reasons) or not all(outs.values()):
        raise AssertionError(f"a pinned-lookahead request failed: {reasons}")
    return outs, sched.stats.snapshot()["spec_accepted"] - accepted0


def spec_step(torch, dev, _cuda, name, sched, cfg, params, prompts, serve, requests=("batch", "alone", "quote",
                                                                                    "sampled"), baseline=None):
    """Serve one step's requests through the engine front on ``sched``
    and read its streams, counters and launches (``baseline``: the plain
    step's fields in the same position, printed beside these)."""
    from generativeaiexamples_tpu_torch.engine.server import create_engine_app
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer

    tee = StreamTee(sched)
    server = create_engine_app(sched, get_tokenizer("llama3-8b"), "llama3-8b", "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    sched.start()
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _complete(base, prompts["warmup"], 4)
        tee.records.clear()
        n_ttft0 = len(sched.stats.ttft_recent)
        snap0 = sched.stats.snapshot()
        _cuda.reset_launch_counts()
        t_wall = time.perf_counter()
        fields = {}
        if "batch" in requests:
            workers, results = _concurrent(base, prompts["completions"])
            status, body = _post(base + "/v1/chat/completions", {
                "messages": [{"role": "user", "content": prompts["chat"]}], "max_tokens": 32,
                "temperature": 0, "stream": True})
            for w in workers:
                w.join(timeout=900)
            if status != 200 or len(results) != len(prompts["completions"]):
                raise AssertionError(f"{name}: a batch request failed ({status})")
            fields["wall_s"] = time.perf_counter() - t_wall
            snap1 = sched.stats.snapshot()
            decode_tokens = (snap1["tokens_total"] - snap0["tokens_total"]) - (snap1["requests_total"]
                                                                               - snap0["requests_total"])
            decode_s = snap1["decode_s"] - snap0["decode_s"]
            ttfts = sorted(list(sched.stats.ttft_recent)[n_ttft0:])
            chunks = snap1["decode_chunks"] - snap0["decode_chunks"]
            # A late arrival waits out the running decode chunk: its ms
            # (plain: decode_chunk_size steps; spec: ceil(chunk / (gamma +
            # 1)) rounds) sets the batch's TTFT.
            fields.update(ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3,
                          ttft_ms=[t * 1e3 for t in ttfts],
                          decode_tokens_per_s=decode_tokens / decode_s if decode_s else None,
                          decode_chunks=chunks, decode_chunk_ms=decode_s / chunks * 1e3 if chunks else None,
                          serve_decode_tokens_per_s=serve["decode_tokens_per_s"], serve_wall_s=serve["wall_s"],
                          serve_ttft_p50_ms=serve["ttft_p50_ms"])
            if baseline is not None:
                fields.update({f"plain_{k}": baseline[k] for k in ("decode_tokens_per_s", "ttft_p50_ms", "wall_s",
                                                                    "decode_chunk_ms")})
                fields["vs_plain_decode_tokens_per_s"] = fields["decode_tokens_per_s"] / baseline["decode_tokens_per_s"]
        alone = (20, 650) if "alone" in requests else (20,) if "alone20" in requests else ()
        for n in alone:
            _complete(base, prompts["completions"][prompts["lengths"].index(n)])
        if "quote" in requests:
            _complete(base, quote_prompt())
        if "sampled" in requests:
            status, body = _post(base + "/v1/completions", {"prompt": prompts["chat"], **SPEC_SAMPLED})
            if status != 200:
                raise AssertionError(f"{name}: the sampled request failed: {status} {body[:200]}")
        launches = dict(_cuda.LAUNCHES)
        flash_hd = dict(_cuda.FLASH_HD_LAUNCHES)
        snap = sched.stats.snapshot()
        series = _spec_metrics(base, sched)
        delta = {k: snap[k] - snap0[k] for k in SPEC_COUNTERS}
        fields.update(
            spec=delta, spec_gamma=snap["spec_gamma"], spec_acceptance_ewma=snap["spec_acceptance_ewma"],
            acceptance=delta["spec_accepted"] / delta["spec_proposed"] if delta["spec_proposed"] else None,
            tokens_per_target_forward=delta["spec_tokens"] / delta["spec_rounds"] if delta["spec_rounds"] else None,
            metrics_equal_stats=True, engine_spec_series=series, launches=launches, flash_hd_launches=flash_hd,
            requests=len(tee.records),
        )
        return tee.records, fields
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=30)


def spec_accept_round(torch, dev, cfg, params, prompt_ids) -> dict:
    """Speculation rounds at full width whose drafts stand, on both
    layouts, through the n-gram chunk functions with the drafts planted in
    the token history (random weights accept ~nothing on their own).

    Two rows hold the same prompt.  Row 0 proposes the target's own greedy
    continuation and must emit gamma + 1 tokens, the drafts and a bonus;
    row 1 proposes it with its third draft replaced and must emit 3, the
    first two drafts and the target's own third (the rejected tail's KV is
    written and must be overwritten).  The chunk runs a second round from
    each row's new length.  The continuation starts as the teacher-forced
    argmax and is corrected, one position per try, where the verify pass
    picks another token.  Readings: the corrections needed, each emitted
    token's deficit below its teacher-forced argmax, the verify pass's
    logits against the teacher-forced ones, paged against contiguous.
    Returns the readings with ``failures``."""
    from generativeaiexamples_tpu_torch.engine import spec_decode
    from generativeaiexamples_tpu_torch.engine.decode import _append_buffer
    from generativeaiexamples_tpu_torch.models import llama

    g, b, max_len, pt = SPEC_GAMMA, 2, 512, 64
    ids = list(prompt_ids)
    n = len(ids)
    failures = []
    cache = llama.init_kv_cache(cfg, b, max_len, device=dev)
    with torch.inference_mode():
        hidden, _ = llama.forward(params, cfg, torch.tensor([ids] * b, device=dev),
                                  torch.arange(n, dtype=torch.int32, device=dev).repeat(b, 1), cache,
                                  torch.full((b,), n, dtype=torch.int32, device=dev), cold_prefill=True)
        tok0 = int(llama.logits(params, hidden[:1, -1:])[0, 0].argmax())
    stream = [tok0]
    for _ in range(g):
        stream.append(int(teacher_forced_logits(torch, cfg, params, ids, stream + [0])[-1].argmax()))
    leaves, table = paged_mirror(torch, cache, [max_len] * b, pt, torch.Generator().manual_seed(6))
    layouts = {"contiguous": (spec_decode.make_ngram_spec_chunk_fn(cfg, max_len, 2), cache, None),
               "paged": (spec_decode.make_paged_ngram_spec_chunk_fn(cfg, max_len, pt, 2), leaves, table)}
    tok = torch.full((b,), tok0, dtype=torch.int32, device=dev)
    lengths = torch.full((b,), n, dtype=torch.int32, device=dev)
    greedy = (torch.zeros(b, device=dev), torch.ones(b, device=dev), torch.zeros(b, dtype=torch.int32, device=dev))
    # The planted bigram (the prompt's last token, tok0) and its
    # continuation end before the prompt's last token: the latest match.
    p = n - g - 2

    def planted(rows):
        hist = torch.tensor([ids + [0] * (max_len - n)] * b, dtype=torch.int32, device=dev)
        for r, drafts in enumerate(rows):
            hist[r, p - 1:p + g + 1] = torch.tensor([ids[-1], tok0] + drafts, dtype=torch.int32, device=dev)
        return hist

    def run(layout, rows, n_rounds):
        fn, base, tbl = layouts[layout]
        c = tuple(x.clone() for x in base)
        hist = planted(rows)
        with_tok = hist.clone()
        with_tok[:, n] = tok0
        proposed = spec_decode._ngram_drafts(with_tok, tok, lengths, max_len, g, 2).tolist()
        if proposed != rows:
            raise AssertionError(f"spec_accept: the history proposes {proposed}, not the planted {rows}")
        args = (tok, lengths, torch.Generator(device=dev).manual_seed(0), *greedy, n_rounds, g, max_len, False)
        with torch.inference_mode():
            out = fn(params, c, tbl, hist, *args) if tbl is not None else fn(params, c, hist, *args)
        return out[2].tolist(), out[3].tolist()

    drafts, corrected = stream[1:], []
    for _ in range(g + 1):
        outs, n_emit = run("contiguous", [drafts, drafts], 1)
        a = n_emit[0][0] - 1
        if a == g:
            break
        corrected.append(a)
        drafts = drafts[:a] + [outs[0][0][a]] + drafts[a + 1:]
    wrong = drafts[:2] + [(drafts[2] + 1) % cfg.vocab_size] + drafts[3:]
    got = {layout: run(layout, [drafts, wrong], 2) for layout in layouts}
    outs, n_emit = got["contiguous"]
    bonus, next0, next1 = outs[0][0][g], outs[1][0][0], outs[1][1][0]
    if n_emit[0] != [g + 1, 3]:
        failures.append(f"round 1 emitted {n_emit[0]} tokens, not [{g + 1}, 3]")
    if outs[0][0][:g] != drafts or outs[0][1][:3] != drafts[:3]:
        failures.append(f"round 1 emitted {outs[0]}, drafts {drafts}")
    if got["paged"] != got["contiguous"]:
        failures.append(f"paged {got['paged']} != contiguous {got['contiguous']}")
    # Teacher-forced logits along row 0's stream: row k predicts its k-th
    # token, so rows 1..g hold the drafts', g + 1 the bonus', g + 2 the
    # second round's; row 1's second round predicts d_4 (row 4).
    full = [tok0] + drafts + [bonus, next0]
    tf = teacher_forced_logits(torch, cfg, params, ids, full)
    top = tf.max(dim=-1).values
    deficits = [(top[k] - tf[k, full[k]]).item() for k in range(len(full))]
    deficits.append((top[4] - tf[4, next1]).item())
    # The verify pass's own logits over row 0's round against the
    # teacher-forced ones (the same positions).
    c = tuple(x.clone() for x in cache)
    ab = _append_buffer(cfg, 1, g + 1, dev)
    with torch.inference_mode():
        vh, _, ab = llama.forward(params, cfg, torch.tensor([full[:g + 1]], device=dev),
                                  torch.arange(n, n + g + 1, dtype=torch.int32, device=dev)[None],
                                  tuple(x[:, :, :1] for x in c), lengths[:1], kv_bucket=max_len,
                                  append_cache=(ab, 0))
        vlogits = llama.logits(params, vh)[0].float()
    logit_diff = (vlogits - tf[1:g + 2]).abs().max().item()
    if logit_diff > VERIFY_LOGIT_TOL:
        failures.append(f"the verify logits {logit_diff:.4f} from the teacher-forced ones (> VERIFY_LOGIT_TOL)")
    if max(deficits) > SPEC_TIE:
        failures.append(f"an emitted token {max(deficits):.4f} below its teacher-forced argmax (> SPEC_TIE)")
    return dict(prompt_tokens=n, drafts=drafts, corrections_at=corrected, n_emit=n_emit, outs=outs,
                verify_logit_tol=VERIFY_LOGIT_TOL,
                paged_equal=got["paged"] == got["contiguous"], row1_round2_is_d4=next1 == drafts[3],
                max_token_deficit=max(deficits), token_deficits=deficits,
                verify_vs_teacher_forced_max_abs_logit_diff=logit_diff, failures=failures)


def time_verify_attention(torch, dev, k2_ms: float) -> dict:
    """The verify pass's attention for one layer at B=32, S=5 (gamma 4),
    32/8 heads, window 1024 on a cache of 2048, timed as a CUDA-graph
    replay and eagerly, beside its byte bound (the int8 K/V window and
    its scales, q, the buffer and the output, over the card's memory
    rate) and K2's S=1 time at the same window."""
    from generativeaiexamples_tpu_torch.ops import decode_attention as da

    b, s, kh, g, hd, t, window, n_layers = 32, SPEC_GAMMA + 1, 8, 4, 128, 2048, 1024, 2
    gen = torch.Generator(device=dev).manual_seed(8)
    nv = 2

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)

    def sc(*shape):
        return (torch.rand(shape, generator=gen, device=dev) * 0.02 + 0.01).to(torch.bfloat16)

    caches = [(i8(n_layers, kh, b, t, hd), i8(n_layers, kh, b, t, hd), sc(n_layers, kh, b, t), sc(n_layers, kh, b, t))
              for _ in range(nv)]
    blocks = [(i8(n_layers, kh, b, s, hd), i8(n_layers, kh, b, s, hd), sc(n_layers, kh, b, s), sc(n_layers, kh, b, s))
              for _ in range(nv)]
    qs = [torch.randn(b, s, kh * g, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(nv)]
    lengths = torch.full((b,), window - s, dtype=torch.int32, device=dev)

    def fn(i):
        return da.verify_gqa_attention(qs[i], *caches[i], 1, lengths, blocks[i], window=window)

    out = fn(0)
    if not torch.isfinite(out.float()).all():
        raise AssertionError("verify attention: non-finite output")
    ms = time_ms(fn, nv, 10, graph=True)
    eager_ms = time_ms(fn, nv, 10)
    nbytes = b * kh * window * (2 * hd + 2 * 2) + b * kh * s * (2 * hd + 2 * 2) + 2 * b * s * kh * g * hd * 2 + b * 4
    b_ms, b_by = bound(nbytes, 4.0 * b * kh * g * s * (window + s) * hd, BF16_FLOPS)
    del caches, blocks
    return dict(b=b, s=s, n_q=kh * g, n_kv=kh, window=window, ms=ms, eager_ms=eager_ms, bound_ms=b_ms, bound_by=b_by,
                bound_share=b_ms / ms, k2_s1_ms=k2_ms, vs_k2=ms / k2_ms)


def spec_phase(torch, dev, _cuda, cfg, params, prompts, serve, k2_ms: float) -> dict:
    """Speculative decoding through the engine server's flags, Llama-3-8B
    W8A8 at full width and depth (the ``serve`` params), gamma 4:
    ``spec_plain`` (a plain scheduler: the same-position baseline),
    ``spec_ngram`` (``--spec-decode``, contiguous), ``spec_draft``
    (``--spec-decode --draft-model llama3.2-1b``, paged, page 64),
    ``spec_self`` (the target's first 4 layers as the draft, contiguous),
    ``spec_fault`` (``spec_draft:error=1`` on the n-gram scheduler) and
    ``spec_accept`` (:func:`spec_accept_round`).  Returns each step's
    launches by kernel and K4's head_dim-64 launches in ``spec_draft``."""
    from generativeaiexamples_tpu_torch.engine import spec_decode
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import parse_args, spec_scheduler_kwargs
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.obs.tsdb import Tsdb
    from generativeaiexamples_tpu_torch.resilience.faults import get_fault_injector, reset_faults

    t_phase = time.perf_counter()
    emit("spec_verify_attention", **time_verify_attention(torch, dev, k2_ms))
    streams = serve["streams"]
    out, greedy, accepted = {}, {}, {}

    def run(name, sched, requests=("batch", "alone", "quote", "sampled"), baseline=None, spec=True):
        t0 = time.perf_counter()
        records, fields = spec_step(torch, dev, _cuda, name, sched, cfg, params, prompts, serve, requests, baseline)
        gates = check_spec_streams(torch, cfg, params, records, streams, spec=spec)
        greedy[name] = {prompt: ids for prompt, sp, ids in records if sp.temperature <= 0.0}
        accepted[name] = fields["spec"]["spec_accepted"]
        launches = fields["launches"]
        failures = gates.pop("failures")
        decode = ("decode_attention", "paged_decode_attention")
        if not launches["qmm"] or not launches["flash_attention"]:
            failures.append(f"K1 and K4 must launch: {launches}")
        if spec and any(launches[k] for k in decode):
            failures.append(f"K2/K3 launched on a speculating path: {launches}")
        if not spec and not launches["decode_attention"]:
            failures.append(f"K2 did not launch on the plain path: {launches}")
        if bool(fields["spec"]["spec_rounds"]) != spec:
            failures.append(f"speculation rounds {fields['spec']['spec_rounds']}")
        emit(name, gamma_max=SPEC_GAMMA, step_s=time.perf_counter() - t0, **gates, **fields)
        if failures:
            raise AssertionError(f"{name}: {failures}")
        out[name] = launches
        return fields

    # The bit-for-bit comparison runs at one pinned lookahead (F5): the
    # adaptive runs' gamma follows the most hopeful active lane, and which
    # lanes are active follows when the HTTP requests arrive.
    tok = get_tokenizer("llama3-8b")
    pinned_prompts = [tok.encode(p) for p in prompts["completions"][:SPEC_PINNED_PROMPTS]]
    pinned, pinned_accepted, pinned_s = {}, {}, {}

    def run_pinned(name, **kw):
        t0 = time.perf_counter()
        sched = Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8", gamma=SPEC_GAMMA,
                          adaptive_gamma=False, **kw)
        try:
            pinned[name], pinned_accepted[name] = pinned_streams(sched, pinned_prompts, SPEC_PINNED_TOKENS)
        finally:
            sched._cache = sched._pool = sched._dcache = sched._dhist = None
            pinned_s[name] = time.perf_counter() - t0

    # The baseline: a plain scheduler in the same position of the run.
    plain = Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8", **serve_kw("contiguous"))
    try:
        baseline = run("spec_plain", plain, ("batch",), spec=False)
    finally:
        plain._cache = None
    gc.collect()
    torch.cuda.empty_cache()

    # --spec-decode alone: prompt lookup, through the front's args mapping.
    kw = spec_scheduler_kwargs(parse_args(["--spec-decode", "--gamma", str(SPEC_GAMMA)]), cfg, dev)
    if kw != {"spec_mode": "ngram", "gamma": SPEC_GAMMA}:
        raise AssertionError(f"--spec-decode mapped to {kw}")
    ngram = Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8", **serve_kw("contiguous"), **kw)
    try:
        run("spec_ngram", ngram, baseline=baseline)
        # The fault: every tick degrades to the plain chunk (K2), so the
        # stream is serve's bit for bit.
        snap0 = ngram.stats.snapshot()
        get_fault_injector().install("spec_draft", error_rate=1.0)
        try:
            records, fields = spec_step(torch, dev, _cuda, "spec_fault", ngram, cfg, params, prompts, serve,
                                        ("alone20",))
        finally:
            reset_faults()
        snap = ngram.stats.snapshot()
        prompt20 = next(r for r in records if len(r[0]) == 20)
        if prompt20[2] != streams[prompt20[0]]:
            raise AssertionError("spec_fault: the degraded stream differs from serve's")
        if not snap["spec_fallbacks"] > snap0["spec_fallbacks"] or snap["spec_rounds"] != snap0["spec_rounds"]:
            raise AssertionError(f"spec_fault: fallbacks {snap['spec_fallbacks']}, rounds {snap['spec_rounds']}")
        if not all(fields["launches"][k] for k in ("qmm", "decode_attention", "flash_attention")):
            raise AssertionError(f"spec_fault: K1, K4 and the plain chunk's K2 must launch: {fields['launches']}")
        emit("spec_fault", stream_equal_to_serve=True, fallbacks=snap["spec_fallbacks"] - snap0["spec_fallbacks"],
             spec_rounds=snap["spec_rounds"] - snap0["spec_rounds"], launches=fields["launches"])
        out["spec_fault"] = fields["launches"]
    finally:
        ngram._cache = ngram._dhist = None
    gc.collect()
    torch.cuda.empty_cache()
    run_pinned("spec_ngram", **serve_kw("contiguous"), spec_mode="ngram")

    with _PresetDepth("llama3.2-1b", SPEC_DRAFT_LAYERS):
        kw = spec_scheduler_kwargs(
            parse_args(["--spec-decode", "--draft-model", "llama3.2-1b", "--gamma", str(SPEC_GAMMA),
                        "--matmul-kernel", "pallas_w8a8"]), cfg, dev)
    draft = Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8", **serve_kw("paged"), **kw)
    try:
        fields = run("spec_draft", draft, baseline=baseline)
        hd64 = fields["flash_hd_launches"][64]
        if not hd64:
            raise AssertionError(f"spec_draft: K4 never launched at head_dim 64: {fields['flash_hd_launches']}")
        draft_kw = dict(draft_cfg=draft.draft_cfg, draft_params=draft.draft_params)
        draft._cache = draft._pool = draft._dcache = draft.draft_params = None
        gc.collect()
        torch.cuda.empty_cache()
        run_pinned("spec_draft", **serve_kw("paged"), **draft_kw)
    finally:
        draft._cache = draft._pool = draft._dcache = draft.draft_params = None
    del kw, draft_kw
    gc.collect()
    torch.cuda.empty_cache()

    dcfg, dparams = spec_decode.self_draft(cfg, params, SPEC_SELF_LAYERS)
    selfd = Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8", **serve_kw("contiguous"),
                      draft_cfg=dcfg, draft_params=dparams,
                      gamma=SPEC_GAMMA)
    try:
        run("spec_self", selfd, ("batch",), baseline=baseline)
    finally:
        selfd._cache = selfd._dcache = None
    gc.collect()
    torch.cuda.empty_cache()
    run_pinned("spec_self", **serve_kw("contiguous"), draft_cfg=dcfg, draft_params=dparams)

    # One verify math, three drafts and two layouts.  Pinned steps that
    # accepted no draft ran every round at slot 0 with the same lookahead,
    # so their greedy streams must be equal bit for bit; a token a step
    # emitted from a later slot of a round (an accepted draft or its bonus)
    # went through other shapes and may flip a near tie there.  The
    # adaptive runs' lookahead follows the arrival order of their requests,
    # so they part from each other only within SPEC_TIE.
    same = {}
    for kind, streams_of, accepted_of in (("pinned", pinned, pinned_accepted), ("adaptive", greedy, accepted)):
        for name in ("spec_draft", "spec_self"):
            exact = kind == "pinned" and not (accepted_of[name] or accepted_of["spec_ngram"])
            common = [prompt for prompt in streams_of[name] if prompt in streams_of["spec_ngram"]]
            gaps = []
            for prompt in common:
                ids, ref = streams_of[name][prompt], streams_of["spec_ngram"][prompt]
                j = next((i for i in range(min(len(ids), len(ref))) if ids[i] != ref[i]), None)
                if j is None:
                    continue
                logits = teacher_forced_logits(torch, cfg, params, prompt, ids[:j + 1])
                gaps.append(abs(logits[j, ids[j]].item() - logits[j, ref[j]].item()))
            same[f"{kind}_{name}"] = dict(compared=len(common), differing=len(gaps), must_be_equal=exact,
                                          first_difference_logit_gaps=gaps, accepted=accepted_of[name],
                                          ngram_accepted=accepted_of["spec_ngram"])
            if not common or (exact and gaps) or any(gap > SPEC_TIE for gap in gaps):
                raise AssertionError(f"{kind} {name}: greedy streams against spec_ngram's: {same[f'{kind}_{name}']}")

    accept = spec_accept_round(torch, dev, cfg, params, get_tokenizer("llama3-8b").encode(prompts["chat"]))
    failures = accept.pop("failures")
    emit("spec_accept", gamma=SPEC_GAMMA, spec_tie=SPEC_TIE, **accept)
    if failures:
        raise AssertionError(f"spec_accept: {failures}")
    emit("spec", seconds=time.perf_counter() - t_phase, steps=list(out), streams_equal_to_spec_ngram=same,
         pinned_lookahead_s=pinned_s)
    return out, hd64


PROFILE_STEPS, PROFILE_LENGTH, PROFILE_WINDOW = 8, 512, 1024
# Device-side names of the port's kernel functions (torch.profiler keys).
PORT_KERNEL_NAMES = ("qmm_decode", "qmm_wide", "decode_kernel", "flash_kernel")


def decode_chunk(torch, dev, sched):
    """One decode chunk of PROFILE_STEPS steps with every lane live at
    PROFILE_LENGTH, as a closure over fixed inputs.  On the paged layout
    every lane first takes private pages for its window."""
    b = sched.max_batch
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, sched.cfg.vocab_size, (b,), device=dev, generator=gen, dtype=torch.int32)
    lengths = torch.full((b,), PROFILE_LENGTH, dtype=torch.int32, device=dev)
    temp = torch.zeros(b, device=dev)
    top_p = torch.ones(b, device=dev)
    top_k = torch.zeros(b, dtype=torch.int32, device=dev)
    cache_args: tuple = (sched._cache,)
    if sched._pool is not None:
        for i in range(b):
            sched._pool.make_writable(i, 0, PROFILE_LENGTH + PROFILE_STEPS + 1)
        cache_args = (sched._cache, sched._pool.device_table())

    def chunk():
        with torch.inference_mode():
            return sched._decode_chunk(sched.params, *cache_args, tokens, lengths, gen, temp, top_p, top_k,
                                       PROFILE_STEPS, PROFILE_WINDOW)

    return chunk


def time_chunk(torch, chunk) -> dict:
    """One warm-up call, then one call timed by host clock (dispatch, and
    wall to the end of its device work) and by CUDA events."""
    chunk()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    chunk()
    host_ms = (time.perf_counter() - t0) * 1e3  # dispatch time: the host's share
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    span_ms = start.elapsed_time(end)
    return dict(host_dispatch_ms=host_ms, wall_ms=wall_ms, event_span_ms=span_ms,
                ms_per_step=span_ms / PROFILE_STEPS)


def device_ms_by_name(prof) -> dict:
    """Device ms by kernel name from a torch.profiler trace (kernel-level
    events only: an operator's device time is its kernels')."""
    from torch.autograd import DeviceType

    by_name: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0.0)
        if dt:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + dt / 1e3
    return by_name


def profile_embed(torch, dev, embedder) -> None:
    """Where a 32 x 512 arctic-embed-l forward's time goes: one forward
    traced with torch.profiler, device ms by kernel name (top ten) and the
    busy share of the traced call's CUDA-event span."""
    from torch.profiler import ProfilerActivity, profile

    from generativeaiexamples_tpu_torch.models import bert

    gen = torch.Generator(device=dev).manual_seed(7)
    tokens = torch.randint(0, 256, (32, 512), device=dev, generator=gen)
    mask = torch.ones_like(tokens)
    with torch.inference_mode():
        bert.embed(embedder.params, embedder.cfg, tokens, mask)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            bert.embed(embedder.params, embedder.cfg, tokens, mask)
            end.record()
            end.synchronize()
    span_ms = start.elapsed_time(end)
    by_name = device_ms_by_name(prof)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    emit("profile_embed", what="one arctic-embed-l forward, 32 x 512, bf16, 24 layers", traced_device_ms=device_ms,
         traced_event_span_ms=span_ms, device_busy_share=device_ms / span_ms if span_ms else None,
         top_kernels_ms={k[:80]: v for k, v in top})


def profile_decode(torch, dev, cfg, params, kv_layout: str, timing: dict) -> None:
    """Where a decode chunk's time goes, on a fresh scheduler of one layout:
    the chunk traced with torch.profiler (device time by kernel name), with
    the busy share taken as the traced call's device time over that same
    call's CUDA-event span.  ``timing`` is the chunk timed untraced after
    the serve, before any trace of the run: a trace leaves the process's
    later host work slower (``PERF.md``, PR 2 run 5)."""
    from torch.profiler import ProfilerActivity, profile

    sched = make_scheduler(cfg, params, dev, kv_layout)
    try:
        chunk = decode_chunk(torch, dev, sched)
        chunk()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            chunk()
            end.record()
            end.synchronize()
    finally:
        sched._cache = sched._pool = None
    traced_span_ms = start.elapsed_time(end)
    by_name = device_ms_by_name(prof)
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # The port's own kernels, by name, whether or not they are in the top ten.
    port = {k[:80]: v for k, v in by_name.items() if any(n in k for n in PORT_KERNEL_NAMES)}
    emit(
        "profile_paged" if kv_layout == "paged" else "profile",
        what=f"one decode chunk, {PROFILE_STEPS} steps, batch {sched.max_batch} all live at {PROFILE_LENGTH}, "
             f"window {PROFILE_WINDOW}",
        **timing, traced_device_ms=device_ms, traced_event_span_ms=traced_span_ms,
        device_busy_share=device_ms / traced_span_ms if traced_span_ms else None,
        top_kernels_ms={k[:80]: v for k, v in top}, port_kernels_ms=port,
        decode_attention_ms_per_step=sum(v for k, v in port.items() if "decode_kernel" in k) / PROFILE_STEPS,
    )


# ---------------------------------------------------------------------------
# the chain server: /documents -> /search -> /generate over Llama-3-8B
# ---------------------------------------------------------------------------

CHAIN_SHORT_DOCS, CHAIN_LONG_DOCS, CHAIN_SEARCHES, CHAIN_CONCURRENT_GEN = 64, 4, 16, 8
# Short documents stay under 350 bytes, so a prompt of the RAG template
# and four of them fits the engine's 2,039-token bound (byte tokens).
CHAIN_SHORT_BYTES, CHAIN_LONG_BYTES, CHAIN_GEN_TOKENS = (200, 350), 6000, 32
CHAIN_WORDS = ("cache", "vector", "search", "engine", "token", "layer", "kernel", "batch", "store", "query",
               "answer", "prompt", "device", "memory", "stream", "server", "index", "rank", "score", "model")


def _chain_text(rng, n_bytes: int) -> str:
    out = ""
    while len(out) < n_bytes:
        out += " ".join(rng.choice(CHAIN_WORDS, int(rng.integers(4, 12)))) + ". "
    return out[:n_bytes].strip()


def _upload(base, name: str, text: str) -> float:
    """POST one text document as multipart/form-data; returns its ms."""
    return _upload_bytes(base, name, text.encode())


def _upload_bytes(base, name: str, data: bytes) -> float:
    """POST one document's bytes as multipart/form-data; returns its ms."""
    boundary = "chainSmokeBoundary"
    body = (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="{name}"\r\n'
            f"Content-Type: application/octet-stream\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    t0 = time.perf_counter()
    status, _, raw = _http("POST", base + "/documents", body,
                           {"Content-Type": f"multipart/form-data; boundary={boundary}"})
    if status != 200:
        raise AssertionError(f"upload of {name} failed: {status} {raw[:300]!r}")
    return (time.perf_counter() - t0) * 1e3


def _generate(base, query: str, kb: bool = True, max_tokens: int = CHAIN_GEN_TOKENS, headers=None,
              collection: str = "") -> dict:
    """One streamed /generate: status, text, ms to the first ``data:`` line
    and to the end, ms between successive ``data:`` lines, the [DONE]
    chunk and the response headers (an error status: its body)."""
    body = {"messages": [{"role": "user", "content": query}], "use_knowledge_base": kb, "temperature": 0,
            "max_tokens": max_tokens, "collection": collection}
    req = urllib.request.Request(base + "/generate", json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    try:
        resp = urllib.request.urlopen(req, timeout=600)
    except urllib.error.HTTPError as exc:
        return dict(status=exc.code, body=exc.read(), headers=exc.headers)
    chunks, arrivals = [], []
    with resp:
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if line.startswith("data: "):
                arrivals.append(time.perf_counter())
                chunks.append(json.loads(line[6:]))
    wall_ms = (time.perf_counter() - t0) * 1e3
    if not chunks or chunks[-1]["choices"][0]["finish_reason"] != "[DONE]" or not chunks[-1]["id"]:
        raise AssertionError(f"chain: /generate did not end with a [DONE] chunk of this stream: {chunks[-1:]}")
    pieces = [c["choices"][0]["message"]["content"] for c in chunks[:-1]]
    return dict(status=resp.status, text="".join(pieces), pieces=pieces, done=chunks[-1],
                ttft_ms=(arrivals[0] - t0) * 1e3, wall_ms=wall_ms, headers=resp.headers, arrivals=arrivals,
                gaps_ms=[(b - a) * 1e3 for a, b in zip(arrivals, arrivals[1:])])


def _search(base, query: str, top_k: int, request_id: str = "") -> list:
    """One /search: its chunks.  Fails unless it is a 200 that no rung of
    the degradation ladder served.  ``request_id`` goes out as
    ``X-Request-Id``, which names the request's trace in /debug/requests."""
    headers = {"X-Request-Id": request_id} if request_id else None
    status, _, raw = _http("POST", base + "/search", {"query": query, "top_k": top_k}, headers=headers)
    body = json.loads(raw) if status == 200 else {}
    if status != 200 or body["degraded"]:
        raise AssertionError(f"chain: /search {query!r}: {status} {raw[:300]!r}")
    return body["chunks"]


def _server_timing(header: str) -> dict:
    """Server-Timing ``name;dur=ms`` entries, summed by name."""
    out: dict = {}
    for part in (header or "").split(","):
        name, _, dur = part.strip().partition(";dur=")
        if name and dur:
            out[name] = out.get(name, 0.0) + float(dur)
    return out


def _pct(values, q: float) -> float:
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]


def _same_as_engine(base, llm, sched, received, ids_by_request, query, kb=True, collection="", where="chain"):
    """One greedy /generate (prefix cache off, so it and the direct
    submission prefill alike) whose streamed token ids must equal the
    engine's for the same chat-templated prompt ids submitted directly to
    the scheduler, and whose streamed pieces the engine's text.
    ``received`` and ``ids_by_request`` are filled by recording wrappers
    of ``GPUChatLLM.stream`` and the scheduler's ``submit``.  Returns
    (response, the messages the LLM received, prompt ids, token ids)."""
    from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
    from generativeaiexamples_tpu_torch.engine.scheduler import Request
    from generativeaiexamples_tpu_torch.engine.tokenizer import decode_stream
    from generativeaiexamples_tpu_torch.server.schema import sanitize

    sched.prefix_cache = "off"
    try:
        received.clear()
        ids_by_request.clear()
        res = _generate(base, query, kb=kb, collection=collection)
        if res["status"] != 200 or res["done"]["degraded"] or len(received) != 1:
            raise AssertionError(f"{where}: the gate's /generate failed or degraded: {res.get('done', res)}")
        streamed_ids = list(ids_by_request.values())
        messages = received[-1]
        ids = llm.tokenizer.apply_chat_template(messages)
        tokens, done = [], []
        sched.submit(Request(token_ids=list(ids), sampling=SamplingParams(temperature=0.0, top_p=0.7,
                             max_tokens=CHAIN_GEN_TOKENS), on_token=tokens.append, on_done=done.append,
                             eos_id=llm.tokenizer.eos_id, id=f"{where}-direct"))
        t0 = time.perf_counter()
        while not done and time.perf_counter() - t0 < 300:
            time.sleep(0.01)
    finally:
        sched.prefix_cache = "shared"
    if not done or done[0] not in ("stop", "length") or len(streamed_ids) != 1 or streamed_ids[0] != tokens:
        raise AssertionError(f"{where}: gate 2: the stream's ids {streamed_ids} != the engine's {tokens} ({done})")
    # The engine's text as the server streams it: one chunk per non-empty
    # decoded piece, each sanitized as the reference's Message is (a piece
    # "<|id|>" of an id past the byte vocabulary becomes an empty chunk).
    piece = decode_stream(llm.tokenizer)
    direct = [p for p in [piece(t) for t in tokens] + [piece(0, final=True)] if p]
    if [sanitize(p) for p in direct] != res["pieces"]:
        raise AssertionError(f"{where}: gate 2: streamed {res['pieces']} != engine's {direct}")
    return res, messages, ids, tokens


def check_flash_long(torch, dev) -> dict:
    """K4 at the chain's prefill shape (RAG prompts of ~2k tokens, whole and
    cold) against its plain version within FLASH_TOL."""
    from generativeaiexamples_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(9)
    b, s, nq, nkv, hd = 2, 2048, 32, 8, 128
    q = torch.randn(b, s, nq, hd, device=dev, generator=gen).to(torch.bfloat16)
    k = torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16)
    lengths = torch.tensor([1931, 1702], dtype=torch.int32, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous()
    out = fa.flash_attention_cuda(q, k, v, pos, lengths)
    ref = fa.flash_gqa_attention_plain(q, k, v, pos, lengths)
    valid = pos < lengths[:, None]
    torch.testing.assert_close(out[valid], ref[valid], **FLASH_TOL)
    return dict(flash_s2048_max_abs_err=(out[valid].float() - ref[valid].float()).abs().max().item(),
                flash_s2048_tolerance_use=tolerance_use(out[valid], ref[valid], **FLASH_TOL))


def chain_phase(torch, dev, _cuda, smi: str) -> tuple[dict, dict]:
    """The chain server from ``APP_*`` defaults through ``create_app()``:
    Llama-3-8B W8A8 (random, seed 0) behind ``GPUChatLLM``, arctic-embed-l,
    the exact store, the result cache, no reranker.  Documents in over
    HTTP, searches against direct calls, /generate against the engine's
    own greedy text, concurrent streams, the other routes; then, on the
    same server, the bulk, collections, multi-turn and profiler steps.
    Returns the launches of the phase's own requests and, by step, those
    of the steps that launch kernels."""
    import shutil
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch.chains import factory
    from generativeaiexamples_tpu_torch.chains.developer_rag import QAChatbot
    from generativeaiexamples_tpu_torch.chains.llm import GPUChatLLM
    from generativeaiexamples_tpu_torch.core.configuration import get_config, reset_config_cache
    from generativeaiexamples_tpu_torch.obs.slo import slo_health
    from generativeaiexamples_tpu_torch.retrieval.base import Chunk, ScoredChunk
    from generativeaiexamples_tpu_torch.server.app import UPLOAD_DIR_ENV, create_app

    t_phase = time.perf_counter()
    fields = dict(nvidia_smi=smi, **check_flash_long(torch, dev))
    reset_config_cache()
    factory.reset_factories()
    cfg = get_config()
    os.environ[UPLOAD_DIR_ENV] = tempfile.mkdtemp(prefix="chain_uploads_")
    # The profiler routes are served when the server is built with the gate open.
    os.environ.update(GAIE_ENABLE_PROFILER="1", GAIE_PROFILER_DIR=tempfile.mkdtemp(prefix="chain_profile_"))
    t0 = time.perf_counter()
    server = create_app()
    torch.cuda.synchronize()
    fields["build_s"] = time.perf_counter() - t0
    llm, retriever, store = factory.peek_chat_llm(), factory.get_retriever(), factory.get_store()
    cache, batcher, splitter = factory.get_retrieval_cache(), factory.get_retrieval_batcher(), factory.get_splitter()
    sched = llm.scheduler
    if (not isinstance(llm, GPUChatLLM) or sched.device.type != "cuda" or retriever.reranker is not None
            or cache is None or batcher is None or type(store).__name__ != "GPUVectorStore"):
        raise AssertionError("chain: create_app() did not build the default chain on the card")
    fields.update(config="APP_* defaults", llm=f"{cfg.llm.model_name} -> llama3-8b W8A8, "
                  f"{sched.cfg.n_layers} layers, random int8, seed 0",
                  engine=dict(max_batch=sched.max_batch, max_len=sched.max_len,
                              decode_chunk_size=sched.decode_chunk_size,
                              prefill_chunk_tokens=sched.prefill_chunk_tokens, prefix_cache=sched.prefix_cache,
                              kv_layout=sched.kv_layout, max_prompt_len=sched.max_prompt_len),
                  embedder=f"arctic-embed-l, {retriever.embedder.cfg.n_layers} layers, random bf16, seed 0",
                  top_k=retriever.top_k, score_threshold=retriever.score_threshold,
                  device_gb_after_build=torch.cuda.memory_allocated(dev) / 1e9)
    # What GPUChatLLM.stream receives, recorded by wrapping the class's
    # method for this phase (the server has no hook of its own).
    received: list = []
    stream = GPUChatLLM.stream

    def recording_stream(self, messages, **kw):
        received.append(list(messages))
        return stream(self, messages, **kw)

    GPUChatLLM.stream = recording_stream
    # The token ids each request receives, by request id: the server's
    # streams and the direct submission go through the scheduler's submit.
    ids_by_request: dict = {}
    submit = sched.submit

    def recording_submit(req):
        on_token, got = req.on_token, ids_by_request.setdefault(req.id, [])
        req.on_token = lambda t: (got.append(int(t)), on_token(t))
        return submit(req)

    sched.submit = recording_submit

    def gate(query, **kw):
        """Gate 2: one greedy /generate whose streamed ids are the engine's
        for the same chat-templated prompt ids submitted directly."""
        return _same_as_engine(base, llm, sched, received, ids_by_request, query, **kw)

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(0)
    try:
        _cuda.reset_launch_counts()
        # 1. Ingest: 64 one-chunk documents and 4 of ~6 KB (token splitter
        # at 510/200: 508-token windows every 308 tokens).
        short = [_chain_text(rng, int(rng.integers(*CHAIN_SHORT_BYTES))) for _ in range(CHAIN_SHORT_DOCS)]
        long = [_chain_text(rng, CHAIN_LONG_BYTES) for _ in range(CHAIN_LONG_DOCS)]
        short_ms = [_upload(base, f"short{i}.txt", t) for i, t in enumerate(short)]
        long_ms = [_upload(base, f"long{i}.txt", t) for i, t in enumerate(long)]
        long_chunks = [len(splitter.split(t)) for t in long]
        rows = store.capacity_stats()["rows"]
        if rows != CHAIN_SHORT_DOCS + sum(long_chunks) or min(long_chunks) < 2:
            raise AssertionError(f"chain: {rows} rows after ingest, want {CHAIN_SHORT_DOCS} + {long_chunks}")
        fields.update(ingest_docs=len(short) + len(long), ingest_short_ms_per_doc=sum(short_ms) / len(short),
                      ingest_long_ms_per_doc=sum(long_ms) / len(long), long_doc_chunks=long_chunks,
                      store_rows_after_ingest=rows)

        # 2. /search, one query at a time, each on a cleared cache (random
        # embeddings lie within the semantic tier's 0.98 of each other),
        # against QAChatbot().document_search on a cleared cache and the
        # store's own threshold-filtered search.
        queries = [_chain_text(rng, int(rng.integers(30, 60))) for _ in range(CHAIN_SEARCHES)]
        k = retriever.top_k
        search_ms = []
        for q in queries:
            cache.clear()
            t0 = time.perf_counter()
            found = _search(base, q, k)
            search_ms.append((time.perf_counter() - t0) * 1e3)
            got = [(c["content"], c["filename"], c["score"]) for c in found]
            cache.clear()
            direct = [(h["content"], h["source"], h["score"]) for h in QAChatbot().document_search(q, k)]
            hits = store.search_batch(retriever.embedder.embed_queries([q]), k)[0]
            want = [(h.chunk.text, h.chunk.source, h.score) for h in hits if h.score >= retriever.score_threshold]
            if not got or got != direct or got != want:
                raise AssertionError(f"chain: /search {q!r}:\n{got}\n{direct}\n{want}")
        fields.update(searches=len(queries), search_ms_p50=_pct(search_ms, 0.5), search_ms_p95=_pct(search_ms, 0.95),
                      search_equal_to_direct_and_store=True)

        # 3. Deletes: the long documents go (their chunks would not fit a
        # prompt beside the template: 4 x 508 tokens), and are no longer
        # searched.
        probe = None
        for q in queries:  # a query whose top 25 holds long-document chunks
            cache.clear()
            if any(c["filename"].startswith("long") for c in _search(base, q, 25)):
                probe = q
                break
        for i in range(CHAIN_LONG_DOCS):
            status, _, raw = _http("DELETE", base + f"/documents?filename=long{i}.txt")
            if status != 200:
                raise AssertionError(f"chain: DELETE long{i}.txt: {status} {raw[:200]!r}")
        _, _, raw = _http("GET", base + "/documents")
        listed = json.loads(raw)["documents"]
        cache.clear()
        after = _search(base, probe or queries[0], 25)
        if any(n.startswith("long") for n in listed) or len(listed) != CHAIN_SHORT_DOCS or probe is None or any(
                c["filename"].startswith("long") for c in after):
            raise AssertionError(f"chain: deletes not honoured (probe {probe is not None}, listed {len(listed)})")
        fields.update(deleted_docs=CHAIN_LONG_DOCS, store_rows_after_delete=store.capacity_stats()["rows"])

        # 4. /generate, knowledge base on, greedy, 32 tokens.  Gate 1: the
        # system turn is the RAG template over the hits /search gave.  Gate
        # 2: the token ids the server's stream received are the engine's
        # for the same chat-templated ids submitted directly, and so is the
        # streamed text.  The prefix cache is off for the gate, so both go
        # through the same cold prefill.
        q = _chain_text(rng, 50)
        cache.clear()
        hits = _search(base, q, k)
        res, messages, ids, tokens = gate(q)
        context = retriever.build_context(
            [ScoredChunk(Chunk(text=h["content"], source=h["filename"]), h["score"]) for h in hits])
        if messages[0] != ("system", cfg.prompts.rag_template.format(context=context)) or (
                messages[-1] != ("user", q)) or res["done"]["cache_tier"] != "exact":
            raise AssertionError(f"chain: gate 1: the retrieved context did not reach the prompt ({res['done']})")
        fields.update(gate_prompt_tokens=len(ids), gate_hits=len(hits), gate_context_chars=len(context),
                      gate_ttft_ms=res["ttft_ms"], gate_wall_ms=res["wall_ms"], gate_tokens=len(tokens),
                      gate_text=res["text"], gate_byte_tokens=sum(t < llm.tokenizer.vocab_size for t in tokens),
                      context_in_prompt=True, answer_ids_equal_to_engine=True, answer_equal_to_engine=True)

        # 5. Concurrent streams: 8 with the knowledge base on (fresh
        # queries, a cleared cache), then one with it off.
        cache.clear()
        snap0, rag0 = sched.stats.snapshot(), batcher.stats.snapshot()
        gen_queries = [_chain_text(rng, int(rng.integers(30, 60))) for _ in range(CHAIN_CONCURRENT_GEN)]
        results: dict = {}
        received.clear()

        def one(i):
            results[i] = _generate(base, gen_queries[i])

        workers = [threading.Thread(target=one, args=(i,)) for i in range(CHAIN_CONCURRENT_GEN)]
        t_wall = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
        wall = time.perf_counter() - t_wall
        snap1, rag1 = sched.stats.snapshot(), batcher.stats.snapshot()
        if len(results) != CHAIN_CONCURRENT_GEN or any(
                r["status"] != 200 or not r["pieces"] or r["done"]["degraded"] for r in results.values()):
            raise AssertionError(f"chain: a concurrent /generate failed or degraded: "
                                 f"{[(r['status'], r['done']['degraded']) for r in results.values()]}")
        prompt_tokens = [len(llm.tokenizer.apply_chat_template(m)) for m in received]
        off = _generate(base, gen_queries[0], kb=False)
        if off["status"] != 200 or not off["pieces"] or off["done"]["cache_tier"] or off["done"]["degraded"]:
            raise AssertionError(f"chain: /generate with the knowledge base off failed: {off}")
        ttfts = [r["ttft_ms"] for r in results.values()]
        # The stream admitted first is decoding when the others' cold batch
        # is prefilled whole: its longest gap between SSE lines, beside the
        # longest gaps of the others (a decode chunk's tokens come out
        # together), is what that prefill costs a running stream.
        first = min(results.values(), key=lambda r: r["ttft_ms"])
        later_gaps = sorted(max(r["gaps_ms"]) for r in results.values() if r is not first)
        stages = [_server_timing(r["headers"].get("Server-Timing")) for r in results.values()]
        decode_tokens = (snap1["tokens_total"] - snap0["tokens_total"]) - (snap1["requests_total"] - snap0["requests_total"])
        decode_s = snap1["decode_s"] - snap0["decode_s"]
        fields.update(
            concurrent=CHAIN_CONCURRENT_GEN, concurrent_wall_s=wall, ttft_ms_p50=_pct(ttfts, 0.5),
            ttft_ms_p95=_pct(ttfts, 0.95), ttft_ms=sorted(ttfts), stream_wall_ms=sorted(r["wall_ms"] for r in results.values()),
            first_stream_gaps_ms_top=sorted(first["gaps_ms"])[-4:],
            later_streams_max_gap_ms=[later_gaps[0], _pct(later_gaps, 0.5), later_gaps[-1]],
            decode_tokens_per_s=decode_tokens / decode_s if decode_s else None,
            tokens_per_s=(snap1["tokens_total"] - snap0["tokens_total"]) / wall,
            rag_prompt_tokens=[min(prompt_tokens), max(prompt_tokens)],
            retrieval_stage_ms={name: [_pct([s.get(name, 0.0) for s in stages], 0.5),
                                       max(s.get(name, 0.0) for s in stages)]
                                for name in ("cache_lookup", "queue_wait", "embed", "search")},
            # Random embeddings lie within the semantic tier's 0.98 of each
            # other: a batch after the first may be served from the ring.
            concurrent_cache_tiers=sorted(r["done"]["cache_tier"] for r in results.values()),
            microbatch_requests=rag1["requests_total"] - rag0["requests_total"],
            microbatch_batches=rag1["batches_total"] - rag0["batches_total"],
            kb_off_ttft_ms=off["ttft_ms"], kb_off_wall_ms=off["wall_ms"],
            kb_off_prompt_tokens=len(llm.tokenizer.apply_chat_template(received[-1])))

        # 6. The other routes.
        status, _, raw = _http("GET", base + "/health")
        health = json.loads(raw)
        status_m, _, raw = _http("GET", base + "/metrics")
        series = {line.split(" ")[0]: float(line.split(" ")[1]) for line in raw.decode().splitlines()
                  if line and not line.startswith("#")}
        # /health is "degraded" exactly while the SLO engine's fast-burn
        # rule fires (streams past /generate's 2,500 ms latency objective
        # burn its budget); every breaker must be closed.
        slo = slo_health()
        if status != 200 or health["slo"] != slo or health["status"] != ("degraded" if slo["degraded"] else "ok") or (
                set(health["breakers"].values()) != {"closed"}) or status_m != 200 or (
                series["rag_requests_total"] != batcher.stats.snapshot()["requests_total"]) or (
                series["rag_store_rows"] != store.capacity_stats()["rows"]):
            raise AssertionError(f"chain: /health {status} {health} or /metrics {status_m} disagree")
        # No rung of the degradation ladder (the LLM-only answer, the host
        # scan, ...) served a request of the phase, and no breaker opened
        # (the counters are reset at the phase's start).
        ladder = {name: v for name, v in series.items()
                  if name.startswith(("rag_degraded_total", "rag_breaker_open_total"))}
        if not ladder or any(ladder.values()):
            raise AssertionError(f"chain: the ladder served requests: {ladder}")
        late = _generate(base, _chain_text(rng, 40), headers={"X-Request-Deadline-Ms": "1"})
        unlimited = _generate(base, _chain_text(rng, 40), max_tokens=4, headers={"X-Request-Deadline-Ms": "0"})
        if late["status"] != 504 or unlimited["status"] != 200:
            raise AssertionError(f"chain: deadline 1 ms gave {late['status']}, 0 gave {unlimited['status']}")
        fields.update(health=health["status"], health_slo_firing=health["slo"]["firing"],
                      metrics_rag_requests_total=series["rag_requests_total"],
                      metrics_rag_store_rows=series["rag_store_rows"], ladder_counters_zero=len(ladder),
                      deadline_1ms_status=504,
                      deadline_0_status=200)

        # 7. Every kernel of the path launched in this phase (counts zeroed
        # after the build, before the first request).
        launches = dict(_cuda.LAUNCHES)
        if not all(launches[n] for n in ("qmm", "decode_attention", "flash_attention")) or (
                launches["paged_decode_attention"]):
            raise AssertionError(f"chain: path launches {launches}")
        fields.update(launches=launches, qmm_design_launches=dict(_cuda.QMM_DESIGN_LAUNCHES),
                      phase_s=time.perf_counter() - t_phase)
        emit("chain", **fields)

        # 8-11. The same server's bulk path, named collections, a second
        # server with the multi-turn chain, and the profiler routes (last:
        # a trace slows the process's later host work).  Each reads the
        # launches of its own requests.
        bulk_step(torch, base, factory, store, retriever, cache, splitter, sched, smi)
        step_launches = dict(
            collections=collections_step(base, factory, retriever, cache, splitter, gate, _cuda, smi),
            multi_turn=multi_turn_step(factory, llm, sched, received, ids_by_request, _cuda, smi),
            profiler=profiler_step(base, _cuda, smi))
    finally:
        GPUChatLLM.stream = stream
        sched.submit = submit
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        factory.reset_factories()  # stops the engine's tick thread, frees the chain
        reset_config_cache()
        shutil.rmtree(os.environ.pop("GAIE_PROFILER_DIR"), ignore_errors=True)
        for key in (UPLOAD_DIR_ENV, "GAIE_ENABLE_PROFILER"):
            del os.environ[key]
    return launches, step_launches


# ---------------------------------------------------------------------------
# bulk ingestion, named collections, the multi-turn chain, the profiler
# routes (on the chain phase's server) and durability (server processes)
# ---------------------------------------------------------------------------

# The stream beside the job: enough tokens to outlast it (decode starves
# while the job embeds), few enough that its tail after the job is short.
BULK_DOCS, BULK_SERIAL_DOCS, BULK_STREAM_TOKENS = 128, 16, 48
TENANT_DOCS, MULTI_TURN_TOKENS, PROFILE_GEN_TOKENS = 8, CHAIN_GEN_TOKENS, 8
DURABLE_DOCS, DURABLE_RESUME_DOCS, DURABLE_SEARCHES = 32, 16, 16
# The durable fabric's run: the sharded fabric through the APP_* keys, a
# snapshot cut during the ingest (every 3 WAL records; one more delete if
# the last record would fall on a snapshot), and the SIGKILL restart, which
# restores that snapshot onto the fabric's children and replays the WAL
# records after it.
DURABLE_FABRIC_DOCS = 16
DURABLE_FABRIC_ENV = {"APP_VECTORSTORE_NAME": "fabric", "APP_FABRIC_NUMSHARDS": "4", "APP_FABRIC_CHILDBACKEND": "tpu",
                      "APP_DURABILITY_SNAPSHOTEVERYRECORDS": "3"}
# Files that must fail alone in a bulk job: an extension no loader takes,
# and a .json file that is not JSON.
BAD_FILES = (("bad.xyz", "no loader takes this extension"), ("broken.json", "{not json"))


def _multipart_files(files) -> tuple[bytes, dict]:
    """A multipart/form-data body of (name, text) files under ``files``."""
    boundary = "chainSmokeBulkBoundary"
    body = b"".join(f'--{boundary}\r\nContent-Disposition: form-data; name="files"; filename="{name}"\r\n'
                    f"Content-Type: text/plain\r\n\r\n{text}\r\n".encode() for name, text in files)
    return body + f"--{boundary}--\r\n".encode(), {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def _bulk(base, files, query: str = "") -> str:
    """POST /documents/bulk; the job id of its 202."""
    body, headers = _multipart_files(files)
    status, _, raw = _http("POST", base + "/documents/bulk" + query, body, headers)
    if status != 202:
        raise AssertionError(f"bulk: POST /documents/bulk{query}: {status} {raw[:300]!r}")
    return json.loads(raw)["job_id"]


def _job(base, job_id: str) -> dict:
    status, _, raw = _http("GET", base + f"/documents/status?job_id={job_id}")
    if status != 200:
        raise AssertionError(f"bulk: GET /documents/status?job_id={job_id}: {status} {raw[:300]!r}")
    return json.loads(raw)


def _wait_job(base, job_id: str, timeout: float = 600.0, poll_s: float = 0.05) -> dict:
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        snap = _job(base, job_id)
        if snap["status"] not in ("queued", "running"):
            return snap
        time.sleep(poll_s)
    raise AssertionError(f"bulk: job {job_id} still running after {timeout} s")


def _exposition(base):
    """/metrics, parsed and checked by the port's exposition parser."""
    from generativeaiexamples_tpu_torch.obs.exposition import parse_exposition

    status, _, raw = _http("GET", base + "/metrics")
    if status != 200:
        raise AssertionError(f"/metrics: {status}")
    return parse_exposition(raw.decode())


def _documents(base, query: str = "") -> list:
    status, _, raw = _http("GET", base + "/documents" + query)
    if status != 200:
        raise AssertionError(f"GET /documents{query}: {status} {raw[:200]!r}")
    return sorted(json.loads(raw)["documents"])


def _hits(chunks) -> list:
    return [(c["content"], c["filename"], c["score"]) for c in chunks]


def _store_hits(hits, threshold: float) -> list:
    return [(h.chunk.text, h.chunk.source, h.score) for h in hits if h.score >= threshold]


def _path_launches(_cuda, where: str, expect=("qmm", "decode_attention", "flash_attention")) -> dict:
    """The launches since the last reset; every kernel of the path must
    have launched and the paged decode kernel not."""
    launches = dict(_cuda.LAUNCHES)
    if not all(launches[n] for n in expect) or launches["paged_decode_attention"]:
        raise AssertionError(f"{where}: path launches {launches}")
    return launches


def _chunk_timer(sched):
    """Wrap a scheduler's decode-chunk dispatch and finalize (instance
    attributes, undone by ``restore``): each chunk's host perf_counter
    times (dispatch start, dispatch end, finalize start, finalize end),
    so a slow chunk shows whether its host enqueue or its wait on the
    device took the time."""
    chunks: list = []
    dispatch, finalize = sched._decode_dispatch, sched._decode_finalize

    def timed_dispatch(active):
        t0 = time.perf_counter()
        out = dispatch(active)
        chunks.append([t0, time.perf_counter()])
        return out

    def timed_finalize(*args):
        t0 = time.perf_counter()
        finalize(*args)
        if chunks:
            chunks[-1] += [t0, time.perf_counter()]

    def restore():
        del sched._decode_dispatch, sched._decode_finalize

    sched._decode_dispatch, sched._decode_finalize = timed_dispatch, timed_finalize
    return chunks, restore


def _substeps(t0: float, marks: dict) -> dict:
    """Seconds of each part of a step, from perf_counter ``marks`` (in the
    order taken, each the end of its part)."""
    out = {}
    for name, t in marks.items():
        out[name], t0 = t - t0, t
    return out


def bulk_step(torch, base, factory, store, retriever, cache, splitter, sched, smi) -> None:
    """``/documents/bulk`` on the chain server: 128 documents of 6,000
    bytes (numpy seed 0) and two files that must fail alone, against the
    serial ``/documents`` path, with a stream running beside the job (its
    decode chunks timed: host enqueue, wait on the device, and the time
    between chunks)."""
    import numpy as np

    t_step = time.perf_counter()
    brng = np.random.default_rng(0)
    docs = [_chain_text(brng, CHAIN_LONG_BYTES) for _ in range(BULK_DOCS + BULK_SERIAL_DOCS)]
    bulk_docs, serial_docs = docs[:BULK_DOCS], docs[BULK_DOCS:]
    expected = sum(len(splitter.split(t)) for t in bulk_docs)
    rows0 = store.capacity_stats()["rows"]
    marks = {"prepare": time.perf_counter()}
    # The pipeline the route builds, built here first to time its embed
    # dispatches with CUDA events (device busy share of the job).
    pipeline = factory.get_ingest_pipeline()
    dispatches: list = []
    embed = pipeline._embed_fn

    def timed_embed(texts):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = embed(texts)
        end.record()
        dispatches.append((start, end, len(texts)))
        return out

    pipeline._embed_fn = timed_embed
    chunk_times, restore_chunks = _chunk_timer(sched)
    stream: dict = {}
    streamer = threading.Thread(target=lambda: stream.update(_generate(
        base, _chain_text(brng, 40), kb=False, max_tokens=BULK_STREAM_TOKENS)), daemon=True)
    try:
        streamer.start()
        time.sleep(1.0)  # the stream is decoding when the job starts
        files = [(f"bulk{i}.txt", t) for i, t in enumerate(bulk_docs)] + list(BAD_FILES)
        t0 = time.perf_counter()
        job_id = _bulk(base, files)
        snap = _wait_job(base, job_id, poll_s=0.02)
        t_done = time.perf_counter()
        wall = t_done - t0
        streamer.join(timeout=600)
        marks["job"], marks["stream_tail"] = t_done, time.perf_counter()
    finally:
        pipeline._embed_fn = embed
        restore_chunks()
    torch.cuda.synchronize()
    busy_ms = sum(s.elapsed_time(e) for s, e, _ in dispatches)
    errors = " ".join(snap["errors"])
    rows1 = store.capacity_stats()["rows"]
    if snap["status"] != "partial" or snap["files_failed"] != 2 or snap["files_done"] != BULK_DOCS or (
            snap["chunks_ingested"] != expected) or "bad.xyz" not in errors or "broken.json" not in errors or (
            rows1 - rows0 != expected):
        raise AssertionError(f"bulk: job {snap}, rows {rows0} -> {rows1}, want +{expected}")
    # 16 /search against the store's own search on the same query vectors.
    qrng = np.random.default_rng(1)
    k = retriever.top_k
    for q in [_chain_text(qrng, int(qrng.integers(30, 60))) for _ in range(CHAIN_SEARCHES)]:
        cache.clear()
        got = _hits(_search(base, q, k))
        want = _store_hits(store.search_batch(retriever.embedder.embed_queries([q]), k)[0], retriever.score_threshold)
        if not got or got != want:
            raise AssertionError(f"bulk: /search {q!r} after the job:\n{got}\n{want}")
    exp = _exposition(base)
    stats = pipeline.stats.snapshot()
    counters = {name: exp.value(name) for name in ("ingest_jobs_total", "ingest_docs_total",
                                                   "ingest_doc_failures_total", "ingest_chunks_total",
                                                   "ingest_embed_batches_total", "ingest_append_batches_total")}
    want_counters = {"ingest_jobs_total": 1, "ingest_docs_total": snap["files_done"],
                     "ingest_doc_failures_total": snap["files_failed"], "ingest_chunks_total": snap["chunks_total"],
                     "ingest_embed_batches_total": stats["embed_batches_total"],
                     "ingest_append_batches_total": stats["append_batches_total"]}
    if counters != want_counters or len(dispatches) != stats["embed_batches_total"]:
        raise AssertionError(f"bulk: /metrics {counters} != the job's {want_counters} ({len(dispatches)} dispatches)")
    marks["searches_metrics"] = time.perf_counter()
    # The serial path: 16 more of the same documents through POST /documents.
    serial_ms = [_upload(base, f"serial{i}.txt", t) for i, t in enumerate(serial_docs)]
    serial_chunks = sum(len(splitter.split(t)) for t in serial_docs)
    marks["serial"] = time.perf_counter()
    # Their chunks would not fit a prompt beside the template (4 x 508
    # byte tokens): the later /generate gates need them gone.
    for name in [f"bulk{i}.txt" for i in range(BULK_DOCS)] + [f"serial{i}.txt" for i in range(BULK_SERIAL_DOCS)]:
        status, _, raw = _http("DELETE", base + f"/documents?filename={name}")
        if status != 200:
            raise AssertionError(f"bulk: DELETE {name}: {status} {raw[:200]!r}")
    if store.capacity_stats()["rows"] != rows0:
        raise AssertionError(f"bulk: {store.capacity_stats()['rows']} rows after the deletes, want {rows0}")
    marks["deletes"] = time.perf_counter()
    arrivals = stream.get("arrivals", [])
    in_job = [(b - a) * 1e3 for a, b in zip(arrivals, arrivals[1:]) if b > t0 and a < t_done]
    # Decode chunks that overlap the job: (enqueue ms, finalize ms, ms
    # since the previous chunk's finalize ended).
    job_chunks = [(c[1] - c[0], c[3] - c[2], (c[0] - p[3]) if p else 0.0)
                  for p, c in zip([None] + chunk_times, chunk_times) if len(c) == 4 and c[3] > t0 and c[0] < t_done]
    job_chunks = [tuple(x * 1e3 for x in c) for c in job_chunks]
    emit("bulk", nvidia_smi=smi, docs=BULK_DOCS, doc_bytes=CHAIN_LONG_BYTES, bad_files=[n for n, _ in BAD_FILES],
         chunks=expected, job_status=snap["status"], files_done=snap["files_done"], files_failed=snap["files_failed"],
         job_wall_s=wall, chunks_per_s=expected / wall, embed_dispatches=len(dispatches),
         chunks_per_dispatch=sum(n for _, _, n in dispatches) / max(len(dispatches), 1),
         append_batches=stats["append_batches_total"], device_busy_ms=busy_ms, device_busy_share=busy_ms / 1e3 / wall,
         serial_docs=BULK_SERIAL_DOCS, serial_chunks=serial_chunks, serial_ms_per_doc=sum(serial_ms) / len(serial_ms),
         serial_chunks_per_s=serial_chunks / (sum(serial_ms) / 1e3), searches_equal_to_store=CHAIN_SEARCHES,
         metrics_equal_to_job=counters, stream_status=stream.get("status"), stream_tokens=len(arrivals),
         stream_spans_job=bool(arrivals) and arrivals[0] < t0 and arrivals[-1] > t_done,
         stream_max_gap_ms_during_job=max(in_job) if in_job else None, stream_gaps_during_job=len(in_job),
         stream_max_gap_ms=max(stream["gaps_ms"]) if stream.get("gaps_ms") else None,
         stream_chunks_during_job=len(job_chunks),
         stream_chunk_enqueue_ms_max=max((c[0] for c in job_chunks), default=None),
         stream_chunk_finalize_ms_max=max((c[1] for c in job_chunks), default=None),
         stream_chunk_between_ms_max=max((c[2] for c in job_chunks), default=None),
         stream_chunk_ms=[[round(x, 1) for x in c] for c in job_chunks],
         step_s=time.perf_counter() - t_step, substeps_s=_substeps(t_step, marks))


def collections_step(base, factory, retriever, cache, splitter, gate, _cuda, smi) -> dict:
    """``?collection=`` on the chain server: a quota from ``APP_*``, a bulk
    job into ``tenant-a`` and one more file refused alone, searches against
    the collection's store, the default collection untouched, a 404 before
    any SSE byte, and a knowledge-base /generate over ``tenant-a`` that
    streams the engine's greedy ids."""
    import numpy as np

    from generativeaiexamples_tpu_torch.core.configuration import reset_config_cache

    t_step = time.perf_counter()
    rng = np.random.default_rng(2)
    k = retriever.top_k
    queries = [_chain_text(rng, int(rng.integers(30, 60))) for _ in range(8)]

    def default_hits():
        out = []
        for q in queries:
            cache.clear()
            out.append(_hits(_search(base, q, k)))
        return out

    before = default_hits()
    docs = [_chain_text(rng, int(rng.integers(*CHAIN_SHORT_BYTES))) for _ in range(TENANT_DOCS + 1)]
    rows_want = sum(len(splitter.split(t)) for t in docs[:TENANT_DOCS])
    # The quota admits the 8 documents (one chunk each) and not one more;
    # the manager is rebuilt under it (the default collection is not
    # written to in this step).
    os.environ["APP_COLLECTIONS_MAXROWSPERCOLLECTION"] = str(rows_want)
    reset_config_cache()
    factory.reset_factories(keep=("chat_llm", "embedder", "store", "reranker", "retriever", "cache", "batcher",
                                  "splitter", "ingest"))
    try:
        first = _wait_job(base, _bulk(base, [(f"tenant{i}.txt", t) for i, t in enumerate(docs[:TENANT_DOCS])],
                                      "?collection=tenant-a"))
        refused = _wait_job(base, _bulk(base, [("tenant-extra.txt", docs[-1])], "?collection=tenant-a"))
    finally:
        del os.environ["APP_COLLECTIONS_MAXROWSPERCOLLECTION"]
        reset_config_cache()
    manager = factory.peek_collection_manager()
    tstore = manager.get("tenant-a")
    if first["status"] != "done" or first["files_done"] != TENANT_DOCS or refused["status"] != "failed" or (
            refused["files_failed"] != 1 or "CollectionQuotaExceeded" not in refused["errors"][0]) or (
            len(tstore) != rows_want or type(tstore).__name__ != "GPUVectorStore" or tstore.device.type != "cuda"):
        raise AssertionError(f"collections: jobs {first} / {refused}, {len(tstore)} rows (want {rows_want})")
    names = {f"tenant{i}.txt" for i in range(TENANT_DOCS)}
    for q in queries:
        got = _http("POST", base + "/search", {"query": q, "top_k": k, "collection": "tenant-a"})
        body = json.loads(got[2])
        want = _store_hits(tstore.search(retriever.embedder.embed_query(q), k), retriever.score_threshold)
        if got[0] != 200 or body["degraded"] or _hits(body["chunks"]) != want or not want or not {
                c["filename"] for c in body["chunks"]} <= names:
            raise AssertionError(f"collections: /search tenant-a {q!r}:\n{body}\n{want}")
    if default_hits() != before or set(_documents(base, "?collection=tenant-a")) != names:
        raise AssertionError("collections: the default collection's results moved, or tenant-a lists other files")
    unknown = _generate(base, queries[0], collection="nobody")
    exp = _exposition(base)
    rows_label = exp.value("rag_store_rows", collection="tenant-a")
    if unknown["status"] != 404 or not json.loads(unknown["body"])["detail"].startswith("unknown collection") or (
            rows_label != rows_want or exp.value("rag_collection_quota_rejections_total") != 1 or (
            exp.value("rag_collection_count") != 2)):
        raise AssertionError(f"collections: unknown collection gave {unknown['status']}, rows {rows_label}")
    _cuda.reset_launch_counts()
    q = queries[1]
    res, messages, ids, tokens = gate(q, collection="tenant-a")
    hits = json.loads(_http("POST", base + "/search", {"query": q, "top_k": k, "collection": "tenant-a"})[2])["chunks"]
    context = "\n\n".join(c["content"] for c in hits)
    if ("system", f"Answer using this context from the 'tenant-a' collection:\n{context}") not in messages:
        raise AssertionError(f"collections: the tenant-a context did not reach the prompt: {messages}")
    launches = _path_launches(_cuda, "collections")
    emit("collections", nvidia_smi=smi, collection="tenant-a", docs=TENANT_DOCS, rows=rows_want,
         max_rows_per_collection=rows_want, extra_file_status=refused["status"], extra_file_error=refused["errors"][0],
         searches_equal_to_collection_store=len(queries), default_results_unchanged=True, unknown_collection_status=404,
         metrics_rows_tenant_a=rows_label, quota_rejections=1, gate_prompt_tokens=len(ids), gate_tokens=len(tokens),
         gate_ttft_ms=res["ttft_ms"], answer_ids_equal_to_engine=True, launches=launches,
         step_s=time.perf_counter() - t_step)
    return launches


def multi_turn_step(factory, llm, sched, received, ids_by_request, _cuda, smi) -> dict:
    """A second server, ``create_app(example_cls=MultiTurnChatbot)``, over the
    same singletons: two greedy turns; the first is written to the memory
    store (its own store on the card), the second's prompt holds it, and
    both stream the engine's greedy ids."""
    import numpy as np

    from generativeaiexamples_tpu_torch.chains.multi_turn import MultiTurnChatbot
    from generativeaiexamples_tpu_torch.server.app import create_app

    t_step = time.perf_counter()
    server = create_app(example_cls=MultiTurnChatbot)
    memory = factory.get_memory_store()
    marks = {"create_app": time.perf_counter()}
    if type(memory).__name__ != "GPUVectorStore" or memory.device.type != "cuda" or len(memory) or (
            memory is factory.get_store()):
        raise AssertionError(f"multi_turn: the memory store is {type(memory).__name__} with {len(memory)} rows")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(3)
    try:
        _cuda.reset_launch_counts()
        q1, q2 = _chain_text(rng, 45), _chain_text(rng, 45)
        res1, _, ids1, tokens1 = _same_as_engine(base, llm, sched, received, ids_by_request, q1, where="multi_turn")
        marks["turn1"] = time.perf_counter()
        rows = [c.text for c in memory._mirror._chunks]
        if len(memory) != 1 or not rows[0].startswith(f"User: {q1}\nAssistant: ") or len(rows[0]) <= len(q1) + 18:
            raise AssertionError(f"multi_turn: memory after turn 1: {rows}")
        res2, messages2, ids2, tokens2 = _same_as_engine(base, llm, sched, received, ids_by_request, q2,
                                                         where="multi_turn")
        marks["turn2"] = time.perf_counter()
        if rows[0] not in messages2[0][1] or len(memory) != 2:
            raise AssertionError(f"multi_turn: turn 2's prompt lacks turn 1: {messages2[0]}")
        launches = _path_launches(_cuda, "multi_turn")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    marks["shutdown"] = time.perf_counter()
    emit("multi_turn", nvidia_smi=smi, memory_store="GPUVectorStore on cuda", memory_rows=len(memory),
         turn_prompt_tokens=[len(ids1), len(ids2)], turn_tokens=[len(tokens1), len(tokens2)],
         turn_ttft_ms=[res1["ttft_ms"], res2["ttft_ms"]], turn2_prompt_holds_turn1=True,
         answer_ids_equal_to_engine=True, launches=launches, step_s=time.perf_counter() - t_step,
         substeps_s=_substeps(t_step, marks), turn_wall_ms=[res1["wall_ms"], res2["wall_ms"]])
    return launches


def profiler_step(base, _cuda, smi) -> dict:
    """``/debug/profiler/{start,stop}`` on the chain server: a second start
    is 409; the trace of one 8-token /generate, written by ``stop``, names
    the W8A8 matmul and decode-attention kernels among its CUDA kernels."""
    t_step = time.perf_counter()
    _cuda.reset_launch_counts()
    first, _, raw = _http("POST", base + "/debug/profiler/start")
    second, _, _ = _http("POST", base + "/debug/profiler/start")
    if first != 200 or second != 409:
        raise AssertionError(f"profiler: start gave {first} {raw[:200]!r}, a second start {second}")
    res = _generate(base, "profile this answer", kb=False, max_tokens=PROFILE_GEN_TOKENS)
    t0 = time.perf_counter()
    status, _, raw = _http("POST", base + "/debug/profiler/stop")
    stop_s = time.perf_counter() - t0
    body = json.loads(raw)
    if status != 200 or res["status"] != 200 or not os.path.isfile(body.get("trace", "")):
        raise AssertionError(f"profiler: stop gave {status} {body}, /generate {res['status']}")
    launches = _path_launches(_cuda, "profiler", expect=("qmm", "decode_attention"))
    size = os.path.getsize(body["trace"])
    with open(body["trace"], encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    qmm_k = sum("qmm" in n for n in kernels)
    decode_k = sum("decode_kernel" in n for n in kernels)
    if not qmm_k or not decode_k:
        raise AssertionError(f"profiler: the trace's {len(kernels)} CUDA kernels name no qmm / decode_kernel")
    emit("profiler", nvidia_smi=smi, trace="chrome", trace_mb=size / 1e6, export_s=body["export_s"],
         stop_request_s=stop_s, cuda_kernels=len(kernels), qmm_kernels=qmm_k, decode_attention_kernels=decode_k,
         second_start_status=409, generate_tokens=PROFILE_GEN_TOKENS, launches=launches,
         step_s=time.perf_counter() - t_step)
    return launches


# A standby chain server: the interpreter, torch, the package and a CUDA
# context start ahead of time, then the server's main runs on "go".
_STANDBY_SERVER = (
    "import sys, torch\n"
    "import generativeaiexamples_tpu_torch.chains.factory\n"
    "import generativeaiexamples_tpu_torch.server.__main__ as server\n"
    "if torch.cuda.is_available():\n"
    "    torch.zeros(1, device='cuda')\n"
    "if sys.stdin.readline().strip() == 'go':\n"
    "    server.main(sys.argv[1:])\n"
)


class _ServerProcess:
    """``python -m generativeaiexamples_tpu_torch.server`` in its own process
    on a free port, its log in ``log_path``.  A ``standby`` process starts
    its interpreter, imports and CUDA context now and serves from
    :meth:`go`; its times count from there."""

    _ports_lock = threading.Lock()
    _ports_given: set = set()

    def __init__(self, env: dict, log_path: str, args=(), name: str = "", standby: bool = False) -> None:
        import socket

        self.name = name
        # Servers of phases that run side by side never share a port.
        with self._ports_lock:
            while True:
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    self.port = sock.getsockname()[1]
                if self.port not in self._ports_given:
                    self._ports_given.add(self.port)
                    break
        self.base = f"http://127.0.0.1:{self.port}"
        self.log_path = log_path
        self.t0 = time.perf_counter()
        self._log = open(log_path, "ab")
        entry = ["-c", _STANDBY_SERVER] if standby else ["-m", "generativeaiexamples_tpu_torch.server"]
        self.proc = subprocess.Popen([sys.executable, *entry, "--host", "127.0.0.1", "--port", str(self.port), "-v",
                                      *args], cwd=ROOT, env=env, stdout=self._log, stderr=subprocess.STDOUT,
                                     stdin=subprocess.PIPE if standby else None)

    def go(self) -> "_ServerProcess":
        """Start a standby process's server now."""
        self.t0 = time.perf_counter()
        self.proc.stdin.write(b"go\n")
        self.proc.stdin.flush()
        return self

    def log_tail(self, n: int = 3000) -> str:
        with open(self.log_path, "rb") as fh:
            return fh.read()[-n:].decode(errors="replace")

    def wait_ready(self, timeout: float = 300.0) -> float:
        """Seconds from the process's start to its first answered /health."""
        while time.perf_counter() - self.t0 < timeout:
            if self.proc.poll() is not None:
                raise AssertionError(f"durable: the server exited with {self.proc.returncode}:\n{self.log_tail()}")
            try:
                if _http("GET", self.base + "/health", timeout=5)[0] == 200:
                    return time.perf_counter() - self.t0
            except OSError:
                pass
            time.sleep(0.1)
        raise AssertionError(f"durable: the server did not come up in {timeout} s:\n{self.log_tail()}")

    def kill(self) -> None:
        self.proc.kill()  # SIGKILL: no handler, no flush, no snapshot
        self.proc.wait(timeout=60)
        self._log.close()

    def term(self) -> tuple[int, float]:
        """SIGTERM; (exit code, seconds to exit)."""
        import signal

        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=300)
        self._log.close()
        return rc, time.perf_counter() - t0

    def close(self) -> None:
        if self.proc.poll() is None:
            self.kill()


def _recovery_event(base) -> dict:
    """The pinned ``startup.recovery`` record of /debug/requests; fails
    unless the recovered store is on the card."""
    status, _, raw = _http("GET", base + "/debug/requests")
    events = [r for r in json.loads(raw)["requests"] if r["route"] == "startup.recovery"] if status == 200 else []
    if len(events) != 1:
        raise AssertionError(f"durable: {len(events)} recovery events in /debug/requests ({status})")
    rec = events[0]["attrs"]["recovery"]
    if not rec["device"].startswith("cuda"):
        raise AssertionError(f"durable: the store was recovered on {rec['device']}")
    # A sharded fabric: every shard's child back on the card (R1).
    if not all(d.startswith("cuda") for d in rec.get("shard_devices", ())):
        raise AssertionError(f"durable: the fabric's shards were recovered on {rec['shard_devices']}")
    return rec


def _search_store_versions(base, request_ids) -> list:
    """The store version each of these /search requests read (its result
    cache's stamp), from its trace in /debug/requests.  Fails unless every
    one of them is there with its stamp; other requests' traces are not
    read."""
    status, _, raw = _http("GET", base + "/debug/requests")
    if status != 200:
        raise AssertionError(f"durable: /debug/requests {status}")
    records = json.loads(raw)["requests"]
    by_id = {r["request_id"]: r for r in records if r["route"] == "/search"}
    missing = [i for i in request_ids if "store_version" not in by_id.get(i, {}).get("attrs", {})]
    if missing:
        seen = [(r["request_id"], r["route"], r["status"], r["attrs"]) for r in records if r["route"] != "/documents/status"]
        raise AssertionError(f"durable: /search traces {missing} lack a store version; /debug/requests holds {seen}")
    return [by_id[i]["attrs"]["store_version"] for i in request_ids]


def _other_search_traces(base, request_ids) -> list:
    """(request id, status, attrs) of each /search trace in /debug/requests
    that none of ``request_ids`` left: a record of stray /search traffic,
    not a gate."""
    records = json.loads(_http("GET", base + "/debug/requests")[2])["requests"]
    return [(r["request_id"], r["status"], r["attrs"]) for r in records
            if r["route"] == "/search" and r["request_id"] not in set(request_ids)]


def _snapshot_seq(env):
    """The WAL sequence number of the durable store's newest snapshot (its
    manifest's ``wal_seq``), or None before the first."""
    path = os.path.join(env["GAIE_DURABILITY_DIR"], "store", "MANIFEST.json")
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)["wal_seq"]


def durable_phase(smi: str, server_args=(), env_extra=None, name="durable", n_docs=DURABLE_DOCS, term=True) -> None:
    """Durability on the card with server processes: recovery after a
    SIGKILL from the WAL (and, where ``env_extra`` sets a snapshot cadence,
    from a snapshot cut during the ingest plus at least one WAL record
    after it), then (with ``term``) a
    final snapshot at SIGTERM and a bulk job killed mid-way that resumes
    with every file landing once.  The LLM is the echo fake (none of this reaches it); the
    embedder (arctic-embed-l) and the store (``env_extra`` may name
    another, such as the sharded fabric) are the card's.  The result cache keeps only its
    exact tier (random embeddings lie within the semantic tier's 0.98 of
    each other), which stamps each /search's trace with the store version
    it read; no query is searched twice in one process, so every gated
    /search reaches the store."""
    import re
    import shutil
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch.core.configuration import AppConfig
    from generativeaiexamples_tpu_torch.ingest.splitters import get_text_splitter

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="durable_")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("APP_", "GAIE_"))}
    env.update(APP_DURABILITY_ENABLED="true", GAIE_DURABILITY_DIR=os.path.join(root, "durability"),
               APP_LLM_MODELENGINE="echo", APP_CACHE_SEMANTICENABLED="false",
               GAIE_UPLOAD_DIR=os.path.join(root, "uploads"),
               **(env_extra or {}))
    splitter = get_text_splitter(AppConfig())
    brng = np.random.default_rng(0)
    docs = [(f"durable{i}.txt", _chain_text(brng, CHAIN_LONG_BYTES)) for i in range(n_docs)]
    resume_docs = [(f"resume{i}.txt", _chain_text(brng, CHAIN_LONG_BYTES)) for i in range(DURABLE_RESUME_DOCS)]
    qrng = np.random.default_rng(1)
    queries = [_chain_text(qrng, int(qrng.integers(30, 60))) for _ in range(DURABLE_SEARCHES + 1)]
    queries, first_query = queries[:-1], queries[-1]
    chunks_of = {name: len(splitter.split(text)) for name, text in docs + resume_docs}
    snapshot_every = int((env_extra or {}).get("APP_DURABILITY_SNAPSHOTEVERYRECORDS", 0))
    fabric = env.get("APP_VECTORSTORE_NAME") == "fabric"
    store = (f"ShardedVectorStore, {env.get('APP_FABRIC_NUMSHARDS')} shards of GPUVectorStore (bf16)" if fabric
             else "GPUVectorStore (bf16)")
    servers, standby = [], {}

    def start(name, then=None):
        """Start server ``name`` (from its standby when one waits) and, once
        it answers, a standby for ``then``, the next restart: its start-up
        overlaps this server's work, and the restart's times count from
        its release."""
        srv = standby.pop(name).go() if name in standby else _ServerProcess(
            env, os.path.join(root, f"{name}.log"), server_args, name)
        servers.append(srv)
        ready = srv.wait_ready()
        if then is not None:
            standby[then] = _ServerProcess(env, os.path.join(root, f"{then}.log"), server_args, then, standby=True)
        return srv, ready

    def search_ids(srv):
        return [f"durable-{srv.name}-{i}" for i in range(len(queries))]

    def all_ids(srv):
        return search_ids(srv) + [f"durable-{srv.name}-first"]

    def searches(srv):
        return [_hits(_search(srv.base, q, 4, rid)) for q, rid in zip(queries, search_ids(srv))]

    def first_search_s(srv):
        _search(srv.base, first_query, 4, f"durable-{srv.name}-first")
        return time.perf_counter() - srv.t0

    fields = dict(nvidia_smi=smi, llm="echo (APP_LLM_MODELENGINE=echo; no Llama in this phase)",
                  embedder="arctic-embed-l, 24 layers, random bf16, seed 0", store=store,
                  cache="exact tier only (APP_CACHE_SEMANTICENABLED=false)",
                  durability="APP_DURABILITY_ENABLED=true, snapshot every "
                             f"{snapshot_every or 'default'} records",
                  restarts="standby processes (interpreter, imports, CUDA context started during the previous "
                           "server's work); ready times count from their release")
    try:
        # 1-2. Ingest, delete a source, record 16 searches; SIGKILL.
        a, fields["start_a_s"] = start("a", then="b")
        t0 = time.perf_counter()
        job = _wait_job(a.base, _bulk(a.base, docs))
        fields["ingest_s"] = time.perf_counter() - t0
        added = sum(chunks_of[n] for n, _ in docs)
        deleted = [docs[0][0]]
        status, _, raw = _http("DELETE", a.base + f"/documents?filename={docs[0][0]}")
        if snapshot_every and status == 200 and _snapshot_seq(env) == _exposition(a.base).value("rag_wal_last_seq"):
            # The delete fell on a snapshot: one more record, so the restart
            # replays at least one after it.
            deleted.append(docs[1][0])
            status, _, raw = _http("DELETE", a.base + f"/documents?filename={docs[1][0]}")
        if job["status"] != "done" or job["files_done"] != n_docs or status != 200:
            raise AssertionError(f"durable: ingest {job}, delete {status} {raw[:200]!r}")
        want = searches(a)
        exp = _exposition(a.base)
        rows, seq, wal_bytes = exp.value("rag_store_rows"), exp.value("rag_wal_last_seq"), exp.value("rag_wal_bytes_total")
        sources, versions = _documents(a.base), set(_search_store_versions(a.base, search_ids(a)))
        if rows != added - sum(chunks_of[n] for n in deleted) or len(sources) != n_docs - len(deleted) or (
                len(versions) != 1):
            raise AssertionError(f"durable: {rows} rows, {len(sources)} sources, versions {versions} before the kill")
        version = versions.pop()
        fields["other_search_traces_a"] = _other_search_traces(a.base, search_ids(a))
        a.kill()
        # 3. Restart: the WAL replays (after the snapshot, if one was cut).
        b, fields["restart_after_kill_ready_s"] = start("b", then="c" if term else None)
        fields["restart_after_kill_first_search_s"] = first_search_s(b)
        rec = _recovery_event(b.base)
        exp = _exposition(b.base)
        got = searches(b)
        replayed = seq - rec["base_seq"]
        if rec["snapshot_restored"] != bool(snapshot_every) or rec["replayed_records"] != replayed or replayed < 1 or (
                rec["rows"] != rows) or (
                rec["version"] != version) or set(_search_store_versions(b.base, all_ids(b))) != {version} or (
                exp.value("rag_recovery_replayed_records_total") != replayed) or (
                exp.value("rag_store_rows") != rows) or _documents(b.base) != sources or got != want:
            raise AssertionError(f"durable: recovery gate: {rec} (version {version} before the kill), "
                                 f"searches equal {got == want}")
        fields.update(rows=rows, rows_added=added, sources_deleted=len(deleted), wal_records=seq, wal_bytes=wal_bytes,
                      wal_bytes_per_1000_rows=wal_bytes / added * 1000, recovery_replayed_records=rec["replayed_records"],
                      recovery_s=rec["duration_ms"] / 1e3, version_before_kill=version,
                      recovery_version=rec["version"], recovery_device=rec["device"],
                      recovery_snapshot_restored=rec["snapshot_restored"], recovery_base_seq=rec["base_seq"],
                      searches_equal_after_kill=len(got),
                      other_search_traces_b=_other_search_traces(b.base, all_ids(b)))
        if "shard_devices" in rec:
            fields["recovery_shard_devices"] = rec["shard_devices"]
        if not term:
            rc, _ = b.term()
            if rc != 0:
                raise AssertionError(f"{name}: SIGTERM exit {rc}:\n{b.log_tail()}")
            fields["servers_started"] = len(servers)
        else:
            # 4. SIGTERM cuts a final snapshot.
            rc, fields["sigterm_to_exit_s"] = b.term()
            cut = re.findall(r"snapshot (snap-\d+): (\d+) rows in ([0-9.]+) ms", b.log_tail(200000))
            if rc != 0 or not cut or int(cut[-1][1]) != rows:
                raise AssertionError(f"durable: SIGTERM exit {rc}, snapshot lines {cut}:\n{b.log_tail()}")
            fields.update(snapshot=cut[-1][0], snapshot_s=float(cut[-1][2]) / 1e3)
            # 5. Restart: the snapshot loads and nothing replays.
            c, fields["restart_after_term_ready_s"] = start("c", then="d")
            fields["restart_after_term_first_search_s"] = first_search_s(c)
            rec = _recovery_event(c.base)
            got = searches(c)
            if not rec["snapshot_restored"] or rec["replayed_records"] != 0 or rec["rows"] != rows or got != want or (
                    rec["version"] != version) or set(_search_store_versions(c.base, all_ids(c))) != {version} or (
                    _documents(c.base) != sources):
                raise AssertionError(f"durable: snapshot gate: {rec} (version {version}), searches equal {got == want}")
            fields.update(snapshot_recovery_s=rec["duration_ms"] / 1e3, snapshot_recovery_device=rec["device"],
                          searches_equal_after_term=len(got),
                          other_search_traces_c=_other_search_traces(c.base, all_ids(c)))
            # 6. A bulk job killed mid-way resumes at the next start.
            job_id = _bulk(c.base, resume_docs)
            t0 = time.perf_counter()
            while True:
                snap = _job(c.base, job_id)
                if snap["status"] != "running" or snap["files_done"] >= DURABLE_RESUME_DOCS // 4 or (
                        time.perf_counter() - t0 > 300):
                    break
                time.sleep(0.01)
            c.kill()
            if snap["status"] != "running":
                raise AssertionError(f"durable: the job was not running at the kill: {snap}")
            d, fields["restart_after_job_kill_ready_s"] = start("d")
            _recovery_event(d.base)
            t0 = time.perf_counter()
            resumed = _wait_job(d.base, job_id)
            fields["resume_wait_s"] = time.perf_counter() - t0
            listed = _documents(d.base)
            exp = _exposition(d.base)
            rows_after = rows + sum(chunks_of[n] for n, _ in resume_docs)
            if resumed["status"] != "done" or resumed["files_done"] != DURABLE_RESUME_DOCS or resumed["files_failed"] or (
                    listed != sorted(sources + [n for n, _ in resume_docs])) or exp.value("rag_store_rows") != rows_after or (
                    exp.value("rag_recovery_resumed_jobs_total") != 1):
                raise AssertionError(f"durable: resume gate: {resumed}, {exp.value('rag_store_rows')} rows (want "
                                     f"{rows_after})")
            rc, _ = d.term()
            # Every file landed once: the final snapshot's chunks, by source,
            # with no chunk id twice.
            store_dir = os.path.join(env["GAIE_DURABILITY_DIR"], "store")
            with open(os.path.join(store_dir, "MANIFEST.json"), encoding="utf-8") as fh:
                manifest = json.load(fh)
            with open(os.path.join(store_dir, manifest["snapshot"], "chunks.json"), encoding="utf-8") as fh:
                chunks = json.load(fh)["chunks"]
            per_source: dict = {}
            for c_ in chunks:
                per_source[c_["source"]] = per_source.get(c_["source"], 0) + 1
            ids = [c_["id"] for c_ in chunks]
            if rc != 0 or len(ids) != len(set(ids)) or per_source != {n: chunks_of[n] for n in listed}:
                raise AssertionError(f"durable: exit {rc}, {len(ids) - len(set(ids))} duplicate ids, sources off by "
                                     f"{ {n: per_source.get(n) for n in listed if per_source.get(n) != chunks_of[n]} }")
            fields.update(resume_killed_at_files_done=snap["files_done"], resume_files=DURABLE_RESUME_DOCS,
                          resume_status=resumed["status"], resume_rows=rows_after, resume_duplicate_ids=0,
                          servers_started=len(servers))
    finally:
        for srv in servers + list(standby.values()):
            srv.close()
        shutil.rmtree(root, ignore_errors=True)
        fields["phase_s"] = time.perf_counter() - t_phase
    emit(name, **fields)


# ---------------------------------------------------------------------------
# F2 on the card, and serving HF checkpoints written from a seed
# ---------------------------------------------------------------------------


def np_int8(np, x, axis: int):
    """numpy's symmetric int8 of ``x`` (f32) along ``axis``: f32 scales
    ``max(amax, 1e-8) / 127`` (a division), codes ``rint`` (half to even)
    clipped to +-127.  The reference's arithmetic, which the port's
    quantizers must give bit for bit on the card.  A large 2-D ``x`` is
    cut across ``axis`` into blocks quantized on 8 threads (numpy releases
    the GIL; each block's arithmetic is the same)."""
    if x.ndim == 2 and x.size >= 1 << 24:
        from concurrent.futures import ThreadPoolExecutor

        across = 1 - axis % 2
        with ThreadPoolExecutor(8) as pool:
            parts = list(pool.map(lambda b: np_int8(np, b, axis), np.array_split(x, 8, axis=across)))
        return tuple(np.concatenate(p, axis=across) for p in zip(*parts))
    amax = np.abs(x).max(axis=axis, keepdims=True)
    scale = (np.maximum(amax, 1e-8) / np.float32(127)).astype(np.float32)
    codes = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return codes, scale


def _bits_equal(torch, got, want) -> bool:
    """Equal bit for bit: int8 codes, or f32 / bf16 scales read as integers."""
    got, want = got.cpu().contiguous(), torch.as_tensor(want).contiguous()
    if got.dtype.is_floating_point:
        view = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        got, want = got.view(view), want.to(got.dtype).view(view)
    return got.shape == want.shape and torch.equal(got, want)


QUANT_ROWS, QUANT_WIDTH = 1000, 4096


def check_quantizers(torch, dev) -> dict:
    """The port's three quantizers on the card (``quantize_matrix``,
    ``quantize_activations``, ``_quantize_kv``) against :func:`np_int8` bit
    for bit, scales and codes, on 1000 x 4096 Gaussian rows, their bf16
    roundings, and rows of exact powers of two.  Also counts the scales a
    product by the reciprocal of 127 would have put elsewhere."""
    import numpy as np

    from generativeaiexamples_tpu_torch.models.llama import _quantize_kv
    from generativeaiexamples_tpu_torch.ops.qmm import quantize_activations
    from generativeaiexamples_tpu_torch.ops.quant import quantize_matrix

    rng = np.random.default_rng(0)
    gauss = rng.standard_normal((QUANT_ROWS, QUANT_WIDTH), dtype=np.float32)
    sign = np.where(rng.random((QUANT_ROWS, QUANT_WIDTH)) < 0.5, -1.0, 1.0)
    pow2 = (sign * 2.0 ** rng.integers(-20, 20, (QUANT_ROWS, QUANT_WIDTH))).astype(np.float32)
    cases = {"gaussian": gauss, "gaussian_bf16": torch.from_numpy(gauss).bfloat16().float().numpy(),
             "powers_of_two": pow2}
    bad, reciprocal = [], {}
    for name, rows in cases.items():
        codes, scale = np_int8(np, rows, axis=1)
        x = torch.from_numpy(rows).to(dev)
        qm = quantize_matrix(x.T)  # (K, N): one output channel per row
        if not (_bits_equal(torch, qm.q.T, codes) and _bits_equal(torch, qm.scale[0], scale[:, 0])):
            bad.append(f"quantize_matrix/{name}")
        xq, a_scale = quantize_activations(x)
        if not (_bits_equal(torch, xq, codes) and _bits_equal(torch, a_scale, scale)):
            bad.append(f"quantize_activations/{name}")
        heads = rows.reshape(1, QUANT_ROWS, QUANT_WIDTH // 128, 128)  # (b, s, n_kv, hd)
        kv_codes, kv_scale = np_int8(np, heads, axis=-1)
        kq, ks = _quantize_kv(torch.from_numpy(heads).to(dev))
        if not (_bits_equal(torch, kq, kv_codes) and _bits_equal(torch, ks, torch.from_numpy(kv_scale[..., 0]))):
            bad.append(f"_quantize_kv/{name}")
        amax = np.abs(rows).max(axis=1)
        by_reciprocal = np.maximum(amax, 1e-8) * np.float32(1.0 / 127.0)
        reciprocal[name] = int((by_reciprocal != scale[:, 0]).sum())
    if bad:
        raise AssertionError(f"quantizers differ from numpy's amax / 127 on the card: {bad}")
    return dict(quantizers_bitwise_equal=True, quantizer_rows=QUANT_ROWS, quantizer_width=QUANT_WIDTH,
                scales_a_reciprocal_would_move=reciprocal)


HF_SHARDS = 4
# The seeded Llama-3-8B checkpoint's depth: 4 of its 32 layers, so the whole
# script stays inside its time limit beside the scale-out retrieval phases
# (16 beside the pool phase, 32 before it).
HF_LLAMA_LAYERS = 4
HF_SEED = 0
LLAMA_HF = "meta-llama/Meta-Llama-3-8B-Instruct"
EMBED_HF, RERANK_HF = "acme/arctic-embed-l-seeded", "acme/cross-encoder-seeded"
# The seeded BERT checkpoints' depth: 12 of arctic-embed-l's 24 layers (full
# width), so the whole script stays inside its time limit beside the
# scale-out retrieval phases.
HF_BERT_LAYERS = 12
# (ours, HF name in a layer); the projections in the fused order.
LLAMA_NORMS = (("attn_norm", "input_layernorm.weight"), ("mlp_norm", "post_attention_layernorm.weight"))
LLAMA_PROJ = (("wq", "self_attn.q_proj.weight"), ("wk", "self_attn.k_proj.weight"),
              ("wv", "self_attn.v_proj.weight"), ("wo", "self_attn.o_proj.weight"),
              ("w_gate", "mlp.gate_proj.weight"), ("w_up", "mlp.up_proj.weight"),
              ("w_down", "mlp.down_proj.weight"))
LLAMA_FUSED = (("wqkv", ("wq", "wk", "wv")), ("wo", ("wo",)), ("w_gu", ("w_gate", "w_up")), ("w_down", ("w_down",)))


def _bf16_gauss(torch, np, rng, shape, std=0.02, mean=0.0):
    """Normal draws in bf16 from ``rng``; a large array from a seed ``rng``
    draws, filled on 8 threads (:func:`_seeded_f32`)."""
    if math.prod(shape) >= 1 << 24:
        return torch.from_numpy(_seeded_f32(np, int(rng.integers(1 << 31)), shape, std, mean)).bfloat16()
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(std) + np.float32(mean)).bfloat16()


def llama_base_layer(torch, np, rng, cfg) -> dict:
    """One random layer in HF names and (out, in) shapes, bf16."""
    hd, d = cfg.head_dim, cfg.d_model
    shapes = {"self_attn.q_proj.weight": (cfg.n_heads * hd, d), "self_attn.k_proj.weight": (cfg.n_kv_heads * hd, d),
              "self_attn.v_proj.weight": (cfg.n_kv_heads * hd, d), "self_attn.o_proj.weight": (d, cfg.n_heads * hd),
              "mlp.gate_proj.weight": (cfg.d_ff, d), "mlp.up_proj.weight": (cfg.d_ff, d),
              "mlp.down_proj.weight": (d, cfg.d_ff)}
    out = {name: _bf16_gauss(torch, np, rng, (d,), 0.1, 1.0) for _, name in LLAMA_NORMS}
    out.update({name: _bf16_gauss(torch, np, rng, shape) for name, shape in shapes.items()})
    return out


def llama_layer(torch, base: dict, i: int) -> dict:
    """Layer ``i`` of the seeded checkpoint: the base layer rolled by ``i``
    rows (HF's output axis), so every layer differs from every other and
    a loader that mixes up layers cannot pass."""
    return {name: torch.roll(t, i, 0) for name, t in base.items()}


def write_llama_checkpoint(torch, np, path, cfg, seed: int = HF_SEED, shards: int = HF_SHARDS) -> dict:
    """A Llama checkpoint of ``cfg``'s geometry in bf16, as ``shards``
    ``model-0000k-of-0000n.safetensors`` files with the index and a
    ``LlamaForCausalLM`` ``config.json``, from numpy seed ``seed``.  Returns
    the base tensors (for the references), bytes written and seconds."""
    from generativeaiexamples_tpu_torch.engine.weights import save_safetensors

    t0 = time.perf_counter()
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = llama_base_layer(torch, np, rng, cfg)
    top = {"model.embed_tokens.weight": _bf16_gauss(torch, np, rng, (cfg.vocab_size, cfg.d_model)),
           "model.norm.weight": _bf16_gauss(torch, np, rng, (cfg.d_model,), 0.1, 1.0),
           "lm_head.weight": _bf16_gauss(torch, np, rng, (cfg.vocab_size, cfg.d_model))}
    per_shard = -(-cfg.n_layers // shards)
    weight_map, total = {}, 0
    for k in range(shards):
        fname = f"model-{k + 1:05d}-of-{shards:05d}.safetensors"
        tensors = {"model.embed_tokens.weight": top["model.embed_tokens.weight"]} if k == 0 else {}
        for i in range(k * per_shard, min(cfg.n_layers, (k + 1) * per_shard)):
            tensors.update({f"model.layers.{i}.{name}": t for name, t in llama_layer(torch, base, i).items()})
        if k == shards - 1:
            tensors.update({n: top[n] for n in ("model.norm.weight", "lm_head.weight")})
        save_safetensors(tensors, os.path.join(path, fname))
        weight_map.update({name: fname for name in tensors})
        total += sum(t.numel() * t.element_size() for t in tensors.values())
        del tensors
    with open(os.path.join(path, "model.safetensors.index.json"), "w", encoding="utf-8") as fh:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, fh)
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as fh:
        json.dump({"architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff, "num_hidden_layers": cfg.n_layers,
                   "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
                   "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
                   "max_position_embeddings": cfg.max_seq_len, "tie_word_embeddings": False,
                   "torch_dtype": "bfloat16"}, fh)
    return dict(base=base, top=top, bytes=total, seconds=time.perf_counter() - t0)


# (ours, HF name in a layer) of the families' float trees: the attention
# projections of every family, then each family's MLP and norms.
FAMILY_ATTN = (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"), ("wv", "self_attn.v_proj"),
               ("wo", "self_attn.o_proj"))
FAMILY_MLP = {
    "gated": (("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"), ("w_down", "mlp.down_proj")),
    "plain": (("w_up", "mlp.c_fc"), ("w_down", "mlp.c_proj")),
    "moe": (("w_gate_e", "w1"), ("w_up_e", "w3"), ("w_down_e", "w2")),
}
FAMILY_NORMS = (("attn_norm", "input_layernorm"), ("mlp_norm", "post_attention_layernorm"))


def family_hf_tensors(cfg, params) -> dict:
    """A float param tree in the port's layout (``models.llama.init_params``':
    (in, out) matrices stacked over layers) as HF tensors by name, (out, in):
    Llama / Gemma / Mixtral names (the ``block_sparse_moe`` router and
    experts for a MoE tree) or StarCoder2's (LayerNorm and projection biases,
    ``c_fc`` / ``c_proj``).  A tree whose head is its embedding's transpose
    writes no ``lm_head.weight``: a tied checkpoint."""
    lay = params["layers"]
    out = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    if "final_norm_b" in params:
        out["model.norm.bias"] = params["final_norm_b"]
    tied = params["lm_head"].data_ptr() == params["embed"].data_ptr()
    if not tied:
        out["lm_head.weight"] = params["lm_head"].T
    mlp = "moe" if "router" in lay else "gated" if "w_gate" in lay else "plain"
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        for ours, hf in FAMILY_NORMS:
            out[pre + hf + ".weight"] = lay[ours][i]
            if ours + "_b" in lay:
                out[pre + hf + ".bias"] = lay[ours + "_b"][i]
        bias = dict(wq="bq", wk="bk", wv="bv", wo="bo", w_gate="b_gate", w_up="b_up", w_down="b_down")
        for ours, hf in FAMILY_ATTN + (() if mlp == "moe" else FAMILY_MLP[mlp]):
            out[pre + hf + ".weight"] = lay[ours][i].T
            if bias[ours] in lay:
                out[pre + hf + ".bias"] = lay[bias[ours]][i]
        if mlp == "moe":
            out[pre + "block_sparse_moe.gate.weight"] = lay["router"][i].T
            for e in range(cfg.n_experts):
                for ours, hf in FAMILY_MLP["moe"]:
                    out[pre + f"block_sparse_moe.experts.{e}.{hf}.weight"] = lay[ours][i, e].T
    return {name: t.contiguous() for name, t in out.items()}


def family_hf_config(cfg) -> dict:
    """A ``config.json`` for :func:`family_hf_tensors`' checkpoint of
    ``cfg``'s family."""
    arch, mtype = (("MixtralForCausalLM", "mixtral") if cfg.n_experts > 1 else
                   ("Starcoder2ForCausalLM", "starcoder2") if cfg.norm_type == "layernorm" else
                   ("GemmaForCausalLM", "gemma") if cfg.norm_unit_offset else ("LlamaForCausalLM", "llama"))
    out = {"architectures": [arch], "model_type": mtype, "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
           "intermediate_size": cfg.d_ff, "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
           "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim, "rope_theta": cfg.rope_theta,
           "max_position_embeddings": cfg.max_seq_len, "torch_dtype": "bfloat16"}
    if cfg.n_experts > 1:
        out.update(num_local_experts=cfg.n_experts, num_experts_per_tok=cfg.n_experts_per_tok)
    return out


def write_family_checkpoint(torch, path, cfg, params) -> dict:
    """:func:`family_hf_tensors` of ``params`` (on any device) as
    ``model.safetensors`` with :func:`family_hf_config` under ``path``;
    returns the tensors written, on the host."""
    from generativeaiexamples_tpu_torch.engine.weights import save_safetensors

    os.makedirs(path, exist_ok=True)
    tensors = {name: t.cpu() for name, t in family_hf_tensors(cfg, params).items()}
    save_safetensors(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as fh:
        json.dump(family_hf_config(cfg), fh)
    return tensors


def numpy_quantized(np, base: dict, top: dict) -> dict:
    """numpy's quantization (:func:`np_int8`, per HF row = per output
    channel) of the base layer's projections, the embedding and the head,
    by HF name: (codes, scales)."""
    names = [name for _, name in LLAMA_PROJ] + ["model.embed_tokens.weight", "lm_head.weight"]
    return {name: np_int8(np, (base[name] if name in base else top[name]).float().numpy(), axis=1)
            for name in names}


def numpy_llama_tree(torch, cfg, quantized: dict, base: dict, top: dict, dev) -> dict:
    """The seeded checkpoint quantized by numpy (:func:`numpy_quantized`)
    as a param tree of the port's ``QuantizedMatrix`` leaves on ``dev``,
    which ``prepare_params`` packs and blocks as it finds them.  Layer
    ``i``'s codes and scales are the base layer's rolled by ``i`` output
    channels: a quantization per output channel commutes with a
    permutation of the channels, so these are numpy's codes of layer ``i``
    itself."""
    from generativeaiexamples_tpu_torch.ops.quant import QuantizedMatrix

    L = cfg.n_layers
    layers = {}
    for ours, name in LLAMA_NORMS:
        layers[ours] = torch.stack([torch.roll(base[name], i, 0) for i in range(L)]).to(dev)
    for ours, name in LLAMA_PROJ:
        codes, scale = quantized[name]  # (out, in), (out, 1)
        codes, scale = torch.from_numpy(codes).to(dev), torch.from_numpy(scale[:, 0]).to(dev)
        q = torch.empty((L, codes.shape[1], codes.shape[0]), dtype=torch.int8, device=dev)
        s = torch.empty((L, 1, codes.shape[0]), dtype=torch.float32, device=dev)
        for i in range(L):
            q[i].copy_(torch.roll(codes, i, 0).T)
            s[i, 0].copy_(torch.roll(scale, i, 0))
        layers[ours] = QuantizedMatrix(q=q, scale=s)
        del codes, scale
    embed_codes, embed_scale = quantized["model.embed_tokens.weight"]
    head_codes, head_scale = quantized["lm_head.weight"]
    return {
        "embed": QuantizedMatrix(q=torch.from_numpy(embed_codes).to(dev), scale=torch.from_numpy(embed_scale).to(dev)),
        "layers": layers,
        "final_norm": top["model.norm.weight"].to(dev),
        "lm_head": QuantizedMatrix(q=torch.from_numpy(head_codes).to(dev).T.contiguous(),
                                   scale=torch.from_numpy(head_scale).to(dev).T.contiguous()),
    }


def check_loaded_llama(torch, np, cfg, params, base: dict, quantized: dict) -> dict:
    """The served params' int8 codes and f32 scales against numpy's
    quantization of the written bf16 arrays, bit for bit: every projection
    of the first (the base layer: ``quantized``), a middle and the last
    layer (quantized here from the rolled arrays), the head and the
    embedding."""
    checked, bad = [], []
    hf = dict(LLAMA_PROJ)
    for i in sorted({0, cfg.n_layers // 2, cfg.n_layers - 1}):
        layer = llama_layer(torch, base, i)

        def numpy_q(name):
            return quantized[name] if i == 0 else np_int8(np, layer[name].float().numpy(), axis=1)

        for fused, parts in LLAMA_FUSED:
            codes, scales = zip(*(numpy_q(hf[p]) for p in parts))
            bm = params["layers"][fused]
            got_q, got_s = bm.w[i, : bm.n, : bm.k], bm.scale[i, : bm.n]
            if not (_bits_equal(torch, got_q, np.concatenate(codes)) and
                    _bits_equal(torch, got_s, np.concatenate(scales)[:, 0])):
                bad.append(f"layer {i} {fused}")
            checked.append(f"{i}.{fused}")
    for name, key, to_ours in (("embed", "model.embed_tokens.weight", False), ("lm_head", "lm_head.weight", True)):
        codes, scale = quantized[key]
        qm = params[name]
        got_q, got_s = (qm.q.T, qm.scale.T) if to_ours else (qm.q, qm.scale)
        if not (_bits_equal(torch, got_q.to(torch.int8), codes) and _bits_equal(torch, got_s, scale)):
            bad.append(name)
        checked.append(name)
    if bad:
        raise AssertionError(f"loaded int8 leaves differ from numpy's quantization of the checkpoint: {bad}")
    return dict(leaves_checked=len(checked), layers_checked=sorted({0, cfg.n_layers // 2, cfg.n_layers - 1}),
                int8_bitwise_equal_to_numpy=True)


def _hf_requests(base_url, prompts) -> dict:
    """The phase's greedy requests over one front: four completions sent
    together, then the shortest and the longest sent alone (32 tokens
    each).  Returns each request's text by name."""
    picks = {f"batch_{n}": prompts["completions"][prompts["lengths"].index(n)] for n in (20, 140, 450, 650)}
    workers, results = _concurrent(base_url, list(picks.values()))
    for w in workers:
        w.join(timeout=900)
    if len(results) != len(picks):
        raise AssertionError("hf_checkpoint: a completion did not return")
    texts = {name: results[i]["choices"][0]["text"] for i, name in enumerate(picks)}
    for n in (20, 650):
        texts[f"alone_{n}"] = _complete(base_url, picks[f"batch_{n}"])["choices"][0]["text"]
    return texts


def _hf_serve(torch, _cuda, server, prompts, kv_layout: str) -> tuple[dict, dict]:
    """Start ``server``'s scheduler and front, warm them, zero the launch
    counts, send the phase's requests, and read the counts: every kernel
    of the layout's path must have launched, the other layout's decode
    kernel not.  Returns (texts, launches); the server is shut down."""
    sched = server.scheduler
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    sched.start()
    thread.start()
    base_url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _complete(base_url, prompts["warmup"], 4)
        _cuda.reset_launch_counts()
        texts = _hf_requests(base_url, prompts)
        launches = dict(_cuda.LAUNCHES)
        want, other = PATH_KERNELS[kv_layout]
        if not all(launches[k] for k in want) or launches[other]:
            raise AssertionError(f"hf_checkpoint {kv_layout} path launches: {launches}")
        return texts, launches
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=30)
        sched._cache = sched._pool = None


def bert_hf_tensors(torch, np, rng, cfg, cross_encoder: bool = False) -> dict:
    """A random BERT checkpoint of ``cfg``'s geometry in HF names, bf16: a
    ``BertModel``, or with ``cross_encoder`` a ``BertForSequenceClassification``
    (``bert.``-prefixed, a pooler and a 1-logit classifier)."""
    d, f = cfg.d_model, cfg.d_ff

    def g(*shape):
        return _bf16_gauss(torch, np, rng, shape)

    def norm(prefix):
        return {f"{prefix}.weight": _bf16_gauss(torch, np, rng, (d,), 0.1, 1.0),
                f"{prefix}.bias": _bf16_gauss(torch, np, rng, (d,), 0.02)}

    out = {"embeddings.word_embeddings.weight": g(cfg.vocab_size, d),
           "embeddings.position_embeddings.weight": g(cfg.max_positions, d),
           "embeddings.token_type_embeddings.weight": g(cfg.type_vocab_size, d), **norm("embeddings.LayerNorm")}
    for i in range(cfg.n_layers):
        lay = f"encoder.layer.{i}."
        for proj in ("attention.self.query", "attention.self.key", "attention.self.value", "attention.output.dense"):
            out.update({f"{lay}{proj}.weight": g(d, d), f"{lay}{proj}.bias": g(d)})
        out.update({f"{lay}intermediate.dense.weight": g(f, d), f"{lay}intermediate.dense.bias": g(f),
                    f"{lay}output.dense.weight": g(d, f), f"{lay}output.dense.bias": g(d),
                    **norm(f"{lay}attention.output.LayerNorm"), **norm(f"{lay}output.LayerNorm")})
    if cross_encoder:
        out = {f"bert.{k}": v for k, v in out.items()}
        out.update({"bert.pooler.dense.weight": g(d, d), "bert.pooler.dense.bias": g(d),
                    "classifier.weight": g(1, d), "classifier.bias": g(1)})
    return out


def bert_tree_from_hf(torch, np, cfg, tensors: dict, dev) -> tuple:
    """The written BERT tensors as the port's tree (and rerank head), built
    through ``engine.weights.bert_params_from_numpy`` from f32 numpy
    arrays of the bf16 values, then held in bf16 as written."""
    from generativeaiexamples_tpu_torch.engine.weights import bert_params_from_numpy, rerank_head_from_numpy

    t = {k[5:] if k.startswith("bert.") else k: v for k, v in tensors.items()}

    def a(name, transpose=False):
        v = t[name].T if transpose else t[name]
        return v.float().numpy()

    def stack(fmt, transpose):
        return np.stack([a(fmt.format(i), transpose) for i in range(cfg.n_layers)])

    lay = "encoder.layer.{}."
    tree = {"tok_embed": a("embeddings.word_embeddings.weight"), "pos_embed": a("embeddings.position_embeddings.weight"),
            "type_embed": a("embeddings.token_type_embeddings.weight"), "embed_norm_g": a("embeddings.LayerNorm.weight"),
            "embed_norm_b": a("embeddings.LayerNorm.bias"), "layers": {}}
    for ours, name, tr in (("wq", "attention.self.query.weight", True), ("bq", "attention.self.query.bias", False),
                           ("wk", "attention.self.key.weight", True), ("bk", "attention.self.key.bias", False),
                           ("wv", "attention.self.value.weight", True), ("bv", "attention.self.value.bias", False),
                           ("wo", "attention.output.dense.weight", True), ("bo", "attention.output.dense.bias", False),
                           ("attn_norm_g", "attention.output.LayerNorm.weight", False),
                           ("attn_norm_b", "attention.output.LayerNorm.bias", False),
                           ("w_up", "intermediate.dense.weight", True), ("b_up", "intermediate.dense.bias", False),
                           ("w_down", "output.dense.weight", True), ("b_down", "output.dense.bias", False),
                           ("mlp_norm_g", "output.LayerNorm.weight", False), ("mlp_norm_b", "output.LayerNorm.bias", False)):
        tree["layers"][ours] = stack(lay + name, tr)

    def bf16(tree_):
        return {k: bf16(v) if isinstance(v, dict) else v.to(cfg.compute_dtype) for k, v in tree_.items()}

    params = bf16(bert_params_from_numpy(tree, cfg, dev))
    head = None
    if "classifier.weight" in t:
        head = bf16(rerank_head_from_numpy({"w_pool": a("pooler.dense.weight", True), "b_pool": a("pooler.dense.bias"),
                                            "w": a("classifier.weight", True), "b": a("classifier.bias")}, dev))
    return params, head


def _tree_bits_equal(torch, got: dict, want: dict) -> list:
    bad = []
    for k, v in want.items():
        if isinstance(v, dict):
            bad += [f"{k}.{b}" for b in _tree_bits_equal(torch, got[k], v)]
        elif got[k].dtype != v.dtype or not _bits_equal(torch, got[k], v.cpu()):
            bad.append(k)
    return bad


def write_bert_checkpoint(torch, np, path, cfg, vocab: list, seed: int, cross_encoder: bool = False) -> dict:
    """A BERT checkpoint (bf16 ``model.safetensors``, ``config.json``,
    ``vocab.txt``, ``tokenizer_config.json``) from numpy seed ``seed``;
    returns the written tensors."""
    from generativeaiexamples_tpu_torch.engine.weights import save_safetensors

    os.makedirs(path, exist_ok=True)
    tensors = bert_hf_tensors(torch, np, np.random.default_rng(seed), cfg, cross_encoder)
    save_safetensors(tensors, os.path.join(path, "model.safetensors"))
    arch = "BertForSequenceClassification" if cross_encoder else "BertModel"
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as fh:
        json.dump({"architectures": [arch], "model_type": "bert", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
                   "intermediate_size": cfg.d_ff, "max_position_embeddings": cfg.max_positions,
                   "type_vocab_size": cfg.type_vocab_size, "layer_norm_eps": cfg.norm_eps, "hidden_act": "gelu",
                   "num_labels": 1, "torch_dtype": "bfloat16"}, fh)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(vocab) + "\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w", encoding="utf-8") as fh:
        json.dump({"do_lower_case": True}, fh)
    return tensors


def wordpiece_vocab(seed: int, size: int) -> tuple[list, list]:
    """A BERT-style vocabulary of ``size`` entries: the specials at BERT's
    ids ([PAD] 0, [unused*] 1-99, [UNK] 100, [CLS] 101, [SEP] 102, [MASK]
    103), punctuation, letters and digits whole and as ``##`` pieces, then
    seeded words and ``##`` suffixes.  Returns (vocab, words)."""
    import random

    rng = random.Random(seed)
    chars = [chr(c) for c in range(ord("a"), ord("z") + 1)] + list("0123456789")
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~") + chars + ["##" + c for c in chars]
    seen = set(vocab)
    words = []
    while len(vocab) < size:
        n = rng.randint(2, 4) if rng.random() < 0.25 else rng.randint(3, 10)
        token = "".join(rng.choice(chars[:26]) for _ in range(n))
        token = "##" + token if n <= 4 and rng.random() < 0.6 else token
        if token not in seen:
            seen.add(token)
            vocab.append(token)
            if not token.startswith("##"):
                words.append(token)
    return vocab, words


def vocab_texts(seed: int, words: list, n: int, n_words: int) -> list:
    """``n`` texts of ``n_words`` words each: vocabulary words, compounds of
    two (which split into a word and ``##`` pieces), capitals, digits and
    punctuation."""
    import random

    rng = random.Random(seed)
    out = []
    for _ in range(n):
        parts = []
        for _ in range(n_words):
            r = rng.random()
            w = rng.choice(words)
            if r < 0.2:
                w = w + rng.choice(words)
            elif r < 0.3:
                w = w.capitalize()
            elif r < 0.35:
                w = str(rng.randint(0, 9999))
            parts.append(w + (rng.choice(",.;!?") if rng.random() < 0.1 else ""))
        out.append(" ".join(parts))
    return out


HF_DOCS, HF_QUERIES, HF_PASSAGES = 256, 32, 16
HF_DOC_WORDS, HF_QUERY_WORDS = 400, 12


def hf_embed_and_rerank(torch, np, dev, root) -> dict:
    """arctic-embed-l-shaped embedder and cross-encoder checkpoints (24
    layers, bf16, seeds 1 and 2) with a 30,522-entry ``vocab.txt``, loaded
    through ``chains.factory``'s ``get_embedder`` / ``get_reranker`` from
    ``APP_*``: their leaves equal the written arrays, the WordPiece ids come
    from the native library and equal the Python path's, 256 documents and
    32 queries embed unit-norm and finite within ``EMBED_TOL`` of a
    ``GPUEmbedder`` on ``bert_params_from_numpy`` of the same arrays, and
    32 queries x 16 passages rerank in two segments within ``BERT_TOL`` of
    a direct ``score_pairs`` on the same head."""
    from generativeaiexamples_tpu_torch.chains import factory
    from generativeaiexamples_tpu_torch.core.configuration import reset_config_cache
    from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
    from generativeaiexamples_tpu_torch.engine.reranker import GPUReranker
    import dataclasses

    from generativeaiexamples_tpu_torch.engine.tokenizer import WordPieceTokenizer
    from generativeaiexamples_tpu_torch.models import bert

    cfg = dataclasses.replace(bert.arctic_embed_l(), n_layers=HF_BERT_LAYERS)
    vocab, words = wordpiece_vocab(HF_SEED, cfg.vocab_size)
    t0 = time.perf_counter()
    emb_dir, rr_dir = (os.path.join(root, n.replace("/", "--")) for n in (EMBED_HF, RERANK_HF))
    emb_tensors = write_bert_checkpoint(torch, np, emb_dir, cfg, vocab, seed=1)
    rr_tensors = write_bert_checkpoint(torch, np, rr_dir, cfg, vocab, seed=2, cross_encoder=True)
    write_s = time.perf_counter() - t0
    written_gb = sum(t.numel() * t.element_size() for d in (emb_tensors, rr_tensors) for t in d.values()) / 1e9
    env = dict(APP_EMBEDDINGS_MODELENGINE="tpu", APP_EMBEDDINGS_MODELNAME=EMBED_HF, APP_EMBEDDINGS_DIMENSIONS=str(cfg.d_model),
               APP_RANKING_MODELENGINE="tpu", APP_RANKING_MODELNAME=RERANK_HF)
    os.environ.update(env)
    reset_config_cache()
    factory.reset_factories()
    try:
        t0 = time.perf_counter()
        embedder, reranker = factory.get_embedder(), factory.get_reranker()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        tok = embedder.tokenizer
        if not (isinstance(tok, WordPieceTokenizer) and isinstance(reranker.tokenizer, WordPieceTokenizer)):
            raise AssertionError(f"hf_checkpoint: factory tokenizers {type(tok).__name__}, "
                                 f"{type(reranker.tokenizer).__name__}")
        if embedder.device.type != "cuda" or reranker.device.type != "cuda":
            raise AssertionError("hf_checkpoint: the factory's embedder or reranker is not on the card")
        want_params, _ = bert_tree_from_hf(torch, np, cfg, emb_tensors, dev)
        want_rr, want_head = bert_tree_from_hf(torch, np, cfg, rr_tensors, dev)
        bad = (_tree_bits_equal(torch, embedder.params, want_params) + _tree_bits_equal(torch, reranker.params, want_rr)
               + [f"head.{k}" for k in _tree_bits_equal(torch, reranker.head, want_head)])
        if bad:
            raise AssertionError(f"hf_checkpoint: loaded BERT leaves differ from the written arrays: {bad[:8]}")
        docs = vocab_texts(3, words, HF_DOCS, HF_DOC_WORDS)
        queries = vocab_texts(4, words, HF_QUERIES, HF_QUERY_WORDS)
        passages = docs[:HF_PASSAGES]
        if tok.native_handle() is None:
            raise AssertionError("hf_checkpoint: the native WordPiece library is not live")
        python_tok = WordPieceTokenizer({t: i for i, t in enumerate(vocab)}, lowercase=True)
        python_tok._native_tried = True  # pin the Python path
        texts = docs + [embedder.query_prefix + q for q in queries]
        t0 = time.perf_counter()
        native_ids = [tok.tokenize_ids(t) for t in texts]
        native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        python_ids = [python_tok.tokenize_ids(t) for t in texts]
        python_ms = (time.perf_counter() - t0) * 1e3
        if native_ids != python_ids:
            raise AssertionError("hf_checkpoint: native WordPiece ids differ from the Python path's")
        n_pieces = sum(1 for ids in native_ids for i in ids if vocab[i].startswith("##"))
        n_unk = sum(ids.count(100) for ids in native_ids)
        t0 = time.perf_counter()
        doc_vecs = torch.tensor(embedder.embed_documents(docs))
        query_vecs = torch.tensor([embedder.embed_query(q) for q in queries])
        torch.cuda.synchronize()
        embed_s = time.perf_counter() - t0
        direct = GPUEmbedder(cfg, want_params, tokenizer=python_tok, device=dev)
        direct_docs = torch.tensor(direct.embed_documents(docs))
        direct_queries = torch.tensor([direct.embed_query(q) for q in queries])
        if not (_unit_rows(torch, doc_vecs) and _unit_rows(torch, query_vecs)):
            raise AssertionError("hf_checkpoint: embeddings are not unit-norm and finite")
        torch.testing.assert_close(doc_vecs, direct_docs, **EMBED_TOL)
        torch.testing.assert_close(query_vecs, direct_queries, **EMBED_TOL)
        pairs = [(q, p) for q in queries for p in passages]
        encoded = [reranker._encode_pair(reranker._query_ids(q), p) for q, p in pairs]
        if any(sorted(set(types)) != [0, 1] or ids[0] != 101 or ids.count(102) != 2 for ids, types in encoded):
            raise AssertionError("hf_checkpoint: a rerank pair is not [CLS] q [SEP] p [SEP] in segments 0 and 1")
        t0 = time.perf_counter()
        scores = torch.tensor(reranker.score_pairs(pairs))
        torch.cuda.synchronize()
        rerank_s = time.perf_counter() - t0
        direct_rr = GPUReranker(cfg, want_rr, want_head, tokenizer=python_tok, device=dev)
        direct_scores = torch.tensor(direct_rr.score_pairs(pairs))
        torch.testing.assert_close(scores, direct_scores, **BERT_TOL)
        return dict(
            bert_written_gb=written_gb, bert_write_s=write_s, bert_load_s=load_s, vocab_size=len(vocab),
            bert_leaves_bitwise_equal=True, wordpiece="native", native_equals_python=True,
            tokenized_texts=len(texts), tokens=sum(map(len, native_ids)), wordpiece_continuations=n_pieces,
            unk_tokens=n_unk, native_tokenize_ms=native_ms, python_tokenize_ms=python_ms,
            embedded_docs=len(docs), embedded_queries=len(queries), embed_s=embed_s,
            embed_max_abs_err=max((doc_vecs - direct_docs).abs().max().item(),
                                  (query_vecs - direct_queries).abs().max().item()),
            reranked_pairs=len(pairs), rerank_s=rerank_s, two_segment_pairs=len(encoded),
            rerank_max_abs_err=(scores - direct_scores).abs().max().item(),
        )
    finally:
        factory.reset_factories()
        for key in env:
            del os.environ[key]
        reset_config_cache()


def hf_checkpoint_phase(torch, dev, _cuda, smi: str, prompts) -> dict:
    """Serve checkpoints written from a seed through the normal entry
    points.  A full-width Llama-3-8B checkpoint at ``HF_LLAMA_LAYERS`` of
    its 32 layers (bf16, four shards, about 9 GB) loads through
    ``build_server`` (the preset at that depth) and
    ``$GAIE_WEIGHTS_DIR``; its int8 codes and scales equal numpy's
    quantization bit for bit (:func:`check_loaded_llama`, after
    :func:`check_quantizers`); its greedy streams equal a ``Scheduler``'s
    on the numpy-quantized tree, and a paged ``Scheduler``'s on the loaded
    params, with K1-K4 each launched; then the embedder and cross-encoder
    checkpoints (:func:`hf_embed_and_rerank`).  Returns each path's
    launches."""
    import resource
    import shutil
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import build_server, create_engine_app
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.models import llama

    t_phase = time.perf_counter()
    fields = dict(nvidia_smi=smi, **check_quantizers(torch, dev))
    root = tempfile.mkdtemp(prefix="hf_checkpoints_")
    try:
        cfg = llama.llama3_8b(kv_dtype="int8", n_layers=HF_LLAMA_LAYERS)
        ckpt = write_llama_checkpoint(torch, np, os.path.join(root, LLAMA_HF.replace("/", "--")), cfg)
        base, top = ckpt.pop("base"), ckpt.pop("top")
        fields.update(model=LLAMA_HF, layers=cfg.n_layers, d_model=cfg.d_model, shards=HF_SHARDS,
                      weights=f"bf16 from numpy seed {HF_SEED}, layer i = the base layer rolled by i rows",
                      written_gb=ckpt["bytes"] / 1e9, write_s=ckpt["seconds"])
        gc.collect()
        os.environ["GAIE_WEIGHTS_DIR"] = root
        kw = serve_kw("contiguous")
        argv = ["--model", LLAMA_HF, "--host", "127.0.0.1", "--port", "0", "--embedder", "none",
                "--max-batch", str(kw["max_batch"]), "--max-len", str(kw["max_len"]), "--matmul-kernel", "pallas_w8a8"]
        torch.cuda.reset_peak_memory_stats(dev)
        page = os.sysconf("SC_PAGE_SIZE")
        with open("/proc/self/statm", encoding="ascii") as fh:
            rss_before = int(fh.read().split()[1]) * page
        t0 = time.perf_counter()
        with _PeakRSS() as rss, _PresetDepth("llama3-8b", HF_LLAMA_LAYERS):
            server = build_server(argv)
            torch.cuda.synchronize()
        fields.update(load_s=time.perf_counter() - t0, device_gb_after_load=torch.cuda.memory_allocated(dev) / 1e9,
                      peak_device_gb_load=torch.cuda.max_memory_allocated(dev) / 1e9,
                      rss_before_load_gb=rss_before / 1e9, peak_rss_load_gb=rss.peak / 1e9,
                      ru_maxrss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
                      tokenizer=type(server.tokenizer).__name__)
        # An f32 copy of the model would be 32 GB on the host, a bf16 one 16 GB;
        # the loader holds one tensor's pages at a time (the embedding's 1.05
        # GB at most, which grew the resident set by ~1.8 GB on the H100
        # host: PERF.md).
        if rss.peak - rss_before > 8e9:
            raise AssertionError(f"hf_checkpoint: the load grew the host's resident set by "
                                 f"{(rss.peak - rss_before) / 1e9:.2f} GB")
        sched = server.scheduler
        if sched.device.type != "cuda":
            raise AssertionError("hf_checkpoint: build_server did not serve on the card")
        t0 = time.perf_counter()
        quantized = numpy_quantized(np, base, top)
        fields.update(check_loaded_llama(torch, np, cfg, sched.params, base, quantized),
                      check_s=time.perf_counter() - t0)
        launches = {}
        texts, launches["server"] = _hf_serve(torch, _cuda, server, prompts, "contiguous")
        params = sched.params
        del server, sched
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with torch.inference_mode():
            direct = Scheduler(cfg, numpy_llama_tree(torch, cfg, quantized, base, top, dev), device=dev,
                               matmul_kernel="pallas_w8a8", **kw)
        fields["numpy_tree_s"] = time.perf_counter() - t0
        del base, top, quantized
        direct_texts, launches["direct"] = _hf_serve(
            torch, _cuda, create_engine_app(direct, get_tokenizer(LLAMA_HF), LLAMA_HF, "127.0.0.1", 0), prompts,
            "contiguous")
        if direct_texts != texts:
            raise AssertionError(f"hf_checkpoint: the loaded server's streams differ from the numpy-quantized "
                                 f"scheduler's:\n{texts}\n{direct_texts}")
        del direct
        gc.collect()
        torch.cuda.empty_cache()
        paged = Scheduler(cfg, params, device=dev, matmul_kernel="pallas_w8a8", **serve_kw("paged"))
        paged_texts, launches["paged"] = _hf_serve(
            torch, _cuda, create_engine_app(paged, get_tokenizer(LLAMA_HF), LLAMA_HF, "127.0.0.1", 0), prompts,
            "paged")
        if paged_texts != texts:
            raise AssertionError(f"hf_checkpoint: paged streams differ from contiguous:\n{texts}\n{paged_texts}")
        del paged, params
        gc.collect()
        torch.cuda.empty_cache()
        fields.update(requests=len(texts), streams_equal=["server", "direct", "paged"], launches=launches)
        shutil.rmtree(os.path.join(root, LLAMA_HF.replace("/", "--")))
        fields.update(hf_embed_and_rerank(torch, np, dev, root))
    finally:
        os.environ.pop("GAIE_WEIGHTS_DIR", None)
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    fields["seconds"] = time.perf_counter() - t_phase
    emit("hf_checkpoint", **fields)
    return launches


# ---------------------------------------------------------------------------
# families: Gemma, StarCoder2 and Mixtral through the serving path
# ---------------------------------------------------------------------------

# (HF id, preset) of each family the phase serves.
FAMILY_MODELS = (("google/gemma-2b", "gemma-2b"), ("google/gemma-7b", "gemma-7b"),
                 ("bigcode/starcoder2-3b", "starcoder2-3b"), ("mistralai/Mixtral-8x7B-Instruct-v0.1", "mixtral-8x7b"))
# Mixtral's bf16 experts are 2.82 GB a layer, 90 GB at its 32 layers (more
# than the card holds; the reference keeps them bf16 too).  Each family is
# served at a quarter of its depth and Mixtral at 2 layers, so the whole
# script stays inside its time limit beside the scale-out retrieval phases
# (half and 4 beside the pool phase; all layers and Mixtral at 8 before it;
# 16 before the xla_path phase).
FAMILY_SERVED_LAYERS = {"gemma-2b": 5, "gemma-7b": 7, "starcoder2-3b": 8, "mixtral-8x7b": 2}
FAMILY_PAGED = ("gemma-2b", "starcoder2-3b")
FAMILY_CHECKPOINTS = ("gemma-7b", "starcoder2-3b", "mixtral-8x7b")
FAMILY_VOCAB_STRIDE = 8  # rows of the embedding and head held against numpy
# Depth of the card-vs-CPU models and of the seeded checkpoints.
FAMILY_REF_LAYERS = 2
# The card-vs-CPU logits at full width, 2 layers, bf16, as a share of the
# logits' own size: the RMS error at most 10% of their RMS, the largest
# error at most 25% of the largest logit.  W8A8 re-quantizes each
# projection's input per token, so a one-ulp bf16 difference (the
# attention kernels round in other places than the plain versions) flips
# int8 codes near a rounding edge, and the flips grow over the layers and
# the widths: on an H100 the sound code reads an RMS of 4.3% (Gemma-2B),
# 4.6% (Gemma-7B), 2.2% (StarCoder2-3B) and 5.1% (Mixtral), and a planted
# wrong second 8-head tile in StarCoder2's decode instance 57%
# (perf_torch/rehearse_family_tol.py).  A MoE token whose experts differ
# between the sides (a router near tie) moved by 29% of the largest logit
# (1.75 of 6.05): the largest-error bound reads the tokens routed alike, and fewer
# than one token in 8 may be routed elsewhere (none of the decode step's
# 2).  A wrong float product hides in the flips (bf16 partial sums read
# 9.7%): :func:`moe_products_vs_cpu` holds the MoE's products directly.
FAMILY_TOL = dict(rel_rms=0.1, max_abs_frac=0.25)


class _PresetDepth:
    """``models.llama.PRESETS[name]`` at ``n_layers`` while entered (None:
    as it is): the entry points read a model's geometry from its preset."""

    def __init__(self, name: str, n_layers):
        self.name, self.n_layers = name, n_layers

    def __enter__(self):
        from generativeaiexamples_tpu_torch.models import llama

        self.saved = llama.PRESETS[self.name]
        if self.n_layers is not None:
            llama.PRESETS[self.name] = lambda **kw: self.saved(**{"n_layers": self.n_layers, **kw})
        return self

    def __exit__(self, *exc):
        from generativeaiexamples_tpu_torch.models import llama

        llama.PRESETS[self.name] = self.saved


def family_path(cfg) -> dict:
    """The kernel instances a family's serving path must launch: K2/K3's
    (head_dim, max group) and K4's head_dim."""
    from generativeaiexamples_tpu_torch.ops import decode_attention as da

    return dict(decode_instance="%dx%d" % da.decode_instance(cfg.head_dim, cfg.n_heads // cfg.n_kv_heads),
                flash_hd=cfg.head_dim)


def _completion(base_url, prompt, max_tokens=32) -> dict:
    """A greedy ``/v1/completions`` that must answer 200 with
    ``max_tokens`` tokens (random weights may emit no printable text)."""
    status, body = _post(base_url + "/v1/completions", {"prompt": prompt, "max_tokens": max_tokens, "temperature": 0})
    out = json.loads(body) if status == 200 else {}
    if status != 200 or out["usage"]["completion_tokens"] != max_tokens:
        raise AssertionError(f"completion of a {len(prompt) + 1}-token prompt failed: {status} {body[:300]}")
    return out


def _family_requests(torch, _cuda, server, prompts, kv_layout: str, path: dict) -> tuple[dict, dict, dict]:
    """The phase's requests on one front: the 20- and 650-token prompts
    together, then each alone (32 greedy tokens each), the emitted ids
    recorded at the scheduler (:class:`StreamTee`).  Launch counts are
    zeroed after a warm-up and read after the four: K1, the layout's decode
    kernel at the family's instance and K4 at its head_dim must have
    launched, the other layout's decode kernel not.  The prompts sent alone
    must emit the ids they emitted together.  Returns (ids by prompt
    length, launches, timing: TTFT p50 and decode tokens/s)."""
    sched = server.scheduler
    tee = StreamTee(sched)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    sched.start()
    thread.start()
    base_url = f"http://127.0.0.1:{server.server_address[1]}"
    picks = {n: prompts["completions"][prompts["lengths"].index(n)] for n in (20, 650)}
    try:
        _completion(base_url, prompts["warmup"], 4)
        n_ttft0 = len(sched.stats.ttft_recent)
        snap0 = sched.stats.snapshot()
        _cuda.reset_launch_counts()
        results: dict = {}
        workers = [threading.Thread(target=lambda n=n: results.__setitem__(n, _completion(base_url, picks[n])))
                   for n in picks]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=900)
        if len(results) != len(picks):
            raise AssertionError("families: a completion did not return")
        for prompt in picks.values():
            _completion(base_url, prompt)
        snap1 = sched.stats.snapshot()
        launches = dict(_cuda.LAUNCHES)
        decode_kernel = "paged_decode_attention" if kv_layout == "paged" else "decode_attention"
        instances = {k: dict(v) for k, v in _cuda.DECODE_INSTANCE_LAUNCHES.items()}
        flash_hd = dict(_cuda.FLASH_HD_LAUNCHES)
        want, other = PATH_KERNELS[kv_layout]
        if (not all(launches[k] for k in want) or launches[other] or not instances[decode_kernel][path["decode_instance"]]
                or not flash_hd[path["flash_hd"]]):
            raise AssertionError(f"families {kv_layout} path launches: {launches} {instances} {flash_hd} "
                                 f"(wanted {want}, {path})")
        streams = {}
        for n in picks:
            runs = [list(ids) for prompt, _, ids in tee.records if len(prompt) == n]
            if len(runs) != 2 or runs[0] != runs[1] or len(runs[0]) != 32:
                raise AssertionError(f"families {kv_layout}: the {n}-token prompt alone emitted other ids than "
                                     f"together: {runs}")
            streams[n] = runs[0]
        ttfts = sorted(list(sched.stats.ttft_recent)[n_ttft0:])
        decode_tokens = (snap1["tokens_total"] - snap0["tokens_total"]) - (snap1["requests_total"] - snap0["requests_total"])
        decode_s = snap1["decode_s"] - snap0["decode_s"]
        timing = dict(ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3 if ttfts else None,
                      decode_tokens_per_s=decode_tokens / decode_s if decode_s else None)
        launches.update(decode_instance_launches=instances[decode_kernel], flash_hd_launches=flash_hd)
        return streams, launches, timing
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=30)
        sched._cache = sched._pool = None


def family_serve(torch, dev, _cuda, hf_id: str, preset: str, prompts) -> dict:
    """One family through ``build_server(["--model", hf_id, ...])`` on the
    card, random int8 weights from a seed (MoE experts bf16), at full width
    and its served depth: the prompts sent alone give the text they gave
    together, and a paged ``Scheduler`` on the same params gives the same
    texts (:data:`FAMILY_PAGED`)."""
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import build_server, create_engine_app
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer

    kw = serve_kw("contiguous")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with _PresetDepth(preset, FAMILY_SERVED_LAYERS.get(preset)):
        server = build_server(["--model", hf_id, "--host", "127.0.0.1", "--port", "0", "--embedder", "none",
                               "--max-batch", str(kw["max_batch"]), "--max-len", str(kw["max_len"]),
                               "--matmul-kernel", "pallas_w8a8"])
    torch.cuda.synchronize()
    sched = server.scheduler
    cfg = sched.cfg
    if sched.device.type != "cuda":
        raise AssertionError("families: build_server did not serve on the card")
    fields = dict(model=hf_id, preset=preset, layers=cfg.n_layers, d_model=cfg.d_model, head_dim=cfg.head_dim,
                  heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", experts=cfg.n_experts, moe_dropless=cfg.moe_dropless,
                  weights="random int8 from seed 0" + (", bf16 experts" if cfg.n_experts > 1 else ""),
                  load_s=time.perf_counter() - t0, device_gb=torch.cuda.memory_allocated(dev) / 1e9)
    path = family_path(cfg)
    streams, launches, timing = _family_requests(torch, _cuda, server, prompts, "contiguous", path)
    fields.update(alone_equal_together=True, launches={"contiguous": launches}, **timing,
                  peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    if preset in FAMILY_PAGED:
        paged = Scheduler(cfg, sched.params, device=dev, matmul_kernel="pallas_w8a8", **serve_kw("paged"))
        paged_streams, fields["launches"]["paged"], paged_timing = _family_requests(
            torch, _cuda, create_engine_app(paged, get_tokenizer(hf_id), hf_id, "127.0.0.1", 0), prompts, "paged",
            path)
        if paged_streams != streams:
            raise AssertionError(f"families {preset}: paged streams differ from contiguous:\n{streams}\n"
                                 f"{paged_streams}")
        fields.update(paged_equal_contiguous=True, paged=paged_timing)
        del paged
    del server, sched
    gc.collect()
    torch.cuda.empty_cache()
    emit("families_serve", **fields)
    return fields["launches"]


def seeded_family_tree(torch, cfg, dev, seed: int) -> dict:
    """A float tree of ``cfg`` (bf16) from ``seed`` on ``dev``: 0.02-std
    matrices, norm gains 1 + N(0, 0.1), biases N(0, 0.1), so every bias and
    gain is read; Gemma's head tied to its embedding."""
    from generativeaiexamples_tpu_torch.models import llama

    gen = torch.Generator(device=dev).manual_seed(seed)
    tree = llama.init_params(cfg, gen, dev)

    def jitter(name, t):
        if name in llama.NORM_GAINS or name in llama.BIASES:
            return (t.float() + 0.1 * torch.randn(t.shape, generator=gen, device=dev)).to(t.dtype)
        return t

    tree = {k: jitter(k, v) for k, v in tree.items() if k != "layers"} | {
        "layers": {k: jitter(k, v) for k, v in tree["layers"].items()}}
    if cfg.norm_unit_offset:  # Gemma checkpoints have no lm_head.weight
        tree["lm_head"] = tree["embed"].T
    return tree


def check_loaded_family(torch, np, cfg, params, written: dict) -> dict:
    """The served params of a loaded family checkpoint against the written
    HF tensors: the int8 codes and f32 scales of every projection of its
    last layer, and of every FAMILY_VOCAB_STRIDE-th row of the head and of
    the embedding, equal numpy's quantization (:func:`np_int8`, per HF row)
    bit for bit; norms, biases, the router and every layer's experts equal
    the written bf16 arrays."""
    from generativeaiexamples_tpu_torch.ops.qmm import BlockedQuantizedMatrix

    layers = params["layers"]
    mlp = () if "router" in layers else FAMILY_MLP["gated" if "w_gu" in layers or "w_gate" in layers else "plain"]
    hf = dict(FAMILY_ATTN + mlp)
    parts = {"wqkv": ("wq", "wk", "wv"), "w_gu": ("w_gate", "w_up")}
    i = cfg.n_layers - 1
    pre = f"model.layers.{i}."
    checked, bad = [], []
    for name, leaf in layers.items():
        if isinstance(leaf, BlockedQuantizedMatrix):
            codes, scales = zip(*(np_int8(np, written[pre + hf[p] + ".weight"].float().numpy(), axis=1)
                                  for p in parts.get(name, (name,))))
            if not (_bits_equal(torch, leaf.w[i, : leaf.n, : leaf.k], np.concatenate(codes)) and
                    _bits_equal(torch, leaf.scale[i, : leaf.n], np.concatenate(scales)[:, 0])):
                bad.append(f"layer {i} {name}")
            checked.append(f"{i}.{name}")
    # Every FAMILY_VOCAB_STRIDE-th vocabulary row of the embedding and the
    # head (each row is quantized on its own).
    rows = slice(None, None, FAMILY_VOCAB_STRIDE)
    embed_codes, embed_scale = np_int8(np, written["model.embed_tokens.weight"][rows].float().numpy(), axis=1)
    head = written.get("lm_head.weight")
    head_codes, head_scale = ((embed_codes, embed_scale) if head is None else
                              np_int8(np, head[rows].float().numpy(), axis=1))
    for name, codes, scale, to_ours in (("embed", embed_codes, embed_scale, False),
                                        ("lm_head", head_codes, head_scale, True)):
        qm = params[name]
        got_q, got_s = (qm.q.T, qm.scale.T) if to_ours else (qm.q, qm.scale)
        if not (_bits_equal(torch, got_q[rows].to(torch.int8), codes) and _bits_equal(torch, got_s[rows], scale)):
            bad.append(name)
        checked.append(name)
    floats = {}
    for j in range(cfg.n_layers):
        p = f"model.layers.{j}."
        for ours, hf_norm in FAMILY_NORMS:
            floats[(ours, j)] = written[p + hf_norm + ".weight"]
            if p + hf_norm + ".bias" in written:
                floats[(ours + "_b", j)] = written[p + hf_norm + ".bias"]
        for ours, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"), ("wo", "bo"), ("w_up", "b_up"), ("w_down", "b_down")):
            if b in layers:
                floats[(b, j)] = written[p + hf[ours] + ".bias"]
        if "router" in layers:
            floats[("router", j)] = written[p + "block_sparse_moe.gate.weight"].T
            for e in range(cfg.n_experts):
                for ours, w in FAMILY_MLP["moe"]:
                    floats[(ours, j, e)] = written[p + f"block_sparse_moe.experts.{e}.{w}.weight"].T
    for key, want in floats.items():  # bf16 bits, compared where the served leaf lives
        got = layers[key[0]][key[1:]]
        if not torch.equal(got.view(torch.int16), want.to(got.device).contiguous().view(torch.int16)):
            bad.append("/".join(map(str, key)))
    if bad:
        raise AssertionError(f"loaded family leaves differ from the checkpoint: {bad}")
    return dict(int8_leaves_checked=len(checked), float_leaves_checked=len(floats), bitwise_equal=True)


def family_checkpoint(torch, np, dev, _cuda, root: str, hf_id: str, preset: str, prompts) -> dict:
    """A seeded HF-layout checkpoint of ``preset`` at full width and
    :data:`FAMILY_REF_LAYERS` layers (bf16, :func:`write_family_checkpoint`)
    served by ``build_server`` through ``$GAIE_WEIGHTS_DIR``: its leaves
    (:func:`check_loaded_family`), and two completions, the prompts sent
    together, each with K1, K2 and K4 launched."""
    import shutil

    from generativeaiexamples_tpu_torch.engine.server import build_server
    from generativeaiexamples_tpu_torch.models import llama

    kw = serve_kw("contiguous")
    cfg = llama.PRESETS[preset](n_layers=FAMILY_REF_LAYERS)
    t0 = time.perf_counter()
    path = os.path.join(root, hf_id.replace("/", "--"))
    host = write_family_checkpoint(torch, path, cfg, seeded_family_tree(torch, cfg, dev, HF_SEED))
    torch.cuda.empty_cache()
    fields = dict(model=hf_id, layers=cfg.n_layers, d_model=cfg.d_model, tied_head="lm_head.weight" not in host,
                  written_gb=sum(t.numel() * t.element_size() for t in host.values()) / 1e9,
                  write_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    with _PresetDepth(preset, FAMILY_REF_LAYERS):
        server = build_server(["--model", hf_id, "--host", "127.0.0.1", "--port", "0", "--embedder", "none",
                               "--max-batch", str(kw["max_batch"]), "--max-len", str(kw["max_len"]),
                               "--matmul-kernel", "pallas_w8a8"])
    torch.cuda.synchronize()
    fields["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fields.update(check_loaded_family(torch, np, server.scheduler.cfg, server.scheduler.params, host),
                  check_s=time.perf_counter() - t0)
    del host
    sched = server.scheduler
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    sched.start()
    thread.start()
    base_url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _completion(base_url, prompts["warmup"], 4)
        _cuda.reset_launch_counts()
        results: dict = {}
        workers = [threading.Thread(target=lambda i=i: results.__setitem__(i, _completion(
            base_url, prompts["completions"][i]))) for i in (0, 3)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=900)
        launches = dict(_cuda.LAUNCHES)
        if len(results) != 2 or not all(launches[k] for k in PATH_KERNELS["contiguous"][0]):
            raise AssertionError(f"families checkpoint {preset}: completions {len(results)}, launches {launches}")
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=30)
        sched._cache = sched._pool = None
    del server, sched
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(path, ignore_errors=True)
    fields.update(completions=2, launches=launches)
    emit("families_checkpoint", **fields)
    return launches


def families_phase(torch, dev, _cuda, smi: str, prompts) -> dict:
    """Gemma-2B, Gemma-7B, StarCoder2-3B and Mixtral-8x7B on the card:
    each at full width and 2 layers through the kernels against the plain
    versions on the CPU (:func:`card_vs_cpu`, with the cacheless forward);
    each served through ``build_server`` by its HF id (:func:`family_serve`;
    at ``FAMILY_SERVED_LAYERS``); then seeded checkpoints of Gemma-7B,
    StarCoder2-3B and Mixtral at 2 layers through ``$GAIE_WEIGHTS_DIR``
    (:func:`family_checkpoint`).  Returns the launches of each serving
    path by family."""
    import shutil
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch.models import llama

    t_phase = time.perf_counter()
    for _, preset in FAMILY_MODELS:
        cfg = llama.PRESETS[preset](kv_dtype="int8", n_layers=FAMILY_REF_LAYERS)
        t0 = time.perf_counter()
        fields = card_vs_cpu(torch, dev, cfg, 5, 32, [32, 19], FAMILY_TOL, cacheless=True, built_on="card")
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.n_experts > 1:
            fields["moe_products"] = moe_products_vs_cpu(torch, dev, cfg, 6)
        emit("families_reference", preset=preset, layers=cfg.n_layers, d_model=cfg.d_model, tolerance=FAMILY_TOL,
             seconds=time.perf_counter() - t0, **fields)
    launches = {}
    for hf_id, preset in FAMILY_MODELS:
        launches[preset] = family_serve(torch, dev, _cuda, hf_id, preset, prompts)
    root = tempfile.mkdtemp(prefix="family_checkpoints_")
    try:
        os.environ["GAIE_WEIGHTS_DIR"] = root
        for hf_id, preset in FAMILY_MODELS:
            if preset in FAMILY_CHECKPOINTS:
                launches[preset]["checkpoint"] = family_checkpoint(torch, np, dev, _cuda, root, hf_id, preset,
                                                                   prompts)
    finally:
        os.environ.pop("GAIE_WEIGHTS_DIR", None)
        shutil.rmtree(root, ignore_errors=True)
    emit("families", nvidia_smi=smi, seconds=time.perf_counter() - t_phase,
         served_layers={p: FAMILY_SERVED_LAYERS.get(p, "all") for _, p in FAMILY_MODELS})
    return launches


# ---------------------------------------------------------------------------
# the xla path: bf16 weights over the bf16 KV cache (the reference default)
# ---------------------------------------------------------------------------

# K4's warm regime: a 256-token chunk at positions start..start+255 against
# a window of t > 256 cache slots, at Llama-3-8B's heads (head_dim 128) and
# the 1B draft's (64).  (start, t) pairs.
XLA_WARM_CHUNKS = ((256, 1024), (1792, 2048))
# Card vs CPU at Llama-3-8B's full width and 2 layers, bf16 weights and the
# bf16 cache (no int8 re-quantization anywhere): the logits of each call,
# and the cache's written slots, as a share of their own size.  On an H100
# the sound code reads logits RMS 0.9-1.15% and cache RMS 0.57% (tolerance
# use 0.57); the planted faults (a warm chunk reading its fresh k/v instead
# of the cache; a decode step scattering at position + 1) read 65.6x and
# 19.5x the bound (PERF.md §6).
XLA_TOL = dict(rel_rms=0.02, max_abs_frac=0.1)
XLA_FAULTS = ("fresh_kv", "scatter_plus_one")


def check_flash_warm(torch, dev, log, hd: int, start: int, t: int, nq: int = 32, nkv: int = 8, b: int = 8,
                     s: int = 256, n_valid=(256, 200, 131, 256, 180, 140, 256, 160), regime: str = "warm") -> dict:
    """K4 on a warm block: ``b`` rows of an ``s``-token block at positions
    ``start..start + s - 1`` against ``t`` cache slots (``t > s``; valid
    lengths ``start + n_valid``, ragged by default, so the padded tail of a
    row's block sees only its valid keys), held against its plain version
    within ``FLASH_TOL``, timed beside SDPA with the same boolean mask.
    The VLM's prefill is such a block with b = 1 and start = 0."""
    import torch.nn.functional as F

    from generativeaiexamples_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(13)
    nv = 3
    qs = [torch.randn(b, s, nq, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    kks = [torch.randn(b, t, nkv, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    vvs = [torch.randn(b, t, nkv, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    n_valid = torch.tensor(list(n_valid), dtype=torch.int32, device=dev)
    lengths = start + n_valid
    pos = (start + torch.arange(s, dtype=torch.int32, device=dev)).expand(b, s).contiguous()
    out = fa.flash_attention_cuda(qs[0], kks[0], vvs[0], pos, lengths)
    ref = fa.flash_gqa_attention_plain(qs[0], kks[0], vvs[0], pos, lengths)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    use = tolerance_use(out, ref, **FLASH_TOL)
    torch.testing.assert_close(out, ref, **FLASH_TOL)
    k_ms = time_ms(lambda i: fa.flash_attention_cuda(qs[i], kks[i], vvs[i], pos, lengths), nv, 20, graph=True)
    eager_ms = time_ms(lambda i: fa.flash_attention_cuda(qs[i], kks[i], vvs[i], pos, lengths), nv, 20)
    p_ms = time_ms(lambda i: fa.flash_gqa_attention_plain(qs[i], kks[i], vvs[i], pos, lengths), nv, 3, 1)
    t_idx = torch.arange(t, device=dev)
    mask = ((t_idx[None, None, :] <= pos[:, :, None]) & (t_idx[None, None, :] < lengths[:, None, None]))[:, None]
    qt, kt, vt = ([x.transpose(1, 2) for x in xs] for xs in (qs, kks, vvs))

    def sdpa(i):
        return F.scaled_dot_product_attention(qt[i], kt[i], vt[i], attn_mask=mask, enable_gqa=True)

    lib_eager_ms = time_ms(sdpa, nv, 50)
    try:
        lib_ms, lib_timing = time_ms(sdpa, nv, 20, graph=True), "graph"
    except RuntimeError as exc:
        log.append(f"SDPA graph capture failed (warm chunk), timed eagerly over 50 calls: {exc}")
        torch.cuda.synchronize()
        lib_ms, lib_timing = lib_eager_ms, "eager, 50 calls"
    visible = int(mask.sum().item()) * nq
    # Bytes: q, K/V up to each row's valid length (every key below it is
    # visible to the chunk's last rows), the output, positions, lengths.
    kv_slots = int(lengths.sum().item())
    nbytes = (b * s * nq * hd + kv_slots * 2 * nkv * hd + b * s * nq * hd) * 2 + b * s * 4 + b * 4
    b_ms, b_by = bound(nbytes, 4.0 * visible * hd, BF16_FLOPS)
    row = dict(b=b, s=s, t=t, first_position=start, nq=nq, nkv=nkv, hd=hd, ms=k_ms, eager_ms=eager_ms,
               plain_ms=p_ms, library_ms=lib_ms, library_timing=lib_timing, library_eager_ms=lib_eager_ms,
               bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / k_ms, max_abs_err=err, tolerance=FLASH_TOL,
               tolerance_use=use)
    emit("kernel", kernel="flash_attention", regime=regime, **row)
    del qs, kks, vvs
    return row


def time_float_decode_attention(torch, dev, k2_ms: float) -> dict:
    """The bf16 cache's decode attention (``ops.decode_attention.
    float_cache_attention``, plain torch as in the reference) for one layer
    at B=32, 32 / 8 heads, head_dim 128, rows valid to 600-1000 slots, at a
    window of 1024 (a bucket) and of 2048 (the whole cache, what the port
    reads), timed as CUDA-graph replays and eagerly beside each window's
    byte bound and K2's time at the same shape; and whether a row's output
    bits move with the window, at windows of 1024, 1536 and 1280 against
    the whole cache (what decides the whole-cache read)."""
    from generativeaiexamples_tpu_torch.ops import decode_attention as da

    b, kh, g, hd, t, nv = 32, 8, 4, 128, 2048, 2
    gen = torch.Generator(device=dev).manual_seed(9)
    caches = [tuple(torch.randn(2, kh, b, t, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
              for _ in range(nv)]
    qs = [torch.randn(b, 1, kh * g, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(nv)]
    lengths = torch.randint(600, 1001, (b,), generator=gen, device=dev, dtype=torch.int32)
    pos = (lengths - 1)[:, None]
    out = {}
    for window in (1024, t):
        def fn(i, w=window):
            kc, vc = caches[i]
            return da.float_cache_attention(qs[i], kc[1, :, :, :w], vc[1, :, :, :w], pos, lengths)

        res = fn(0)
        if not torch.isfinite(res.float()).all():
            raise AssertionError("float decode attention: non-finite output")
        ms = time_ms(fn, nv, 20, graph=True)
        eager_ms = time_ms(fn, nv, 20)
        nbytes = b * kh * window * hd * 2 * 2 + 2 * b * kh * g * hd * 2 + b * 8
        b_ms, b_by = bound(nbytes, 4.0 * b * kh * g * window * hd, BF16_FLOPS)
        out[window] = dict(ms=ms, eager_ms=eager_ms, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
                           vs_k2=ms / k2_ms, result=res)
    whole = out[t].pop("result")
    same = {1024: torch.equal(out[1024].pop("result"), whole)}
    for window in (1536, 1280):
        kc, vc = caches[0]
        same[window] = torch.equal(da.float_cache_attention(qs[0], kc[1, :, :, :window], vc[1, :, :, :window], pos,
                                                            lengths), whole)
    fields = dict(b=b, n_q=kh * g, n_kv=kh, hd=hd, cache_slots=t, k2_ms_window_1024=k2_ms,
                  window_1024=out[1024], window_2048=out[t], rows_equal_to_whole_cache_by_window=same)
    emit("xla_decode_attention", **fields)
    del caches
    return fields


XLA_PROJECTIONS = (("wq", 4096, 4096), ("wk", 4096, 1024), ("wo", 4096, 4096), ("w_gate", 4096, 14336),
                   ("w_down", 14336, 4096))


def check_row_blocks(torch, dev) -> dict:
    """Whether a row's bf16 product on the card moves with the rows beside
    it, at Llama-3-8B's unpacked projections (what the ``xla`` scheduler
    serves): rows 0-19 of an M=2048 call against the same rows alone in an
    M=20 call, through one ``torch.mm`` (f32 output) and through the
    port's fixed row blocks (``ops.quant.f32_product``); and what the
    blocks cost, at M=32 (a decode step) and M=2048 (a cold batch), timed
    as CUDA-graph replays."""
    from generativeaiexamples_tpu_torch.ops.quant import FLOAT_BLOCK_ROWS, f32_product

    gen = torch.Generator(device=dev).manual_seed(21)
    rows = {}
    for name, k, n in XLA_PROJECTIONS:
        w = (torch.randn(k, n, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        x = torch.randn(2048, k, generator=gen, device=dev).to(torch.bfloat16)

        def mm(a):
            return torch.mm(a, w, out_dtype=torch.float32)

        row = dict(mm_rows_equal=torch.equal(mm(x)[:20], mm(x[:20].clone())),
                   blocked_rows_equal=torch.equal(f32_product(x, w)[:20], f32_product(x[:20].clone(), w)))
        for m in (32, 2048):
            xm = x[:m].contiguous()
            row[f"mm_ms_m{m}"] = time_ms(lambda i: mm(xm), 1, 10, graph=True)
            row[f"blocked_ms_m{m}"] = time_ms(lambda i: f32_product(xm, w), 1, 10, graph=True)
        rows[name] = row
        del w, x
    fields = dict(block_rows=FLOAT_BLOCK_ROWS, projections=rows,
                  mm_rows_equal=all(r["mm_rows_equal"] for r in rows.values()),
                  blocked_rows_equal=all(r["blocked_rows_equal"] for r in rows.values()))
    emit("xla_row_blocks", **fields)
    if not fields["blocked_rows_equal"]:
        raise AssertionError(f"xla_row_blocks: a row's bits moved with its batch inside fixed blocks: {rows}")
    return fields


def _f32_projections(torch, params):
    """The params with every 2-D / 3-D float leaf held in f32 (bf16 values
    exactly), for the CPU reference: ``float_dot`` widens bf16 operands to
    f32 per call, so the product is the same and the widening happens
    once.  Norm gains and the embedding stay as they are."""
    layers = {n: (v.float() if v.ndim >= 3 else v) for n, v in params["layers"].items()}
    return {**params, "layers": layers, "lm_head": params["lm_head"].float()}


def _xla_calls(torch, d, cfg, params, tokens, lengths, feed):
    """The sequence the bf16 path runs, on device ``d``: a cold prefill
    of ``tokens[:, :s]`` (valid ``lengths``), a 32-token warm chunk at
    each row's offset (through K4 on the card: t = 128 > s), 8 decode
    steps fed ``feed[i]`` (None: the argmax of the previous logits, which
    are returned), a 5-token verify block over a float append buffer, and
    its flush.  Returns (logits by call, the cache, the fed tokens)."""
    from generativeaiexamples_tpu_torch.engine.decode import _append_buffer, _flush_append_buffer
    from generativeaiexamples_tpu_torch.models import llama

    b, s = 2, 64
    T = 256
    lens = lengths.to(d)
    cache = llama.init_kv_cache(cfg, b, T, device=d)
    out = []

    def fwd(toks, pos, kv_len, **kw):
        hidden = llama.forward(params, cfg, toks.to(d).long(), pos.to(d), cache, kv_len.to(d), **kw)[0]
        return llama.logits(params, hidden).float().cpu()

    pos0 = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    out.append(("prefill", fwd(tokens[:, :s], pos0, lengths, cold_prefill=True)))
    wpos = lengths[:, None] + torch.arange(32, dtype=torch.int32)[None]
    out.append(("warm_chunk", fwd(tokens[:, s:s + 32], wpos, lengths + 32, kv_bucket=128)))
    cur = lengths + 32
    fed = []
    tok = out[-1][1][:, -1].argmax(-1)
    for i in range(8):
        tok = tok if feed is None else feed[i]
        fed.append(tok)
        lg = fwd(tok[:, None], cur[:, None], cur + 1, kv_bucket=128)
        out.append((f"decode_{i}", lg))
        tok = lg[:, -1].argmax(-1)
        cur = cur + 1
    vt = tokens[:, s + 32:s + 37]
    vpos = cur[:, None] + torch.arange(5, dtype=torch.int32)[None]
    ab = _append_buffer(cfg, b, 5, d)
    hidden, _, ab = llama.forward(params, cfg, vt.to(d).long(), vpos.to(d), cache, cur.to(d), kv_bucket=128,
                                  append_cache=(ab, 0))
    out.append(("verify", llama.logits(params, hidden).float().cpu()))
    _flush_append_buffer(cache, ab, cur.to(d), T)
    return out, tuple(c.float().cpu() for c in cache), fed


def _share(out, ref) -> tuple[float, float]:
    """(RMS error / RMS of ref, max error / max |ref|)."""
    diff = out - ref
    return ((diff.square().mean().sqrt() / ref.square().mean().sqrt()).item(),
            (diff.abs().max() / ref.abs().max()).item())


def xla_vs_cpu(torch, dev, seed: int = 11) -> dict:
    """Llama-3-8B at full width and 2 layers, random bf16 weights from
    ``seed`` (made on the card, copied to the CPU), bf16 cache: the calls
    of :func:`_xla_calls` through the card's kernels and through the plain
    versions on the CPU, each call's logits and the final cache (every
    written slot) within ``XLA_TOL``; then each planted fault of
    ``XLA_FAULTS`` on the card's side, which must fail the same check.
    Returns the failures (the sound run beyond the bound, a fault
    within it)."""
    from generativeaiexamples_tpu_torch.engine.decode import prepare_params
    from generativeaiexamples_tpu_torch.models import llama

    cfg = llama.llama3_8b(n_layers=2)
    with torch.inference_mode():
        params_dev = prepare_params(cfg, None, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
        params_cpu = _f32_projections(torch, _to_device(torch, params_dev, "cpu"))
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64 + 32 + 5), generator=gen)
    lengths = torch.tensor([64, 41], dtype=torch.int32)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref, ref_cache, fed = _xla_calls(torch, "cpu", cfg, params_cpu, tokens, lengths, None)
    cpu_s = time.perf_counter() - t0
    written = (lengths + 32 + 8 + 5).tolist()

    def compare(fault):
        saved = llama._float_cache_attention
        if fault is not None:
            llama._float_cache_attention = _planted_fault(torch, llama, saved, fault)
        try:
            with torch.inference_mode():
                got, cache, _ = _xla_calls(torch, dev, cfg, params_dev, tokens, lengths, fed)
        finally:
            llama._float_cache_attention = saved
        readings, worst = {}, 0.0
        for (name, out), (_, want) in zip(got, ref):
            if name == "prefill":
                valid = torch.arange(out.shape[1])[None, :] < lengths[:, None]
                out, want = out[valid], want[valid]
            if not torch.isfinite(out).all():
                raise AssertionError(f"xla_reference: non-finite {name} logits on the card")
            rms, frac = _share(out, want)
            readings[name] = dict(rel_rms=rms, max_frac=frac)
            worst = max(worst, rms / XLA_TOL["rel_rms"], frac / XLA_TOL["max_abs_frac"])
        for leaf, (c, w) in zip(("k", "v"), zip(cache, ref_cache)):
            rows = [(c[:, :, r, :n], w[:, :, r, :n]) for r, n in enumerate(written)]
            rms, frac = _share(torch.cat([x.flatten() for x, _ in rows]), torch.cat([y.flatten() for _, y in rows]))
            readings[f"cache_{leaf}"] = dict(rel_rms=rms, max_frac=frac)
            worst = max(worst, rms / XLA_TOL["rel_rms"], frac / XLA_TOL["max_abs_frac"])
        return readings, worst

    sound, use = compare(None)
    fields = dict(model="llama3-8b", layers=cfg.n_layers, d_model=cfg.d_model, weights=f"random bf16, seed {seed}",
                  kv="bf16", tolerance=XLA_TOL, cpu_s=cpu_s, calls=sound, tolerance_use=use)
    faults = {}
    for fault in XLA_FAULTS:
        readings, f_use = compare(fault)
        faults[fault] = dict(tolerance_use=f_use, worst={k: v for k, v in readings.items()
                                                         if max(v["rel_rms"] / XLA_TOL["rel_rms"],
                                                                v["max_frac"] / XLA_TOL["max_abs_frac"]) > 1})
    fields["planted_faults"] = faults
    failures = [f"xla_reference: card vs CPU beyond {XLA_TOL} (use {use:.3f})"] if use > 1 else []
    passed = [f for f, r in faults.items() if r["tolerance_use"] <= 1]
    if passed:
        failures.append(f"xla_reference: planted faults {passed} pass the check")
    emit("xla_reference", **fields, failures=failures)
    del params_dev, params_cpu
    return failures


def _planted_fault(torch, llama, sound, fault: str):
    """``models.llama._float_cache_attention`` with one fault planted:
    ``fresh_kv``, a warm chunk attends over its own fresh k/v and not the
    cache (which it still writes); ``scatter_plus_one``, a decode step
    writes its k/v one slot late (and reads through it)."""

    def faulty(q, k, v, li, positions, kv_lengths, cache, ab, cold_prefill, window, t, row_offset):
        warm = ab is None and not (cold_prefill and q.shape[1] > 1)
        if fault == "fresh_kv" and warm and q.shape[1] > 1:
            sound(q, k, v, li, positions, kv_lengths, cache, ab, cold_prefill, window, t, row_offset)
            return llama.attention(q, k, v, positions - positions[:, :1], None)
        if fault == "scatter_plus_one" and warm and q.shape[1] == 1:
            return sound(q, k, v, li, positions + 1, kv_lengths + 1, cache, ab, cold_prefill, window, t, row_offset)
        return sound(q, k, v, li, positions, kv_lengths, cache, ab, cold_prefill, window, t, row_offset)

    return faulty


# The xla path's Llama-3-8B at full width and 16 of its 32 layers (its
# server, generators and the W8A8 generator), so the whole script stays
# inside its time limit beside the scale-out retrieval phases (all 32
# until then).
XLA_SERVED_LAYERS = 16
XLA_ARGV = ("--model", "llama3-8b", "--matmul-kernel", "xla", "--host", "127.0.0.1", "--port", "0",
            "--embedder", "none", "--seed", "0")


def _xla_front(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    server.scheduler.start()
    thread.start()
    return thread, f"http://127.0.0.1:{server.server_address[1]}"


def _close_front(server, thread) -> None:
    server.shutdown()
    server.server_close()
    server.scheduler.stop()
    thread.join(timeout=30)


def xla_serve(torch, dev, _cuda, prompts) -> tuple:
    """``build_server`` on ``xla`` (Llama-3-8B at full width and depth,
    random bf16 weights from ``--seed`` 0 made on the card, the preset's
    bf16 cache), the engine server's serving settings: eight concurrent
    completions and a streaming chat, then the 20- and 650-token prompts
    alone (their ids must equal the batch's), then the 300-token shared
    prompt and one extension (the extension takes the prefix-cache graft;
    its ids are held against a cold prefill in :func:`xla_generators`).
    Launch counts are zeroed after a warm-up: K4 must launch, K1/K2/K3
    not.  Returns (params, the prompts sent alone and their ids, the
    extension's prompt and ids, the summary with the batch's streams,
    launches, failures)."""
    from generativeaiexamples_tpu_torch.engine.server import build_server

    from generativeaiexamples_tpu_torch.engine import decode as tdecode

    kw = serve_kw("contiguous")
    torch.cuda.reset_peak_memory_stats(dev)
    # The random draw's share of the load, read inside build_server.
    draw, spent = tdecode.init_random_params, {}

    def timed_draw(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = draw(*args, **kwargs)
        torch.cuda.synchronize()
        spent["draw_s"] = time.perf_counter() - t
        return out

    tdecode.init_random_params = timed_draw
    t0 = time.perf_counter()
    try:
        server = build_server([*XLA_ARGV, "--max-batch", str(kw["max_batch"]), "--max-len", str(kw["max_len"])])
        torch.cuda.synchronize()
    finally:
        tdecode.init_random_params = draw
    load_s = time.perf_counter() - t0
    sched = server.scheduler
    if sched.device.type != "cuda" or sched.matmul_kernel != "xla":
        raise AssertionError(f"xla_serve: {sched.device} {sched.matmul_kernel}")
    if len(sched._cache) != 2 or sched._cache[0].dtype != torch.bfloat16:
        raise AssertionError("xla_serve: the server did not build the bf16 cache")
    fields = dict(model="llama3-8b", layers=sched.cfg.n_layers, weights="random bf16, seed 0", kv="bf16 contiguous",
                  **kw, load_s=load_s, random_draw_s=spent.get("draw_s"),
                  device_gb_after_load=torch.cuda.memory_allocated(dev) / 1e9,
                  cache_gb=sum(c.numel() * c.element_size() for c in sched._cache) / 1e9)
    tee = StreamTee(sched)
    thread, base = _xla_front(server)
    try:
        _complete(base, prompts["warmup"], 4)
        tee.records.clear()
        n_ttft0 = len(sched.stats.ttft_recent)
        snap0 = sched.stats.snapshot()
        _cuda.reset_launch_counts()
        t_wall = time.perf_counter()
        workers, results = _concurrent(base, prompts["completions"])
        status, body = _post(base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": prompts["chat"]}], "max_tokens": 32, "temperature": 0,
            "stream": True})
        for w in workers:
            w.join(timeout=900)
        wall = time.perf_counter() - t_wall
        if status != 200 or len(results) != len(prompts["completions"]):
            raise AssertionError(f"xla_serve: a batch request failed ({status})")
        snap1 = sched.stats.snapshot()
        n_batch = len(tee.records)
        batch = {prompt: list(ids) for prompt, _, ids in tee.records}
        for n in (20, 650):
            _complete(base, prompts["completions"][prompts["lengths"].index(n)])
        alone = {prompt: list(ids) for prompt, _, ids in tee.records[n_batch:n_batch + 2]}
        hits0 = sched.stats.snapshot()["shared_prefix_hits"]
        _complete(base, prompts["shared"])
        _complete(base, prompts["extensions"][0])
        hits = sched.stats.snapshot()["shared_prefix_hits"] - hits0
        ext_prompt, _, ext_ids = tee.records[-1]
        _, metrics = _get(base + "/metrics")
        launches = dict(_cuda.LAUNCHES)
        flash_hd = dict(_cuda.FLASH_HD_LAUNCHES)
    finally:
        _close_front(server, thread)
    failures = []
    differ = [len(p) for p, ids in alone.items() if batch.get(p) != ids]
    if differ or len(alone) != 2:
        failures.append(f"prompts of {differ} tokens alone emitted other ids than in the batch")
    if hits < 1:
        failures.append(f"the extension took no shared-prefix graft ({hits})")
    if 'engine_matmul_kernel{kernel="xla"} 1' not in metrics:
        failures.append("/metrics does not report engine_matmul_kernel{kernel=\"xla\"}")
    if not launches["flash_attention"] or any(launches[k] for k in ("qmm", "decode_attention",
                                                                     "paged_decode_attention")):
        failures.append(f"launches {launches}: K4 only on the bf16 path")
    ttfts = sorted(list(sched.stats.ttft_recent)[n_ttft0:])
    decode_tokens = (snap1["tokens_total"] - snap0["tokens_total"]) - (snap1["requests_total"] - snap0["requests_total"])
    decode_s = snap1["decode_s"] - snap0["decode_s"]
    summary = dict(wall_s=wall, ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3 if ttfts else None,
                   decode_tokens_per_s=decode_tokens / decode_s if decode_s else None, streams=batch)
    fields.update(requests=len(prompts["completions"]) + 1, wall_s=wall, ttft_p50_ms=summary["ttft_p50_ms"],
                  ttft_max_ms=ttfts[-1] * 1e3 if ttfts else None, decode_tokens_per_s=summary["decode_tokens_per_s"],
                  decode_chunks=snap1["decode_chunks"] - snap0["decode_chunks"],
                  prefill_chunks=snap1["prefill_chunks"] - snap0["prefill_chunks"], alone_equal_batch=not differ,
                  shared_prefix_hits=hits, metrics_kernel="xla", launches=launches, flash_hd_launches=flash_hd,
                  peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9, failures=failures)
    emit("xla_serve", **fields)
    params = sched.params
    sched._cache = None
    del server, sched
    gc.collect()
    torch.cuda.empty_cache()
    return params, alone, (ext_prompt, list(ext_ids)), summary, launches, [f"xla_serve: {f}" for f in failures]


class _LogLines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def xla_serve_paged(torch, dev, _cuda, prompts) -> dict:
    """``build_server`` on ``xla`` with ``--kv-layout paged``: the preset's
    bf16 KV must be overridden to int8 (the reference's log line), the
    server must serve the 20- and 650-token prompts through K3 and K4
    (no K1, no K2).  Returns (the launches, failures)."""
    from generativeaiexamples_tpu_torch.engine import server as server_mod

    kw = serve_kw("paged")
    handler = _LogLines()
    server_mod.logger.addHandler(handler)
    level = server_mod.logger.level
    server_mod.logger.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        server = server_mod.build_server([*XLA_ARGV, "--max-batch", str(kw["max_batch"]), "--max-len",
                                          str(kw["max_len"]), "--kv-layout", "paged", "--kv-page-size", "64"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        server_mod.logger.removeHandler(handler)
        server_mod.logger.setLevel(level)
    sched = server.scheduler
    override = [line for line in handler.lines if "kv_layout=paged requires int8 KV; overriding kv_dtype" in line]
    thread, base = _xla_front(server)
    try:
        _complete(base, prompts["warmup"], 4)
        _cuda.reset_launch_counts()
        workers, results = _concurrent(base, [prompts["completions"][prompts["lengths"].index(n)] for n in (20, 650)])
        for w in workers:
            w.join(timeout=900)
        launches = dict(_cuda.LAUNCHES)
    finally:
        _close_front(server, thread)
    failures = []
    if not override:
        failures.append("no kv_dtype override logged")
    if sched._pool is None or sched._cache[0].dtype != torch.int8 or sched.matmul_kernel != "xla":
        failures.append("the paged server is not int8 pages on xla")
    if (len(results) != 2 or not launches["paged_decode_attention"] or not launches["flash_attention"]
            or launches["qmm"] or launches["decode_attention"]):
        failures.append(f"launches {launches}: K3 and K4, no K1 or K2")
    emit("xla_serve_paged", load_s=load_s, override_logged=override[:1], kv="int8 paged, page 64",
         launches=launches, failures=failures)
    sched._cache = sched._pool = None
    del server, sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches, [f"xla_serve_paged: {f}" for f in failures]


def _stream_gate(torch, cfg, params, prompt, ids, ref) -> dict:
    """``ids`` against ``ref`` after ``prompt``: equal, or (random-weight
    logits being flat) parted only at a near tie: every token of both
    within ``PLAIN_TIE`` of its position's argmax under a teacher-forced
    forward, and the first difference's two logits within ``PLAIN_TIE``."""
    if list(ids) == list(ref):
        return dict(equal=True)
    lg = teacher_forced_logits(torch, cfg, params, prompt, ids)
    lr = teacher_forced_logits(torch, cfg, params, prompt, ref)
    deficit = 0.0
    for logits, stream in ((lg, ids), (lr, ref)):
        picked = logits[torch.arange(len(stream)), torch.tensor(stream, device=logits.device)]
        deficit = max(deficit, (logits.max(dim=-1).values - picked).max().item())
    j = next((i for i in range(min(len(ids), len(ref))) if ids[i] != ref[i]), None)
    flip = abs(lg[j, ids[j]].item() - lg[j, ref[j]].item()) if j is not None else 0.0
    ok = deficit <= PLAIN_TIE and flip <= PLAIN_TIE and len(ids) == len(ref)
    return dict(equal=False, first_difference=j, logit_gap=flip, max_argmax_deficit=deficit, near_tie=ok)


def xla_spec(torch, dev, _cuda, cfg, params, prompts, serve_summary) -> tuple:
    """The reference's bf16 draft: ``--spec-decode --draft-model
    llama3.2-1b`` on ``xla`` (the draft keeps its preset's bf16 KV and
    float weights, random from the seed) over the ``xla_serve`` params,
    beside a plain scheduler in the same position.  Gates, as ``spec``'s
    (random logits are too flat for stream equality across the verify
    attention and the decode attention): each greedy token within
    ``SPEC_TIE`` of its teacher-forced argmax and streams parting from the
    plain ones only at a near tie (:func:`check_spec_streams`); K4 at
    head_dim 64 launched (the draft's prefill), no K1/K2/K3.  Returns
    (the draft config and params, launches, failures)."""
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import parse_args, spec_scheduler_kwargs

    out = {}
    plain = Scheduler(cfg, params, device=dev, matmul_kernel="xla", **serve_kw("contiguous"))
    try:
        records, baseline = spec_step(torch, dev, _cuda, "xla_spec_plain", plain, cfg, params, prompts, serve_summary,
                                      ("batch",))
    finally:
        plain._cache = None
    plain_streams = {prompt: ids for prompt, sp, ids in records if sp.temperature <= 0.0}
    gc.collect()
    torch.cuda.empty_cache()
    with _PresetDepth("llama3.2-1b", SPEC_DRAFT_LAYERS):
        kw = spec_scheduler_kwargs(parse_args(["--spec-decode", "--draft-model", "llama3.2-1b", "--gamma",
                                               str(SPEC_GAMMA)]), cfg, dev)
    dcfg, dparams = kw["draft_cfg"], kw["draft_params"]
    draft = Scheduler(cfg, params, device=dev, matmul_kernel="xla", **serve_kw("contiguous"), **kw)
    if len(draft._dcache) != 2 or draft._dcache[0].dtype != torch.bfloat16:
        raise AssertionError("xla_spec: the draft's cache is not bf16")
    try:
        t0 = time.perf_counter()
        records, fields = spec_step(torch, dev, _cuda, "xla_spec_draft", draft, cfg, params, prompts, serve_summary,
                                    ("batch", "alone"), baseline)
        gates = check_spec_streams(torch, cfg, params, records, plain_streams, spec=True)
    finally:
        draft._cache = draft._dcache = None
    failures = gates.pop("failures")
    launches = fields["launches"]
    if not fields["spec"]["spec_rounds"]:
        failures.append("no speculation round ran")
    if not fields["flash_hd_launches"][64] or any(launches[k] for k in ("qmm", "decode_attention",
                                                                         "paged_decode_attention")):
        failures.append(f"launches {launches} {fields['flash_hd_launches']}: K4 (hd 64 too), no K1/K2/K3")
    equal = sum(plain_streams.get(prompt) == ids for prompt, sp, ids in records if sp.temperature <= 0.0)
    emit("xla_spec_draft", draft="llama3.2-1b, random bf16 from --seed, bf16 KV", gamma_max=SPEC_GAMMA,
         step_s=time.perf_counter() - t0, streams_equal_to_plain=equal, **gates, **fields, failures=failures)
    out["spec_draft"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    return dcfg, dparams, out, [f"xla_spec_draft: {f}" for f in failures]


def xla_generators(torch, dev, _cuda, cfg, params, dcfg, dparams, alone_streams, ext) -> dict:
    """The offline generators at Llama-3-8B bf16 on the ``xla_serve``
    params: ``LlamaGenerator`` (max_batch 32, as the scheduler decodes,
    unpacked as the scheduler serves) on the 20- and 650-token prompts and
    the graft's extension must give the scheduler's ids (a cold prefill
    against chunked prefill and the graft); ``SpeculativeGenerator`` with
    the bf16 1B draft must give ``LlamaGenerator``'s ids; each equal, or
    parted only at a near tie (:func:`_stream_gate`, the form stated).
    Then ``LlamaGenerator(quantize=True, matmul_kernel="pallas_w8a8")``
    over an int8 cache (random int8 from seed 0) must launch K1, K2 and
    K4.  Returns (the launches, failures)."""
    from generativeaiexamples_tpu_torch.engine.generator import LlamaGenerator
    from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
    from generativeaiexamples_tpu_torch.engine.speculative import SpeculativeGenerator
    from generativeaiexamples_tpu_torch.models import llama

    greedy = SamplingParams(temperature=0.0, max_tokens=32)
    prompts = [p for p in alone_streams] + [ext[0]]
    want = [alone_streams[p] for p in alone_streams] + [ext[1]]
    fields, failures, launches = {}, [], {}
    t0 = time.perf_counter()
    gen = LlamaGenerator(cfg, params, device=dev, max_batch=32, max_len=2048, pack=False, matmul_kernel="xla")
    _cuda.reset_launch_counts()
    got = [r.token_ids for r in gen.generate([list(p) for p in prompts], greedy)]
    launches["generator"] = dict(_cuda.LAUNCHES)
    fields["generator_s"] = time.perf_counter() - t0
    gates = [_stream_gate(torch, cfg, params, p, g, w) for p, g, w in zip(prompts, got, want)]
    fields["generator_vs_scheduler"] = {str(len(p)): g for p, g in zip(prompts, gates)}
    failures += [f"generator vs scheduler, {len(p)}-token prompt: {g}" for p, g in zip(prompts, gates)
                 if not g["equal"] and not g["near_tie"]]
    del gen
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spec = SpeculativeGenerator(cfg, dcfg, params, dparams, device=dev, max_batch=4, max_len=2048, gamma=SPEC_GAMMA,
                                pack=False)
    _cuda.reset_launch_counts()
    spec_got = spec.generate([list(p) for p in prompts], max_tokens=32)
    launches["speculative"] = dict(_cuda.LAUNCHES)
    fields.update(speculative_s=time.perf_counter() - t0, speculative_stats=dict(spec.stats))
    gates = [_stream_gate(torch, cfg, params, p, s, g) for p, s, g in zip(prompts, spec_got, got)]
    fields["speculative_vs_generator"] = {str(len(p)): g for p, g in zip(prompts, gates)}
    failures += [f"speculative vs generator, {len(p)}-token prompt: {g}" for p, g in zip(prompts, gates)
                 if not g["equal"] and not g["near_tie"]]
    del spec
    for name in ("generator", "speculative"):
        if not launches[name]["flash_attention"] or launches[name]["qmm"] or launches[name]["decode_attention"]:
            failures.append(f"{name} launches {launches[name]}: K4 only on the bf16 path")
    gc.collect()
    torch.cuda.empty_cache()
    # The W8A8 route over an int8 cache.
    t0 = time.perf_counter()
    w8 = LlamaGenerator(llama.llama3_8b(kv_dtype="int8", n_layers=cfg.n_layers), None, device=dev, max_batch=8,
                        max_len=2048, quantize=True, matmul_kernel="pallas_w8a8", seed=0)
    _cuda.reset_launch_counts()
    res = w8.generate([list(p) for p in prompts], greedy)
    launches["w8a8_generator"] = dict(_cuda.LAUNCHES)
    fields["w8a8_generator_s"] = time.perf_counter() - t0
    if w8.matmul_kernel != "pallas_w8a8" or not all(len(r.token_ids) == 32 for r in res):
        failures.append(f"the W8A8 generator: {w8.matmul_kernel}, {[len(r.token_ids) for r in res]} tokens")
    if not all(launches["w8a8_generator"][k] for k in ("qmm", "decode_attention", "flash_attention")):
        failures.append(f"the W8A8 generator launched {launches['w8a8_generator']}: K1, K2 and K4 wanted")
    del w8
    gc.collect()
    torch.cuda.empty_cache()
    emit("xla_generators", prompt_tokens=[len(p) for p in prompts], max_tokens=32, launches=launches,
         failures=failures, **fields)
    return launches, [f"xla_generators: {f}" for f in failures]


def xla_path_phase(torch, dev, _cuda, smi: str, log, prompts, k2_ms: float) -> tuple[dict, dict]:
    """The reference engine's default serving path: K4's warm regime at
    both head_dims (the kernel lines), the bf16 decode attention's time,
    card vs CPU with planted faults, the server on ``xla`` (contiguous and
    paged), the bf16 draft, and the offline generators.  Every part is
    read before the phase fails.  Returns (K4's warm rows, the launches of
    each part)."""
    from generativeaiexamples_tpu_torch.models import llama

    t_phase = time.perf_counter()
    warm = {f"hd{hd}_t{t}": check_flash_warm(torch, dev, log, hd, start, t)
            for hd in (128, 64) for start, t in XLA_WARM_CHUNKS}
    decode_attn = time_float_decode_attention(torch, dev, k2_ms)
    check_row_blocks(torch, dev)
    failures = xla_vs_cpu(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    cfg = llama.llama3_8b(n_layers=XLA_SERVED_LAYERS)
    with _PresetDepth("llama3-8b", XLA_SERVED_LAYERS):
        params, alone, ext, summary, launches["serve"], found = xla_serve(torch, dev, _cuda, prompts)
        failures += found
        launches["serve_paged"], found = xla_serve_paged(torch, dev, _cuda, prompts)
        failures += found
        dcfg, dparams, spec_launches, found = xla_spec(torch, dev, _cuda, cfg, params, prompts, summary)
        failures += found
        launches.update(spec_launches)
        gen_launches, found = xla_generators(torch, dev, _cuda, cfg, params, dcfg, dparams, alone, ext)
        failures += found
        launches.update(gen_launches)
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    emit("xla_path", nvidia_smi=smi, seconds=time.perf_counter() - t_phase,
         decode_attention_ms_per_layer=decode_attn["window_2048"]["ms"], failures=failures)
    if failures:
        raise AssertionError(f"xla_path: {failures}")
    return warm, launches


# -- test documents (no PIL: numpy pixels, zlib streams, a hand-made PNG) -----


def chart_pixels(np, size: int = 64):
    """A bar chart as (size, size, 3) uint8: white canvas, black axes, three
    blue bars (few colours, long flat rows: the heuristic's chart)."""
    img = np.full((size, size, 3), 255, np.uint8)
    img[size - 9 : size - 7, 8 : size - 3] = 0
    img[4 : size - 7, 7:9] = 0
    for i, h in enumerate((20, 35, 28)):
        x = 16 + i * 14
        img[size - 8 - h : size - 7, x : x + 9] = (0, 0, 255)
    return img


def photo_pixels(np, size: int = 64, seed: int = 0):
    """A noisy gray photo as (size, size) uint8 (no flat rows: not a chart)."""
    return np.random.default_rng(seed).integers(0, 256, (size, size), dtype=np.uint8)


def png_bytes(np, rgb) -> bytes:
    """(H, W, 3) uint8 as an 8-bit RGB PNG (filter 0 rows, one IDAT)."""
    import struct
    import zlib

    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    rows = b"".join(b"\x00" + np.ascontiguousarray(rgb[r]).tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _pdf_literal(text: str) -> bytes:
    return b"(" + text.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)").encode("latin-1") + b")"


def write_pdf(np, path, pages, images=()) -> None:
    """A linear PDF: one FlateDecode content stream per page (``pages``, a
    list of lines each), each followed by that page's image XObjects
    (``images``: ``(page, pixels)`` with (H, W, 3) uint8 as FlateDecode
    ``/DeviceRGB``, (H, W) uint8 as FlateDecode ``/DeviceGray``, or
    ``(page, jpeg_bytes, (w, h))`` as DCTDecode)."""
    import zlib

    objs = [b"<< /Type /Catalog /Pages 2 0 R >>", None]
    kids, body = [], []
    n = 3
    for p, lines in enumerate(pages):
        content = b"BT /F1 12 Tf 72 720 Td " + b"".join(_pdf_literal(t) + b" Tj T* " for t in lines) + b"ET"
        data = zlib.compress(content)
        kids.append(n)
        body.append((n, b"<< /Type /Page /Parent 2 0 R /Contents %d 0 R >>" % (n + 1), None))
        body.append((n + 1, b"<< /Filter /FlateDecode /Length %d >>" % len(data), data))
        n += 2
        for page, *img in images:
            if page != p:
                continue
            if len(img) == 2:
                jpg, (w, h) = img
                d = b"<< /Type /XObject /Subtype /Image /Width %d /Height %d /ColorSpace /DeviceRGB " \
                    b"/BitsPerComponent 8 /Filter /DCTDecode /Length %d >>" % (w, h, len(jpg))
                body.append((n, d, jpg))
            else:
                px = np.ascontiguousarray(img[0])
                space = b"/DeviceRGB" if px.ndim == 3 else b"/DeviceGray"
                data = zlib.compress(px.tobytes())
                d = b"<< /Type /XObject /Subtype /Image /Width %d /Height %d /ColorSpace %s " \
                    b"/BitsPerComponent 8 /Filter /FlateDecode /Length %d >>" % (px.shape[1], px.shape[0], space,
                                                                                 len(data))
                body.append((n, d, data))
            n += 1
    objs[1] = b"<< /Type /Pages /Kids [%s] /Count %d >>" % (b" ".join(b"%d 0 R" % k for k in kids), len(kids))
    out = b"%PDF-1.4\n"
    for i, d in enumerate(objs, start=1):
        out += b"%d 0 obj %s endobj\n" % (i, d)
    for i, d, stream in body:
        out += b"%d 0 obj %s" % (i, d)
        out += (b"\nstream\n" + stream + b"\nendstream\nendobj\n") if stream is not None else b" endobj\n"
    with open(path, "wb") as fh:
        fh.write(out + b"%%EOF\n")


_PPTX_NS = ('xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main" '
            'xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/main" '
            'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships"')
_PPTX_REL = "http://schemas.openxmlformats.org/officeDocument/2006/relationships/"


def _pptx_part(root: str, paras) -> str:
    from xml.sax.saxutils import escape

    runs = "".join(f"<a:p><a:r><a:t>{escape(t)}</a:t></a:r></a:p>" for t in paras)
    return (f'<?xml version="1.0"?><p:{root} {_PPTX_NS}><p:cSld><p:spTree><p:sp><p:txBody>{runs}'
            f"</p:txBody></p:sp></p:spTree></p:cSld></p:{root}>")


def write_pptx(path, slides, image_png: bytes = b"") -> None:
    """A deck of ``slides`` (``(paragraphs, notes)`` each).  Each slide's
    notes live in a notes slide numbered in reverse, found only through the
    slide's rels; ``image_png`` goes on slide 1 as ``media/image1.png``."""
    import zipfile

    n = len(slides)
    with zipfile.ZipFile(path, "w") as zf:
        for i, (paras, notes) in enumerate(slides, start=1):
            zf.writestr(f"ppt/slides/slide{i}.xml", _pptx_part("sld", paras))
            rels = []
            if notes:
                j = n + 1 - i
                zf.writestr(f"ppt/notesSlides/notesSlide{j}.xml", _pptx_part("notes", [notes]))
                rels.append(f'<Relationship Id="rId1" Type="{_PPTX_REL}notesSlide" '
                            f'Target="../notesSlides/notesSlide{j}.xml"/>')
            if image_png and i == 1:
                zf.writestr("ppt/media/image1.png", image_png)
                rels.append(f'<Relationship Id="rId2" Type="{_PPTX_REL}image" Target="../media/image1.png"/>')
            zf.writestr(f"ppt/slides/_rels/slide{i}.xml.rels",
                        '<?xml version="1.0"?><Relationships xmlns="http://schemas.openxmlformats.org/package/'
                        f'2006/relationships">{"".join(rels)}</Relationships>')


REPORT_HEADER = "ACME Quarterly Review"
REPORT_FOOTER = "Confidential - internal use"


def report_pages() -> list:
    """Three pages with a running header and footer, prose and one aligned
    table (``write_pdf``'s ``pages``)."""
    return [
        [REPORT_HEADER, "Hydra Inc annual report on fusion output and sales.",
         "The chart below shows output by quarter (in GWh).", REPORT_FOOTER],
        [REPORT_HEADER, "Regional sales were strong in the north.", "region  sales  growth",
         "north  42  3%", "south  17  1%", "east  29  2%", "Sales (units) rose (again) on demand.", REPORT_FOOTER],
        [REPORT_HEADER, "The photo shows the reactor hall at night.", REPORT_FOOTER],
    ]


# -- seeded HF checkpoints of the vision and speech models (no transformers) --


def _gauss(np, rng, shape, std=0.05, mean=0.0):
    return (mean + std * rng.standard_normal(shape)).astype(np.float32)


def vit_hf_tensors(np, cfg, seed: int) -> dict:
    """HF ``ViTModel`` tensors for ``cfg`` (numpy f32, seeded)."""
    rng = np.random.default_rng(seed)
    D, F_, c, p = cfg.d_model, cfg.d_ff, cfg.channels, cfg.patch_size
    out = {
        "embeddings.patch_embeddings.projection.weight": _gauss(np, rng, (D, c, p, p)),
        "embeddings.patch_embeddings.projection.bias": _gauss(np, rng, (D,)),
        "embeddings.position_embeddings": _gauss(np, rng, (1, cfg.n_patches + 1, D)),
        "embeddings.cls_token": _gauss(np, rng, (1, 1, D)),
        "layernorm.weight": _gauss(np, rng, (D,), 0.1, 1.0),
        "layernorm.bias": _gauss(np, rng, (D,)),
    }
    for i in range(cfg.n_layers):
        lay = f"encoder.layer.{i}."
        for name, shape in (("attention.attention.query", (D, D)), ("attention.attention.key", (D, D)),
                            ("attention.attention.value", (D, D)), ("attention.output.dense", (D, D)),
                            ("intermediate.dense", (F_, D)), ("output.dense", (D, F_))):
            out[lay + name + ".weight"] = _gauss(np, rng, shape)
            out[lay + name + ".bias"] = _gauss(np, rng, (shape[0],))
        for name in ("layernorm_before", "layernorm_after"):
            out[lay + name + ".weight"] = _gauss(np, rng, (D,), 0.1, 1.0)
            out[lay + name + ".bias"] = _gauss(np, rng, (D,))
    return out


def write_vit_checkpoint(torch, np, path, cfg, seed: int = 0, dtype=None) -> dict:
    """A seeded HF ViT checkpoint (``model.safetensors`` in ``dtype``,
    default f32, and ``config.json``) under ``path``; returns the written
    tensors (torch, in ``dtype``)."""
    from generativeaiexamples_tpu_torch.engine.weights import save_safetensors

    os.makedirs(path, exist_ok=True)
    tensors = {k: torch.from_numpy(v).to(dtype or torch.float32) for k, v in vit_hf_tensors(np, cfg, seed).items()}
    save_safetensors(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as fh:
        json.dump({"model_type": "vit", "architectures": ["ViTModel"], "image_size": cfg.image_size,
                   "patch_size": cfg.patch_size, "num_channels": cfg.channels, "hidden_size": cfg.d_model,
                   "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
                   "intermediate_size": cfg.d_ff, "layer_norm_eps": cfg.norm_eps}, fh)
    return tensors


def vit_tree_from_hf(torch, cfg, tensors: dict, dev) -> dict:
    """The ViT tree a loader must build from ``tensors``, built here with
    plain reshapes (the reference's map), in ``cfg.compute_dtype``."""
    dt = cfg.compute_dtype

    def t(name):
        return tensors[name].to(device=dev, dtype=torch.float32)

    def stack(fmt, transpose):
        return torch.stack([t(fmt.format(i)).T if transpose else t(fmt.format(i)) for i in range(cfg.n_layers)])

    att = "encoder.layer.{}.attention.attention."
    lay = "encoder.layer.{}."
    tree = {
        "patch_proj": t("embeddings.patch_embeddings.projection.weight").permute(2, 3, 1, 0).reshape(
            cfg.patch_dim, cfg.d_model),
        "patch_bias": t("embeddings.patch_embeddings.projection.bias"),
        "pos_embed": t("embeddings.position_embeddings")[0],
        "cls": t("embeddings.cls_token"),
        "layers": {
            "ln1_g": stack(lay + "layernorm_before.weight", False), "ln1_b": stack(lay + "layernorm_before.bias", False),
            "wqkv": torch.cat([stack(att + w + ".weight", True) for w in ("query", "key", "value")], dim=2),
            "bqkv": torch.cat([stack(att + w + ".bias", False) for w in ("query", "key", "value")], dim=1),
            "wo": stack(lay + "attention.output.dense.weight", True),
            "bo": stack(lay + "attention.output.dense.bias", False),
            "ln2_g": stack(lay + "layernorm_after.weight", False), "ln2_b": stack(lay + "layernorm_after.bias", False),
            "w1": stack(lay + "intermediate.dense.weight", True), "b1": stack(lay + "intermediate.dense.bias", False),
            "w2": stack(lay + "output.dense.weight", True), "b2": stack(lay + "output.dense.bias", False),
        },
        "final_ln_g": t("layernorm.weight"),
        "final_ln_b": t("layernorm.bias"),
    }
    return {k: ({n: v.to(dt) for n, v in x.items()} if isinstance(x, dict) else x.to(dt)) for k, x in tree.items()}


def w2v2_hf_tensors(np, cfg, seed: int) -> dict:
    """HF ``Wav2Vec2ForCTC`` tensors (group-norm variant, weight-normed
    positional conv as ``weight_g`` / ``weight_v``) for ``cfg``, seeded."""
    rng = np.random.default_rng(seed)
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    fe = "wav2vec2.feature_extractor.conv_layers."
    out = {}
    c_in = 1
    for i, (c_out, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        out[f"{fe}{i}.conv.weight"] = _gauss(np, rng, (c_out, c_in, k), 1.0 / math.sqrt(c_in * k))
        c_in = c_out
    out[fe + "0.layer_norm.weight"] = _gauss(np, rng, (cfg.conv_dim[0],), 0.1, 1.0)
    out[fe + "0.layer_norm.bias"] = _gauss(np, rng, (cfg.conv_dim[0],))
    pre = "wav2vec2."
    out[pre + "feature_projection.layer_norm.weight"] = _gauss(np, rng, (c_in,), 0.1, 1.0)
    out[pre + "feature_projection.layer_norm.bias"] = _gauss(np, rng, (c_in,))
    out[pre + "feature_projection.projection.weight"] = _gauss(np, rng, (D, c_in))
    out[pre + "feature_projection.projection.bias"] = _gauss(np, rng, (D,))
    pc = pre + "encoder.pos_conv_embed.conv."
    out[pc + "weight_g"] = np.abs(_gauss(np, rng, (1, 1, cfg.pos_conv_kernel), 0.5, 1.0))
    out[pc + "weight_v"] = _gauss(np, rng, (D, D // cfg.pos_conv_groups, cfg.pos_conv_kernel))
    out[pc + "bias"] = _gauss(np, rng, (D,))
    out[pre + "encoder.layer_norm.weight"] = _gauss(np, rng, (D,), 0.1, 1.0)
    out[pre + "encoder.layer_norm.bias"] = _gauss(np, rng, (D,))
    for i in range(cfg.n_layers):
        lay = f"{pre}encoder.layers.{i}."
        for name, shape in (("attention.q_proj", (D, D)), ("attention.k_proj", (D, D)), ("attention.v_proj", (D, D)),
                            ("attention.out_proj", (D, D)), ("feed_forward.intermediate_dense", (F_, D)),
                            ("feed_forward.output_dense", (D, F_))):
            out[lay + name + ".weight"] = _gauss(np, rng, shape)
            out[lay + name + ".bias"] = _gauss(np, rng, (shape[0],))
        for name in ("layer_norm", "final_layer_norm"):
            out[lay + name + ".weight"] = _gauss(np, rng, (D,), 0.1, 1.0)
            out[lay + name + ".bias"] = _gauss(np, rng, (D,))
    out["lm_head.weight"] = _gauss(np, rng, (V, D), 0.2)
    out["lm_head.bias"] = _gauss(np, rng, (V,))
    return out


def write_w2v2_checkpoint(torch, np, path, cfg, seed: int = 0) -> dict:
    """A seeded HF wav2vec2-CTC checkpoint under ``path``: f32
    ``model.safetensors``, ``config.json`` and the base model's
    ``vocab.json``; returns the numpy tensors."""
    from generativeaiexamples_tpu_torch.engine.weights import save_safetensors
    from generativeaiexamples_tpu_torch.models.speech import W2V2_VOCAB

    os.makedirs(path, exist_ok=True)
    tensors = w2v2_hf_tensors(np, cfg, seed)
    save_safetensors(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as fh:
        json.dump({"model_type": "wav2vec2", "architectures": ["Wav2Vec2ForCTC"], "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
                   "num_attention_heads": cfg.n_heads, "intermediate_size": cfg.d_ff,
                   "conv_dim": list(cfg.conv_dim), "conv_kernel": list(cfg.conv_kernel),
                   "conv_stride": list(cfg.conv_stride), "num_conv_pos_embeddings": cfg.pos_conv_kernel,
                   "num_conv_pos_embedding_groups": cfg.pos_conv_groups, "layer_norm_eps": cfg.norm_eps,
                   "do_stable_layer_norm": False, "feat_extract_norm": "group"}, fh)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as fh:
        json.dump({tok: i for i, tok in enumerate(W2V2_VOCAB[: cfg.vocab_size])}, fh)
    return tensors


# -- a raw-socket WebSocket client (RFC 6455) for the speech service ----------


class WSClient:
    """A blocking WebSocket client on a plain socket: masked frames out,
    unmasked frames in (the framing of ``engine.speech_service``)."""

    def __init__(self, host: str, port: int, path: str, timeout: float = 120.0) -> None:
        import base64
        import socket

        from generativeaiexamples_tpu_torch.engine.speech_service import ws_accept_key

        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.rfile = self.sock.makefile("rb")
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n")
                          .encode())
        status = self.rfile.readline()
        headers = {}
        while True:
            line = self.rfile.readline().decode("latin-1").strip()
            if not line:
                break
            name, _, value = line.partition(":")
            headers[name.strip().lower()] = value.strip()
        if b" 101 " not in status or headers.get("sec-websocket-accept") != ws_accept_key(key):
            raise AssertionError(f"websocket handshake failed: {status!r} {headers}")

    def send(self, opcode: int, payload: bytes, fin: bool = True) -> None:
        from generativeaiexamples_tpu_torch.engine.speech_service import ws_frame

        self.sock.sendall(ws_frame(opcode, payload, os.urandom(4), fin=fin))

    def send_json(self, obj) -> None:
        self.send(0x1, json.dumps(obj).encode())

    def send_bytes(self, data: bytes) -> None:
        self.send(0x2, data)

    def recv(self) -> tuple[int, bytes]:
        """(opcode, payload) of the next frame."""
        from generativeaiexamples_tpu_torch.engine.speech_service import ws_read_frame

        _, opcode, payload = ws_read_frame(self.rfile, require_mask=False)
        return opcode, payload

    def recv_json_until_done(self) -> list:
        """Every JSON message up to and including ``done`` (or a close)."""
        events = []
        while True:
            opcode, payload = self.recv()
            if opcode != 0x1:
                return events + [{"close": int.from_bytes(payload[:2], "big") if len(payload) >= 2 else None}]
            events.append(json.loads(payload))
            if events[-1]["type"] == "done":
                return events

    def close(self, code: int = 1000) -> None:
        try:
            self.send(0x8, code.to_bytes(2, "big"))
            while self.recv()[0] != 0x8:
                pass
        except Exception:
            pass
        self.sock.close()


def stream_pcm(ws, pcm16: bytes, frame_bytes: int, rate: int = 16_000) -> list:
    """Config, ``pcm16`` in frames of ``frame_bytes``, then ``end``: every
    message the server sends back, ``done`` last (the ms from sending
    ``end`` to reading ``done`` in ``ws.end_to_done_ms``)."""
    ws.send_json({"type": "config", "sample_rate": rate})
    for i in range(0, len(pcm16), frame_bytes):
        ws.send_bytes(pcm16[i : i + frame_bytes])
    t0 = time.perf_counter()
    ws.send_json({"type": "end"})
    events = ws.recv_json_until_done()
    ws.end_to_done_ms = (time.perf_counter() - t0) * 1e3
    return events


def speech_wave(np, seed: int, seconds: float, silence: float = 0.0):
    """A voiced-looking f32 signal at 16 kHz (harmonics of a wavering pitch
    under an envelope, a little noise), then ``silence`` seconds of
    near-silence (energy far below the endpointer's threshold)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16_000)) / 16_000
    f0 = 120 + 40 * np.sin(2 * np.pi * 1.5 * t)
    voiced = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 16_000) / k for k in range(1, 6))
    wave = 0.3 * voiced * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2) + 0.02 * rng.normal(size=t.shape)
    return np.concatenate([wave, 1e-4 * rng.normal(size=int(silence * 16_000))]).astype(np.float32)


# ---------------------------------------------------------------------------
# the model services: vision, the multimodal chain, speech
# ---------------------------------------------------------------------------

VISION_SEED = 21
VISION_REF_LAYERS = 2  # of Llama-3-8B's 32 in vision_reference's VLM (full width)
VISION_DECODE_STEPS = 8
# ViT-B/16 features in bf16, card against CPU on the same weights: cuBLAS's
# and the CPU GEMM's bf16 roundings after sums in other orders, through 12
# layers and the final LayerNorm (features of magnitude ~1-5).
VIT_TOL = dict(rel_rms=0.02, max_abs_frac=0.1)
# The same weights in f32 (IEEE f32 or better on the card, ops.f32): sums
# in other orders only.  The planted faults must fail this gate (tanh
# GELU moves ViT-B's f32 features by ~2.6e-4 RMS, below bf16's own noise).
VIT_F32_TOL = dict(rel_rms=2e-5, max_abs_frac=1e-4)
VISION_FAULTS = ("patchify_transposed", "gelu_tanh")
VLM_PROMPTS = ("Describe this image in detail:", "Generate the underlying data table for this figure:")
# The VLM's prefill blocks at vlm-base: 197 prefix rows + each prompt's
# byte tokens with BOS; t = s + 96 (the analyst's max_new_tokens).
VLM_PREFILL_S = (228, 249)


def _seeded_f32(np, seed: int, shape, std: float = 0.02, mean: float = 0.0, threads: int = 8):
    """f32 normal draws of ``shape`` from numpy seed ``seed``: row blocks
    filled on ``threads`` threads, each from its own spawned stream (numpy's
    generator releases the GIL while it fills)."""
    from concurrent.futures import ThreadPoolExecutor

    shape = tuple(shape)
    out = np.empty(shape, np.float32)
    bounds = np.linspace(0, shape[0], min(threads, shape[0]) + 1).astype(int)
    seqs = np.random.SeedSequence(seed).spawn(len(bounds) - 1)

    def fill(i):
        lo, hi = bounds[i], bounds[i + 1]
        block = np.random.default_rng(seqs[i]).standard_normal((hi - lo,) + shape[1:], dtype=np.float32)
        out[lo:hi] = block * np.float32(std) + np.float32(mean)

    with ThreadPoolExecutor(len(seqs)) as pool:
        list(pool.map(fill, range(len(seqs))))
    return out


def _seeded_tree(torch, np, shapes, seed: int, dtype, gains=(), _counter=None):
    """A tree of ``shapes`` (dicts and lists) as CPU tensors in ``dtype``
    from numpy seed ``seed``: every leaf drawn (0.02-std normal; the names
    in ``gains`` around 1 with 0.1 std), biases included, so a misplaced
    bias or gain cannot hide behind zeros and ones."""
    counter = _counter if _counter is not None else [0]
    if isinstance(shapes, list):
        return [_seeded_tree(torch, np, s, seed, dtype, gains, counter) for s in shapes]
    out = {}
    for name, shape in shapes.items():
        if isinstance(shape, (dict, list)):
            out[name] = _seeded_tree(torch, np, shape, seed, dtype, gains, counter)
            continue
        counter[0] += 1
        mean, std = (1.0, 0.1) if name in gains else (0.0, 0.02)
        out[name] = torch.from_numpy(_seeded_f32(np, seed * 1000 + counter[0], shape, std, mean)).to(dtype)
    return out


def _tree_to_dtype(tree, dtype):
    if isinstance(tree, list):
        return [_tree_to_dtype(t, dtype) for t in tree]
    return {k: _tree_to_dtype(v, dtype) if isinstance(v, (dict, list)) else v.to(dtype) for k, v in tree.items()}


def _tree_to(tree, dev):
    if isinstance(tree, list):
        return [_tree_to(t, dev) for t in tree]
    return {k: _tree_to(v, dev) if isinstance(v, (dict, list)) else v.to(dev) for k, v in tree.items()}


def _within(torch, out, ref, tol: dict, what: str) -> dict:
    """(rel RMS, max abs / max |ref|) of ``out`` against ``ref``; fails
    past ``tol`` (``rel_rms``, ``max_abs_frac``)."""
    rel_rms, frac = _share(out.float().cpu(), ref.float().cpu())
    reading = dict(rel_rms=rel_rms, max_abs_frac=frac)
    if not (rel_rms <= tol["rel_rms"] and frac <= tol["max_abs_frac"]):
        raise ToleranceError(f"{what}: rel RMS {rel_rms:.4g}, max {frac:.4g} of the largest (tolerance {tol})",
                             reading)
    return reading


class _VisionFault:
    """One planted fault in ``models.vision`` while entered: patchify with
    patch rows and columns swapped, or tanh GELU in place of erf."""

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        import types

        import torch.nn.functional as F

        from generativeaiexamples_tpu_torch.models import vision

        self.saved = vision.patchify, vision.F
        if self.name == "patchify_transposed":
            def patchify(cfg, images):
                b, p, n = images.shape[0], cfg.patch_size, cfg.image_size // cfg.patch_size
                x = images.reshape(b, n, p, n, p, cfg.channels).permute(0, 3, 1, 4, 2, 5)
                return x.reshape(b, n * n, cfg.patch_dim)

            vision.patchify = patchify
        else:
            vision.F = types.SimpleNamespace(gelu=lambda x: F.gelu(x, approximate="tanh"))
        return self

    def __exit__(self, *exc):
        from generativeaiexamples_tpu_torch.models import vision

        vision.patchify, vision.F = self.saved


def vision_reference_phase(torch, dev, smi: str) -> dict:
    """ViT-B/16 (12 layers, bf16, numpy seed) and the VLM at full width
    (ViT-B + Llama-3-8B at ``VISION_REF_LAYERS`` layers) on the card and on
    the CPU with the same weights; two planted faults must fail the ViT
    gate.  Returns the phase's fields."""
    import numpy as np

    from generativeaiexamples_tpu_torch.engine.tokenizer import ByteTokenizer
    from generativeaiexamples_tpu_torch.models import llama, vision

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    vcfg = vision.vit_base()
    gains = ("ln1_g", "ln2_g", "final_ln_g")
    vit_cpu = _seeded_tree(torch, np, vision.vit_param_shapes(vcfg), VISION_SEED, vcfg.compute_dtype, gains)
    vit_dev = _tree_to(vit_cpu, dev)
    images = torch.from_numpy(np.random.default_rng(VISION_SEED).random((2, 224, 224, 3), dtype=np.float32))
    fields = dict(nvidia_smi=smi, vit="vit-b/16, 12 layers, bf16, numpy seed", images=list(images.shape))
    with torch.inference_mode():
        exact = torch.equal(vision.patchify(vcfg, images.to(dev)).cpu(), vision.patchify(vcfg, images))
        if not exact:
            raise AssertionError("vision_reference: patchify on the card differs from the CPU's")
        ref = vision.vit_encode(vit_cpu, vcfg, images)
        fields["vit_features"] = _within(torch, vision.vit_encode(vit_dev, vcfg, images.to(dev)), ref, VIT_TOL,
                                         "vision_reference: ViT features")
        # f32: the same weights, and the gate the planted faults must fail.
        f32cfg = vision.vit_base(dtype="float32")
        vit32 = {"cpu": _tree_to_dtype(vit_cpu, torch.float32)}
        vit32["card"] = _tree_to(vit32["cpu"], dev)
        ref32 = vision.vit_encode(vit32["cpu"], f32cfg, images)
        fields["vit_features_f32"] = _within(torch, vision.vit_encode(vit32["card"], f32cfg, images.to(dev)), ref32,
                                             VIT_F32_TOL, "vision_reference: f32 ViT features")
        faults = {}
        for fault in VISION_FAULTS:
            with _VisionFault(fault):
                try:
                    _within(torch, vision.vit_encode(vit32["card"], f32cfg, images.to(dev)), ref32, VIT_F32_TOL,
                            fault)
                except ToleranceError as exc:
                    faults[fault] = exc.fields
                    continue
            raise AssertionError(f"vision_reference: the planted fault {fault} passed the f32 ViT gate")
        fields["faults_failed_the_gate"] = faults
        del vit32

        # The VLM at full width: the prefix, the prefill's last logits, and
        # greedy decode steps fed the card's ids on both sides.
        lcfg = llama.llama3_8b(n_layers=VISION_REF_LAYERS)
        cfg = vision.vlm_base(lm=lcfg)
        lm_cpu = _seeded_tree(torch, np, llama.param_shapes(lcfg), VISION_SEED + 1, lcfg.compute_dtype,
                              llama.NORM_GAINS)
        proj = torch.from_numpy(_seeded_f32(np, VISION_SEED + 2, (vcfg.d_model, lcfg.d_model))).to(torch.bfloat16)
        sides = {"card": {"vit": vit_dev, "projector": proj.to(dev), "lm": _tree_to(lm_cpu, dev)}}
        # The CPU's projections and head held in f32 once: the same values,
        # and the same products (on the CPU a bf16 product widens both
        # operands to f32 on every call, the weight included).
        proj_names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
        lm_f32 = {**lm_cpu, "lm_head": lm_cpu["lm_head"].float(),
                  "layers": {k: v.float() if k in proj_names else v for k, v in lm_cpu["layers"].items()}}
        sides["cpu"] = {"vit": vit_cpu, "projector": proj, "lm": lm_f32}
        prompt = ByteTokenizer().encode(VLM_PROMPTS[0])
        max_len = cfg.n_prefix + len(prompt) + VISION_DECODE_STEPS + 1
        out = {}
        for side, params in sides.items():
            d = dev if side == "card" else cpu
            img, tok = images[:1].to(d), torch.tensor([prompt], dtype=torch.int32, device=d)
            out[side] = {"prefix": vision.vlm_prefix(params, cfg, img)}
            out[side]["logits"], out[side]["cache"], out[side]["lengths"] = vision.vlm_prefill(
                params, cfg, img, tok, max_len)
        fields["prefix"] = _within(torch, out["card"]["prefix"], out["cpu"]["prefix"], XLA_TOL, "vision_reference: prefix")
        fields["prefill_logits"] = _within(torch, out["card"]["logits"], out["cpu"]["logits"], XLA_TOL,
                                           "vision_reference: prefill logits")
        steps, same_argmax = [], 0
        tok = out["card"]["logits"].argmax(-1).to(torch.int32)
        pos = out["card"]["lengths"]
        for i in range(VISION_DECODE_STEPS):
            got = vision.vlm_decode_step(sides["card"]["lm"], lcfg, out["card"]["cache"], tok, pos)
            want = vision.vlm_decode_step(sides["cpu"]["lm"], lcfg, out["cpu"]["cache"], tok.cpu(), pos.cpu())
            steps.append(_within(torch, got, want, XLA_TOL, f"vision_reference: decode step {i}"))
            same_argmax += int(got.argmax(-1).item() == want.argmax(-1).item())
            tok, pos = got.argmax(-1).to(torch.int32), pos + 1
        fields.update(vlm=f"vit-b/16 + llama3-8b at {VISION_REF_LAYERS} of 32 layers, bf16, numpy seed",
                      prompt_tokens=len(prompt), prefill_s=cfg.n_prefix + len(prompt), max_len=max_len,
                      decode_steps=steps, decode_same_argmax=same_argmax, tolerance=dict(vit=VIT_TOL, vit_f32=VIT_F32_TOL, vlm=XLA_TOL))
    del sides, out, vit_dev
    gc.collect()
    torch.cuda.empty_cache()
    fields["phase_s"] = time.perf_counter() - t_phase
    emit("vision_reference", **fields)
    return fields


class _RecordIds:
    """Wraps an analyst's ``generate_ids`` for a phase: each call's image,
    prompt, ids and seconds (the analyst generates one image at a time)."""

    def __init__(self, analyst) -> None:
        self.calls: list = []
        inner = analyst.generate_ids

        def generate_ids(images, prompt):
            t0 = time.perf_counter()
            ids = inner(images, prompt)
            if len(ids) != 1:
                raise AssertionError(f"the analyst generated for {len(ids)} images at once")
            self.calls.append(dict(images=images, prompt=prompt, ids=ids[0], seconds=time.perf_counter() - t0))
            return ids

        analyst.generate_ids = generate_ids


def vlm_teacher_forced(torch, analyst, image, prompt: str, ids: list):
    """f32 logits (len(ids), vocab) of each generated position, from one
    cacheless forward over [image prefix ; prompt ; ids[:-1]]."""
    from generativeaiexamples_tpu_torch.models import llama, vision

    cfg, params, dev = analyst.cfg, analyst.params, analyst.device
    prompt_ids = analyst.tokenizer.encode(prompt)
    with torch.inference_mode():
        prefix = vision.vlm_prefix(params, cfg, torch.from_numpy(image[None]).to(dev))
        toks = torch.tensor([prompt_ids + list(ids[:-1])], dtype=torch.int32, device=dev)
        embeds = torch.cat([prefix, llama.embed(params["lm"], toks, prefix.dtype)], dim=1)
        total = embeds.shape[1]
        hidden, _ = llama.forward(params["lm"], cfg.lm, torch.zeros((1, total), dtype=torch.int32, device=dev),
                                  torch.arange(total, dtype=torch.int32, device=dev)[None], embeds=embeds)
        return llama.logits(params["lm"], hidden[:, cfg.n_prefix + len(prompt_ids) - 1 :])[0].float()


def _greedy_deficits(torch, logits, ids) -> list:
    """max logit minus the emitted id's logit, per position."""
    idx = torch.tensor(list(ids), device=logits.device)
    return (logits.max(-1).values - logits.gather(1, idx[:, None])[:, 0]).tolist()


def check_vlm_calls(torch, analyst, calls, where: str) -> dict:
    """Every generated id its position's argmax within ``PLAIN_TIE`` under
    one teacher-forced forward; returns the largest deficit and the logits
    of each call (by index)."""
    worst, logits = 0.0, []
    for c in calls:
        tf = vlm_teacher_forced(torch, analyst, c["images"][0], c["prompt"], c["ids"])
        worst = max(worst, max(_greedy_deficits(torch, tf, c["ids"])))
        logits.append(tf)
    if worst > PLAIN_TIE:
        raise AssertionError(f"{where}: a greedy id lies {worst:.4f} below its position's argmax (> PLAIN_TIE)")
    return dict(calls=len(calls), tokens=sum(len(c["ids"]) for c in calls), max_greedy_deficit=worst,
                tie=PLAIN_TIE, logits=logits)


def vit_flops(cfg, b: int) -> tuple[float, float]:
    """(bf16 product FLOPs, f32 attention FLOPs) of one ViT encode of ``b``
    images."""
    s, D, F_ = cfg.n_patches + 1, cfg.d_model, cfg.d_ff
    bf16 = 2.0 * b * cfg.n_patches * cfg.patch_dim * D + cfg.n_layers * 2.0 * b * s * (4 * D * D + 2 * D * F_)
    return bf16, cfg.n_layers * 4.0 * b * s * s * D


def vision_serve_gates(torch, dev, smi: str, analyst, calls: list, tf_logits: list, launches: dict,
                       hd128: int) -> None:
    """``vision_serve``, on the ``GPUVisionAnalyst(model_name="vlm-base")``
    that the multimodal server built from ``APP_VLM_*`` (ViT-B from the
    phase's seeded checkpoint, Llama-3-8B at 32 layers, random bf16 from
    seed 0) and its generations for the report PDF: the drawn chart
    described and tabled, the drawn photo described (``calls``, with their
    teacher-forced logits, every id already held within ``PLAIN_TIE``).
    K4 must have launched at head_dim 128 in those calls alone; a batch of
    the two images gives each image's ids alone, or leaves them only where
    the two tokens' logits lie within ``PLAIN_TIE``.  Timings: the ViT
    encode at batch 1 and 8 beside its FLOP bound, the prefill, the decode
    step as the analyst's graph replays and as one eager step (CUDA
    events), and the first decode of a fresh ``DecodeGraphs`` (one eager
    step and the capture, host clock)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.engine.vision_service import DESCRIBE_PROMPT, TABLE_PROMPT
    from generativeaiexamples_tpu_torch.models import vision

    t_phase = time.perf_counter()
    cfg, params = analyst.cfg, analyst.params
    if [c["prompt"] for c in calls] != [DESCRIBE_PROMPT, TABLE_PROMPT, DESCRIBE_PROMPT]:
        raise AssertionError(f"vision_serve: the report's generations were {[c['prompt'] for c in calls]}")
    if not (launches["flash_attention"] == 3 * cfg.lm.n_layers == hd128):
        raise AssertionError(f"vision_serve: K4 launches {launches}, at head_dim 128 {hd128}")
    # A batch of the two images.
    both = np.stack([calls[0]["images"][0], calls[2]["images"][0]])
    tokens = torch.tensor([analyst.tokenizer.encode(DESCRIBE_PROMPT)] * 2, dtype=torch.int32, device=dev)
    batch = vision.vlm_generate(params, cfg, torch.from_numpy(both).to(dev), tokens, analyst.max_new_tokens,
                                graphs=analyst.graphs)
    departures = []
    for row, ci in zip(batch, (0, 2)):
        alone = calls[ci]["ids"]
        j = next((i for i, (a, b) in enumerate(zip(alone, row)) if a != b), None)
        if j is None:
            continue
        gap = abs(float(tf_logits[ci][j, alone[j]] - tf_logits[ci][j, row[j]]))
        if gap > PLAIN_TIE:
            raise AssertionError(f"vision_serve: batch row leaves its image's ids at {j} with a logit gap {gap:.4f}")
        departures.append(dict(position=j, logit_gap=gap))
    # Timings (CUDA events): the ViT encode, the prefill, the decode step.
    timing = {}
    with torch.inference_mode():
        for b in (1, 8):
            imgs = torch.from_numpy(np.repeat(both[:1], b, 0)).to(dev)
            ms = _event_ms(torch, lambda: vision.vit_encode(params["vit"], cfg.vit, imgs), n=5)
            bf16_ops, f32_ops = vit_flops(cfg.vit, b)
            b_ms = (bf16_ops / BF16_FLOPS + f32_ops / F32_FLOPS) * 1e3
            timing[f"vit_encode_b{b}"] = dict(ms=ms, bound_ms=b_ms, bound_by="operations", bound_share=b_ms / ms)
        img, tok = torch.from_numpy(both[:1]).to(dev), tokens[:1]
        max_len = cfg.n_prefix + tok.shape[1] + analyst.max_new_tokens
        graphs, steps = analyst.graphs, analyst.max_new_tokens - 1
        cache = graphs.cache(1, max_len)
        timing["prefill_ms"] = _event_ms(
            torch, lambda: vision.vlm_prefill(params, cfg, img, tok, max_len, cache=cache), n=3)
        first, cache, lengths = vision.vlm_prefill(params, cfg, img, tok, max_len, cache=cache)
        nxt = first.argmax(-1).to(torch.int32)
        # The report's captions captured this key's graph: these are replays.
        captures = graphs.captures
        timing["decode_step_ms"] = _event_ms(torch, lambda: graphs.decode(cache, nxt, lengths, steps), n=3) / steps
        if graphs.captures != captures:
            raise AssertionError("vision_serve: the timed decode captured a graph; the captions' capture was lost")
        timing["decode_tokens_per_s"] = 1e3 / timing["decode_step_ms"]
        timing["decode_step_eager_ms"] = _event_ms(
            torch, lambda: vision.vlm_decode_step(params["lm"], cfg.lm, cache, nxt, lengths), n=3)
        fresh = vision.DecodeGraphs(params["lm"], cfg.lm, dev)
        fresh_cache = fresh.cache(1, max_len)
        vision.vlm_prefill(params, cfg, img, tok, max_len, cache=fresh_cache)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fresh.decode(fresh_cache, nxt, lengths, 1)
        torch.cuda.synchronize(dev)
        capture_ms = (time.perf_counter() - t0) * 1e3
        del fresh, fresh_cache, cache
    emit("vision_serve", nvidia_smi=smi,
         model="vlm-base: vit-b/16 (the multimodal phase's seeded checkpoint) + llama3-8b, 32 layers, random bf16, "
               "seed 0", analyst="the multimodal server's, from APP_VLM_*",
         prompt_tokens=[len(analyst.tokenizer.encode(p)) for p in VLM_PROMPTS],
         prefill_s=[cfg.n_prefix + len(analyst.tokenizer.encode(p)) for p in VLM_PROMPTS],
         max_new_tokens=analyst.max_new_tokens, generations=len(calls),
         seconds_per_generation=[c["seconds"] for c in calls], launches=launches, flash_hd128_launches=hd128,
         teacher_forced_max_deficit=max(max(_greedy_deficits(torch, lg, c["ids"])) for lg, c in zip(tf_logits, calls)),
         tie=PLAIN_TIE, batch_of_two_departures=departures, **timing,
         peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9, gates_s=time.perf_counter() - t_phase)
    emit("vision_serve_capture", nvidia_smi=smi, first_decode_eager_step_and_capture_ms=capture_ms,
         clock="host, synchronized before and after", decode_step_eager_ms=timing["decode_step_eager_ms"],
         what="a fresh DecodeGraphs' first decode of one step at the describe prompt's cache: its eager "
              "warm-up step and the capture of the next")


MULTIMODAL_ENV = {"GAIE_EXAMPLE_MODULE": "generativeaiexamples_tpu_torch.chains.multimodal",
                  "APP_VLM_MODELENGINE": "tpu", "APP_VLM_MODELNAME": "vlm-base", "APP_LLM_MODELENGINE": "echo"}


def _found(module: str) -> bool:
    """Whether ``module`` is installed (found without importing it)."""
    import importlib.util

    return importlib.util.find_spec(module) is not None


BESIDE_LLM_QUERY = "What does the quarterly report say about revenue?"


def caption_beside_llm(torch, dev, smi: str, pdf: str, report_calls: list, report_chunks: list) -> dict:
    """``caption_beside_llm``: ``MULTIMODAL_ENV`` with the in-process LLM
    (``APP_LLM_MODELENGINE=tpu``: Llama-3-8B W8A8 behind ``GPUChatLLM``,
    random int8 from seed 0, its tick thread on the card) and the same
    weights directory, so the analyst is the echo server's, newly built.
    Greedy ``/generate`` requests (no knowledge base, so every prompt is
    the same) stream back to back on a thread while the report PDF is
    uploaded: the analyst captures its decode graphs and replays them
    beside the LLM's allocations and launches.  Gates: the streams ran from
    before the upload to after it, none failed or degraded, every stream's
    ids equal the engine's for the same prompt submitted alone (prefix
    cache off, as in ``chain``); the analyst captured two graphs (one per
    role prompt) during the upload; the generations' prompts and ids and
    every chunk (kind, text, source) equal the echo server's for the same
    report (``report_calls``, ``report_chunks``)."""
    from generativeaiexamples_tpu_torch.chains import factory
    from generativeaiexamples_tpu_torch.chains.llm import GPUChatLLM
    from generativeaiexamples_tpu_torch.core.configuration import reset_config_cache
    from generativeaiexamples_tpu_torch.engine.vision_service import get_vision_analyst, reset_vision_analyst
    from generativeaiexamples_tpu_torch.server.app import create_app

    t_phase = time.perf_counter()
    os.environ["APP_LLM_MODELENGINE"] = "tpu"
    reset_config_cache()
    factory.reset_factories()
    reset_vision_analyst()
    server = thread = None
    stream_method = GPUChatLLM.stream
    try:
        server = create_app(device=dev)
        torch.cuda.synchronize()
        llm, analyst, store = factory.peek_chat_llm(), get_vision_analyst(), factory.get_store()
        if not isinstance(llm, GPUChatLLM) or llm.scheduler.device.type != dev.type or analyst.graphs is None or \
                analyst.graphs.captures:
            raise AssertionError(f"caption_beside_llm: create_app() built {llm!r}, {analyst!r}")
        sched = llm.scheduler
        rec = _RecordIds(analyst)
        stored = []
        add = store.add

        def recording_add(chunks, embeddings):
            stored.extend(chunks)
            return add(chunks, embeddings)

        store.add = recording_add
        received, ids_by_request = [], {}

        def recording_stream(self, messages, **kw):
            received.append(list(messages))
            return stream_method(self, messages, **kw)

        GPUChatLLM.stream = recording_stream
        submit = sched.submit

        def recording_submit(req):
            on_token, got = req.on_token, ids_by_request.setdefault(req.id, [])
            req.on_token = lambda t: (got.append(int(t)), on_token(t))
            return submit(req)

        sched.submit = recording_submit
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        # Streams back to back until the upload has returned.
        sched.prefix_cache = "off"
        stop, results, errors = threading.Event(), [], []

        def streams():
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    res = _generate(base, BESIDE_LLM_QUERY, kb=False)
                except Exception as exc:  # noqa: BLE001 - a gate below reports it
                    errors.append(repr(exc))
                    return
                results.append(dict(res, started=t0, ended=time.perf_counter()))

        streamer = threading.Thread(target=streams, daemon=True)
        streamer.start()
        t0 = time.perf_counter()
        while not any(ids_by_request.values()) and not errors and time.perf_counter() - t0 < 300:
            time.sleep(0.005)
        with open(pdf, "rb") as fh:
            data = fh.read()
        up0 = time.perf_counter()
        upload_ms = _upload_bytes(base, "report.pdf", data)
        up1 = time.perf_counter()
        captures = analyst.graphs.captures
        stop.set()
        streamer.join(600)
        sched.prefix_cache = "shared"
        if errors or streamer.is_alive() or not results:
            raise AssertionError(f"caption_beside_llm: the streams failed: {errors[:2]}")
        if any(r["status"] != 200 or r["done"]["degraded"] for r in results):
            raise AssertionError(f"caption_beside_llm: a stream failed or degraded: "
                                 f"{[r.get('done') for r in results][:3]}")
        if not (results[0]["started"] < up0 and results[-1]["ended"] > up1):
            raise AssertionError("caption_beside_llm: the streams did not run through the upload")
        streamed = [list(v) for v in ids_by_request.values()]
        if len(streamed) != len(results) or any(m != received[0] for m in received):
            raise AssertionError(f"caption_beside_llm: {len(streamed)} streams recorded for {len(results)} "
                                 "requests, or the prompts differed")
        # The engine's ids for the same prompt, submitted alone.
        _, _, prompt_ids, alone = _same_as_engine(base, llm, sched, received, ids_by_request, BESIDE_LLM_QUERY,
                                                  kb=False, where="caption_beside_llm")
        if any(ids != alone for ids in streamed):
            raise AssertionError(f"caption_beside_llm: a stream's ids differ from the engine's alone: "
                                 f"{[ids for ids in streamed if ids != alone][:1]} != {alone}")
        got_calls = [dict(prompt=c["prompt"], ids=c["ids"]) for c in rec.calls]
        got_chunks = [(c.metadata["kind"], c.text, c.source) for c in stored]
        if captures != 2 or got_calls != report_calls or got_chunks != report_chunks:
            raise AssertionError(f"caption_beside_llm: {captures} captures; generations equal "
                                 f"{got_calls == report_calls}, chunks equal {got_chunks == report_chunks}")
        overlap = [min(r["ended"], up1) - max(r["started"], up0) for r in results]
        emit("caption_beside_llm", nvidia_smi=smi, config=dict(MULTIMODAL_ENV, APP_LLM_MODELENGINE="tpu"),
             llm=f"llama3-8b W8A8, {sched.cfg.n_layers} layers, random int8, seed 0", upload_ms=upload_ms,
             streams=len(results), streams_open_during_upload=sum(o > 0 for o in overlap),
             stream_tokens=[len(ids) for ids in streamed], prompt_tokens=len(prompt_ids),
             stream_ids_equal_to_engine_alone=True, captures_during_upload=captures,
             generations=len(got_calls), generations_equal_to_echo_server=True, chunks=len(got_chunks),
             chunks_equal_to_echo_server=True,
             vlm_s_per_generation=[c["seconds"] for c in rec.calls],
             stream_wall_ms=[r["wall_ms"] for r in results], phase_s=time.perf_counter() - t_phase)
        return {"caption_beside_llm": len(results)}
    finally:
        GPUChatLLM.stream = stream_method
        if thread is not None:
            server.shutdown()
            thread.join(timeout=60)
        if server is not None:
            server.server_close()


def multimodal_phase(torch, dev, _cuda, smi: str) -> dict:
    """The multimodal chain served by ``create_app()`` from ``APP_*``
    (``MULTIMODAL_ENV``: the VLM on the card, the echo LLM, arctic-embed-l,
    the exact store) over HTTP, with a seeded HF ``vit/`` checkpoint under
    ``$GAIE_WEIGHTS_DIR/vlm-base``: a PDF (text, a table, a header and
    footer, a Flate RGB chart, a Flate gray photo) and a PPTX (text, notes;
    an image where PIL imports) in through ``POST /documents``.  Gates: the
    loaded ViT leaves equal the written arrays; the chunks' kinds; each
    caption chunk the analyst's decoded ids (teacher-forced as in
    ``vision_serve``); ``/search`` on a caption equal to the store's own
    search; a knowledge-base ``/generate`` streams; ``DELETE`` removes every
    chunk.  The server's analyst then takes ``vision_serve``'s gates
    (:func:`vision_serve_gates`) on the report's three generations, and
    the same report is uploaded again beside the in-process LLM
    (:func:`caption_beside_llm`).  Returns the launches of each (the
    report's upload; both uploads)."""
    import shutil
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch.chains import factory
    from generativeaiexamples_tpu_torch.core.configuration import reset_config_cache
    from generativeaiexamples_tpu_torch.engine.vision_service import (
        DESCRIBE_PROMPT,
        TABLE_PROMPT,
        GPUVisionAnalyst,
        HeuristicVisionAnalyst,
        get_vision_analyst,
        reset_vision_analyst,
    )
    from generativeaiexamples_tpu_torch.ingest.multimodal_pdf import parse_pdf
    from generativeaiexamples_tpu_torch.ingest.pptx import parse_pptx
    from generativeaiexamples_tpu_torch.models import vision
    from generativeaiexamples_tpu_torch.server.app import UPLOAD_DIR_ENV, create_app

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    saved_env = dict(os.environ)
    root = tempfile.mkdtemp(prefix="multimodal_")
    server = thread = None
    try:
        vcfg = vision.vit_base()
        written = write_vit_checkpoint(torch, np, os.path.join(root, "weights", "vlm-base", "vit"), vcfg,
                                       seed=VISION_SEED + 3, dtype=torch.bfloat16)
        os.environ.update(MULTIMODAL_ENV, GAIE_WEIGHTS_DIR=os.path.join(root, "weights"))
        os.environ[UPLOAD_DIR_ENV] = os.path.join(root, "uploads")
        reset_config_cache()
        factory.reset_factories()
        reset_vision_analyst()
        t0 = time.perf_counter()
        server = create_app(device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        analyst, store = get_vision_analyst(), factory.get_store()
        if not isinstance(analyst, GPUVisionAnalyst) or analyst.device != dev or analyst.cfg.lm.n_layers != 32 or \
                type(store).__name__ != "GPUVectorStore" or server.example_cls.__name__ != "MultimodalRAG":
            raise AssertionError(f"multimodal: create_app() built {server.example_cls}, {analyst!r}, {store!r}")
        bad = _tree_bits_equal(torch, analyst.params["vit"], vit_tree_from_hf(torch, vcfg, written, "cpu"))
        if bad:
            raise AssertionError(f"multimodal: loaded ViT leaves differ from the written checkpoint: {bad}")
        rec = _RecordIds(analyst)
        stored = []
        add = store.add

        def recording_add(chunks, embeddings):
            stored.extend(chunks)
            return add(chunks, embeddings)

        store.add = recording_add
        pdf, deck = os.path.join(root, "report.pdf"), os.path.join(root, "deck.pptx")
        write_pdf(np, pdf, report_pages(), [(0, chart_pixels(np)), (2, photo_pixels(np))])
        pil = _found("PIL")
        # The deck's image is a photo (one caption; a chart would take two).
        write_pptx(deck, [(["Fusion Update", "Ignition at 2x gain"], "Speaker: mention the gain"),
                          (["Next steps", "Budget and risks"], "")],
                   png_bytes(np, np.repeat(photo_pixels(np, seed=1)[..., None], 3, axis=2)) if pil else b"")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        ingest_ms, by_doc = {}, {}
        for path in (pdf, deck):
            _cuda.reset_launch_counts()
            with open(path, "rb") as fh:
                ingest_ms[os.path.basename(path)] = _upload_bytes(base, os.path.basename(path), fh.read())
            torch.cuda.synchronize()
            by_doc[os.path.basename(path)] = (dict(_cuda.LAUNCHES), _cuda.FLASH_HD_LAUNCHES[128], len(rec.calls))
        launches = {k: sum(v[0][k] for v in by_doc.values()) for k in _cuda.LAUNCHES}
        if not launches["flash_attention"]:
            raise AssertionError(f"multimodal: K4 did not launch in the VLM's prefills: {launches}")
        kinds = [c.metadata["kind"] for c in stored]
        if not {"text", "table", "chart", "image"} <= set(kinds) or not all(
                c.source in ("report.pdf", "deck.pptx") for c in stored):
            raise AssertionError(f"multimodal: chunk kinds {kinds}")
        # Each caption chunk, rebuilt from the recorded generations in the
        # chain's order (describe, then the table of a chart).
        calls, want = list(rec.calls), []
        heuristic = HeuristicVisionAnalyst()
        images = [(s.image, s.text) for s in parse_pdf(pdf) if s.kind == "image"]
        images += [(img, s.text[:200]) for s in parse_pptx(deck) for img in s.images]

        per_image = []

        def decoded(prompt):
            call = calls.pop(0)
            if call["prompt"] != prompt:
                raise AssertionError(f"multimodal: generation order {call['prompt']!r} != {prompt!r}")
            per_image[-1] += call["seconds"]
            return analyst.tokenizer.decode(call["ids"])

        for image, caption in images:
            per_image.append(0.0)
            desc = decoded(DESCRIBE_PROMPT)
            if heuristic.is_graph(image):
                want.append(("chart", f"Chart: {caption}\n{desc}\nData table:\n{decoded(TABLE_PROMPT)}"))
            else:
                want.append(("image", f"Image: {caption}\n{desc}"))
        got = [(c.metadata["kind"], c.text) for c in stored if c.metadata["kind"] in ("chart", "image")]
        if calls or got != want:
            raise AssertionError(f"multimodal: caption chunks {got} != the analyst's decoded ids {want}")
        gate = check_vlm_calls(torch, analyst, rec.calls, "multimodal")
        tf_logits = gate.pop("logits")
        # /search on a caption: the store's own search, bit for bit.
        retriever, cache = factory.get_retriever(), factory.get_retrieval_cache()
        query = got[0][1]
        if cache is not None:
            cache.clear()
        found = [(c["content"], c["filename"], c["score"]) for c in _search(base, query, retriever.top_k)]
        hits = store.search_batch(retriever.embedder.embed_queries([query]), retriever.top_k)[0]
        direct = [(h.chunk.text, h.chunk.source, h.score) for h in hits if h.score >= retriever.score_threshold]
        if not found or found != direct:
            raise AssertionError(f"multimodal: /search on a caption: {found[:2]} != {direct[:2]}")
        gen = _generate(base, "What does the chart show?", kb=True, max_tokens=16)
        if gen["status"] != 200 or not gen["pieces"]:
            raise AssertionError(f"multimodal: a knowledge-base /generate did not stream: {gen['status']}")
        for name in ("report.pdf", "deck.pptx"):
            status, _, raw = _http("DELETE", base + f"/documents?filename={name}")
            if status != 200:
                raise AssertionError(f"multimodal: DELETE {name}: {status} {raw[:200]!r}")
        _, _, raw = _http("GET", base + "/documents")
        rows = store.capacity_stats()["rows"]
        if json.loads(raw)["documents"] or rows:
            raise AssertionError(f"multimodal: {rows} rows left after the deletes")
        n_report = by_doc["report.pdf"][2]
        vision_serve_gates(torch, dev, smi, analyst, rec.calls[:n_report], tf_logits[:n_report],
                           *by_doc["report.pdf"][:2])
        del tf_logits
        fields = dict(nvidia_smi=smi, config=MULTIMODAL_ENV, build_s=build_s, vit_checkpoint_leaves_equal=True,
                      pil=pil, pytesseract=_found("pytesseract"),
                      ingest_ms=ingest_ms, chunks=len(stored),
                      chunks_by_kind={k: kinds.count(k) for k in sorted(set(kinds))}, generations=len(rec.calls),
                      vlm_s_per_image=per_image, teacher_forced=gate, search_on_caption_equal=True,
                      generate_ttft_ms=gen["ttft_ms"], deleted_rows_left=rows, launches=launches,
                      phase_s=time.perf_counter() - t_phase)
        emit("multimodal", **fields)
        report_calls = [dict(prompt=c["prompt"], ids=c["ids"]) for c in rec.calls[:n_report]]
        report_chunks = [(c.metadata["kind"], c.text, c.source) for c in stored if c.source == "report.pdf"]
        # The echo server goes before the drill builds its own.
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        server = thread = None
        del analyst, store, add, recording_add, retriever, cache, rec, stored
        factory.reset_factories()
        reset_vision_analyst()
        gc.collect()
        torch.cuda.empty_cache()
        caption_beside_llm(torch, dev, smi, pdf, report_calls, report_chunks)
        return {"vision_serve": by_doc["report.pdf"][0], "multimodal": launches}
    finally:
        if thread is not None:
            server.shutdown()
            thread.join(timeout=60)
        if server is not None:
            server.server_close()
        os.environ.clear()
        os.environ.update(saved_env)
        reset_config_cache()
        factory.reset_factories()
        reset_vision_analyst()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


SPEECH_SEED = 31
# f32 card (IEEE f32 or better: ops.f32's f64 products, cuFFT) against
# the CPU's f32 on the same weights and inputs, full width and depth.
SPEECH_TOL = {
    "log_mel": dict(atol=1e-3, rtol=1e-4),  # logs of power sums; quiet bins carry the error
    "asr_logits": dict(atol=1e-3, rtol=1e-3),  # 12 conformer blocks
    "tts_mel": dict(atol=1e-3, rtol=1e-3),  # 2 x 4 blocks over 2,048 frames
    "tts_durations": dict(atol=1e-4, rtol=1e-5),
    "w2v2_logits": dict(atol=1e-3, rtol=1e-3),  # 7 convs, 12 post-LN blocks
}
# Griffin-Lim from zero phase is chaotic on these spectra: the card's
# waveform is held within GL_SPREAD times the CPU's own change when its
# input moves by one ulp, after 1 and after 30 iterations.
GL_SPREAD = 8.0
SPEECH_SENTENCE = "the quick brown fox jumps over the lazy dog near the river bank"


def _close_within(torch, got, want, tol: dict, what: str) -> float:
    err = (got.float().cpu() - want.float().cpu()).abs()
    bound = tol["atol"] + tol["rtol"] * want.float().cpu().abs()
    if bool((err > bound).any()):
        raise ToleranceError(f"{what}: max error {err.max().item():.4g} past {tol}", dict(max_err=err.max().item()))
    return err.max().item()


def _ctc_ids_checked(torch, got, want, atol: float, what: str) -> int:
    """Frames whose CPU top-2 gap exceeds twice ``atol`` must give the same
    argmax on the card; returns how many were checked."""
    top2 = want.float().cpu().topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * atol
    same = got.float().cpu().argmax(-1) == want.float().cpu().argmax(-1)
    if bool((sure & ~same).any()):
        raise AssertionError(f"{what}: a CTC frame's id differs where its top-2 gap exceeds {2 * atol}")
    return int(sure.sum())


def _rel_rms(a, b) -> float:
    return float(((a - b) ** 2).mean().sqrt() / (b**2).mean().sqrt())


def speech_reference_phase(torch, dev, smi: str) -> dict:
    """Conformer-S, FastSpeech-S and wav2vec2-base at full width and depth
    (f32, numpy seed) on the card and on the CPU: log-mel, the ASR logits
    and CTC ids, the TTS mel and durations, Griffin-Lim, the wav2vec2
    logits and CTC ids, within ``SPEECH_TOL`` / ``GL_SPREAD``; a planted
    transposed filterbank must fail the log-mel gate."""
    import numpy as np

    from generativeaiexamples_tpu_torch.models import speech

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    fields = dict(nvidia_smi=smi)
    acfg, tcfg, wcfg = speech.conformer_s(), speech.fastspeech_s(), speech.wav2vec2_base()
    asr_gains = ("ffn1_norm", "attn_norm", "conv_norm", "ffn2_norm", "final_norm", "out_norm")
    trees = {
        "asr": _seeded_tree(torch, np, speech.asr_param_shapes(acfg), SPEECH_SEED, torch.float32, asr_gains),
        "tts": _seeded_tree(torch, np, speech.tts_param_shapes(tcfg), SPEECH_SEED + 1, torch.float32,
                            ("attn_norm", "mlp_norm")),
        "w2v2": _seeded_tree(torch, np, speech.w2v2_param_shapes(wcfg), SPEECH_SEED + 2, torch.float32,
                             ("gn_g", "fp_norm_g", "enc_norm_g", "ln1_g", "ln2_g")),
    }
    card = {k: _tree_to(v, dev) for k, v in trees.items()}
    pcm = speech_wave(np, SPEECH_SEED, 2.0)
    with torch.inference_mode():
        mel_cpu = speech.log_mel(torch.from_numpy(pcm), 400, 160, acfg.n_mels)
        fields["log_mel_max_err"] = _close_within(
            torch, speech.log_mel(torch.from_numpy(pcm).to(dev), 400, 160, acfg.n_mels), mel_cpu,
            SPEECH_TOL["log_mel"], "speech_reference: log-mel")
        fb = speech.mel_filterbank
        speech.mel_filterbank = lambda *a: fb(*a).T.reshape(fb(*a).shape).copy()
        try:
            speech_fault = None
            _close_within(torch, speech.log_mel(torch.from_numpy(pcm).to(dev), 400, 160, acfg.n_mels), mel_cpu,
                          SPEECH_TOL["log_mel"], "transposed filterbank")
        except ToleranceError as exc:
            speech_fault = exc.fields
        finally:
            speech.mel_filterbank = fb
        if speech_fault is None:
            raise AssertionError("speech_reference: the planted transposed filterbank passed the log-mel gate")
        a_cpu = speech.asr_forward(trees["asr"], acfg, mel_cpu[None])
        a_dev = speech.asr_forward(card["asr"], acfg, mel_cpu[None].to(dev))
        fields["asr_logits_max_err"] = _close_within(torch, a_dev, a_cpu, SPEECH_TOL["asr_logits"],
                                                     "speech_reference: ASR logits")
        fields["asr_ctc_frames_checked"] = _ctc_ids_checked(torch, a_dev, a_cpu, SPEECH_TOL["asr_logits"]["atol"],
                                                            "speech_reference: ASR")
        ids = [speech.text_to_ids(SPEECH_SENTENCE)]
        t_cpu, t_dev = speech.tts_forward(trees["tts"], tcfg, ids), speech.tts_forward(card["tts"], tcfg, ids)
        if not torch.equal(t_dev[1].cpu(), t_cpu[1]):
            raise AssertionError(f"speech_reference: TTS frame counts {t_dev[1]} != {t_cpu[1]}")
        fields["tts_mel_max_err"] = _close_within(torch, t_dev[0], t_cpu[0], SPEECH_TOL["tts_mel"],
                                                  "speech_reference: TTS mel")
        fields["tts_duration_max_err"] = _close_within(torch, t_dev[2], t_cpu[2], SPEECH_TOL["tts_durations"],
                                                       "speech_reference: TTS durations")
        n = int(t_cpu[1][0])
        m2l = torch.from_numpy(np.linalg.pinv(speech.mel_filterbank(tcfg.n_mels, tcfg.n_fft, tcfg.fs)).astype(
            np.float32))
        mag = torch.sqrt(torch.clamp(torch.exp(t_cpu[0][0, :n]) @ m2l, min=0.0))
        nudged = torch.from_numpy(np.nextafter(mag.numpy(), np.float32(np.inf)))
        edge = slice(tcfg.n_fft - tcfg.hop, -(tcfg.n_fft - tcfg.hop))
        gl = {}
        for iters in (1, 30):
            want = speech.griffin_lim(mag, tcfg.n_fft, tcfg.hop, iters)[edge]
            spread = _rel_rms(speech.griffin_lim(nudged, tcfg.n_fft, tcfg.hop, iters)[edge], want)
            got = _rel_rms(speech.griffin_lim(mag.to(dev), tcfg.n_fft, tcfg.hop, iters)[edge].cpu(), want)
            if got > GL_SPREAD * spread:
                raise AssertionError(f"speech_reference: Griffin-Lim ({iters} iterations) {got:.4g} rel RMS from "
                                     f"the CPU's, past {GL_SPREAD} x its one-ulp spread {spread:.4g}")
            gl[f"iters_{iters}"] = dict(rel_rms=got, cpu_one_ulp_spread=spread)
        fields["griffin_lim"] = gl
        wave = speech.w2v2_normalize(speech_wave(np, SPEECH_SEED + 1, 1.0))[None]
        w_cpu, w_dev = speech.w2v2_forward(trees["w2v2"], wcfg, wave), speech.w2v2_forward(card["w2v2"], wcfg, wave)
        fields["w2v2_logits_max_err"] = _close_within(torch, w_dev, w_cpu, SPEECH_TOL["w2v2_logits"],
                                                      "speech_reference: wav2vec2 logits")
        fields["w2v2_ctc_frames_checked"] = _ctc_ids_checked(
            torch, w_dev, w_cpu, SPEECH_TOL["w2v2_logits"]["atol"], "speech_reference: wav2vec2")
    fields.update(models="conformer-s, fastspeech-s, wav2vec2-base; f32, every leaf from numpy seed",
                  audio_s=len(pcm) / 16_000, tts_frames=n, tolerance=SPEECH_TOL, gl_spread=GL_SPREAD,
                  fault_failed_the_gate=speech_fault, phase_s=time.perf_counter() - t_phase)
    emit("speech_reference", **fields)
    del card, trees
    gc.collect()
    torch.cuda.empty_cache()
    return fields


def w2v2_tree_from_hf(torch, np, cfg, tensors: dict) -> dict:
    """The wav2vec2 tree a loader must build from the HF ``tensors``
    (numpy), mapped here as the reference maps it, as CPU f32 tensors."""
    def t(name):
        return torch.from_numpy(np.ascontiguousarray(tensors["wav2vec2." + name]))

    def stack(fmt, transpose=True):
        return torch.stack([t(fmt.format(i)).T if transpose else t(fmt.format(i)) for i in range(cfg.n_layers)])

    fe = "feature_extractor.conv_layers."
    convs = [{"w": t(f"{fe}{i}.conv.weight").permute(2, 1, 0).contiguous()} for i in range(len(cfg.conv_dim))]
    convs[0].update(gn_g=t(fe + "0.layer_norm.weight"), gn_b=t(fe + "0.layer_norm.bias"))
    pc = "encoder.pos_conv_embed.conv."
    g, v = tensors["wav2vec2." + pc + "weight_g"], tensors["wav2vec2." + pc + "weight_v"]
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True))
    pos_w = (g * v / np.maximum(norm, 1e-12)).astype(np.float32)
    enc = "encoder.layers.{}."
    layers = {}
    for ours, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
        layers["w" + ours] = stack(enc + f"attention.{hf}.weight")
        layers["b" + ours] = stack(enc + f"attention.{hf}.bias", False)
    for ours, hf in (("ff_in", "intermediate_dense"), ("ff_out", "output_dense")):
        layers[ours + "_w"] = stack(enc + f"feed_forward.{hf}.weight")
        layers[ours + "_b"] = stack(enc + f"feed_forward.{hf}.bias", False)
    for ours, hf in (("ln1", "layer_norm"), ("ln2", "final_layer_norm")):
        layers[ours + "_g"] = stack(enc + f"{hf}.weight", False)
        layers[ours + "_b"] = stack(enc + f"{hf}.bias", False)
    return {"conv_layers": convs, "fp_norm_g": t("feature_projection.layer_norm.weight"),
            "fp_norm_b": t("feature_projection.layer_norm.bias"), "fp_w": t("feature_projection.projection.weight").T,
            "fp_b": t("feature_projection.projection.bias"), "pos_conv_w": torch.from_numpy(pos_w).permute(2, 1, 0),
            "pos_conv_b": t(pc + "bias"), "enc_norm_g": t("encoder.layer_norm.weight"),
            "enc_norm_b": t("encoder.layer_norm.bias"), "layers": layers,
            "lm_head_w": torch.from_numpy(tensors["lm_head.weight"]).T, "lm_head_b": torch.from_numpy(tensors["lm_head.bias"])}


def _pcm16_frames_events(np, session, pcm16: bytes, frame_bytes: int) -> list:
    """A direct session fed ``pcm16`` as the service feeds it (frames of
    ``frame_bytes``, a dangling byte carried), then finished: the
    service's message list."""
    events, carry = [], b""
    for i in range(0, len(pcm16), frame_bytes):
        data = carry + pcm16[i : i + frame_bytes]
        cut = len(data) & ~1
        data, carry = data[:cut], data[cut:]
        if data:
            events += session.feed(np.frombuffer(data, np.int16).astype(np.float32) / 32768.0)
    events += session.finish()
    return [{"type": "final" if e["is_final"] else "partial", "text": e["text"]} for e in events] + [
        {"type": "done", "transcript": session.transcript}]


def _serve_speech(engine):
    from generativeaiexamples_tpu_torch.engine.speech_service import create_speech_app

    server = create_speech_app(engine)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, server.server_address[1]


def _stop_speech(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout=60)
    server.engine.close()


def _wav_multipart(data: bytes) -> tuple[bytes, dict]:
    boundary = "speechSmokeBoundary"
    body = (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="a.wav"\r\n'
            f"Content-Type: audio/wav\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


def speech_serve_phase(torch, dev, smi: str) -> dict:
    """The port's speech service in process on 127.0.0.1 (Conformer-S and
    FastSpeech-S, random f32 from seed 0, on the card): TTS to WAV to
    ``/v1/audio/transcriptions`` against a direct ``transcribe``; the
    WebSocket stream against a direct ``StreamingTranscriber``; streaming
    TTS frames against each segment's ``synthesize``; voices, health, the
    400s; then a seeded wav2vec2-base checkpoint from ``GAIE_W2V2_DIR``."""
    import shutil
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch.engine import speech_service as ss
    from generativeaiexamples_tpu_torch.models import speech

    t_phase = time.perf_counter()
    saved = os.environ.pop("GAIE_W2V2_DIR", None)
    engine = ss.SpeechEngine(device=dev)
    server, thread, port = _serve_speech(engine)
    base = f"http://127.0.0.1:{port}"
    root = tempfile.mkdtemp(prefix="speech_")
    fields = dict(nvidia_smi=smi, asr="conformer-s, random f32, seed 0", tts="fastspeech-s, random f32, seed 1")
    try:
        # TTS -> WAV -> ASR.
        t0 = time.perf_counter()
        status, _, wav = _http("POST", base + "/v1/audio/speech", {"input": SPEECH_SENTENCE})
        tts_s = time.perf_counter() - t0
        pcm = ss._read_wav(wav)
        if status != 200 or not np.array_equal(np.round(pcm * 32768).astype(np.int16),
                                               engine.synthesize(SPEECH_SENTENCE)[1]):
            raise AssertionError(f"speech_serve: /v1/audio/speech {status} differs from a direct synthesize")
        body, headers = _wav_multipart(wav)
        status, _, raw = _http("POST", base + "/v1/audio/transcriptions", body, headers)
        direct = engine.run(engine.transcribe, pcm)
        if status != 200 or json.loads(raw)["text"] != direct:
            raise AssertionError(f"speech_serve: transcription {raw[:200]!r} != direct {direct!r}")
        long = speech_wave(np, SPEECH_SEED + 2, 4.0)
        asr_ms = _host_ms(lambda: engine.run(engine.transcribe, long), n=3)
        # The WebSocket stream against a direct session fed the same frames.
        audio = np.concatenate([speech_wave(np, SPEECH_SEED + 3, 1.2, silence=1.4), speech_wave(np, SPEECH_SEED + 4, 1.0)])
        pcm16 = (audio * 32767).astype(np.int16).tobytes()
        ws = WSClient("127.0.0.1", port, "/v1/audio/transcriptions/stream")
        events = stream_pcm(ws, pcm16, 6401)
        end_to_done_ms = ws.end_to_done_ms
        ws.close()
        want = engine.run(lambda: _pcm16_frames_events(np, engine.streaming_transcriber(), pcm16, 6401))
        kinds = [e["type"] for e in events]
        if events != want or "final" not in kinds or "partial" not in kinds:
            raise AssertionError(f"speech_serve: stream events {events} != a direct session's {want}")
        # Streaming TTS: one frame per segment, each the segment's synthesize.
        text = (SPEECH_SENTENCE + ". ") * 6
        status, stream_headers, raw = _http("POST", base + "/v1/audio/speech/stream", {"input": text})
        frames, pos = [], 0
        while pos + 4 <= len(raw):
            n = int.from_bytes(raw[pos : pos + 4], "little")
            frames.append(np.frombuffer(raw[pos + 4 : pos + 4 + n], np.int16))
            pos += 4 + n
        segments = ss.segment_text(text)
        if status != 200 or stream_headers.get("X-Sample-Rate") != "16000" or len(frames) != len(segments) < 2 or any(
                not np.array_equal(f, engine.synthesize(s)[1]) for f, s in zip(frames, segments)):
            raise AssertionError(f"speech_serve: streaming TTS gave {len(frames)} frames for {len(segments)} segments")
        checks = {"/v1/audio/voices": (200, {"voices": [{"name": "default", "language": "en-US"}]}),
                  "/health": (200, {"message": "Service is up.", "asr_backend": "conformer-ctc"})}
        for path, (code, body_want) in checks.items():
            status, _, raw = _http("GET", base + path)
            if status != code or json.loads(raw) != body_want:
                raise AssertionError(f"speech_serve: GET {path}: {status} {raw[:200]!r}")
        for path in ("/v1/audio/speech", "/v1/audio/speech/stream"):
            status, _, raw = _http("POST", base + path, {"input": "   "})
            if status != 400 or json.loads(raw) != {"message": "empty input"}:
                raise AssertionError(f"speech_serve: {path} on empty input: {status} {raw[:200]!r}")
        fields.update(tts_real_time_factor=tts_s / (len(pcm) / 16_000), asr_ms_per_audio_s=asr_ms / 4.0,
                      stream_events=len(events), stream_end_to_done_ms=end_to_done_ms, tts_stream_frames=len(frames),
                      transcript_chars=len(direct))
        _stop_speech(server, thread)
        server = None
        # wav2vec2-base from a seeded HF checkpoint through GAIE_W2V2_DIR.
        wcfg = speech.wav2vec2_base()
        tensors = write_w2v2_checkpoint(torch, np, root, wcfg, seed=SPEECH_SEED + 5)
        os.environ["GAIE_W2V2_DIR"] = root
        t0 = time.perf_counter()
        w_engine = ss.SpeechEngine(device=dev)
        load_s = time.perf_counter() - t0
        server, thread, port = _serve_speech(w_engine)
        base = f"http://127.0.0.1:{port}"
        status, _, raw = _http("GET", base + "/health")
        if json.loads(raw).get("asr_backend") != "wav2vec2-ctc" or w_engine.asr_params is not None:
            raise AssertionError(f"speech_serve: GAIE_W2V2_DIR gave {raw[:200]!r}")
        _, params = w_engine.w2v2
        direct_tree = _tree_to(w2v2_tree_from_hf(torch, np, wcfg, tensors), dev)
        wave = speech.w2v2_normalize(pcm, pad=True)[None]
        with torch.inference_mode():
            served = speech.w2v2_forward(params, wcfg, wave)
            want = speech.w2v2_forward(direct_tree, wcfg, wave)
        w_err = (served - want).abs().max().item()
        if w_err > 1e-5 * max(want.abs().max().item(), 1.0):
            raise AssertionError(f"speech_serve: the served wav2vec2's logits are {w_err} from a direct forward")
        status, _, raw = _http("POST", base + "/v1/audio/transcriptions", body, headers)
        if status != 200 or json.loads(raw)["text"] != speech.w2v2_decode(served[0], w_engine.w2v2_vocab):
            raise AssertionError(f"speech_serve: wav2vec2 transcription {raw[:200]!r}")
        fields.update(w2v2="wav2vec2-base, HF safetensors from numpy seed", w2v2_load_s=load_s,
                      w2v2_logits_max_err=w_err, w2v2_backend="wav2vec2-ctc",
                      w2v2_asr_ms_per_audio_s=_host_ms(lambda: w_engine.run(w_engine.transcribe, long), n=3) / 4.0,
                      phase_s=time.perf_counter() - t_phase)
        # The port serves speech on http.server; the line records whether
        # aiohttp (the reference's server) is installed here.
        fields["aiohttp"] = _found("aiohttp")
        emit("speech_serve", **fields)
        return fields
    finally:
        if server is not None:
            _stop_speech(server, thread)
        os.environ.pop("GAIE_W2V2_DIR", None)
        if saved is not None:
            os.environ["GAIE_W2V2_DIR"] = saved
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training on one device, and the streaming SDR -> ASR -> RAG pipeline
# ---------------------------------------------------------------------------

TRAIN_SEED = 41
TRAIN_LAYERS = 8  # of Llama-3-8B's 32, at full width
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 1024, 6, 3e-4
# One step's loss, grad norm and the attention projections' gradient norms
# with K4 against the same step with the plain attention (8 bf16 layers;
# relative): ~4x the sound runs' readings (5.3e-5, 1.0e-4, 1.9e-4, the same
# in every run on the card), below what the planted faults read.  K4's
# wrapper returns the plain attention's autograd, recomputed, so its dq /
# dk / dv are held to that autograd bit for bit (a plumbing check).
TRAIN_STEP_TOL = dict(loss=2e-4, grad_norm=4e-4, projection_norms=8e-4)
# Planted in the step through K4 (``_train_fault``); each must fail
# ``TRAIN_STEP_TOL`` or the non-zero gate.
TRAIN_FAULTS = ("output_one_ulp_up", "noncausal_backward", "dk_dropped")
LORA_SEED = 43
LORA_BATCH, LORA_SEQ, LORA_STEPS, LORA_LR = 4, 512, 4, 2e-3
# The losses' card-vs-CPU gates at 2 layers (relative): bf16 models (BERT,
# the VLM) read cuBLAS's and the CPU's roundings, and the card's backward
# rounds its cotangents to bf16 where the CPU's runs in f32; FastSpeech is
# f32 with f64 products on the card.  ~5x the sound runs' largest readings
# (contrastive 3.2e-5 / 8.6e-5, the VLM 1.1e-4 / 9.5e-4, FastSpeech 1.4e-7
# / 0; the CPU's half moves with the host's CPU), below the planted faults'.
LOSS_TOL = {"contrastive": dict(loss=2e-4, grad_norm=5e-4), "vlm_caption": dict(loss=5e-4, grad_norm=5e-3),
            "tts": dict(loss=1e-6, grad_norm=1e-6)}
# Planted in each loss's card half (``train_losses_phase``); each must fail
# its ``LOSS_TOL``.
LOSS_FAULTS = {"contrastive": ("passage_mask_short_by_one",),
               "vlm_caption": ("text_positions_from_zero", "patchify_transposed"), "tts": ("tf32_products",)}
LOSS_STEPS = 3
STREAM_SECONDS, STREAM_FS_SOURCE, STREAM_BLOCK = 10.0, 50_000, 65_536
STREAM_TONE_HZ = 1000.0
STREAM_SPEED = 2.0  # the UDP replay's pace, x real time
STREAM_QUESTION = "What was said on the radio about the weather?"


class _SwapAttention:
    """While entered, ``models.llama``'s attention is ``fn`` (the phase
    swaps it in; the package has no switch)."""

    def __init__(self, llama, fn) -> None:
        self.llama, self.fn = llama, fn

    def __enter__(self):
        self.saved = self.llama.attention
        self.llama.attention = self.fn
        return self

    def __exit__(self, *exc):
        self.llama.attention = self.saved


def _train_attention(torch, path: str):
    """The attention of one of ``train``'s step paths: ``plain`` (the
    plain PyTorch ``gqa_attention``, no K4) or a planted fault in the step
    through K4: ``output_one_ulp_up`` (K4's output moved one bf16 ulp away
    from zero in every element; K4's gradient), ``noncausal_backward``
    (K4's output; the gradient of the attention without its causal mask),
    ``dk_dropped`` (K4's output and gradient, dk zero)."""
    from generativeaiexamples_tpu_torch.ops.attention import attention, gqa_attention

    def plain(q, k, v, pos, kv_lengths=None, **kw):
        return gqa_attention(q, k, v, pos, kv_lengths, **kw)

    def output_one_ulp_up(q, k, v, pos, kv_lengths=None, **kw):
        out = attention(q, k, v, pos, kv_lengths, **kw)
        bits = torch.int16 if out.element_size() == 2 else torch.int32
        up = (out.detach().view(bits) + 1).view(out.dtype)
        return out + (up - out.detach())

    def noncausal_backward(q, k, v, pos, kv_lengths=None, **kw):
        out = attention(q, k, v, pos, kv_lengths, **kw)
        wrong = gqa_attention(q, k, v, torch.full_like(pos, k.shape[1] - 1), kv_lengths)
        return out.detach() + (wrong - wrong.detach())

    def dk_dropped(q, k, v, pos, kv_lengths=None, **kw):
        return attention(q, k.detach() + 0 * k, v, pos, kv_lengths, **kw)  # k's gradient zero

    return {"plain": plain, "output_one_ulp_up": output_one_ulp_up, "noncausal_backward": noncausal_backward,
            "dk_dropped": dk_dropped}[path]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _tensor_rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def check_flash_train(torch, dev, log, nq: int = 32, nkv: int = 8, regime: str = "train") -> dict:
    """K4 at the training shape (b = 4, s = 1,024, ``nq`` / ``nkv`` heads:
    32 / 8 on one device, 16 / 4 on a tensor=2 rank; head_dim 128, causal
    from position 0) through its autograd wrapper against the plain
    attention's autograd: the forward within ``FLASH_TOL``, dq / dk / dv
    equal bit for bit (the wrapper's backward is that autograd,
    recomputed: a plumbing check); the forward timed beside its bound, the
    plain version and SDPA, and forward + backward beside SDPA's."""
    import torch.nn.functional as F

    from generativeaiexamples_tpu_torch.ops import flash_attention as fa

    b, s, hd = TRAIN_BATCH, TRAIN_SEQ, 128
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    nv = copies_for(b * s * (2 * nq + 2 * nkv) * hd * 2)
    qs = [torch.randn(b, s, nq, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    kks = [torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    vvs = [torch.randn(b, s, nkv, hd, device=dev, generator=gen).to(torch.bfloat16) for _ in range(nv)]
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous()
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    g = torch.randn(b, s, nq, hd, device=dev, generator=gen).to(torch.bfloat16)
    q, k, v = (x.clone().requires_grad_() for x in (qs[0], kks[0], vvs[0]))
    out = fa.flash_gqa_attention(q, k, v, pos, lengths)
    if out.grad_fn is None or type(out.grad_fn).__name__ != "FlashAttentionFunctionBackward":
        raise AssertionError(f"train: K4 under grad gave {out.grad_fn!r}, not its autograd wrapper")
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = fa.flash_gqa_attention_plain(q, k, v, pos, lengths)
    want = torch.autograd.grad(ref, (q, k, v), g)
    torch.cuda.synchronize()
    use = tolerance_use(out.detach(), ref.detach(), **FLASH_TOL)
    torch.testing.assert_close(out.detach(), ref.detach(), **FLASH_TOL)
    grad_err = {name: _tensor_rel(a, w) for name, a, w in zip(("dq", "dk", "dv"), got, want)}
    for name, a in zip(("dq", "dk", "dv"), got):
        if not (torch.isfinite(a).all() and a.abs().max() > 0):
            raise AssertionError(f"train: K4's {name} is not finite and non-zero")
    if not all(torch.equal(a, w) for a, w in zip(got, want)):
        raise ToleranceError(f"train: K4's gradients are not the plain autograd's bit for bit: {grad_err}", grad_err)
    err = (out.detach().float() - ref.detach().float()).abs().max().item()
    del out, ref, got, want, q, k, v
    k_ms = time_ms(lambda i: fa.flash_attention_cuda(qs[i], kks[i], vvs[i], pos, lengths), nv, 20, graph=True)
    eager_ms = time_ms(lambda i: fa.flash_attention_cuda(qs[i], kks[i], vvs[i], pos, lengths), nv, 20)
    p_ms = time_ms(lambda i: fa.flash_gqa_attention_plain(qs[i], kks[i], vvs[i], pos, lengths), nv, 3, 1)
    qt, kt, vt = ([x.transpose(1, 2) for x in xs] for xs in (qs, kks, vvs))

    def sdpa(i):
        return F.scaled_dot_product_attention(qt[i], kt[i], vt[i], is_causal=True, enable_gqa=True)

    try:
        lib_ms, lib_timing = time_ms(sdpa, nv, 20, graph=True), "graph"
    except RuntimeError as exc:
        log.append(f"train: SDPA graph capture failed, timed eagerly over 200 calls: {exc}")
        torch.cuda.synchronize()
        lib_ms, lib_timing = time_ms(sdpa, nv, 200), "eager, 200 calls"
    leaves = [[x.clone().requires_grad_() for x in xs] for xs in (qs[:2], kks[:2], vvs[:2])]

    def k4_fwd_bwd(i):
        o = fa.flash_gqa_attention(leaves[0][i % 2], leaves[1][i % 2], leaves[2][i % 2], pos, lengths)
        torch.autograd.grad(o, (leaves[0][i % 2], leaves[1][i % 2], leaves[2][i % 2]), g)

    def sdpa_fwd_bwd(i):
        xs = [leaves[j][i % 2].transpose(1, 2) for j in range(3)]
        o = F.scaled_dot_product_attention(*xs, is_causal=True, enable_gqa=True)
        torch.autograd.grad(o, [leaves[j][i % 2] for j in range(3)], g.transpose(1, 2))

    fwd_bwd_ms = time_ms(k4_fwd_bwd, 2, 5, 1)
    lib_fwd_bwd_ms = time_ms(sdpa_fwd_bwd, 2, 5, 1)
    visible = b * s * (s + 1) // 2 * nq
    nbytes = (b * s * (2 * nq + 2 * nkv) * hd) * 2 + b * s * 4 + b * 4
    b_ms, b_by = bound(nbytes, 4.0 * visible * hd, BF16_FLOPS)
    row = dict(b=b, s=s, t=s, nq=nq, nkv=nkv, hd=hd, ms=k_ms, eager_ms=eager_ms, plain_ms=p_ms, library_ms=lib_ms,
               library_timing=lib_timing, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / k_ms, max_abs_err=err,
               tolerance=FLASH_TOL, tolerance_use=use, grad_err=grad_err,
               grad_check="plumbing: dq / dk / dv equal to the plain attention's autograd bit for bit",
               fwd_bwd_ms=fwd_bwd_ms, library_fwd_bwd_ms=lib_fwd_bwd_ms,
               backward="plain recompute (no backward kernel in the reference)")
    emit("kernel", kernel="flash_attention", regime=regime, **row)
    return row


def _train_flops(cfg, b: int, s: int) -> tuple[float, float]:
    """(model FLOPs of one training step: 6 x matmul params x tokens plus
    the causal attention's, forward and backward; the same with the remat
    recompute's extra forward of every layer)."""
    d, hd, nq, nkv, f = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    layer = d * (nq + 2 * nkv) * hd + nq * hd * d + 3 * d * f
    tokens = b * s
    attn_fwd = 4.0 * b * nq * hd * s * (s + 1) / 2 * cfg.n_layers
    model = 6.0 * (cfg.n_layers * layer + d * cfg.vocab_size) * tokens + 3 * attn_fwd
    return model, model + 2.0 * cfg.n_layers * layer * tokens + attn_fwd


def train_phase(torch, dev, _cuda, smi: str, log) -> dict:
    """Full fine-tuning of Llama-3-8B at full width and ``TRAIN_LAYERS`` of
    32 layers (bf16, remat, AdamW at ``TRAIN_LR``) on one seeded batch of
    4 x 1,024 tokens: K4's wrapper against the plain autograd
    (``check_flash_train``); the first step's loss, grad norm and
    attention projections' gradient norms with K4 against the same step
    with the plain attention swapped in (``TRAIN_STEP_TOL``); every
    gradient finite and the attention projections' non-zero; each of
    ``TRAIN_FAULTS`` planted in the step must fail those gates; then
    ``TRAIN_STEPS`` steps whose loss falls, K4 launched."""
    from generativeaiexamples_tpu_torch.engine import training
    from generativeaiexamples_tpu_torch.models import llama

    t_phase = time.perf_counter()
    k4 = check_flash_train(torch, dev, log)
    cfg = llama.llama3_8b(n_layers=TRAIN_LAYERS)
    opt = training.make_optimizer(TRAIN_LR)
    t0 = time.perf_counter()
    state = training.init_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(TRAIN_SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in training.tree_leaves(state.params))
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": ids[:, :-1], "targets": ids[:, 1:],
             "mask": torch.ones((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.float32, device=dev)}

    def loss(p):
        return training.loss_fn(p, cfg, batch["tokens"], batch["targets"], batch["mask"])

    projections = ("wq", "wk", "wv", "wo")
    readings = {}
    for path in ("k4", "plain") + TRAIN_FAULTS:
        _cuda.reset_launch_counts()
        if path == "k4":
            value, grads = training.value_and_grad(loss, state.params)
        else:
            with _SwapAttention(llama, _train_attention(torch, path)):
                value, grads = training.value_and_grad(loss, state.params)
        torch.cuda.synchronize()
        names = [n for n in grads if n != "layers"] + [f"layers.{n}" for n in grads["layers"]]
        leaves = [grads[n] for n in grads if n != "layers"] + list(grads["layers"].values())
        readings[path] = dict(
            loss=float(value), grad_norm=float(training.global_norm(grads)),
            flash_launches=_cuda.LAUNCHES["flash_attention"],
            not_finite=[n for n, g in zip(names, leaves) if not torch.isfinite(g).all()],
            projection_norms={n: float(grads["layers"][n].float().norm()) for n in projections})
        del value, grads, leaves
        gc.collect()
        torch.cuda.empty_cache()

    def step_gate(r) -> tuple[dict, list]:
        """(each reading's relative distance from the plain step, the gates
        it fails: the non-zero projections or ``TRAIN_STEP_TOL``)."""
        err = {key: _rel(r[key], plain[key]) for key in ("loss", "grad_norm")}
        err["projection_norms"] = max(_rel(r["projection_norms"][n], plain["projection_norms"][n])
                                      for n in projections)
        failed = [key for key in TRAIN_STEP_TOL if err[key] > TRAIN_STEP_TOL[key]]
        if r["not_finite"] or any(not v > 0 for v in r["projection_norms"].values()):
            failed.append("finite_and_non_zero")
        return err, failed

    k4r, plain = readings["k4"], readings["plain"]
    if k4r["flash_launches"] != 2 * cfg.n_layers or plain["flash_launches"] != 0:
        raise AssertionError(f"train: K4 launched {k4r['flash_launches']} times in the K4 step (2 a layer: the "
                             f"forward and the remat recompute) and {plain['flash_launches']} in the plain one")
    step_err, failed = step_gate(k4r)
    if failed:
        raise ToleranceError(f"train: the K4 step against the plain one {step_err}, failing {failed} (tolerance "
                             f"{TRAIN_STEP_TOL}; gradients not finite {k4r['not_finite']}, projections' norms "
                             f"{k4r['projection_norms']})", step_err)
    faults = {}
    for path in TRAIN_FAULTS:
        err, failed = step_gate(readings[path])
        faults[path] = dict(rel_err=err, failed=failed, projection_norms=readings[path]["projection_norms"])
    passed = [path for path, f in faults.items() if not f["failed"]]
    if passed:
        raise AssertionError(f"train: the planted faults {passed} passed the step gate: {faults}")

    step = training.make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
        if not math.isfinite(float(metrics["grad_norm"])):
            raise AssertionError(f"train: step {len(losses)}'s grad norm is {float(metrics['grad_norm'])}")
    launches = dict(_cuda.LAUNCHES)
    if launches["flash_attention"] != 2 * cfg.n_layers * TRAIN_STEPS:
        raise AssertionError(f"train: K4 launched {launches['flash_attention']} times in {TRAIN_STEPS} steps")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    model_flops, hw_flops = _train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    emit("train", nvidia_smi=smi, model=f"llama3-8b width, {TRAIN_LAYERS} of 32 layers, bf16, remat, random from "
         f"seed {TRAIN_SEED}", params=n_params, batch=[TRAIN_BATCH, TRAIN_SEQ], optimizer=f"AdamW lr {TRAIN_LR}",
         init_s=init_s, losses=losses, step_ms=step_s * 1e3, first_step_ms=times[0] * 1e3,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s, peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         model_tflops=model_flops / step_s / 1e12, model_flops_share=model_flops / step_s / BF16_FLOPS,
         hardware_tflops=hw_flops / step_s / 1e12, k4_step=k4r, plain_step=plain, k4_vs_plain=step_err,
         k4_vs_plain_tolerance=TRAIN_STEP_TOL, faults_failed_the_gate=faults, launches=launches, phase_s=time.perf_counter() - t_phase)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(k4=k4, launches=launches)


def lora_phase(torch, dev, _cuda, smi: str) -> dict:
    """LoRA SFT of the full 32-layer Llama-3-8B (bf16, drawn on the card
    from ``LORA_SEED``, frozen): rank 8 on wq wk wv wo, ``LORA_STEPS``
    steps of 4 x 512 (loss on the response tokens).  Gates: the loss falls,
    the base stays bit for bit, ``merge_lora``'s forward equals
    ``apply_lora``'s bit for bit (a plumbing check: the same arithmetic),
    ``save_lora`` then ``load_lora`` is bit for bit, K4 launched twice a
    layer a step."""
    import shutil
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch.engine import lora, training
    from generativeaiexamples_tpu_torch.engine.decode import init_random_params
    from generativeaiexamples_tpu_torch.models import llama

    t_phase = time.perf_counter()
    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    base = init_random_params(cfg, torch.Generator(device=dev).manual_seed(LORA_SEED), dev)
    kept = training.tree_map(lambda t: t.clone(), base)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lcfg = lora.LoRAConfig()
    opt = training.make_optimizer(LORA_LR)
    state = lora.init_lora_train_state(cfg, lcfg, opt, torch.Generator(device=dev).manual_seed(LORA_SEED + 1),
                                       device=dev)
    rng = np.random.default_rng(LORA_SEED)
    pairs = []
    for i in range(LORA_BATCH):
        n_prompt = 192 + 48 * i
        ids = rng.integers(0, cfg.vocab_size, LORA_SEQ + 1)
        pairs.append((ids[:n_prompt].tolist(), ids[n_prompt:].tolist()))
    batch = lora.sft_batch(pairs, max_len=LORA_SEQ)
    step = lora.make_lora_train_step(cfg, lcfg, opt, base)
    torch.cuda.reset_peak_memory_stats(dev)
    _cuda.reset_launch_counts()
    losses, times = [], []
    for _ in range(LORA_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    launches = dict(_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if launches["flash_attention"] != 2 * cfg.n_layers * LORA_STEPS:
        raise AssertionError(f"lora: K4 launched {launches['flash_attention']} times in {LORA_STEPS} steps")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"lora: the loss did not fall over {LORA_STEPS} steps: {losses}")
    changed = [i for i, (a, b) in enumerate(zip(training.tree_leaves(base), training.tree_leaves(kept)))
               if not torch.equal(a, b)]
    if changed or any(t.requires_grad for t in training.tree_leaves(base)):
        raise AssertionError(f"lora: the frozen base changed (leaves {changed})")
    del kept
    # The merged tree's forward against the effective tree's.
    prompt = torch.as_tensor(np.asarray(pairs[0][0][:128]), dtype=torch.int32, device=dev)[None]
    positions = torch.arange(prompt.shape[1], dtype=torch.int32, device=dev)[None]
    with torch.inference_mode():
        merged = lora.merge_lora(base, state.params, lcfg)
        merged_logits = llama.logits(merged, llama.forward(merged, cfg, prompt, positions)[0])
        del merged
        eff = lora.apply_lora(base, state.params, lcfg)
        eff_logits = llama.logits(eff, llama.forward(eff, cfg, prompt, positions)[0])
        del eff
    # A plumbing check: ``merge_lora`` is ``apply_lora``'s arithmetic
    # without a gradient, so the two forwards agree bit for bit.
    if not torch.equal(merged_logits, eff_logits):
        raise AssertionError(f"lora: merge_lora's forward is not apply_lora's bit for bit: "
                             f"{_within(torch, merged_logits, eff_logits, XLA_TOL, 'lora: merge_lora')}")
    root = tempfile.mkdtemp(prefix="lora_")
    try:
        path = os.path.join(root, "adapters.npz")
        lora.save_lora(state.params, path)
        file_bytes = os.path.getsize(path)
        loaded = lora.load_lora(path, device=dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if sorted(loaded) != sorted(state.params) or not all(
            loaded[n][ab].dtype == state.params[n][ab].dtype and torch.equal(loaded[n][ab], state.params[n][ab])
            for n in state.params for ab in ("a", "b")):
        raise AssertionError("lora: save_lora then load_lora is not bit for bit")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    emit("lora", nvidia_smi=smi, base=f"llama3-8b, 32 layers, bf16, drawn on the card from seed {LORA_SEED} (no bf16 "
         "tree of it is resident at this point)", lora=dict(rank=lcfg.rank, alpha=lcfg.alpha, targets=lcfg.targets),
         adapter_params=sum(t.numel() for t in training.tree_leaves(state.params)), batch=[LORA_BATCH, LORA_SEQ],
         optimizer=f"AdamW lr {LORA_LR}", init_s=init_s, losses=losses, step_ms=step_s * 1e3,
         first_step_ms=times[0] * 1e3, tokens_per_s=LORA_BATCH * LORA_SEQ / step_s, peak_device_gb=peak_gb,
         base_unchanged=True, merge_equals_apply_bit_for_bit=True, adapter_file_bytes=file_bytes, launches=launches,
         phase_s=time.perf_counter() - t_phase)
    del base, state, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _to_cpu(torch, tree):
    from generativeaiexamples_tpu_torch.engine.training import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


def _loss_card_vs_cpu(torch, dev, name: str, loss, params, faults: dict) -> dict:
    """One loss and grad norm on the card and on the CPU (the same
    params), held to ``LOSS_TOL[name]``; then the card's under each planted
    fault of ``faults`` (its name: the card's loss under it), each of which
    must fail that gate."""
    from generativeaiexamples_tpu_torch.engine import training

    tol = LOSS_TOL[name]
    readings = {}
    for where, p, d in (("card", params, dev), ("cpu", _to_cpu(torch, params), torch.device("cpu"))):
        t0 = time.perf_counter()
        value, grads = training.value_and_grad(lambda q: loss(q, d), p)
        readings[where] = dict(loss=float(value), grad_norm=float(training.global_norm(grads)),
                               seconds=time.perf_counter() - t0)
        del grads

    def gate(r) -> tuple[dict, list]:
        err = {k: _rel(r[k], readings["cpu"][k]) for k in ("loss", "grad_norm")}
        return err, [k for k in err if err[k] > tol[k]]

    err, failed = gate(readings["card"])
    if failed:
        raise ToleranceError(f"train_losses: {name} card against CPU {err} (tolerance {tol})", err)
    planted = {}
    for fault, fault_loss in faults.items():
        value, grads = training.value_and_grad(fault_loss, params)
        fault_err, fault_failed = gate(dict(loss=float(value), grad_norm=float(training.global_norm(grads))))
        planted[fault] = dict(rel_err=fault_err, failed=fault_failed)
        del grads
    passed = [fault for fault, r in planted.items() if not r["failed"]]
    if passed:
        raise AssertionError(f"train_losses: the planted faults {passed} passed {name}'s gate: {planted}")
    return dict(readings, rel_err=err, tolerance=tol, faults_failed_the_gate=planted)


def _loss_steps(torch, _cuda, name: str, step, state, batch, k4_launches: int) -> dict:
    """``LOSS_STEPS`` steps on the card whose loss must fall; the launch
    counts are zeroed just before them and read just after: K4 exactly
    ``k4_launches`` times, the decode kernels and K1 never."""
    _cuda.reset_launch_counts()
    losses, times = [], []
    for _ in range(LOSS_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    launches = dict(_cuda.LAUNCHES)
    if launches != {**{k: 0 for k in launches}, "flash_attention": k4_launches}:
        raise AssertionError(f"train_losses: {name}'s {LOSS_STEPS} steps launched {launches}, not K4 "
                             f"{k4_launches} times alone")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_losses: {name}'s loss did not fall over {LOSS_STEPS} steps: {losses}")
    return dict(losses=losses, step_ms=sorted(times)[len(times) // 2] * 1e3, first_step_ms=times[0] * 1e3,
                steps_s=sum(times), launches=launches)


class _TF32Products:
    """While entered, ``models.speech``'s f32 products take operands cut to
    TF32's 10 mantissa bits (as cuBLAS reads f32 when a process allows
    TF32): the fault ``ops/f32`` keeps out.  Gradients pass straight
    through the cut."""

    def __enter__(self):
        import types

        import torch

        from generativeaiexamples_tpu_torch.models import speech
        from generativeaiexamples_tpu_torch.ops import f32

        def tf32(x):
            cut = (x.detach().view(torch.int32) & -8192).view(torch.float32)
            return x + (cut - x.detach())

        self.saved = speech.f32
        speech.f32 = types.SimpleNamespace(matmul=lambda a, b: f32.matmul(tf32(a), tf32(b)),
                                           einsum=lambda eq, *ops: f32.einsum(eq, *(tf32(o) for o in ops)),
                                           conv1d=f32.conv1d)
        return self

    def __exit__(self, *exc):
        from generativeaiexamples_tpu_torch.models import speech

        speech.f32 = self.saved


def train_losses_phase(torch, dev, _cuda, smi: str) -> dict:
    """The other trainers: one contrastive step of arctic-embed-l (24
    layers, 8 queries x (1 positive + 3 negatives) x 128 tokens), the VLM's
    caption loss (vlm-base: ViT-B and the Llama-3-8B decoder at
    ``TRAIN_LAYERS`` layers, 2 images, 32 caption tokens) and FastSpeech-S's
    loss (4 utterances): each at 2 layers card against CPU (loss and grad
    norm within ``LOSS_TOL``; the CPU halves on smaller batches: 4 x (1 +
    3) x 64 tokens, one image and 16 caption tokens) with the planted
    faults of ``LOSS_FAULTS`` failing that gate on the card, then
    ``LOSS_STEPS`` AdamW steps on the card whose loss falls.  Returns each
    model's launch counts over its steps alone."""
    import dataclasses

    import numpy as np

    from generativeaiexamples_tpu_torch.engine import training
    from generativeaiexamples_tpu_torch.models import bert, llama, speech, vision

    t_phase = time.perf_counter()
    rng = np.random.default_rng(TRAIN_SEED + 7)
    out = {}

    # Contrastive: queries, each with a positive and 3 hard negatives (the
    # CPU half of the gate on a quarter of the steps' tokens).
    def contrastive_batch(d, b: int, s: int):
        def rows(shape):
            lengths = rng.integers(s // 4, s + 1, shape)
            toks = rng.integers(1000, 30000, shape + (s,)).astype(np.int32)
            return toks * (np.arange(s) < lengths[..., None]), (np.arange(s) < lengths[..., None]).astype(np.int32)

        (qt, qm), (pt, pm) = rows((b,)), rows((b, 4))
        return {k: torch.as_tensor(v, device=d) for k, v in
                (("q_tokens", qt), ("q_mask", qm), ("p_tokens", pt), ("p_mask", pm))}

    gb = contrastive_batch(dev, 4, 64)
    gb_cpu = {k: v.cpu() for k, v in gb.items()}
    # The planted fault: the first positive's padding mask one token short.
    short = gb["p_mask"].clone()
    short[0, 0, int(short[0, 0].sum()) - 1] = 0
    cfg2 = bert.arctic_embed_l(n_layers=2)
    p2 = bert.init_params(cfg2, torch.Generator(device=dev).manual_seed(TRAIN_SEED + 8), dev)
    gate = _loss_card_vs_cpu(
        torch, dev, "contrastive", lambda p, d: training.contrastive_loss_fn(p, cfg2, gb if d.type == "cuda" else gb_cpu),
        p2, {"passage_mask_short_by_one": lambda p: training.contrastive_loss_fn(p, cfg2, {**gb, "p_mask": short})})
    del p2
    cfg = bert.arctic_embed_l()
    opt = training.make_optimizer(1e-4)
    state = training.init_bert_train_state(cfg, opt, generator=torch.Generator(device=dev).manual_seed(TRAIN_SEED + 9),
                                           device=dev)
    out["contrastive"] = dict(model="arctic-embed-l, 24 layers, bf16", batch="8 x (1 + 3) x 128",
                              card_vs_cpu_2_layers=dict(gate, batch="4 x (1 + 3) x 64"),
                              **_loss_steps(torch, _cuda, "contrastive", training.make_contrastive_train_step(cfg, opt),
                                            state, contrastive_batch(dev, 8, 128), 0))
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # The VLM's caption loss.
    def vlm_batch(d, b: int, n: int):
        images = torch.as_tensor(rng.random((b, 224, 224, 3)).astype(np.float32), device=d)
        text = rng.integers(32, 128, (b, n)).astype(np.int32)
        inp = np.concatenate([np.full((b, 1), 1, np.int32), text[:, :-1]], axis=1)
        return [images, torch.as_tensor(inp, device=d), torch.as_tensor(text, device=d),
                torch.ones((b, n), dtype=torch.float32, device=d)]

    def vlm_fault_loss(fault):
        def text_positions_from_zero(params, cfg, tokens, positions, *args, **kw):
            shift = torch.where(positions >= vcfg2.n_prefix, vcfg2.n_prefix, 0).to(positions.dtype)
            return forward(params, cfg, tokens, positions - shift, *args, **kw)

        def fault_loss(p):
            if fault != "text_positions_from_zero":
                with _VisionFault(fault):
                    return vision.vlm_caption_loss(p, vcfg2, *vb)
            llama.forward = text_positions_from_zero
            try:
                return vision.vlm_caption_loss(p, vcfg2, *vb)
            finally:
                llama.forward = forward

        return fault_loss

    forward = llama.forward

    vcfg2 = vision.vlm_base(lm=llama.llama3_8b(n_layers=2))
    vp2 = vision.init_vlm_params(vcfg2, torch.Generator(device=dev).manual_seed(TRAIN_SEED + 10), dev)
    vb = vlm_batch(dev, 1, 16)  # the CPU half of the gate: one image, 16 caption tokens
    vb_cpu = [t.cpu() for t in vb]
    gate = _loss_card_vs_cpu(torch, dev, "vlm_caption", lambda p, d: vision.vlm_caption_loss(
        p, vcfg2, *(vb if d.type == "cuda" else vb_cpu)), vp2, {f: vlm_fault_loss(f) for f in LOSS_FAULTS["vlm_caption"]})
    del vp2
    gc.collect()
    torch.cuda.empty_cache()
    vcfg = vision.vlm_base(lm=llama.llama3_8b(n_layers=TRAIN_LAYERS))
    vparams = vision.init_vlm_params(vcfg, torch.Generator(device=dev).manual_seed(TRAIN_SEED + 11), dev)
    opt = training.make_optimizer(TRAIN_LR)
    vstate = training.TrainState(vparams, opt.init(vparams), 0)

    def vlm_step(st, batch):
        value, grads = training.value_and_grad(lambda p: vision.vlm_caption_loss(p, vcfg, *batch), st.params)
        return training.apply_gradients(st, opt, value, grads)

    # K4 once a decoder layer a step (no remat in the caption loss).
    out["vlm_caption"] = dict(model=f"vlm-base: ViT-B/16, the Llama-3-8B decoder at {TRAIN_LAYERS} of 32 layers, bf16",
                              card_vs_cpu_2_layers=dict(gate, batch="1 image, 16 caption tokens"),
                              **_loss_steps(torch, _cuda, "vlm_caption", vlm_step, vstate, vlm_batch(dev, 2, 32),
                                            LOSS_STEPS * TRAIN_LAYERS))
    del vstate, vparams
    gc.collect()
    torch.cuda.empty_cache()

    # FastSpeech-S's loss: teacher-forced durations, log-mel-like targets.
    tcfg = speech.fastspeech_s()
    texts = ("the quick brown fox jumps over the lazy dog", "streaming radio transcripts",
             "retrieval augmented generation", "training on one card")
    ids = np.zeros((4, 48), np.int32)
    for i, text in enumerate(texts):
        row = speech.text_to_ids(text)[:48]
        ids[i, : len(row)] = row
    durs = (rng.integers(2, 7, ids.shape) * (ids != 0)).astype(np.float32)
    mel = rng.normal(size=(4, tcfg.max_frames, tcfg.n_mels)).astype(np.float32)
    tcfg2 = dataclasses.replace(tcfg, n_layers=2)
    tp2 = speech.tts_init_params(tcfg2, torch.Generator(device=dev).manual_seed(TRAIN_SEED + 12), dev)

    def tts_tf32_loss(p):
        with _TF32Products():
            return speech.tts_loss(p, tcfg2, ids, mel, durs)

    gate = _loss_card_vs_cpu(torch, dev, "tts", lambda p, d: speech.tts_loss(p, tcfg2, ids, mel, durs), tp2,
                             {"tf32_products": tts_tf32_loss})
    opt = training.make_optimizer(1e-4)
    tparams = speech.tts_init_params(tcfg, torch.Generator(device=dev).manual_seed(TRAIN_SEED + 13), dev)
    tstate = training.TrainState(tparams, opt.init(tparams), 0)

    def tts_step(st, batch):
        value, grads = training.value_and_grad(lambda p: speech.tts_loss(p, tcfg, *batch), st.params)
        return training.apply_gradients(st, opt, value, grads)

    out["tts"] = dict(model="fastspeech-s, f32 (f64 products on the card)", card_vs_cpu_2_layers=gate,
                      **_loss_steps(torch, _cuda, "tts", tts_step, tstate, (ids, mel, durs), 0))
    emit("train_losses", nvidia_smi=smi, **out, phase_s=time.perf_counter() - t_phase)
    del tstate, tparams
    gc.collect()
    torch.cuda.empty_cache()
    return {name: out[name]["launches"] for name in ("contrastive", "vlm_caption", "tts")}


def fm_test_audio(np, seed: int, fs: int = STREAM_FS_SOURCE, seconds: float = STREAM_SECONDS):
    """``seconds`` of seeded broadcast audio at ``fs``: a 1 kHz test tone
    (1 s), then voiced bursts (``speech_wave``'s signal at ``fs``), each
    followed by 0.8 s of near-silence so the ASR endpointer closes it."""
    rng = np.random.default_rng(seed)

    def voiced(sec):
        t = np.arange(int(sec * fs)) / fs
        f0 = 120 + 40 * np.sin(2 * np.pi * 1.5 * t)
        wave = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / fs) / k for k in range(1, 6))
        return 0.3 * wave * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t) ** 2) + 0.02 * rng.normal(size=t.shape)

    def quiet(sec):
        return 1e-4 * rng.normal(size=int(sec * fs))

    tone = 0.5 * np.sin(2 * np.pi * STREAM_TONE_HZ * np.arange(fs) / fs)
    parts = [tone, quiet(0.8), voiced(2.2), quiet(0.8), voiced(2.2), quiet(0.8), voiced(1.4), quiet(0.8)]
    return np.concatenate(parts)[: int(seconds * fs)].astype(np.float32)


def _sse_chunks(raw: bytes) -> list:
    return [json.loads(line[6:]) for line in raw.decode().splitlines() if line.startswith("data: ")]


def streaming_phase(torch, dev, _cuda, smi: str) -> dict:
    """The streaming pipeline (the upstream's fm-asr-streaming-rag): 10 s of
    seeded audio FM-modulated at 250 kHz (``replay.fm_modulate``), through
    ``FMReceiverChain`` on the card in 65,536-sample blocks against the same
    chain on the CPU (PCM within 1 LSB; the test tone recovered; the card's
    real-time factor); then UDP end to end: ``replay_iq`` -> ``UDPSource``
    -> the chain -> ``ASRSink`` (Conformer-S, seeded, on the card) -> the
    port's streaming server -> ``TextAccumulator`` -> ``StreamingChains``
    on arctic-embed-l and a ``GPUVectorStore`` on the card.  Gates: every
    block arrives, the finals reach the server and are stored with their
    timestamps in both stores, and ``/generate`` streams an SSE answer."""
    import numpy as np

    from generativeaiexamples_tpu_torch.chains.llm import EchoChatLLM
    from generativeaiexamples_tpu_torch.engine.embedder import GPUEmbedder
    from generativeaiexamples_tpu_torch.models import bert, speech
    from generativeaiexamples_tpu_torch.retrieval.gpu import GPUVectorStore
    from generativeaiexamples_tpu_torch.streaming import dsp
    from generativeaiexamples_tpu_torch.streaming.asr import ASRSink
    from generativeaiexamples_tpu_torch.streaming.chains import StreamingChains
    from generativeaiexamples_tpu_torch.streaming.graph import Operator, Pipeline, UDPSource
    from generativeaiexamples_tpu_torch.streaming.replay import fm_modulate, replay_iq
    from generativeaiexamples_tpu_torch.streaming.server import create_streaming_app
    from generativeaiexamples_tpu_torch.streaming.timestamps import TimestampDatabase

    t_phase = time.perf_counter()
    cfg = dsp.FMReceiverConfig()
    iq = fm_modulate(fm_test_audio(np, TRAIN_SEED + 20), STREAM_FS_SOURCE, cfg.fs_baseband)
    blocks = [iq[i : i + STREAM_BLOCK] for i in range(0, len(iq) - STREAM_BLOCK + 1, STREAM_BLOCK)]
    card, host = dsp.FMReceiverChain(cfg, device=dev), dsp.FMReceiverChain(cfg, device="cpu")
    card(blocks[0])  # warm-up, then a fresh chain is timed
    card = dsp.FMReceiverChain(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcm_card = np.concatenate([card(b) for b in blocks])
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pcm_host = np.concatenate([host(b) for b in blocks])
    host_s = time.perf_counter() - t0
    lsb = int(np.abs(pcm_card.astype(np.int32) - pcm_host.astype(np.int32)).max())
    audio_s = len(blocks) * STREAM_BLOCK / cfg.fs_baseband
    tone = pcm_card[1600 : cfg.fs_audio - 1600].astype(np.float32)
    peak_hz = float(np.fft.rfftfreq(len(tone), 1 / cfg.fs_audio)[np.abs(np.fft.rfft(tone)).argmax()])
    if lsb > 1 or abs(peak_hz - STREAM_TONE_HZ) > 20:
        raise AssertionError(f"streaming: card PCM {lsb} LSB from the CPU chain's, tone at {peak_hz} Hz")
    receiver = dict(blocks=len(blocks), samples=len(iq), audio_s=audio_s, pcm_samples=len(pcm_card),
                    max_lsb_vs_cpu=lsb, tone_hz=peak_hz, card_s=card_s, cpu_s=host_s,
                    real_time_factor=card_s / audio_s, cpu_real_time_factor=host_s / audio_s)

    # UDP end to end into the streaming server.
    embedder = GPUEmbedder(bert.arctic_embed_l(), device=dev)
    store = GPUVectorStore(embedder.cfg.d_model, device=dev)
    chains = StreamingChains(EchoChatLLM(), embedder, store, TimestampDatabase())
    server = create_streaming_app(chains)
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    partials = []
    sink = ASRSink(asr_cfg=speech.conformer_s(), seed=TRAIN_SEED + 21, device=dev, server_url=base, source="fm",
                   on_partial=partials.append)
    fed = []

    def asr(pcm):
        sink(pcm)
        fed.append(len(pcm))

    pipeline = Pipeline([Operator("fm-rx", dsp.FMReceiverChain(cfg, device=dev)), Operator("asr", asr)])
    pipeline.start()
    src = UDPSource(pipeline, host="127.0.0.1", port=0, block_samples=STREAM_BLOCK)
    src.start()
    try:
        t0 = time.perf_counter()
        # Paced at STREAM_SPEED x real time: UDP drops what the socket's
        # buffer cannot hold, so the blocks that arrived are counted, not
        # assumed.
        sent = replay_iq(iq, "127.0.0.1", src.port, cfg.fs_baseband, speed=STREAM_SPEED)
        seen = [len(fed), time.perf_counter()]

        def drained():
            if len(fed) != seen[0]:
                seen[:] = [len(fed), time.perf_counter()]
            return len(fed) >= len(blocks) or time.perf_counter() - seen[1] > 2.0

        _wait_for(drained, 120, "streaming: the pipeline to drain")
        pipeline_s = time.perf_counter() - t0
    finally:
        src.stop()
        pipeline.stop()
    sink.flush()
    status, _, raw = _http("POST", base + "/flush", {"source": "fm"})
    flushed = json.loads(raw)["chunks_flushed"]
    rows = chains.db.all_chunks()
    finals = [t for t in sink.finals if t.strip()]
    try:
        if status != 200 or not finals or not rows or len(rows) != len(store):
            raise AssertionError(f"streaming: {len(finals)} finals, {len(rows)} rows in the timestamp database, "
                                 f"{len(store)} in the vector store")
        joined = " ".join(t.strip() for t in finals)
        if not all(r["text"].strip() in joined for r in rows):
            raise AssertionError("streaming: a stored chunk is not the finals' text")
        for r in rows:
            hit = store.search(embedder.embed_query(r["text"]), 1)[0]
            meta = hit.chunk.metadata
            if hit.chunk.text != r["text"] or (meta["t_first"], meta["t_last"]) != (r["t_first"], r["t_last"]) \
                    or not r["t_first"] <= r["t_last"]:
                raise AssertionError(f"streaming: chunk {r['text'][:40]!r} not stored alike in both stores")
        t0 = time.perf_counter()
        status, _, raw = _http("POST", base + "/generate", {
            "messages": [{"role": "user", "content": STREAM_QUESTION}], "use_knowledge_base": True, "max_tokens": 32})
        generate_ms = (time.perf_counter() - t0) * 1e3
        chunks = _sse_chunks(raw)
        answer = "".join(c["choices"][0]["message"]["content"] for c in chunks[:-1])
        if status != 200 or len(chunks) < 2 or chunks[-1]["choices"][0]["finish_reason"] != "[DONE]" or not answer:
            raise AssertionError(f"streaming: /generate gave {status} {raw[:200]!r}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    emit("streaming", nvidia_smi=smi, receiver=receiver, packets=sent, speed=STREAM_SPEED, blocks_sent=len(blocks),
         blocks_received=len(fed), pipeline_s=pipeline_s,
         asr="conformer-s, random f32 on the card, seed " + str(TRAIN_SEED + 21), finals=len(sink.finals),
         nonempty_finals=len(finals), partials=len(partials), stored_chunks=len(rows), flushed_at_end=flushed,
         llm="echo (the chain phase's LLM is freed before this phase)", embedder="arctic-embed-l, random bf16",
         generate_ms=generate_ms, answer_chunks=len(chunks) - 1, phase_s=time.perf_counter() - t_phase)
    del embedder, store, chains, sink, card
    gc.collect()
    torch.cuda.empty_cache()
    return dict(receiver=receiver)


# ---------------------------------------------------------------------------
# serving over a device mesh: two ranks on one card
# ---------------------------------------------------------------------------

# ``mesh_serve``: Llama-3-8B at full width and 8 of its 32 layers, random
# weight-only int8 weights from this seed (an int8 cache), served as
# MeshSpec(tensor=2) on [cuda:0, cuda:0] and by a single-device scheduler on
# the same draw.
MESH_LAYERS, MESH_SEED = 8, 0
# A mesh collective, or a rank's answer, that takes longer raises.
MESH_TIMEOUT_S = 120.0
# ``mesh_seq``: one attention layer at Llama-3-8B's heads over this prompt.
MESH_SEQ_LEN = 8192
# ``mesh_moe``: Mixtral-8x7B's width at this depth over MeshSpec(expert=2).
MESH_MOE_LAYERS = 2
# The two-rank forward against the single-device one on the same weights
# (f32 readings of bf16 values).  wo's and w_down's partial products are
# summed in f32 and rounded once, as one device's are, but every sharded
# product is a cuBLAS call of another shape (half the columns or rows), so
# its f32 sums run in another order and an element may round one bf16 ulp
# apart; random weights carry such ulps through 8 layers and the head.
# Measured on an H100 (PERF.md): sound, the probe's hidden states
# 1.17% RMS and 1.65% of the largest at most, its logits 0.074 apart at
# most, and 0.1085 over every served stream teacher-forced (288 steps); the
# subtlest planted fault (MESH_PROBE_FAULTS: wo's psum dropped in the last
# of 8 layers) 3.38% RMS, 4.12% and 0.208; a swapped KV-head shard 128% RMS.
# Each limit sits between the sound reading and that fault's.
MESH_HIDDEN_TOL = dict(rel_rms=0.02, max_abs_frac=0.026)
# The logits' largest difference allowed; a greedy stream may part from the
# single-device one only where the single device's top-2 gap is below
# twice this (each side within it of the other).
MESH_LOGIT_TOL = 0.15
# ``mesh_moe``'s hidden states against the single-device forward: bit for
# bit.  Each expert's products run on the same fixed row blocks on a rank
# as on one device (the same cuBLAS calls), and a token's combine is a sum
# of its two experts' f32 terms: one rank adds both, or each rank holds one
# and the psum adds them, the same two terms either way (measured bit for
# bit on an H100; a planted missing expert reads 66% RMS, PERF.md).
MESH_MOE_TOL = dict(rel_rms=0.0, max_abs_frac=0.0)


def _rel_err(torch, got, ref) -> dict:
    err = (got.float() - ref.float())
    rms = ref.float().square().mean().sqrt().item()
    return {"max_abs_err": err.abs().max().item(), "rel_rms": err.square().mean().sqrt().item() / max(rms, 1e-30),
            "max_abs_frac": err.abs().max().item() / max(ref.float().abs().max().item(), 1e-30)}


def _rel_within(err: dict, tol: dict) -> bool:
    return err["rel_rms"] <= tol["rel_rms"] and err["max_abs_frac"] <= tol["max_abs_frac"]


def _rank_reset(ctx) -> None:
    """Zero this rank's kernel launch counts and collective counts."""
    from generativeaiexamples_tpu_torch.ops import _cuda
    from generativeaiexamples_tpu_torch.parallel.comm import reset_comm_stats

    _cuda.reset_launch_counts()
    reset_comm_stats()


def _rank_counts(ctx) -> dict:
    """This rank's launches per kernel, collectives and device memory."""
    import torch

    from generativeaiexamples_tpu_torch.ops import _cuda
    from generativeaiexamples_tpu_torch.parallel.comm import COMM_STATS

    torch.cuda.synchronize()
    return {"rank": ctx.rank, "launches": dict(_cuda.LAUNCHES), "flash_hd": dict(_cuda.FLASH_HD_LAUNCHES),
            "comm": {k: COMM_STATS[k] for k in ("collectives", "staged_bytes", "payload_bytes", "ms")},
            "by_op": dict(COMM_STATS["by_op"]), "device_gb": torch.cuda.memory_allocated() / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def probe_forward(torch, params, cfg, prompt, follow, mesh=None):
    """f32 hidden states and logits of a cold prefill of ``prompt`` (the
    last position) and of decode steps feeding ``follow`` one at a time
    through the append buffer, as the decode chunk runs them (K4, then K2
    on the int8 cache).  ``mesh`` (a rank's context) runs one rank's share;
    every rank then holds the whole logits."""
    from generativeaiexamples_tpu_torch.engine.decode import _append_buffer
    from generativeaiexamples_tpu_torch.models import llama

    dev = params["final_norm"].device
    lc = llama.local_config(cfg, mesh)
    s = len(prompt)
    cache = llama.init_kv_cache(lc, 1, s + len(follow) + 8, device=dev)
    hidden, _ = llama.forward(params, cfg, torch.tensor([list(prompt)], device=dev),
                              torch.arange(s, dtype=torch.int32, device=dev)[None], cache,
                              torch.tensor([s], dtype=torch.int32, device=dev), cold_prefill=True, mesh=mesh)
    hs, lgs = [hidden[0, -1]], [llama.logits(params, hidden[:, -1:], mesh)[0, 0]]
    ab = _append_buffer(lc, 1, len(follow), dev)
    lengths0 = torch.tensor([s], dtype=torch.int32, device=dev)
    for i, tok in enumerate(follow):
        hidden, _, ab = llama.forward(params, cfg, torch.tensor([[tok]], device=dev),
                                      torch.tensor([[s + i]], dtype=torch.int32, device=dev), cache, lengths0,
                                      append_cache=(ab, i), mesh=mesh)
        hs.append(hidden[0, 0])
        lgs.append(llama.logits(params, hidden, mesh)[0, 0])
    return torch.stack(hs).float(), torch.stack(lgs).float()


def _rank_teacher_forced(ctx, key, prompt, stream):
    """``teacher_forced_logits`` on this rank's share of a mesh scheduler's
    engine."""
    import torch

    eng = ctx.state[key]
    return teacher_forced_logits(torch, eng.cfg, eng.params, prompt, stream, mesh=ctx)


# Planted faults that the probe's gates must fail, each run on the card
# beside the sound probe: ``psum`` drops the last layer's wo psum (each rank
# keeps its own partial product), ``kv_shard`` swaps rank 1's first two
# local KV heads in wk and wv of every layer (a misplaced shard).
MESH_PROBE_FAULTS = ("psum", "kv_shard")


class _NoSum:
    """A stand-in rank context whose psum is this rank's value alone."""

    @staticmethod
    def psum(x, axis):
        return x


def _swap_first_heads(torch, w, hd: int):
    """``w`` (a projection, heads on its last axis) with its first two
    heads' columns swapped."""
    idx = torch.arange(w.shape[-1], device=(w.q if hasattr(w, "q") else w).device)
    idx[:hd], idx[hd : 2 * hd] = idx[hd : 2 * hd].clone(), idx[:hd].clone()
    if hasattr(w, "q"):
        return type(w)(q=w.q[..., idx].contiguous(), scale=w.scale[..., idx].contiguous())
    return w[..., idx].contiguous()


def _rank_probe(ctx, key, prompt, follow, fault=None):
    """``probe_forward`` on this rank's share of a mesh scheduler's engine,
    sound or with one of MESH_PROBE_FAULTS planted."""
    import torch

    from generativeaiexamples_tpu_torch.models import llama

    eng = ctx.state[key]
    params = eng.params
    if fault == "kv_shard" and ctx.rank == 1:
        layers = params["layers"]
        params = {**params, "layers": {**layers, **{n: _swap_first_heads(torch, layers[n], eng.cfg.head_dim)
                                                    for n in ("wk", "wv")}}}
    real = llama.row_parallel_dot
    if fault == "psum":
        calls = [0]

        def row_parallel_dot(x, w, name, mesh, axis="tensor"):
            if name == "wo":
                calls[0] += 1
                if calls[0] % eng.cfg.n_layers == 0:  # the last layer's
                    return real(x, w, name, _NoSum, axis)
            return real(x, w, name, mesh, axis)

        llama.row_parallel_dot = row_parallel_dot
    try:
        return probe_forward(torch, params, eng.cfg, prompt, follow, ctx)
    finally:
        llama.row_parallel_dot = real


def _rank_seq(ctx, strategy: str, seed: int, reps: int):
    """One attention layer at Llama-3-8B's heads over MESH_SEQ_LEN tokens
    (q/k/v drawn alike on every rank from ``seed``), sequence-parallel;
    rank 0's whole output and the median ms of ``reps`` runs."""
    import torch

    from generativeaiexamples_tpu_torch.parallel.ring_attention import sequence_parallel_attention

    q, k, v, pos = _seq_inputs(torch, ctx.device, seed)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sequence_parallel_attention(q, k, v, pos, None, mesh=ctx, strategy=strategy)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, sorted(times)[len(times) // 2]


def _rank_ulysses_k4(ctx, seed: int, tokens: int) -> dict:
    """Ulysses over ``tokens`` tokens with this rank's K4 call recorded
    (its 16 / 4 local heads over the whole sequence): that call's output
    against the plain attention on the same inputs (query rows in blocks of
    1,024), within FLASH_TOL."""
    import torch

    from generativeaiexamples_tpu_torch.ops import attention as attention_mod
    from generativeaiexamples_tpu_torch.ops.flash_attention import flash_gqa_attention_plain
    from generativeaiexamples_tpu_torch.parallel.ring_attention import sequence_parallel_attention

    calls, inner = [], attention_mod.attention

    def recording(q, k, v, pos, kv_lengths=None, **kw):
        out = inner(q, k, v, pos, kv_lengths, **kw)
        calls.append((q, k, v, pos, kv_lengths, out))
        return out

    q, k, v, pos = _seq_inputs(torch, ctx.device, seed, tokens)
    attention_mod.attention = recording
    try:
        sequence_parallel_attention(q, k, v, pos, None, mesh=ctx, strategy="ulysses")
    finally:
        attention_mod.attention = inner
    del q, k, v, pos
    (q, k, v, pos, lengths, out), = calls
    worst, within = 0.0, True
    for i in range(0, q.shape[1], 1024):
        ref = flash_gqa_attention_plain(q[:, i : i + 1024], k, v, pos[:, i : i + 1024], lengths).float()
        got = out[:, i : i + 1024].float()
        err = (got - ref).abs()
        worst = max(worst, err.max().item())
        within &= bool((err <= FLASH_TOL["atol"] + FLASH_TOL["rtol"] * ref.abs()).all())
    return {"rank": ctx.rank, "shape": f"b=1 s={q.shape[1]} n_q={q.shape[2]} n_kv={k.shape[2]} hd={q.shape[3]}",
            "max_abs_err": worst, "within": within}


def _seq_inputs(torch, dev, seed: int, tokens: int = MESH_SEQ_LEN):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape_q, shape_kv = (1, tokens, 32, 128), (1, tokens, 8, 128)
    q, k, v = (torch.randn(s, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)
               for s in (shape_q, shape_kv, shape_kv))
    pos = torch.arange(tokens, dtype=torch.int32, device=dev)[None]
    return q, k, v, pos


def _rank_moe(ctx, cfg, seed: int, tokens):
    """Mixtral's width over the ``expert`` axis: this rank's shard of the
    seeded float tree (every rank draws the whole tree alike, then slices),
    a cacheless forward; rank 0's f32 hidden states, sound and with rank
    1's first expert planted missing."""
    import torch

    from generativeaiexamples_tpu_torch.engine.decode import prepare_params
    from generativeaiexamples_tpu_torch.models import llama

    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    params = prepare_params(cfg, None, device=ctx.device, generator=gen, mesh=ctx)
    t = torch.tensor(tokens, device=ctx.device)
    pos = torch.arange(t.shape[1], dtype=torch.int32, device=ctx.device).expand(t.shape)
    hidden, _ = llama.forward(params, cfg, t, pos, mesh=ctx)
    out = hidden.float()
    # Planted: rank 1's first expert missing (its down projection zero).
    if ctx.rank == 1:
        w = params["layers"]["w_down_e"]
        params = {**params, "layers": {**params["layers"], "w_down_e": torch.cat([torch.zeros_like(w[:, :1]),
                                                                                    w[:, 1:]], 1)}}
    faulted, _ = llama.forward(params, cfg, t, pos, mesh=ctx)
    del params
    torch.cuda.empty_cache()
    return out, faulted.float()


# ``mesh_train``: Llama-3-8B width at MESH_TRAIN_LAYERS of 32 layers, bf16,
# remat, AdamW; one step on one device, then one on each mesh of two ranks
# on this card, from the same draw.  The learning rate sits far above a
# bf16 parameter's ulp (1.2e-4 at 0.02), so a step's update is its
# gradient's sign (Adam's first step), and rounding moves an updated leaf
# by at most an ulp: an element is counted as moved apart from the single
# device's when it differs by more than STEP_ATOL (0.1 x lr, the rule of
# ``tests/test_torch_training.py``), i.e. its update took the other sign.
MESH_TRAIN_SEED, MESH_TRAIN_LAYERS = 51, 8
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_LR, MESH_TRAIN_MICRO = 4, 1024, 1e-2, 4
# tensor=2 first: its cheap steps take the followers' first-training-step
# cost (~8-10 s on an H100, PERF.md).
MESH_TRAIN_SPECS = (("tensor", dict(tensor=2)), ("fsdp", dict(fsdp=2)), ("pipe", dict(pipe=2)))
# The mesh step against the single device's: the loss and the grad norm
# (relative), and the share of each updated leaf's elements moved apart
# (the largest over leaves).  Each limit sits between the sound and the
# planted readings measured on an H100 (PERF.md): sound loss 0 to
# 7.2e-6, grad norm 2.5e-6 to 5.1e-5, moved 0.12% to 2.17% (tensor=2's
# lm_head: the vocabulary-sharded softmax rounds otherwise, and a head
# column of a token absent from the batch has a gradient near zero);
# planted grad norm 5.1e-5 (the norms' fsdp sum) to 13.1%, moved 8.7% to
# 26.1%.
MESH_TRAIN_TOL = dict(loss=1e-4, grad_norm=1e-3, moved=0.04)
# Planted in each mesh's step (``_rank_plant``), each must fail the gates:
# the norms' gradient sum over fsdp dropped (each rank keeps its rows'
# share), the f op's backward sum over tensor dropped before wq / wk / wv,
# the pipeline's last microbatch's gradient hand-off zeroed.
MESH_TRAIN_FAULTS = {"fsdp": "norm_grad_sum", "tensor": "qkv_f_sum", "pipe": "last_microbatch_handoff"}
# K4's launches a rank in the sound step: each layer's forward and its
# remat recompute in the backward, so 2 x layers on tensor and fsdp, and
# 2 x (layers / 2 stages) x MESH_TRAIN_MICRO microbatches on pipe.
MESH_TRAIN_K4 = {"tensor": 2 * MESH_TRAIN_LAYERS, "fsdp": 2 * MESH_TRAIN_LAYERS,
                 "pipe": 2 * (MESH_TRAIN_LAYERS // 2) * MESH_TRAIN_MICRO}
# ``mesh_train_moe``: Mixtral width, 1 layer, expert=2, capacity-factor
# dispatch; the loss (with the aux loss) and the grad norm against one
# device's, bit for bit: every sound reading on an H100 was exactly the
# one device's (PERF.md).  Planted, each must fail: the aux loss averaged
# per rank over its own experts, and the f op's gradient sum over
# ``expert`` dropped (on the dispatched rows and the combine weights).
MESH_MOE_TRAIN_BATCH, MESH_MOE_TRAIN_LAYERS = 2, 1
MESH_MOE_TRAIN_TOL = dict(loss=0.0, grad_norm=0.0)
MESH_MOE_TRAIN_FAULTS = ("aux_per_rank", "expert_f_sum")


class _GatherNoSum:
    """A planted fault: fsdp gathers whose gradient is this rank's slice of
    its own gradient (the sum over fsdp dropped)."""

    @staticmethod
    def make(torch):
        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, group, dim):
                ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
                return group.all_gather(x.contiguous(), dim)

            @staticmethod
            def backward(ctx, g):
                return g.narrow(ctx.dim, ctx.group.index * ctx.n, ctx.n), None, None

        return Fn


class _ZeroGradient:
    """A planted fault: identity forward, zero gradient (a hand-off whose
    gradient is lost)."""

    @staticmethod
    def make(torch):
        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.clone()

            @staticmethod
            def backward(ctx, g):
                return torch.zeros_like(g)

        return Fn


_PLANTED: list = []


def _rank_plant(ctx, fault=None) -> None:
    """Plant ``fault`` in this rank's process (None: restore every seam).
    Each fault wraps one of the rank context's collectives (an instance
    attribute over the method, deleted again on restore) or one model
    function, as the fault names:

    * ``norm_grad_sum``: the fsdp gathers of the norm gains (the only 1-D
      leaves of a Llama layer) lose their gradient's sum over ``fsdp``;
    * ``qkv_f_sum``: the f op over ``tensor`` on q/k/v's input (the output
      of ``block_norm(..., "attn_norm")``, tagged) is the identity both
      ways;
    * ``last_microbatch_handoff``: stage 0's hand-off of the last
      microbatch (its ``MESH_TRAIN_MICRO``-th ``ppermute`` over ``pipe``)
      passes no gradient back;
    * ``aux_per_rank``: the MoE's aux term counts only this rank's experts
      and is averaged over the ``expert`` axis;
    * ``expert_f_sum``: the f op over ``expert`` (on the dispatched rows
      and the combine weights) is the identity both ways."""
    import torch

    from generativeaiexamples_tpu_torch.models import llama

    while _PLANTED:
        undo = _PLANTED.pop()
        undo()
    if fault is None:
        return

    def wrap_ctx(name, fn):
        real = getattr(ctx, name)
        setattr(ctx, name, lambda *a, **k: fn(real, *a, **k))
        _PLANTED.append(lambda: delattr(ctx, name))

    def patch(mod, name, fn):
        real = getattr(mod, name)
        setattr(mod, name, fn)
        _PLANTED.append(lambda: setattr(mod, name, real))

    if fault == "norm_grad_sum":
        nosum = _GatherNoSum.make(torch)

        def all_gather(real, x, axis, dim=0):
            if axis == "fsdp" and x.dim() == 1:
                return nosum.apply(x, ctx.groups["fsdp"], dim)
            return real(x, axis, dim)

        wrap_ctx("all_gather", all_gather)
    elif fault == "qkv_f_sum":
        real_norm = llama.block_norm

        def block_norm(x, cfg, lp, name):
            y = real_norm(x, cfg, lp, name)
            y.planted_qkv_input = name == "attn_norm"
            return y

        patch(llama, "block_norm", block_norm)
        wrap_ctx("copy_to", lambda real, x, axis: x if getattr(x, "planted_qkv_input", False) else real(x, axis))
    elif fault == "last_microbatch_handoff":
        zero, ticks = _ZeroGradient.make(torch), [0]

        def ppermute(real, x, axis, perm):
            if axis == "pipe":
                if ctx.index("pipe") == 0 and ticks[0] == MESH_TRAIN_MICRO - 1:
                    x = zero.apply(x)
                ticks[0] += 1
            return real(x, axis, perm)

        wrap_ctx("ppermute", ppermute)
    elif fault == "aux_per_rank":
        def moe_aux_terms(frac, mean_prob, n_experts):
            ep = ctx.size("expert")
            e0 = ctx.index("expert") * (n_experts // ep)
            own = slice(e0, e0 + n_experts // ep)
            return ctx.psum(n_experts * (frac[:, own] * mean_prob[:, own]).sum(-1), "expert") / ep

        patch(llama, "moe_aux_terms", moe_aux_terms)
    elif fault == "expert_f_sum":
        wrap_ctx("copy_to", lambda real, x, axis: x if axis == "expert" else real(x, axis))
    else:
        raise ValueError(f"unknown planted fault {fault!r}")


def _rank_peak_reset(ctx) -> None:
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _rank_rss(ctx) -> dict:
    """This rank's host resident set (GB) and checkpoint byte counts."""
    from generativeaiexamples_tpu_torch.engine import weights

    with open("/proc/self/status") as fh:
        rss = next(int(line.split()[1]) for line in fh if line.startswith("VmRSS:"))
    return {"rank": ctx.rank, "rss_gb": rss * 1024 / 1e9, **weights.CHECKPOINT_STATS}


def _train_batch(torch, dev, cfg, b: int, s: int, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen, device=dev, dtype=torch.int32)
    return {"tokens": ids[:, :-1].cpu().numpy(), "targets": ids[:, 1:].cpu().numpy(),
            "mask": torch.ones((b, s), dtype=torch.float32).numpy()}


def _rank_moved(ctx, key, want: dict) -> dict:
    """Against ``want`` (the single device's updated leaves, whole, on the
    card: the runtime's pipe hands a follower CUDA tensors by IPC, so
    nothing is copied), each local leaf's count of elements more than
    STEP_ATOL (0.1 x lr) apart, its size and its largest difference."""
    import torch

    from generativeaiexamples_tpu_torch.utils.trees import flatten
    from generativeaiexamples_tpu_torch.parallel.mesh import shard_slices

    st = ctx.state[key]
    spec_of = dict(flatten(st.specs))
    out = {}
    for p, a in flatten(st.params):
        w = want[p][shard_slices(tuple(want[p].shape), spec_of[p], ctx.sizes, ctx.coords)]
        d = (a.float() - w.float()).abs()
        out[p] = (int((d > 0.1 * MESH_TRAIN_LR).sum()), d.numel(), float(d.max()))
    torch.cuda.synchronize()
    return out


def _moved_apart(mesh, key, want: dict) -> dict:
    """Each leaf's share of elements more than STEP_ATOL from the single
    device's updated leaf, and its largest difference, counted on the
    ranks (a replicated leaf counts alike on each of its ranks)."""
    counts = mesh.run(_rank_moved, key, want, gather=True)
    return {p: (sum(c[p][0] for c in counts) / sum(c[p][1] for c in counts), max(c[p][2] for c in counts))
            for p in counts[0]}


def _train_gate(reading: dict, ref: dict, tol: dict) -> tuple[dict, list]:
    err = {k: _rel(reading[k], ref[k]) for k in ("loss", "grad_norm")}
    if "moved" in reading:
        err["moved"] = max(v[0] for v in reading["moved"].values())
    return err, [k for k in tol if k in err and err[k] > tol[k]]


def mesh_train_phase(torch, dev, smi, runtime) -> dict:
    """``mesh_train``: one single-device step, then a sound step and a
    planted one on each of MESH_TRAIN_SPECS; gates on loss, grad norm and
    the updated leaves (``MESH_TRAIN_TOL``), K4 exactly ``MESH_TRAIN_K4``
    times a rank.  Returns each mesh's launches per rank."""
    from generativeaiexamples_tpu_torch.engine import training
    from generativeaiexamples_tpu_torch.utils.trees import flatten
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec, fsdp_rules
    from generativeaiexamples_tpu_torch.parallel.pipeline import make_pipeline_train_step, pipeline_rules

    t_phase = time.perf_counter()
    cfg = llama.llama3_8b(n_layers=MESH_TRAIN_LAYERS)
    opt = training.make_optimizer(MESH_TRAIN_LR)
    batch = _train_batch(torch, dev, cfg, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_SEED + 1)
    tokens = MESH_TRAIN_BATCH * MESH_TRAIN_SEQ

    def generator():
        return torch.Generator(device=dev).manual_seed(MESH_TRAIN_SEED)

    state = training.init_train_state(cfg, opt, generator(), device=dev)
    step = training.make_train_step(cfg, opt)
    dev_batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, m = step(state, dev_batch)
    single = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    torch.cuda.synchronize()
    single.update(step_ms=(time.perf_counter() - t0) * 1e3, peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    single["tokens_per_s"] = tokens / single["step_ms"] * 1e3
    # The single device's updated params stay on the card for the ranks'
    # comparisons (5.6 GB; the moments and gradients are freed).
    want = dict(flatten(state.params))
    del state, step, m, dev_batch
    gc.collect()
    torch.cuda.empty_cache()

    fields = dict(nvidia_smi=smi, model=f"llama3-8b width, {MESH_TRAIN_LAYERS} of 32 layers, bf16, remat, random "
                  f"from seed {MESH_TRAIN_SEED}", batch=[MESH_TRAIN_BATCH, MESH_TRAIN_SEQ],
                  optimizer=f"AdamW lr {MESH_TRAIN_LR}", tolerance=MESH_TRAIN_TOL, single_device=single)
    failures, launches = [], {}
    emit("mesh_train_progress", single_device=single)
    try:
        for name, spec in MESH_TRAIN_SPECS:
            mesh = runtime.new_mesh(MeshSpec(**{"tensor": 1, **spec}).resolve(2))
            pipe = name == "pipe"
            rules = pipeline_rules() if pipe else fsdp_rules()

            def one_step(fault=None):
                st = training.init_train_state(cfg, opt, generator(), mesh=mesh, rules=rules)
                stepper = (make_pipeline_train_step(cfg, opt, mesh, n_micro=MESH_TRAIN_MICRO) if pipe
                           else training.make_train_step(cfg, opt, mesh=mesh))
                mesh.run(_rank_plant, fault)
                mesh.run(_rank_reset)
                mesh.run(_rank_peak_reset)
                try:
                    t0 = time.perf_counter()
                    st, metrics = stepper(st, batch)
                    ms = (time.perf_counter() - t0) * 1e3
                finally:
                    mesh.run(_rank_plant, None)
                counts = mesh.run(_rank_counts, gather=True)
                emit("mesh_train_progress", layout=name, planted=fault, step_ms=ms, **metrics)
                reading = dict(metrics, step_ms=ms, moved=_moved_apart(mesh, st.key, want))
                st.release()
                return reading, counts

            fault = MESH_TRAIN_FAULTS[name]
            planted, _ = one_step(fault)
            sound, counts = one_step()
            err, failed = _train_gate(sound, single, MESH_TRAIN_TOL)
            f_err, f_failed = _train_gate(planted, single, MESH_TRAIN_TOL)
            k4 = {c["rank"]: c["launches"]["flash_attention"] for c in counts}
            if failed:
                failures.append(f"{name}: the mesh step against one device's {err} fails {failed} ({MESH_TRAIN_TOL})")
            if not f_failed:
                failures.append(f"{name}: the planted {fault!r} passes every gate: {f_err}")
            if set(k4.values()) != {MESH_TRAIN_K4[name]}:
                failures.append(f"{name}: K4 launched {k4} times a rank, not {MESH_TRAIN_K4[name]}")
            launches[f"train_{name}"] = {c["rank"]: c["launches"] for c in counts}
            worst = sorted(sound["moved"].items(), key=lambda kv: -kv[1][0])[:4]
            fields[name] = dict(
                mesh=f"MeshSpec({', '.join(f'{k}={v}' for k, v in spec.items())}) on [cuda:0, cuda:0]"
                + (f", n_micro {MESH_TRAIN_MICRO}" if pipe else ""),
                loss=sound["loss"], grad_norm=sound["grad_norm"], vs_single=err, most_moved_leaves=dict(worst),
                step_ms=sound["step_ms"], tokens_per_s=tokens / sound["step_ms"] * 1e3,
                vs_single_tokens_per_s=single["step_ms"] / sound["step_ms"], k4_launches=k4,
                ranks={c["rank"]: {**c["comm"], "staged_mb": c["comm"]["staged_bytes"] / 1e6,
                                   "payload_mb": c["comm"]["payload_bytes"] / 1e6, "by_op": c["by_op"],
                                   "device_gb": c["device_gb"], "peak_gb": c["peak_gb"]} for c in counts},
                planted={"fault": fault, "loss": planted["loss"], "grad_norm": planted["grad_norm"], "vs_single": f_err,
                         "fails": f_failed})
            emit("mesh_train_step", layout=name, **fields[name])
    finally:
        del want
    gc.collect()
    fields["phase_s"] = time.perf_counter() - t_phase
    emit("mesh_train", **{k: v for k, v in fields.items() if k not in dict(MESH_TRAIN_SPECS)})
    if failures:
        raise AssertionError(f"mesh_train: {failures}")
    return launches


def mesh_train_moe_phase(torch, dev, smi, runtime) -> dict:
    """``mesh_train_moe``: Mixtral width at 1 layer, expert=2, capacity
    dispatch; the loss and grad norm of one step against one device's
    (``MESH_MOE_TRAIN_TOL``), each planted fault failing them, K4 twice a
    rank."""
    from generativeaiexamples_tpu_torch.engine import mesh_training, training
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec

    t_phase = time.perf_counter()
    cfg = llama.mixtral_8x7b(n_layers=MESH_MOE_TRAIN_LAYERS)
    opt = training.make_optimizer(MESH_TRAIN_LR)
    batch = _train_batch(torch, dev, cfg, MESH_MOE_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_SEED + 2)

    def generator():
        return torch.Generator(device=dev).manual_seed(MESH_TRAIN_SEED + 3)

    state = training.init_train_state(cfg, opt, generator(), device=dev)
    t0 = time.perf_counter()
    _, m = training.make_train_step(cfg, opt)(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    single = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    torch.cuda.synchronize()
    single["step_ms"] = (time.perf_counter() - t0) * 1e3
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    mesh = runtime.new_mesh(MeshSpec(expert=2, tensor=1).resolve(2))
    st = training.init_train_state(cfg, opt, generator(), mesh=mesh)
    planted = {}
    try:
        rows = mesh_training.rank_rows(mesh, batch)
        for fault in MESH_MOE_TRAIN_FAULTS:
            mesh.run(_rank_plant, fault)
            try:
                f_loss, f_norm = mesh.run(mesh_training.loss_and_norm, st.key, rank_args=rows)
            finally:
                mesh.run(_rank_plant, None)
            f_err, f_failed = _train_gate({"loss": f_loss, "grad_norm": f_norm}, single, MESH_MOE_TRAIN_TOL)
            planted[fault] = {"loss": f_loss, "grad_norm": f_norm, "vs_single": f_err, "fails": f_failed}
        mesh.run(_rank_reset)
        t0 = time.perf_counter()
        st, metrics = training.make_train_step(cfg, opt, mesh=mesh)(st, batch)
        ms = (time.perf_counter() - t0) * 1e3
        counts = mesh.run(_rank_counts, gather=True)
    finally:
        st.release()
    err, failed = _train_gate(metrics, single, MESH_MOE_TRAIN_TOL)
    k4 = {c["rank"]: c["launches"]["flash_attention"] for c in counts}
    emit("mesh_train_moe", nvidia_smi=smi, model=f"mixtral-8x7b width, {MESH_MOE_TRAIN_LAYERS} of 32 layers, bf16, "
         f"capacity-factor dispatch, random from seed {MESH_TRAIN_SEED + 3}", batch=[MESH_MOE_TRAIN_BATCH,
         MESH_TRAIN_SEQ], mesh="MeshSpec(expert=2) on [cuda:0, cuda:0]: 4 experts a rank", single_device=single,
         loss=metrics["loss"], grad_norm=metrics["grad_norm"], vs_single=err, tolerance=MESH_MOE_TRAIN_TOL,
         step_ms=ms, k4_launches=k4, ranks={c["rank"]: {**c["comm"], "by_op": c["by_op"], "peak_gb": c["peak_gb"]}
                                            for c in counts},
         planted=planted, phase_s=time.perf_counter() - t_phase)
    failures = []
    if failed:
        failures.append(f"the mesh step against one device's {err} fails {failed}")
    failures += [f"the planted {f!r} passes the gates: {r['vs_single']}" for f, r in planted.items() if not r["fails"]]
    # K4 a rank: the layer's forward and its remat recompute.
    if set(k4.values()) != {2 * MESH_MOE_TRAIN_LAYERS}:
        failures.append(f"K4 launched {k4} times a rank, not {2 * MESH_MOE_TRAIN_LAYERS}")
    if failures:
        raise AssertionError(f"mesh_train_moe: {failures}")
    return {"train_moe": {c["rank"]: c["launches"] for c in counts}}


def _checkpoint_dir(need_bytes: int) -> tuple[str, str]:
    """A temporary directory on tmpfs when ``/dev/shm`` has room for the
    checkpoint (twice over), else in the default temporary directory."""
    import shutil
    import tempfile

    if os.path.isdir("/dev/shm") and shutil.disk_usage("/dev/shm").free > 2 * need_bytes:
        return tempfile.mkdtemp(prefix="gaie-ckpt-", dir="/dev/shm"), "/dev/shm (tmpfs)"
    return tempfile.mkdtemp(prefix="gaie-ckpt-"), f"{tempfile.gettempdir()} (/dev/shm too small)"


def _rank_same(ctx, key, whole: dict) -> dict:
    """This rank's shards of the state under ``key`` against the same
    slices of ``whole`` (a checkpoint loaded whole on one device: the
    runtime's pipe hands a follower its CUDA tensors by IPC), leaf by leaf,
    bit for bit; the leaves that differ."""
    import torch

    from generativeaiexamples_tpu_torch.utils.trees import flatten
    from generativeaiexamples_tpu_torch.parallel.mesh import shard_slices

    st = ctx.state[key]
    spec_of = dict(flatten(st.specs))
    trees = {"params": st.params, "mu": st.opt_state.mu, "nu": st.opt_state.nu}
    differ, checked = [], 0
    for name, tree in trees.items():
        full = dict(flatten(whole[name]))
        for p, x in flatten(tree):
            w = full[p][shard_slices(tuple(full[p].shape), spec_of[p], ctx.sizes, ctx.coords)]
            checked += x.numel()
            if x.dtype != w.dtype or not torch.equal(x, w):
                differ.append(f"{name}/{p}")
    if (whole["step"], whole["count"]) != (st.step, st.opt_state.count):
        differ.append(f"step/count {whole['step']}/{whole['count']} against {st.step}/{st.opt_state.count}")
    return {"rank": ctx.rank, "differ": differ, "elements_checked": checked}


def mesh_ckpt_phase(torch, dev, smi, runtime, prompts) -> dict:
    """``mesh_ckpt``: the tensor=2 state of a 1-layer Llama-3-8B-width
    model (full vocabulary; params and both moments after a step) saved by
    its ranks; loaded onto fsdp=2 (each rank reads only its slices) and
    onto one device; every rank holds its shards of both mesh states
    against the one-device load bit for bit (so the file holds the saved
    state, and each load reads it back; the load reaches the follower by
    CUDA IPC); then ``Scheduler(mesh=tensor=2)``
    serves from it through ``RankParams("sharded")``: one chat completion
    through the engine's HTTP front, K2 and K4 on both ranks."""
    import dataclasses
    import shutil

    from generativeaiexamples_tpu_torch.engine import mesh_serving, mesh_training, training, weights
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.server import create_engine_app
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec, fsdp_rules

    t_phase = time.perf_counter()
    cfg = llama.llama3_8b(n_layers=1)
    opt = training.make_optimizer(MESH_TRAIN_LR)
    shapes = llama.param_shapes(cfg)
    n_params = sum(math.prod(v) for k, v in shapes.items() if k != "layers") + sum(
        math.prod(v) for v in shapes["layers"].values())
    total = 3 * 2 * n_params  # bf16 params and both moments
    path_root, where = _checkpoint_dir(total)
    path = os.path.join(path_root, "state")
    fields = dict(nvidia_smi=smi, model="llama3-8b width, 1 layer, full vocabulary, bf16", directory=where,
                  tree_gb=total / 1e9)
    failures, counts = [], []
    tp = runtime.new_mesh(MeshSpec(tensor=2).resolve(2))
    fs = runtime.new_mesh(MeshSpec(fsdp=2, tensor=1).resolve(2))
    st = st2 = None
    try:
        st = training.init_train_state(cfg, opt, torch.Generator(device=dev).manual_seed(MESH_TRAIN_SEED + 4),
                                       mesh=tp)
        st, _ = training.make_train_step(cfg, opt, mesh=tp)(st, _train_batch(torch, dev, cfg, 2, 256, 7))
        t0 = time.perf_counter()
        written = mesh_training.save(st, path)
        write_s = time.perf_counter() - t0
        fields.update(written_gb=written / 1e9, write_s=write_s, write_gb_per_s=written / 1e9 / write_s)
        emit("mesh_ckpt_progress", saved=fields)
        before = fs.run(_rank_rss, gather=True)
        t0 = time.perf_counter()
        st2 = mesh_training.new_state(fs, "llama", cfg, opt, fsdp_rules(), ("checkpoint", path))
        read_s = time.perf_counter() - t0
        after = fs.run(_rank_rss, gather=True)
        read = [a["read_bytes"] - b["read_bytes"] for a, b in zip(after, before)]
        fields["fsdp2"] = dict(read_s=read_s, read_gb_per_s=sum(read) / 1e9 / read_s,
                               read_gb_by_rank=[r / 1e9 for r in read], rss_gb_by_rank=[a["rss_gb"] for a in after])
        if any(r > total / 2 + 1e6 for r in read):
            failures.append(f"fsdp=2: a rank read more than its half: {read} of {total}")
        t0 = time.perf_counter()
        whole = weights.load_checkpoint(path, device=dev)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        fields["one_device"] = dict(read_s=one_s, read_gb_per_s=total / 1e9 / one_s)
        emit("mesh_ckpt_progress", loaded={k: fields[k] for k in ("fsdp2", "one_device")})
        for what, mesh, key in (("tensor=2 (saved)", tp, st.key), ("fsdp=2 (loaded)", fs, st2.key)):
            for r in mesh.run(_rank_same, key, whole, gather=True):
                fields.setdefault("bit_for_bit", {}).setdefault(what, []).append(r)
                if r["differ"]:
                    failures.append(f"{what}: rank {r['rank']}'s {r['differ'][:4]} differ from the one-device load")
        del whole
        st.release()
        st2.release()
        st = st2 = None

        sched = Scheduler(dataclasses.replace(cfg, kv_dtype="int8"), mesh_serving.RankParams("sharded", path=path),
                          mesh=tp, **serve_kw("contiguous"))
        try:
            tp.run(_rank_reset)
            server = create_engine_app(sched, get_tokenizer("llama3-8b"), "llama3-8b", "127.0.0.1", 0)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            sched.start()
            try:
                body = {"model": "llama3-8b", "messages": [{"role": "user", "content": prompts["completions"][0]}],
                        "max_tokens": 16, "temperature": 0.0}
                req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/v1/chat/completions",
                                             json.dumps(body).encode(), {"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as resp:
                    status, out = resp.status, json.loads(resp.read())
            finally:
                server.shutdown()
                server.server_close()
                sched.stop()
                thread.join(timeout=10)
            counts = tp.run(_rank_counts, gather=True)
            rss = tp.run(_rank_rss, gather=True)
        finally:
            sched.release_mesh()
        served = {c["rank"]: {k: c["launches"][k] for k in ("decode_attention", "flash_attention")} for c in counts}
        fields["serve"] = dict(status=status, completion_tokens=out["usage"]["completion_tokens"], launches=served,
                               rss_gb_by_rank=[r["rss_gb"] for r in rss], shard_params_gb=n_params * 2 / 2 / 1e9)
        if status != 200 or out["usage"]["completion_tokens"] < 1:
            failures.append(f"serve: status {status}, {out.get('usage')}")
        # One layer: K4 once a prefill chunk of the prompt, K2 once a decode
        # step, and the decode runs whole chunks past the prefill's token.
        kw = serve_kw("contiguous")
        chunk = kw["decode_chunk_size"]
        want = {"decode_attention": chunk * math.ceil((out["usage"]["completion_tokens"] - 1) / chunk),
                "flash_attention": math.ceil(out["usage"]["prompt_tokens"] / kw["prefill_chunk_tokens"])}
        fields["serve"]["launches_expected"] = want
        if any(v != want for v in served.values()):
            failures.append(f"serve: launches {served}, not {want} a rank")
    finally:
        for state in (st, st2):
            if state is not None:
                state.release()
        shutil.rmtree(path_root, ignore_errors=True)
    fields["phase_s"] = time.perf_counter() - t_phase
    emit("mesh_ckpt", **fields)
    if failures:
        raise AssertionError(f"mesh_ckpt: {failures}")
    return {"ckpt_serve": {c["rank"]: c["launches"] for c in counts}}


def mesh_serve_step(torch, name, sched, prompts, counts):
    """Serve ``prompts``' 8 concurrent completions and one streaming chat
    through the engine's HTTP front on ``sched``; ``counts()`` zeroes
    (``True``) or reads (``False``) the launch counts of every rank.
    Returns (records, fields)."""
    from generativeaiexamples_tpu_torch.engine.server import create_engine_app
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer

    tee = StreamTee(sched)
    server = create_engine_app(sched, get_tokenizer("llama3-8b"), "llama3-8b", "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    sched.start()
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _complete(base, prompts["warmup"], 4)
        tee.records.clear()
        n_ttft0 = len(sched.stats.ttft_recent)
        snap0 = sched.stats.snapshot()
        counts(True)
        t_wall = time.perf_counter()
        workers, results = _concurrent(base, prompts["completions"])
        status, _ = _post(base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": prompts["chat"]}], "max_tokens": 32, "temperature": 0,
            "stream": True})
        for w in workers:
            w.join(timeout=600)
        wall = time.perf_counter() - t_wall
        launches = counts(False)
        if status != 200 or len(results) != len(prompts["completions"]):
            raise AssertionError(f"{name}: a request failed ({status}, {len(results)} completions)")
        snap1 = sched.stats.snapshot()
        decode_tokens = (snap1["tokens_total"] - snap0["tokens_total"]) - (snap1["requests_total"]
                                                                           - snap0["requests_total"])
        decode_s = snap1["decode_s"] - snap0["decode_s"]
        ttfts = sorted(list(sched.stats.ttft_recent)[n_ttft0:])
        return tee.records, dict(wall_s=wall, ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3,
                                 decode_tokens_per_s=decode_tokens / decode_s if decode_s else None,
                                 decode_chunks=snap1["decode_chunks"] - snap0["decode_chunks"],
                                 requests=len(tee.records), launches=launches)
    finally:
        server.shutdown()
        server.server_close()
        sched.stop()
        thread.join(timeout=30)


def mesh_stream_gate(torch, cfg, params, single: dict, mesh_streams: dict, gaps_of: dict,
                     teacher=None) -> dict:
    """The mesh's greedy streams against the single-device engine's.

    Each stream must equal the single device's up to its first step where
    the single-device run's top-2 logit gap (teacher-forced, f32) is below
    2 * MESH_LOGIT_TOL.  ``teacher(prompt, ids)``, when given, is the mesh's
    teacher-forced logits over the single device's stream: they must lie
    within MESH_LOGIT_TOL of the single device's at every step (the probe's
    logit gate over every served prompt), and the steps where their top-1
    differs are counted.  ``gaps_of`` keeps each prompt's gaps for the next
    layout.  Returns the readings: per stream its length, first difference,
    first near tie, the gap at the difference and the teacher-forced
    reading; ``steps_checked`` counts the steps the equality rule covers
    (each stream's up to its first near tie) out of ``steps``; ``failures``
    lists what broke a rule."""
    out = {"compared": 0, "equal": 0, "steps": 0, "steps_checked": 0, "teacher_forced_top1_differs": 0,
           "teacher_forced_max_abs_err": 0.0, "streams": [], "failures": []}
    for prompt, ids in single.items():
        got = mesh_streams.get(prompt)
        if got is None:
            out["failures"].append(f"the mesh never served a {len(prompt)}-token prompt")
            continue
        out["compared"] += 1
        row = {"prompt_tokens": len(prompt), "tokens": len(ids)}
        if prompt not in gaps_of or teacher is not None:
            want = teacher_forced_logits(torch, cfg, params, prompt, ids)
            top2 = want.topk(2, dim=-1).values
            gaps_of[prompt] = (top2[:, 0] - top2[:, 1]).tolist()
            if teacher is not None:
                t0 = time.perf_counter()
                lg = teacher(prompt, ids)
                out["teacher_forced_s"] = out.get("teacher_forced_s", 0.0) + time.perf_counter() - t0
                err = (lg - want).abs().amax(-1)
                row["teacher_forced_max_abs_err"] = err.max().item()
                row["teacher_forced_top1_differs"] = int((lg.argmax(-1) != want.argmax(-1)).sum().item())
                out["teacher_forced_max_abs_err"] = max(out["teacher_forced_max_abs_err"], err.max().item())
                out["teacher_forced_top1_differs"] += row["teacher_forced_top1_differs"]
                if err.max().item() > MESH_LOGIT_TOL:
                    out["failures"].append(f"a {len(prompt)}-token prompt's teacher-forced logits differ by "
                                           f"{err.max().item()} (allowed {MESH_LOGIT_TOL})")
        gaps = gaps_of[prompt]
        near = next((i for i, g in enumerate(gaps) if g < 2 * MESH_LOGIT_TOL), len(gaps))
        j = next((i for i in range(min(len(ids), len(got))) if ids[i] != got[i]), None)
        if j is None and len(ids) != len(got):
            j = min(len(ids), len(got))
        out["equal"] += j is None
        out["steps"] += len(ids)
        out["steps_checked"] += min(near, len(ids))
        gap = gaps[j] if j is not None and j < len(gaps) else None
        out["streams"].append({**row, "first_difference": j, "first_near_tie": near, "gap_at_difference": gap})
        if j is not None and j < near:
            out["failures"].append(f"a {len(prompt)}-token prompt parts at step {j}, before its first near tie "
                                   f"at {near} (gap {gap})")
    return out


def mesh_phases(torch, dev, _cuda, smi, prompts) -> dict:
    """The ``mesh`` group: ``mesh_serve``, ``mesh_seq``, ``mesh_moe``,
    ``mesh_train``, ``mesh_train_moe``, ``mesh_ckpt`` and last
    ``mesh_fault``, on one pair of follower processes (rank 1 of every
    mesh; rank 0 is this process), each rank on ``cuda:0``.  Returns each
    kernel's launches per rank in ``mesh_serve`` by layout and in the
    training phases by mesh."""
    import dataclasses

    from generativeaiexamples_tpu_torch.engine import mesh_serving
    from generativeaiexamples_tpu_torch.engine.decode import prepare_params
    from generativeaiexamples_tpu_torch.engine.scheduler import Scheduler
    from generativeaiexamples_tpu_torch.engine.tokenizer import get_tokenizer
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops.flash_attention import flash_gqa_attention
    from generativeaiexamples_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    t_group = time.perf_counter()
    devices = [dev, dev]
    t0 = time.perf_counter()
    # The follower was spawned at the script's start (main): this waits
    # for what is left of its start-up and builds the mesh's groups.
    mesh = make_mesh(MeshSpec(tensor=2), devices, timeout_s=MESH_TIMEOUT_S)
    runtime = mesh.runtime
    ready_s = time.perf_counter() - t0
    per_rank: dict = {}
    try:
        # --- mesh_serve -----------------------------------------------------
        t_phase = time.perf_counter()
        cfg = llama.llama3_8b(kv_dtype="int8", n_layers=MESH_LAYERS)
        with torch.inference_mode():
            ref = prepare_params(cfg, None, device=dev, quantize=True,
                                 generator=torch.Generator(device=dev).manual_seed(MESH_SEED))
        fields: dict = dict(nvidia_smi=smi, model=f"llama3-8b, {MESH_LAYERS} of 32 layers, full width",
                            weights="random weight-only int8 (seed 0), int8 KV cache",
                            mesh="MeshSpec(tensor=2) on [cuda:0, cuda:0]: two processes on one card",
                            transport=mesh.ctx.groups["tensor"].transport,
                            shared_line=mesh.ctx.groups["tensor"].shared is not None, mesh_ready_s=ready_s)

        def counts_all(reset):
            if reset:
                mesh.run(_rank_reset)
                return None
            return mesh.run(_rank_counts, gather=True)

        def counts_local(reset):
            if reset:
                _cuda.reset_launch_counts()
                return None
            return [{"rank": 0, "launches": dict(_cuda.LAUNCHES)}]

        tok = get_tokenizer("llama3-8b")
        probe_prompt = tok.encode(prompts["completions"][2])
        single, records = {}, {}
        single_sched = Scheduler(cfg, ref, device=dev, **serve_kw("contiguous"))
        try:
            recs, fields["single_device"] = mesh_serve_step(torch, "mesh_single", single_sched, prompts, counts_local)
            single = {p: ids for p, sp, ids in recs}
            timing_single = _time_decode_chunk(torch, dev, single_sched)
        finally:
            single_sched._cache = None
        follow = single[tuple(probe_prompt)][:8] if tuple(probe_prompt) in single else probe_prompt[:8]
        with torch.inference_mode():
            want_h, want_lg = probe_forward(torch, ref, cfg, probe_prompt, follow)
        gc.collect()
        torch.cuda.empty_cache()
        failures, gaps_of = [], {}
        for layout in ("contiguous", "paged"):
            t0 = time.perf_counter()
            sched = Scheduler(cfg, mesh_serving.RankParams("seed", quantize=True), mesh=mesh, **serve_kw(layout))
            build_s = time.perf_counter() - t0
            try:
                if layout == "contiguous":
                    got_h, got_lg = mesh.run(_rank_probe, sched._mesh_key, probe_prompt, follow)
                    h_err, lg_err = _rel_err(torch, got_h, want_h), _rel_err(torch, got_lg, want_lg)
                    fields["probe"] = dict(prompt_tokens=len(probe_prompt), decode_steps=len(follow),
                                           hidden=h_err, logits=lg_err,
                                           logits_max_abs_err_per_step=(got_lg - want_lg).abs().amax(-1).tolist(),
                                           hidden_tolerance=MESH_HIDDEN_TOL, logit_tolerance=MESH_LOGIT_TOL)
                    if not _rel_within(h_err, MESH_HIDDEN_TOL) or lg_err["max_abs_err"] > MESH_LOGIT_TOL:
                        failures.append(f"probe: hidden {h_err} (tolerance {MESH_HIDDEN_TOL}), logits {lg_err} "
                                        f"(largest difference allowed {MESH_LOGIT_TOL})")
                    planted = {}
                    for fault in MESH_PROBE_FAULTS:
                        f_h, f_lg = mesh.run(_rank_probe, sched._mesh_key, probe_prompt, follow, fault)
                        planted[fault] = {"hidden": _rel_err(torch, f_h, want_h),
                                          "logits": _rel_err(torch, f_lg, want_lg)}
                        if (_rel_within(planted[fault]["hidden"], MESH_HIDDEN_TOL)
                                or planted[fault]["logits"]["max_abs_err"] <= MESH_LOGIT_TOL):
                            failures.append(f"probe: the planted fault {fault!r} passes a gate: {planted[fault]}")
                    fields["probe"]["planted_faults"] = planted
                recs, step = mesh_serve_step(torch, f"mesh_{layout}", sched, prompts, counts_all)
                records[layout] = {p: ids for p, sp, ids in recs}
                # The mesh's teacher-forced logits over every served stream
                # (its params are the same draw on both layouts: once).
                teacher = None if layout != "contiguous" else (
                    lambda prompt, ids: mesh.run(_rank_teacher_forced, sched._mesh_key, prompt, ids))
                gate = mesh_stream_gate(torch, cfg, ref, single, records[layout], gaps_of, teacher)
                failures += [f"{layout}: {f}" for f in gate.pop("failures")]
                digests = mesh.run(mesh_serving.sampled_digest, sched._mesh_key, gather=True)
                if len(set(digests)) != 1:
                    failures.append(f"{layout}: the ranks sampled different tokens: {digests}")
                kernel = "paged_decode_attention" if layout == "paged" else "decode_attention"
                launches = {c["rank"]: c["launches"] for c in step["launches"]}
                for rank, c in launches.items():
                    if not (c[kernel] and c["flash_attention"]):
                        failures.append(f"{layout}: rank {rank} launched {c}")
                per_rank[layout] = launches
                step["launches"] = launches
                step["ranks"] = {c["rank"]: {k: c[k] for k in ("comm", "by_op", "device_gb", "peak_gb")}
                                 for c in counts_all(False)}
                if layout == "contiguous":
                    step["decode_chunk"] = _time_mesh_chunk(torch, mesh, sched)
                    step["decode_chunk"]["single_device_ms_per_step"] = timing_single
                fields[layout] = dict(build_s=build_s, **step, streams=gate, sampled_digest_equal=len(set(digests)) == 1,
                                      vs_single_decode_tokens_per_s=(step["decode_tokens_per_s"]
                                                                     / fields["single_device"]["decode_tokens_per_s"]),
                                      shard_bytes=sched.mesh_shards)
            finally:
                sched.release_mesh()
        fields["phase_s"] = time.perf_counter() - t_phase
        emit("mesh_serve", **fields)
        if failures:
            raise AssertionError(f"mesh_serve: {failures}")
        del ref
        gc.collect()
        torch.cuda.empty_cache()

        # --- mesh_seq -------------------------------------------------------
        t_phase = time.perf_counter()
        seq = runtime.new_mesh(MeshSpec(seq=2, tensor=1).resolve(2))
        q, k, v, pos = _seq_inputs(torch, dev, 1)
        flash_gqa_attention(q, k, v, pos, None)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = flash_gqa_attention(q, k, v, pos, None)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out = dict(nvidia_smi=smi, tokens=MESH_SEQ_LEN, heads="32 q / 8 kv, head_dim 128 (Llama-3-8B)",
                   mesh="MeshSpec(seq=2) on [cuda:0, cuda:0]", k4_whole_sequence_ms=sorted(times)[1],
                   tolerance=FLASH_TOL)
        seq_fail = []
        for strategy in ("ring", "ulysses"):
            mesh.run(_rank_reset)
            got, ms = seq.run(_rank_seq, strategy, 1, 3)
            err = (got.float() - want.float()).abs()
            ok = bool((err <= FLASH_TOL["atol"] + FLASH_TOL["rtol"] * want.float().abs()).all())
            c = seq.run(_rank_counts, gather=True)
            out[strategy] = dict(ms=ms, max_abs_err=err.max().item(), within=ok,
                                 k4_launches={r["rank"]: r["launches"]["flash_attention"] for r in c},
                                 collectives={r["rank"]: r["by_op"] for r in c},
                                 staged_bytes={r["rank"]: r["comm"]["staged_bytes"] for r in c})
            if not ok:
                seq_fail.append(f"{strategy}: max abs err {err.max().item()} past {FLASH_TOL}")
        if not all(out["ulysses"]["k4_launches"].values()):
            seq_fail.append(f"ulysses: K4 launched {out['ulysses']['k4_launches']}")
        out["ulysses"]["rank_k4_vs_plain"] = seq.run(_rank_ulysses_k4, 1, MESH_SEQ_LEN, gather=True)
        for r in out["ulysses"]["rank_k4_vs_plain"]:
            if not r["within"]:
                seq_fail.append(f"ulysses: rank {r['rank']}'s K4 call against the plain attention: {r}")
        del q, k, v, want, got
        out["phase_s"] = time.perf_counter() - t_phase
        emit("mesh_seq", **out)
        if seq_fail:
            raise AssertionError(f"mesh_seq: {seq_fail}")
        gc.collect()
        torch.cuda.empty_cache()

        # --- mesh_moe -------------------------------------------------------
        t_phase = time.perf_counter()
        mcfg = llama.mixtral_8x7b(n_layers=MESH_MOE_LAYERS)
        moe = runtime.new_mesh(MeshSpec(expert=2, tensor=1).resolve(2))
        tokens = [tok.encode(prompts["completions"][3])[:128]]
        got, got_missing = moe.run(_rank_moe, mcfg, MESH_SEED, tokens)
        with torch.inference_mode():
            mparams = prepare_params(mcfg, None, device=dev,
                                     generator=torch.Generator(device=dev).manual_seed(MESH_SEED))
            t = torch.tensor(tokens, device=dev)
            want, _ = llama.forward(mparams, mcfg, t, torch.arange(t.shape[1], dtype=torch.int32,
                                                                    device=dev).expand(t.shape))
        err, missing = _rel_err(torch, got, want), _rel_err(torch, got_missing, want)
        del mparams
        emit("mesh_moe", nvidia_smi=smi, model=f"mixtral-8x7b width, {MESH_MOE_LAYERS} of 32 layers, random bf16 "
             "(seed 0)", mesh="MeshSpec(expert=2) on [cuda:0, cuda:0]: 4 experts a rank", tokens=len(tokens[0]),
             hidden=err, tolerance=MESH_MOE_TOL, planted_expert_missing=missing,
             phase_s=time.perf_counter() - t_phase)
        if not _rel_within(err, MESH_MOE_TOL):
            raise AssertionError(f"mesh_moe: {err} past {MESH_MOE_TOL}")
        if _rel_within(missing, MESH_MOE_TOL):
            raise AssertionError(f"mesh_moe: the planted missing expert passes the gate: {missing}")
        gc.collect()
        torch.cuda.empty_cache()

        # --- mesh_train, mesh_train_moe, mesh_ckpt ----------------------------
        per_rank.update(mesh_train_phase(torch, dev, smi, runtime))
        gc.collect()
        torch.cuda.empty_cache()
        per_rank.update(mesh_train_moe_phase(torch, dev, smi, runtime))
        gc.collect()
        torch.cuda.empty_cache()
        per_rank.update(mesh_ckpt_phase(torch, dev, smi, runtime, prompts))
        gc.collect()
        torch.cuda.empty_cache()

        # --- mesh_fault -----------------------------------------------------
        t_phase = time.perf_counter()
        sched = Scheduler(dataclasses.replace(cfg, n_layers=2), mesh_serving.RankParams("seed", quantize=True),
                          mesh=mesh, **serve_kw("contiguous"))
        from generativeaiexamples_tpu_torch.engine.sampler import SamplingParams
        from generativeaiexamples_tpu_torch.engine.scheduler import Request

        done, first = queue.Queue(), queue.Queue()
        sched.start()
        sched.submit(Request(token_ids=probe_prompt, sampling=SamplingParams(max_tokens=1500, temperature=0.0),
                             on_token=first.put, on_done=done.put))
        first.get(timeout=120)
        runtime._procs[0].kill()
        t_kill = time.perf_counter()
        try:
            reason = done.get(timeout=MESH_TIMEOUT_S + 30)
        except queue.Empty:
            reason = None
        failed_s = time.perf_counter() - t_kill
        late = queue.Queue()
        sched.submit(Request(token_ids=[1, 2, 3], sampling=SamplingParams(max_tokens=4), on_token=lambda t: None,
                             on_done=late.put))
        late_reason = late.get(timeout=10)
        sched.stop()
        healthy = sched.healthy()
        emit("mesh_fault", nvidia_smi=smi, killed="rank 1 (SIGKILL) mid-decode", request_done=reason,
             failed_after_s=failed_s, group_timeout_s=MESH_TIMEOUT_S, late_request_done=late_reason,
             scheduler_healthy=healthy, phase_s=time.perf_counter() - t_phase)
        if reason != "error" or late_reason != "error" or healthy or failed_s > MESH_TIMEOUT_S:
            raise AssertionError(f"mesh_fault: request {reason} after {failed_s:.1f} s, late {late_reason}, "
                                 f"healthy {healthy}")
    finally:
        runtime.close()
        emit("mesh", phase_s=time.perf_counter() - t_group, followers_left=[p.pid for p in runtime._procs
                                                                              if p.is_alive()])
    gc.collect()
    torch.cuda.empty_cache()
    return per_rank


def _time_decode_chunk(torch, dev, sched) -> float:
    """ms per step of one single-device decode chunk, every lane live at
    PROFILE_LENGTH (garbage KV: timing only)."""
    fn = decode_chunk(torch, dev, sched)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS


def _time_mesh_chunk(torch, mesh, sched) -> dict:
    """One mesh decode chunk, every lane live at PROFILE_LENGTH: ms per
    step and rank 0's collectives, staged bytes and staged ms per step."""
    import numpy as np

    from generativeaiexamples_tpu_torch.engine import mesh_serving
    from generativeaiexamples_tpu_torch.parallel.comm import COMM_STATS, stats_delta

    b, n = sched.max_batch, sched.decode_chunk_size
    args = (np.arange(b, dtype=np.int32) + 1000, np.full((b,), PROFILE_LENGTH, np.int32), np.zeros(b, np.float32),
            np.ones(b, np.float32), np.zeros(b, np.int32), n, PROFILE_LENGTH + n + 1, None)
    mesh.run(mesh_serving.decode, sched._mesh_key, *args)
    before = dict(COMM_STATS)
    t0 = time.perf_counter()
    mesh.run(mesh_serving.decode, sched._mesh_key, *args)
    ms = (time.perf_counter() - t0) * 1e3
    delta = stats_delta(before)
    return {"lanes": b, "length": PROFILE_LENGTH, "ms_per_step": ms / n,
            "collectives_per_step": delta["collectives"] / n, "staged_mb_per_step": delta["staged_bytes"] / n / 1e6,
            "collective_ms_per_step": delta["ms"] / n}


def main() -> int:
    # SIGUSR1 prints every thread's stack (a stalled run is located by
    # sending it, as ``timeout -s USR1`` does).
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    # The run uses one card: only the first visible one is exposed, so the
    # device count in the last line is 1 whatever else the machine holds.
    os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    # Tokenizers come from local files only: no hub lookups.
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "generativeaiexamples_tpu_torch", "csrc")):
        print("chip_smoke: the generativeaiexamples_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from generativeaiexamples_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    took = _cuda.build()
    from generativeaiexamples_tpu_torch.ops import qmm

    # Dynamic shared memory per block of each K1 design (ptxas reports
    # only static shared memory).
    qmm_smem = {f"{p.design} M={m} tile {p.tile_n}": p.smem_bytes
                for m in (1, 32, 64, 256, 2048) for p in [qmm.qmm_plan(m, 4096, 4096)]}
    emit("build", seconds=time.perf_counter() - t0, per_kernel_s=took,
         ptxas={name: ptxas_summary(log) for name, (_, log) in _cuda.BUILD_LOG.items()},
         qmm_dynamic_smem_bytes=qmm_smem)

    # The mesh group's follower rank starts now, so that its start-up (an
    # interpreter, torch, a CUDA context) overlaps the phases before it.
    from generativeaiexamples_tpu_torch.parallel.runtime import get_runtime

    get_runtime([dev, dev], timeout_s=MESH_TIMEOUT_S)
    if sys.argv[1:] == ["--only", "mesh"]:
        # The build, the kernels at a mesh rank's shapes and the mesh group
        # alone, for work on the mesh (the whole script runs with no
        # arguments).
        check_mesh_rank(torch, dev, [])
        check_flash_train(torch, dev, [], **MESH_TRAIN_RANK_FLASH)
        mesh_phases(torch, dev, _cuda, smi, make_prompts())
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}), flush=True)
        return 0
    log: list[str] = []
    summary = {
        "qmm": check_qmm(torch, dev, log),
        "decode_attention": check_decode(torch, dev),
        "paged_decode_attention": check_paged_decode(torch, dev),
        "flash_attention": check_flash(torch, dev, log),
    }
    # K4 at the speculative draft's head_dim (Llama-3.2-1B: 64).
    summary["flash_attention"]["hd64"] = check_flash(torch, dev, log, hd=64)
    # The families' instances: K2/K3 at (256, G <= 8) and (128, G <= 16),
    # K4 at head_dim 256 with Gemma-7B's and Gemma-2B's heads.
    instance_rows = {model: check_decode_instance(torch, dev, hd, kh, g) for model, hd, kh, g in DECODE_INSTANCE_SHAPES}
    for name in ("decode_attention", "paged_decode_attention"):
        summary[name]["instances"] = {model: rows[name] for model, rows in instance_rows.items()}
    summary["flash_attention"]["hd256"] = {"gemma-7b": check_flash(torch, dev, log, hd=256, nq=16, nkv=16),
                                           "gemma-2b": check_flash(torch, dev, log, hd=256, nq=8, nkv=1)}
    # A mesh rank's shapes (mesh_serve, tensor=2).
    for name, row in check_mesh_rank(torch, dev, log).items():
        summary[name]["mesh_rank"] = row
    # K4 at a tensor=2 training rank's shape (mesh_train).
    summary["flash_attention"]["mesh_train_rank"] = check_flash_train(torch, dev, log, **MESH_TRAIN_RANK_FLASH)
    if log:
        emit("notes", notes=log)
    check_reference(torch, dev)
    torch.cuda.empty_cache()

    # The retrieval side, before the Llama params: BERT on card vs CPU,
    # arctic-embed-l through the embedder (kept with a reranker for
    # ``serve``), the exact store at 1M rows, the retrieval chain over it,
    # and the compressed and IVF stores over its corpus (all freed after).
    from generativeaiexamples_tpu_torch.engine.microbatch import BatchedEmbedder
    from generativeaiexamples_tpu_torch.engine.reranker import GPUReranker
    from generativeaiexamples_tpu_torch.models import bert

    check_bert(torch, dev)
    embedder, queries = embed_phase(torch, dev)
    store, ret_queries, planted = retrieve_phase(torch, dev)
    retriever_phase(torch, dev, store)
    stores_phase(torch, dev, store, ret_queries, planted)
    fabric_phase(torch, dev, store, ret_queries, planted)
    native_store_phase(store, ret_queries)
    from generativeaiexamples_tpu_torch.chains.factory import reset_factories

    reset_factories()  # frees the chain: the 1M-row store, its embedder, the reranker
    del store
    gc.collect()
    torch.cuda.empty_cache()
    rag = (BatchedEmbedder(embedder, max_batch=32, max_wait_ms=3.0), GPUReranker(bert.arctic_embed_l(), device=dev),
           queries)

    from generativeaiexamples_tpu_torch.engine.decode import w8a8_params
    from generativeaiexamples_tpu_torch.models import llama

    # Llama-3-8B at full width and depth, random int8 weights from a seed,
    # shared by both serving layouts.
    cfg = llama.llama3_8b(kv_dtype="int8")
    t0 = time.perf_counter()
    with torch.inference_mode():
        params = w8a8_params(cfg, None, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit("params", model="llama3-8b", seconds=time.perf_counter() - t0,
         device_gb=torch.cuda.memory_allocated(dev) / 1e9)
    prompts = make_prompts()
    # Every K1 shape the serving phases launch is held bit for bit against
    # the plain version after them.
    with QmmShapes() as k1_shapes:
        try:
            launches, alone, timing, serve_summary = serve(torch, dev, _cuda, cfg, params, prompts, "contiguous",
                                                           rag=rag)
        finally:
            rag[0].close()
        del rag
        gc.collect()
        torch.cuda.empty_cache()
        paged_launches, _, paged_timing, _ = serve(torch, dev, _cuda, cfg, params, prompts, "paged", expect=alone)
        # Each kernel's launches come from the path that runs it.
        launches["paged_decode_attention"] = paged_launches["paged_decode_attention"]
        gc.collect()
        torch.cuda.empty_cache()
        pool_launches = pool_phase(torch, dev, _cuda, smi, cfg, params, prompts, serve_summary, alone)
        gc.collect()
        torch.cuda.empty_cache()
        spec_launches, spec_hd64 = spec_phase(torch, dev, _cuda, cfg, params, prompts, serve_summary,
                                           summary["decode_attention"]["ms"])
        for kv_layout, t in (("contiguous", timing), ("paged", paged_timing)):
            gc.collect()
            torch.cuda.empty_cache()
            profile_decode(torch, dev, cfg, params, kv_layout, t)
        profile_embed(torch, dev, embedder)
        del embedder, params
        gc.collect()
        torch.cuda.empty_cache()
        # The chain server builds its own engine and embedder from APP_*.
        chain_launches, step_launches = chain_phase(torch, dev, _cuda, smi)
        gc.collect()
        torch.cuda.empty_cache()
        hf_launches = hf_checkpoint_phase(torch, dev, _cuda, smi, prompts)
        gc.collect()
        torch.cuda.empty_cache()
        family_launches = families_phase(torch, dev, _cuda, smi, prompts)
        gc.collect()
        torch.cuda.empty_cache()
        warm, xla_launches = xla_path_phase(torch, dev, _cuda, smi, log, prompts, summary["decode_attention"]["ms"])
    gc.collect()
    torch.cuda.empty_cache()
    kw = serve_kw("contiguous")
    check_qmm_shapes(torch, dev, k1_shapes.seen, worst_m=kw["max_batch"] * kw["max_len"])
    # Serving over a mesh: two ranks on this card.
    mesh_launches = mesh_phases(torch, dev, _cuda, smi, prompts)
    # The model services: K4 at the VLM's prefill shapes, the vision
    # models card vs CPU, the analyst, the multimodal chain, speech.
    vlm_k4 = {f"s{s}_t{s + 96}": check_flash_warm(torch, dev, log, 128, 0, s + 96, b=1, s=s, n_valid=(s,),
                                                   regime="vlm_prefill") for s in VLM_PREFILL_S}
    vision_reference_phase(torch, dev, smi)
    service_launches = multimodal_phase(torch, dev, _cuda, smi)
    speech_reference_phase(torch, dev, smi)
    speech_serve_phase(torch, dev, smi)
    # Training on one card, then the streaming pipeline.
    train = train_phase(torch, dev, _cuda, smi, log)
    training_launches = {"train": train["launches"], "lora": lora_phase(torch, dev, _cuda, smi),
                         **train_losses_phase(torch, dev, _cuda, smi)}
    streaming_phase(torch, dev, _cuda, smi)
    # The two durability runs share nothing but the card (their own server
    # processes, directories and ports), and mostly wait on those
    # processes: they run side by side.
    side_by_side(lambda: durable_phase(smi),
                 lambda: durable_phase(smi, name="durable_fabric", n_docs=DURABLE_FABRIC_DOCS, term=False,
                                       env_extra=DURABLE_FABRIC_ENV))

    kernels = []
    for name, s in summary.items():
        kernels.append({
            "name": name, "route": "cuda", "source": f"generativeaiexamples_tpu_torch/csrc/{_cuda.SOURCES[name]}",
            "replaces": REPLACES[name], "launches": launches[name], "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "eager_ms": s["eager_ms"], "shape": s["shape"],
            "pool_launches": pool_launches[name],
            "chain_launches": chain_launches[name],
            "step_launches": {step: counts[name] for step, counts in step_launches.items()},
            "spec_launches": {step: counts[name] for step, counts in spec_launches.items()},
            "hf_launches": {path: counts[name] for path, counts in hf_launches.items()},
            "xla_path_launches": {part: counts[name] for part, counts in xla_launches.items()},
            "mesh_launches": {layout: {f"rank{r}": c[name] for r, c in ranks.items()}
                              for layout, ranks in mesh_launches.items()},
            **{k: s[k] for k in ("layer_ms_by_m", "layer_library_ms_by_m") if k in s},
        })
        kernels[-1]["families_launches"] = {
            preset: {path: counts[name] for path, counts in paths.items()} for preset, paths in family_launches.items()}
        timed = ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err")
        kernels[-1]["services_launches"] = {phase: counts[name] for phase, counts in service_launches.items()}
        kernels[-1]["training_launches"] = {phase: counts[name] for phase, counts in training_launches.items()}
        if name == "flash_attention":
            kernels[-1]["train"] = {f: train["k4"][f] for f in timed + ("b", "s", "hd", "fwd_bwd_ms",
                                                                         "library_fwd_bwd_ms", "grad_err")}
            kernels[-1]["warm"] = {k: {f: h[f] for f in timed + ("t", "first_position", "hd")} for k, h in warm.items()}
            kernels[-1]["vlm_prefill"] = {k: {f: h[f] for f in timed + ("s", "t", "first_position", "hd")}
                                          for k, h in vlm_k4.items()}
        if "mesh_train_rank" in s:
            h = s["mesh_train_rank"]
            kernels[-1]["mesh_train_rank"] = {
                **{k: h[k] for k in timed + ("b", "s", "nq", "nkv", "hd")},
                "launches": {phase: ranks for phase, ranks in kernels[-1]["mesh_launches"].items()
                             if phase.startswith("train")}}
        if "mesh_rank" in s:
            h = s["mesh_rank"]
            kernels[-1]["mesh_rank"] = {
                **{k: h[k] for k in timed}, "launches": kernels[-1]["mesh_launches"],
                "shape": h.get("shape") or (f"B={h['b']} KH={h['kv_heads']} G={h['group']} hd={h['hd']} "
                                            f"window={h['window']} append C={h['append_c']}")}
        if "hd64" in s:
            h = s["hd64"]
            kernels[-1]["hd64"] = {k: h[k] for k in timed + ("shape",)}
            kernels[-1]["hd64"]["spec_draft_launches"] = spec_hd64
        if "hd256" in s:
            kernels[-1]["hd256"] = {
                model: {**{k: h[k] for k in timed + ("shape",)},
                        "families_launches": family_launches[model]["contiguous"]["flash_hd_launches"][256]}
                for model, h in s["hd256"].items()}
        if "instances" in s:
            path = "contiguous" if name == "decode_attention" else "paged"
            kernels[-1]["instances"] = {
                model: {**{k: h[k] for k in timed + ("instance", "hd", "kv_heads", "group", "window")},
                        "families_launches": family_launches[model][path]["decode_instance_launches"][h["instance"]]
                        if path in family_launches[model] else None}
                for model, h in s["instances"].items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
