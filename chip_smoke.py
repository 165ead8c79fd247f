#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # the full run, on the first GPU

It imports nothing of JAX and nothing of the JAX package ``repro``.  In
order, it

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   kernels from the sources under ``src/repro_torch``, in a thread while
   the host builds the corpus, the index and the shard's host layout of
   step 2: one for each of the
   nine TPU kernels, kernels 8 and 9 each with a bf16 kernel on the tensor
   cores and an fp32 one on the CUDA cores, and the fit's four (a tree
   level's ``level_split`` and ``level_route``, the leaf means'
   ``level_histogram``, ``boost_update``);
2. builds the ``paper_200ms`` cascade at one shard of 196,608 docs (the
   per-chip shard of the paper's ISN deployment) on the card and on the
   CPU from one host layout of the shard (``postings.shard_layouts``, built
   once and copied to each device; ``hybrid_fusion``'s two systems of step
   5 take it too) and fits each on its own device (``SearchSystem.fit`` from 4,096
   queries, seed 5: three Stage-0 quantile GBRTs and the LTR GBRT, the
   routing thresholds from the 60th/75th percentiles of the predictions),
   the card's fit counted from 0 (``level_split`` and ``level_route`` the
   same count) and its ``level_histogram`` and ``boost_update`` calls
   recorded, and every 40th and the largest ``level_split`` and
   ``level_route`` call; requires the four forests (feat, thresh, leaf,
   base, bin edges) and ``t_k``/``t_time`` bit-equal, and prints both fit
   walls; then one small quantile GBRT fit with column and row sampling
   (``colsample`` 0.5, ``subsample`` 0.8; ``sampled_fit``) on the card and
   the CPU, bit-equal; then one card ``build_tree`` at depth 5 on the fit's
   largest level's inputs under ``torch.profiler``: at most 2 device
   kernels a level + 4, its tree bit-equal to the CPU's (``--profile``:
   one more card fit under the profiler, host time per fit stage);
3. serves one batch of 32 queries on both (the CPU runs the kernels'
   plain versions) and requires ``topk``, ``final`` and the modeled
   ``latency`` to be equal, while recording every kernel call's inputs;
4. per-query phase: runs the per-query Stage-1 path
   (``saat_serve_laxmap`` at two budgets, ``daat_serve_laxmap`` at two
   θ) over the same 32 queries on both systems' shards, counted from 0 on
   the card, and requires the card to equal the CPU and the batched
   engines (DAAT scores of the batched engine within 1e-4), recording the
   largest call of each of its three kernels; prints the wall time per
   query on the card;
5. builds the ``hybrid_fusion`` cascade (the dense Stage-1 modality) from
   the same index, on the card and on the CPU, with the models fitted on
   each (its Stage-0 and LTR specs and budget are ``paper_200ms``'s) and
   one two-tower model drawn from the spec's seed; where the
   preset's θ bands catch none of the calibration queries' top dense
   scores, sets them from quantiles of those scores; serves one batch of
   32 queries picked to reach the θ-skip and fallback branches on both
   and requires ``topk``, ``final``, ``latency`` and the per-query
   modality, θ-skip and fallback flags to be equal, recording the dense
   kernel's inputs;
6. kernel phase: runs each kernel on the recorded main-path inputs and on
   edge cases against its plain version on the card (the integer kernels,
   the dense top-k and the float sums of kernels 2, 3 and 5 exact;
   kernels 1, 2, 3, 6 and 7 also against their plain twins, exactly;
   kernels 6 and 7 on the edge cases of ``edge_calls`` and
   ``kernel7_edge_scores``: ties on the k-th key across tiles and blocks,
   1,500 of them at once, all-equal rows, k = N and 2,048, ragged
   lengths and rows of 400,000 (too long for kernel 7 to stage in shared
   memory); kernel 7 is one fused launch, ``histogram_select``,
   held on all three outputs, the histogram against ``score_histogram_ref``
   and the top-k against ``topk_from_histogram``; kernel 3
   also on a candidate whose matches overflow its records, duplicate
   candidates, C = 50 and 300, Q = 1 and all lanes dead; kernel 4, given
   each row's live length, also against its plain version without the
   lengths, and on full rows, empty rows and a call without lengths;
   kernel 5 also on hand-made bucketed layouts: -1 lanes inside rows, a
   full row and a residue, a residue under survive_t 0, one doc's 600
   lanes whose order changes the sum, tile_d 48, every tile empty;
   kernels 1 and 2 also on the live delta's shapes (``delta_edge_calls``:
   2 tiles at a lane capacity of 8,192, empty and one tile full) and
   kernel 6 at k = n = 256 and 300 over zero ghost rows) and
   times the kernel, its plain version and, where one exists, the
   library call with CUDA events; for the redesigned kernels (1–7 and 9)
   it logs the wrapper's time beside the device time of a call
   (``torch.profiler``) and the earlier design's time, for kernels 4, 6
   and 7 the device times of the kernel and of its library call (kernel 7:
   a stable ``torch.sort``, whose first k it checks against the kernel's
   on the recorded accumulator), and kernel 7's histogram alone beside
   ``torch.bincount``; the fit's level kernels against their plain
   versions (tolerance 0.0): ``level_histogram`` on a sample of the card
   fit's calls (the LTR's leaf means), the histograms of its largest level
   and edge cases (a constant feature, rows of weight 0, n off the tile,
   1 to 32 nodes, 256 bins), timed at that level beside the plain version,
   an fp32 ``index_add_`` (float atomics; how many of its sums differ from
   the ordered ones is logged) and the earlier design's time, and on the
   worst case (a constant feature at depth 0); ``level_split`` and
   ``level_route`` on the recorded calls and on ``level_split_edge_calls``
   (each of those edge cases as one tree, and ties across features, dead
   nodes, a one-feature mask, 64 trees x 32 nodes), each timed beside its
   plain version (no one library call computes either); and
   ``boost_update`` against its plain version;
7. serve phases: for each preset, sets the launch counts to 0, serves 8
   batches of 32 queries on the card and reads the counts: for
   ``paper_200ms`` both routes must take queries, Stage-2 must re-rank and
   its three kernels must have launched; for ``hybrid_fusion`` lexical,
   dense-only and fused rows must each occur and the dense kernel must
   have launched; prints the wall time per batch and the device memory;
8. tail phase: the BENCH_tail flow of ``benchmarks/bench_tail.py:43-130``
   (``tail_flow``: 8,192 docs, a system fitted from 256 queries with seed
   7, the raw tail, budgets at its 85th/70th/50th percentiles until the
   seed scheduler leaks through a BMW late hedge, the seed scheduler
   against the enforced one) on the card, counted from 0, and on the CPU;
   requires every figure equal on both, 0 over budget when enforced, a
   leak without, and identical ``topk``/``final``; logs each figure
   against ``results/BENCH_tail.json``, read at run time;
9. cli phase: the serving CLI (``repro_torch.launch.serve.run``) at the
   reference CLI's defaults on the card, counted from 0: ``paper_200ms``
   at 1 shard, 16,384 docs (vocab 8,192), 2,000 queries, the oracle labels
   (``LabelConfig(max_k=4096, batch=256)``, computed once on the host),
   the labelled fit and one serve of the whole trace; prints the
   ``[serve]`` lines, the walls of the labels, the fit and the serve and
   the launches of kernels 1-3, ``level_histogram`` and ``boost_update``
   (each must launch); then fits a CPU system from the same index, query
   log and labels and requires the four forests, the routing thresholds,
   the regressed cost model and the budget reservation bit-equal to the
   card's; serves the first 256 queries as their own call on the CPU and
   on a fresh card system with the card's fit (the CPU's plain kernels
   would take about 90 s for all 2,000) and requires ``topk``, ``final``,
   latency, routes and over-budget count equal; requires the CLI's
   ``--dryrun`` dict equal to a direct ``dryrun`` call on the same spec
   and corpus, a post-build dry run costed from the index, and a
   ``--spec-json`` spec that loads back equal to the one served;
10. predict phase (the paper's Stage-0 prediction framework, §4 and Table
   2) on the cli phase's index, query log, oracle labels and the Stage-0
   features of its 2,000 queries: ``cross_val_predict`` at the
   reference's defaults (10 folds, 64 trees; QR depth 5 at τ 0.5, RF
   depth 6, LR l2 1.0) of each method on the response-time target
   ``t_bmw`` on the card, the launch counts set to 0 before each method
   (QR must launch ``level_split``, ``level_route`` and ``boost_update``
   and no ``level_histogram``; RF ``level_split`` and ``level_route`` once
   a level for all 64 trees of a fit and ``level_histogram`` once a fit for
   their leaf means, no ``boost_update``); prints each method's
   ``regression_report``
   (tail quantile 0.95) as ``benchmarks/bench_predict_time.py`` renders
   it, and the walls; fits fold 0 of each method again on the CPU from
   the same rows and requires the QR and RF forests and predictions
   bit-equal to the card's and LR's within 1e-5 of max(1, |prediction|),
   and fits RF's fold 0 once more on the card with its level calls
   recorded (the forest equal; every call, 64 trees x up to 32 nodes,
   equal to its plain version);
   serves the first 256 queries on the card through ``HybridServer`` and
   ``CascadePipeline`` (with the LTR model; kernels 1-3 counted from 0,
   each must launch) and through systems built from the equivalent
   one-shard specs, requiring ``topk``, ``final`` and latency equal, and
   runs ``rerank_loop`` over the pipeline's Stage-1 candidates, requiring
   its ``final`` equal to the batched one;
11. online phase (``SearchSystem.serve_online``: seeded arrivals, the
   micro-batcher, the admission ladder; each dispatched batch padded to a
   power of two and served on the card): on step 2's shard with the card's
   fitted models and spec (``max_batch`` 32, deadline 5, admission and
   degrade on, routing adapted after every batch), (a) the capacity
   ``estimate_capacity`` measures on a ``fresh_probe`` (fresh serving
   state, the shard shared), (b) a poisson and a bursty trace of the fit
   log's first 512 queries at 0.8 x capacity, each on a fresh probe
   with the launch counts set to 0: 0 over the
   response budget, every served row's timing as the loop defines it
   (``wait == start - arrival``, ``completion == start + dispatch +
   service``, ``response == completion - arrival`` bit for bit; ``response``
   within 1e-12 of ``wait + dispatch + service``, the same sum grouped the
   other way), batches of at most 32, kernels 1-3 launched; it prints the
   modes, the response tail and the host wall a batch and a query.  Then
   on the cli phase's index, query log and models: (c) the baseline (no
   admission, ``max_batch`` 1) over a bursty trace of the first 256
   queries must go over the response budget and shed nothing; (d) a
   poisson trace of the first 128 queries on a fresh card system and on
   a CPU system: event log, ``response``, ``mode``, ``batch_of``,
   ``topk``, ``final`` and stats equal, at every padded width the batches
   took; (e) micro-batch parity with adaptation off, as
   ``benchmarks/bench_online.py:128-149``: the first 64 served queries
   served alone equal to their online rows (``topk``; ``final`` where
   served at full); (f) the 4-shard x 3-replica deployment with 5 units of
   gather a shard (the routing of ``tests/test_torch_online.py``'s fixture
   deployment: budget 100, ``late_rho`` 8,192, ``hedge_deadline`` 0.6, no
   adaptation): a batch with ``shard_cap`` cycling 1-4 equal on the card
   and the CPU (coverage and fault counters too), then a bursty trace of
   the first 128 queries at twice that deployment's capacity under a
   response budget of the full bound plus the shard bounds' spread: the
   partial-coverage rung must fire with 0 over budget and coverage below
   1, card = CPU;
12. cache phase (the two-level result cache, ``SearchSystem.serve`` through
   its cached path, ``cache_peek`` and the loop's cache branches) on the
   cli phase's index, query log and fit: (a) the ``cached`` preset against
   ``paper_200ms`` served cache-off over the first 256 queries: the cold
   serve equal (``topk``, ``final``; each row's stage-1 time the probe
   ``cache_hit_us`` more), the warm serve 256 L1 hits, bit-identical, each
   at ``predict_us + cache_hit_us``, with kernels 1-3 launched 0 times;
   (b) a serve at ``stage2_cap`` = ``k_serve`` / 2: 256 L2 hits, kernels 1
   and 2 launched 0 times and kernel 3 launched, ``final`` equal to the
   cache-off recompute at that cap; (c) ``cache_peek`` moves nothing (LRU
   order, counters, scheduler and pool stats); (d) disabled and
   zero-capacity specs build no cache and equal cache-off; (e)
   ``serve_online`` of the first 128 queries at Zipf skew 1.2 (poisson,
   0.8 x capacity) on the card and the CPU: event log, arrays, stats and
   cache contents equal, front-door hits, 0 over budget; (f) the
   BENCH_cache flow (``cache_flow``, ``benchmarks/bench_cache.py:62-206``)
   at a reduced size on the card, its gates required and its figures
   logged beside ``results/BENCH_cache.json``; (g) ``hybrid_fusion`` with
   the cache: the warm serve's L1 replay equal to the cold serve, kernel 6
   launched on the cold serve and no kernel on the warm one;
13. faults phase (``serving/faults``, the retry chain, the health probes)
   on the cli phase's index, query log and fit: the ``fault_tolerant``
   preset (4 partitions x 3 replicas, 4 units of merge a shard), (a) for
   each named schedule of ``fault_scenario`` sized to the trace, a
   poisson trace of the first 128 queries at 0.8 x capacity through
   ``serve_online`` on the card: 0 over the response budget, coverage at
   least the surviving fraction at each batch's dispatch, kernels 1-3
   launched, and the counters each schedule implies (retries, probes,
   transient timeouts, lost partitions); (b) ``timeout_storm`` and
   ``partition_outage`` on the CPU too: event log, arrays, stats,
   ``stats()`` and the injector's draws equal; (c) the empty schedule
   replays the fault-free run, and the armed failover equals the disarmed
   one offline; (d) the cache's fault epochs (a partition out over [0,
   50)): a result filled healthy never hits inside the outage, results
   inside it are never filled, and after it heals the cache refills and
   hits;
14. obs phase (telemetry: ``serving/telemetry``, the serve path's and
   the loop's hooks, ``snapshot``): (a) the observability gate's flow
   (``obs_flow``, ``benchmarks/obs_diff.py:197-276``) at its defaults on
   the card (4,096 docs, ``paper_200ms`` fitted from 256 queries with seed
   7, telemetry on, capacity from ``estimate_capacity``, one offline batch
   and a bursty trace at 0.7 x capacity, ``max_batch`` 8): its four gates
   (the snapshot clean against itself, an injected regression flagged,
   ``results/BENCH_obs_baseline.json`` present, read and never written,
   and no regression against it); (b) on the cli phase's index and fit, a
   telemetry-on system (snapshots every 20 units) on the card and on the
   CPU and a telemetry-off one on the card, over the first 64 queries
   offline and a bursty trace of the first 64 at 0.8 x capacity: the
   snapshot, the periodic snapshots and the Prometheus text equal on the
   card and the CPU (as dicts and as bytes), results, event logs and
   stats equal on and off, and kernels 1-3 launched as often on as off;
   (c) ``hybrid_fusion`` on and off: one batch equal, kernels 1-3 and 6
   launched as often;
15. ingest phase (live ingest: ``index/delta``, the delta segments of
   both engines and of the dense engine, ``add_documents``, ``merge``):
   (a) on the fit's 196,608-doc shard, ``live_ingest``'s delta (256 docs,
   8,192 postings) on the card and the CPU systems (the shared host
   layout, the fit's models), ``worst_case_us`` the delta-off bound plus
   ``delta_time(8192)``; 128 feed docs (``synthesize_feed_docs``) in
   batches of 16, after each a batch of 32 queries served on the card
   with the launch counts set to 0: kernel 1 launched once more a SAAT
   route and kernel 2 twice more a BMW route (its two scoring passes) for
   the delta segment, live candidates > 0, card = CPU on the last batch,
   the delta at its fullest (topk, final, latency), and that batch's
   delta-segment kernel calls against their plain versions; (b) the
   BENCH_ingest flow (``ingest_flow``,
   ``benchmarks/bench_ingest.py:74-212``) at its 4,096 docs, 128 queries
   and two loads on the card, every gate (post-merge bit parity against
   a from-scratch rebuild, the worst case covering the delta, the inert
   spec, 0 violations while feeding, feed applied), ``worst_case_on``
   266.2592, and its parity and accounting figures equal to the CPU's;
   (c) ``hybrid_fusion`` with the delta on the cli phase's
   index: 64 feed docs, 64 queries card = CPU (modality flags too),
   kernel 6 launched on the delta at k = n (against its plain version), no
   ghost row surfacing, and one merge clearing the delta;
16. isn phase (the distributed ISN step: ``isn/shard.hybrid_serve_fn``
   over ``launch/mesh.make_local_mesh``): (a) a (1, 1) mesh on the card
   (NCCL, world size 1) and the step at the production per-chip cell of
   ``configs/paper_isn.CONFIG`` on its 16 x 16 mesh (the fit's 196,608-doc
   shard, 256 queries of 8 terms, k_shard 1,024, ρ_max 131,072, the
   caps of ``build_serve_cell``, t_k 1,000, t_time 150; k_global cut to
   1,024) with the fit's three Stage-0 GBRTs as one ``ForestArrays``
   (their bin edges required equal), warmed once, then counted from 0:
   kernel 1 once and kernel 2 twice a block of 64 queries, each Stage-0
   kernel once, no other kernel, no plain version on CUDA tensors (Stage-0's
   calls recorded for step 16a); the step equal to
   ``saat_serve`` and ``daat_serve`` called directly with its routes and
   ρ (ids, scores, work, routes), JASS rows' work within ρ_max; Stage-0
   (pk, prho, pt) of the 256 queries and ``xla_expm1`` over 2.36 M values
   (both branches, every 4,099th bit pattern) on the card equal to the
   CPU's bit for bit; prints the route mix, the work, the step's wall
   (CUDA events) and the card line; (b) the step on the cli phase's index
   over its first 32 queries on the card and, on a gloo mesh, on the CPU
   with the CPU system's fit: ids, work and routes exact, scores within
   1e-4 (JASS rows exact), pk / prho / pt bit-equal; the process group
   ended at the phase's end;
16a. Stage-0 phase (``kernels/stage0``): each Stage-0 kernel against its
   plain version on the card, bit for bit (nan equal to nan), on the
   recorded calls of the card's fit (the features of its 4,096 queries),
   of step 7's ``paper_200ms`` serve (each batch one launch of each kernel,
   required) and of step 16's ISN step, and on the edge cases (one-term
   and all-padded rows, negative ids, ±0.0 statistics where the
   reference's max and min decide ties, float df across ``xla_log1p``'s
   small-|x| cut, every integer df below 2^19; 10 tree counts covering
   every ``_sum_trees`` branch at depths 3 to 5, per-model and shared
   edges, Q of 1, 32 and 256, features on an edge and NaN; predictions
   whose half flushes and around ``xla_expm1``'s 0.5 cut, and 2^20 seeded
   values and every 4,099th bit pattern through its ``xla_expm1``); times
   each kernel and its plain version on the ISN step's call and logs the
   cascade's and the fit's (``--only stage0``: this phase alone on a
   shard of ``--n-docs`` docs, with its own fit, ``--batches`` served
   batches and 4 ISN steps);
17. LM phase (Yi-6B, the prefill and KV-cache decode serving path), once
   the retrieval systems are freed:
   a. cross-check: a 2-layer Yi-6B at full width in fp32, drawn once on
      the host and copied to the card, runs ``prefill`` on 2 prompts of
      1,024 tokens and 8 greedy ``decode_step``s on the card (kernels) and
      the CPU (plain versions), recording every kernel call's inputs, and
      the card's 8 steps once more from the CPU's prefill cache and
      tokens.  Both sides sum in other orders, and the kernel scales the
      logits after the dot, the plain path q before it; under the
      reference's 1/√L weight scale the softmax is sharply peaked, so at
      a near-tie a rounding difference moves a whole row of the attention
      output.  Required: the final caches within 1e-3 of their largest
      magnitude at any element and 1e-5 of it on average; the last-token
      logits of the prefill, and of the steps from the same cache, within
      1e-4 of their largest magnitude; the steps from each device's own
      cache, which attend over those cache rows, within the caches' 1e-3;
      equal greedy tokens;
   b. serve: all 32 layers of Yi-6B in bf16 drawn on the card, a warm-up
      and then a counted pass of prefill (4 x 4,096 tokens) and 32 greedy
      decode steps on a 4,608-position cache, the launch counts set to 0
      before the counted pass; requires one ``flash_attention`` launch a
      layer and one ``flash_decode`` launch a layer and step, and finite
      logits; prints the prefill wall, the per-step decode walls, tokens
      per second and device memory;
   c. kernel rows: each of the two kernels against the plain path the
      model would take on the recorded calls (the serve warm-up's layer 0
      and the cross-check's calls), and against ``attention_ref`` /
      ``decode_ref`` on edge cases (ragged S and T, causal and not, GQA
      groups 1/3/4/8, head widths 16-128, fp32 and bf16, the bf16 kernel's
      tile edges S = 1, 127, 128, 129 and 4,097, kv_len 0, 1, 512, 513, T,
      decode GQA groups 1 to 32, the ``decode_32k`` cache of 8 x 32,768),
      every bf16 prefill output also against ``attention_tc_plain`` (the
      tensor-core kernel's arithmetic: 128 x 128 tiles, P as bf16 hi +
      lo), every decode output also against ``merge_splits`` of
      ``decode_partials_plain`` (the split and merge kernels' arithmetic)
      under the same tolerance, timed beside the
      plain path and ``scaled_dot_product_attention``; kernel 8's row is
      the bf16 kernel on the recorded bf16 call, with its TFLOP/s and
      share of the bound beside SDPA's on a line before, and the fp32
      kernel is timed on the largest fp32 recorded call on a line of its
      own; every fp32
      prefill call, recorded and edge, and the fp32 forward's tile edges
      (``f32_edge_calls``: Sq and Sk of 1, 15, 16, 17, 255, 256, 257 at D
      16 and 32 causal and not, S of 63 to 129 around a 64-key tile and a
      128-row block, views whose rows are off a 16-byte boundary, and
      BERT4Rec's training call with the log-sum-exp) also launched twice
      with the same bits and held to ``attention_ref`` and
      ``attention_f32_tiles_plain`` (the fp32 kernel's arithmetic: its
      query tiles and 32-key softmax steps) by ``f32_check``, the
      log-sum-exp within ``BWD_F32_TOL`` of max(1, |want|).  Tolerances:
      fp32
      1e-5 absolute on the edge cases, 5e-3 of the largest output (and
      1e-5 of it on average) on the recorded fp32 model calls (the same
      near-ties); bf16 2e-2 absolute below magnitude 1 and 2e-2 relative
      above it (a one-ulp rounding flip is 2^-8 to 2^-7 relative);
18. MoE and MLA phase (``models/moe``, ``mla_*``, the MoE and MLA branches
   of ``models/transformer``), once Yi-6B's memory is freed, for
   granite-MoE 3B-A800M (40 experts, top-8; GQA of 24 query heads over 8
   kv heads, D 64), Moonlight-16B-A3B (``moonshot_v1_16b_a3b``: 64 experts,
   top-6, 2 shared experts; D 128) and MiniCPM3-4B (MLA: q/k width 64 + 32,
   v width 64, a latent cache of 256 + 32 a position):
   a. cross-check: each at full width, 2 layers, fp32, drawn once on the
      card with each layer matrix at 1/√(its fan-in) and copied to the
      host, ``prefill`` of 2 prompts of 256 tokens and 4 greedy
      ``decode_step``s on the card and the CPU, as in 17a and under its
      tolerances; for the MoE models also the experts and the capacity
      drops of every token in layer 0 of the prefill equal on both, with
      the smallest gap between a token's k-th and (k+1)-th gate logged;
      every kernel call recorded.  The reference's 1/√L weight scale
      (which ``init`` keeps) gives attention logits of spread d_model /
      L: 768 for granite at L = 2, 48 at its 32 layers.  Such a
      near-argmax softmax turns the card's and the CPU's fp32 rounding of
      q (~1e-6) into logit errors of 1e-4 to 1e-2 wherever a row's top two
      keys nearly tie, past 17a's tolerances at either depth; at
      1/√(fan-in) the logits are O(1), as in a trained model, and the
      comparison measures the port's arithmetic;
   b. serve: each in bf16 drawn on the card, granite's 32 layers (≈ 3.4 B
      parameters), MiniCPM3's 62 (≈ 4.3 B) and 12 of Moonlight's 48 (≈ 7.7
      B: all 48 would be ≈ 57.8 GB of weights; its 64 experts, 2 shared
      experts and 163,840-token vocabulary kept), a warm-up and then a
      counted pass of prefill (4 x 1,024 tokens) and 8 greedy steps:
      finite logits, ``flash_attention`` once a layer, ``flash_decode``
      once a layer and step for the MoE models and never for MiniCPM3
      (its decode is the reference's absorbed form in torch products);
      prints the prefill wall, the step walls and device memory;
   c. kernel rows: every recorded call of a and b against the model's
      plain path (bf16 also against ``attention_tc_plain``, decode also
      against ``merge_splits``), kernel 8 at MLA's width pair on the edge
      cases of ``mla_edge_calls`` against ``attention_ref`` (S = 1, 127,
      128, 129, 700 and 4,097 causal and not, Sq != Sk, Hkv = H and GQA
      groups of 4, fp32 and bf16, the strided views ``mla_forward``
      passes), under the tolerances of 17c (every fp32 call also through
      ``f32_check``), and the largest bf16 MLA call
      timed beside the plain path and SDPA, with its TFLOP/s and share of
      the bound on a line of its own (the ``kernels`` line keeps kernel 8's
      Yi-6B row);
19. train phase (LM training: ``forward_hidden`` and ``loss_fn`` of
   ``models/transformer``, ``train/*``, ``data/*``, kernel 8's backward),
   once the served models are freed:
   a. card = CPU: Yi-6B, granite-MoE and MiniCPM3 at full width, 2 layers,
      fp32, ``remat="full"``, drawn once on the card at 1/√(fan-in) and
      copied to the host; on each, the loss and gradients of 2 x 64 tokens
      from ``lm_batches`` (``train_loop.value_and_grad``), one AdamW step
      (``optimizer.apply`` at the peak lr: warm-up 1 step) and the loss of
      the next 2 x 64 tokens after it: both losses and the grad norm within
      1e-5 (relative), every gradient leaf within 1e-4 of its largest
      magnitude on the CPU, the MoE model's layer-0 experts and capacity
      drops equal; the card's kernel-8 backward call recorded;
   b. full width: Yi-6B in bf16 at its published widths, 8 of its 32
      layers (32 layers' parameters, grads and fp32 moments alone would
      be ≈ 72.7 GB), ``remat="full"``, three ``make_train_step`` steps of
      2 x 4,096 tokens from ``lm_batches`` through ``PrefetchingLoader``,
      counted from 0: kernel 8's forward twice a layer and step (the
      forward, then its recomputation), its backward once, no decode;
      finite losses and grad norms, the parameters moved; prints each
      step's wall (CUDA events), tokens a second and peak memory;
   c. the loop: ``train_loop.run`` at Yi-6B's REDUCED size on the card,
      checkpoints every 5 of 12 steps in a temporary directory, a crash at
      step 7, then a resume from step 5 (data from
      ``data_cursor_after_restart``) to the end: its losses within 1e-5 of
      the same steps of an uninterrupted run;
   d. kernel 8's backward row: the recorded calls of a and b and edge
      cases at every built width pair in fp32 and bf16 (GQA groups 1, 3
      and 8, causal and not, ragged S 1, 129, 200, 300 and 1,000, and
      Yi-6B's training call (2, 32, 4,096, 128) causal in bf16 with a
      unit-scale dO) against ``flash_attention_backward_plain`` on dq, dk
      and dv, each of its largest magnitude (a floor of 1e-2 of the largest
      of the three, for the gradients that are 0 at S = 1; fp32 within
      1e-4, bf16 within ``BF16_TOL``), every call launched twice with the
      same bits, the forward's log-sum-exp against ``attention_ref``'s, the
      forward of every fp32 call through ``f32_check``;
      the bf16 Yi-6B call timed beside the plain
      version and ``scaled_dot_product_attention``'s backward (k and v
      repeated to every head outside the timed call), with its TFLOP/s and
      share of the bound, and the fp32 kernel on the fp32 call on a line
      of its own; and the bf16 rounding of P and dS that the kernel takes
      (``flash_attention_backward_tc_plain`` at halves 1 and 2 on every
      bf16 call, ``bwd_measure``'s error against the plain version);
20. recsys_gnn phase (``models/{recsys,gnn,embedding}``: the four recsys
   heads and DimeNet), once the LM is freed:
   a. card = CPU: DeepFM, xDeepFM, the two-tower model (32 a batch) and
      DimeNet (128 molecules of 30 nodes and 64 edges) at REDUCED, and
      BERT4Rec at its CONFIG widths (d 64, 2 heads of 32, 2 blocks, 200
      positions) with n_items cut to 4,096 and 8 histories (REDUCED's head
      width 8 is one kernel 8 is not built for, ROADMAP §3 open 2), in
      fp32, drawn once on the card and copied to the host (BERT4Rec's
      block matrices at 1/√(fan-in), ``fan_in_scale``: at the reference's
      1/√n_blocks fp32 alone puts its gradients 6.1e-05 to 3.4e-04 of a
      leaf's largest from fp64, past the bar, ROADMAP §3 open 12): the
      loss and gradients of one batch, one AdamW step at the peak lr, the
      loss after it, under 19a's tolerances; kernel 8 and its backward
      launched once a block for BERT4Rec, no kernel for the others; for
      BERT4Rec each attention call's softmax rows logged (the row's
      largest logit and its gap to the second); ``neighbor_sample``
      (1,024 seeds, fanouts 15 and 10) and ``build_triplets`` (2 a sampled
      edge) over a synthetic graph of Reddit's 232,965 nodes and mean
      degree 492 (a (232,965, 512) int32 padded adjacency drawn on the
      card) on the card and the CPU from one key, bit-equal; the repeat
      check (``rg_repeat``): a DimeNet ``value_and_grad`` at CONFIG on
      the molecule batch and on minibatch_lg's sample, and a ragged
      EmbeddingBag of 65,536 bags of 40 rows of a 1,000,000 x 64 table
      forward and backward, each run twice on the card with the loss or
      output and every gradient bit-equal (their segment sums sort once and
      sum in row order; the ``index_add_`` they replaced is run twice
      beside them and its differing sums logged);
   b. serve paths, each counted from 0: the two-tower model at CONFIG
      (8,000,000 users, 2,000,000 items, towers 1,024-512-256): the item
      tower over 2,000,000 synthetic items as the candidates, 512 users'
      towers into ``streaming_topk`` (kernel 6, k 100: one launch), and
      ``anytime_retrieval`` of one user over the first 1,000,448
      candidates at k 1,000 and budgets 1,000,448, 131,072 and 500 (one
      launch each); BERT4Rec at CONFIG (1,000,000 items; the reference's
      init here and in c): 512 histories of 200 through
      ``bert4rec_hidden`` (kernel 8 fp32, one launch a block)
      and the last position into ``streaming_topk`` over the 1,000,192
      item rows (one launch).  Kernel 6 on each recorded call against
      ``dense_topk_plain`` (in chunks of 64 queries) on these unquantized
      embeddings: scores within 1e-5 of max(1, |want|), ids equal except
      between near-tied scores (counted and logged); on the edge calls
      (k > n with its (-inf, 0) fill, 777 candidates, budget 0 with no
      launch); timed beside the plain version and ``torch.topk(q @ embᵀ,
      k)``.  Kernel 8's fp32 kernel on BERT4Rec's serve call (512, 2, 200,
      32) non-causal against ``chunked_attention_plain`` (within 1e-4 of
      the largest |want|) and through ``f32_check`` (the same bar), timed
      beside the plain path and SDPA;
   c. full-width training steps (``train_loop.value_and_grad`` and
      ``optimizer.apply`` with the buffers donated), 2 each, counted from
      0, at each model's CONFIG: DeepFM at its published batch of 65,536;
      xDeepFM at 8,192 (the CIN's (B, 200, 39, 10) fp32 product is 20.4 GB
      a layer at 65,536); the two-tower model at 16,384 (parameters,
      gradients and moments take ≈ 41 GB, the (B, B) logits 17.2 GB at
      65,536); BERT4Rec at 4,096 histories of 200, 8 masked, 2,048
      candidates (an FFN activation is 13.4 GB at 65,536): kernel 8 and its
      backward once a block and step, the recorded training call (4,096,
      2, 200, 32) held to the plain versions (the forward also through
      ``f32_check``, the backward by ``bwd_check``), the forward with its
      log-sum-exp timed beside SDPA and the backward beside SDPA's
      backward; DimeNet on 128
      molecules and on minibatch_lg's sample (d_feat 602: 168,960 edges,
      337,920 triplets), its block matrices at 1/√(fan-in) (at the
      reference's 1/√6 the loss overflows, ROADMAP §3 open 11); each step's
      wall (CUDA events), peak memory and
      launches logged; the phase's wall and launches logged;
21. mesh phase (the model code under a mesh: ``launch/mesh.mesh_context``
   over ``make_local_mesh``'s (1, 1) mesh, NCCL at world size 1): (a)
   granite-MoE at CONFIG widths in bf16, at the MoE and MLA phase's depth
   (32 layers), the prefill of 4 x 1,024 tokens under the mesh (its MoE
   through the expert-parallel branch, the ``prefill_32k`` rules) equal
   bit for bit to the prefill without one (logits and cache), counted
   from 0: ``flash_attention`` once a layer; (b) ``reshard_tree`` of that
   tree under ``rules_for("lm", LM_SHAPES["train_4k"])``, every local
   shard equal to its leaf, and a ``restore_latest(shardings=)`` round
   trip of its first ``MESH_RESTORE_LAYERS`` layer with the embeddings
   (every kind of leaf; the 32 layers' 6.8 GB would spend a minute on
   disk and sha1 work), every restored shard a DTensor equal to its
   leaf; (c) step 20b's two-tower serve (the
   same user towers and candidates) through ``sharded_streaming_topk``:
   its ids equal ``streaming_topk``'s, kernel 6 launched once; (d)
   ``sharded_lookup_manual`` over the candidate rows equal to
   ``table[ids]``; (e) DimeNet at CONFIG (1/√(fan-in) blocks) on the
   molecule batch, one rank holding every edge: ``loss_fn_partitioned``'s
   loss within 1e-5 and every gradient leaf within 1e-4 of its largest
   of ``loss_fn``'s; (f) granite-MoE's training step at that depth on the
   train phase's 2 x 64 batch (``lm_batches``), its MoE through the mesh
   branch and its backward: the loss and every gradient leaf under the
   mesh equal bit for bit to those without one, counted from 0: kernel 8
   and its backward launched; the process group ended at the phase's end;
22. cells phase (the dry-run cells, ``launch/steps.build_cell``, on a
   (1, 1) NCCL mesh, under ``mesh_context``): (a) Yi-6B x ``decode_32k``
   at CONFIG widths cut to ``CELLS_DECODE_LAYERS`` layers, the cell's own
   batch 128 and cache 32,768 (bf16, every sequence at kv_len 32,767):
   one step of ``Cell.fn`` equal bit for bit to ``decode_step`` called
   directly on a copy of the same arrays, counted: kernel 9 once a layer;
   the dry run of the same cell on the (1, 1) mesh
   (``dryrun.measure``: fake tensors on the card's device type, nothing
   launched) giving the real arguments' bytes and the FLOPs that
   ``dryrun.RankCounter`` counts on the real step; its modeled peak
   logged beside the step's ``max_memory_allocated``; (b) BERT4Rec x
   ``serve_p99`` at CONFIG on step 20b's parameters and histories (not
   drawn again): its ids equal the serve's, kernel 8 (fp32) once a block
   and kernel 6 once; (c) DimeNet x ``molecule`` at CONFIG (1/√(fan-in)
   blocks), the train cell through the partitioned loss against the same
   cell with ``partition_gnn`` off on the same batch: the loss within
   1e-5, the AdamW moments within 1e-4 of each leaf's largest, the
   parameters within 2.2 lr (the first step moves an entry by about lr ·
   sign(g));
23. prints the total elapsed time, the ``kernels`` JSON line (thirteen
    rows: the nine TPU kernels, kernel 8's backward, ``level_histogram``,
    ``level_split`` and ``level_route``, the fit's launches of step 2;
    the launches of kernels 1-3 are step 7's, the
    backward's step 19b's; the library time of kernels 1 and 2 an
    ``index_add_`` over the (query, lane) pairs each adds; step 20's rows
    of kernels 6 and 8 are logged lines), then the card line, then the
    result.

Any failed check exits non-zero without the result line.  ``--n-docs``
and ``--batches`` shrink the retrieval phases for a quick check,
``--lm-layers``, ``--lm-prompt`` and ``--lm-steps`` the LM phase (and,
below their defaults, the MoE and MLA phase: each model at most
``--lm-layers`` layers, prompts and steps at most those given; and the
train phase's full-width run: at most ``--lm-layers`` layers and
``--lm-prompt`` tokens a sequence);
``--profile`` adds a ``torch.profiler`` breakdown (wall, device busy time,
busiest device kernels) of one more LM prefill and decode step; the serve
path's is ``portbench/``'s traced runs and the port's own spans
(``repro_torch.serving.telemetry.host``).
``--only train``, ``--only recsys_gnn``, ``--only mesh`` and ``--only
cells`` build the kernels and run step 19, 20, 21 or 22 alone (the mesh
phase then draws the two-tower serve's inputs itself, the cells phase
BERT4Rec's parameters and histories), and print no result; ``--only fit``
builds the shard beside the kernels and runs step 2 and the fit's kernel
rows of step 6 (with ``--profile``, step 2's profiled fit), ``--only
predict`` the CLI's labelled fit of step 9 and then step 10.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device-memory rate
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 rate outside the tensor cores
# H100 SXM dense bf16 tensor-core rate: the least time for attention on
# bf16 inputs (fp32 inputs are held to the fp32 rate: no TF32, ROADMAP
# rule b)
BF16_FLOPS_PER_S = 989e12
# H100 SXM int32 rate: the published 67 TFLOP/s fp32 is 132 SMs x 128 fp32
# lanes x 2 (an FMA) x 1.98 GHz; an SM issues 64 int32 operations a clock,
# a quarter of that.  The kernels' work is int32 compares.
INT32_OPS_PER_S = 67e12 / 4
SEED = 20171003
BATCH = 32
REPS = 20                     # timed runs of each kernel (median)
DEVICE = "cuda"

KERNELS = {
    "impact_accumulate_batched": dict(
        source="src/repro_torch/kernels/impact_accumulate/impact_accumulate.cu",
        replaces="src/repro/kernels/impact_accumulate/kernel.py:79"),
    "blockmax_score_batched": dict(
        source="src/repro_torch/kernels/blockmax_score/blockmax_score.cu",
        replaces="src/repro/kernels/blockmax_score/kernel.py:104"),
    "qd_feature_gather_lanes": dict(
        source="src/repro_torch/kernels/qd_feature_gather/qd_feature_gather.cu",
        replaces="src/repro/kernels/qd_feature_gather/kernel.py:67"),
    "dense_topk_tiles": dict(
        source="src/repro_torch/kernels/dense_topk/dense_topk.cu",
        replaces="src/repro/kernels/dense_topk/kernel.py:61"),
    "impact_accumulate_bucketed": dict(
        source="src/repro_torch/kernels/impact_accumulate/impact_accumulate.cu",
        replaces="src/repro/kernels/impact_accumulate/kernel.py:113"),
    "blockmax_score_bucketed": dict(
        source="src/repro_torch/kernels/blockmax_score/blockmax_score.cu",
        replaces="src/repro/kernels/blockmax_score/kernel.py:143"),
    "score_histogram": dict(
        source="src/repro_torch/kernels/score_histogram/score_histogram.cu",
        replaces="src/repro/kernels/score_histogram/kernel.py:47"),
    # the row reports the bf16 kernel on the recorded bf16 call; the fp32
    # kernel of flash_attention.cu is checked and timed on its own line
    "flash_attention": dict(
        source="src/repro_torch/kernels/flash_attention/"
               "flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:77"),
    "flash_decode": dict(
        source="src/repro_torch/kernels/flash_attention/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:136"),
    # training's backward of kernel 8: the reference differentiates its
    # jnp chunked_attention (no Pallas backward kernel)
    "flash_attention_backward": dict(
        source="src/repro_torch/kernels/flash_attention/"
               "flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:77 (its "
                 "backward: jax.grad of src/repro/models/attention.py:35 "
                 "chunked_attention; no Pallas kernel)"),
    # the fit's split histograms: no TPU kernel, but a float scatter-add
    # whose order the card must keep (ROADMAP rule d)
    "level_histogram": dict(
        source="src/repro_torch/kernels/level_histogram/level_histogram.cu",
        replaces="src/repro/core/trees.py:69 (jax.ops.segment_sum; no "
                 "Pallas kernel)"),
    # the rest of a tree level: the split choice and the rows' routing
    # (jnp ops inside the reference's jit; no Pallas kernel)
    "level_split": dict(
        source="src/repro_torch/kernels/level_histogram/level_histogram.cu",
        replaces="src/repro/core/trees.py:102 (build_tree: the histograms, "
                 "cumsum, gain, masks and argmax of a level; no Pallas "
                 "kernel)"),
    "level_route": dict(
        source="src/repro_torch/kernels/level_histogram/level_histogram.cu",
        replaces="src/repro/core/trees.py:115 (build_tree: the dead rule "
                 "and the rows' new nodes; no Pallas kernel)"),
    # Stage-0: jnp ops inside the reference's jit (no Pallas kernel)
    "stage0_features": dict(
        source="src/repro_torch/kernels/stage0/stage0.cu",
        replaces="src/repro/core/features.py:36 (extract; no Pallas "
                 "kernel)"),
    "stage0_forest": dict(
        source="src/repro_torch/kernels/stage0/stage0.cu",
        replaces="src/repro/core/gbrt.py:134 (predict_stacked) and "
                 "src/repro/isn/shard.py:55 (_forest_predict with expm1; no "
                 "Pallas kernel)"),
}
# the kernels of the per-query Stage-1 path (saat/daat_serve_laxmap), and
# those of the two served cascades
LAXMAP_KERNELS = ("impact_accumulate_bucketed", "blockmax_score_bucketed",
                  "score_histogram")
LM_KERNELS = ("flash_attention", "flash_decode")
FIT_KERNELS = ("level_histogram", "boost_update", "level_split",
               "level_route")
# the fit's level calls checked on the card: every FIT_SAMPLE-th and the
# largest (recorded as copies: a level updates the node ids in place)
FIT_SAMPLE = 40
LEVEL_KERNELS = ("level_split", "level_route")
# device kernels of one card build_tree besides its two a level (the node
# ids, feat and thresh zeroed)
TREE_FIXED_KERNELS = 4
TREE_DEPTH = 5
TRAIN_KERNELS = ("flash_attention", "flash_attention_backward")
# Stage-0's two kernels (features; the stacked forests), checked on the
# recorded calls of the fits and serves and on STAGE0 edge cases: tree counts
# over every _sum_trees branch, depths, batch sizes, and the xla_expm1 sweep
# (random values and every STAGE0["expm1_stride"]-th bit pattern) and the
# one-term queries over every integer df below STAGE0["log1p_ints"]
STAGE0_KERNELS = ("stage0_features", "stage0_forest")
STAGE0 = dict(trees=(1, 8, 12, 16, 24, 32, 33, 48, 64, 100),
              depths=(3, 4, 5), queries=(1, 32, 256), log1p_ints=1 << 19,
              expm1_stride=4099, expm1_models=8192, isn_steps=4)
# kernels 1 and 2 (one block per tile and query group over the shard's
# mirror) and 3 (one cluster per query, match records), and the plain twins
# of their arithmetic, in the same modules
BATCHED = ("impact_accumulate_batched", "blockmax_score_batched")
TWINS = {"impact_accumulate_batched": "impact_accumulate_grouped",
         "blockmax_score_batched": "blockmax_score_grouped",
         "qd_feature_gather_lanes": "qd_feature_gather_recorded",
         "dense_topk_tiles": "dense_topk_selected",
         "score_histogram": "histogram_topk_selected"}
# the wrapper that launches a kernel, where it is not named after it: kernel
# 7 is one fused launch, histogram_select(scores, k, n_bins) (k = 0 for the
# histogram alone), behind score_histogram and histogram_topk
WRAPPERS = {"score_histogram": "histogram_select"}
SERVE_KERNELS = tuple(n for n in KERNELS
                      if n not in LAXMAP_KERNELS + LM_KERNELS + FIT_KERNELS
                      + TRAIN_KERNELS + STAGE0_KERNELS)
RETRIEVAL_KERNELS = SERVE_KERNELS + LAXMAP_KERNELS

# LM phase (Yi-6B)
XC_PROMPTS, XC_LEN, XC_STEPS = 2, 1024, 8     # card-vs-CPU cross-check
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 4096, 32   # the bf16 serve
DECODE_ROOM = 512             # cache positions past the prompt (4,608)
XC_LOGIT_TOL = 1e-4           # of the largest |logit|, from one cache
XC_CACHE_TOL, XC_CACHE_MEAN_TOL = 1e-3, 1e-5  # of the largest |cache|
MODEL_F32_TOL = 5e-3          # of the largest |output|, recorded fp32 calls
# Sq and Sk at the fp32 forward's tile edges (16-row warps, 128-row blocks,
# 32-key steps, 64-key tiles at widths up to 32; ops.f32_forward_tiles)
F32_TILE_EDGES = (1, 15, 16, 17, 255, 256, 257)
BF16_TOL = 2e-2               # below magnitude 1 absolute, above relative
# MoE and MLA phase: granite-MoE (GQA, 24 heads over 8, D 64), Moonlight
# (MHA, D 128, 2 shared experts), MiniCPM3 (MLA: q/k 96, v 64); the fp32
# cross-check's prompt length and steps (2 prompts, 2 layers), the bf16
# serve's (LM_BATCH prompts), and the layers served: all of granite's and
# MiniCPM3's, 12 of Moonlight's 48 (48 would be ≈ 57.8 GB of weights)
MOE_MLA_CONFIGS = ("granite_moe_3b_a800m", "moonshot_v1_16b_a3b",
                   "minicpm3_4b")
MM_XC_LEN, MM_XC_STEPS = 256, 4
MM_PROMPT, MM_STEPS = 1024, 8
MM_LAYERS = {"granite_moe_3b_a800m": 32, "moonshot_v1_16b_a3b": 12,
             "minicpm3_4b": 62}
# train phase: the fp32 card-vs-CPU steps (2 layers at full width, batch x
# sequence, steps) of three configurations, the bf16 Yi-6B steps (layers,
# batch, sequence, steps: 8 of 32 layers, as 32 layers' parameters, grads
# and fp32 moments alone would be ≈ 72.7 GB), the crash-resume loop at
# REDUCED size, and the tolerances: the card's fp32 losses and grad norms
# against the CPU's (relative) and its gradients (of each leaf's largest
# magnitude); the backward kernel against its plain version in fp32, of
# each gradient's largest magnitude (bf16: BF16_TOL), that magnitude
# floored at BWD_FLOOR of the largest of dq, dk and dv
TRAIN_XC_CONFIGS = ("yi_6b", "granite_moe_3b_a800m", "minicpm3_4b")
TRAIN_XC = dict(batch=2, seq=64)
TRAIN_FULL = dict(layers=8, batch=2, seq=4096, steps=3)
TRAIN_LOOP = dict(steps=12, ckpt_every=5, fail_at=7, batch=4, seq=64)
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
BWD_F32_TOL = 1e-4
BWD_FLOOR = 1e-2
# recsys_gnn phase: the card-vs-CPU checks (REDUCED; BERT4Rec at CONFIG
# widths with n_items cut to 4,096 and 8 histories) and their batch; the
# serve calls (512 queries, k 100; anytime_retrieval over 1,000,448
# candidates at k 1,000 and three budgets); the full-width steps' batches
# (module docstring, 20c: xDeepFM, two-tower and BERT4Rec cut for memory);
# the synthetic Reddit-sized graph of minibatch_lg and the molecule batch;
# kernel 6's bar on unquantized embeddings (of max(1, |want|)) and kernel
# 8's fp32 bar on the model calls (of the largest |want|)
RG_HEADS = ("deepfm", "xdeepfm", "two_tower_retrieval", "bert4rec")
RG_XC = dict(batch=32, bert_items=4096, bert_batch=8)
RG_SERVE = dict(queries=512, k=100, chunk=64)
RG_ANYTIME = dict(n=1_000_448, k=1000, budgets=(1_000_448, 131_072, 500))
RG_STEP_BATCH = {"deepfm": 65_536, "xdeepfm": 8_192,
                 "two_tower_retrieval": 16_384, "bert4rec": 4_096}
RG_BERT = dict(n_masked=8, xc_cands=256, cands=2048)
RG_STEPS = 2
RG_BAG = dict(rows=1_000_000, dim=64, bags=65_536, per_bag=40)
MESH_RESTORE_LAYERS = 1       # granite layers saved and restored (of 32)
CELLS_DECODE_LAYERS = 2       # Yi-6B layers of the decode_32k cell
MESH_LOOKUP = (512, 16)       # ids of the lookup over the candidate rows
RG_GRAPH = dict(n_nodes=232_965, max_deg=512, min_deg=472, d_feat=602,
                seeds=1024, fanouts=(15, 10), trip=2)
RG_MOLECULE = dict(graphs=128, nodes=30, edges=64, trip=4)
RG_TOPK_TOL = 1e-5
RG_F32_TOL = 1e-4
# fit phase: the query log the systems are fitted from, and the fit's seed
FIT_QUERIES, FIT_SEED = 4096, 5
# cli phase: the serving CLI at the reference CLI's defaults (paper_200ms,
# 1 shard, 16,384 docs, vocab 8,192, 2,000 queries, oracle labels), its
# kernels, and the queries of its card-vs-CPU serve (the CPU's plain
# kernels serve 2,000 queries in about 90 s, past the run's time)
CASCADE_KERNELS = ("impact_accumulate_batched", "blockmax_score_batched",
                   "qd_feature_gather_lanes")
CLI_KERNELS = CASCADE_KERNELS + FIT_KERNELS
CLI_CROSS = 256
# predict phase: the Stage-0 prediction framework at the reference's
# defaults on the cli phase's run, its Table 2 columns, the tolerance of
# the ridge model's card-vs-CPU predictions (of max(1, |prediction|))
PREDICT_METHODS = ("qr", "rf", "lr")
PREDICT_TAIL = 0.95
REPORT_COLUMNS = ("rmse", "precision", "recall", "f1", "macro_precision",
                  "macro_recall", "macro_f1", "auc")
LR_TOL = 1e-5
# online phase: the serving loop (SearchSystem.serve_online) on the fit's
# shard (the first ONLINE_QUERIES queries of the fit's log a trace, at
# ONLINE_LOAD x capacity, TrafficSpec seed ONLINE_SEED), then on the cli
# phase's index: the baseline and the parity run over its first
# ONLINE_CROSS queries, card = CPU over the first ONLINE_CPU, the
# partial-coverage runs over the first PARTIAL_CROSS, micro-batch parity
# over the first ONLINE_PARITY served queries.  ONLINE_QUERIES and
# ONLINE_CPU are cut from 1,024 and 256 to keep the run near 300 s.  The partial-coverage system
# takes the routing of the reference's 4 x 3 fixture deployment: its shard
# bounds shrink with the shard count only under a 100-unit budget (at 200
# the late-hedge chain stays under the budget and every bound is the
# budget's) and with the hedge deadline fixed (adaptation lowers it until
# the bounds are the budget's again)
ONLINE_QUERIES, ONLINE_CROSS, ONLINE_CPU = 512, 256, 128
ONLINE_PARITY, PARTIAL_CROSS = 64, 128
ONLINE_LOAD, ONLINE_SEED = 0.8, 8
PARTIAL_DEPLOY = dict(n_shards=4, replicas=3)
PARTIAL_ROUTING = dict(budget=100.0, late_rho=8192, hedge_deadline=0.6,
                       adapt_every=0)
PARTIAL_GATHER_US = 5.0
PARTIAL_OVERLOAD = 2.0        # offered load / capacity of the overload trace
# the BENCH_online flow's figures (benchmarks/bench_online.py:36-187)
ONLINE_FIGURES = ("capacity_qps", "response_budget", "worst_case_bound",
                  "guarantee_holds", "regression_demonstrated", "rows",
                  "parity")
# cache phase: the first CACHE_CROSS queries of the cli phase's log offline,
# the first CACHE_ONLINE online at Zipf skew CACHE_SKEW (card = CPU), and
# the BENCH_cache flow at CACHE_FLOW (cut from 384 queries, three skews and
# ten loads: each cached arrival's front-door peek runs Stage-0 on the card
# at Q = 1, about 20 ms of host wall, so at 192 queries and seven loads the
# flow alone took 26.8 s); faults phase: the fault_tolerant
# preset with FAULT_GATHER_US of merge a shard (bench_faults' 4.0), traces
# of the first FAULT_QUERIES queries, the epoch check over the first
# FAULT_EPOCH_QUERIES
CACHE_CROSS, CACHE_ONLINE, CACHE_SKEW = 256, 128, 1.2
CACHE_FLOW = dict(q_batch=96, skews=(0.0, 1.2), loads_off=(0.8, 1.2, 2.0),
                  loads_on=(1.5, 3.0))
CACHE_ARTIFACT = ROOT / "results" / "BENCH_cache.json"
FAULT_GATHER_US, FAULT_QUERIES, FAULT_EPOCH_QUERIES = 4.0, 128, 64
# the BENCH_cache and BENCH_faults flows' figures
# (benchmarks/bench_cache.py:62-206, bench_faults.py:94-212)
CACHE_FIGURES = ("parity", "capacity_off_qps", "inert", "sweep", "grid",
                 "certified_qps", "hit_ratio_at_hot_skew", "gates")
FAULT_FIGURES = ("rows", "capacity_qps", "response_budget",
                 "worst_case_bound", "guarantee_holds", "coverage_certified",
                 "inert_replay_identical", "inert_offline_identical",
                 "faults_demonstrated")
# ingest phase: (a) on the fit's shard, live_ingest's delta (256 docs,
# 8,192 postings) fed INGEST_FEED docs of synthesize_feed_docs(seed
# INGEST_SEED) in batches of INGEST_FEED_BATCH, a batch of 32 queries served
# after each, card = CPU on the batches INGEST_CHECKED (a CPU serve of the
# 196,608-doc shard with the delta takes about 8 s: the last batch only,
# the delta full); (b) the BENCH_ingest flow at INGEST_FLOW
# (benchmarks/bench_ingest.py:74-212 at its 4,096 docs; cut from 384
# queries and three loads for time) on the card, its parity and accounting
# parts also on the CPU (the CPU's plain kernels over the delta's
# 8,192-lane tiles would take most of the phase on the online parts);
# (c) hybrid_fusion with the delta on the cli phase's index over its first
# INGEST_DENSE queries, fed INGEST_DENSE_FEED docs
INGEST_FEED, INGEST_FEED_BATCH, INGEST_SEED = 128, 16, 10
INGEST_CHECKED = (7,)
INGEST_FLOW = dict(q_batch=128, n_docs=4096, loads=(0.5, 0.8))
INGEST_DENSE, INGEST_DENSE_FEED = 64, 64
INGEST_ARTIFACT = ROOT / "results" / "BENCH_ingest.json"
# the BENCH_ingest flow's figures (benchmarks/bench_ingest.py:74-212)
INGEST_FIGURES = ("parity", "capacity_qps", "accounting", "inert", "sweep",
                  "gates")
WORST_CASE_ON = 266.2592      # results/BENCH_ingest.json, accounting
# isn phase: the distributed ISN step (repro_torch.isn.shard) at the
# production per-chip cell of configs/paper_isn.CONFIG on its 16 x 16 mesh
# (ISN_DATA_RANKS query ranks: 4,096 / 16 = 256 queries a step) at world
# size 1; k_global cut from 4,096 to k_shard (1,024), the candidates one
# model rank has; the CPU twin on the cli phase's index over ISN_CHECKED
# queries (a CPU step on the 196,608-doc shard runs both engines on every
# query: seconds a batch of 32)
ISN_DATA_RANKS = 16
ISN_CHECKED = 32
# the sampled card fit of the fit phase (GBRT colsample / subsample < 1)
SAMPLED_FIT = dict(n=2048, n_feat=32, seed=3)
# obs phase: the observability gate's flow (benchmarks/obs_diff.py:197-276,
# ``obs_flow``) at its defaults, diffed against OBS_BASELINE (read, never
# written) under OBS_TOL; then on the cli phase's index a telemetry-on
# system against its CPU twin and a telemetry-off system over the first
# OBS_CROSS queries offline and a bursty trace of the first OBS_ONLINE
# (snapshots every OBS_EVERY units on the virtual clock)
OBS_BASELINE = ROOT / "results" / "BENCH_obs_baseline.json"
OBS_CROSS, OBS_ONLINE, OBS_EVERY = 64, 64, 20.0
OBS_FIGURES = ("gates", "snapshot", "findings", "capacity_qps",
               "traces_kept")
OBS_QUANTILES = ("p50", "p95", "p99", "p99.99")
OBS_TOL = {"latency_rel": 0.25, "latency_abs_us": 2.0, "count_rel": 0.25,
           "count_abs": 2.0, "hit_ratio_drop": 0.10}
# histogram name substrings whose growth is a regression; counters where
# more is worse (exact names, or a mirrored section and its key substrings)
OBS_LATENCY_HISTS = ("latency", "wait")
OBS_BAD_COUNTERS = ("budget_violations", "shed_queries", "stage2_trimmed",
                    "stage2_skipped")
OBS_BAD_SECTION_KEYS = {
    "admission": ("shed_",),
    "scheduler": ("over_budget", "late_hedged"),
    "faults": ("retries", "lost_partitions", "transient", "degraded"),
    "ingest": ("feed_throttled", "merges_forced"),
}
# the BENCH_tail flow (benchmarks/bench_tail.py:43-130) and the figures it
# reports, as results/BENCH_tail.json names them
TAIL_ARTIFACT = ROOT / "results" / "BENCH_tail.json"
TAIL_FIGURES = ("budget", "late_rho", "raw_max", "worst_case_bound",
                "bound_holds", "identical_topk", "identical_final",
                "regression_demonstrated", "bmw_late_hedge_exercised",
                "guarantee_holds")
# the redesigned kernels' earlier designs, ms on the card (PERF.md §6, on
# an NVIDIA H100 80GB HBM3 at 700 W), logged beside this run's
EARLIER_MS = {"impact_accumulate_batched": "1.611-1.622",
              "blockmax_score_batched": "0.780-0.788",
              "qd_feature_gather_lanes": "0.742-0.754",
              "dense_topk_tiles": "0.4089-0.4148, device 0.3735-0.3747",
              "score_histogram": "0.5409-0.8154 (histogram_topk: the "
                                 "histogram kernel, torch ops, a stable sort)",
              "impact_accumulate_bucketed": "device 0.0040-0.0041",
              "blockmax_score_bucketed": "0.0647-0.0723",
              "flash_decode": "0.171-0.267",
              "level_histogram": "0.3031-0.3143, device 0.1696-0.2827 "
                                 "(the warp-vote design)",
              "flash_decode decode_32k": "0.655-0.683"}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# kernel phase helpers
# ---------------------------------------------------------------------------

def kernel_modules():
    """The ops module of each kernel wrapper, by kernel name."""
    from repro_torch.kernels.blockmax_score import ops as bm
    from repro_torch.kernels.dense_topk import ops as dt
    from repro_torch.kernels.impact_accumulate import ops as ia
    from repro_torch.kernels.qd_feature_gather import ops as qd
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.level_histogram import ops as lh
    from repro_torch.kernels.score_histogram import ops as sh
    from repro_torch.kernels.stage0 import ops as s0
    return {"stage0_features": s0, "stage0_forest": s0,
            "impact_accumulate_batched": ia, "blockmax_score_batched": bm,
            "qd_feature_gather_lanes": qd, "dense_topk_tiles": dt,
            "impact_accumulate_bucketed": ia, "blockmax_score_bucketed": bm,
            "score_histogram": sh, "flash_attention": fa,
            "flash_decode": fa, "level_histogram": lh, "boost_update": lh,
            "flash_attention_backward": fa, "level_split": lh,
            "level_route": lh}


class Recorder:
    """Records the arguments of every call of the named kernel wrappers (the
    main path's real inputs) while passing the call through; with
    ``largest``, only the call that moves the most bytes is kept, with
    ``first`` only the first; ``clone`` records copies of the tensors (the
    KV cache is written in place later).  ``every`` maps a name to k: of
    that wrapper only every k-th call and each call larger than all before
    it (by its tensors' sizes, read from shapes alone: no device sync) are
    recorded, as copies."""

    def __init__(self, names=SERVE_KERNELS, largest=False, first=False,
                 clone=False, every=None):
        mods = kernel_modules()
        self.sites = {name: mods[name] for name in names}
        self.calls = {name: [] for name in self.sites}
        self.largest, self.first, self.clone = largest, first, clone
        self.every = every or {}
        self.seen = {name: 0 for name in self.every}
        self.top = {name: -1 for name in self.every}
        self.orig = {}

    def _copy(self, args, clone=False):
        import torch
        if not (self.clone or clone):
            return args
        return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args)

    def _sampled(self, name, args, kw):
        """Whether the ``every`` wrapper ``name``'s call is recorded."""
        import torch
        i = self.seen[name]
        self.seen[name] = i + 1
        size = kw.get("n_nodes", 1) * sum(
            a.numel() for a in args if isinstance(a, torch.Tensor))
        larger = size > self.top[name]
        self.top[name] = max(self.top[name], size)
        return i % self.every[name] == 0 or larger

    def __enter__(self):
        for name, mod in self.sites.items():
            fn = getattr(mod, WRAPPERS.get(name, name))
            self.orig[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kw):
                calls = self.calls[_name]
                if _name in self.every:
                    if self._sampled(_name, args, kw):
                        calls.append((self._copy(args, clone=True), kw))
                elif not (self.first and calls):
                    calls.append((self._copy(args), kw))
                if self.largest and len(calls) > 1:
                    calls[:] = [max(calls,
                                    key=lambda c: work_of(_name, *c)[0])]
                return _fn(*args, **kw)
            setattr(mod, WRAPPERS.get(name, name), wrapped)
        return self

    def __exit__(self, *exc):
        for name, mod in self.sites.items():
            setattr(mod, WRAPPERS.get(name, name), self.orig[name])


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs, each timed with
    CUDA events after a synchronize (one warm-up run first)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps):
    """Device time of one ``fn()`` as text: the card's kernels and copies
    that ``reps`` calls launch under ``torch.profiler``, summed and divided
    by ``reps`` (the host's time between the launches left out), in ms;
    "not captured" when the profiler recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return f"{us / reps / 1e3:.4f}" if us > 0 else "not captured"


def log_redesign(label, ms, fn):
    """A redesigned kernel's wrapper time beside its device time and the
    earlier design's time (``EARLIER_MS``)."""
    log(f"kernel {label}: wrapper {ms:.4f} ms, device {device_ms(fn, REPS)}"
        f" ms a call (profiler); the earlier design {EARLIER_MS[label]} ms "
        f"(PERF.md)")


def lm_work(name, args, kw):
    """(bytes, ops, ops per second) of an attention call.  Prefill: q, k, v
    read once and the output (at v's width) written once; 2·(D + Dv)
    operations (one FMA a q/k width for the logit, one a v width for P·V;
    4·D at equal widths) per (query, key) pair it must score — the pairs on
    or below the diagonal when causal.  Decode: the cache positions below kv_len (k and v) read
    once, q and the output once; 4·D operations per (query head, valid
    position).  bf16 inputs at the bf16 tensor-core rate, fp32 at the fp32
    rate."""
    import torch
    q = args[0]
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    el = q.element_size()
    if name == "flash_attention":
        _, k, v = args
        b, h, sq, d = q.shape
        sk, dv = k.shape[2], v.shape[-1]
        pairs = (b * h * sq * (sq + 1) // 2 if kw.get("causal", True)
                 else b * h * sq * sk)
        return (el * (q.numel() + k.numel() + v.numel() + b * h * sq * dv),
                2 * pairs * (d + dv), rate)
    _, k, v, kv_len = args
    b, h, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    valid = int(kv_len.long().clamp(0, t).sum())
    return (el * (2 * valid * hkv * d + 2 * q.numel()) + 4 * b,
            4 * h * d * valid, rate)


def bwd_work(args, kw):
    """(bytes, ops, ops per second) of kernel 8's backward: q, k, v, o, dO
    and the log-sum-exp read once, dQ, dK and dV written once; five
    products a (query, key) pair it must score — S and dQ and dK at the
    q/k width, dP and dV at the v width: 2·(3·D + 2·Dv) operations — the
    pairs on or below the diagonal when causal; bf16 inputs at the bf16
    tensor-core rate, fp32 at the fp32 rate."""
    import torch
    q, k, v, o, lse, do = args
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    b, h, sq, d = q.shape
    sk, dv = k.shape[2], v.shape[-1]
    pairs = (b * h * sq * (sq + 1) // 2 if kw.get("causal", True)
             else b * h * sq * sk)
    el = q.element_size()
    nbytes = el * 2 * (q.numel() + k.numel() + v.numel() + o.numel()) \
        + 4 * lse.numel()
    return nbytes, 2 * pairs * (3 * d + 2 * dv), rate


def work_of(name, args, kw):
    """(bytes, ops, ops per second) the call must move and do on these
    inputs.  Kernels 1 and 2: ``batched_work``.  Stage-2 gather:
    ``gather_work``.  Dense top-k: the embeddings and queries read once,
    (Q, k) scores and ids written once; two fp32 operations (one FMA) per
    (query, doc, dimension).  Per-query bucketed kernels: the live lanes
    the function needs (doc and value, 8 B; for kernel 5 those of the
    surviving tiles and the residue), the flags, offsets or row lengths
    and the cut read once, the tiles written once; for kernel 4 one
    int32 compare with the cut and one add per live lane, for kernel 5 one
    fp32 add per lane.  Histogram top-k (kernel 7's fused call): the scores
    read once, the bins and the k values and indices written once, one int32
    increment and one compare per score.  Level histogram: the (F, n) uint8
    bins, the node ids, g·w and w read once, the two float histograms
    written once; two fp32 adds per (row, feature).  Level split (T
    trees): the bins of the features some tree may split on, the (T, n)
    node ids and weights, g and the masks read once, the (T, n_nodes, F)
    gains and bins written once; per tree, one multiply a row (g·w), two
    adds per (row, feature in its mask) and 15 operations per (node,
    feature in its mask, bin): two prefix-sum adds and the gain's 13.
    Level route: the candidates read once, each row's node id and the bin
    of its node's feature read once and its node id written once, each
    node's feature and threshold written once; one compare per (tree, node,
    feature) and two operations a row.  Stage-0 features: each query's
    term ids, mask, statistic rows and df read once, its 147 features
    written once; six operations per (slot, statistic) and two log1p's.
    Stage-0 forests: the features, the edges, the 2^depth - 1 nodes (split
    feature and threshold) and 2^depth leaves of each tree and the bases
    read once, the predictions written once; a compare per
    (query, edge), two operations per (query, tree, level)."""
    import torch
    if name == "stage0_features":
        q, slots = args[2].shape
        return (4 * q * slots * 39 + 4 * q * 147, q * (216 * slots + 60),
                FP32_FLOPS_PER_S)
    if name == "stage0_forest":
        x, edges, feat, thresh, leaf, base = args
        q = x.shape[0]
        m, n_trees = feat.shape[:2]
        nodes = m * n_trees * 2 ** kw["depth"]
        return (4 * (x.numel() + edges.numel() + 2 * (nodes - m * n_trees)
                     + nodes + m + m * q),
                q * (edges.numel() + 2 * m * n_trees * kw["depth"]),
                FP32_FLOPS_PER_S)
    if name == "level_split":
        xbt, node, g, w, fmask = args
        n_feat, n = xbt.shape
        n_trees, nodes, bins = node.shape[0], kw["n_nodes"], kw["n_bins"]
        used = int(fmask.sum())
        cols = int(fmask.any(dim=0).sum())
        return (cols * n + 8 * n_trees * n + 4 * n + n_trees * n_feat
                + 8 * n_trees * nodes * n_feat,
                n_trees * n + 2 * n * used + 15 * used * nodes * bins,
                FP32_FLOPS_PER_S)
    if name == "level_route":
        node, gain = args[1], args[2]
        n_trees, n = node.shape
        nodes = gain.shape[1]
        return (8 * gain.numel() + 9 * n_trees * n + 8 * n_trees * nodes,
                gain.numel() + 2 * n_trees * n, FP32_FLOPS_PER_S)
    if name == "level_histogram":
        xbt, node, gw, w = args
        n_feat, n = xbt.shape
        cells = kw["n_nodes"] * n_feat * kw["n_bins"]
        return (n_feat * n + 12 * n + 8 * cells, 2 * n * n_feat,
                FP32_FLOPS_PER_S)
    if name in LM_KERNELS:
        return lm_work(name, args, kw)
    if name == "flash_attention_backward":
        return bwd_work(args, kw)
    if name == "impact_accumulate_bucketed":
        docs_b, imps_b, lstar, *lens = args     # the row lengths, if given
        n_tiles, tile_d = docs_b.shape[0], kw["tile_d"]
        live = int(((docs_b >= 0) & (docs_b < tile_d)).sum())
        return (8 * live + 4 + 4 * n_tiles * (len(lens) + tile_d), 2 * live,
                INT32_OPS_PER_S)
    if name == "blockmax_score_bucketed":
        lanes = bucketed_score_lanes(*args)
        n_tiles, tile_d = args[0].shape[0], kw["tile_d"]
        return (8 * lanes + 4 * (2 * n_tiles + 1) + 4 * n_tiles * tile_d,
                lanes, FP32_FLOPS_PER_S)
    if name == "score_histogram":
        s, k, n_bins = args
        n = s.shape[0]
        return 4 * n + 4 * n_bins + 8 * k, 2 * n, INT32_OPS_PER_S
    if name == "dense_topk_tiles":
        q_emb, doc_emb, k = args
        (q, d), n = q_emb.shape, doc_emb.shape[0]
        return (4 * (n * d + q * d) + 12 * q * k, 2 * q * n * d,
                FP32_FLOPS_PER_S)
    if name in BATCHED:
        return batched_work(name, args, kw)[:3]
    return gather_work(*args)[:3]


def gather_work(lane_docs, lane_scores, cand):
    """(bytes, ops, ops per second, the TPU design's compares) of a call of
    kernel 3 on these inputs.  Bytes: the doc of each live lane (4 B), the
    score of each lane that matches a candidate (4 B), the candidates read
    once, the three outputs written once.  Operations: one table lookup
    per live lane plus one add per (lane, candidate column) match, at the
    int32 rate.  The TPU design's count: one int32 compare per (live lane,
    candidate column)."""
    import torch
    from repro_torch.kernels.qd_feature_gather import ops as qd
    live = int((lane_docs >= 0).sum())
    cnt = qd.qd_feature_gather_plain(lane_docs, lane_scores, cand)[2]
    # a lane's score is read once, whichever columns hold its doc
    c = cand.shape[1]
    earlier = torch.ones((c, c), dtype=torch.bool,
                         device=cand.device).tril(-1)
    dup = ((cand[:, :, None] == cand[:, None, :]) & earlier).any(dim=2)
    lanes_matched = int(cnt[~dup].sum())
    return (4 * live + 4 * lanes_matched + 16 * cand.numel(),
            live + int(cnt.sum()), INT32_OPS_PER_S, live * c)


def batched_work(name, args, kw):
    """(bytes, ops, ops per second, the TPU design's compares) of a call of
    kernel 1 or 2 on these inputs.  Bytes: 4 for each live term lane of the
    tiles the call must read (every tile for kernel 1; for kernel 2 those
    some query keeps), 8 (doc and impact or score) for each of those lanes
    whose term a query holds (for kernel 2 a query that keeps the tile),
    the flags, query terms and cuts read once, the output written once.
    Operations: one term lookup a lane read, plus one add per (lane, query)
    match that adds (kernel 1: the impact reaches the query's cut; kernel
    2: the query keeps the tile and the lane's block).  The TPU design's
    count: one int32 compare per (query, live lane it scans, query slot)."""
    import torch
    from repro_torch.kernels import term_table as tt
    docs, terms, vals, qterms = args[:4]
    q, n_terms = qterms.shape
    n_tiles, tile_d = docs.shape[0], kw["tile_d"]
    live = docs >= 0
    per_tile = live.sum(dim=1).to(torch.int64)
    if name == "blockmax_score_batched":
        sb, st = args[4:]
        read = (st > 0).any(dim=0)
        flags = sb.numel() + st.numel()
        scanned = int(((st > 0).to(torch.int64) * per_tile[None]).sum())
    else:
        read = torch.ones(n_tiles, dtype=torch.bool, device=docs.device)
        flags = q
        scanned = q * int(per_tile.sum())
    needed = torch.zeros_like(live)
    adds = 0
    for g0 in range(0, q, tt.GROUP):
        qt = qterms[g0:g0 + tt.GROUP]
        keys, mask, _ = tt.group_table(qt)
        tile, j, entry = tt.matched_lanes(keys, docs, terms, tile_d)
        held = tt.mask_bits(mask[entry], qt.shape[0])
        if name == "blockmax_score_batched":
            held &= st[g0:g0 + tt.GROUP].T[tile] > 0
            blk = docs[tile, j].long() // kw["block_size"]
            hit = held & (sb[g0:g0 + tt.GROUP].permute(1, 2, 0)[tile, blk]
                          > 0)
        else:
            hit = held & (vals[tile, j].unsqueeze(1)
                          >= args[4][g0:g0 + tt.GROUP].unsqueeze(0))
        some = held.any(dim=1)
        needed[tile[some], j[some]] = True
        adds += int(hit.sum())
    lanes = int(per_tile[read].sum())
    nbytes = (4 * lanes + 8 * int(needed.sum())
              + 4 * (flags + qterms.numel()) + 4 * q * n_tiles * tile_d)
    return nbytes, lanes + adds, INT32_OPS_PER_S, scanned * n_terms


def compare(name, got, want, tol=1e-5):
    """Max abs error; raises if the kernel disagrees with its plain version
    beyond the stated tolerance (integers exact, floats within ``tol``)."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name}: kernel output {tuple(g.shape)} {g.dtype} vs plain "
              f"{tuple(w.shape)} {w.dtype}")
        if g.dtype.is_floating_point:
            e = float((g - w).abs().max()) if g.numel() else 0.0
            check(e <= tol, f"{name}: max abs error {e} > {tol}")
        else:
            e = float((g.long() - w.long()).abs().max()) if g.numel() else 0.0
            check(e == 0, f"{name}: integer outputs differ by {e}")
        err = max(err, e)
    return err


def edge_calls(device):
    """Small seeded inputs with the edge cases the main path rarely shows:
    -1 query slots, a repeated query term, an empty tile, a ghost tail
    tile, tiles whose survive_t is 0 under set block flags, dead lanes
    and -1 candidates; for kernels 1 and 2 also Q = 1, 33 and 64 (one
    group, a group of one, two full groups of 8 slots) with a term held by
    every query at different slots, and at Q = 33 a group that prunes
    every tile; for the dense top-k, exact ties (duplicated doc rows)
    across tiles and blocks, all-equal rows, 1,500 zero rows whose score
    (+0.0) is the k-th for every query (non-negative queries and rows, some
    rows negated), doc counts that are not a multiple of a tile or of 512,
    k in {1, 33, 128, 1,000 = N, 2,048}, Q in {1, 5, 33} and a row of
    400,000 docs.  Lists of (args, kwargs)."""
    import numpy as np
    import torch
    from repro_torch.dense import embed_queries, synthetic_embeddings
    from repro_torch.index.builder import pack_tiles
    rng = np.random.RandomState(SEED)
    n_docs, vocab, tile_d, block = 1000, 40, 128, 64
    hit = rng.rand(vocab, n_docs) < 0.08
    hit[:, 256:384] = False
    term, doc = np.nonzero(hit)
    scores = (rng.rand(len(doc)) * 8).astype(np.float32)
    imps = rng.randint(1, 256, len(doc)).astype(np.int32)
    docs_b, terms_b, (scores_b, imps_b), _ = pack_tiles(
        doc, term, [(scores, 0.0, np.float32), (imps, 0, np.int32)], n_docs,
        tile_d)
    qterms = np.asarray([[3, 7, 11, -1, -1], [5, 5, 9, -1, -1],
                         [-1, -1, -1, -1, -1], [17, -1, 17, 30, 31]],
                        np.int32)
    q, n_tiles = len(qterms), docs_b.shape[0]
    sb = (rng.rand(q, n_tiles, tile_d // block) < 0.7).astype(np.int32)
    st = (rng.rand(q, n_tiles) < 0.6).astype(np.int32)
    lanes = rng.randint(0, 300, (q, 700)).astype(np.int32)
    lanes[rng.rand(q, 700) < 0.2] = -1
    lane_sc = np.where(lanes >= 0, rng.rand(q, 700) * 5, 0).astype(np.float32)
    cand = rng.randint(0, 300, (q, 50)).astype(np.int32)
    cand[rng.rand(q, 50) < 0.15] = -1

    doc_emb, table = synthetic_embeddings(3000, 512, d=32, seed=SEED % 997)
    q_emb = embed_queries(table, rng.randint(0, 512, (24, 6)),
                          np.ones((24, 6), np.float32))
    ties = np.concatenate([doc_emb[:700]] * 3)          # 2,100 docs, 3x ties
    # non-negative queries and rows score > 0; zero rows score +0.0, the
    # 400th key for every query: 1,500 ties spread over the blocks
    pos, zero = np.abs(doc_emb[:300]), np.zeros((750, 32), np.float32)
    zeros_k = np.concatenate([pos[:150], zero, pos[150:], zero,
                              -pos[:200]])
    big = synthetic_embeddings(400_000, 512, d=32, seed=SEED % 991)[0]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def groups(q):
        # L = 8 slots, 40 % of them -1; term 13 in every query, at slot
        # q % 8; at Q = 33 the second group prunes every tile
        qt = rng.randint(0, vocab, (q, 8)).astype(np.int32)
        qt[rng.rand(q, 8) < 0.4] = -1
        qt[np.arange(q), np.arange(q) % 8] = 13
        cut = rng.randint(0, 128, q).astype(np.int32)
        sbq = (rng.rand(q, n_tiles, tile_d // block) < 0.7).astype(np.int32)
        stq = (rng.rand(q, n_tiles) < 0.7).astype(np.int32)
        if q == 33:
            stq[32:] = 0
        return ((t(docs_b), t(terms_b), t(imps_b), t(qt), t(cut)),
                (t(docs_b), t(terms_b), t(scores_b), t(qt), t(sbq), t(stq)))

    grouped = [groups(q) for q in (1, 33, 64)]
    return {
        "impact_accumulate_batched": [(
            (t(docs_b), t(terms_b), t(imps_b), t(qterms),
             t(np.asarray([0, 40, 0, 1], np.int32))), dict(tile_d=tile_d))]
        + [(a, dict(tile_d=tile_d)) for a, _ in grouped],
        "blockmax_score_batched": [(
            (t(docs_b), t(terms_b), t(scores_b), t(qterms), t(sb), t(st)),
            dict(tile_d=tile_d, block_size=block))]
        + [(b, dict(tile_d=tile_d, block_size=block)) for _, b in grouped],
        "qd_feature_gather_lanes": [((t(lanes), t(lane_sc), t(cand)), {})]
        + gather_edge_calls(device),
        "dense_topk_tiles": [
            ((t(q_emb), t(ties), 128), {}),
            ((t(q_emb), t(ties), 2048), {}),
            ((t(q_emb), t(doc_emb[:1025]), 33), {}),
            ((t(q_emb), t(doc_emb), 1), {}),
            ((t(q_emb[:1]), t(doc_emb), 128), {}),
            ((t(q_emb[:5]), t(doc_emb[:2999]), 33), {}),
            ((t(q_emb), t(doc_emb[:1000]), 1000), {}),
            ((t(q_emb[:3]), t(np.repeat(doc_emb[:1], 5000, axis=0)), 100),
             {}),
            ((t(np.abs(q_emb)), t(zeros_k), 400), {}),
            ((t(np.concatenate([q_emb, q_emb[:9]])), t(doc_emb[:1025]), 64),
             {}),
            ((t(q_emb[:2]), t(big), 2048), {}),
        ],
    }


def delta_edge_calls(device):
    """The live delta's shapes (padded lanes, k = n): kernels 1 and 2 on a delta shard of 2 tiles of 128 docs at a lane
    capacity of 8,192 (``live_ingest``'s), empty (every lane -1) and full
    (one tile's 8,192 lanes all live: 128 docs x 64 terms); kernel 6 at k =
    n = 256 and 300 (the wrapper rounds k up to 512 > n) over capacity
    matrices whose rows past the live ones are zero ghosts, against queries
    that score some live rows below zero.  A dict of lists of (args,
    kwargs)."""
    import numpy as np
    import torch
    from repro_torch.dense import embed_queries, synthetic_embeddings
    from repro_torch.index.builder import pack_tiles
    rng = np.random.RandomState(SEED + 25)
    n_docs, tile_d, block, cap = 256, 128, 64, 8192

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def layout(doc, term):
        score = (rng.rand(len(doc)) * 8).astype(np.float32)
        imp = rng.randint(1, 256, len(doc)).astype(np.int32)
        docs_b, terms_b, (scores_b, imps_b), got = pack_tiles(
            doc, term, [(score, 0.0, np.float32), (imp, 0, np.int32)],
            n_docs, tile_d, tile_cap=cap)
        check(got == cap, "delta edge layout: lane capacity")
        return docs_b, terms_b, scores_b, imps_b

    empty = layout(np.zeros(0, np.int64), np.zeros(0, np.int64))
    term, doc = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    full = layout(doc.ravel(), term.ravel() * 3)      # (term, doc) order
    check(int((full[0][0] >= 0).sum()) == cap
          and int((empty[0] >= 0).sum()) == 0, "delta edge layout: fill")
    q = 40
    qt = rng.randint(0, 200, (q, 8)).astype(np.int32)
    qt[rng.rand(q, 8) < 0.3] = -1
    cut = rng.randint(0, 200, q).astype(np.int32)
    sb = (rng.rand(q, 2, tile_d // block) < 0.8).astype(np.int32)
    st = (rng.rand(q, 2) < 0.9).astype(np.int32)
    k1, k2 = [], []
    for docs_b, terms_b, scores_b, imps_b in (empty, full):
        k1.append(((t(docs_b), t(terms_b), t(imps_b), t(qt), t(cut)),
                   dict(tile_d=tile_d)))
        k2.append(((t(docs_b), t(terms_b), t(scores_b), t(qt), t(sb),
                    t(st)), dict(tile_d=tile_d, block_size=block)))
    emb, table = synthetic_embeddings(300, 512, d=32, seed=SEED % 983)
    q_emb = embed_queries(table, rng.randint(0, 512, (24, 6)),
                          np.ones((24, 6), np.float32))
    k6 = []
    for n, live in ((256, 100), (300, 120)):
        ghosts = emb[:n].copy()
        ghosts[live:] = 0.0
        k6.append(((t(q_emb), t(ghosts), n), {}))
    return {"impact_accumulate_batched": k1, "blockmax_score_batched": k2,
            "dense_topk_tiles": k6}


def gather_edge_calls(device):
    """Kernel 3's edges (its redesign's): a candidate matched by 600 lanes
    whose order changes the f32 sum (1e8, 3, 3, -1e8, 3, ...), past the
    records of every block, and a duplicate column of it; 20 matches in
    one lane chunk (past a block's records, inside a warp's); duplicate
    and -1 candidates; C = 77 (not a multiple of 32) and C = 300 (three
    column groups) at P = 333; nine lane chunks at P = 9,001 (the ninth
    walked by the first block again); Q = 1; all lanes dead.
    Lists of (args, kwargs)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED + 5)

    def lanes(q, p, c, n, dead=0.2):
        docs = rng.randint(0, n, (q, p)).astype(np.int32)
        docs[rng.rand(q, p) < dead] = -1
        scores = np.where(docs >= 0, rng.rand(q, p) * 5, 0).astype(np.float32)
        cand = rng.randint(0, n, (q, c)).astype(np.int32)
        cand[rng.rand(q, c) < 0.15] = -1
        return [docs, scores, cand]

    over = lanes(2, 1000, 128, 300)
    hot = rng.rand(1000) < 0.6
    over[0][:, hot] = 7
    over[1][:, hot] = np.tile(np.float32([1e8, 3.0, 3.0, -1e8, 3.0]),
                              200)[:int(hot.sum())]
    over[2][:, 3] = 7
    over[2][1, 90] = 7
    seg = lanes(2, 1600, 50, 300)
    seg[0][:, 200:][seg[0][:, 200:] == 9] = -1
    seg[0][:, :200:10] = 9
    seg[2][:, 0] = 9
    dup = lanes(4, 800, 64, 60)
    dup[2][:, 10:20] = dup[2][:, :10]
    dup[2][1] = -1
    dead = lanes(3, 600, 50, 100, dead=1.0)
    dead[1][:] = 0.0
    calls = [over, seg, dup, lanes(3, 333, 77, 200), lanes(3, 333, 300, 200),
             lanes(2, 9001, 128, 2000), lanes(1, 1000, 128, 120), dead]
    return [(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                   for a in c), {}) for c in calls]


def bucketed_impact_edge_calls(device):
    """Kernel 4's edges with row lengths (its redesign's): every row full
    (``cap`` live lanes), every row empty (length 0), rows prefix-packed
    to random lengths (0, ``cap`` and 1 among them); and a call without
    lengths (whole rows, -1 padding inside them).  Lists of (args,
    kwargs)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED + 6)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def call(docs_b, lens, lstar, tile_d=128):
        imps_b = rng.randint(1, 256, docs_b.shape).astype(np.int32)
        args = (t(docs_b), t(imps_b), t(np.asarray([lstar], np.int32)))
        if lens is not None:
            args += (t(np.asarray(lens, np.int32)),)
        return args, dict(tile_d=tile_d)

    n_tiles, cap = 40, 256
    full = rng.randint(0, 128, (n_tiles, cap)).astype(np.int32)
    lens = rng.randint(0, cap + 1, n_tiles)
    lens[:3] = (0, cap, 1)
    packed = np.where(np.arange(cap)[None, :] < lens[:, None],
                      rng.randint(0, 128, (n_tiles, cap)), -1
                      ).astype(np.int32)
    holes = rng.randint(-1, 128, (n_tiles, cap)).astype(np.int32)
    return [call(full, [cap] * n_tiles, 0),
            call(np.full((n_tiles, cap), -1, np.int32), [0] * n_tiles, 0),
            call(packed, lens, 100),
            call(holes, None, 50)]


def kernel7_edge_scores(rng):
    """Kernel 7's edges, (int32 scores, k) pairs (k = 0: the histogram
    alone): N not a multiple of 512 with scores past the last bin, k above
    the count of non-negative scores, all scores negative; ties on the k-th
    key across the blocks (a JASS-like accumulator, ninety per cent zeros,
    at k = 128 and 2,048; 1,500 scores of 50 spread over the blocks with
    100 above them at k = 128); all-equal scores; k = N; more than k scores
    past the last bin (the radix rounds); negatives tying with zeros at
    t = 0; 400,001 scores, too many to stage in shared memory; the
    histogram alone of an accumulator and of no scores."""
    import numpy as np

    def jass(n, zero=0.9):
        s = rng.randint(1, 600, n).astype(np.int32)
        s[rng.rand(n) < zero] = 0
        return s

    def scores(n, lo, hi, neg=0.0):
        s = rng.randint(lo, hi, n).astype(np.int32)
        s[rng.rand(n) < neg] = -1
        return s

    tied = np.zeros(196_608, np.int32)
    tied[rng.choice(196_608, 1_600, replace=False)] = [50] * 1_500 + [60] * 100
    few = np.full(3001, -1, np.int32)
    few[[5, 17, 40, 2999]] = [3, 0, 7, 2500]
    return [(scores(1000, 0, 3000, 0.1), 100),
            (scores(777, 0, 2500, 0.99), 64),
            (scores(2048, -3, 0), 5), (jass(196_608), 128),
            (jass(196_608), 2048), (tied, 128),
            (np.full(4097, 9, np.int32), 2048), (jass(1000), 1000),
            (scores(5000, 0, 9000), 100), (few, 64),
            (scores(196_608, -3, 1), 128), (scores(400_001, 0, 9000), 2048),
            (jass(196_608), 0), (np.zeros(0, np.int32), 0)]


def laxmap_edge_calls(device):
    """Edge inputs of the per-query kernels, driven through their flat
    wrappers on the card, each flat result held to its plain counterpart:
    for kernel 4 a ``cap`` below the densest tile (the overflow residue),
    ``lstar`` > 0, ``n_docs`` not a multiple of ``tile_d`` and all lanes
    dead, against the direct integer scatter (exact); for kernel 5 the
    residue, every block pruned and a ragged ``n_docs``, against the same
    wrapper on the CPU (bit-equal); for kernel 7 ``kernel7_edge_scores``,
    ``histogram_topk`` (and, at k = 0, ``score_histogram``) against
    ``histogram_select_plain`` (exact).  Returns the bucketed kernel calls the
    wrappers made (lists of (args, kwargs)) and the largest error of the
    flat checks, per kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.blockmax_score import ops as bm
    from repro_torch.kernels.impact_accumulate import ops as ia
    from repro_torch.kernels.score_histogram import ops as sh
    rng = np.random.RandomState(SEED + 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def flat_docs(n_docs, p, dead):
        docs = rng.randint(0, n_docs, p).astype(np.int32)
        docs[rng.rand(p) < dead] = -1
        return docs

    errs = dict.fromkeys(LAXMAP_KERNELS, 0.0)
    with Recorder(LAXMAP_KERNELS) as rec:
        name = "impact_accumulate_bucketed"
        for n_docs, p, cap, lstar, dead in ((1000, 5000, 128, 0, 0.15),
                                            (1000, 5000, 128, 128, 0.15),
                                            (300, 700, 64, 0, 1.0)):
            docs = t(flat_docs(n_docs, p, dead))
            imps = t(rng.randint(1, 256, p).astype(np.int32))
            got = ia.impact_accumulate(docs, imps, lstar, n_docs=n_docs,
                                       cap=cap)
            want = ia.impact_accumulate_ref(docs, imps, lstar, n_docs)
            errs[name] = max(errs[name], compare(name + " (flat)", got, want))
        name = "blockmax_score_bucketed"
        for n_docs, p, frac, cap in ((1000, 6000, 0.8, 256),
                                     (1000, 6000, 0.0, 256),
                                     (700, 3000, 0.5, 1024)):
            docs = flat_docs(n_docs, p, 0.1)
            scores = (rng.rand(p) * 8).astype(np.float32)
            survive = rng.rand(-(-n_docs // 64)) < frac
            kw = dict(n_docs=n_docs, block_size=64, cap=cap)
            got = bm.blockmax_score(t(docs), t(scores), t(survive), **kw)
            want = bm.blockmax_score(
                *(torch.from_numpy(a) for a in (docs, scores, survive)), **kw)
            errs[name] = max(errs[name], compare(
                name + " (flat)", got, want.to(device), tol=0.0))
        name = "score_histogram"
        for s, k in kernel7_edge_scores(rng):
            s = t(s)
            got = sh.histogram_topk(s, k=k) if k else sh.score_histogram(s)
            want = sh.histogram_select_plain(s, k, 2048)
            errs[name] = max(errs[name], compare(
                "histogram_topk" if k else "score_histogram", got,
                want[:2] if k else want[2]))
    # the CPU run of the kernel-5 wrapper called its plain version
    return ({n: [c for c in calls if c[0][0].is_cuda]
             for n, calls in rec.calls.items()}, errs)


def bucketed_layout(tiles, cap, device):
    """Kernel 5's inputs from per-tile lane lists [(docs, scores), ...]:
    the bucket rows (each tile's first ``cap`` lanes, -1 padded), the run
    (every tile's lanes in order) and the run's tile starts."""
    import numpy as np
    import torch
    n_tiles = len(tiles)
    docs_b = np.full((n_tiles, cap), -1, np.int32)
    scores_b = np.zeros((n_tiles, cap), np.float32)
    for i, (d, s) in enumerate(tiles):
        docs_b[i, :min(cap, len(d))] = d[:cap]
        scores_b[i, :min(cap, len(d))] = s[:cap]
    run_start = np.concatenate([[0], np.cumsum([len(d) for d, _ in tiles])])
    run_docs = np.concatenate([d for d, _ in tiles] + [[]]).astype(np.int32)
    run_scores = np.concatenate([s for _, s in tiles] + [[]]
                                ).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (docs_b, scores_b, run_docs, run_scores,
                           run_start.astype(np.int32)))


def bucketed_score_edge_calls(device):
    """Kernel 5 on hand-made bucketed layouts (its redesign's edges): -1
    lanes scattered inside rows; a full row plus a residue; a tile with
    survive_t 0 but a residue; one doc hit by 600 lanes whose order
    changes the f32 sum (1e8, 3, -1e8 ...); tile_d 48 with docs past it;
    every tile empty.  Lists of (args, kwargs)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED + 4)

    def lanes(n, tile_d, dead=0.0):
        d = rng.randint(0, tile_d, n).astype(np.int32)
        d[rng.rand(n) < dead] = -1
        return d, (rng.rand(n) * 8).astype(np.float32)

    def call(tiles, cap, survive, tile_d=128):
        docs_b, scores_b, run_docs, run_scores, run_start = bucketed_layout(
            tiles, cap, device)
        st = torch.tensor(survive, dtype=torch.int32, device=device)
        return ((docs_b, scores_b, st, run_docs, run_scores, run_start),
                dict(tile_d=tile_d))

    big = np.tile(np.asarray([1e8, 3.0, 3.0, -1e8, 3.0], np.float32), 120)
    return [
        call([lanes(200, 128, 0.3) for _ in range(6)], 256, [1] * 6),
        call([lanes(256, 128), lanes(556, 128, 0.1), lanes(40, 128)], 256,
             [1, 1, 1]),
        call([lanes(100, 128), lanes(356, 128), lanes(0, 128)], 256,
             [1, 0, 0]),
        call([(np.full(600, 7, np.int32), big), lanes(90, 128)], 256,
             [1, 1]),
        call([lanes(300, 50, 0.2) for _ in range(5)], 128, [1, 0, 1, 1, 1],
             tile_d=48),
        call([(np.zeros(0, np.int32), np.zeros(0, np.float32))] * 4, 64,
             [1, 1, 0, 0]),
    ]


def bucketed_score_lanes(docs_b, scores_b, survive_t, run_docs, run_scores,
                         run_start):
    """Lanes kernel 5 must add: the live bucket lanes of the surviving tiles
    and every tile's overflow residue."""
    cap = docs_b.shape[1]
    bucket = int(((docs_b >= 0) & (survive_t[:, None] != 0)).sum())
    res = (run_start[1:] - run_start[:-1] - cap).clamp(min=0)
    return bucket + int(res.sum())


def batched_pairs(name, args, kw):
    """The (query, lane) pairs a call of kernel 1 or 2 adds, as the flat
    output index (query, tile, doc) and the value added (impact or score):
    per group of queries, the lanes whose term a query of the group holds
    (``term_table``), kept where the lane reaches the query's cut (kernel
    1) or the query keeps the lane's tile and block (kernel 2)."""
    import torch
    from repro_torch.kernels import term_table as tt
    docs, terms, vals, qterms = args[:4]
    q = qterms.shape[0]
    n_tiles, tile_d = docs.shape[0], kw["tile_d"]
    idx, val = [], []
    for g0 in range(0, q, tt.GROUP):
        qt = qterms[g0:g0 + tt.GROUP]
        keys, mask, _ = tt.group_table(qt)
        tile, j, entry = tt.matched_lanes(keys, docs, terms, tile_d)
        hit = tt.mask_bits(mask[entry], qt.shape[0])
        if name == "blockmax_score_batched":
            sb, st = args[4:]
            hit &= st[g0:g0 + tt.GROUP].T[tile] > 0
            blk = docs[tile, j].long() // kw["block_size"]
            hit &= sb[g0:g0 + tt.GROUP].permute(1, 2, 0)[tile, blk] > 0
        else:
            hit &= (vals[tile, j].unsqueeze(1)
                    >= args[4][g0:g0 + tt.GROUP].unsqueeze(0))
        lane, g = torch.nonzero(hit, as_tuple=True)
        idx.append(((g0 + g) * n_tiles + tile[lane]) * tile_d
                   + docs[tile[lane], j[lane]].long())
        val.append(vals[tile[lane], j[lane]])
    return torch.cat(idx), torch.cat(val), q * n_tiles * tile_d


def library_calls():
    """Per kernel, a maker of the one PyTorch call that computes the same
    function on a call's inputs (its operands prepared outside the timed
    call), timed as the library yardstick and used nowhere in the port.
    Kernel 3 has none: its three features (a count, a max and a sum per
    candidate over the lanes that match it) take three reductions after a
    join of lanes against candidates, and no one call does that."""
    import torch
    from repro_torch.kernels.blockmax_score import ops as bm

    def dense(args, kw):
        # the nearest composition: one fp32 product, one stable sort
        q_emb, doc_emb, k = args
        return lambda: torch.sort(q_emb @ doc_emb.T, dim=1, descending=True,
                                  stable=True)

    def scatter(idx, val, n):
        return lambda: torch.zeros(n, dtype=val.dtype,
                                   device=val.device).index_add_(0, idx, val)

    def impact(args, kw):
        # integer index_add_ over the live lanes that reach the cut
        docs_b, imps_b, lstar = args[:3]
        tile_d = kw["tile_d"]
        rows = torch.arange(docs_b.shape[0], device=docs_b.device)[:, None]
        live = (docs_b >= 0) & (docs_b < tile_d) & (imps_b >= lstar)
        idx = (rows * tile_d + docs_b)[live].long()
        return scatter(idx, imps_b[live], docs_b.shape[0] * tile_d)

    def score(args, kw):
        # fp32 index_add_ over the lanes kernel 5 adds; its float atomics
        # add in no fixed order, so the port never uses it
        docs_b, scores_b, survive_t, run_docs, run_scores, run_start = args
        tile_d = kw["tile_d"]
        n_tiles, cap = docs_b.shape
        rows = torch.arange(n_tiles, device=docs_b.device)[:, None]
        live = (docs_b >= 0) & (survive_t[:, None] != 0)
        j, tile_r = bm._residue_lanes(run_start, cap, run_docs.shape[0])
        idx = torch.cat([(rows * tile_d + docs_b)[live].long(),
                         tile_r * tile_d + run_docs[j].long()])
        val = torch.cat([scores_b[live], run_scores[j]])
        return scatter(idx, val, n_tiles * tile_d)

    def histogram_topk(args, kw):
        # a stable sort of the scores: on a non-negative accumulator its
        # first k are histogram_topk's
        s = args[0]
        return lambda: torch.sort(s, descending=True, stable=True)

    def batched(name):
        # rows 1 and 2: index_add_ over the (query, lane) pairs the kernel
        # adds -- integer impacts for kernel 1; fp32 scores for kernel 2,
        # whose float atomics add in no fixed order, and which leaves out
        # the block-max pruning that picks the pairs (the survive flags
        # are its inputs)
        return lambda args, kw: scatter(*batched_pairs(name, args, kw))

    return {"impact_accumulate_batched": batched("impact_accumulate_batched"),
            "blockmax_score_batched": batched("blockmax_score_batched"),
            "dense_topk_tiles": dense, "impact_accumulate_bucketed": impact,
            "blockmax_score_bucketed": score,
            "score_histogram": histogram_topk}


def histogram_only(s, n_bins):
    """Kernel 7 with selection off (``score_histogram``) against
    ``torch.bincount`` on the recorded scores: wrapper and device times."""
    import torch
    from repro_torch.kernels.score_histogram import ops as sh
    kern = lambda: sh.score_histogram(s, n_bins=n_bins)
    lib = lambda: torch.bincount(torch.clamp(s[s >= 0], max=n_bins - 1),
                                 minlength=n_bins)
    log(f"kernel score_histogram, the histogram alone over {s.shape[0]} "
        f"scores: wrapper {cuda_ms(kern, REPS):.4f} ms, device "
        f"{device_ms(kern, REPS)} ms; torch.bincount {cuda_ms(lib, REPS):.4f}"
        f" ms, device {device_ms(lib, REPS)} ms")


def kernel_row(name, kern, plain, library, args, kw, err, note):
    """The ``kernels`` line's row of one kernel: the kernel, its plain
    version and (``library``, a maker of the call, or None) the library
    call timed on one call's inputs, and the bound of that call."""
    nbytes, ops, rate = work_of(name, args, kw)
    ms = cuda_ms(lambda: kern(*args, **kw), REPS)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), REPS // 4)
    library_ms = cuda_ms(library(args, kw), REPS) if library else None
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    row = dict(name=name, route="cuda", **KERNELS[name], launches=0,
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=library_ms)
    log(f"kernel {name}: {note}, max_abs_err={err}, ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms} "
        f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}: {nbytes} B, "
        f"{ops} ops)")
    return row


def kernel_phase(recorded):
    """Every recorded main-path call, and the edge cases: kernel vs plain
    version on the card."""
    import torch
    mods = kernel_modules()
    plain = {"impact_accumulate_batched": "impact_accumulate_plain",
             "blockmax_score_batched": "blockmax_score_plain",
             "qd_feature_gather_lanes": "qd_feature_gather_plain",
             "dense_topk_tiles": "dense_topk_plain",
             "impact_accumulate_bucketed": "impact_accumulate_bucketed_plain",
             "blockmax_score_bucketed": "blockmax_score_bucketed_plain",
             "score_histogram": "histogram_select_plain"}
    plain = {name: getattr(mods[name], fn) for name, fn in plain.items()}
    kern = {name: getattr(mods[name], WRAPPERS.get(name, name))
            for name in RETRIEVAL_KERNELS}
    library = library_calls()
    # the dense top-k is exact on the grid-quantized embeddings; kernels 2,
    # 3 and 5 add each sum's terms in the plain version's order; kernel 7's
    # outputs are integers
    tols = {"dense_topk_tiles": 0.0, "blockmax_score_batched": 0.0,
            "qd_feature_gather_lanes": 0.0, "blockmax_score_bucketed": 0.0}
    twin = {name: getattr(mods[name], fn) for name, fn in TWINS.items()}
    rows = {}
    dev = recorded["qd_feature_gather_lanes"][0][0][0].device
    edges = edge_calls(dev)
    lax_edges, flat_errs = laxmap_edge_calls(dev)
    edges.update(lax_edges)
    edges["blockmax_score_bucketed"] += bucketed_score_edge_calls(dev)
    edges["impact_accumulate_bucketed"] += bucketed_impact_edge_calls(dev)
    for name, calls in delta_edge_calls(dev).items():
        edges[name] += calls
    for name in RETRIEVAL_KERNELS:
        calls = recorded[name]
        check(calls, f"{name}: the main path never called it")
        err = flat_errs.get(name, 0.0)
        for args, kw in calls + edges[name]:
            got = kern[name](*args, **kw)
            want = plain[name](*args, **kw)
            torch.cuda.synchronize()
            err = max(err, compare(name, got, want, tols.get(name, 1e-5)))
            if name in TWINS:
                err = max(err, compare(name + " (twin)", got,
                                       twin[name](*args, **kw), 0.0))
            if name == "impact_accumulate_bucketed" and len(args) == 4:
                # the rows are prefix-packed: the whole rows give the same
                err = max(err, compare(name + " (plain, whole rows)", got,
                                       plain[name](*args[:3], **kw)))
        # time the largest call of the batch (the one with most work)
        args, kw = max(calls, key=lambda c: work_of(name, *c)[0])
        note = (f"{len(calls)} main-path calls and {len(edges[name])} edge "
                "cases checked")
        if name in TWINS:
            note += f" (and against {TWINS[name]})"
        if name in BATCHED:
            note += (f", Q={args[3].shape[0]}; the TPU design's compares "
                     f"{batched_work(name, args, kw)[3]}")
        if name == "qd_feature_gather_lanes":
            note += (f", Q x P x C = {tuple(args[0].shape)} x "
                     f"{args[2].shape[1]}; the TPU design's compares "
                     f"{gather_work(*args)[3]}")
        if name == "impact_accumulate_bucketed":
            note += (f", with row lengths: {len(args) == 4}, live lanes "
                     f"{int((args[0] >= 0).sum())} of {args[0].numel()} "
                     "slots")
        rows[name] = kernel_row(name, kern[name], plain[name],
                                library.get(name), args, kw, err, note)
        if name in EARLIER_MS:
            log_redesign(name, rows[name]["ms"],
                         lambda: kern[name](*args, **kw))
        if name in ("impact_accumulate_bucketed", "dense_topk_tiles",
                    "score_histogram"):
            # rows 4, 6 and 7: the kernel's and the library call's device time
            lib_ms = device_ms(library[name](args, kw), REPS)
            log(f"kernel {name}: device "
                f"{device_ms(lambda: kern[name](*args, **kw), REPS)} ms "
                f"a call, library call device {lib_ms} ms (profiler)")
        if name == "dense_topk_tiles":
            q_emb, doc_emb, k = args
            design = 4 * doc_emb.numel() + 2 * 4 * q_emb.shape[0] \
                * doc_emb.shape[0]
            log(f"kernel {name}: the design's own traffic {design} B (the "
                "embeddings read, the keys written and read back once), "
                f"{design / HBM_BYTES_PER_S * 1e3:.4f} ms at the HBM rate")
        if name == "score_histogram":
            s, k, n_bins = args
            order = torch.sort(s, descending=True, stable=True).indices[:k]
            check(torch.equal(order.to(torch.int32), kern[name](*args)[1]),
                  "score_histogram: the stable sort's top-k differs on the "
                  "recorded accumulator")
            histogram_only(s, n_bins)
    return rows


def run_profiled(fn):
    """``fn()`` under ``torch.profiler`` (host and card activity), ending
    in a synchronize: (the profile, the wall ms with the profiler on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return prof, wall_ms


def log_profile(prof, wall_ms, label="profile"):
    """Device busy time (the union of the card's own kernel and copy
    intervals; the host-side aten ops that launched them are not counted
    again) and idle share of the wall, host time per ``stage:``
    annotation, and the busiest device kernels."""
    from torch.autograd import DeviceType

    def on_card(e):
        # the card's kernels and copies; the stage annotations are mirrored
        # onto the device timeline too, spanning whole stages
        return (e.device_type == DeviceType.CUDA
                and not e.key.startswith("stage:"))
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if on_card(e))
    check(spans, f"{label}: the profiler recorded no device activity")
    busy_us, last = 0.0, spans[0][0]
    for start, end in spans:
        busy_us += max(0.0, end - max(start, last))
        last = max(last, end)
    busy_ms = busy_us / 1e3
    log(f"{label}: wall {wall_ms:.2f} ms (profiler on), device busy "
        f"{busy_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f} % of wall, "
        f"idle {100 - 100 * busy_ms / wall_ms:.1f} % ({len(spans)} device "
        f"events)")
    events = prof.key_averages()
    for e in events:
        if e.key.startswith("stage:") and e.cpu_time_total > 0:
            log(f"{label}: {e.key} host {e.cpu_time_total / 1e3:.2f} ms")
    device = [e for e in events if on_card(e)]
    for e in sorted(device, key=lambda e: e.device_time_total,
                    reverse=True)[:12]:
        log(f"{label}: device {e.device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:70]}")


# ---------------------------------------------------------------------------
# LM phase (Yi-6B prefill and KV-cache decode)
# ---------------------------------------------------------------------------

def tree_to(tree, device):
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _sync(x):
    import torch
    if x.is_cuda:
        torch.cuda.synchronize()


def prefill_padded(params, c, tokens):
    """``prefill`` of ``tokens`` (B, S) with its cache padded by
    ``DECODE_ROOM`` positions: (last-token logits, cache, wall s); the wall
    on the host clock, ending in a synchronize on the card."""
    import torch
    from repro_torch.models import transformer as tr
    _sync(tokens)
    t = time.perf_counter()
    logits, cache = tr.prefill(params, c, tokens)
    _sync(tokens)
    wall = time.perf_counter() - t
    return logits, {k: torch.nn.functional.pad(v, (0, 0, 0, DECODE_ROOM))
                    for k, v in cache.items()}, wall


def decode_greedy(params, c, logits, cache, s, steps, feed=None):
    """``steps`` decode steps from a prefill of length ``s``: each feeds the
    argmax of the last logits (or ``feed[i]``).  Returns (the logits of
    each step, the tokens fed, the cache, the step walls s)."""
    import torch
    from repro_torch.models import transformer as tr
    kv = torch.full((logits.shape[0],), s, dtype=torch.int32,
                    device=logits.device)
    outs, fed, walls = [], [], []
    for i in range(steps):
        nxt = (feed[i].to(logits.device) if feed is not None
               else logits[:, :c.vocab].argmax(dim=-1).to(torch.int32))
        fed.append(nxt)
        _sync(kv)
        t = time.perf_counter()
        logits, cache = tr.decode_step(params, c, nxt, cache, kv)
        _sync(kv)
        walls.append(time.perf_counter() - t)
        outs.append(logits)
        kv = kv + 1
    return outs, fed, cache, walls


def greedy(params, c, tokens, steps):
    """A prefill then ``steps`` greedy steps: (the logits of the prefill and
    of each step, the tokens fed, the final cache, the prefill wall, the
    step walls)."""
    logits, cache, t_prefill = prefill_padded(params, c, tokens)
    outs, fed, cache, walls = decode_greedy(params, c, logits, cache,
                                            tokens.shape[1], steps)
    return [logits] + outs, fed, cache, t_prefill, walls


def _rel_err(a, b):
    """max |a - b| over the largest |b| (a moved to b's device)."""
    return float((a.to(b.device) - b).abs().max() / b.abs().max())


class FirstMoEInput:
    """Keeps the tokens (T, d) of the first MoE FFN call (a prefill's layer
    0) while passing every call through, and the layer's router with it."""

    def __enter__(self):
        from repro_torch.models import transformer as tr
        self.tr, self.orig, self.x = tr, tr.moe_forward, None

        def wrapped(p, x, cfg, *args, **kw):
            if self.x is None:
                self.x, self.router, self.cfg = x.clone(), p["router"], cfg
            return self.orig(p, x, cfg, *args, **kw)
        tr.moe_forward = wrapped
        return self

    def __exit__(self, *exc):
        self.tr.moe_forward = self.orig

    def routes(self):
        """(each token's top-k experts, which of them took it, each
        token's gap between its k-th and (k+1)-th gate) on the host."""
        from repro_torch.models import moe
        gates, _, tope = moe.route(self.router, self.x, self.cfg)
        kept = moe.kept(tope, self.cfg.n_experts,
                        moe.capacity(self.x.shape[0], self.cfg))
        top = gates.sort(dim=-1, descending=True).values
        k = self.cfg.top_k
        return tope.cpu(), kept.cpu(), (top[:, k - 1] - top[:, k]).cpu()


def fan_in_scale(params, stacked=None, keep=("router",)):
    """Rescale, in place, each stacked layer matrix of ``params`` (leaves
    (L, ..., fan-in, fan-out), drawn at the reference's 1/√L) to 1/√(its
    fan-in); the leaves named in ``keep`` (the MoE router, 0.02) and the
    norms stay.  ``stacked`` names another dict of stacked leaves, nested
    dicts included, to rescale in place of the LM's layers (the ``blocks``
    of BERT4Rec and DimeNet)."""
    groups = ([stacked] if stacked is not None else
              [params["layers"][group] for group in ("attn", "ffn")])
    for leaves_ in groups:
        for key, w in leaves_.items():
            if isinstance(w, dict):
                fan_in_scale(params, w, keep)
            elif w.dim() > 2 and key not in keep:
                w.mul_(math.sqrt(w.shape[0] / w.shape[-2]))
    return params


def lm_cross_check(dev, xc_len, c=None, label="LM", steps=XC_STEPS,
                   draw="cpu", fan_in=False):
    """A 2-layer model at full width in fp32 (``c``; Yi-6B by default),
    drawn on the host, on the card and on the CPU: prefill of
    ``XC_PROMPTS`` prompts of ``xc_len`` tokens and ``steps`` greedy steps
    on each, and the card's steps once more from the CPU's prefill cache
    and tokens, which separates the decode path's own error from what it
    inherits from the caches (module docstring, 17a); for an MoE model
    also the experts and capacity drops of every token in layer 0 of the
    prefill, card = CPU, and the smallest gap between a token's k-th and
    (k+1)-th gate.  The weights are drawn on ``draw`` (the host, or the
    card: faster for a large model) and copied to the other device; with
    ``fan_in``, each layer matrix at 1/√(its fan-in) (``fan_in_scale``)
    in place of the reference's 1/√L.  Every number is logged before any
    check.  Returns the card's recorded kernel calls."""
    import numpy as np
    import torch
    from repro_torch.configs import yi_6b
    from repro_torch.models import transformer as tr
    if c is None:
        c = dataclasses.replace(yi_6b.CONFIG, n_layers=2, dtype="float32")
    t = time.perf_counter()
    drawn = tr.init(c, seed=SEED, device=draw)
    if fan_in:
        fan_in_scale(drawn)
    if drawn["embed"].is_cuda:
        card, host = drawn, tree_to(drawn, "cpu")
    else:
        host, card = drawn, tree_to(drawn, dev)
    log(f"{label} cross-check: 2-layer {c.name} fp32, {c.param_count()} "
        f"parameters, drawn on the {'card' if drawn is card else 'host'} "
        + ("at 1/√(fan-in) " if fan_in else "")
        + f"and copied in {time.perf_counter() - t:.1f} s")
    toks = np.random.RandomState(SEED).randint(0, c.vocab,
                                               (XC_PROMPTS, xc_len))
    toks = torch.from_numpy(toks)
    with Recorder(LM_KERNELS, clone=True) as rec, FirstMoEInput() as a_moe:
        a_outs, a_fed, a_cache, a_prefill, _ = greedy(card, c, toks.to(dev),
                                                      steps)
    t = time.perf_counter()
    with FirstMoEInput() as b_moe:
        logits, cache, _ = prefill_padded(host, c, toks)
    start = {k: v.clone() for k, v in cache.items()}
    b_outs, b_fed, b_cache, _ = decode_greedy(host, c, logits, cache, xc_len,
                                              steps)
    log(f"{label} cross-check: card prefill {a_prefill:.3f} s (first call), "
        f"CPU prefill and {steps} steps {time.perf_counter() - t:.1f} s")
    iso_outs, _, _, _ = decode_greedy(card, c, logits.to(dev),
                                      tree_to(start, dev), xc_len, steps,
                                      feed=b_fed)
    routes_same = True
    if c.moe is not None:
        (a_e, a_k, _), (b_e, b_k, gap) = a_moe.routes(), b_moe.routes()
        routes_same = torch.equal(a_e, b_e) and torch.equal(a_k, b_k)
        log(f"{label} cross-check: layer 0 of the prefill routes "
            f"{a_e.shape[0]} tokens to {c.moe.top_k} of {c.moe.n_experts} "
            f"experts: card = CPU {routes_same} (experts "
            f"{torch.equal(a_e, b_e)}, drops {torch.equal(a_k, b_k)}), "
            f"{int((~b_k).sum())} pairs dropped; smallest gap between a "
            f"token's k-th and (k+1)-th gate {float(gap.min()):.3e} "
            f"(median {float(gap.median()):.3e})")
    e_prefill = _rel_err(a_outs[0], logits)
    e_own = [_rel_err(x, y) for x, y in zip(a_outs[1:], b_outs)]
    e_iso = [_rel_err(x, y) for x, y in zip(iso_outs, b_outs)]
    same = [torch.equal(x.cpu(), y) for x, y in zip(a_fed, b_fed)]
    log(f"{label} cross-check: logits error over their largest magnitude: "
        f"prefill {e_prefill:.3e}; steps from each device's own cache "
        + " ".join(f"{e:.3e}" for e in e_own)
        + "; steps from the CPU's cache " + " ".join(f"{e:.3e}" for e in e_iso))
    cache_errs = {}
    for key, y in b_cache.items():
        d = (a_cache[key].cpu() - y).abs()
        top = float(y.abs().max())
        cache_errs[key] = (float(d.max()) / top, float(d.mean()) / top)
        log(f"{label} cross-check: {key} cache max error "
            f"{cache_errs[key][0]:.3e}, mean {cache_errs[key][1]:.3e} of its "
            f"largest magnitude {top:.2f}")
    log(f"{label} cross-check: greedy tokens equal per step {same} "
        f"({[x.tolist() for x in a_fed]})")
    check(routes_same, f"{label} cross-check: layer 0's experts or drops "
          f"differ")
    check(e_prefill <= XC_LOGIT_TOL, f"{label} cross-check: prefill logits "
          f"differ by {e_prefill} of their largest magnitude")
    check(max(e_iso) <= XC_LOGIT_TOL, f"{label} cross-check: decode logits "
          f"from the same cache differ beyond the tolerance")
    check(max(e_own) <= XC_CACHE_TOL, f"{label} cross-check: decode logits "
          f"from each device's cache differ beyond the caches' tolerance")
    check(all(same), f"{label} cross-check: greedy tokens differ")
    for key, (e, mean) in cache_errs.items():
        check(e <= XC_CACHE_TOL and mean <= XC_CACHE_MEAN_TOL,
              f"{label} cross-check: {key} cache differs by {e} (mean "
              f"{mean})")
    return rec.calls


def lm_serve(dev, n_layers, prompt, steps, profile=False, c=None,
             label="LM"):
    """A model in bf16 on the card (``c``, Yi-6B by default; ``n_layers``
    of it): a warm-up pass (prefill of ``LM_BATCH`` prompts, ``steps``
    greedy steps) that records layer 0's kernel calls, then the counted
    pass (module docstring, 17b and 18b): ``flash_attention`` once a layer,
    ``flash_decode`` once a layer and step (none with MLA, whose decode is
    the absorbed form); with ``profile``, one more prefill and one more
    step under ``torch.profiler``.  Returns (launches of the counted pass,
    the recorded calls)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import yi_6b
    from repro_torch.models import transformer as tr
    c = dataclasses.replace(c or yi_6b.CONFIG, n_layers=n_layers)
    t = time.perf_counter()
    params = tr.init(c, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"{label} serve: {c.name}, {n_layers} layers, bf16, "
        f"{c.param_count()} parameters drawn on the card in "
        f"{time.perf_counter() - t:.1f} s; {torch.cuda.memory_allocated()} B"
        f" in use")
    toks = np.random.RandomState(SEED + 1).randint(0, c.vocab,
                                                   (LM_BATCH, prompt))
    toks = torch.from_numpy(toks).to(dev)
    with Recorder(LM_KERNELS, first=True, clone=True) as rec:
        warm = greedy(params, c, toks, steps)
    log(f"{label} serve: warm-up prefill {warm[3]:.3f} s, first step "
        f"{1e3 * warm[4][0]:.2f} ms")
    del warm
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    outs, fed, cache, t_prefill, walls = greedy(params, c, toks, steps)
    launches = dict(kernels.LAUNCHES)
    log(f"{label} serve: launches {launches}")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          f"{label} serve: non-finite logits")
    check(launches["flash_attention"] == n_layers,
          f"{label} serve: flash_attention launched "
          f"{launches['flash_attention']} times, not once a layer "
          f"({n_layers})")
    n_decode = 0 if c.attention == "mla" else n_layers * steps
    check(launches["flash_decode"] == n_decode,
          f"{label} serve: flash_decode launched {launches['flash_decode']} "
          f"times, not {n_decode} (once a layer and step, none with MLA)")
    med = statistics.median(walls)
    log(f"{label} serve: prefill {LM_BATCH} x {prompt} tokens in "
        f"{t_prefill:.4f} s ({LM_BATCH * prompt / t_prefill:.0f} tokens/s)")
    log(f"{label} serve: decode ms per step ({LM_BATCH} sequences, cache "
        f"{prompt + DECODE_ROOM}): "
        + " ".join(f"{1e3 * w:.2f}" for w in walls)
        + f" (median {1e3 * med:.3f}, {LM_BATCH / med:.1f} tokens/s)")
    log(f"{label} serve: device memory {torch.cuda.memory_allocated()} B in "
        f"use, {torch.cuda.max_memory_allocated()} B peak in the counted "
        f"pass; cache "
        f"{sum(v.numel() * v.element_size() for v in cache.values())} B; "
        f"last greedy tokens {fed[-1].tolist()}")
    if profile:
        prof, wall = run_profiled(lambda: tr.prefill(params, c, toks))
        log_profile(prof, wall, f"profile {label} prefill")
        nxt = outs[-1][:, :c.vocab].argmax(dim=-1).to(torch.int32)
        kv = torch.full((LM_BATCH,), prompt + steps, dtype=torch.int32,
                        device=dev)
        prof, wall = run_profiled(lambda: tr.decode_step(params, c, nxt,
                                                         cache, kv))
        log_profile(prof, wall, f"profile {label} decode step")
    return launches, rec.calls


def lm_edge_calls(dev):
    """Seeded edge inputs of the two attention kernels, drawn on the card:
    ragged S (200, 700) causal and not, Sq != Sk, GQA groups 1, 3, 4 and 8,
    head widths 16 to 128, fp32 and bf16, a strided q/k/v as the model
    passes them; in bf16 also the tensor-core kernel's 128-row and 128-key
    tile edges (S = 1, 127, 128, 129, 4,097), D = 16 and 128, Sq != Sk and
    a strided GQA-8 view; for decode ragged T, kv_len 0, 1, 512, 513 and T,
    GQA groups 1 to 32 (3 among them) and head widths 16 to 128 in both
    types, and
    ``decode_32k``'s cache (B = 8, T = 32,768, bf16).  Lists of (args,
    kwargs) per kernel."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)

    def randn(shape, dt, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale).to(dt)

    prefill = []
    for b, h, hkv, sq, sk, d, dt, causal in (
            (1, 8, 8, 200, 200, 64, f32, True),
            (2, 8, 2, 200, 200, 128, bf16, False),
            (1, 16, 2, 700, 700, 128, f32, True),
            (1, 8, 1, 700, 700, 64, bf16, True),
            (2, 4, 1, 700, 700, 64, f32, False),
            (1, 8, 2, 100, 300, 64, f32, False),
            (1, 4, 4, 64, 64, 16, f32, True),
            (1, 4, 2, 96, 96, 32, bf16, True),
            (1, 8, 1, 1, 1, 128, bf16, True),
            (2, 8, 8, 127, 127, 16, bf16, True),
            (1, 8, 1, 128, 128, 128, bf16, True),
            (2, 8, 2, 129, 129, 128, bf16, False),
            (2, 4, 4, 129, 129, 16, bf16, True),
            (1, 8, 1, 4097, 4097, 128, bf16, True),
            (1, 8, 2, 100, 300, 128, bf16, False),
            # GQA groups of 3 (granite: 24 query heads over 8 kv heads)
            (1, 6, 2, 300, 300, 64, bf16, True),
            (2, 24, 8, 200, 200, 64, bf16, False),
            (1, 12, 4, 129, 129, 64, f32, True),
            (2, 6, 2, 700, 700, 64, f32, False)):
        prefill.append(((randn((b, h, sq, d), dt, 0.4),
                      randn((b, hkv, sk, d), dt, 0.4),
                      randn((b, hkv, sk, d), dt)), dict(causal=causal)))
    # (B, S, H, D) viewed as (B, H, S, D), as the model passes q, k, v
    for b, s, h, hkv, d, dt in ((1, 300, 8, 2, 64, f32),
                                (2, 300, 32, 4, 128, bf16),
                                (1, 300, 24, 8, 64, bf16)):
        prefill.append(((randn((b, s, h, d), dt, 0.4).transpose(1, 2),
                         randn((b, s, hkv, d), dt, 0.4).transpose(1, 2),
                         randn((b, s, hkv, d), dt).transpose(1, 2)),
                        dict(causal=True)))
    decode = []
    for b, h, hkv, t, d, dt, lens in (
            (4, 8, 8, 700, 64, f32, (1, 512, 513, 700)),
            (4, 32, 4, 1500, 128, bf16, (1, 512, 513, 1500)),
            (2, 16, 4, 4608, 128, f32, (4608, 4097)),
            (2, 8, 2, 300, 32, f32, (0, 300)),
            (2, 8, 2, 520, 16, bf16, (2, 519)),
            # the redesigned kernel's edges: groups 1 to 32 (a block takes
            # 16 heads a pass in bf16, 8 in fp32: two passes at 32 and 16),
            # every head width in both types, kv_len 0, 1, on a split
            # boundary and T, T off the split
            (3, 4, 2, 1100, 64, bf16, (0, 1024, 1100)),
            (2, 4, 2, 1100, 64, f32, (1, 1024)),
            (2, 16, 2, 513, 16, f32, (513, 1)),
            (3, 4, 4, 1536, 32, bf16, (1536, 0, 1025)),
            (2, 12, 2, 2049, 128, f32, (2048, 2049)),
            (2, 12, 2, 2049, 128, bf16, (512, 2049)),
            (1, 32, 2, 777, 64, bf16, (777,)),
            (1, 32, 2, 777, 64, f32, (700,)),
            (1, 32, 1, 600, 128, bf16, (600,)),
            (2, 8, 1, 96, 32, f32, (96, 95)),
            (2, 8, 8, 64, 16, bf16, (64, 0)),
            # GQA groups of 3, ragged T
            (2, 24, 8, 700, 64, bf16, (1, 700)),
            (2, 6, 2, 1100, 64, f32, (513, 1100)),
            (1, 12, 4, 520, 128, bf16, (519,))):
        decode.append(((randn((b, h, d), dt, 0.4),
                     randn((b, hkv, t, d), dt, 0.4), randn((b, hkv, t, d), dt),
                     torch.tensor(lens, dtype=torch.int32, device=dev)), {}))
    return {"flash_attention": prefill, "flash_decode": decode}


def mla_edge_calls(dev):
    """Seeded edge inputs of the prefill kernels at MLA's width pair (q/k
    96, v 64), drawn on the card: S = 1, 127, 128, 129, 700 and 4,097
    causal and not, Sq != Sk (not causal), Hkv = H and GQA groups of 4, fp32
    and bf16, and the strided views ``mla_forward`` passes ((B, S, H, .)
    tensors transposed to (B, H, S, .), q and k concatenated from their
    no-rope and rope parts).  A list of (args, kwargs)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)

    def randn(shape, dt, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale).to(dt)

    calls = []
    for b, h, hkv, sq, sk, dt, causal in (
            (1, 8, 8, 1, 1, bf16, True), (1, 8, 2, 1, 1, f32, False),
            (2, 8, 8, 127, 127, bf16, True), (2, 8, 2, 127, 127, f32, False),
            (1, 8, 2, 128, 128, bf16, False), (1, 8, 8, 128, 128, f32, True),
            (2, 4, 4, 129, 129, bf16, True), (2, 4, 1, 129, 129, bf16, False),
            (1, 8, 8, 129, 129, f32, True),
            (1, 8, 8, 700, 700, bf16, True), (1, 8, 2, 700, 700, bf16, False),
            (1, 4, 4, 700, 700, f32, True), (1, 4, 1, 700, 700, f32, False),
            (1, 4, 4, 4097, 4097, bf16, True),
            (1, 4, 1, 4097, 4097, bf16, False),
            (1, 4, 4, 4097, 4097, f32, True),
            (1, 8, 2, 100, 300, bf16, False), (1, 8, 8, 100, 300, f32, False)):
        calls.append(((randn((b, h, sq, 96), dt, 0.4),
                       randn((b, hkv, sk, 96), dt, 0.4),
                       randn((b, hkv, sk, 64), dt)), dict(causal=causal)))
    for b, s, h, dt in ((2, 300, 8, bf16), (1, 700, 4, f32)):
        q = torch.cat([randn((b, s, h, 64), dt, 0.4),
                       randn((b, s, h, 32), dt, 0.4)], dim=-1)
        k = torch.cat([randn((b, s, h, 64), dt, 0.4),
                       randn((b, s, 1, 32), dt, 0.4).expand(b, s, h, 32)],
                      dim=-1)
        calls.append(((q.transpose(1, 2), k.transpose(1, 2),
                       randn((b, s, h, 64), dt).transpose(1, 2)),
                      dict(causal=True, scale=96 ** -0.5)))
    return calls


def decode_32k_call(dev):
    """``decode_32k``'s decode attention at B = 8 (cut from 128): a bf16
    cache of 32,768 positions (537 MB of k and v), kv_len drawn in [1,
    32,768] with one row full."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    b, h, hkv, t, d = 8, 32, 4, 32768, 128

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(
            scale).to(torch.bfloat16)
    kv_len = torch.randint(1, t + 1, (b,), generator=gen, device=dev,
                           dtype=torch.int32)
    kv_len[-1] = t
    return (randn((b, h, d), 0.4), randn((b, hkv, t, d), 0.4),
            randn((b, hkv, t, d)), kv_len), {}


def bf16_rel_err(got, want):
    """max |got - want| / max(1, |want|): what ``BF16_TOL`` bounds."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / w.abs().clamp(min=1.0)).max())


def compare_attention(label, got, want, model=False):
    """Max abs error of an attention output against its plain version or
    oracle; raises beyond the stated tolerance (module docstring, 17c)."""
    import torch
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: kernel output {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
    err = (g - w).abs()
    e = float(err.max())
    if got.dtype == torch.bfloat16:
        rel = bf16_rel_err(got, want)
        check(rel <= BF16_TOL, f"{label}: bf16 error {rel} of max(1, |want|)"
              f" > {BF16_TOL}")
    elif model:
        top = float(w.abs().max())
        check(e <= MODEL_F32_TOL * top and float(err.mean()) <= 1e-5 * top,
              f"{label}: max error {e} (mean {float(err.mean())}) against "
              f"the largest output {top}")
    else:
        check(e <= 1e-5, f"{label}: max abs error {e} > 1e-05")
    return e


def attention_library_calls():
    """The one PyTorch call computing each LM kernel's function:
    ``scaled_dot_product_attention`` with GQA (and, for decode, a boolean
    mask of the valid positions, built outside the timed call); a
    yardstick, used nowhere in the port."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def prefill(args, kw):
        q, k, v = args
        return lambda: sdpa(q, k, v, is_causal=kw.get("causal", True),
                            scale=kw.get("scale"), enable_gqa=True)

    def decode(args, kw):
        q, k, v, kv_len = args
        pos = torch.arange(k.shape[2], device=k.device)
        mask = (pos[None, :] < kv_len[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        return lambda: sdpa(q4, k, v, attn_mask=mask, scale=kw.get("scale"),
                            enable_gqa=True)

    return {"flash_attention": prefill, "flash_decode": decode}


def lm_kernel_phase(recorded, launches, dev):
    """Rows of kernels 8 and 9 (module docstring, 17c): every recorded call
    against the model's plain path, the edge cases against the oracles,
    every bf16 prefill call also against ``attention_tc_plain`` (the
    tensor-core kernel's own arithmetic), the ``decode_32k`` call, and the
    timing of the largest recorded call; for kernel 8 also the fp32
    CUDA-core kernel on the largest fp32 recorded call, on a line of its
    own."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import attention as attn
    kern = {"flash_attention": fa.flash_attention,
            "flash_decode": fa.flash_decode}
    plain = {"flash_attention": attn.chunked_attention_plain,
             "flash_decode": attn.gqa_decode_plain}
    oracle = {"flash_attention": fa.attention_ref,
              "flash_decode": fa.decode_ref}
    library = attention_library_calls()
    edges = lm_edge_calls(dev)
    rows = {}
    for name in LM_KERNELS:
        calls = recorded[name]
        check(calls, f"{name}: the LM path never called it")
        errs = {torch.float32: 0.0, torch.bfloat16: 0.0}   # by dtype
        worst_bf16 = 0.0     # of max(1, |want|), what BF16_TOL bounds
        n_f32 = 0            # fp32 prefill calls held by f32_check
        for args, kw in calls:
            got = kern[name](*args, **kw)
            want = plain[name](*args, **kw)
            torch.cuda.synchronize()
            if got.dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, bf16_rel_err(got, want))
                if name == "flash_attention":
                    attention_diagnosis(name, got, want, args, kw)
            errs[got.dtype] = max(
                errs[got.dtype], compare_attention(name, got, want, True),
                tc_plain_error(name, got, args, kw),
                split_merge_error(name, got, args, kw, True))
            if name == "flash_attention" and got.dtype == torch.float32:
                n_f32 += 1
                errs[got.dtype] = max(errs[got.dtype], f32_check(
                    f"{name} fp32 {tuple(args[0].shape)}", args, kw,
                    "model"))
            if name == "flash_attention" and got.dtype == torch.bfloat16:
                once = fa.attention_tc_plain(*args, **kw, p_halves=1)
                log(f"flash_attention {tuple(args[0].shape)}: the kernel "
                    f"(P as bf16 hi + lo) gives {bf16_rel_err(got, want)} "
                    f"of max(1, |want|) against the plain path; P rounded "
                    f"once to bf16 would give {bf16_rel_err(once, want)} "
                    f"(BF16_TOL {BF16_TOL}); largest |want| "
                    f"{float(want.float().abs().max())}")
        for args, kw in edges[name]:
            got = kern[name](*args, **kw)
            want = oracle[name](*args, **kw)
            torch.cuda.synchronize()
            if got.dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, bf16_rel_err(got, want))
            errs[got.dtype] = max(
                errs[got.dtype],
                compare_attention(f"{name} edge", got, want),
                tc_plain_error(f"{name} edge", got, args, kw),
                split_merge_error(f"{name} edge", got, args, kw))
            if name == "flash_attention" and got.dtype == torch.float32:
                n_f32 += 1
                errs[got.dtype] = max(errs[got.dtype], f32_check(
                    f"{name} fp32 edge {tuple(args[0].shape)}", args, kw))
        if name == "flash_attention":
            log(f"flash_attention bf16: worst error of max(1, |want|) over "
                f"the recorded and edge calls {worst_bf16}")
            tile_edges = f32_edge_calls(dev)
            for args, kw in tile_edges:
                errs[torch.float32] = max(errs[torch.float32], f32_check(
                    f"{name} fp32 tile edge {tuple(args[0].shape)} "
                    f"{tuple(args[1].shape)} {kw}", args, kw))
            n_f32 += len(tile_edges)
            del tile_edges
            log(f"flash_attention fp32: {n_f32} recorded and edge calls "
                f"({len(F32_TILE_EDGES)} tile edges at D 16 and 32, rows "
                f"off 16 bytes, BERT4Rec's training call with the "
                f"log-sum-exp among them) against attention_ref and "
                f"attention_f32_tiles_plain, two launches bit-equal on "
                f"each; worst error {errs[torch.float32]}")
        # kernel 8's row holds the bf16 kernel; kernel 9 has one kernel
        err = (errs[torch.bfloat16] if name == "flash_attention"
               else max(errs.values()))
        note = f"{len(calls)} model calls and {len(edges[name])} edge cases"
        if name == "flash_decode":
            args, kw = decode_32k_call(dev)
            got = kern[name](*args, **kw)
            err = max(err, compare_attention(
                "flash_decode decode_32k", got, oracle[name](*args, **kw)),
                split_merge_error("flash_decode decode_32k", got, args, kw))
            del got
            torch.cuda.synchronize()
            row = kernel_row(name, kern[name], plain[name], library[name],
                             args, kw, err, "decode_32k (B 8, T 32,768, "
                             "bf16; timed apart from the row's call)")
            log_redesign("flash_decode decode_32k", row["ms"],
                         lambda: kern[name](*args, **kw))
            note += " and decode_32k"
        def largest(dtype=None):
            return max((c for c in calls
                        if dtype is None or c[0][0].dtype == dtype),
                       key=lambda c: work_of(name, *c)[0])
        if name == "flash_attention":
            args, kw = largest(torch.float32)
            kernel_row(name, kern[name], plain[name], library[name], args,
                       kw, errs[torch.float32], "fp32 CUDA-core kernel "
                       "(flash_attention.cu) on the largest fp32 recorded "
                       "call, all fp32 calls checked")
            args, kw = largest(torch.bfloat16)
        else:
            args, kw = largest()
        rows[name] = kernel_row(name, kern[name], plain[name], library[name],
                                args, kw, err, note + " checked")
        rows[name]["launches"] = launches[name]
        if name in EARLIER_MS:
            log_redesign(name, rows[name]["ms"],
                         lambda: kern[name](*args, **kw))
        if name == "flash_attention":
            row = rows[name]
            ops = work_of(name, args, kw)[1]
            log(f"kernel flash_attention ({args[0].dtype}, "
                f"{tuple(args[0].shape)}, tensor cores): "
                f"{ops / row['ms'] / 1e9:.1f} TFLOP/s, "
                f"{100 * row['bound_ms'] / row['ms']:.1f} % of the bound; "
                f"SDPA {ops / row['library_ms'] / 1e9:.1f} TFLOP/s, "
                f"{100 * row['bound_ms'] / row['library_ms']:.1f} %")
    return rows


def attention_diagnosis(label, got, want, args, kw):
    """For a bf16 prefill call held to the plain path ``want``: at the
    element where the kernel is furthest from it (what ``BF16_TOL``
    bounds), the kernel's, the plain path's, ``attention_tc_plain``'s and
    ``attention_ref``'s errors on that (b, h) slice against each other and
    against the attention computed in fp64 from the same bf16 inputs, and
    the row's largest logit (scaled, masked) with the gap between its two
    largest; logged, and returned as a dict.  A kernel fault shows as the
    kernel far from ``attention_tc_plain`` and from the fp64 attention
    while they agree; an ill-conditioned row (a near-tie of its top logits,
    at logits in the thousands) as every path, the fp32 ones too, far from
    the fp64 attention."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    q, k, v = args
    causal = kw.get("causal", True)
    scale = kw.get("scale") or q.shape[-1] ** -0.5
    g, w = got.float(), want.float()
    rel = (g - w).abs() / w.abs().clamp(min=1.0)
    b, h, r, col = (int(i) for i in np.unravel_index(int(rel.argmax()),
                                                     tuple(rel.shape)))
    kvh = h // (q.shape[1] // k.shape[1])
    qs, ks, vs = q[b:b + 1, h:h + 1], k[b:b + 1, kvh:kvh + 1], \
        v[b:b + 1, kvh:kvh + 1]
    outs = {"kernel": got[b:b + 1, h:h + 1], "plain": want[b:b + 1, h:h + 1],
            "tc_plain": fa.attention_tc_plain(qs, ks, vs, **kw),
            "ref": fa.attention_ref(qs, ks, vs, **kw)}
    lg = qs.double() @ ks.double().transpose(-1, -2) * scale
    if causal:
        lg = torch.where(torch.ones(lg.shape[-2:], dtype=torch.bool,
                                    device=lg.device).tril(), lg, -1e300)
    outs["fp64"] = torch.softmax(lg, dim=-1) @ vs.double()
    n = r + 1 if causal else k.shape[2]
    logits = (q[b, h, r].float() @ k[b, kvh, :n].float().T) * scale
    top = logits.topk(min(2, n)).values
    errs = {f"{x} vs {y}": bf16_rel_err(outs[x], outs[y])
            for x, y in (("kernel", "plain"), ("kernel", "tc_plain"),
                         ("kernel", "ref"), ("tc_plain", "ref"),
                         ("plain", "ref"), ("tc_plain", "plain"),
                         ("kernel", "fp64"), ("plain", "fp64"),
                         ("tc_plain", "fp64"), ("ref", "fp64"))}
    out = dict(at=(b, h, r, col), largest_logit=float(top[0]),
               gap=float(top[0] - top[-1]), **errs)
    log(f"{label} {tuple(q.shape)} diagnosis at (b, h, row, col) "
        f"{out['at']}: errors of max(1, |y|) "
        + ", ".join(f"{key} {e:.4g}" for key, e in errs.items())
        + f"; the row's largest logit {out['largest_logit']:.6g}, gap to "
        f"the second {out['gap']:.4g}")
    return out


def moe_mla_phase(dev, lm_layers, lm_prompt, lm_steps, profile=False):
    """The MoE and MLA phase (module docstring, 18): for granite-MoE,
    Moonlight and MiniCPM3, the fp32 cross-check of 2 layers at full width,
    then the bf16 serve; then kernel 8 at MLA's width pair.  A quick run
    (``lm_layers`` below Yi-6B's 32) cuts each model to ``lm_layers``
    layers, and ``lm_prompt`` / ``lm_steps`` cut the prompts and steps."""
    import importlib

    import torch
    from repro_torch.configs import yi_6b
    recorded = {n: [] for n in LM_KERNELS}
    for name in MOE_MLA_CONFIGS:
        t = time.perf_counter()
        c = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
        n_layers = MM_LAYERS[name]
        if lm_layers < yi_6b.CONFIG.n_layers:
            n_layers = min(n_layers, lm_layers)
        xc = lm_cross_check(
            dev, min(MM_XC_LEN, lm_prompt),
            dataclasses.replace(c, n_layers=2, dtype="float32"), c.name,
            min(MM_XC_STEPS, lm_steps), draw=dev, fan_in=True)
        torch.cuda.empty_cache()
        _, calls = lm_serve(dev, n_layers, min(MM_PROMPT, lm_prompt),
                            min(MM_STEPS, lm_steps), profile, c, c.name)
        torch.cuda.empty_cache()
        for n in LM_KERNELS:
            recorded[n] += calls[n] + xc[n]
        log(f"{c.name}: cross-check and serve in "
            f"{time.perf_counter() - t:.1f} s")
    mla_kernel_rows(recorded, dev)


def mla_kernel_rows(recorded, dev):
    """Kernels 8 and 9 on the MoE and MLA models' recorded calls against
    the model's plain path (and, in bf16, ``attention_tc_plain``; decode
    also against ``merge_splits``), kernel 8 at MLA's (96, 64) on the edge
    cases of ``mla_edge_calls`` against ``attention_ref``, and the largest
    bf16 MLA call timed beside the plain path and SDPA (module docstring,
    18c)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import attention as attn
    kern = {"flash_attention": fa.flash_attention,
            "flash_decode": fa.flash_decode}
    plain = {"flash_attention": attn.chunked_attention_plain,
             "flash_decode": attn.gqa_decode_plain}
    mla_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name in LM_KERNELS:
        for args, kw in recorded[name]:
            got = kern[name](*args, **kw)
            want = plain[name](*args, **kw)
            torch.cuda.synchronize()
            if name == "flash_attention" and got.dtype == torch.bfloat16:
                attention_diagnosis(name, got, want, args, kw)
            e = max(compare_attention(name, got, want, True),
                    tc_plain_error(name, got, args, kw),
                    split_merge_error(name, got, args, kw, True))
            if name == "flash_attention" and got.dtype == torch.float32:
                e = max(e, f32_check(f"{name} fp32 {tuple(args[0].shape)}",
                                     args, kw, "model"))
            if name == "flash_attention" and args[0].shape[-1] == 96:
                mla_err[got.dtype] = max(mla_err[got.dtype], e)
    n_rec = {n: len(recorded[n]) for n in LM_KERNELS}
    edges = mla_edge_calls(dev)
    for args, kw in edges:
        got = fa.flash_attention(*args, **kw)
        want = fa.attention_ref(*args, **kw)
        torch.cuda.synchronize()
        mla_err[got.dtype] = max(
            mla_err[got.dtype],
            compare_attention("flash_attention MLA edge", got, want),
            tc_plain_error("flash_attention MLA edge", got, args, kw))
        if got.dtype == torch.float32:
            mla_err[got.dtype] = max(mla_err[got.dtype], f32_check(
                f"flash_attention fp32 MLA edge {tuple(args[0].shape)}",
                args, kw))
    log(f"MoE and MLA kernel rows: {n_rec} recorded calls against the plain"
        f" path, {len(edges)} edge cases at (96, 64) against attention_ref; "
        f"largest absolute error at (96, 64): fp32 {mla_err[torch.float32]},"
        f" bf16 {mla_err[torch.bfloat16]}")
    mla = [c for c in recorded["flash_attention"]
           if c[0][0].shape[-1] == 96 and c[0][0].dtype == torch.bfloat16]
    check(mla, "flash_attention: the MLA serve never called it at (96, 64)")
    args, kw = max(mla, key=lambda c: work_of("flash_attention", *c)[0])
    row = kernel_row("flash_attention", fa.flash_attention,
                     attn.chunked_attention_plain,
                     attention_library_calls()["flash_attention"], args, kw,
                     mla_err[torch.bfloat16],
                     f"MLA (96, 64) bf16 {tuple(args[0].shape)} q, "
                     f"{tuple(args[2].shape)} v")
    ops = work_of("flash_attention", args, kw)[1]
    log(f"kernel flash_attention MLA (96, 64) ({tuple(args[0].shape)}, "
        f"tensor cores): {ops / row['ms'] / 1e9:.1f} TFLOP/s, "
        f"{100 * row['bound_ms'] / row['ms']:.1f} % of the bound; SDPA "
        f"{ops / row['library_ms'] / 1e9:.1f} TFLOP/s, "
        f"{100 * row['bound_ms'] / row['library_ms']:.1f} %")


def split_merge_error(label, got, args, kw, model=False):
    """For a decode call: the kernel's output, merged on the card, against
    ``merge_splits`` of ``decode_partials_plain`` (the split and merge
    kernels' arithmetic in plain PyTorch), under the oracle's tolerance (0
    for any other call)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    if not label.startswith("flash_decode"):
        return 0.0
    want = fa.merge_splits(*fa.decode_partials_plain(*args, **kw), got.dtype)
    torch.cuda.synchronize()
    return compare_attention(f"{label} (split partials + merge_splits)", got,
                             want, model)


def tc_plain_error(label, got, args, kw):
    """For a bf16 prefill call: the kernel's output against
    ``attention_tc_plain``, the tensor-core kernel's arithmetic in plain
    PyTorch, under ``BF16_TOL`` (0 for any other call)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    if not label.startswith("flash_attention") or \
            got.dtype != torch.bfloat16:
        return 0.0
    want = fa.attention_tc_plain(*args, **kw)
    torch.cuda.synchronize()
    return compare_attention(f"{label} (tensor-core plain)", got, want)


def f32_edge_calls(dev):
    """Seeded fp32 inputs at the edges of kernel 8's fp32 forward tiles,
    drawn on the card: Sq and Sk of ``F32_TILE_EDGES`` at D 16 and 32,
    causal (Sq = Sk, Hkv = H) and not (GQA group 2; at D 32 every (Sq, Sk)
    pair, at D 16 Sq = Sk and Sq against the list reversed); D 64 and 128
    across a 32-key tile; S of 63 to 129 around a 64-key tile and a
    128-row block; views whose rows are off a 16-byte boundary
    (the kernel's 4-byte copies) at D 32 and 64, causal and not; and
    BERT4Rec's training call (4,096, 2, 200, 32) as the model passes it
    ((B, S, H·D) tensors viewed as (B, H, S, D)) with the log-sum-exp.  A
    list of (args, kwargs)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    def qkv(b, h, hkv, sq, sk, d):
        return (randn((b, h, sq, d), 0.4), randn((b, hkv, sk, d), 0.4),
                randn((b, hkv, sk, d)))

    calls = []
    edges = F32_TILE_EDGES
    for d in (16, 32):
        for i, sq in enumerate(edges):
            calls.append((qkv(1, 2, 2, sq, sq, d), dict(causal=True)))
            sks = edges if d == 32 else dict.fromkeys((sq, edges[-1 - i]))
            calls += [(qkv(1, 2, 1, sq, sk, d), dict(causal=False))
                      for sk in sks]
    for b, h, hkv, sq, sk, d, causal in ((1, 2, 1, 33, 33, 128, True),
                                         (1, 2, 2, 31, 65, 64, False),
                                         (2, 2, 1, 32, 32, 64, True),
                                         (1, 2, 2, 63, 63, 32, True),
                                         (1, 2, 2, 65, 65, 32, True),
                                         (1, 2, 2, 127, 127, 32, True),
                                         (1, 2, 2, 129, 129, 32, True),
                                         (1, 2, 1, 129, 65, 16, False),
                                         (1, 2, 1, 127, 63, 16, False)):
        calls.append((qkv(b, h, hkv, sq, sk, d), dict(causal=causal)))
    # rows of H·D + 1 floats from the second: no row on a 16-byte boundary
    for b, s, h, hkv, d, causal in ((2, 200, 2, 2, 32, False),
                                    (1, 300, 4, 2, 64, True),
                                    (1, 257, 2, 1, 32, True)):
        def view(heads, scale=1.0):
            x = randn((b, s, heads * d + 1), scale)[..., 1:]
            return x.view(b, s, heads, d).transpose(1, 2)
        calls.append(((view(h, 0.4), view(hkv, 0.4), view(hkv)),
                      dict(causal=causal)))
    b, s, h, d = 4096, 200, 2, 32
    q, k, v = (randn((b, s, h * d), 0.5).view(b, s, h, d).transpose(1, 2)
               for _ in range(3))
    calls.append(((q, k, v), dict(causal=False, return_lse=True)))
    return calls


def f32_check(label, args, kw, bar="edge"):
    """An fp32 call of kernel 8's forward: the kernel launched twice (the
    same bits, the log-sum-exp too where asked), then held to
    ``attention_ref`` and to ``attention_f32_tiles_plain`` (the kernel's
    arithmetic) under ``bar``: "edge" 1e-5 absolute, "model"
    ``compare_attention``'s bar of a recorded call (``MODEL_F32_TOL`` of
    the largest |want|, mean 1e-5 of it), "rg" ``RG_F32_TOL`` of the
    largest |want|; the log-sum-exp within ``BWD_F32_TOL`` of max(1,
    |want|).  Returns the largest output error (of the largest |want| for
    "rg")."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    with_lse = kw.get("return_lse", False)
    got = fa.flash_attention(*args, **kw)
    again = fa.flash_attention(*args, **kw)
    torch.cuda.synchronize()
    got, again = ((got, again) if with_lse else ((got,), (again,)))
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"{label}: two launches on the same inputs differ")
    err = 0.0
    for name, plain in (("attention_ref", fa.attention_ref),
                        ("attention_f32_tiles_plain",
                         fa.attention_f32_tiles_plain)):
        want = plain(*args, **kw)
        want = want if with_lse else (want,)
        torch.cuda.synchronize()
        if bar == "rg":
            e = float((got[0] - want[0]).abs().max() / want[0].abs().max())
            check(bool(torch.isfinite(got[0]).all()) and e <= RG_F32_TOL,
                  f"{label} against {name}: error {e} of the largest |want|"
                  f" > {RG_F32_TOL}")
        else:
            e = compare_attention(f"{label} against {name}", got[0], want[0],
                                  bar == "model")
        err = max(err, e)
        if with_lse:
            e_lse = float(((got[1] - want[1]).abs()
                           / want[1].abs().clamp(min=1.0)).max())
            check(e_lse <= BWD_F32_TOL, f"{label} against {name}: "
                  f"log-sum-exp error {e_lse} > {BWD_F32_TOL}")
        del want
    return err


# ---------------------------------------------------------------------------
# LM training: card = CPU steps, Yi-6B at full width, kernel 8's backward,
# the crash-resume loop
# ---------------------------------------------------------------------------

def train_batches(c, batch, seq, device, start_index=0):
    """``lm_batches`` of ``c``'s vocabulary through the prefetching loader
    onto ``device``."""
    from repro_torch.data import synthetic
    from repro_torch.data.pipeline import PrefetchingLoader
    return PrefetchingLoader(synthetic.lm_batches(
        c.vocab, batch, seq, seed=SEED % 10_000, start_index=start_index),
        device=device)


def lm_step_fn(c):
    """``make_train_step`` over ``loss_fn`` of ``c`` at the default AdamW
    settings."""
    from repro_torch.models import transformer as tr
    from repro_torch.train import train_loop
    return train_loop.make_train_step(
        lambda p, b: tr.loss_fn(p, c, b["tokens"], b["labels"]),
        train_loop.TrainConfig())


def train_cross_check(dev, name):
    """A 2-layer model of ``name`` at full width in fp32, ``remat="full"``,
    drawn once on the card at 1/√(fan-in) and copied to the host; on each
    device from the same parameters and batches (module docstring, 19a):
    the loss and gradients of one batch, one AdamW step at the peak lr, the
    loss of the next batch after it.  Both losses and the grad norm within
    ``TRAIN_LOSS_TOL`` of the CPU's, every gradient leaf within
    ``TRAIN_GRAD_TOL`` of its largest magnitude on the CPU; for an MoE
    model the experts and capacity drops of layer 0 in the first forward
    equal.  Returns the card's kernel-8 backward call and the CPU side's
    wall."""
    import importlib

    import torch
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as tr
    from repro_torch.train import optimizer, train_loop
    from repro_torch.train.tree import leaves
    c = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
    c = dataclasses.replace(c, n_layers=2, dtype="float32", remat="full")
    card = fan_in_scale(tr.init(c, seed=SEED, device=dev))
    host = tree_to(card, "cpu")
    gen = synthetic.lm_batches(c.vocab, TRAIN_XC["batch"], TRAIN_XC["seq"],
                               seed=SEED % 10_000)
    batches = [next(gen) for _ in range(2)]
    opt_cfg = optimizer.AdamWConfig(warmup_steps=1)

    def loss_fn(p, b):
        return tr.loss_fn(p, c, b["tokens"], b["labels"])
    walls, runs = {}, {}
    for side, params in (("card", card), ("cpu", host)):
        dv = dev if side == "card" else "cpu"
        b0, b1 = ({k: torch.from_numpy(v).to(dv) for k, v in b.items()}
                  for b in batches)
        rec = Recorder(("flash_attention_backward",), first=True, clone=True)
        moe = FirstMoEInput()
        t = time.perf_counter()
        with rec, moe:
            loss0, grads = train_loop.value_and_grad(loss_fn, params, b0)
        stepped, _, m = optimizer.apply(params, grads, optimizer.init(params),
                                        opt_cfg)
        with torch.no_grad():
            loss1 = loss_fn(stepped, b1)
        runs[side] = dict(losses=[float(loss0), float(loss1)],
                          norm=float(m["grad_norm"]), lr=float(m["lr"]),
                          grads=grads, calls=rec.calls)
        walls[side] = time.perf_counter() - t
        del stepped
        with torch.no_grad():
            runs[side]["routes"] = moe.routes() if c.moe is not None else None
    a, b = runs["card"], runs["cpu"]
    e_loss = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                     b["losses"]))
    e_norm = abs(a["norm"] - b["norm"]) / abs(b["norm"])
    e_grad, worst = 0.0, None
    for (key, x), y in zip(leaves_with_keys(a["grads"]), leaves(b["grads"])):
        top = float(y.abs().max())
        d = float((x.cpu() - y).abs().max())
        e = d / top if top > 0 else (0.0 if d == 0 else math.inf)
        if e >= e_grad:
            e_grad, worst = e, key
    log(f"train cross-check {c.name}: 2 layers fp32 remat=full, "
        f"{c.param_count()} parameters, {TRAIN_XC['batch']} x "
        f"{TRAIN_XC['seq']} tokens: losses before and after one AdamW step "
        f"(lr {b['lr']:.3e}) card {a['losses']} CPU {b['losses']} (largest "
        f"relative difference {e_loss:.3e}), grad norms {a['norm']:.6g} / "
        f"{b['norm']:.6g} ({e_norm:.3e} apart); gradients at most "
        f"{e_grad:.3e} of their leaf's largest magnitude apart ({worst}); "
        f"walls card {walls['card']:.2f} s (first calls), CPU "
        f"{walls['cpu']:.2f} s")
    if c.moe is not None:
        (ae, ak, _), (be, bk, gap) = a["routes"], b["routes"]
        log(f"train cross-check {c.name}: layer 0 routes card = CPU "
            f"experts {torch.equal(ae, be)}, drops {torch.equal(ak, bk)}, "
            f"{int((~bk).sum())} pairs dropped, smallest gate gap "
            f"{float(gap.min()):.3e}")
        check(torch.equal(ae, be) and torch.equal(ak, bk),
              f"train cross-check {c.name}: layer 0's experts or drops "
              f"differ")
    check(e_loss <= TRAIN_LOSS_TOL and e_norm <= TRAIN_LOSS_TOL,
          f"train cross-check {c.name}: losses or grad norms differ by "
          f"{e_loss} / {e_norm}")
    check(e_grad <= TRAIN_GRAD_TOL, f"train cross-check {c.name}: gradient "
          f"{worst} differs by {e_grad} of its largest magnitude")
    calls = a["calls"]["flash_attention_backward"]
    check(calls, f"train cross-check {c.name}: kernel 8's backward never "
          f"ran on the card")
    return calls[0], walls["cpu"]


def leaves_with_keys(tree, prefix=""):
    """(dotted key, leaf) of a tree in the order of ``train.tree.leaves``:
    dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        items = [(key, tree[key]) for key in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    return [pair for key, sub in items for pair in
            leaves_with_keys(sub, f"{prefix}.{key}" if prefix else str(key))]


def train_full_width(dev, n_layers, seq):
    """Yi-6B in bf16 at its published widths, ``n_layers`` of its 32 layers,
    ``remat="full"``, drawn on the card at 1/√(fan-in): three
    ``make_train_step`` steps of ``TRAIN_FULL["batch"]`` x ``seq`` tokens
    from ``lm_batches`` through the prefetching loader (module docstring,
    19b), counted from 0: kernel 8's forward twice a layer and step (the
    forward, then its recomputation), its backward once, no decode.
    Finite losses and grad norms, the parameters moved; logs each step's
    wall (CUDA events), tokens a second and peak memory.  Returns the
    recorded backward call of the first step."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import yi_6b
    from repro_torch.models import transformer as tr
    from repro_torch.train import optimizer
    from repro_torch.train.tree import leaves
    c = dataclasses.replace(yi_6b.CONFIG, n_layers=n_layers)
    t = time.perf_counter()
    params = fan_in_scale(tr.init(c, seed=SEED, device=dev))
    opt = optimizer.init(params)
    wq0 = params["layers"]["attn"]["wq"][0, :4].clone()
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in leaves(params))
    log(f"train Yi-6B: {n_layers} of 32 layers, bf16, remat=full, "
        f"{n_par} parameters drawn in {time.perf_counter() - t:.1f} s")
    step = lm_step_fn(c)
    loader = train_batches(c, TRAIN_FULL["batch"], seq, dev)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, norms = [], [], []
    rec = Recorder(("flash_attention_backward",), first=True, clone=True)
    with rec:
        for _ in range(TRAIN_FULL["steps"]):
            batch = next(loader)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt, loss, m = step(params, opt, batch)
            end.record()
            torch.cuda.synchronize()
            walls.append(start.elapsed_time(end))
            losses.append(float(loss))
            norms.append(float(m["grad_norm"]))
    loader.close()
    launches = dict(kernels.LAUNCHES)
    tokens = TRAIN_FULL["batch"] * seq
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"train Yi-6B: {TRAIN_FULL['steps']} steps of "
        f"{TRAIN_FULL['batch']} x {seq} tokens: walls ms "
        + " ".join(f"{w:.1f}" for w in walls)
        + f" (CUDA events), {tokens / (min(walls[1:] or walls) / 1e3):.0f} "
        f"tokens/s at the fastest later step, losses {losses}, grad norms "
        f"{norms}, peak memory {peak:.2f} GB; launches {launches}")
    moved = not torch.equal(params["layers"]["attn"]["wq"][0, :4], wq0)
    n = n_layers * TRAIN_FULL["steps"]
    check(all(math.isfinite(x) for x in losses + norms),
          "train Yi-6B: non-finite loss or grad norm")
    check(moved, "train Yi-6B: the parameters did not move")
    check(launches["flash_attention"] == 2 * n
          and launches["flash_attention_backward"] == n
          and launches["flash_decode"] == 0,
          f"train Yi-6B: launches {launches}, want flash_attention {2 * n}, "
          f"flash_attention_backward {n}")
    calls = rec.calls["flash_attention_backward"]
    del params, opt, step
    torch.cuda.empty_cache()
    return calls[0], launches["flash_attention_backward"]


def train_loop_check(dev):
    """``train_loop.run`` on the card at Yi-6B's REDUCED size with
    checkpoints every ``TRAIN_LOOP["ckpt_every"]`` steps (module docstring,
    19c): a run that crashes at ``fail_at`` after its checkpoint, then a
    run that resumes from it (its data from ``data_cursor_after_restart``)
    to the end and saves; its losses equal, within ``TRAIN_LOSS_TOL``, to
    those of the same steps of an uninterrupted run; both launch kernel 8
    and its backward."""
    import tempfile

    import torch
    from repro_torch import kernels
    from repro_torch.configs import yi_6b
    from repro_torch.models import transformer as tr
    from repro_torch.train import elastic, train_loop
    from repro_torch.train.checkpoint import CheckpointManager
    c = yi_6b.REDUCED
    cfg = dict(steps=TRAIN_LOOP["steps"], ckpt_every=TRAIN_LOOP["ckpt_every"],
               log_every=TRAIN_LOOP["ckpt_every"])
    bs, seq = TRAIN_LOOP["batch"], TRAIN_LOOP["seq"]

    def loss_fn(p, b):
        return tr.loss_fn(p, c, b["tokens"], b["labels"])

    def params():
        return tr.init(c, seed=SEED, device=dev)
    kernels.reset_launches()
    loaders = []

    def data(start=0):
        loaders.append(train_batches(c, bs, seq, dev, start))
        return loaders[-1]
    with tempfile.TemporaryDirectory() as tmp:
        whole = train_loop.TrainConfig(ckpt_dir=f"{tmp}/whole", **cfg)
        _, _, ref = train_loop.run(params(), loss_fn, data(), whole)
        split = train_loop.TrainConfig(ckpt_dir=f"{tmp}/split", **cfg)
        crashed = None
        try:
            train_loop.run(params(), loss_fn, data(), split,
                           fail_at=TRAIN_LOOP["fail_at"])
        except RuntimeError as e:
            crashed = str(e)
        check(crashed is not None,
              "train loop: the injected failure did not fire")
        log(f"train loop: {crashed}")
        steps = CheckpointManager(split.ckpt_dir).list_steps()
        resume_at = steps[-1]
        cursor = elastic.data_cursor_after_restart(resume_at, bs)
        _, opt, losses = train_loop.run(params(), loss_fn, data(cursor),
                                        split)
        final = CheckpointManager(split.ckpt_dir).list_steps()
    for loader in loaders:
        loader.close()
    launches = dict(kernels.LAUNCHES)
    e = max(abs(x - y) / abs(y) for x, y in zip(losses, ref[resume_at:]))
    log(f"train loop: {c.name} on the card, {cfg['steps']} steps, "
        f"checkpoints {steps} before the crash, resumed at {resume_at} "
        f"(cursor {cursor}), {len(losses)} steps to {final}; losses "
        f"{losses} against the uninterrupted run's {ref[resume_at:]} "
        f"(largest relative difference {e:.3e}); launches {launches}")
    check(resume_at == TRAIN_LOOP["ckpt_every"] and int(opt.step) ==
          cfg["steps"] and final[-1] == cfg["steps"],
          f"train loop: resumed at {resume_at}, ended at {int(opt.step)}, "
          f"checkpoints {final}")
    check(e <= TRAIN_LOSS_TOL, f"train loop: the resumed losses differ by "
          f"{e}")
    check(launches["flash_attention"] > 0
          and launches["flash_attention_backward"] > 0,
          f"train loop: launches {launches}")


def bwd_edge_calls(dev):
    """Seeded edge inputs of kernel 8's backward, drawn on the card, at
    every built width pair in fp32 and bf16: GQA groups 1, 3 and 8, causal
    and not, ragged S (1, 129, 200, 300), one of 1,000 keys, and in bf16
    Yi-6B's training call (2, 32, 4,096, 128) causal with a unit-scale dO
    (the training step's own dO is the gradient of a mean over 8,192
    tokens); each as (q, k, v, dO) with its forward from the kernel."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)

    def randn(shape, dt, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale).to(dt)
    calls = []
    for dt in (torch.float32, torch.bfloat16):
        for d, dv in fa.PREFILL_WIDTHS:
            for b, h, hkv, s, causal in ((2, 4, 4, 129, True),
                                         (1, 6, 2, 200, False),
                                         (1, 8, 1, 300, True),
                                         (2, 3, 1, 1, False)):
                calls.append(((randn((b, h, s, d), dt, 0.5),
                               randn((b, hkv, s, d), dt, 0.5),
                               randn((b, hkv, s, dv), dt),
                               randn((b, h, s, dv), dt)), causal))
        calls.append(((randn((1, 8, 1000, 128), dt, 0.5),
                       randn((1, 1, 1000, 128), dt, 0.5),
                       randn((1, 1, 1000, 128), dt),
                       randn((1, 8, 1000, 128), dt)), True))
    dt = torch.bfloat16
    calls.append(((randn((2, 32, 4096, 128), dt, 0.5),
                   randn((2, 4, 4096, 128), dt, 0.5),
                   randn((2, 4, 4096, 128), dt),
                   randn((2, 32, 4096, 128), dt)), True))
    return calls


def bwd_measure(got, want):
    """The largest error of dq, dk and dv against the plain version, each
    max |got - want| over its own largest |want|, that magnitude floored at
    ``BWD_FLOOR`` of the largest of the three (dq and dk are 0 at S = 1);
    so a gradient's scale (the training step's are ~1e-5) cannot hide a
    wrong tensor.  Returns the error and the largest |want| of each."""
    tops = [float(w.float().abs().max()) for w in want]
    floor = BWD_FLOOR * max(tops)
    err = max(float((g.float() - w.float()).abs().max())
              / (max(top, floor) or 1.0) for g, w, top in zip(got, want, tops))
    return err, tops


def bwd_error(label, got, want):
    """``bwd_measure``'s error of the kernel's gradients, checked: shapes,
    types and finite values, and raises beyond ``BF16_TOL`` (bf16) or
    ``BWD_F32_TOL`` (fp32).  Returns the error and how many of the three
    took the floor."""
    import torch
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{label}: {name} {tuple(g.shape)} {g.dtype} vs "
              f"{tuple(w.shape)} {w.dtype}")
        check(bool(torch.isfinite(g.float()).all()), f"{label}: non-finite "
              f"{name}")
    err, tops = bwd_measure(got, want)
    check(max(tops) > 0, f"{label}: every gradient of the plain version is 0")
    floor = BWD_FLOOR * max(tops)
    tol = BF16_TOL if got[0].dtype == torch.bfloat16 else BWD_F32_TOL
    check(err <= tol, f"{label}: error {err} of the largest |want| > {tol}")
    return err, sum(top < floor for top in tops)


def bwd_check(label, args, kw, halves=None):
    """One backward call: the kernel twice (the same bits), the plain
    version; returns ``bwd_error``'s error and count of floored gradients.
    With ``halves`` (a dict), a bf16 call also adds ``bwd_measure``'s error
    of ``flash_attention_backward_tc_plain`` at ``halves`` 1 and 2 (P and
    dS rounded to bf16 once, or as hi + lo) to ``halves[1]`` and
    ``halves[2]``: the measure that chooses the kernel's rounding."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    got = fa.flash_attention_backward(*args, **kw)
    again = fa.flash_attention_backward(*args, **kw)
    want = fa.flash_attention_backward_plain(*args, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"{label}: two launches on the same inputs differ")
    if halves is not None and args[0].dtype == torch.bfloat16:
        for n in (1, 2):
            emu = fa.flash_attention_backward_tc_plain(*args, **kw, halves=n)
            halves[n].append(bwd_measure(emu, want)[0])
            del emu
    return bwd_error(label, got, want)


def sdpa_backward_call(args, kw):
    """``scaled_dot_product_attention``'s backward on the call's q, k, v
    and dO, k and v repeated to every query head outside the timed call
    (with ``enable_gqa`` PyTorch takes its math path for a backward); a
    yardstick, used nowhere in the port."""
    import torch
    q, k, v, _, _, do = args
    group = q.shape[1] // k.shape[1]
    leaves = [q.detach().requires_grad_(True),
              k.repeat_interleave(group, 1).requires_grad_(True),
              v.repeat_interleave(group, 1).requires_grad_(True)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *leaves, is_causal=kw.get("causal", True), scale=kw.get("scale"))
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def log_bwd_rate(design, args, kw, row):
    """Kernel 8's backward row as rates: the kernel's and SDPA's backward
    TFLOP/s on ``bwd_work``'s operations, and their shares of the
    bound."""
    ops = bwd_work(args, kw)[1]
    log(f"kernel flash_attention_backward ({tuple(args[0].shape)}, "
        f"{design}): {ops / row['ms'] / 1e9:.1f} TFLOP/s, "
        f"{100 * row['bound_ms'] / row['ms']:.1f} % of the bound; SDPA's "
        f"backward {ops / row['library_ms'] / 1e9:.1f} TFLOP/s, "
        f"{100 * row['bound_ms'] / row['library_ms']:.1f} %")


def bwd_kernel_row(dev, recorded, launches):
    """Kernel 8's backward row (module docstring, 19d): the recorded calls
    (the fp32 cross-checks' and the bf16 Yi-6B step's), the edge cases and
    each built width pair against ``flash_attention_backward_plain``, two
    launches bit-equal; the forward's log-sum-exp against
    ``attention_ref``'s; the bf16 Yi-6B call timed beside the plain
    version and SDPA's backward."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    halves = {1: [], 2: []}
    rec = [bwd_check(f"flash_attention_backward {tuple(args[0].shape)}",
                     args, kw, halves) for args, kw in recorded]
    rec_errs = [e for e, _ in rec]
    floored = sum(n for _, n in rec)
    # the forward of each fp32 call, with the log-sum-exp the backward read
    fwd_err = max((f32_check(f"flash_attention fp32 training call "
                             f"{tuple(args[0].shape)}", args[:3],
                             dict(kw, return_lse=True), "model")
                   for args, kw in recorded
                   if args[0].dtype == torch.float32), default=0.0)
    for (args, _), e in zip(recorded, rec_errs):
        errs[args[0].dtype] = max(errs[args[0].dtype], e)
    edges = bwd_edge_calls(dev)
    e_lse, edge_errs = 0.0, []
    for (q, k, v, do), causal in edges:
        o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
        _, lse_ref = fa.attention_ref(q, k, v, causal=causal,
                                      return_lse=True)
        if q.dtype == torch.float32:
            fwd_err = max(fwd_err, f32_check(
                f"flash_attention fp32 backward edge {tuple(q.shape)}",
                (q, k, v), dict(causal=causal, return_lse=True)))
        e_lse = max(e_lse, float(((lse - lse_ref).abs()
                                  / lse_ref.abs().clamp(min=1.0)).max()))
        e, n = bwd_check(
            f"flash_attention_backward edge {tuple(q.shape)} "
            f"{tuple(v.shape)} causal={causal}", (q, k, v, o, lse, do),
            dict(causal=causal), halves)
        edge_errs.append(e)
        floored += n
        errs[q.dtype] = max(errs[q.dtype], e)
    yi_err = edge_errs[-1]      # the last edge case is Yi-6B's call
    log(f"kernel flash_attention_backward: {len(recorded)} recorded calls "
        f"and {len(edges)} edge cases, every built width pair "
        f"{fa.PREFILL_WIDTHS}, two launches bit-equal on each; worst error "
        f"of each gradient's largest |want| fp32 {errs[torch.float32]:.3e} "
        f"(bar {BWD_F32_TOL}), bf16 {errs[torch.bfloat16]:.3e} (bar "
        f"{BF16_TOL}); Yi-6B's call with a unit-scale dO {yi_err:.3e}; "
        f"{floored} of {3 * (len(recorded) + len(edges))} gradients held "
        f"to the floor ({BWD_FLOOR} of the call's largest); "
        f"forward log-sum-exp against attention_ref {e_lse:.3e}; the fp32 "
        f"forward of each fp32 call (f32_check) {fwd_err:.3e}")
    log(f"kernel flash_attention_backward, the bf16 rounding of P and dS "
        f"(flash_attention_backward_tc_plain, bwd_measure's error against "
        f"the plain version) over {len(halves[1])} bf16 calls: rounded once "
        f"worst {max(halves[1]):.3e}, Yi-6B's call {halves[1][-1]:.3e}; "
        f"hi + lo worst {max(halves[2]):.3e}, Yi-6B's call "
        f"{halves[2][-1]:.3e} (a single rounding is taken at or below "
        f"{BF16_TOL / 2} on every call)")
    check(e_lse <= BWD_F32_TOL, f"flash_attention lse: error {e_lse}")

    def timed(dtype):
        """The recorded call of ``dtype`` with the most work, and its own
        error."""
        i = max((i for i, c in enumerate(recorded)
                 if c[0][0].dtype == dtype),
                key=lambda i: bwd_work(*recorded[i])[1])
        return recorded[i], rec_errs[i]
    (args, kw), err = timed(torch.bfloat16)
    row = kernel_row("flash_attention_backward", fa.flash_attention_backward,
                     fa.flash_attention_backward_plain, sdpa_backward_call,
                     args, kw, err,
                     f"the bf16 Yi-6B training call {tuple(args[0].shape)}")
    log_bwd_rate("bf16, wgmma + TMA", args, kw, row)
    fp32, err = timed(torch.float32)
    log_bwd_rate("fp32, register tiles", *fp32, kernel_row(
        "flash_attention_backward", fa.flash_attention_backward,
        fa.flash_attention_backward_plain, sdpa_backward_call, *fp32, err,
        f"fp32 CUDA-core kernel on the fp32 cross-check's call "
        f"{tuple(fp32[0][0].shape)}"))
    row["launches"] = launches
    return row


def train_phase(dev, lm_layers, lm_prompt):
    """The train phase (module docstring, 19): the fp32 card-vs-CPU steps of
    Yi-6B, granite-MoE and MiniCPM3, the bf16 Yi-6B steps at full width
    (``lm_layers`` and ``lm_prompt`` cut its depth and sequence in a quick
    run), the crash-resume loop, and kernel 8's backward row."""
    import torch
    from repro_torch.configs import yi_6b
    recorded, cpu_s = [], 0.0
    for name in TRAIN_XC_CONFIGS:
        call, wall = train_cross_check(dev, name)
        recorded.append(call)
        cpu_s += wall
        torch.cuda.empty_cache()
    log(f"train cross-checks: the CPU side took {cpu_s:.1f} s")
    n_layers = TRAIN_FULL["layers"]
    if lm_layers < yi_6b.CONFIG.n_layers:
        n_layers = min(n_layers, lm_layers)
    call, launches = train_full_width(dev, n_layers,
                                      min(TRAIN_FULL["seq"], lm_prompt))
    recorded.append(call)
    train_loop_check(dev)
    return bwd_kernel_row(dev, recorded, launches)


# ---------------------------------------------------------------------------
# recsys and GNN: card = CPU, the serve paths' kernel calls, full-width steps
# ---------------------------------------------------------------------------

def rg_config(name, reduced=True):
    """``name``'s configuration in the port's registry: REDUCED or
    CONFIG."""
    from repro_torch.configs import registry
    return (registry.get_reduced if reduced else registry.get_arch)(name)[0]


def rg_host_batch(name, c, batch, seed, n_cands=RG_BERT["cands"]):
    """A batch of ``name`` as NumPy arrays: ``data/synthetic``'s CTR,
    masked-sequence and molecule generators; for the two-tower model NumPy
    draws (each side's ids, full masks, a small logQ)."""
    import numpy as np
    from repro_torch.data import synthetic
    if name in ("deepfm", "xdeepfm"):
        return next(synthetic.ctr_batches(c.n_sparse, c.rows_per_field,
                                          batch, seed=seed))
    if name == "bert4rec":
        return next(synthetic.seqrec_batches(
            c.n_items, batch, c.seq_len, n_masked=RG_BERT["n_masked"],
            n_cands=n_cands, seed=seed))
    if name == "dimenet":
        m = RG_MOLECULE
        return synthetic.make_molecule_batch(
            np.random.RandomState(seed), m["graphs"], m["nodes"], m["edges"],
            c.d_feat, m["trip"])
    rng = np.random.RandomState(seed)
    return {"user_ids": rng.randint(0, c.n_users, (batch, c.n_user_feats))
            .astype(np.int32),
            "user_mask": np.ones((batch, c.n_user_feats), np.float32),
            "item_ids": rng.randint(0, c.n_items, (batch, c.n_item_feats))
            .astype(np.int32),
            "item_mask": np.ones((batch, c.n_item_feats), np.float32),
            "log_q": (rng.randn(batch) * 0.1).astype(np.float32)}


def to_device(host, dev):
    import torch
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def rg_loss(name, c):
    """``name``'s training loss as fn(params, batch)."""
    from repro_torch.models import gnn, recsys
    fn = {"deepfm": recsys.ctr_loss, "xdeepfm": recsys.ctr_loss,
          "two_tower_retrieval": recsys.two_tower_loss,
          "bert4rec": recsys.bert4rec_loss, "dimenet": gnn.loss_fn}[name]
    return lambda p, b: fn(p, c, b)


def rg_init(name, c, dev, fan_in=False, seed=SEED):
    """Parameters of ``c`` drawn on ``dev``; with ``fan_in`` the stacked
    block matrices rescaled to 1/√(their fan-in) (``fan_in_scale``;
    DimeNet's bilinear tensor keeps its 1/√(h · n_bilinear)).  DimeNet
    takes it at CONFIG: there the reference's scale overflows (ROADMAP §3
    open 11: a loss of 2.7e29 and an infinite grad norm on a molecule
    batch).  BERT4Rec's card-vs-CPU check takes it: at the reference's
    1/√n_blocks the CPU's own fp32 gradients lie 6.1e-05 to 3.4e-04 of a
    leaf's largest from fp64 (ROADMAP §3 open 12), past the check's 1e-4;
    its serve and full-width steps run at the reference's init."""
    from repro_torch.models import gnn, recsys
    mod = gnn if name == "dimenet" else recsys
    params = mod.init(c, seed=seed, device=dev)
    if fan_in:
        fan_in_scale(params, params["blocks"], keep=("bilinear",))
    return params


def rg_cross_check(dev, name, seed=SEED, fan_in=False):
    """One head, or DimeNet on a molecule batch, on the card and on the CPU
    from the same parameters (drawn on the card, copied to the host) and
    batch (module docstring, 20a): the loss and gradients, one AdamW step
    at the peak lr, the loss after it.  Both losses within
    ``TRAIN_LOSS_TOL``, each gradient leaf within ``TRAIN_GRAD_TOL`` of its
    largest magnitude on the CPU; the card's launches counted: kernel 8
    and its backward once a block for BERT4Rec's gradient (and kernel 8
    again for the loss after the step), no kernel for the others.  ``seed``
    draws the parameters and the batch; ``fan_in`` rescales the block
    matrices (``rg_init``).  Returns the CPU side's wall."""
    import torch
    from repro_torch import kernels
    from repro_torch.train import optimizer, train_loop
    from repro_torch.train.tree import leaves
    if name == "bert4rec":
        c = dataclasses.replace(rg_config(name, reduced=False),
                                n_items=RG_XC["bert_items"])
        batch = RG_XC["bert_batch"]
    else:
        c, batch = rg_config(name), RG_XC["batch"]
    card = rg_init(name, c, dev, fan_in, seed)
    host = tree_to(card, "cpu")
    hb = rg_host_batch(name, c, batch, seed % 10_000, RG_BERT["xc_cands"])
    loss_fn = rg_loss(name, c)
    cfg = optimizer.AdamWConfig(warmup_steps=1)
    runs, walls = {}, {}
    rec = Recorder(("flash_attention",), clone=True)
    for side, params in (("card", card), ("cpu", host)):
        b = to_device(hb, dev if side == "card" else "cpu")
        kernels.reset_launches()
        t = time.perf_counter()
        with rec if side == "card" else contextlib.nullcontext():
            loss0, grads = train_loop.value_and_grad(loss_fn, params, b)
        stepped, _, _ = optimizer.apply(params, grads, optimizer.init(params),
                                        cfg)
        with torch.no_grad():
            loss1 = loss_fn(stepped, b)
        runs[side] = dict(losses=[float(loss0), float(loss1)], grads=grads,
                          launches=dict(kernels.LAUNCHES))
        walls[side] = time.perf_counter() - t
    a, b = runs["card"], runs["cpu"]
    e_loss = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                     b["losses"]))
    e_grad, worst = 0.0, None
    for (key, x), y in zip(leaves_with_keys(a["grads"]), leaves(b["grads"])):
        top = float(y.abs().max())
        d = float((x.cpu() - y).abs().max())
        e = d / top if top > 0 else (0.0 if d == 0 else math.inf)
        if e >= e_grad:
            e_grad, worst = e, key
    launched = {k: n for k, n in a["launches"].items() if n}
    want = ({"flash_attention": 2 * c.n_blocks,
             "flash_attention_backward": c.n_blocks}
            if name == "bert4rec" else {})
    log(f"recsys_gnn cross-check {c.name}: batch {batch}, "
        f"{sum(x.numel() for x in leaves(card))} parameters; losses before "
        f"and after one AdamW step card {a['losses']} CPU {b['losses']} "
        f"(largest relative difference {e_loss:.3e}); gradients at most "
        f"{e_grad:.3e} of their leaf's largest magnitude apart ({worst}); "
        f"card launches {launched}; walls card {walls['card']:.2f} s, CPU "
        f"{walls['cpu']:.2f} s")
    if name == "bert4rec":
        log_logit_spread(c.name, rec.calls["flash_attention"])
    check(e_loss <= TRAIN_LOSS_TOL, f"recsys_gnn cross-check {c.name}: "
          f"losses differ by {e_loss}")
    check(e_grad <= TRAIN_GRAD_TOL, f"recsys_gnn cross-check {c.name}: "
          f"gradient {worst} differs by {e_grad} of its largest magnitude")
    check(launched == want, f"recsys_gnn cross-check {c.name}: launches "
          f"{launched}, want {want}")
    return walls["cpu"]


def log_logit_spread(label, calls):
    """For each recorded attention call (a block of the loss's forward):
    each softmax row's largest logit q·k · scale and its gap to the row's
    second largest, over all rows: the largest and median of the one, the
    smallest and median of the other, and the rows whose gap is under
    1e-3 (where an fp32 rounding could swap the two)."""
    import torch
    for i, (args, kw) in enumerate(calls):
        q, k = args[0].float(), args[1].float()
        scale = kw.get("scale") or q.shape[-1] ** -0.5
        top = torch.topk(q @ k.transpose(-1, -2) * scale, 2, dim=-1).values
        big, gap = top[..., 0].flatten(), (top[..., 0] - top[..., 1]).flatten()
        log(f"recsys_gnn cross-check {label}: attention call {i} "
            f"{tuple(q.shape)}: row-largest logit max {float(big.max()):.4f} "
            f"median {float(big.median()):.4f}; top-2 gap min "
            f"{float(gap.min()):.3e} median {float(gap.median()):.4f}, "
            f"{int((gap < 1e-3).sum())} of {gap.numel()} rows under 1e-3")


def rg_graph(dev):
    """minibatch_lg's synthetic graph on ``dev`` from a seed: Reddit's
    232,965 nodes as a (N, 512) int32 padded adjacency (row i's first
    degree[i] slots its neighbors, drawn uniformly; the rest 0), degrees
    uniform in [472, 512] (mean 492, Reddit's), and a generator for what
    follows."""
    import torch
    g = RG_GRAPH
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    n, width = g["n_nodes"], g["max_deg"]
    deg = torch.randint(g["min_deg"], width + 1, (n,), generator=gen,
                        device=dev, dtype=torch.int32)
    nbr = torch.randint(0, n, (n, width), generator=gen, device=dev,
                        dtype=torch.int32)
    nbr.masked_fill_(torch.arange(width, device=dev)[None, :]
                     >= deg[:, None], 0)
    return nbr, deg, gen


def rg_samplers(dev):
    """``neighbor_sample`` (1,024 seeds, fanouts 15 and 10) and
    ``build_triplets`` (2 a sampled edge) on the card and, from the graph
    copied to the host, on the CPU, from one ``PRNGKey``: every output
    bit-equal (module docstring, 20a).  Returns minibatch_lg's DimeNet
    batch on the card: the sampled edges' nodes relabelled 0…n-1, their
    features (d 602) and positions drawn there, the loss on the seeds."""
    import torch
    from repro_torch.core import prng
    from repro_torch.models import gnn
    g = RG_GRAPH
    nbr, deg, gen = rg_graph(dev)
    seeds = torch.randperm(g["n_nodes"], generator=gen, device=dev)[
        :g["seeds"]]
    k_nbr, k_trip = prng.split(prng.PRNGKey(SEED % 10_000))
    out, walls = {}, {}
    for side, graph in (("card", (nbr, deg, seeds)),
                        ("cpu", tuple(t.cpu() for t in (nbr, deg, seeds)))):
        _sync(graph[0])
        t = time.perf_counter()
        sub = gnn.neighbor_sample(*graph, g["fanouts"], k_nbr)
        kj, ji, tm = gnn.build_triplets(sub["edge_src"], sub["edge_dst"],
                                        g["trip"] * sub["edge_src"].shape[0],
                                        k_trip)
        _sync(kj)
        walls[side] = time.perf_counter() - t
        out[side] = dict(sub, trip_kj=kj, trip_ji=ji, trip_mask=tm)
    for key, want in out["cpu"].items():
        got = out["card"][key]
        check(got.dtype == want.dtype and torch.equal(got.cpu(), want),
              f"recsys_gnn samplers: {key} differs on the card and the CPU")
    sub = out["card"]
    e = sub["edge_src"].shape[0]
    nodes, inv = torch.unique(torch.cat([sub["edge_src"], sub["edge_dst"]]),
                              return_inverse=True)
    n = nodes.shape[0]
    c = dataclasses.replace(rg_config("dimenet", reduced=False),
                            d_feat=g["d_feat"])
    batch = dict(
        feat=torch.randn((n, c.d_feat), generator=gen, device=dev).mul_(0.3),
        pos=torch.randn((n, 3), generator=gen, device=dev).mul_(1.5),
        edge_src=inv[:e], edge_dst=inv[e:], trip_kj=sub["trip_kj"],
        trip_ji=sub["trip_ji"], edge_mask=sub["edge_mask"],
        trip_mask=sub["trip_mask"],
        node_mask=torch.isin(nodes, seeds.long()).float(),
        target=torch.randn((n,), generator=gen, device=dev))
    log(f"recsys_gnn samplers: graph {g['n_nodes']} nodes x {g['max_deg']} "
        f"slots ({nbr.numel() * 4 / 1e6:.0f} MB int32, mean degree "
        f"{float(deg.float().mean()):.1f}); {g['seeds']} seeds, fanouts "
        f"{g['fanouts']}: {e} edges ({int(sub['edge_mask'].sum())} live), "
        f"{sub['trip_kj'].shape[0]} triplets ({int(sub['trip_mask'].sum())} "
        f"live), {n} nodes; card = CPU bit for bit; walls card "
        f"{walls['card']:.3f} s, CPU {walls['cpu']:.3f} s")
    return c, batch


def dense_plain_rows(q_emb, doc_emb, k):
    """``dense_topk_plain`` over ``RG_SERVE["chunk"]`` queries at a time:
    the same function, whose (Q, N) stable sort at once would take tens of
    GB at the serve calls."""
    import torch
    from repro_torch.kernels.dense_topk import ops as dt
    step = RG_SERVE["chunk"]
    parts = [dt.dense_topk_plain(q_emb[i:i + step], doc_emb, k)
             for i in range(0, q_emb.shape[0], step)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def topk_library(args, kw):
    """``torch.topk(q @ embᵀ, k)``: the one PyTorch call of kernel 6's
    function at these sizes (not tie-stable); a yardstick, used nowhere in
    the port."""
    import torch
    q_emb, doc_emb, k = args
    return lambda: torch.topk(q_emb @ doc_emb.T, k, dim=1)


def topk_check(label, got, want, q_emb, doc_emb):
    """Kernel 6's (scores, ids) against the plain version's on unquantized
    embeddings: scores within ``RG_TOPK_TOL`` of max(1, |want|); where the
    ids differ, the kernel's id scored anew (fp32) within that bar of the
    plain score there (a near-tie).  Returns (the error, the positions
    whose ids differ)."""
    import torch
    (gv, gi), (wv, wi) = got, want
    check(gv.shape == wv.shape and gi.dtype == wi.dtype == torch.int64,
          f"{label}: kernel output {tuple(gv.shape)} {gi.dtype} vs plain "
          f"{tuple(wv.shape)} {wi.dtype}")
    check(bool(torch.isfinite(gv).all()), f"{label}: non-finite scores")
    bar = RG_TOPK_TOL * wv.abs().clamp(min=1.0)
    err = float(((gv - wv).abs() / wv.abs().clamp(min=1.0)).max())
    check(err <= RG_TOPK_TOL, f"{label}: scores differ by {err} of max(1, "
          f"|want|)")
    diff = gi != wi
    n_diff = int(diff.sum())
    if n_diff:
        rows = torch.nonzero(diff)[:, 0]
        own = (q_emb[rows] * doc_emb[gi[diff]]).sum(dim=-1)
        check(bool(((own - wv[diff]).abs() <= bar[diff]).all()),
              f"{label}: {n_diff} ids differ, not all between near-tied "
              f"scores")
        check(all(len(set(r.tolist())) == len(r) for r in gi[rows.unique()]),
              f"{label}: a row holds an id twice")
    return err, n_diff


def rg_topk_row(label, args, launches):
    """Kernel 6 on one call of a serve path against its plain version
    (``topk_check``), timed beside the plain version and
    ``topk_library``."""
    from repro_torch.kernels.dense_topk import ops as dt
    got = dt.dense_topk_tiles(*args)
    want = dense_plain_rows(*args)
    err, n_diff = topk_check(f"dense_topk_tiles {label}", got, want, *args[:2])
    q_emb, doc_emb, k = args
    del got, want
    row = kernel_row("dense_topk_tiles", dt.dense_topk_tiles,
                     dense_plain_rows, topk_library, args, {}, err,
                     f"{label}: Q {q_emb.shape[0]} x N {doc_emb.shape[0]} x "
                     f"d {doc_emb.shape[1]}, k {k}; {n_diff} of "
                     f"{q_emb.shape[0] * k} ids differ between near-tied "
                     f"scores; plain in chunks of {RG_SERVE['chunk']} "
                     f"queries; library torch.topk(q @ embᵀ, k)")
    row["launches"] = launches
    return row


def events():
    import torch
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def rg_topk_edges(dev, q_emb, cand):
    """Kernel 6's edge calls through the port's entry points: k > n
    (``streaming_topk`` of 100 over 50 candidates: the kernel at k = 50,
    then (-inf, id 0) fills), a candidate count off the 256-doc tile (777),
    ``anytime_retrieval`` at budget 0 (no launch, every slot filled)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import recsys
    k = RG_SERVE["k"]
    err, q = 0.0, q_emb[:16]
    for n in (50, 777):
        vals, ids = recsys.streaming_topk(q, cand[:n], k)
        m = min(k, n)
        e, _ = topk_check(f"dense_topk_tiles edge n={n}",
                          (vals[:, :m], ids[:, :m]),
                          dense_plain_rows(q, cand[:n], m), q, cand[:n])
        err = max(err, e)
        check(bool((vals[:, m:] == -math.inf).all() and (ids[:, m:] == 0)
                   .all()), f"streaming_topk k > n={n}: wrong fill")
    kernels.reset_launches()
    vals, ids = recsys.anytime_retrieval(q[:1], cand, 0, k)
    check(kernels.LAUNCHES["dense_topk_tiles"] == 0
          and bool((vals == -math.inf).all())
          and torch.equal(ids, torch.arange(k, device=ids.device)),
          "anytime_retrieval at budget 0: wrong fill or a launch")
    return err


def rg_two_tower(dev):
    """The two-tower model at CONFIG on the card (module docstring, 20b,
    20c): the item tower over 2,000,000 synthetic items (each its own id
    and 7 feature rows drawn from a seed) gives the candidates; counted
    from 0, the user tower over 512 users' bags into ``streaming_topk``
    (kernel 6, k 100); counted from 0, ``anytime_retrieval`` of the first
    user over the first 1,000,448 candidates at k 1,000 and three budgets;
    kernel 6's rows and edge calls; then the full-width training steps.
    Returns (the launches of both paths, the rows, the serve's user towers,
    candidates and top-k ids, which the mesh phase serves again)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import recsys
    c, params, cand, uids = two_tower_candidates(dev)
    with torch.no_grad():
        start, end = events()
        kernels.reset_launches()
        with Recorder(("dense_topk_tiles",)) as rec:
            start.record()
            u = recsys.tower_embed(params, c, "user_table", "user_mlp",
                                   uids, torch.ones(uids.shape, device=dev))
            vals, ids = recsys.streaming_topk(u, cand, RG_SERVE["k"])
            end.record()
            torch.cuda.synchronize()
        launches = {"serve": kernels.LAUNCHES["dense_topk_tiles"]}
        check(launches["serve"] == 1 and bool(torch.isfinite(vals).all())
              and vals.shape == (RG_SERVE["queries"], RG_SERVE["k"]),
              f"two-tower serve: launches {launches}, scores finite "
              f"{bool(torch.isfinite(vals).all())}")
        log(f"recsys_gnn two-tower serve: {c.n_items} item-tower outputs, "
            f"{RG_SERVE['queries']} users' towers into streaming_topk (k "
            f"{RG_SERVE['k']}): {start.elapsed_time(end):.3f} ms (CUDA "
            f"events), kernel 6 launched {launches['serve']} time")
        a = RG_ANYTIME
        kernels.reset_launches()
        with Recorder(("dense_topk_tiles",)) as rec_a:
            for budget in a["budgets"]:
                v, i = recsys.anytime_retrieval(
                    u[:1], cand[:a["n"]], torch.tensor(budget, device=dev),
                    a["k"])
                live = min(budget, a["k"])
                check(v.shape == (a["k"],) and bool((i[:live] < budget).all())
                      and bool(torch.isfinite(v[:live]).all())
                      and bool((v[live:] == -math.inf).all())
                      and torch.equal(i[live:], torch.arange(
                          budget, budget + a["k"] - live, device=dev)),
                      f"anytime_retrieval at budget {budget}: wrong ids or "
                      f"fill")
        launches["anytime"] = kernels.LAUNCHES["dense_topk_tiles"]
        check(launches["anytime"] == len(a["budgets"]),
              f"anytime_retrieval: {launches['anytime']} launches")
        rows = [rg_topk_row("two-tower serve", rec.calls[
            "dense_topk_tiles"][0][0], launches["serve"])]
        for args, _ in rec_a.calls["dense_topk_tiles"]:
            rows.append(rg_topk_row(
                f"anytime_retrieval budget {args[1].shape[0]}", args,
                launches["anytime"]))
        err = rg_topk_edges(dev, u, cand)
        log(f"kernel dense_topk_tiles: edge calls (k > n, n = 777, budget "
            f"0) within {err:.3e} of max(1, |want|)")
    serve = dict(u=u, cand=cand, ids=ids)
    del rec, rec_a, args
    torch.cuda.empty_cache()
    rg_steps(dev, "two_tower_retrieval", c, params, {})
    return launches, rows, serve


def rg_steps(dev, name, c, params, want, host=None):
    """``RG_STEPS`` full-width training steps of ``name`` on the card
    (module docstring, 20c): ``train_loop.value_and_grad`` of its loss and
    ``optimizer.apply`` with the buffers donated, on one batch of
    ``RG_STEP_BATCH`` (or ``host``), counted from 0.  Finite losses and
    grad norms, the launches ``want`` (no other kernel); logs each step's
    wall (CUDA events) and the peak memory.  Returns the first recorded
    calls of kernel 8 and its backward."""
    import torch
    from repro_torch import kernels
    from repro_torch.train import optimizer, train_loop
    from repro_torch.train.tree import leaves
    if host is None:
        host = rg_host_batch(name, c, RG_STEP_BATCH[name], SEED % 10_000)
    batch = to_device(host, dev) if not isinstance(
        next(iter(host.values())), torch.Tensor) else host
    n_par = sum(x.numel() for x in leaves(params))
    loss_fn = rg_loss(name, c)
    opt = optimizer.init(params)
    cfg = optimizer.AdamWConfig()
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, norms = [], [], []
    rec = Recorder(("flash_attention", "flash_attention_backward"),
                   first=True, clone=True)
    with rec:
        for _ in range(RG_STEPS):
            start, end = events()
            start.record()
            loss, grads = train_loop.value_and_grad(loss_fn, params, batch)
            params, opt, m = optimizer.apply(params, grads, opt, cfg,
                                             donate=True)
            del grads
            end.record()
            torch.cuda.synchronize()
            walls.append(start.elapsed_time(end))
            losses.append(float(loss))
            norms.append(float(m["grad_norm"]))
    launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
    peak = torch.cuda.max_memory_allocated() / 1e9
    size = {k: tuple(v.shape) for k, v in batch.items()
            if k in ("ids", "user_ids", "items", "edge_src", "trip_kj",
                     "feat")}
    log(f"recsys_gnn step {c.name}: {n_par} parameters, batch {size}: walls "
        f"ms " + " ".join(f"{w:.1f}" for w in walls) + f" (CUDA events), "
        f"losses {losses}, grad norms {norms}, peak memory {peak:.2f} GB; "
        f"launches {launched}")
    check(all(math.isfinite(x) for x in losses + norms),
          f"recsys_gnn step {c.name}: non-finite loss or grad norm")
    check(launched == want, f"recsys_gnn step {c.name}: launches "
          f"{launched}, want {want}")
    calls = dict(rec.calls)
    del params, opt, batch, rec
    torch.cuda.empty_cache()
    return calls


def rg_bert4rec(dev):
    """BERT4Rec at CONFIG (1,000,000 items) on the card (module docstring,
    20b, 20c): counted from 0, 512 histories of 200 (the last slot the mask
    token) through ``bert4rec_hidden`` (kernel 8 in fp32, one launch a
    block) and the last position's hidden state into ``streaming_topk``
    over the 1,000,192 item rows (kernel 6, k 100); kernel 6's row and
    kernel 8's fp32 forward row at the serve call; then the full-width
    steps (kernel 8 and its backward once a block and step) and the
    backward's row at the training call.  Returns the serve's launches,
    the rows, and the serve (a copy of the parameters as served, the
    histories and the ids) for the cells phase."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import attention as attn
    from repro_torch.models import recsys
    from repro_torch.train.tree import map_tree
    c = rg_config("bert4rec", reduced=False)
    params = rg_init("bert4rec", c, dev)
    host = rg_host_batch("bert4rec", c, RG_SERVE["queries"], SEED % 10_000)
    items = torch.from_numpy(host["items"]).to(dev)
    items[:, -1] = c.n_items                 # the mask token: predict next
    start, end = events()
    kernels.reset_launches()
    with Recorder(("flash_attention", "dense_topk_tiles")) as rec, \
            torch.no_grad():
        start.record()
        h = recsys.bert4rec_hidden(params, c, items)
        vals, ids = recsys.streaming_topk(h[:, -1], params["item_embed"],
                                          RG_SERVE["k"])
        end.record()
        torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in ("flash_attention",
                                                 "dense_topk_tiles")}
    log(f"recsys_gnn BERT4Rec serve: {RG_SERVE['queries']} histories of "
        f"{c.seq_len} into streaming_topk over {c.padded_items} item rows "
        f"(k {RG_SERVE['k']}): {start.elapsed_time(end):.3f} ms (CUDA "
        f"events), launches {launches}")
    check(launches == {"flash_attention": c.n_blocks, "dense_topk_tiles": 1}
          and bool(torch.isfinite(vals).all()),
          f"BERT4Rec serve: launches {launches}")
    with torch.no_grad():
        rows = [rg_topk_row("BERT4Rec serve",
                            rec.calls["dense_topk_tiles"][0][0], 1)]
        args, kw = rec.calls["flash_attention"][0]
        got = fa.flash_attention(*args, **kw)
        want = attn.chunked_attention_plain(*args, **kw)
        err = float((got - want).abs().max() / want.abs().max())
        check(err <= RG_F32_TOL, f"flash_attention fp32 BERT4Rec serve call: "
              f"error {err} of the largest |want|")
        del got, want
        err = max(err, f32_check("flash_attention fp32 BERT4Rec serve call",
                                 args, kw, "rg"))
        rows.append(kernel_row(
            "flash_attention", fa.flash_attention,
            attn.chunked_attention_plain,
            attention_library_calls()["flash_attention"], args, kw, err,
            f"fp32 kernel (flash_attention.cu) on BERT4Rec's serve call "
            f"{tuple(args[0].shape)} non-causal, the strided views the "
            f"model passes; error of the largest |want|"))
        rows[-1]["launches"] = launches["flash_attention"]
    # the serve as served, for the cells phase (the steps below update the
    # parameters in place)
    served = dict(params=map_tree(torch.clone, params), items=items,
                  ids=ids)
    del rec, h, args
    torch.cuda.empty_cache()
    n = c.n_blocks * RG_STEPS
    calls = rg_steps(dev, "bert4rec", c, params,
                     {"flash_attention": n, "flash_attention_backward": n})
    del params
    (args, kw), = calls["flash_attention"]
    got, lse = fa.flash_attention(*args, **kw)
    want, lse_want = attn.chunked_attention_plain(*args, **kw)
    err = float((got - want).abs().max() / want.abs().max())
    check(err <= RG_F32_TOL, f"flash_attention fp32 BERT4Rec training call: "
          f"error {err} of the largest |want|")
    log(f"kernel flash_attention fp32 at BERT4Rec's training call "
        f"{tuple(args[0].shape)}: error {err:.3e} of the largest |want|, "
        f"log-sum-exp {float((lse - lse_want).abs().max()):.3e}")
    del got, want, lse, lse_want
    err = max(err, f32_check("flash_attention fp32 BERT4Rec training call",
                             args, kw, "rg"))
    rows.append(kernel_row(
        "flash_attention", fa.flash_attention, attn.chunked_attention_plain,
        attention_library_calls()["flash_attention"], args, kw, err,
        f"fp32 kernel (flash_attention.cu) on BERT4Rec's training call "
        f"{tuple(args[0].shape)} non-causal with the log-sum-exp, the "
        f"strided views the model passes (SDPA without it); error of the "
        f"largest |want|"))
    rows[-1]["launches"] = n
    (args, kw), = calls["flash_attention_backward"]
    e_bwd, floored = bwd_check("flash_attention_backward BERT4Rec", args, kw)
    rows.append(kernel_row(
        "flash_attention_backward", fa.flash_attention_backward,
        fa.flash_attention_backward_plain, sdpa_backward_call, args, kw,
        e_bwd, f"fp32 kernel on BERT4Rec's training call "
        f"{tuple(args[0].shape)} non-causal ({floored} gradients held to "
        f"the floor)"))
    log_bwd_rate("fp32, register tiles", args, kw, rows[-1])
    rows[-1]["launches"] = n
    del calls, args
    torch.cuda.empty_cache()
    return launches, rows, served


def recsys_gnn_phase(dev):
    """The recsys_gnn phase (module docstring, 20): the card-vs-CPU checks,
    the samplers, the repeat check, the serve paths with their kernel rows,
    the full-width steps.  Returns (the rows, logged: the ``kernels`` line
    keeps the serve and LM phases' rows of kernels 6 and 8; the two-tower
    serve's inputs and ids, for the mesh phase; BERT4Rec's serve, for the
    cells phase)."""
    import torch
    t = time.perf_counter()
    cpu_s = sum(rg_cross_check(dev, name, fan_in=name == "bert4rec")
                for name in RG_HEADS + ("dimenet",))
    mb_config, mb_batch = rg_samplers(dev)
    rg_repeat(dev, mb_config, mb_batch)
    torch.cuda.empty_cache()
    tt_launches, rows, serve = rg_two_tower(dev)
    bert_launches, bert_rows, b4r = rg_bert4rec(dev)
    rows += bert_rows
    for name in ("deepfm", "xdeepfm"):
        c = rg_config(name, reduced=False)
        rg_steps(dev, name, c, rg_init(name, c, dev), {})
    c = rg_config("dimenet", reduced=False)
    rg_steps(dev, "dimenet", c, rg_init("dimenet", c, dev, fan_in=True), {},
             host=rg_host_batch("dimenet", c, None, SEED % 10_000))
    rg_steps(dev, "dimenet", mb_config,
             rg_init("dimenet", mb_config, dev, fan_in=True), {},
             host=mb_batch)
    del mb_batch
    torch.cuda.empty_cache()
    log(f"recsys_gnn: launches dense_topk_tiles two-tower {tt_launches}, "
        f"BERT4Rec {bert_launches['dense_topk_tiles']}; flash_attention "
        f"BERT4Rec serve {bert_launches['flash_attention']}, steps "
        f"{2 * RG_STEPS}; flash_attention_backward steps {2 * RG_STEPS}; "
        f"cross-checks' CPU sides {cpu_s:.1f} s; phase "
        f"{time.perf_counter() - t:.1f} s")
    return rows, serve, b4r


def rg_repeat(dev, mb_config, mb_batch):
    """The sums in a fixed order (module docstring, 20a): one DimeNet step
    (``value_and_grad``) on a molecule batch and on minibatch_lg's sample,
    and one ragged EmbeddingBag forward and backward (``RG_BAG``), each run
    twice on the card: the loss or output and every gradient bit-equal.
    Logs the checks' wall and, beside them, how many of the bag's sums the
    float-atomic ``index_add_`` they replaced gives differently in two
    runs."""
    import torch
    from repro_torch.models import embedding, gnn
    from repro_torch.train import train_loop
    from repro_torch.train.tree import leaves
    t = time.perf_counter()
    c = rg_config("dimenet", reduced=False)
    runs = (("molecule", c, rg_init("dimenet", c, dev, fan_in=True),
             to_device(rg_host_batch("dimenet", c, None, SEED % 10_000),
                       dev)),
            ("minibatch_lg", mb_config,
             rg_init("dimenet", mb_config, dev, fan_in=True), mb_batch))
    for label, c_, params, batch in runs:
        outs = [train_loop.value_and_grad(
            lambda p, b: gnn.loss_fn(p, c_, b), params, batch)
            for _ in range(2)]
        (l0, g0), (l1, g1) = outs
        check(torch.equal(l0, l1) and all(
            torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1))),
            f"recsys_gnn repeat: DimeNet {label} step differs between two "
            f"runs on the card")
    del runs, outs, g0, g1
    b = RG_BAG
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    table = torch.randn((b["rows"], b["dim"]), generator=gen,
                        device=dev).requires_grad_()
    n = b["bags"] * b["per_bag"]
    flat = torch.randint(0, b["rows"], (n,), generator=gen, device=dev)
    bags = torch.randint(0, b["bags"], (n,), generator=gen, device=dev)
    weights = torch.rand((n,), generator=gen, device=dev).requires_grad_()
    probe = torch.randn((b["bags"], b["dim"]), generator=gen, device=dev)
    got = []
    for _ in range(2):
        out = embedding.ragged_embedding_bag(table, flat, bags, b["bags"],
                                             weights)
        gt, gw = torch.autograd.grad((out * probe).sum(), (table, weights))
        got.append((out.detach(), gt, gw))
    check(all(torch.equal(x, y) for x, y in zip(*got)),
          "recsys_gnn repeat: the ragged bag or its gradients differ between "
          "two runs on the card")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with torch.no_grad():
        rows = table[flat] * weights[:, None]
        atomic = [torch.zeros_like(got[0][0]).index_add_(0, bags, rows)
                  for _ in range(2)]
    log(f"recsys_gnn repeat: DimeNet steps (molecule, minibatch_lg) and a "
        f"ragged bag ({b['bags']} bags of {b['per_bag']} rows of a "
        f"{b['rows']} x {b['dim']} table) bit-equal in two runs on the card "
        f"({wall:.2f} s); index_add_ in their place: "
        f"{int((atomic[0] != atomic[1]).sum())} of {atomic[0].numel()} sums "
        f"differ between two runs")
    del table, weights, got, rows, atomic
    torch.cuda.empty_cache()


def two_tower_candidates(dev):
    """The two-tower model at CONFIG drawn on the card, its item tower over
    2,000,000 synthetic items (each its own id and 7 feature rows drawn
    from a seed) as the candidates, and 512 users' feature ids: (config,
    parameters, candidates, user ids)."""
    import torch
    from repro_torch.models import recsys
    c = rg_config("two_tower_retrieval", reduced=False)
    params = recsys.init(c, seed=SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    step = 1 << 18
    with torch.no_grad():
        cand = torch.empty((c.n_items, c.tower_mlp[-1]), device=dev)
        for lo in range(0, c.n_items, step):
            hi = min(lo + step, c.n_items)
            ids = torch.randint(0, c.n_items, (hi - lo, c.n_item_feats),
                                generator=gen, device=dev)
            ids[:, 0] = torch.arange(lo, hi, device=dev)
            cand[lo:hi] = recsys.tower_embed(
                params, c, "item_table", "item_mlp", ids,
                torch.ones(ids.shape, device=dev))
        uids = torch.randint(0, c.n_users, (RG_SERVE["queries"],
                                            c.n_user_feats),
                             generator=gen, device=dev)
    return c, params, cand, uids


def mesh_serve_inputs(dev):
    """The two-tower serve's inputs as ``rg_two_tower`` draws them (for
    ``--only mesh``): the 512 user towers, the 2,000,000 item-tower
    outputs, and ``streaming_topk``'s ids over them."""
    import torch
    from repro_torch.models import recsys
    c, params, cand, uids = two_tower_candidates(dev)
    with torch.no_grad():
        u = recsys.tower_embed(params, c, "user_table", "user_mlp", uids,
                               torch.ones(uids.shape, device=dev))
        _, ids = recsys.streaming_topk(u, cand, RG_SERVE["k"])
    return dict(u=u, cand=cand, ids=ids)


def mesh_phase(dev, lm_layers, lm_prompt, serve=None):
    """The mesh phase (module docstring, 21): the model code under a (1, 1)
    mesh over NCCL at world size 1 (``launch/mesh.make_local_mesh``),
    through ``mesh_context``.  ``serve`` is the recsys_gnn phase's
    two-tower serve (drawn here when the phase runs alone)."""
    import tempfile

    import torch
    from repro_torch import kernels
    from repro_torch.configs import granite_moe_3b_a800m, yi_6b
    from repro_torch.configs.shapes import LM_SHAPES, rules_for
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import make_local_mesh, mesh_context
    from repro_torch.models import embedding, gnn, recsys
    from repro_torch.models import transformer as tr
    from repro_torch.train import elastic, train_loop
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.tree import leaves, map_tree
    t0 = time.perf_counter()
    if serve is None:
        serve = mesh_serve_inputs(dev)
        torch.cuda.synchronize()
        log(f"mesh: the two-tower serve's inputs drawn in "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh = make_local_mesh(device=dev)
    walls = {}
    try:
        # granite-MoE's prefill, its MoE through the mesh branch
        t = time.perf_counter()
        n_layers = MM_LAYERS["granite_moe_3b_a800m"]
        if lm_layers < yi_6b.CONFIG.n_layers:
            n_layers = min(n_layers, lm_layers)
        c = dataclasses.replace(granite_moe_3b_a800m.CONFIG,
                                n_layers=n_layers)
        params = tr.init(c, seed=SEED, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 23)
        toks = torch.randint(0, c.vocab, (LM_BATCH, min(MM_PROMPT,
                                                        lm_prompt)),
                             generator=gen, device=dev)
        ms = {}
        with torch.no_grad():
            # a warm-up under the mesh (its first collectives set up NCCL's
            # communicators), then each side timed
            with mesh_context(mesh):
                tr.prefill(params, c, toks)
            for side in ("mesh", "none"):
                if side == "mesh":
                    kernels.reset_launches()
                start, end = events()
                start.record()
                with (mesh_context(mesh) if side == "mesh"
                      else contextlib.nullcontext()):
                    out = tr.prefill(params, c, toks, rules=rules_for(
                        "lm", LM_SHAPES["prefill_32k"]))
                end.record()
                torch.cuda.synchronize()
                ms[side] = start.elapsed_time(end)
                if side == "mesh":
                    launched = dict(kernels.LAUNCHES)
                    got, cache = out
        want, want_cache = out
        check(torch.equal(got, want) and all(
            torch.equal(cache[k], want_cache[k]) for k in cache),
            "mesh: granite-MoE's prefill under the (1, 1) mesh differs from "
            "the prefill without one")
        check(launched["flash_attention"] == n_layers,
              f"mesh: flash_attention launched {launched['flash_attention']} "
              f"times in the prefill, not once a layer ({n_layers})")
        log(f"mesh: granite-MoE, {n_layers} layers bf16, prefill of "
            f"{tuple(toks.shape)} tokens under the (1, 1) mesh bit-equal to "
            f"the prefill without one (logits and cache); walls under the "
            f"mesh {ms['mesh']:.1f} ms, without {ms['none']:.1f} ms (CUDA "
            f"events); launches under the mesh "
            f"{ {k: n for k, n in launched.items() if n} }")
        del want, want_cache, got, cache, out
        walls["moe"] = time.perf_counter() - t

        # granite's training step: the mesh branch's backward (f)
        t = time.perf_counter()
        gen_b = synthetic.lm_batches(c.vocab, TRAIN_XC["batch"],
                                     TRAIN_XC["seq"], seed=SEED % 10_000)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(gen_b).items()}

        def lm_loss(p, b):
            return tr.loss_fn(p, c, b["tokens"], b["labels"])
        want_loss, want_grads = train_loop.value_and_grad(lm_loss, params,
                                                          batch)
        kernels.reset_launches()
        with mesh_context(mesh):
            got_loss, got_grads = train_loop.value_and_grad(lm_loss, params,
                                                            batch)
        torch.cuda.synchronize()
        trained = {k: n for k, n in kernels.LAUNCHES.items() if n}
        n_diff = sum(not torch.equal(a, b) for a, b in
                     zip(leaves(got_grads), leaves(want_grads)))
        check(torch.equal(got_loss, want_loss) and n_diff == 0,
              f"mesh: granite-MoE's training under the (1, 1) mesh: loss "
              f"{float(got_loss)} against {float(want_loss)}, {n_diff} "
              f"gradient leaves differ")
        check(trained.get("flash_attention", 0) > 0
              and trained.get("flash_attention_backward", 0) > 0,
              f"mesh: granite-MoE's training launched {trained}")
        walls["moe_train"] = time.perf_counter() - t
        log(f"mesh: granite-MoE, {n_layers} layers bf16, the loss and "
            f"gradients of a {tuple(batch['tokens'].shape)} batch under the "
            f"(1, 1) mesh (the MoE branch's backward) bit-equal to those "
            f"without one ({len(leaves(got_grads))} leaves, loss "
            f"{float(got_loss):.6f}); launches under the mesh {trained}; "
            f"{walls['moe_train']:.2f} s")
        del want_grads, got_grads, batch

        # reshard granite's tree under the train_4k rules, then a restore
        # onto the same shardings of its first MESH_RESTORE_LAYERS layers
        t = time.perf_counter()
        rules = rules_for("lm", LM_SHAPES["train_4k"])
        placed = elastic.reshard_tree(params, tr.param_names(c), rules,
                                      mesh)
        check(all(torch.equal(d.to_local(), w) for d, w in
                  zip(leaves(placed), leaves(params))),
              "mesh: a local shard after reshard_tree differs from its leaf")
        del placed
        walls["reshard"] = time.perf_counter() - t
        t = time.perf_counter()
        c_cut = dataclasses.replace(c, n_layers=MESH_RESTORE_LAYERS)
        cut = dict(params, layers=map_tree(
            lambda w: w[:MESH_RESTORE_LAYERS].clone(), params["layers"]))
        del params
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp)
            mgr.save(1, cut)
            step, back, _ = mgr.restore_latest(
                cut, device=dev, shardings=elastic.sharding_tree(
                    cut, tr.param_names(c_cut), rules, mesh))
        check(step == 1 and all(
            isinstance(d, torch.distributed.tensor.DTensor)
            and torch.equal(d.to_local(), w)
            for d, w in zip(leaves(back), leaves(cut))),
            "mesh: a shard restored onto its sharding differs from its leaf")
        n_bytes = sum(w.numel() * w.element_size() for w in leaves(cut))
        del back, cut
        walls["restore"] = time.perf_counter() - t
        log(f"mesh: reshard_tree of granite's {n_layers} layers under "
            f"train_4k's rules ({walls['reshard']:.2f} s) and a "
            f"restore_latest(shardings=) round trip of {MESH_RESTORE_LAYERS} "
            f"layer ({n_bytes} B, {walls['restore']:.2f} s): every local "
            f"shard bit-equal to its leaf")

        # the two-tower serve through sharded_streaming_topk
        t = time.perf_counter()
        u, cand = serve["u"], serve["cand"]
        kernels.reset_launches()
        with torch.no_grad(), mesh_context(mesh):
            _, ids = recsys.sharded_streaming_topk(u, cand, RG_SERVE["k"])
        torch.cuda.synchronize()
        diff = int((ids != serve["ids"]).sum())
        check(kernels.LAUNCHES["dense_topk_tiles"] == 1 and diff == 0,
              f"mesh: sharded_streaming_topk launched kernel 6 "
              f"{kernels.LAUNCHES['dense_topk_tiles']} times, {diff} ids "
              f"differ from streaming_topk's")
        log(f"mesh: two-tower serve ({u.shape[0]} x {cand.shape[0]} x "
            f"{cand.shape[1]}, k {RG_SERVE['k']}) through "
            f"sharded_streaming_topk: {diff} of {ids.numel()} ids differ "
            f"from streaming_topk's; kernel 6 launched "
            f"{kernels.LAUNCHES['dense_topk_tiles']} time")

        # the lookup over the candidate rows
        ids = torch.randint(0, cand.shape[0], MESH_LOOKUP, generator=gen,
                            device=dev)
        with torch.no_grad(), mesh_context(mesh):
            rows = embedding.sharded_lookup_manual(cand, ids, "model",
                                                   cand.shape[0])
        check(torch.equal(rows, cand[ids]),
              "mesh: sharded_lookup_manual differs from table[ids]")
        log(f"mesh: sharded_lookup_manual of {tuple(ids.shape)} ids over the "
            f"{tuple(cand.shape)} rows bit-equal to table[ids]")
        del rows, u, cand, serve
        walls["serve"] = time.perf_counter() - t

        # DimeNet's partitioned loss, one rank holding every edge
        t = time.perf_counter()
        c = rg_config("dimenet", reduced=False)
        params = rg_init("dimenet", c, dev, fan_in=True)
        batch = to_device(rg_host_batch("dimenet", c, None, SEED % 10_000),
                          dev)
        loss, grads = train_loop.value_and_grad(
            lambda p, b: gnn.loss_fn(p, c, b), params, batch)
        with mesh_context(mesh):
            loss_p, grads_p = train_loop.value_and_grad(
                lambda p, b: gnn.loss_fn_partitioned(p, c, b,
                                                     ("data", "model")),
                params, batch)
        loss_err = abs(float(loss_p) - float(loss)) / abs(float(loss))
        grad_err = max(_rel_err(a, b) for a, b in
                       zip(leaves(grads_p), leaves(grads)))
        check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL,
              f"mesh: DimeNet's partitioned loss {loss_err:.3e} or gradients "
              f"{grad_err:.3e} off loss_fn's")
        walls["dimenet"] = time.perf_counter() - t
        log(f"mesh: DimeNet at CONFIG (1/sqrt(fan-in) blocks), "
            f"{batch['edge_src'].shape[0]} edges on one rank: "
            f"loss_fn_partitioned's loss {loss_err:.3e} and gradients "
            f"{grad_err:.3e} (of each leaf's largest) from loss_fn's")
    finally:
        torch.distributed.destroy_process_group()
    log("mesh: walls s " + ", ".join(f"{k} {v:.2f}" for k, v in
                                      walls.items())
        + f"; phase {time.perf_counter() - t0:.1f} s")


def cells_serve_inputs(dev):
    """BERT4Rec's serve as ``rg_bert4rec`` draws it (for ``--only cells``):
    its parameters, the 512 histories with the mask token last, and
    ``streaming_topk``'s ids."""
    import torch
    from repro_torch.models import recsys
    c = rg_config("bert4rec", reduced=False)
    params = rg_init("bert4rec", c, dev)
    host = rg_host_batch("bert4rec", c, RG_SERVE["queries"], SEED % 10_000)
    items = torch.from_numpy(host["items"]).to(dev)
    items[:, -1] = c.n_items
    with torch.no_grad():
        h = recsys.bert4rec_hidden(params, c, items)
        _, ids = recsys.streaming_topk(h[:, -1], params["item_embed"],
                                       RG_SERVE["k"])
    return dict(params=params, items=items, ids=ids)


def nbytes(tree):
    from repro_torch.train.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def cells_phase(dev, b4r=None):
    """The cells phase (module docstring, 22): three dry-run cells built by
    ``launch/steps.build_cell`` on a (1, 1) NCCL mesh, their ``fn`` under
    ``mesh_context``.  ``b4r`` is the recsys_gnn phase's BERT4Rec serve
    (drawn here when the phase runs alone)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import yi_6b
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_local_mesh, mesh_context
    from repro_torch.models import transformer as tr
    from repro_torch.train import optimizer
    from repro_torch.train.tree import leaves, map_tree
    t0 = time.perf_counter()
    if b4r is None:
        b4r = cells_serve_inputs(dev)
        torch.cuda.synchronize()
        log(f"cells: BERT4Rec's serve drawn in "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh = make_local_mesh(device=dev)
    walls = {}
    try:
        # (a) Yi-6B x decode_32k at its own batch and cache, 2 layers
        t = time.perf_counter()
        c = dataclasses.replace(yi_6b.CONFIG, n_layers=CELLS_DECODE_LAYERS)
        cell = steps.build_cell("yi_6b", "decode_32k", mesh,
                                config_override=c)
        _, token_spec, cache_spec, _ = cell.args
        b, t_len = token_spec.shape[0], cache_spec["k"].shape[3]
        params = tr.init(c, seed=SEED, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 41)
        cache = {k: torch.randn(v.shape, generator=gen, dtype=v.dtype,
                                device=dev) for k, v in cache_spec.items()}
        token = torch.randint(0, c.vocab, (b,), generator=gen, device=dev,
                              dtype=torch.int32)
        kv_len = torch.full((b,), t_len - 1, dtype=torch.int32, device=dev)
        args = (params, token, cache, kv_len)
        arg_bytes = nbytes(args)
        want_cache = map_tree(torch.clone, cache)
        with torch.no_grad():
            want, want_cache = tr.decode_step(params, c, token, want_cache,
                                              kv_len)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        counter = dryrun.RankCounter()
        start, end = events()
        with torch.no_grad(), counter, mesh_context(mesh):
            start.record()
            got, got_cache = cell.fn(*args)
            end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated()
        launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
        check(torch.equal(got, want) and all(
            torch.equal(got_cache[k], want_cache[k]) for k in want_cache),
            "cells: the decode_32k cell's step differs from decode_step")
        check(launched == {"flash_decode": CELLS_DECODE_LAYERS},
              f"cells: the decode_32k cell launched {launched}, not "
              f"flash_decode once a layer")
        del want, want_cache, got, got_cache
        with torch.no_grad():
            fake = dryrun.measure(cell, mesh, dev.type)
        mem = fake["memory"]
        check(mem["argument_size"] == arg_bytes
              and fake["flops"] == counter.flops,
              f"cells: the dry run's argument bytes {mem['argument_size']} "
              f"(real {arg_bytes}) or FLOPs {fake['flops']} (the counter on "
              f"the real step: {counter.flops}) differ")
        walls["decode"] = time.perf_counter() - t
        log(f"cells: Yi-6B x decode_32k, {CELLS_DECODE_LAYERS} layers bf16, "
            f"batch {b}, cache {t_len} (kv_len {t_len - 1}): Cell.fn "
            f"bit-equal to decode_step (logits and cache), {step_ms:.3f} ms "
            f"(CUDA events), launches {launched}; dry run on the (1, 1) mesh "
            f"in {fake['seconds']:.2f} s: argument bytes {arg_bytes} = the "
            f"real arguments', FLOPs {fake['flops']} = the counter on the "
            f"real step, collectives {fake['coll']['total']} B; modeled peak "
            f"(arguments + temporaries) {mem['argument_size'] + mem['temp_size']} "
            f"B beside the step's max_memory_allocated {peak} B (two caches "
            f"held)")
        del args, params, cache, cell
        torch.cuda.empty_cache()

        # (b) BERT4Rec x serve_p99 on the recsys_gnn phase's serve
        t = time.perf_counter()
        cell = steps.build_cell("bert4rec", "serve_p99", mesh)
        kernels.reset_launches()
        start, end = events()
        with torch.no_grad(), mesh_context(mesh):
            start.record()
            vals, ids = cell.fn(b4r["params"], b4r["items"])
            end.record()
        torch.cuda.synchronize()
        launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
        diff = int((ids != b4r["ids"]).sum())
        n_blocks = rg_config("bert4rec", reduced=False).n_blocks
        check(diff == 0 and launched == {"flash_attention": n_blocks,
                                         "dense_topk_tiles": 1},
              f"cells: BERT4Rec's serve cell: {diff} ids differ, launches "
              f"{launched}")
        walls["bert4rec"] = time.perf_counter() - t
        log(f"cells: BERT4Rec x serve_p99 ({tuple(b4r['items'].shape)} "
            f"histories, k {RG_SERVE['k']}): {diff} of {ids.numel()} ids "
            f"differ from the recsys_gnn serve's, {start.elapsed_time(end):.3f}"
            f" ms (CUDA events), launches {launched}")
        del vals, ids, b4r, cell

        # (c) DimeNet x molecule, partitioned against not
        t = time.perf_counter()
        c = rg_config("dimenet", reduced=False)
        host = rg_host_batch("dimenet", c, None, SEED % 10_000)
        params = rg_init("dimenet", c, dev, fan_in=True)
        runs = {}
        for name, rules in (("partitioned", None),
                            ("unpartitioned", {"partition_gnn": False})):
            cell = steps.build_cell("dimenet", "molecule", mesh, rules,
                                    dataclasses.replace(c))
            p = map_tree(torch.clone, params)
            with mesh_context(mesh):
                runs[name] = cell.fn(p, optimizer.init(p),
                                     to_device(host, dev))
        torch.cuda.synchronize()
        (p_a, o_a, l_a, m_a), (p_b, o_b, l_b, _) = (runs["partitioned"],
                                                    runs["unpartitioned"])
        loss_err = abs(float(l_a) - float(l_b)) / abs(float(l_b))
        errs = [_rel_err(a, w) for a, w in zip(
            leaves(o_a.m) + leaves(o_a.v), leaves(o_b.m) + leaves(o_b.v))]
        # AdamW's first step moves an entry by about lr · sign(g): where a
        # gradient is near 0 its sign may differ, and the entry by 2 lr
        lr = float(m_a["lr"])
        p_diff = max(float((a - w).abs().max())
                     for a, w in zip(leaves(p_a), leaves(p_b)))
        check(loss_err <= TRAIN_LOSS_TOL and max(errs) <= TRAIN_GRAD_TOL
              and p_diff <= 2.2 * lr,
              f"cells: DimeNet's partitioned train step {loss_err:.3e} "
              f"(loss), {max(errs):.3e} (moments) or {p_diff:.3e} "
              f"(parameters, lr {lr:.3e}) off the unpartitioned step's")
        walls["dimenet"] = time.perf_counter() - t
        log(f"cells: DimeNet x molecule at CONFIG (1/sqrt(fan-in) blocks), "
            f"{host['edge_src'].shape[0]} edges: the partitioned step's loss "
            f"{loss_err:.3e} and moments {max(errs):.3e} (of each leaf's "
            f"largest) from the unpartitioned step's, parameters "
            f"{p_diff:.3e} apart (lr {lr:.3e})")
    finally:
        torch.distributed.destroy_process_group()
    log("cells: walls s " + ", ".join(f"{k} {v:.2f}" for k, v in
                                       walls.items())
        + f"; phase {time.perf_counter() - t0:.1f} s")


def lm_phase(dev, n_layers, prompt, steps, profile=False):
    """The LM phase (module docstring, 17): cross-check, serve, kernel rows.
    Returns the rows of kernels 8 and 9."""
    xc_calls = lm_cross_check(dev, min(XC_LEN, prompt))
    launches, serve_calls = lm_serve(dev, n_layers, prompt, steps, profile)
    recorded = {n: serve_calls[n] + xc_calls[n] for n in LM_KERNELS}
    return lm_kernel_phase(recorded, launches, dev)


# ---------------------------------------------------------------------------
# training: the fit phase, its kernels, and the BENCH_tail flow
# ---------------------------------------------------------------------------

def fitted_models(system):
    """The four fitted GBRTs of a system, by name."""
    return {**system.models, "ltr": system.ltr.model}


def same_forest(label, a, b):
    """Require two fitted tree models' forests (feat, thresh, leaf), bin
    edges and, for a GBRT, base to be equal bit for bit."""
    import torch

    def bits(t):
        t = t.cpu()
        return t.view(torch.int32) if t.is_floating_point() else t

    pairs = [(f, getattr(a.forest, f), getattr(b.forest, f))
             for f in ("feat", "thresh", "leaf")]
    pairs += [(f, getattr(a, f), getattr(b, f))
              for f in ("base", "bin_edges") if hasattr(a, f)]
    for field, u, v in pairs:
        check(u.dtype == v.dtype and torch.equal(bits(u), bits(v)),
              f"{label}: {field} differs")


def same_models(label, a, b):
    """Require two systems' fitted forests (feat, thresh, leaf, base, bin
    edges) and routing thresholds to be equal bit for bit."""
    ma, mb = fitted_models(a), fitted_models(b)
    for name in ma:
        same_forest(f"{label}: {name}", ma[name], mb[name])
    ra, rb = a.cascade_spec.routing, b.cascade_spec.routing
    check(ra.t_k == rb.t_k and ra.t_time == rb.t_time,
          f"{label}: t_k/t_time {ra.t_k}/{ra.t_time} vs {rb.t_k}/{rb.t_time}")


def profile_fit(spec, index, corpus, ql, dev):
    """One more card fit, of a fresh system, under ``torch.profiler``: wall,
    device busy time, host time per ``stage:`` (the features, each tree's
    builder, its leaf values, the level kernels' wrappers and the boosting
    update inside them, the LTR set), the busiest device kernels."""
    from torch.profiler import record_function
    from repro_torch.core import features, gbrt, trees
    from repro_torch.kernels.level_histogram import ops as lh
    from repro_torch.serving import system as system_mod
    from repro_torch.serving.system import build_system
    sites = [(features, "extract"), (trees, "build_tree"),
             (gbrt, "_leaf_values"), (lh, "level_histogram"),
             (lh, "level_split"), (lh, "level_route"),
             (lh, "boost_update"), (system_mod, "qd_features")]
    orig = [getattr(mod, name) for mod, name in sites]
    for (mod, name), fn in zip(sites, orig):
        def timed(*a, _fn=fn, _name=name, **kw):
            with record_function(f"stage:{_name}"):
                return _fn(*a, **kw)
        setattr(mod, name, timed)
    system = build_system(spec, index, corpus=corpus, device=dev)
    try:
        prof, wall_ms = run_profiled(lambda: system.fit(ql, None,
                                                        seed=FIT_SEED))
    finally:
        for (mod, name), fn in zip(sites, orig):
            setattr(mod, name, fn)
    log_profile(prof, wall_ms, "profile of fit")


def fit_phase(spec, index, corpus, dev, layouts, profile=False):
    """``SearchSystem.fit(ql, None, seed=FIT_SEED)`` from a log of
    FIT_QUERIES queries on the card (counted from 0; every
    ``level_histogram`` and ``boost_update`` call recorded, and every
    FIT_SAMPLE-th and the largest ``level_split`` and ``level_route``
    call) and on the CPU (plain versions), both systems built from the
    shard's shared host ``layouts``; requires the four forests and the
    routing thresholds bit-equal; then ``sampled_fit`` and
    ``tree_kernels``.  With ``profile``, one more card fit under the
    profiler.  Returns (card system, CPU system, launches, recorded calls,
    the query log)."""
    import torch
    from repro_torch import kernels
    from repro_torch.index.corpus import build_queries
    from repro_torch.serving.system import build_system
    ql = build_queries(corpus, FIT_QUERIES, stop_k=spec.index.stop_k,
                       seed=FIT_SEED)
    t = time.perf_counter()
    gpu = build_system(spec, index, corpus=corpus, device=dev,
                       layouts=layouts)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    kernels.reset_launches()
    every = {name: FIT_SAMPLE for name in LEVEL_KERNELS}
    with Recorder(FIT_KERNELS, every=every) as rec:
        t = time.perf_counter()
        gpu.fit(ql, None, seed=FIT_SEED)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t
    launches = {name: kernels.LAUNCHES[name] for name in FIT_KERNELS}
    t = time.perf_counter()
    cpu = build_system(spec, index, corpus=corpus, device="cpu",
                       layouts=layouts)
    t_build_cpu = time.perf_counter() - t
    t = time.perf_counter()
    cpu.fit(ql, None, seed=FIT_SEED)
    t_cpu = time.perf_counter() - t
    same_models("fit", gpu, cpu)
    r = gpu.cascade_spec.routing
    log(f"fit: systems built from the shared layout: card {t_build:.2f} s, "
        f"CPU {t_build_cpu:.2f} s")
    log(f"fit ({FIT_QUERIES} queries, seed {FIT_SEED}; LTR set "
        f"{min(FIT_QUERIES, 32)} x 64): card {t_card:.2f} s, CPU "
        f"{t_cpu:.2f} s; launches {launches}; t_k {r.t_k!r}, t_time "
        f"{r.t_time!r}; the four forests bit-equal on the card and the CPU")
    for name in FIT_KERNELS:
        check(launches[name] > 0, f"fit: kernel {name} never launched")
    check(launches["level_split"] == launches["level_route"],
          "fit: level_split and level_route launched unequally")
    sampled_fit(dev)
    tree_kernels(max(rec.calls["level_split"],
                     key=lambda c: work_of("level_split", *c)[0]))
    if profile:
        profile_fit(spec, index, corpus, ql, dev)
    return gpu, cpu, launches, rec.calls, ql


def sampled_fit(dev):
    """One small quantile GBRT fit with column and row sampling
    (``colsample`` 0.5, ``subsample`` 0.8: each tree's feature mask and row
    weights drawn from the seed as the reference draws them) on the card
    and on the CPU from the same seeded rows; requires the forests, base
    and bin edges bit-equal."""
    import numpy as np
    import torch
    from repro_torch.core import gbrt
    rng = np.random.RandomState(SAMPLED_FIT["seed"])
    x = rng.randn(SAMPLED_FIT["n"], SAMPLED_FIT["n_feat"]).astype(np.float32)
    y = (x[:, 0] + np.sin(3 * x[:, 1]) + 0.1 * rng.randn(len(x))).astype(
        np.float32)
    p = gbrt.GBRTParams(n_trees=16, depth=5, loss="quantile", tau=0.75,
                        colsample=0.5, subsample=0.8)
    t = time.perf_counter()
    card = gbrt.fit(x, y, p, seed=SAMPLED_FIT["seed"], device=dev)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t
    t = time.perf_counter()
    host = gbrt.fit(x, y, p, seed=SAMPLED_FIT["seed"], device="cpu")
    same_forest("sampled fit", card, host)
    fmask, w = gbrt.tree_draws(SAMPLED_FIT["seed"], len(x), x.shape[1], p)
    log(f"sampled fit (quantile, 16 trees, colsample 0.5, subsample 0.8, "
        f"{len(x)} x {x.shape[1]}; {fmask.sum(1).min()}-{fmask.sum(1).max()}"
        f" features and {int(w.sum(1).min())}-{int(w.sum(1).max())} rows a "
        f"tree): card {t_card:.2f} s, CPU {time.perf_counter() - t:.2f} s, "
        "forest, base and bin edges bit-equal")


def tree_kernels(call, depth=TREE_DEPTH):
    """One card ``build_tree`` at ``depth`` on a recorded ``level_split``
    call's bins, target, weights and mask, counted under ``torch.profiler``:
    at most two device kernels a level plus TREE_FIXED_KERNELS; its tree
    bit-equal to the CPU's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import trees
    (xbt, _, g, w, fmask), kw = call
    params = trees.TreeParams(depth, kw["n_bins"], kw["min_child_weight"],
                              kw["l2"])
    run = lambda: trees.build_tree(xbt, g, w[0], fmask[0], params)
    got = run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    want = trees.build_tree(xbt.cpu(), g.cpu(), w[0].cpu(), fmask[0].cpu(),
                            params)
    for a, b in zip(got, want):
        check(torch.equal(a.cpu(), b), "build_tree: the card's tree differs "
              "from the CPU's")
    levels = sum("level_kernel" in n or "level_route_kernel" in n
                 for n in names)
    log(f"build_tree at depth {depth} (n {xbt.shape[1]}, F {xbt.shape[0]}):"
        f" {len(names)} device kernels ({levels} of the level kernels), "
        f"tree bit-equal to the CPU's; "
        + ", ".join(sorted({n[:60] for n in names})))
    check(len(names) <= 2 * depth + TREE_FIXED_KERNELS,
          f"build_tree: {len(names)} device kernels at depth {depth}, above "
          f"2 a level + {TREE_FIXED_KERNELS}")


def level_histogram_edge_calls(device):
    """Seeded edge cases: a constant feature (every row in one bin, also at
    depth 0 where one cell takes every row: the longest serial chain), rows
    of weight 0, n not a multiple of 32 or of the 4,096-row tile (37,
    1,000, 1,025, 4,097), depth 1 and depth 5 levels (1 and 16 nodes), 32
    nodes (two node groups a feature at 64 bins), 256 bins (4 and 8 nodes:
    one and two groups of four)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED % 1000)

    def call(n, n_feat, n_nodes, n_bins=64, constant=False, zeros=0.0):
        xb = rng.randint(0, n_bins, (n_feat, n)).astype(np.uint8)
        if constant:
            xb[0] = n_bins // 2
        node = rng.randint(0, n_nodes, n).astype(np.int32)
        g = (rng.standard_cauchy(n) * 10).astype(np.float32)
        w = (rng.rand(n) >= zeros).astype(np.float32)
        t = [torch.from_numpy(a).to(device) for a in (xb, node, g * w, w)]
        return tuple(t), dict(n_nodes=n_nodes, n_bins=n_bins)

    return [call(4096, 147, 1, constant=True),
            call(4096, 147, 16, constant=True, zeros=0.3),
            call(37, 5, 2), call(1000, 8, 1, zeros=0.5),
            call(1025, 147, 16), call(4097, 3, 32), call(600, 4, 4, 256),
            call(600, 4, 8, 256)]


def level_split_edge_calls(device):
    """``level_split``'s edge cases: each of ``level_histogram_edge_calls``
    as one tree (its g·w as g, every feature in the mask), and four more:
    equal gains across features (columns 2, 5 and 9 one column, a target
    two-valued on it: feature 2 must win every node), dead nodes (a
    min_child_weight few children reach, and one none reaches), a
    one-feature mask (each of 4 trees its own feature) and 64 trees x 32
    nodes (the RF's deepest level: 147 features, 1,800 rows, Poisson
    weights, masks of 0.4)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED % 997)
    calls = []
    for (xbt, node, gw, w), kw in level_histogram_edge_calls(device):
        fmask = torch.ones((1, xbt.shape[0]), dtype=torch.bool, device=device)
        calls.append(((xbt, node[None], gw, w[None], fmask),
                      dict(kw, l2=1.0, min_child_weight=10.0)))

    def call(n, n_feat, n_trees, n_nodes, mcw=10.0, ties=False, one=False,
             p=1.0):
        xb = rng.randint(0, 64, (n_feat, n)).astype(np.uint8)
        g = (rng.standard_cauchy(n) * 10).astype(np.float32)
        if ties:
            xb[5] = xb[2]
            xb[9] = xb[2]
            g = np.where(xb[2] > 31, 1.0, -1.0).astype(np.float32)
        node = rng.randint(0, n_nodes, (n_trees, n)).astype(np.int32)
        w = rng.poisson(1.0, (n_trees, n)).astype(np.float32)
        fmask = rng.rand(n_trees, n_feat) < p
        if one:
            fmask[:] = False
            fmask[np.arange(n_trees), rng.randint(0, n_feat, n_trees)] = True
        t = [torch.from_numpy(a).to(device) for a in (xb, node, g, w, fmask)]
        return tuple(t), dict(n_nodes=n_nodes, n_bins=64, l2=1.0,
                              min_child_weight=mcw)

    return calls + [call(4096, 147, 1, 8, ties=True),
                    call(4096, 147, 1, 16, mcw=150.0),
                    call(4096, 20, 2, 4, mcw=1e6),
                    call(2000, 147, 4, 8, one=True),
                    call(1800, 147, 64, 32, p=0.4)]


def route_args(split_call):
    """A ``level_route`` call after a ``level_split`` call: the split's
    plain outputs, and zeroed feat and thresh deep and wide enough for its
    nodes (the last level)."""
    import torch
    from repro_torch.kernels.level_histogram import ops as lh
    (xbt, node, g, w, fmask), kw = split_call
    gain, best = lh.level_split_plain(xbt, node, g, w, fmask, **kw)
    depth = kw["n_nodes"].bit_length()
    shape = (node.shape[0], depth, 2 ** (depth - 1))
    feat = torch.zeros(shape, dtype=torch.int32, device=xbt.device)
    return ((xbt, node.clone(), gain, best, feat, feat.clone()),
            dict(level=depth - 1, n_bins=kw["n_bins"]))


def routed(fn, args, kw):
    """``fn`` (``level_route`` or its plain version) on copies of the
    tensors it updates: (node, feat, thresh)."""
    xbt, node, gain, best, feat, thresh = args
    out = node.clone(), feat.clone(), thresh.clone()
    fn(xbt, out[0], gain, best, out[1], out[2], **kw)
    return out


def fresh_nodes(fn, node, count):
    """``fn`` with each call's node ids a fresh copy of ``node``, ``count``
    made beforehand (a route updates them in place), for timing."""
    copies = [node.clone() for _ in range(count)]
    return lambda xbt, _node, *rest, **kw: fn(xbt, copies.pop(), *rest, **kw)


def index_add_histograms(args, kw):
    """The library call: both histograms by one fp32 ``index_add_`` on the
    card (float atomics, in no fixed order), its keys and values formed
    outside the timed call."""
    import torch
    xbt, node, gw, w = args
    n_feat, n = xbt.shape
    n_bins = kw["n_bins"]
    n_seg = kw["n_nodes"] * n_feat * n_bins
    feat = torch.arange(n_feat, device=xbt.device)
    keys = ((node.long()[:, None] * n_feat + feat[None, :]) * n_bins
            + xbt.T.long()).reshape(-1)
    vals = torch.stack([gw, w], dim=1)[:, None, :].expand(
        n, n_feat, 2).reshape(-1, 2)
    return lambda: torch.zeros((n_seg, 2), device=xbt.device).index_add_(
        0, keys, vals)


def fit_kernel_phase(calls):
    """The fit's level kernels against their plain versions (tolerance 0.0)
    on a sample of the card fit's own calls, its largest and the edge
    cases, each timed beside its plain version: ``level_histogram`` on the
    fit's calls (the LTR's leaf means) and on the histograms of the fit's
    largest level (timed there beside ``index_add_``, whose sums are
    counted where they differ from the ordered ones, and the earlier
    design), ``level_split`` and ``level_route`` on every recorded call
    (every FIT_SAMPLE-th and the largest); the constant feature at depth 0
    (one cell takes every row) timed as the worst case; ``boost_update``
    on a sample of its calls.  Returns the three level kernels' rows."""
    import torch
    from repro_torch.kernels.level_histogram import ops as lh
    hist, split, route = (calls[name] for name in ("level_histogram",
                                                   "level_split",
                                                   "level_route"))
    check(hist and split and route, "fit: a level kernel was never called")
    largest = max(split, key=lambda c: work_of("level_split", *c)[0])
    (xbt, node, g, w, _), kw = largest
    dev = xbt.device
    # the histograms of the fit's largest level, as one level_histogram call
    big = ((xbt, node[0].contiguous(), g * w[0], w[0].contiguous()),
           dict(n_nodes=kw["n_nodes"], n_bins=kw["n_bins"]))
    edges = level_histogram_edge_calls(dev)
    sample = hist[::FIT_SAMPLE] + hist[-1:] + [big]
    err = 0.0
    for args, kw in sample + edges:
        got = lh.level_histogram(*args, **kw)
        want = lh.level_histogram_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, compare("level_histogram", got, want, 0.0))
    args, kw = big
    note = (f"{len(sample)} of the fit's calls ({len(hist)} leaf means and "
            f"its largest level) and {len(edges)} edge cases checked; (nodes,"
            f" F, n) = ({kw['n_nodes']}, {args[0].shape[0]}, "
            f"{args[0].shape[1]})")
    rows = {"level_histogram": kernel_row(
        "level_histogram", lh.level_histogram, lh.level_histogram_plain,
        index_add_histograms, args, kw, err, note)}
    kern = lambda: lh.level_histogram(*args, **kw)
    log_redesign("level_histogram", rows["level_histogram"]["ms"], kern)
    want = torch.stack(lh.level_histogram(*args, **kw), dim=-1).reshape(-1, 2)
    lib = index_add_histograms(args, kw)
    diff = [int((lib() != want).any(dim=1).sum()) for _ in range(REPS)]
    log(f"kernel level_histogram: device {device_ms(kern, REPS)} ms a call, "
        f"index_add_ device {device_ms(lib, REPS)} ms (profiler); "
        f"index_add_'s sums differ from the ordered ones in {diff} of "
        f"{want.shape[0]} cells over {REPS} calls")
    args, kw = edges[0]
    worst = lambda: lh.level_histogram(*args, **kw)
    log(f"kernel level_histogram, worst case (a constant feature at depth "
        f"0, 4,096 rows in one cell, 147 features): "
        f"{cuda_ms(worst, REPS):.4f} ms, device {device_ms(worst, REPS)} ms")

    split_edges = level_split_edge_calls(dev)
    err = 0.0
    for args, kw in split + split_edges:
        got = lh.level_split(*args, **kw)
        want = lh.level_split_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, compare("level_split", got, want, 0.0))
    args, kw = largest
    note = (f"{len(split)} of the fit's calls (every {FIT_SAMPLE}th and the "
            f"largest) and {len(split_edges)} edge cases checked; (T, nodes,"
            f" F, n) = ({args[1].shape[0]}, {kw['n_nodes']}, "
            f"{args[0].shape[0]}, {args[0].shape[1]})")
    rows["level_split"] = kernel_row("level_split", lh.level_split,
                                     lh.level_split_plain, None, args, kw,
                                     err, note)
    kern = lambda: lh.level_split(*args, **kw)
    log(f"kernel level_split: device {device_ms(kern, REPS)} ms a call "
        "(profiler)")
    for label, (args, kw) in (("worst case (a constant feature at depth 0)",
                               split_edges[0]),
                              ("64 trees x 32 nodes", split_edges[-1])):
        kern = lambda: lh.level_split(*args, **kw)
        log(f"kernel level_split, {label}: {cuda_ms(kern, REPS):.4f} ms, "
            f"device {device_ms(kern, REPS)} ms")

    route_edges = [route_args(c) for c in split_edges]
    err = 0.0
    for args, kw in route + route_edges:
        got = routed(lh.level_route, args, kw)
        want = routed(lh.level_route_plain, args, kw)
        torch.cuda.synchronize()
        err = max(err, compare("level_route", got, want, 0.0))
    args, kw = max(route, key=lambda c: work_of("level_route", *c)[0])
    note = (f"{len(route)} of the fit's calls and {len(route_edges)} edge "
            f"cases checked (node, feat, thresh); (T, nodes, F, n) = "
            f"({args[1].shape[0]}, {args[2].shape[1]}, {args[0].shape[0]}, "
            f"{args[0].shape[1]})")
    rows["level_route"] = kernel_row(
        "level_route", fresh_nodes(lh.level_route, args[1], REPS + 1),
        fresh_nodes(lh.level_route_plain, args[1], REPS // 4 + 1), None,
        args, kw, err, note)
    kern = fresh_nodes(lh.level_route, args[1], 2 * REPS + 2)
    log(f"kernel level_route: device "
        f"{device_ms(lambda: kern(*args, **kw), REPS)} ms a call (profiler)")

    boost = calls["boost_update"]
    for args, kw in boost[::16] + boost[-1:]:
        got = lh.boost_update(*args, **kw)
        torch.cuda.synchronize()
        compare("boost_update", got, lh.boost_update_plain(*args, **kw), 0.0)
    log(f"kernel boost_update: {len(boost[::16]) + 1} of the fit's "
        f"{len(boost)} calls equal to the plain version (tolerance 0.0)")
    return rows


def tail_figures(payload):
    """The figures of a BENCH_tail payload (``benchmarks/bench_tail.py``'s
    or ``tail_flow``'s), flat."""
    out = {k: payload[k] for k in TAIL_FIGURES}
    out["budget_percentile"] = payload["config"]["budget_percentile"]
    for side in ("seed_scheduler", "enforced"):
        for k, v in payload[side].items():
            out[f"{side}.{k}"] = v
    return out


def tail_flow(device, q_batch=256, n_docs=8192, seed=7, pcts=(85, 70, 50)):
    """The BENCH_tail flow of ``benchmarks/bench_tail.py:43-130`` with the
    port on ``device``: a system fitted from ``q_batch`` queries with
    ``seed``, the raw latency tail, then per budget percentile the seed
    scheduler (the no-op late hedge, no enforcement) against the enforced
    one, on one trace and the same models.  Returns ``tail_figures``."""
    import numpy as np
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.index.corpus import (CorpusParams, build_corpus,
                                          build_queries)
    from repro_torch.serving.latency import budget_attribution
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.serving.system import build_system

    t0 = time.perf_counter()
    corpus = build_corpus(CorpusParams(n_docs=n_docs,
                                       vocab=max(n_docs // 2, 2048),
                                       avg_doclen=96, zipf_a=1.05, seed=seed))
    base = get_preset("paper_200ms")
    ql = build_queries(corpus, q_batch, stop_k=base.index.stop_k,
                       seed=seed + 4)
    fit_sys = build_system(base, corpus, device=device)
    t = time.perf_counter()
    fit_sys.fit(ql, None, seed=seed)
    t_fit = time.perf_counter() - t
    index, models, ltr = fit_sys.index, fit_sys.models, fit_sys.ltr
    cost = fit_sys.cost
    base = dataclasses.replace(
        base, routing=dataclasses.replace(
            base.routing, t_k=fit_sys._base_cfg.t_k,
            t_time=fit_sys._base_cfg.t_time, calibrate=False,
            adapt_every=0))

    def system(**routing_kw):
        spec = dataclasses.replace(
            base, routing=dataclasses.replace(base.routing, **routing_kw))
        return build_system(spec, index, corpus=corpus, models=models,
                            ltr=ltr, device=device)

    probe = system(budget=1e9, enable_hedging=False, enforce_budget=False)
    lat_raw = probe.serve(ql.terms, ql.mask, ql.topic).latency
    chosen = None
    for pct in pcts:
        budget = float(np.percentile(lat_raw, pct))
        budget1 = budget_attribution(budget, cost,
                                     base.stage2.k_serve)["stage1"]
        if budget1 <= 0:
            continue
        probe_cfg = SchedulerConfig(budget=budget1,
                                    hedge_deadline=base.routing.hedge_deadline)
        late_rho = min(probe_cfg.max_late_rho(cost), base.routing.rho_min)
        if late_rho < 1:
            continue
        seed_sys = system(budget=budget, late_rho=base.routing.rho_max,
                          enforce_budget=False)
        enf_sys = system(budget=budget, late_rho=late_rho,
                         enforce_budget=True)
        res_seed = seed_sys.serve(ql.terms, ql.mask, ql.topic)
        res_enf = enf_sys.serve(ql.terms, ql.mask, ql.topic)
        cand = (pct, budget, late_rho, enf_sys, res_seed, res_enf)
        if res_seed.stats["over_budget"] >= 1 and chosen is None:
            chosen = cand
        if (res_seed.stats["over_budget"] >= 1
                and res_seed.stats["late_hedged"] >= 1):
            chosen = cand
            break
    check(chosen is not None, f"tail on {device}: no feasible budget")
    pct, budget, late_rho, enf_sys, res_seed, res_enf = chosen
    bound = enf_sys.worst_case_us()

    def side(res, jass):
        out = {"over_budget": int(res.stats["over_budget"]),
               "over_budget_pct": float(res.stats["over_budget_pct"]),
               "max": float(res.latency.max()),
               "late_hedged": int(res.stats["late_hedged"])}
        if jass:
            out.update(
                late_hedged_jass=int(res.stats["late_hedged_jass"]),
                stage2_trimmed=int(res.stats["budget"]["stage2_trimmed"]),
                stage2_skipped=int(res.stats["budget"]["stage2_skipped"]))
        return out

    figures = tail_figures({
        "config": {"budget_percentile": pct},
        "budget": budget, "late_rho": int(late_rho),
        "raw_max": float(lat_raw.max()), "worst_case_bound": float(bound),
        "bound_holds": bool(res_enf.latency.max() <= bound + 1e-9),
        "seed_scheduler": side(res_seed, False),
        "enforced": side(res_enf, True),
        "identical_topk": bool(np.array_equal(res_seed.topk, res_enf.topk)),
        "identical_final": bool(np.array_equal(res_seed.final,
                                               res_enf.final)),
        "regression_demonstrated": int(res_seed.stats["over_budget"]) >= 1,
        "bmw_late_hedge_exercised": int(res_seed.stats["late_hedged"]) >= 1,
        "guarantee_holds": int(res_enf.stats["over_budget"]) == 0})
    log(f"tail on {device}: fit {t_fit:.2f} s, whole flow "
        f"{time.perf_counter() - t0:.2f} s")
    return figures


def tail_phase(dev):
    """The BENCH_tail flow on the card (counted from 0) and on the CPU:
    every figure equal on both; each held against
    ``results/BENCH_tail.json``, read here, and logged."""
    from repro_torch import kernels
    kernels.reset_launches()
    card = tail_flow(dev)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    host = tail_flow("cpu")
    for key, v in card.items():
        check(host[key] == v, f"tail: {key} {v!r} on the card, "
              f"{host[key]!r} on the CPU")
    check(card["guarantee_holds"] and card["regression_demonstrated"]
          and card["identical_topk"] and card["identical_final"],
          "tail: the enforced run must hold the budget at identical output "
          "while the seed scheduler leaks")
    art = tail_figures(json.loads(TAIL_ARTIFACT.read_text()))
    same = [k for k in art if card.get(k) == art[k]]
    differ = {k: (card.get(k), art[k]) for k in art if k not in same}
    log(f"tail: figures equal on the card and the CPU: {card}; launches "
        f"{launches}")
    log(f"tail: against {TAIL_ARTIFACT.relative_to(ROOT)}: equal {same}; "
        f"differ (this run, the file) {differ}")


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------

def cli_phase(dev):
    """``repro_torch.launch.serve.run`` at the reference CLI's defaults on
    the card (counted from 0): corpus, build, the oracle labels (on the
    host), the labelled fit and one serve of the whole trace; prints its
    ``[serve]`` lines, walls and launches.  Then, from the same index,
    corpus, query log and labels, a CPU fit (the four forests, the
    regressed cost model and the budget reservation bit-equal to the
    card's) and the first CLI_CROSS queries served as their own call on
    the CPU and on a fresh card system with the card's fitted models
    (``topk``, ``final``, latency, routes and over-budget count equal);
    the ``--dryrun`` dict through the CLI equal to a direct call on the
    same spec and corpus, and post-build on the index; a ``--spec-json``
    spec loading back equal to the one served.  Returns the CLI's run and
    the CPU system."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch import dryrun_cascade, serve
    from repro_torch.serving.spec import CascadeSpec
    from repro_torch.serving.system import build_system
    t0 = time.perf_counter()
    kernels.reset_launches()
    card = serve.run(["--device", str(dev)], say=print)
    launches = {name: kernels.LAUNCHES[name] for name in CLI_KERNELS}
    for line in serve.report(card):
        print(line, flush=True)
    g, labels, ql = card.system, card.labels, card.ql
    w = card.walls
    log(f"cli: {len(ql.terms)} queries, {g.index.n_docs} docs; walls s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in w.items())
        + f" (labels on the host); launches {launches}")
    log(f"cli: labels keep {int(labels.keep.sum())}, median oracle_k "
        f"{np.median(labels.oracle_k)}, oracle_rho "
        + str(dict(zip(*(a.tolist() for a in np.unique(
            labels.oracle_rho, return_counts=True))))))
    for name in CLI_KERNELS:
        check(launches[name] > 0, f"cli: kernel {name} never launched")
    res = card.result
    check(res.topk.shape == (len(ql.terms), card.spec.stage2.k_serve)
          and np.isfinite(res.latency).all() and (res.topk >= 0).all(),
          "cli: served result invalid")

    t = time.perf_counter()
    cpu = build_system(card.spec, g.index, corpus=card.corpus,
                       device="cpu")
    cpu.fit(ql, labels)
    t_fit = time.perf_counter() - t
    # a fresh card system with the card's fit (serving has adapted the
    # served one's thresholds since)
    gpu = build_system(card.fitted, g.index, corpus=card.corpus,
                       models=g.models, ltr=g.ltr, cost=g.cost, device=dev)
    same_models("cli fit", gpu, cpu)
    check(dataclasses.asdict(g.cost) == dataclasses.asdict(cpu.cost),
          "cli: the regressed cost models differ")
    check(g._budget_reserve == cpu._budget_reserve
          and gpu._budget_reserve == cpu._budget_reserve,
          "cli: the budget reservations differ")
    sub = slice(0, CLI_CROSS)
    topics = ql.topic[sub]
    t = time.perf_counter()
    a = gpu.serve(ql.terms[sub], ql.mask[sub], topics)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t
    t = time.perf_counter()
    b = cpu.serve(ql.terms[sub], ql.mask[sub], topics)
    t_cpu = time.perf_counter() - t
    same_batch("cli", a, b)
    for key in ("jass", "bmw", "hedged", "late_hedged", "late_hedged_jass",
                "over_budget"):
        check(a.stats[key] == b.stats[key],
              f"cli: {key} {a.stats[key]} on the card, {b.stats[key]} on "
              "the CPU")
    log(f"cli: CPU fit {t_fit:.2f} s, forests, cost model and budget "
        f"reservation bit-equal to the card's; first {CLI_CROSS} queries "
        f"served as their own call: card {t_card:.2f} s, CPU {t_cpu:.2f} s, "
        f"topk, final, latency, routes and over-budget equal (p99 "
        f"{a.stats['p99']:.3f}, over budget {a.stats['over_budget']})")

    dry = serve.run(["--device", str(dev), "--dryrun"],
                    say=lambda line: None).dryrun
    check(dry == dryrun_cascade.dryrun(card.spec, card.corpus,
                                       n_queries=len(ql.terms)),
          "cli: the --dryrun dict differs from a direct call")
    post = dryrun_cascade.dryrun(card.spec, card.corpus,
                                 n_queries=len(ql.terms), index=g.index)
    check(post["config"]["costing"] == "index"
          and np.isfinite(post["config"]["worst_case_bound"]),
          "cli: post-build dry run")
    for label, d in (("pre-build", dry), ("post-build", post)):
        p = d["enforced"]["percentiles"]
        log(f"cli: dryrun {label}: enforced p99 {p['p99']:.3f} max "
            f"{p['max']:.3f}, over budget {d['enforced']['over_budget']}, "
            f"bound {d['config']['worst_case_bound']:.3f}")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "spec.json")
        serve.run(["--spec-json", path], say=lambda line: None)
        check(CascadeSpec.from_json(Path(path).read_text()) == card.spec,
              "cli: the --spec-json spec differs from the one served")
    log("cli: --dryrun equal to a direct call, --spec-json loads back "
        f"equal to the spec served; phase {time.perf_counter() - t0:.1f} s")
    return card, cpu


# ---------------------------------------------------------------------------
# the Stage-0 prediction framework and the serve-path shims
# ---------------------------------------------------------------------------

def rf_level_calls(xtr, ytr, cfg, model, dev):
    """Fold 0's random forest fitted once more on the card with its level
    calls recorded (each level larger than the last: all of them) and its
    leaf means' call: the forest equal to the cross-validation's, and every
    call equal to its plain version (tolerance 0.0)."""
    import torch
    from repro_torch.core import predictors
    from repro_torch.kernels.level_histogram import ops as lh
    every = {name: FIT_SAMPLE for name in LEVEL_KERNELS}
    with Recorder(("level_histogram",) + LEVEL_KERNELS, every=every) as rec:
        m, _ = predictors._fit_predict("rf", xtr, ytr, xtr[:1], cfg,
                                       seed=cfg.seed * 100, device=dev)
    same_forest("predict rf: fold 0 fitted again", m, model)
    for args, kw in rec.calls["level_split"]:
        got = lh.level_split(*args, **kw)
        torch.cuda.synchronize()
        compare("level_split", got, lh.level_split_plain(*args, **kw), 0.0)
    for args, kw in rec.calls["level_route"]:
        got = routed(lh.level_route, args, kw)
        torch.cuda.synchronize()
        compare("level_route", got, routed(lh.level_route_plain, args, kw),
                0.0)
    for args, kw in rec.calls["level_histogram"]:
        got = lh.level_histogram(*args, **kw)
        torch.cuda.synchronize()
        compare("level_histogram", got,
                lh.level_histogram_plain(*args, **kw), 0.0)
    (xbt, node, *_), kw = rec.calls["level_split"][-1]
    log(f"predict rf: fold 0 fitted again, forest equal; its "
        f"{len(rec.calls['level_split'])} level_split and level_route calls "
        f"(the last: {node.shape[0]} trees x {kw['n_nodes']} nodes, "
        f"{xbt.shape[0]} features, {xbt.shape[1]} rows) and its "
        f"{len(rec.calls['level_histogram'])} leaf-means call equal to their "
        "plain versions (tolerance 0.0)")


def predict_phase(card, dev):
    """The Stage-0 prediction framework on the cli phase's run (its index,
    query log, oracle labels and the Stage-0 features of its 2,000
    queries): ``cross_val_predict`` at the reference's defaults (10 folds,
    64 trees; QR depth 5 at τ 0.5, RF depth 6, LR l2 1.0) for each method
    on the response-time target ``t_bmw``, counted from 0 on the card, with
    its Table 2 report; fold 0 of each method fitted again on the CPU from
    the same rows (QR and RF forests and predictions bit-equal to the
    card's, LR within LR_TOL); the first CLI_CROSS queries served through
    ``HybridServer`` and ``CascadePipeline`` (with the LTR model) and
    through systems built from the equivalent one-shard specs (``topk``,
    ``final`` and latency equal; kernels 1-3 counted from 0), and
    ``rerank_loop`` over the pipeline's Stage-1 candidates (its ``final``
    equal to the batched one)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import features as F
    from repro_torch.core import gbrt, linreg, predictors, random_forest
    from repro_torch.ltr.cascade import rerank_loop
    from repro_torch.serving.pipeline import CascadePipeline
    from repro_torch.serving.server import HybridServer
    from repro_torch.serving.spec import (CascadeSpec, DeploySpec, IndexSpec,
                                          Stage2Spec)
    from repro_torch.serving.system import (build_system, routing_spec,
                                            scheduler_config)
    t0 = time.perf_counter()
    g, labels, ql = card.system, card.labels, card.ql
    x = F.extract(g.term_stats, g.df, torch.as_tensor(ql.terms, device=dev),
                  torch.as_tensor(ql.mask, device=dev)).cpu().numpy()
    rows = np.flatnonzero(labels.keep)
    x, y = x[rows], labels.t_bmw[rows]
    check(x.shape[1] == F.N_FEATURES and np.isfinite(x).all(),
          "predict: Stage-0 features invalid")
    predict = {"qr": gbrt.predict, "rf": random_forest.predict,
               "lr": linreg.predict}
    print("system," + ",".join(REPORT_COLUMNS), flush=True)
    for method in PREDICT_METHODS:
        cfg = predictors.PredictorConfig(method=method, tau=0.5)
        kernels.reset_launches()
        t = time.perf_counter()
        cv = predictors.cross_val_predict(x, y, cfg, device=dev)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t
        launches = {name: kernels.LAUNCHES[name] for name in FIT_KERNELS}
        check(cv.pred.shape == y.shape and np.isfinite(cv.pred).all()
              and len(cv.models) == cfg.n_folds,
              f"predict {method}: cross-validated predictions invalid")
        # (level_histogram, boost_update, level_split, level_route): QR's
        # leaves are quantiles, RF's means of one level_histogram a fit
        want = {"qr": (False, True, True, True),
                "rf": (True, False, True, True),
                "lr": (False, False, False, False)}[method]
        for name, launched in zip(FIT_KERNELS, want):
            check((launches[name] > 0) == launched,
                  f"predict {method}: {launches[name]} {name} launches")
        if method == "rf":
            # all the trees of a fit in one launch of each a level
            levels = cfg.n_folds * cv.models[0].params.depth
            check(launches["level_split"] == launches["level_route"] == levels
                  and launches["level_histogram"] == cfg.n_folds,
                  f"predict rf: {launches} for {cfg.n_folds} fits of depth "
                  f"{cv.models[0].params.depth}")
        report = predictors.regression_report(y, cv.pred,
                                              tail_quantile=PREDICT_TAIL)
        print(method.upper() + ","
              + ",".join(f"{report[c]:.3f}" for c in REPORT_COLUMNS),
              flush=True)

        # fold 0 again on the CPU, from the same rows
        fold = np.random.RandomState(cfg.seed).randint(0, cfg.n_folds,
                                                       size=len(y))
        te = fold == 0
        target = np.log1p(np.maximum(y, 0))
        t = time.perf_counter()
        m_cpu, p_cpu = predictors._fit_predict(
            method, x[~te], target[~te], x[te], cfg, seed=cfg.seed * 100,
            device="cpu")
        t_cpu = time.perf_counter() - t
        m_card = cv.models[0]
        p_card = predict[method](
            m_card, torch.from_numpy(x[te]).to(dev)).cpu().numpy()
        check(np.array_equal(np.maximum(np.expm1(p_card), 0), cv.pred[te]),
              f"predict {method}: fold 0's predictions changed")
        if method == "lr":
            err = float(np.max(np.abs(p_card - p_cpu)
                               / np.maximum(1.0, np.abs(p_cpu))))
            check(err <= LR_TOL, f"predict lr: fold 0 card vs CPU {err:.3g}"
                  f" > {LR_TOL} of max(1, |prediction|)")
            same = f"within {err:.3g} of max(1, |prediction|)"
        else:
            same_forest(f"predict {method} fold 0", m_card, m_cpu)
            check(np.array_equal(p_card, p_cpu),
                  f"predict {method}: fold 0's predictions differ")
            if method == "rf":
                rf_level_calls(x[~te], target[~te], cfg, m_card, dev)
            same = "forest and predictions bit-equal"
        log(f"predict {method}: 10 card fits and predictions {t_card:.2f} s,"
            f" launches {launches}; CPU fold 0 {t_cpu:.2f} s, {same} "
            f"({int(te.sum())} held-out queries)")

    # the shims and the per-query Stage-2 loop, on the card
    cfg = scheduler_config(card.fitted.routing)
    s2 = card.fitted.stage2
    sub = slice(0, CLI_CROSS)
    terms, mask, topics = ql.terms[sub], ql.mask[sub], ql.topic[sub]
    kw = dict(cost=g.cost, device=dev)
    t = time.perf_counter()
    kernels.reset_launches()
    pipe = CascadePipeline(g.index, g.models, cfg, corpus=card.corpus,
                           ltr=g.ltr, k_serve=s2.k_serve, t_final=s2.t_final,
                           **kw)
    a = pipe.serve(terms, mask, topics)
    server = HybridServer(g.index, g.models, cfg, k_serve=s2.k_serve, **kw)
    h = server.serve(terms, mask)
    torch.cuda.synchronize()
    launches = {name: kernels.LAUNCHES[name] for name in CASCADE_KERNELS}
    for name in CASCADE_KERNELS:
        check(launches[name] > 0, f"shims: kernel {name} never launched")
    one = CascadeSpec(
        index=IndexSpec(block_size=g.index.block_size),
        routing=routing_spec(cfg),
        stage2=Stage2Spec(enabled=True, k_serve=s2.k_serve,
                          t_final=s2.t_final),
        deploy=DeploySpec(n_shards=1, replicas=2, rebalance_every=0),
        name="one_shard")
    b = build_system(one, g.index, corpus=card.corpus, models=g.models,
                     ltr=g.ltr, **kw).serve(terms, mask, topics)
    same_batch("shims: CascadePipeline vs SearchSystem", a, b)
    stage1 = dataclasses.replace(
        one, stage2=Stage2Spec(enabled=False, k_serve=s2.k_serve))
    c = build_system(stage1, g.index, models=g.models, **kw).serve(terms,
                                                                   mask)
    check(np.array_equal(h.topk, c.topk)
          and np.array_equal(h.latency, c.latency),
          "shims: HybridServer vs SearchSystem: topk or latency differs")
    t_shims = time.perf_counter() - t
    # the per-query loop over the pipeline's Stage-1 candidates, each
    # query's Stage-0 k as Stage-2 took it (clipped to k_serve and to the
    # budget); queries whose Stage-2 was skipped serve their Stage-1 order
    t = time.perf_counter()
    used = a.candidates_used
    rr = np.flatnonzero(used > 0)
    loop = rerank_loop(g.index, card.corpus, ql, rr, a.topk[rr], used[rr],
                       g.ltr, t_final=s2.t_final)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t
    check(np.array_equal(loop.final, a.final[rr])
          and np.array_equal(loop.candidates_used, used[rr]),
          "rerank_loop: final differs from the batched Stage-2")
    log(f"shims: first {CLI_CROSS} queries through CascadePipeline (LTR) "
        f"and HybridServer equal to the one-shard SearchSystems (topk, "
        f"final, latency; p99 {a.stats['p99']:.3f}, jass {a.stats['jass']} "
        f"/ bmw {a.stats['bmw']}), {t_shims:.2f} s, launches {launches}; "
        f"rerank_loop over {len(rr)} queries equal to the batched final, "
        f"{t_loop:.2f} s")
    log(f"predict: phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# online serving: arrivals, micro-batching, admission
# ---------------------------------------------------------------------------

def microbatch_parity(on, system, terms, mask, topics, n):
    """The first ``n`` served queries of the online run ``on``, each served
    alone (Q = 1) on ``system``: ``topk`` must equal the online row's, and
    ``final`` too where the row was served at FULL
    (``benchmarks/bench_online.py:128-149``)."""
    import numpy as np
    from repro_torch.serving.online import FULL, SHED
    served = np.flatnonzero(on.mode != SHED)
    ok_topk = ok_final = True
    for qid in served[:n]:
        r1 = system.serve(terms[qid:qid + 1], mask[qid:qid + 1],
                          topics[qid:qid + 1])
        ok_topk &= bool(np.array_equal(r1.topk[0], on.topk[qid]))
        if int(on.mode[qid]) == FULL:
            ok_final &= bool(np.array_equal(r1.final[0], on.final[qid]))
    return {"checked": int(min(len(served), n)), "identical_topk": ok_topk,
            "identical_final": ok_final}


def online_figures(payload):
    """The figures of a BENCH_online payload (``bench_online.run_online``'s
    or ``online_flow``'s)."""
    return {k: payload[k] for k in ONLINE_FIGURES}


def bench_build(device, preset, q_batch, n_docs, seed, max_batch):
    """The fitted system the online, cache and fault benches share
    (``benchmarks/bench_online.py:40-66``, ``bench_faults.py:48-76``): a
    corpus of ``n_docs`` (vocab ``n_docs // 2``, at least 1,024), ``preset``
    with ``max_batch``, ``q_batch`` queries, fitted with ``seed`` on
    ``device``.  Returns (corpus, the spec with the fit's thresholds frozen
    and adaptation off, the query log, the fitted system)."""
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.index.corpus import (CorpusParams, build_corpus,
                                          build_queries)
    from repro_torch.serving.system import build_system
    corpus = build_corpus(CorpusParams(n_docs=n_docs,
                                       vocab=max(n_docs // 2, 1024),
                                       avg_doclen=96, zipf_a=1.05, seed=seed))
    base = get_preset(preset)
    base = dataclasses.replace(
        base, online=dataclasses.replace(base.online, max_batch=max_batch))
    ql = build_queries(corpus, q_batch, stop_k=base.index.stop_k,
                       seed=seed + 4)
    fit_sys = build_system(base, corpus, device=device)
    fit_sys.fit(ql, None, seed=seed)
    base = dataclasses.replace(
        base, routing=dataclasses.replace(
            base.routing, t_k=fit_sys._base_cfg.t_k,
            t_time=fit_sys._base_cfg.t_time, calibrate=False,
            adapt_every=0))
    return corpus, base, ql, fit_sys


def online_flow(device, q_batch=384, n_docs=4096, seed=7,
                loads=(0.5, 0.8, 0.95), arrivals=("poisson", "bursty"),
                max_batch=16):
    """The BENCH_online flow of ``benchmarks/bench_online.py:36-187`` with
    the port on ``device``: ``paper_200ms`` fitted from ``q_batch``
    queries with ``seed`` and frozen (thresholds fixed, no adaptation),
    capacity from ``estimate_capacity``; per arrival process and load, the
    online front door against the no-admission ``max_batch`` 1 baseline on
    one trace; then micro-batch parity over 64 served queries.  Returns
    ``online_figures``."""
    from repro_torch.serving.online import estimate_capacity
    from repro_torch.serving.spec import TrafficSpec
    from repro_torch.serving.system import build_system

    corpus, base, ql, fit_sys = bench_build(device, "paper_200ms", q_batch,
                                            n_docs, seed, max_batch)
    index, models, ltr = fit_sys.index, fit_sys.models, fit_sys.ltr
    cost = fit_sys.cost

    def system(**online_kw):
        spec = dataclasses.replace(
            base, online=dataclasses.replace(base.online, **online_kw))
        return build_system(spec, index, corpus=corpus, models=models,
                            ltr=ltr, cost=cost, device=device)

    capacity = estimate_capacity(system(), ql.terms, ql.mask, ql.topic)
    budget_r = None
    rows = []
    for arrival in arrivals:
        for load in loads:
            traffic = TrafficSpec(arrival=arrival, qps=load * capacity,
                                  seed=seed + 1)
            s_on = system().serve_online(ql.terms, ql.mask, ql.topic,
                                         traffic=traffic).stats
            s_off = system(admission=False, max_batch=1,
                           batch_deadline_us=0.0).serve_online(
                ql.terms, ql.mask, ql.topic, traffic=traffic).stats
            budget_r = s_on["response_budget"]

            def tail(st, key):
                return st["response"][key] if "response" in st else None

            rows.append({
                "arrival": arrival, "load": load,
                "qps": float(load * capacity),
                "online": {
                    "over_budget": s_on["over_budget"],
                    "served": s_on["served"], "shed": s_on["shed"],
                    "modes": s_on["modes"],
                    "p99.99": tail(s_on, "p99.99"), "max": tail(s_on, "max"),
                    "mean_batch": (s_on["batch"]["mean_size"]
                                   if "batch" in s_on else None),
                },
                "baseline": {
                    "over_budget": s_off["over_budget"],
                    "served": s_off["served"],
                    "p99.99": tail(s_off, "p99.99"),
                    "max": tail(s_off, "max"),
                },
            })
    on = system().serve_online(
        ql.terms, ql.mask, ql.topic,
        traffic=TrafficSpec(arrival="poisson", qps=0.8 * capacity,
                            seed=seed + 1))
    parity = microbatch_parity(on, system(), ql.terms, ql.mask, ql.topic, 64)
    certified = [r for r in rows if r["load"] <= 0.8 + 1e-9
                 and r["arrival"] in ("poisson", "bursty")]
    return {"capacity_qps": float(capacity),
            "response_budget": float(budget_r),
            "worst_case_bound": float(fit_sys.worst_case_us()),
            "guarantee_holds": all(r["online"]["over_budget"] == 0
                                   for r in rows),
            "regression_demonstrated": bool(certified) and all(
                r["baseline"]["over_budget"] >= 1 for r in certified),
            "rows": rows, "parity": parity}


def check_response_accounting(label, on, online):
    """Every served row's timing as the loop defines it, bit for bit:
    ``wait == start - arrival``, ``completion == start + dispatch_us +
    service``, ``response == completion - arrival``; and ``response``
    against ``wait + dispatch_us + service``, the same sum grouped the
    other way, within 1e-12 of it (they may round apart); batches at most
    ``max_batch`` wide."""
    import numpy as np
    from repro_torch.serving.online import SHED
    d = online.dispatch_us
    for qid, bid, arrival, start, w, svc, done, m in on.event_log:
        if m == SHED:
            continue
        check(w == start - arrival and done == start + d + svc
              and on.response[qid] == done - arrival
              and on.wait[qid] == w and on.service[qid] == svc,
              f"{label}: query {qid}'s timing differs from the loop's")
    sv = np.flatnonzero(on.mode != SHED)
    err = float(np.max(np.abs(on.response[sv]
                              - (on.wait[sv] + d + on.service[sv]))
                       / on.response[sv]))
    check(err <= 1e-12, f"{label}: response - (wait + dispatch + service) "
          f"{err:.3g} of the response")
    check(on.stats["batch"]["max_size"] <= online.max_batch,
          f"{label}: a batch wider than max_batch")
    return err


def same_online(label, a, b):
    """Card (a) against CPU (b) results of one online run."""
    import numpy as np
    check(a.event_log == b.event_log, f"{label}: event logs differ")
    for key in ("response", "mode", "batch_of", "topk", "final",
                "coverage"):
        u, v = getattr(a, key), getattr(b, key)
        check((u is None and v is None) or np.array_equal(u, v),
              f"{label}: {key} differs")
    check(a.stats == b.stats, f"{label}: stats differ")


def online_line(label, on, wall, launches=None):
    """One log line of an online run: modes, response tail, batches, the
    host wall per simulated batch and per query."""
    s = on.stats
    r = s.get("response", {})
    n_batch = s["batches"]
    log(f"{label}: modes {s['modes']}, over budget {s['over_budget']} of "
        f"{s['served']} served (response budget {s['response_budget']}); "
        f"response p50/p99/p99.99/max {r.get('p50', 0):.3f}/"
        f"{r.get('p99', 0):.3f}/{r.get('p99.99', 0):.3f}/"
        f"{r.get('max', 0):.3f}; {n_batch} batches, mean size "
        f"{s['batch']['mean_size'] if n_batch else 0:.2f}; wall {wall:.2f} s"
        f" ({1e3 * wall / max(n_batch, 1):.2f} ms a batch, "
        f"{1e3 * wall / s['n_queries']:.3f} ms a query)"
        + (f"; launches {launches}" if launches is not None else ""))


def timed_online(system, terms, mask, topics, traffic, online=None):
    """``serve_online`` and its host wall, ending on a synchronized
    device."""
    import torch
    t = time.perf_counter()
    on = system.serve_online(terms, mask, topics, traffic=traffic,
                             online=online)
    if system.device.type == "cuda":
        torch.cuda.synchronize()
    return on, time.perf_counter() - t


def online_phase(dev, fitted_shard, fit_ql, card, cpu):
    """The online serving loop on the card.  Every system below that is
    not built from a new spec is a ``fresh_probe`` (fresh serving state,
    the index's device structures shared).

    Part 1, on the fit's 196,608-doc shard (``fitted_shard``: the fit
    phase's card system as fitted, before serving adapted it; ``max_batch``
    32, deadline 5, admission and degrade on, ``adapt_every`` 1): (a)
    capacity from ``estimate_capacity`` on a fresh probe; (b) a poisson and
    a bursty trace of the fit log's first ONLINE_QUERIES queries at
    ONLINE_LOAD x capacity, each on a fresh probe with the launch counts
    set to 0: 0 over budget, the loop's timing
    (``check_response_accounting``), kernels 1-3 launched.

    Part 2, on the cli phase's index, query log and models (the card's, and
    the CPU system's bit-equal ones for the CPU side): (c) the baseline (no
    admission, ``max_batch`` 1, deadline 0) over a bursty trace of the
    first ONLINE_CROSS queries at ONLINE_LOAD x capacity must go over the
    response budget and shed nothing; (d) a poisson trace of the first
    ONLINE_CPU queries on the card and on the CPU: event log,
    ``response``, ``mode``, ``batch_of``, ``topk``, ``final`` and stats
    equal; (e) micro-batch parity over the first ONLINE_PARITY served
    queries of a poisson run of the first ONLINE_CROSS with adaptation
    off, each served alone on a fresh card system; (f) the
    4 x 3 partial-coverage deployment (PARTIAL_*): a batch of 32 with
    ``shard_cap`` cycling 1-4 on the card and the CPU (``topk``, ``final``,
    latency, coverage, the stats' coverage and faults equal), then a bursty
    trace of the first PARTIAL_CROSS queries at PARTIAL_OVERLOAD x capacity
    under a response budget picked from the printed shard bounds (the full
    bound plus the bounds' spread): the partial rung fires, 0 over budget,
    coverage below 1, card = CPU."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.serving.online import (SHED, bucket_size,
                                            estimate_capacity, fresh_probe)
    from repro_torch.serving.spec import TrafficSpec
    t0 = time.perf_counter()

    # ---- part 1: the fit's shard
    spec = fitted_shard.cascade_spec
    n_docs = fitted_shard.index.n_docs
    sub = slice(0, ONLINE_QUERIES)
    terms, mask, topics = fit_ql.terms[sub], fit_ql.mask[sub], fit_ql.topic[sub]
    t = time.perf_counter()
    capacity = estimate_capacity(fresh_probe(fitted_shard), terms, mask,
                                 topics)
    torch.cuda.synchronize()
    log(f"online: {n_docs}-doc shard; capacity {capacity!r} queries a 1000 "
        f"units (estimate_capacity, {time.perf_counter() - t:.2f} s); "
        f"worst-case bound {fitted_shard.worst_case_us():.4f}, response "
        f"budget {spec.online.response_budget_us or 2.0 * spec.routing.budget}")
    for arrival in ("poisson", "bursty"):
        system = fresh_probe(fitted_shard)
        kernels.reset_launches()
        traffic = TrafficSpec(arrival=arrival, qps=ONLINE_LOAD * capacity,
                              seed=ONLINE_SEED)
        on, wall = timed_online(system, terms, mask, topics, traffic)
        launches = launched()
        label = f"online {arrival} {len(on.mode)} queries"
        online_line(label, on, wall, launches)
        for name in CASCADE_KERNELS:
            check(launches[name] > 0, f"{label}: kernel {name} never "
                  "launched")
        check(on.stats["over_budget"] == 0, f"{label}: over budget")
        check_response_accounting(label, on, spec.online)
        served = on.mode != SHED
        check(np.isfinite(on.response[served]).all()
              and (on.topk[served] >= 0).all()
              and (on.topk[served] < n_docs).all(),
              f"{label}: served rows invalid")

    # ---- part 2: the cli phase's index, models and query log
    g, ql, fitted = card.system, card.ql, card.fitted

    sub = slice(0, ONLINE_CROSS)
    terms, mask, topics = ql.terms[sub], ql.mask[sub], ql.topic[sub]
    base, base_cpu = (cli_build(card, cpu, d, fitted) for d in (dev, "cpu"))
    cap_cli = estimate_capacity(fresh_probe(base), ql.terms, ql.mask,
                                ql.topic)
    log(f"online cli: {g.index.n_docs}-doc index, capacity {cap_cli!r}")
    bursty = TrafficSpec(arrival="bursty", qps=ONLINE_LOAD * cap_cli,
                         seed=ONLINE_SEED)
    on, wall = timed_online(
        fresh_probe(base), terms, mask, topics, bursty,
        online=dataclasses.replace(fitted.online, admission=False,
                                   max_batch=1, batch_deadline_us=0.0))
    online_line("online baseline (no admission, max_batch 1)", on, wall)
    check(on.stats["over_budget"] >= 1 and on.stats["shed"] == 0,
          "online baseline: it must answer every query and go over budget")
    poisson = TrafficSpec(arrival="poisson", qps=ONLINE_LOAD * cap_cli,
                          seed=ONLINE_SEED)
    cpu_rows = slice(0, ONLINE_CPU)
    a, wall = timed_online(base, terms[cpu_rows], mask[cpu_rows],
                           topics[cpu_rows], poisson)
    online_line("online cli poisson on the card", a, wall)
    b, wall_cpu = timed_online(base_cpu, terms[cpu_rows], mask[cpu_rows],
                               topics[cpu_rows], poisson)
    same_online("online card vs CPU", a, b)
    check(a.stats["over_budget"] == 0, "online cli poisson: over budget")
    check_response_accounting("online cli poisson", a, fitted.online)
    sizes = np.bincount(a.batch_of[a.batch_of >= 0])
    widths = sorted({bucket_size(int(n), fitted.online.max_batch)
                     for n in sizes})
    log(f"online card vs CPU: event log ({len(a.event_log)} rows), response,"
        f" mode, batch_of, topk, final and stats equal; CPU {wall_cpu:.2f} s;"
        f" batch sizes {sorted(set(sizes.tolist()))}, padded widths {widths}")

    frozen = cli_build(card, cpu, dev, dataclasses.replace(
        fitted, routing=dataclasses.replace(fitted.routing, adapt_every=0)))
    on, _ = timed_online(fresh_probe(frozen), terms, mask, topics, poisson)
    t = time.perf_counter()
    parity = microbatch_parity(on, frozen, terms, mask, topics,
                               ONLINE_PARITY)
    check(parity["identical_topk"] and parity["identical_final"],
          f"online micro-batch parity: {parity}")
    log(f"online micro-batch parity (adapt_every 0): {parity}, "
        f"{time.perf_counter() - t:.2f} s")

    spec4 = dataclasses.replace(
        fitted,
        deploy=dataclasses.replace(fitted.deploy, **PARTIAL_DEPLOY),
        routing=dataclasses.replace(fitted.routing, **PARTIAL_ROUTING))
    pair = [cli_build(card, cpu, d, spec4, PARTIAL_GATHER_US)
            for d in (dev, "cpu")]
    bounds = [pair[0].sched.cfg.worst_case_us(pair[0].cost, m)
              for m in range(1, PARTIAL_DEPLOY["n_shards"] + 1)]
    full = pair[0].worst_case_us()
    budget_r = full + (bounds[-1] - bounds[0])
    cap = (np.arange(BATCH) % PARTIAL_DEPLOY["n_shards"]) + 1
    x, y = (fresh_probe(s).serve(ql.terms[:BATCH], ql.mask[:BATCH],
                                 ql.topic[:BATCH], shard_cap=cap)
            for s in pair)
    same_batch("online shard_cap", x, y)
    check(np.array_equal(x.coverage, y.coverage)
          and x.stats["coverage"] == y.stats["coverage"]
          and x.stats["faults"] == y.stats["faults"],
          "online shard_cap: coverage or fault counters differ")
    log(f"online shard_cap 1-4: card = CPU (coverage {x.stats['coverage']}, "
        f"faults {x.stats['faults']}); shard bounds {bounds}, full bound "
        f"{full!r}: response budget {budget_r!r}")
    cap4 = estimate_capacity(fresh_probe(pair[0]), ql.terms, ql.mask,
                             ql.topic)
    sub = slice(0, PARTIAL_CROSS)
    overload = TrafficSpec(arrival="bursty", qps=PARTIAL_OVERLOAD * cap4,
                           seed=ONLINE_SEED)
    online4 = dataclasses.replace(spec4.online, response_budget_us=budget_r)
    a, wall = timed_online(pair[0], ql.terms[sub], ql.mask[sub],
                           ql.topic[sub], overload, online4)
    online_line(f"online partial (4 x 3, capacity {cap4:.3f})", a, wall)
    b, _ = timed_online(pair[1], ql.terms[sub], ql.mask[sub], ql.topic[sub],
                        overload, online4)
    same_online("online partial card vs CPU", a, b)
    check(pair[0].stats()["faults"] == pair[1].stats()["faults"],
          "online partial: fault counters differ")
    check(a.stats["modes"]["partial"] > 0 and a.stats["over_budget"] == 0
          and a.stats["coverage"]["min"] < 1.0,
          f"online partial: the rung must fire inside the budget "
          f"({a.stats['modes']}, coverage {a.stats['coverage']})")
    log(f"online partial: card = CPU; coverage {a.stats['coverage']}; "
        f"phase {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the result cache and fault injection
# ---------------------------------------------------------------------------

def cache_figures(payload):
    """The figures of a BENCH_cache payload (``bench_cache.run_cache``'s or
    ``cache_flow``'s)."""
    return {k: payload[k] for k in CACHE_FIGURES}


def cache_cell(res):
    """One online run's BENCH_cache cell (``bench_cache._cell``)."""
    s = res.stats
    out = {
        "served": s["served"], "shed": s["shed"],
        "over_budget": s["over_budget"],
        "modes": s["modes"],
        "p50": s["response"]["p50"] if "response" in s else None,
        "p99.99": s["response"]["p99.99"] if "response" in s else None,
        "achieved_qps": s.get("achieved_qps"),
    }
    if "cache" in s:
        c = s["cache"]
        out["hit_ratio"] = c["hit_ratio"]
        out["l1_hits"] = c["l1"]["hits"] if c.get("l1") else 0
        out["front_door_hits"] = c["front_door_hits"]
        out["hit_ewma"] = c.get("hit_ewma")
    return out


def certified_qps(cells):
    """Highest offered QPS at which every query was served FULL with no
    budget violation and no shed (``bench_cache._certified``)."""
    ok = [c["qps"] for c in cells
          if c["over_budget"] == 0 and c["shed"] == 0
          and c["modes"]["full"] == c["served"]]
    return float(max(ok)) if ok else 0.0


def cache_flow(device, q_batch=384, n_docs=4096, seed=7,
               skews=(0.0, 0.8, 1.2), sweep_load=0.8,
               loads_off=(0.8, 1.0, 1.2, 1.5, 2.0),
               loads_on=(1.2, 1.5, 2.0, 2.5, 3.0), max_batch=16):
    """The BENCH_cache flow of ``benchmarks/bench_cache.py:62-206`` with
    the port on ``device``: ``bench_build``'s ``paper_200ms`` system; hit
    parity (cold and warm cache-on against cache-off, offline), the inert
    zero-capacity spec (offline, and a bursty online trace), the skew sweep
    at ``sweep_load`` x the cache-off capacity, and the overload grid at
    the hottest skew, from which the certified QPS of each side.  Returns
    ``cache_figures``."""
    import numpy as np
    from repro_torch.serving.online import estimate_capacity
    from repro_torch.serving.spec import CacheSpec, TrafficSpec
    from repro_torch.serving.system import build_system

    corpus, base, ql, fit_sys = bench_build(device, "paper_200ms", q_batch,
                                            n_docs, seed, max_batch)
    index, models, ltr = fit_sys.index, fit_sys.models, fit_sys.ltr
    cost = fit_sys.cost
    cache_spec = CacheSpec(enabled=True)

    def system(cache=None):
        spec = base if cache is None else dataclasses.replace(base,
                                                              cache=cache)
        return build_system(spec, index, corpus=corpus, models=models,
                            ltr=ltr, cost=cost, device=device)

    def serve(sys_):
        return sys_.serve(ql.terms, ql.mask, ql.topic)

    def online(sys_, traffic):
        return sys_.serve_online(ql.terms, ql.mask, ql.topic,
                                 traffic=traffic)

    off_sys = system()
    res_off = serve(off_sys)
    b_off = res_off.stats["budget"]
    on_sys = system(cache_spec)
    cold = serve(on_sys)
    warm = serve(on_sys)
    parity = {
        "no_trims_in_reference": bool(b_off["stage2_trimmed"] == 0
                                      and b_off["stage2_skipped"] == 0),
        "cold_topk_identical": bool(np.array_equal(cold.topk, res_off.topk)),
        "cold_final_identical": bool(np.array_equal(cold.final,
                                                    res_off.final)),
        "warm_topk_identical": bool(np.array_equal(warm.topk, res_off.topk)),
        "warm_final_identical": bool(np.array_equal(warm.final,
                                                    res_off.final)),
        "warm_all_l1_hits": bool(on_sys.cache.counters["l1_hits"]
                                 == q_batch),
        "p50_off": res_off.stats["p50"], "p50_warm": warm.stats["p50"],
        "hit_speedup_p50": float(res_off.stats["p50"]
                                 / max(warm.stats["p50"], 1e-9)),
        "worst_case_off": float(off_sys.worst_case_us()),
        "worst_case_on": float(on_sys.worst_case_us()),
    }

    inert_spec = CacheSpec(enabled=True, l1_entries=0, l2_entries=0)
    sys_a, sys_b = system(), system(inert_spec)
    ra, rb = serve(sys_a), serve(sys_b)
    traffic_i = TrafficSpec(arrival="bursty", qps=0.8 * 500.0, skew=0.8,
                            seed=seed + 1)
    oa = online(system(), traffic_i)
    ob = online(system(inert_spec), traffic_i)
    inert = {
        "cache_absent": bool(sys_b.cache is None),
        "offline_topk_identical": bool(np.array_equal(ra.topk, rb.topk)),
        "offline_final_identical": bool(np.array_equal(ra.final, rb.final)),
        "offline_latency_identical": bool(np.array_equal(ra.latency,
                                                         rb.latency)),
        "online_event_log_identical": bool(oa.event_log == ob.event_log),
    }

    capacity_off = estimate_capacity(system(), ql.terms, ql.mask, ql.topic)
    sweep = []
    for skew in skews:
        traffic = TrafficSpec(arrival="poisson",
                              qps=sweep_load * capacity_off, skew=skew,
                              seed=seed + 1)
        r_on = online(system(cache_spec), traffic)
        r_off = online(system(), traffic)
        sweep.append({"skew": skew, "load": sweep_load,
                      "qps": float(sweep_load * capacity_off),
                      "on": cache_cell(r_on), "off": cache_cell(r_off)})

    skew_hot = float(max(skews))
    grid = {"on": [], "off": []}
    for name, spec_c, loads in (("off", None, loads_off),
                                ("on", cache_spec, loads_on)):
        for load in loads:
            traffic = TrafficSpec(arrival="poisson",
                                  qps=load * capacity_off, skew=skew_hot,
                                  seed=seed + 1)
            r = online(system(spec_c), traffic)
            grid[name].append({"load": load,
                               "qps": float(load * capacity_off),
                               **cache_cell(r)})

    certified_off = certified_qps(grid["off"])
    certified_on = certified_qps(grid["on"])
    hot_on = [r["on"] for r in sweep if r["skew"] == skew_hot]
    hit_ratio_hot = hot_on[0]["hit_ratio"] if hot_on else 0.0
    enforced = ([r["on"] for r in sweep] + [r["off"] for r in sweep]
                + grid["on"] + grid["off"])
    gates = {
        "hits_bit_identical": (parity["no_trims_in_reference"]
                               and parity["cold_topk_identical"]
                               and parity["cold_final_identical"]
                               and parity["warm_topk_identical"]
                               and parity["warm_final_identical"]
                               and parity["warm_all_l1_hits"]),
        "inert_bit_identical": all(inert.values()),
        "guarantee_holds": all(r["over_budget"] == 0 for r in enforced),
        "capacity_speedup": (certified_off > 0
                             and certified_on
                             >= 1.2 * certified_off - 1e-9),
        "hits_nonvacuous": hit_ratio_hot >= 0.2,
    }
    return {"parity": parity, "capacity_off_qps": float(capacity_off),
            "inert": inert, "sweep": sweep, "grid": grid,
            "certified_qps": {"off": certified_off, "on": certified_on,
                              "speedup": (certified_on
                                          / max(certified_off, 1e-9))},
            "hit_ratio_at_hot_skew": float(hit_ratio_hot), "gates": gates}


def fault_figures(payload):
    """The figures of a BENCH_faults payload (``bench_faults.run_faults``'s
    or ``fault_flow``'s)."""
    return {k: payload[k] for k in FAULT_FIGURES}


def coverage_floor_ok(res, injector, replicas, ns):
    """Every served query's coverage at least the fraction of partitions
    the schedule left reachable at its batch's dispatch
    (``bench_faults._coverage_floor_ok``).  Returns (ok, the largest
    shortfall seen)."""
    worst = 0.0
    for qid, bid, _, start, _, _, _, _ in res.event_log:
        if bid < 0:
            continue
        floor = injector.surviving(replicas, start) / ns
        cov = 1.0 if res.coverage is None else float(res.coverage[qid])
        worst = max(worst, floor - cov)
        if cov < floor - 1e-9:
            return False, worst
    return True, worst


def fault_flow(device, q_batch=256, n_docs=4096, seed=7, loads=(0.5, 0.8),
               max_batch=16, gather_us=4.0):
    """The BENCH_faults flow of ``benchmarks/bench_faults.py:94-212`` with
    the port on ``device``: ``bench_build``'s ``fault_tolerant`` system (4
    partitions x 3 replicas) with ``gather_us`` of merge a shard; per load,
    a poisson trace under every named scenario (``fault_scenario``, sized
    to the trace's span): over-budget count, coverage floor, counters and
    the FULL rows' final lists against the fault-free run; then the empty
    schedule's replay and the failover-disabled build offline.  Returns
    ``fault_figures``."""
    import numpy as np
    from repro_torch.serving.faults import (SCENARIOS, FaultInjector,
                                            fault_scenario)
    from repro_torch.serving.online import FULL, estimate_capacity
    from repro_torch.serving.spec import FaultSpec, TrafficSpec
    from repro_torch.serving.system import build_system

    corpus, base, ql, fit_sys = bench_build(device, "fault_tolerant",
                                            q_batch, n_docs, seed, max_batch)
    cost = dataclasses.replace(fit_sys.cost, gather_per_shard_us=gather_us)
    index, models, ltr = fit_sys.index, fit_sys.models, fit_sys.ltr
    ns, replicas = base.deploy.n_shards, base.deploy.replicas

    def system(fault=None, failover=True):
        spec = base
        if not failover:
            spec = dataclasses.replace(spec, routing=dataclasses.replace(
                spec.routing, failover_timeout=0.0, max_retries=0))
        if fault is not None:
            spec = dataclasses.replace(spec, fault=fault)
        return build_system(spec.validate(), index, corpus=corpus,
                            models=models, ltr=ltr, cost=cost, device=device)

    capacity = estimate_capacity(system(), ql.terms, ql.mask, ql.topic)
    budget_r = None
    rows = []
    none_runs = {}
    floors_hold = True
    for load in loads:
        qps = load * capacity
        horizon = 1000.0 * q_batch / qps
        traffic = TrafficSpec(arrival="poisson", qps=qps, seed=seed + 1)
        for scenario in SCENARIOS:
            fspec = fault_scenario(scenario, n_partitions=ns,
                                   replicas=replicas, horizon=horizon,
                                   seed=seed)
            res = system(fault=fspec).serve_online(ql.terms, ql.mask,
                                                   ql.topic, traffic=traffic)
            s = res.stats
            budget_r = s["response_budget"]
            if scenario == "none":
                none_runs[load] = res
            ok_floor, _ = coverage_floor_ok(res, FaultInjector(fspec, ns),
                                            replicas, ns)
            floors_hold &= ok_floor
            ctrl = none_runs[load]
            both = np.flatnonzero((res.mode == FULL) & (ctrl.mode == FULL))
            same = (float(np.mean(np.all(
                res.final[both] == ctrl.final[both], axis=1)))
                if len(both) and res.final is not None else None)
            cov = s.get("coverage", {})
            rows.append({
                "load": load, "qps": float(qps), "scenario": scenario,
                "over_budget": s["over_budget"],
                "served": s["served"], "shed": s["shed"],
                "modes": s["modes"],
                "p99.99": (s["response"]["p99.99"]
                           if "response" in s else None),
                "max": s["response"]["max"] if "response" in s else None,
                "coverage": {"min": cov.get("min", 1.0),
                             "mean": cov.get("mean", 1.0),
                             "degraded": cov.get("degraded", 0)},
                "coverage_floor_ok": ok_floor,
                "faults": s.get("faults"),
                "full_final_match_vs_none": same,
            })

    load0 = loads[-1]
    traffic = TrafficSpec(arrival="poisson", qps=load0 * capacity,
                          seed=seed + 1)
    a = none_runs[load0]
    b = system(fault=FaultSpec()).serve_online(ql.terms, ql.mask, ql.topic,
                                               traffic=traffic)
    replay_identical = (
        a.event_log == b.event_log
        and bool(np.array_equal(a.topk, b.topk))
        and (a.final is None or bool(np.array_equal(a.final, b.final))))
    r_on = system().serve(ql.terms, ql.mask, ql.topic)
    r_off = system(failover=False).serve(ql.terms, ql.mask, ql.topic)
    offline_identical = (
        bool(np.array_equal(r_on.topk, r_off.topk))
        and bool(np.array_equal(r_on.latency, r_off.latency))
        and (r_on.final is None
             or bool(np.array_equal(r_on.final, r_off.final))))
    return {
        "rows": rows,
        "capacity_qps": float(capacity),
        "response_budget": float(budget_r),
        "worst_case_bound": float(system().worst_case_us()),
        "guarantee_holds": all(r["over_budget"] == 0 for r in rows),
        "coverage_certified": floors_hold,
        "inert_replay_identical": replay_identical,
        "inert_offline_identical": offline_identical,
        "faults_demonstrated": any(
            r["faults"] and (r["faults"]["retries"] > 0
                             or r["faults"]["lost_partitions"] > 0
                             or r["faults"]["transient"] > 0)
            for r in rows if r["scenario"] != "none"),
    }


def ingest_figures(payload):
    """The figures of a BENCH_ingest payload (``bench_ingest.run_ingest``'s
    or ``ingest_flow``'s)."""
    return {k: payload[k] for k in INGEST_FIGURES}


def index_identical(a, b):
    """Every field of two ``InvertedIndex``es equal, arrays bit for bit
    (``bench_ingest._index_identical``)."""
    import numpy as np
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if not np.array_equal(np.asarray(va), np.asarray(vb)):
                return False
        elif va != vb:
            return False
    return True


def ingest_cell(res):
    """One online run's BENCH_ingest cell (``bench_ingest._cell``)."""
    s = res.stats
    out = {
        "served": s["served"], "shed": s["shed"],
        "over_budget": s["over_budget"],
        "modes": s["modes"],
        "p50": s["response"]["p50"] if "response" in s else None,
        "p99.99": s["response"]["p99.99"] if "response" in s else None,
        "achieved_qps": s.get("achieved_qps"),
    }
    if "ingest" in s:
        i = s["ingest"]
        out["ingest"] = {
            "feed_batches_applied": i["feed_batches_applied"],
            "feed_batches_due": i["feed_batches_due"],
            "feed_throttled": i.get("feed_throttled", 0),
            "docs_ingested": i["docs_ingested"],
            "merges": i["merges"],
            "merge_deferred": i.get("merge_deferred", 0),
            "merges_forced": i.get("merges_forced", 0),
            "fill": i["fill"],
        }
    return out


def ingest_flow(device, q_batch=384, n_docs=4096, seed=7,
                loads=(0.5, 0.8, 0.95), feed_docs=128, max_batch=16,
                offline_only=False):
    """The BENCH_ingest flow of ``benchmarks/bench_ingest.py:74-212`` with
    the port on ``device``: ``bench_build``'s ``paper_200ms`` system with
    ``live_ingest``'s delta; post-merge bit parity (serve, ingest a feed,
    serve, merge, serve) against a system built from scratch over the
    extended collection, the worst case with and without the delta, the
    inert spec (offline, and a bursty online trace), and the
    serve-while-ingesting sweep at each load x the live capacity, ingest on
    and off.  Returns ``ingest_figures``; with ``offline_only`` only the
    parity and accounting figures (the CPU's side of the card-vs-CPU
    check)."""
    import numpy as np
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.index.builder import build_index
    from repro_torch.index.corpus import (extend_corpus, slice_feed,
                                          synthesize_feed_docs)
    from repro_torch.serving.online import estimate_capacity
    from repro_torch.serving.spec import IngestSpec, TrafficSpec
    from repro_torch.serving.system import build_system

    corpus, base, ql, fit_sys = bench_build(device, "paper_200ms", q_batch,
                                            n_docs, seed, max_batch)
    index, models, ltr = fit_sys.index, fit_sys.models, fit_sys.ltr
    cost = fit_sys.cost
    ing = get_preset("live_ingest").ingest

    def system(ingest=None, idx=None, corp=None):
        spec = base if ingest is None else dataclasses.replace(base,
                                                               ingest=ingest)
        return build_system(spec, idx if idx is not None else index,
                            corpus=corp if corp is not None else corpus,
                            models=models, ltr=ltr, cost=cost, device=device)

    def online(sys_, traffic):
        return sys_.serve_online(ql.terms, ql.mask, ql.topic,
                                 traffic=traffic)

    # post-merge bit parity against the from-scratch rebuild
    on_sys = system(ing)
    feed = synthesize_feed_docs(corpus, feed_docs, seed=seed + 3)
    took = on_sys.add_documents(feed)
    mid = on_sys.serve(ql.terms, ql.mask, ql.topic)
    live_hits = int((np.asarray(mid.topk) >= index.n_docs).sum())
    merged = on_sys.merge()
    after = on_sys.serve(ql.terms, ql.mask, ql.topic)
    ext = extend_corpus(corpus, slice_feed(feed, 0, took))
    oracle_idx = build_index(ext, stop_k=base.index.stop_k)
    ref = system(ing, idx=oracle_idx, corp=ext).serve(ql.terms, ql.mask,
                                                      ql.topic)
    parity = {
        "docs_ingested": int(took), "docs_merged": int(merged),
        "live_candidate_slots": live_hits,
        "index_identical": index_identical(on_sys.index, oracle_idx),
        "topk_identical": bool(np.array_equal(after.topk, ref.topk)),
        "final_identical": bool(np.array_equal(after.final, ref.final)),
        "latency_identical": bool(np.array_equal(after.latency,
                                                 ref.latency)),
    }

    # worst-case accounting of the live delta scan
    wc_off = float(system().worst_case_us())
    wc_on = float(system(ing).worst_case_us())
    delta_term = float(cost.delta_time(ing.delta_postings))
    accounting = {
        "worst_case_off": wc_off, "worst_case_on": wc_on,
        "delta_scan_term": delta_term,
        "budget": float(base.routing.budget),
        "covers_delta": bool(wc_on >= wc_off + delta_term - 1e-9),
    }
    if offline_only:
        return {"parity": parity, "accounting": accounting}

    # inert mode: enabled=False == no ingest node, bit for bit
    inert_spec = IngestSpec(enabled=False, delta_docs=ing.delta_docs,
                            feed_qps=ing.feed_qps)
    sys_a, sys_b = system(), system(inert_spec)
    ra = sys_a.serve(ql.terms, ql.mask, ql.topic)
    rb = sys_b.serve(ql.terms, ql.mask, ql.topic)
    capacity = estimate_capacity(system(), ql.terms, ql.mask, ql.topic)
    traffic_i = TrafficSpec(arrival="bursty", qps=0.8 * capacity,
                            seed=seed + 1)
    oa = online(system(), traffic_i)
    ob = online(system(inert_spec), traffic_i)
    inert = {
        "delta_absent": bool(sys_b.delta is None),
        "offline_topk_identical": bool(np.array_equal(ra.topk, rb.topk)),
        "offline_final_identical": bool(np.array_equal(ra.final, rb.final)),
        "offline_latency_identical": bool(np.array_equal(ra.latency,
                                                         rb.latency)),
        "online_event_log_identical": bool(oa.event_log == ob.event_log),
        "worst_case_identical": bool(sys_a.worst_case_us()
                                     == sys_b.worst_case_us()),
    }

    # serve-while-ingesting sweep, at loads of the live capacity
    capacity_live = estimate_capacity(system(ing), ql.terms, ql.mask,
                                      ql.topic)
    sweep = []
    for load in loads:
        traffic = TrafficSpec(arrival="bursty", qps=load * capacity_live,
                              seed=seed + 1)
        r_on = online(system(ing), traffic)
        r_off = online(system(), traffic)
        sweep.append({"load": load, "qps": float(load * capacity_live),
                      "on": ingest_cell(r_on), "off": ingest_cell(r_off)})

    enforced = [r[s] for r in sweep for s in ("on", "off")]
    applied = sum(r["on"]["ingest"]["feed_batches_applied"] for r in sweep)
    ingested = sum(r["on"]["ingest"]["docs_ingested"] for r in sweep)
    gates = {
        "post_merge_bit_parity": (parity["index_identical"]
                                  and parity["topk_identical"]
                                  and parity["final_identical"]
                                  and parity["latency_identical"]),
        "worst_case_covers_delta": accounting["covers_delta"],
        "inert_bit_identical": all(inert.values()),
        "zero_violations": all(c["over_budget"] == 0 for c in enforced),
        "ingest_nonvacuous": (applied > 0 and ingested > 0
                              and parity["live_candidate_slots"] > 0),
    }
    return {"parity": parity,
            "capacity_qps": {"sealed": float(capacity),
                             "live": float(capacity_live)},
            "accounting": accounting, "inert": inert, "sweep": sweep,
            "gates": gates}


def _obs_latency_hist(key):
    name = key.split("{", 1)[0]
    return any(s in name for s in OBS_LATENCY_HISTS)


def _obs_bad_counter(key):
    name, _, rest = key.partition("{")
    if name in OBS_BAD_COUNTERS:
        return True
    return any(name == section and any(s in rest for s in subs)
               for section, subs in OBS_BAD_SECTION_KEYS.items())


def diff_snapshots(base, cur, tol=None):
    """Regressions of snapshot ``cur`` against ``base`` (empty: none), as
    ``benchmarks/obs_diff.diff_snapshots`` finds them: latency quantiles
    that grew past a relative plus an absolute slack, bad-event counters
    that went from zero to any or grew past the slack, a cache hit ratio
    that fell, a metric of ``base`` missing from ``cur``.  Each finding is
    ``{"metric", "field", "base", "cur", "limit", "rule"}``."""
    t = dict(OBS_TOL, **(tol or {}))
    out = []

    def flag(metric, field, b, c, limit, rule):
        out.append({"metric": metric, "field": field, "base": float(b),
                    "cur": float(c), "limit": float(limit), "rule": rule})

    c_h = cur.get("histograms", {})
    for key, bh in sorted(base.get("histograms", {}).items()):
        if not _obs_latency_hist(key) or not bh.get("count"):
            continue
        ch = c_h.get(key)
        if ch is None:
            flag(key, "present", 1, 0, 1, "missing")
            continue
        for q in OBS_QUANTILES:
            if q not in bh or q not in ch:
                continue
            limit = bh[q] * (1.0 + t["latency_rel"]) + t["latency_abs_us"]
            if ch[q] > limit:
                flag(key, q, bh[q], ch[q], limit, "latency")
    b_c, c_c = base.get("counters", {}), cur.get("counters", {})
    for key in sorted(set(b_c) | set(c_c)):
        if not _obs_bad_counter(key):
            continue
        bv, cv = b_c.get(key, 0), c_c.get(key)
        if cv is None:
            if bv > 0:
                flag(key, "present", 1, 0, 1, "missing")
            continue
        if bv == 0:
            if cv > 0:
                flag(key, "total", bv, cv, 0, "zero_to_nonzero")
            continue
        limit = bv * (1.0 + t["count_rel"]) + t["count_abs"]
        if cv > limit:
            flag(key, "total", bv, cv, limit, "count")
    b_g, c_g = base.get("gauges", {}), cur.get("gauges", {})
    if "cache_hit_ratio" in b_g:
        cv = c_g.get("cache_hit_ratio")
        limit = b_g["cache_hit_ratio"] - t["hit_ratio_drop"]
        if cv is None:
            flag("cache_hit_ratio", "present", 1, 0, 1, "missing")
        elif cv < limit:
            flag("cache_hit_ratio", "value", b_g["cache_hit_ratio"], cv,
                 limit, "hit_ratio")
    return out


def inject_regression(snap):
    """A tampered copy of ``snap`` that a sound gate must flag: doubled
    service-latency quantiles and five invented budget violations."""
    import copy
    bad = copy.deepcopy(snap)
    h = bad.get("histograms", {}).get("service_latency_us")
    if h:
        for q in OBS_QUANTILES:
            if q in h:
                h[q] *= 2.0
    c = bad.setdefault("counters", {})
    c["budget_violations"] = c.get("budget_violations", 0) + 5
    return bad


def format_findings(findings):
    lines = [f"{len(findings)} regression(s):"]
    for f in findings:
        lines.append(f"  {f['metric']} {f['field']}: {f['base']:g} -> "
                     f"{f['cur']:g} (limit {f['limit']:g}, "
                     f"rule={f['rule']})")
    return "\n".join(lines)


def obs_figures(payload):
    """The figures of a BENCH_obs payload (``obs_diff.run_gate``'s or
    ``obs_flow``'s)."""
    return {k: payload[k] for k in OBS_FIGURES}


def obs_flow(device, q_batch=256, n_docs=4096, seed=7, max_batch=8,
             load=0.7, baseline=OBS_BASELINE):
    """The observability gate of ``benchmarks/obs_diff.py:197-276`` with
    the port on ``device``: ``bench_build``'s ``paper_200ms`` system with
    telemetry on, capacity from ``estimate_capacity`` on the fit's system,
    one offline batch and one bursty trace at ``load`` x capacity through
    the instrumented system, then the gates: the snapshot diffs clean
    against itself, an injected regression is flagged by the latency and
    zero-to-nonzero rules, and the snapshot has no regression against the
    committed ``baseline`` (read, never written).  Returns
    ``obs_figures``."""
    from repro_torch.serving.online import estimate_capacity
    from repro_torch.serving.spec import TelemetrySpec, TrafficSpec
    from repro_torch.serving.system import build_system

    corpus, base, ql, fit_sys = bench_build(device, "paper_200ms", q_batch,
                                            n_docs, seed, max_batch)
    spec = dataclasses.replace(base, telemetry=TelemetrySpec(enabled=True))
    system = build_system(spec, fit_sys.index, corpus=corpus,
                          models=fit_sys.models, ltr=fit_sys.ltr,
                          cost=fit_sys.cost, device=device)
    capacity = estimate_capacity(fit_sys, ql.terms, ql.mask, ql.topic)
    system.serve(ql.terms, ql.mask, ql.topic)
    traffic = TrafficSpec(arrival="bursty", qps=load * capacity,
                          seed=seed + 1)
    system.serve_online(ql.terms, ql.mask, ql.topic, traffic=traffic)
    snap = system.snapshot()
    injected = diff_snapshots(snap, inject_regression(snap))
    present = Path(baseline).exists()
    findings = []
    if present:
        want = json.loads(Path(baseline).read_text())
        findings = diff_snapshots(want.get("snapshot", want), snap)
    return {
        "gates": {
            "self_check_clean": not diff_snapshots(snap, snap),
            "self_check_flags_regression": bool(injected) and {
                "latency", "zero_to_nonzero"} <= {f["rule"]
                                                  for f in injected},
            "baseline_present": present,
            "no_regressions_vs_baseline": not findings,
        },
        "snapshot": {k: v for k, v in snap.items() if k != "traces"},
        "findings": findings,
        "capacity_qps": float(capacity),
        "traces_kept": len(snap["traces"]),
    }


def cli_build(card, cpu, device, spec, gather=None, layouts=None):
    """A system of the cli phase's index and corpus for ``spec`` on
    ``device`` with the card's fit (on the CPU, the CPU system's, which is
    bit-equal); ``gather`` overrides the cost model's merge cost a shard,
    ``layouts`` are the index's shards laid out on the host."""
    from repro_torch.serving.system import build_system
    g = card.system
    src = g if str(device) != "cpu" else cpu
    cost = (src.cost if gather is None else dataclasses.replace(
        src.cost, gather_per_shard_us=gather))
    return build_system(spec, g.index, corpus=card.corpus,
                        models=src.models, ltr=src.ltr, cost=cost,
                        device=device, layouts=layouts)


def launched(names=CASCADE_KERNELS):
    """The launch counts of ``names`` since the last reset."""
    from repro_torch import kernels
    return {name: kernels.LAUNCHES[name] for name in names}


def lru_state(system):
    """A cache's counters, each level's MRU order, bytes and stats."""
    c = system.cache
    return (c.stats(), [None if lru is None else lru.keys_mru()
                        for lru in (c.l1, c.l2)])


def cache_phase(dev, card, cpu):
    """The result cache on the card, on the cli phase's index, query log
    and fit (module docstring, step 12): hit parity, an L2 serve, the peek,
    inert specs, the online loop card = CPU, the BENCH_cache flow and
    ``hybrid_fusion`` with the cache.  Every system of the index is built
    from one host layout of its shard."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.configs.two_tower_retrieval import REDUCED
    from repro_torch.index.postings import shard_layouts
    from repro_torch.models.recsys import TwoTower
    from repro_torch.serving.online import estimate_capacity, fresh_probe
    from repro_torch.serving.spec import CacheSpec, TrafficSpec
    from repro_torch.serving.system import build_system
    t0 = time.perf_counter()
    ql, fitted = card.ql, card.fitted

    def at_fit(name):
        spec = get_preset(name)
        return dataclasses.replace(spec, routing=dataclasses.replace(
            spec.routing, t_k=fitted.routing.t_k,
            t_time=fitted.routing.t_time))

    cached = at_fit("cached")
    layouts = shard_layouts(card.system.index, 1, cached.index.tile_d)
    sub = slice(0, CACHE_CROSS)
    terms, mask, topics = ql.terms[sub], ql.mask[sub], ql.topic[sub]
    n = len(terms)

    # (a) hit parity: cold cache-on = cache-off, warm = L1 hits
    off = cli_build(card, cpu, dev, fitted, layouts=layouts)
    wc_off = off.worst_case_us()
    r_off = off.serve(terms, mask, topics)
    on = cli_build(card, cpu, dev, cached, layouts=layouts)
    hit = on.cost.cache_hit_us
    kernels.reset_launches()
    cold = on.serve(terms, mask, topics)
    cold_launches = launched()
    kernels.reset_launches()
    warm = on.serve(terms, mask, topics)
    torch.cuda.synchronize()
    warm_launches = launched()
    check(np.array_equal(cold.topk, r_off.topk)
          and np.array_equal(cold.final, r_off.final),
          "cache: cold cache-on topk/final differ from cache-off")
    sl_on, sl_off = cold.stage_latency, r_off.stage_latency
    check(np.array_equal(sl_on["stage0"], sl_off["stage0"])
          and np.array_equal(sl_on["stage1"], sl_off["stage1"] + hit)
          and np.array_equal(sl_on["stage2"], sl_off["stage2"])
          and np.array_equal(cold.latency, sl_off["stage0"]
                             + (sl_off["stage1"] + hit) + sl_off["stage2"]),
          "cache: a cold row's latency is not cache-off's plus the probe")
    check(all(v > 0 for v in cold_launches.values()),
          f"cache: the cold serve launched {cold_launches}")
    check(on.cache.counters["l1_hits"] == n
          and np.array_equal(warm.topk, r_off.topk)
          and np.array_equal(warm.final, r_off.final)
          and np.array_equal(warm.latency,
                             np.full(n, on.cost.predict_us) + hit),
          "cache: the warm serve is not all L1 hits equal to cache-off")
    check(all(v == 0 for v in warm_launches.values()),
          f"cache: the warm serve launched {warm_launches}")
    check(on.worst_case_us() == wc_off + hit,
          "cache: the probe is not charged into the worst case")
    log(f"cache (a): {n} queries, cold = cache-off (topk, final; latency "
        f"the probe more, {hit}), launches {cold_launches}; warm: {n} L1 "
        f"hits, bit-identical, each {warm.latency[0]!r}, launches "
        f"{warm_launches}; budget trims cache-off "
        f"{r_off.stats['budget']['stage2_trimmed']}")

    # (b) an L2 serve below k_serve, against the cache-off recompute
    cap = np.full(n, on.k_serve // 2, np.int64)
    kernels.reset_launches()
    l2 = on.serve(terms, mask, topics, stage2_cap=cap)
    torch.cuda.synchronize()
    l2_launches = launched()
    recompute = cli_build(card, cpu, dev, fitted, layouts=layouts).serve(
        terms, mask, topics, stage2_cap=cap)
    b = recompute.stats["budget"]
    check(on.cache.counters["l2_hits"] == n
          and np.array_equal(l2.topk, r_off.topk)
          and b["stage2_trimmed"] == 0 and b["stage2_skipped"] == 0
          and np.array_equal(l2.final, recompute.final),
          "cache: L2 hits differ from the cache-off recompute at the cap")
    check(l2_launches["impact_accumulate_batched"] == 0
          and l2_launches["blockmax_score_batched"] == 0
          and l2_launches["qd_feature_gather_lanes"] > 0,
          f"cache: the L2 serve launched {l2_launches}")
    log(f"cache (b): stage2_cap {int(cap[0])}: {n} L2 hits, final = the "
        f"cache-off recompute, launches {l2_launches}")

    # (c) the peek changes nothing
    before = (lru_state(on), dict(on.sched.stats), on.pool.stats())
    peek = on.cache_peek(terms, mask, topics)
    check(peek.all() and (lru_state(on), dict(on.sched.stats),
                          on.pool.stats()) == before,
          "cache: cache_peek changed the cache, the scheduler or the pool")

    # (d) inert specs
    for label, inert in (("disabled", CacheSpec()),
                         ("zero capacity", CacheSpec(enabled=True,
                                                     l1_entries=0,
                                                     l2_entries=0))):
        sys_i = cli_build(card, cpu, dev,
                          dataclasses.replace(cached, cache=inert),
                          layouts=layouts)
        r = sys_i.serve(terms, mask, topics)
        check(sys_i.cache is None, f"cache: a {label} spec built a cache")
        same_batch(f"cache inert ({label})", r, r_off)
    log("cache (c, d): the peek changed nothing (all hits); disabled and "
        "zero-capacity specs build no cache and equal cache-off")

    # (e) serve_online, Zipf skew 1.2, card = CPU
    cap_on = estimate_capacity(fresh_probe(off), ql.terms, ql.mask,
                               ql.topic)
    traffic = TrafficSpec(arrival="poisson", qps=ONLINE_LOAD * cap_on,
                          seed=ONLINE_SEED, skew=CACHE_SKEW)
    rows = slice(0, CACHE_ONLINE)
    pair = [cli_build(card, cpu, d, cached, layouts=layouts)
            for d in (dev, "cpu")]
    kernels.reset_launches()
    a, wall = timed_online(pair[0], ql.terms[rows], ql.mask[rows],
                           ql.topic[rows], traffic)
    online_line(f"cache online (skew {CACHE_SKEW})", a, wall, launched())
    b, wall_cpu = timed_online(pair[1], ql.terms[rows], ql.mask[rows],
                               ql.topic[rows], traffic)
    same_online("cache online card vs CPU", a, b)
    check(lru_state(pair[0]) == lru_state(pair[1]),
          "cache online: the caches differ on the card and the CPU")
    c = a.stats["cache"]
    check(c["front_door_hits"] > 0 and a.stats["over_budget"] == 0,
          f"cache online: front-door hits {c['front_door_hits']}, over "
          f"budget {a.stats['over_budget']}")
    log(f"cache (e): card = CPU (CPU {wall_cpu:.2f} s); hit ratio "
        f"{c['hit_ratio']:.3f}, front door {c['front_door_hits']}, L2 "
        f"{c['l2_hits']}, EWMA {c['hit_ewma']:.3f}")

    # (f) the BENCH_cache flow at a reduced size
    t = time.perf_counter()
    flow = cache_flow(dev, **CACHE_FLOW)
    for gate, ok in flow["gates"].items():
        check(ok, f"cache flow: gate {gate} fails")
    want = json.loads(CACHE_ARTIFACT.read_text())
    log(f"cache (f): BENCH_cache flow {CACHE_FLOW} in "
        f"{time.perf_counter() - t:.2f} s: gates {flow['gates']}; certified "
        f"QPS {flow['certified_qps']} (results/BENCH_cache.json, "
        f"q_batch {want['config']['q_batch']}: {want['certified_qps']}); "
        f"capacity off {flow['capacity_off_qps']!r} (the file's "
        f"{want['capacity_off_qps']!r}); hit ratio at skew "
        f"{max(CACHE_FLOW['skews'])} {flow['hit_ratio_at_hot_skew']!r} (the "
        f"file's {want['hit_ratio_at_hot_skew']!r})")

    # (g) hybrid_fusion with the cache: L1 replay of the dense rows
    spec_h = dataclasses.replace(at_fit("hybrid_fusion"),
                                 cache=CacheSpec(enabled=True))
    tower = TwoTower.init(REDUCED, spec_h.dense.seed, device="cpu")
    g = card.system
    sys_h = build_system(spec_h, g.index, corpus=card.corpus,
                         models=g.models, ltr=g.ltr, cost=g.cost,
                         tower=tower, device=dev, layouts=layouts)
    kernels.reset_launches()
    cold = sys_h.serve(terms, mask, topics)
    cold_launches = launched(CASCADE_KERNELS + ("dense_topk_tiles",))
    kernels.reset_launches()
    warm = sys_h.serve(terms, mask, topics)
    torch.cuda.synchronize()
    warm_launches = launched(CASCADE_KERNELS + ("dense_topk_tiles",))
    check(cold_launches["dense_topk_tiles"] > 0
          and sys_h.cache.counters["l1_hits"] == n
          and all(v == 0 for v in warm_launches.values()),
          f"cache hybrid_fusion: launches cold {cold_launches}, warm "
          f"{warm_launches}, L1 hits {sys_h.cache.counters['l1_hits']}")
    check(np.array_equal(cold.topk, warm.topk)
          and np.array_equal(cold.final, warm.final)
          and np.array_equal(cold.dense["modality"], warm.dense["modality"]),
          "cache hybrid_fusion: the L1 replay differs from the cold serve")
    log(f"cache (g): hybrid_fusion {cold.stats['dense']}: L1 replay equal "
        f"to the cold serve; launches cold {cold_launches}, warm "
        f"{warm_launches}; phase {time.perf_counter() - t0:.1f} s")


def faults_phase(dev, card, cpu):
    """Fault injection and failover on the card, on the cli phase's index,
    query log and fit (module docstring, step 13): the five named schedules
    online, card = CPU under two of them, the empty schedule, and the
    cache's fault epochs."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.index.postings import shard_layouts
    from repro_torch.serving.faults import (SCENARIOS, FaultInjector,
                                            fault_scenario)
    from repro_torch.serving.online import SHED, estimate_capacity
    from repro_torch.serving.spec import CacheSpec, FaultSpec, TrafficSpec
    t0 = time.perf_counter()
    ql, fitted = card.ql, card.fitted
    preset = get_preset("fault_tolerant")
    spec = dataclasses.replace(preset, routing=dataclasses.replace(
        preset.routing, t_k=fitted.routing.t_k,
        t_time=fitted.routing.t_time))
    ns, replicas = spec.deploy.n_shards, spec.deploy.replicas
    layouts = shard_layouts(card.system.index, ns, spec.index.tile_d)

    def build(device, fault=None, **routing_kw):
        spec_ = dataclasses.replace(spec, routing=dataclasses.replace(
            spec.routing, **routing_kw))
        if fault is not None:
            spec_ = dataclasses.replace(spec_, fault=fault)
        return cli_build(card, cpu, device, spec_.validate(),
                         FAULT_GATHER_US, layouts)

    rows = slice(0, FAULT_QUERIES)
    terms, mask, topics = ql.terms[rows], ql.mask[rows], ql.topic[rows]
    capacity = estimate_capacity(build(dev), terms, mask, topics)
    qps = ONLINE_LOAD * capacity
    horizon = 1000.0 * FAULT_QUERIES / qps
    traffic = TrafficSpec(arrival="poisson", qps=qps, seed=ONLINE_SEED)
    log(f"faults: fault_tolerant {ns} x {replicas} on the "
        f"{card.system.index.n_docs}-doc index, gather {FAULT_GATHER_US}; "
        f"capacity {capacity!r}, trace {FAULT_QUERIES} queries over "
        f"{horizon:.3f} units")

    # (a) each named schedule online on the card
    runs = {}
    for name in SCENARIOS:
        fspec = fault_scenario(name, n_partitions=ns, replicas=replicas,
                               horizon=horizon, seed=ONLINE_SEED)
        system = build(dev, fspec)
        kernels.reset_launches()
        on, wall = timed_online(system, terms, mask, topics, traffic)
        launches = launched()
        runs[name] = (fspec, system, on)
        ok, worst = coverage_floor_ok(on, FaultInjector(fspec, ns),
                                      replicas, ns)
        f = system.stats().get("faults", {})
        label = f"faults {name}"
        online_line(label, on, wall, launches)
        log(f"{label}: counters {f}, coverage {on.stats.get('coverage')}, "
            f"floor shortfall {worst!r}, draws {system.faults.draws}")
        check(on.stats["over_budget"] == 0, f"{label}: over budget")
        check(ok, f"{label}: coverage below the surviving fraction")
        check(all(v > 0 for v in launches.values()),
              f"{label}: launches {launches}")
        implied = {"crash_one": ("retries",),
                   "rolling_restart": ("retries", "probes"),
                   "timeout_storm": ("transient", "retries"),
                   "partition_outage": ("lost_partitions",)}.get(name, ())
        for key in implied:
            check(f.get(key, 0) > 0, f"{label}: no {key}")
    check(min(runs["partition_outage"][2].coverage[
        runs["partition_outage"][2].mode != SHED]) < 1.0,
          "faults partition_outage: no query degraded")

    # (b) card = CPU under the storm and the outage
    t = time.perf_counter()
    for name in ("timeout_storm", "partition_outage"):
        fspec, system, a = runs[name]
        host = build("cpu", fspec)
        b, _ = timed_online(host, terms, mask, topics, traffic)
        same_online(f"faults {name} card vs CPU", a, b)
        sa, sb = system.stats(), host.stats()
        sa.pop("device"), sb.pop("device")
        check(sa == sb and system.faults.draws == host.faults.draws,
              f"faults {name}: stats() or draws differ on the card and the "
              "CPU")
    log(f"faults (b): timeout_storm and partition_outage card = CPU (event "
        f"logs, arrays, stats, stats(), draws "
        f"{runs['timeout_storm'][1].faults.draws}); CPU "
        f"{time.perf_counter() - t:.2f} s")

    # (c) the empty schedule
    again = build(dev, FaultSpec())
    e, _ = timed_online(again, terms, mask, topics, traffic)
    same_online("faults empty schedule replay", runs["none"][2], e)
    x = build(dev).serve(terms, mask, topics)
    y = build(dev, failover_timeout=0.0, max_retries=0).serve(terms, mask,
                                                              topics)
    same_batch("faults armed vs disarmed", x, y)
    check(x.coverage is None and again.faults.draws == 0,
          "faults: the empty schedule took the faulted path")

    # (d) the cache's fault epochs
    q = FAULT_EPOCH_QUERIES
    # routing frozen, as the cached preset freezes it: adaptation would
    # change the routes, and so the keys, between the serves
    sys_c = dataclasses.replace(
        spec, cache=CacheSpec(enabled=True),
        fault=FaultSpec(outages=((0, 0.0, 50.0),)),
        routing=dataclasses.replace(spec.routing, adapt_every=0))
    sys_c = cli_build(card, cpu, dev, sys_c, FAULT_GATHER_US, layouts)
    tq, mq, pq = ql.terms[:q], ql.mask[:q], ql.topic[:q]
    ctr = sys_c.cache.counters
    r_h = sys_c.serve(tq, mq, pq, now=60.0)
    fills = sys_c.cache.l1.stats["fills"]
    r_f = sys_c.serve(tq, mq, pq, now=10.0)
    check(fills == q and (r_f.coverage < 1.0).all()
          and ctr["l1_hits"] == 0
          and sys_c.cache.l1.stats["epoch_misses"] == q
          and ctr["skipped_partial"] == q,
          f"faults epoch: inside the outage {ctr}")
    sys_c.serve(tq, mq, pq, now=10.0)
    r_h2 = sys_c.serve(tq, mq, pq, now=70.0)
    check(ctr["l1_hits"] == 0 and ctr["skipped_partial"] == 2 * q
          and np.array_equal(r_h2.topk, r_h.topk),
          f"faults epoch: an outage-window result hit after healing {ctr}")
    r_h3 = sys_c.serve(tq, mq, pq, now=80.0)
    torch.cuda.synchronize()
    check(ctr["l1_hits"] == q and np.array_equal(r_h3.topk, r_h.topk),
          f"faults epoch: the healed epoch does not hit {ctr}")
    log(f"faults (c, d): the empty schedule replays the fault-free run and "
        f"armed = disarmed offline; the cache's epochs: {ctr}; phase "
        f"{time.perf_counter() - t0:.1f} s")


def obs_phase(dev, card, cpu):
    """Telemetry on the card (module docstring, step 14): the observability
    gate's flow, then on the cli phase's index and fit a telemetry-on
    system against its CPU twin (snapshots equal as dicts and as JSON
    bytes) and against a telemetry-off system (equal results, event logs
    and kernel launches a batch), and ``hybrid_fusion`` on and off."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.configs.two_tower_retrieval import REDUCED
    from repro_torch.index.postings import shard_layouts
    from repro_torch.models.recsys import TwoTower
    from repro_torch.serving.online import estimate_capacity, fresh_probe
    from repro_torch.serving.spec import TelemetrySpec, TrafficSpec
    from repro_torch.serving.system import build_system
    from repro_torch.serving.telemetry.export import render_json
    t0 = time.perf_counter()

    # (a) the gate's flow at its defaults
    flow = obs_flow(dev)
    for gate, ok in flow["gates"].items():
        check(ok, f"obs flow: gate {gate} fails")
    snap = flow["snapshot"]
    svc = snap["histograms"]["service_latency_us"]
    n_metrics = sum(len(snap[k]) for k in ("counters", "gauges",
                                            "histograms"))
    log(f"obs (a): gate flow in {time.perf_counter() - t0:.2f} s: gates "
        f"{flow['gates']}; capacity {flow['capacity_qps']!r} qps, traces "
        f"kept {flow['traces_kept']}, {n_metrics} metrics; service "
        f"p50/p99/p99.99 {svc['p50']!r}/{svc['p99']!r}/"
        f"{svc['p99.99']!r} of {svc['count']}, findings against "
        f"{OBS_BASELINE.relative_to(ROOT)}: {len(flow['findings'])}")

    # (b) the cli index: telemetry on (card, CPU twin) and off (card)
    t = time.perf_counter()
    ql, fitted = card.ql, card.fitted
    spec_on = dataclasses.replace(fitted, telemetry=TelemetrySpec(
        enabled=True, snapshot_every_us=OBS_EVERY))
    layouts = shard_layouts(card.system.index, 1, fitted.index.tile_d)
    off = cli_build(card, cpu, dev, fitted, layouts=layouts)
    on, twin = [cli_build(card, cpu, d, spec_on, layouts=layouts)
                for d in (dev, "cpu")]
    sub = slice(0, OBS_CROSS)
    terms, mask, topics = ql.terms[sub], ql.mask[sub], ql.topic[sub]
    res, counts = {}, {}
    for label, system in (("off", off), ("on", on)):
        kernels.reset_launches()
        res[label] = system.serve(terms, mask, topics)
        torch.cuda.synchronize()
        counts[label] = launched()
    same_batch("obs offline on vs off", res["on"], res["off"])
    same_batch("obs offline card vs CPU", res["on"],
               twin.serve(terms, mask, topics))
    check(counts["on"] == counts["off"]
          and all(v > 0 for v in counts["on"].values()),
          f"obs offline: launches on {counts['on']}, off {counts['off']}")
    capacity = estimate_capacity(fresh_probe(off), ql.terms, ql.mask,
                                 ql.topic)
    traffic = TrafficSpec(arrival="bursty", qps=ONLINE_LOAD * capacity,
                          seed=ONLINE_SEED)
    rows = slice(0, OBS_ONLINE)
    runs = {}
    for label, system in (("off", off), ("on", on)):
        kernels.reset_launches()
        runs[label], wall = timed_online(system, ql.terms[rows],
                                         ql.mask[rows], ql.topic[rows],
                                         traffic)
        counts[label] = launched()
        online_line(f"obs online ({label})", runs[label], wall,
                    counts[label])
    a, b = runs["on"], runs["off"]
    check(a.event_log == b.event_log
          and {k: v for k, v in a.stats.items() if k != "telemetry"}
          == b.stats, "obs online: telemetry on and off differ")
    check(counts["on"] == counts["off"],
          f"obs online: launches on {counts['on']}, off {counts['off']}")
    same_online("obs online card vs CPU", a, timed_online(
        twin, ql.terms[rows], ql.mask[rows], ql.topic[rows], traffic)[0])
    s_card, s_cpu = on.snapshot(), twin.snapshot()
    periodic = on.telemetry.snapshots
    check(s_card == s_cpu and render_json(s_card) == render_json(s_cpu),
          "obs: the card's snapshot differs from the CPU's")
    check(len(periodic) > 0 and periodic == twin.telemetry.snapshots
          and [render_json(x) for x in periodic]
          == [render_json(x) for x in twin.telemetry.snapshots],
          "obs: the periodic snapshots differ on the card and the CPU")
    check(on.render_snapshot("prom") == twin.render_snapshot("prom"),
          "obs: the Prometheus text differs on the card and the CPU")
    c = s_card["counters"]
    log(f"obs (b): {OBS_CROSS} queries offline + a bursty trace of "
        f"{OBS_ONLINE} at {ONLINE_LOAD} x {capacity:.2f} qps: card = CPU "
        f"(snapshot of {len(render_json(s_card))} JSON bytes, "
        f"{len(periodic)} periodic snapshots, {len(s_card['traces'])} "
        f"traces, queries_served {c['queries_served']!r}, batches_served "
        f"{c['batches_served']!r}); on = off (results, event log, launches "
        f"{counts['on']}); {time.perf_counter() - t:.2f} s")

    # (c) hybrid_fusion: kernel 6's launches a batch, on and off
    t = time.perf_counter()
    spec_h = get_preset("hybrid_fusion")
    spec_h = dataclasses.replace(spec_h, routing=dataclasses.replace(
        spec_h.routing, t_k=fitted.routing.t_k,
        t_time=fitted.routing.t_time))
    tower = TwoTower.init(REDUCED, spec_h.dense.seed, device="cpu")
    g = card.system
    names = CASCADE_KERNELS + ("dense_topk_tiles",)
    for label, spec in (("off", spec_h), ("on", dataclasses.replace(
            spec_h, telemetry=TelemetrySpec(enabled=True)))):
        system = build_system(spec, g.index, corpus=card.corpus,
                              models=g.models, ltr=g.ltr, cost=g.cost,
                              tower=tower, device=dev, layouts=layouts)
        kernels.reset_launches()
        res[label] = system.serve(terms, mask, topics)
        torch.cuda.synchronize()
        counts[label] = launched(names)
    same_batch("obs hybrid_fusion on vs off", res["on"], res["off"],
               dense=True)
    check(counts["on"] == counts["off"]
          and counts["on"]["dense_topk_tiles"] > 0,
          f"obs hybrid_fusion: launches on {counts['on']}, off "
          f"{counts['off']}")
    log(f"obs (c): hybrid_fusion {res['on'].stats['dense']}: on = off, "
        f"launches {counts['on']}; {time.perf_counter() - t:.2f} s; phase "
        f"{time.perf_counter() - t0:.1f} s")


def delta_call_times(name, kern, args, kw):
    """A delta-segment call's wrapper ms (CUDA events), device ms
    (profiler) and bound ms (``work_of``), as a dict for the log."""
    nbytes, ops, rate = work_of(name, args, kw)
    return {"name": name, "ms": round(cuda_ms(lambda: kern(*args, **kw),
                                               REPS), 4),
            "device_ms": device_ms(lambda: kern(*args, **kw), REPS),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / rate) * 1e3}


def ingest_phase(dev, shard, card, cpu):
    """Live ingest on the card (module docstring, step 15): (a) the
    ``live_ingest`` delta on the fit's 196,608-doc shard, fed and served
    batch by batch, card = CPU on the checked batches; (b) the
    BENCH_ingest flow on the card, its offline figures on the CPU too;
    (c) ``hybrid_fusion`` with the delta on the cli phase's index.  ``shard`` holds the fit's index,
    corpus, host layouts, fitted spec, query log and both devices'
    models."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.configs.two_tower_retrieval import REDUCED
    from repro_torch.dense import M_LEX
    from repro_torch.index.corpus import slice_feed, synthesize_feed_docs
    from repro_torch.index.postings import shard_layouts
    from repro_torch.models.recsys import TwoTower
    from repro_torch.serving.spec import IngestSpec
    from repro_torch.serving.system import build_system
    t0 = time.perf_counter()
    index, corpus, ql = shard["index"], shard["corpus"], shard["ql"]
    fitted = shard["spec"]
    live = get_preset("live_ingest")
    check(live.stage0 == fitted.stage0 and live.stage2 == fitted.stage2
          and live.routing.budget == fitted.routing.budget,
          "ingest: live_ingest's fit would differ from paper_200ms's")
    spec = dataclasses.replace(live, routing=dataclasses.replace(
        live.routing, t_k=fitted.routing.t_k, t_time=fitted.routing.t_time))

    # (a) the delta on the fit's shard, card and CPU fed alike
    def build(device, models, ingest=None):
        spec_ = spec if ingest is None else dataclasses.replace(
            spec, ingest=ingest)
        return build_system(spec_, index, corpus=corpus, models=models[0],
                            ltr=models[1], device=device,
                            layouts=shard["layouts"])
    on = build(dev, shard["card_models"])
    host = build("cpu", shard["cpu_models"])
    off = build("cpu", shard["cpu_models"], IngestSpec())
    term = on.cost.delta_time(spec.ingest.delta_postings)
    check(abs(on.worst_case_us() - (off.worst_case_us() + term)) <= 1e-9
          and host.worst_case_us() == on.worst_case_us(),
          f"ingest: worst case {on.worst_case_us()!r}, off "
          f"{off.worst_case_us()!r} + delta_time {term!r}")
    feed = synthesize_feed_docs(corpus, INGEST_FEED, seed=INGEST_SEED)
    fb = INGEST_FEED_BATCH
    took, walls_feed, walls_serve = [], [], []
    delta_launches = {"impact_accumulate_batched": 0,
                      "blockmax_score_batched": 0}
    live_slots, t_cpu, rec = 0, 0.0, None
    for b in range(INGEST_FEED // fb):
        part = slice_feed(feed, b * fb, (b + 1) * fb)
        t = time.perf_counter()
        took.append(on.add_documents(part))
        torch.cuda.synchronize()
        walls_feed.append(time.perf_counter() - t)
        check(host.add_documents(part) == took[-1],
              "ingest: the CPU delta took other docs")
        rows = (np.arange(BATCH) + b * BATCH) % len(ql.terms)
        jass0, bmw0 = on.sched.stats["jass"], on.sched.stats["bmw"]
        last = b == INGEST_FEED // fb - 1
        kernels.reset_launches()
        # the last batch's calls are recorded, to hold the delta segment's
        # against the plain versions
        with (Recorder(names=BATCHED) if last
              else contextlib.nullcontext()) as r:
            t = time.perf_counter()
            res = on.serve(ql.terms[rows], ql.mask[rows], ql.topic[rows])
            torch.cuda.synchronize()
            walls_serve.append(time.perf_counter() - t)
        rec = r if last else rec
        got = launched()
        n_j = on.sched.stats["jass"] - jass0
        n_b = on.sched.stats["bmw"] - bmw0
        want = {"impact_accumulate_batched": 2 * (n_j > 0),
                "blockmax_score_batched": 4 * (n_b > 0),
                "qd_feature_gather_lanes": 1}
        check(got == want, f"ingest batch {b}: launches {got}, want {want} "
              f"(jass {n_j}, bmw {n_b}: for the delta segment kernel 1 once "
              "more a SAAT route, kernel 2 twice more a BMW route)")
        delta_launches["impact_accumulate_batched"] += int(n_j > 0)
        delta_launches["blockmax_score_batched"] += 2 * int(n_b > 0)
        live_slots += int((res.topk >= index.n_docs).sum())
        check(np.isfinite(res.latency).all()
              and (res.topk < index.n_docs + on.delta.n_docs).all()
              and float(res.latency.max()) <= on.worst_case_us() + 1e-9,
              f"ingest batch {b}: ids, latency or bound invalid")
        if b in INGEST_CHECKED:
            t = time.perf_counter()
            same_batch(f"ingest batch {b} card vs CPU", res,
                       host.serve(ql.terms[rows], ql.mask[rows],
                                  ql.topic[rows]))
            t_cpu += time.perf_counter() - t
    check(sum(took) > 0 and live_slots > 0,
          f"ingest: took {took}, live candidate slots {live_slots}")
    check(on.stats()["ingest"] == host.stats()["ingest"],
          "ingest: the card's and the CPU's ingest stats differ")
    # the last batch's delta-segment calls (the mirror at the delta's lane
    # capacity) against the plain versions
    cap = on.delta.shard_spec.tile_cap
    mods = kernel_modules()
    n_delta, timed = 0, []
    for name, calls in rec.calls.items():
        kern = getattr(mods[name], name)
        plain = getattr(mods[name], name.replace("_batched", "_plain"))
        for args, kw in calls:
            if args[0].shape[1] == cap:
                n_delta += 1
                compare(f"{name} (delta segment)", kern(*args, **kw),
                        plain(*args, **kw), 0.0)
                timed.append(delta_call_times(name, kern, args, kw))
    check(n_delta == got["impact_accumulate_batched"] // 2
          + got["blockmax_score_batched"] // 2,
          f"ingest: {n_delta} delta-segment calls recorded, launches {got}")
    i = on.stats()["ingest"]
    log(f"ingest (a): live_ingest's delta on the {index.n_docs}-doc shard: "
        f"fed {INGEST_FEED} docs in batches of {fb}, took {took} (delta "
        f"{i['delta_docs']} docs, {i['delta_postings']} postings, fill "
        f"{i['fill']:.3f}); {len(took)} batches of {BATCH} served, launches "
        f"on the delta segment {delta_launches}, live candidate slots "
        f"{live_slots}; worst case {on.worst_case_us()!r} = off "
        f"{off.worst_case_us()!r} + delta_time {term!r}; batches "
        f"{INGEST_CHECKED} card = CPU (CPU {t_cpu:.2f} s); the last batch's "
        f"{n_delta} delta-segment calls equal the plain versions ({timed}); "
        "walls s "
        "feed " + " ".join(f"{w:.3f}" for w in walls_feed) + ", serve "
        + " ".join(f"{w:.4f}" for w in walls_serve)
        + f"; part {time.perf_counter() - t0:.1f} s")
    del on, host, off
    t1 = time.perf_counter()

    # (b) the BENCH_ingest flow, card and CPU
    t = time.perf_counter()
    flow = ingest_flow(dev, **INGEST_FLOW)
    t_card = time.perf_counter() - t
    t = time.perf_counter()
    flow_cpu = ingest_flow("cpu", **INGEST_FLOW, offline_only=True)
    t_host = time.perf_counter() - t
    check({k: flow[k] for k in flow_cpu} == flow_cpu,
          "ingest flow: the card's parity or accounting differs from the "
          "CPU's")
    for gate, ok in flow["gates"].items():
        check(ok, f"ingest flow: gate {gate} fails")
    wc = flow["accounting"]["worst_case_on"]
    check(abs(wc - WORST_CASE_ON) <= 1e-9,
          f"ingest flow: worst case on {wc!r}, not {WORST_CASE_ON}")
    want = json.loads(INGEST_ARTIFACT.read_text())
    log(f"ingest (b): BENCH_ingest flow {INGEST_FLOW}: card {t_card:.2f} s, "
        f"CPU (parity and accounting) {t_host:.2f} s, equal; gates "
        f"{flow['gates']}; parity "
        f"{flow['parity']}; accounting {flow['accounting']} (the file's "
        f"worst_case_on {want['accounting']['worst_case_on']!r}); capacity "
        f"{flow['capacity_qps']} (the file's, at "
        f"{want['config']['q_batch']} queries and "
        f"{want['config']['n_docs']} docs: {want['capacity_qps']}); sweep on "
        f"{[r['on'] for r in flow['sweep']]}; part "
        f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()

    # (c) hybrid_fusion with the delta on the cli phase's index
    g = card.system
    spec_h = get_preset("hybrid_fusion")
    spec_h = dataclasses.replace(
        spec_h, ingest=live.ingest, routing=dataclasses.replace(
            spec_h.routing, t_k=card.fitted.routing.t_k,
            t_time=card.fitted.routing.t_time))
    tower = TwoTower.init(REDUCED, spec_h.dense.seed, device="cpu")
    layouts = shard_layouts(g.index, 1, spec_h.index.tile_d)
    pair = [build_system(spec_h, g.index, corpus=card.corpus,
                         models=src.models, ltr=src.ltr, cost=src.cost,
                         tower=tower, device=d, layouts=layouts)
            for src, d in ((g, dev), (cpu, "cpu"))]
    feed = synthesize_feed_docs(card.corpus, INGEST_DENSE_FEED,
                                seed=INGEST_SEED)
    took_h = [s_.add_documents(feed) for s_ in pair]
    check(took_h[0] == took_h[1] > 0, f"ingest hybrid_fusion: took {took_h}")
    rows = slice(0, INGEST_DENSE)
    terms, mask, topics = card.ql.terms[rows], card.ql.mask[rows], \
        card.ql.topic[rows]
    kernels.reset_launches()
    with Recorder(names=("dense_topk_tiles",)) as rec6:
        a = pair[0].serve(terms, mask, topics)
        torch.cuda.synchronize()
    l6 = kernels.LAUNCHES["dense_topk_tiles"]
    b = pair[1].serve(terms, mask, topics)
    same_batch("ingest hybrid_fusion card vs CPU", a, b, dense=True)
    n_dense = int((a.dense["modality"] != M_LEX).sum())
    n_live = g.index.n_docs + pair[0].delta.n_docs
    delta_calls = [(args, kw) for args, kw in rec6.calls["dense_topk_tiles"]
                   if args[2] == args[1].shape[0]
                   == spec_h.ingest.delta_docs]
    check(n_dense > 0 and l6 == 2 and len(delta_calls) == 1,
          f"ingest hybrid_fusion: {n_dense} dense rows, kernel 6 launched "
          f"{l6} times, {len(delta_calls)} delta calls")
    mod6 = kernel_modules()["dense_topk_tiles"]
    err6 = compare("dense_topk_tiles (delta, k = n)",
                   mod6.dense_topk_tiles(*delta_calls[0][0]),
                   mod6.dense_topk_plain(*delta_calls[0][0]), 0.0)
    t6 = delta_call_times("dense_topk_tiles", mod6.dense_topk_tiles,
                          *delta_calls[0])
    check((a.topk < n_live).all(), "ingest hybrid_fusion: a ghost row of "
          "the dense delta surfaced")
    delta_ids = int((a.topk >= g.index.n_docs).sum())
    merged = pair[0].merge()
    kernels.reset_launches()
    c = pair[0].serve(terms, mask, topics)
    torch.cuda.synchronize()
    check(merged == took_h[0] and pair[0].delta.n_docs == 0
          and pair[0].dense.delta_emb is None
          and kernels.LAUNCHES["dense_topk_tiles"] == 1
          and (c.topk < pair[0].index.n_docs).all()
          and pair[0].index.n_docs == n_live,
          "ingest hybrid_fusion: the merge did not clear the delta")
    log(f"ingest (c): hybrid_fusion with the delta on the "
        f"{g.index.n_docs}-doc index, {took_h[0]} docs fed: {a.stats['dense']},"
        f" kernel 6 launched {l6} times (the delta at k = n = "
        f"{spec_h.ingest.delta_docs}, max_abs_err {err6}, {t6}), "
        f"{delta_ids} "
        f"candidate slots from the delta, card = CPU (topk, final, latency, "
        f"modality, theta_skip, fallback); one merge ({merged} docs) clears "
        f"it; part {time.perf_counter() - t1:.1f} s, phase "
        f"{time.perf_counter() - t0:.1f} s")


class PlainWatch:
    """Counts the calls of kernels 1 and 2's plain versions (and their
    plain twins) and of Stage-0's that are given a CUDA tensor: the
    wrappers must launch the kernel there, never the plain version."""

    NAMES = {"impact_accumulate_batched": ("impact_accumulate_plain",
                                           "impact_accumulate_grouped"),
             "blockmax_score_batched": ("blockmax_score_plain",
                                        "blockmax_score_grouped"),
             "stage0_features": ("stage0_features_plain",),
             "stage0_forest": ("stage0_forest_plain",)}

    def __init__(self):
        mods = kernel_modules()
        self.sites = [(mods[k], n) for k, names in self.NAMES.items()
                      for n in names]
        self.on_card, self.orig = 0, []

    def __enter__(self):
        import torch
        for mod, name in self.sites:
            fn = getattr(mod, name)
            self.orig.append(fn)

            def watched(*args, _fn=fn, **kw):
                if any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in (*args, *kw.values())):
                    self.on_card += 1
                return _fn(*args, **kw)
            setattr(mod, name, watched)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.sites, self.orig):
            setattr(mod, name, fn)


def isn_sizes(shard_spec):
    """``hybrid_serve_fn``'s sizes for one model rank holding a shard of
    ``shard_spec``'s docs under ``paper_isn.CONFIG`` (its k_shard, ρ_max,
    block size, tile width, t_k and t_time; the caps of
    ``build_serve_cell``), k_global cut to k_shard."""
    from repro_torch.configs import paper_isn
    from repro_torch.isn.shard import serve_cell_sizes
    cfg = paper_isn.CONFIG
    check(shard_spec.block_size == cfg.block_size
          and shard_spec.tile_d == cfg.tile_d,
          f"isn: the shard's block size / tile width {shard_spec.block_size}"
          f" / {shard_spec.tile_d}, not the config's")
    # one model rank holding the shard's docs; k_global cut to k_shard (one
    # rank's candidates cannot fill k_max)
    sizes = serve_cell_sizes(dataclasses.replace(cfg,
                                                 n_docs=shard_spec.n_docs), 1)
    sizes["k_global"] = sizes["k_shard"]
    check(sizes["daat_cap"] >= shard_spec.max_df
          and sizes["daat_bcap"] >= shard_spec.max_blocks_per_term
          and sizes["n_blocks"] == shard_spec.n_blocks,
          f"isn: caps {sizes} do not cover the shard {shard_spec}")
    return sizes


def same_bits(label, a, b):
    """Require two float tensors equal bit for bit (nan to nan)."""
    import torch
    a, b = a.cpu(), b.cpu()
    both_nan = torch.isnan(a) & torch.isnan(b)
    bad = (a.view(torch.int32) != b.view(torch.int32)) & ~both_nan
    check(a.shape == b.shape and not bool(bad.any()),
          f"{label}: {int(bad.sum())} of {a.numel()} values differ")


def isn_phase(dev, shard, card, cpu, card_name):
    """The distributed ISN step on the card (module docstring, step 16):
    ``make_local_mesh()`` (NCCL, world size 1, mesh (1, 1)), the step at
    the production per-chip cell of ``paper_isn.CONFIG`` on the fit's
    196,608-doc shard with the fit's three Stage-0 GBRTs, counted from 0,
    against the engines called directly; Stage-0 and ``xla_expm1`` card =
    CPU; then the card's step against its CPU twin (gloo) on the cli
    phase's index.  ``shard`` as for ``ingest_phase``; ``card`` / ``cpu``
    the cli phase's card run and CPU system."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import paper_isn
    from repro_torch.core import features
    from repro_torch.index.corpus import build_queries
    from repro_torch.index.postings import shard_to_device
    from repro_torch.isn import shard as isn
    from repro_torch.isn.daat import daat_serve
    from repro_torch.isn.saat import saat_serve
    from repro_torch.launch.mesh import (backend_for, make_local_mesh,
                                         mesh_info)
    t0 = time.perf_counter()
    index, layout = shard["index"], shard["layouts"][0]
    sizes = isn_sizes(layout.spec)
    # one query rank's rows of the global step (the serve phases' log at
    # their default size)
    q = paper_isn.CONFIG.queries_per_step // ISN_DATA_RANKS
    ql = build_queries(shard["corpus"], q,
                       max_len=paper_isn.CONFIG.query_len,
                       stop_k=shard["spec"].index.stop_k)
    models = shard["card_models"][0]
    edges = [models[n].bin_edges for n in isn.STAGE0_TARGETS]
    check(all(torch.equal(e, edges[0]) for e in edges[1:]),
          "isn: the three Stage-0 models bin their features with other "
          "edges")
    fa = isn.stage0_forest(models)
    depth = models["k"].params.depth
    check(depth == 5, f"isn: Stage-0 forests of depth {depth}")
    t_k32, t_time32 = (float(np.float32(sizes[k])) for k in ("t_k", "t_time"))

    def routes(fa_, ts_, df, terms_, mask_):
        pk, prho, pt = isn._stage0(fa_, ts_, df, terms_, mask_, depth)
        rho = torch.clamp(prho, 1024, sizes["rho_max"]).to(torch.int32)
        return (pk, prho, pt), (pk > t_k32) | (pt > t_time32), rho

    try:
        mesh = make_local_mesh(device=dev)
        info = mesh_info(mesh)
        check(info == {"axes": {"data": 1, "model": 1}, "n_devices": 1}
              and dist.get_backend() == backend_for(dev)
              and mesh.device_type == dev.type,
              f"isn: mesh {info} on {mesh.device_type}, backend "
              f"{dist.get_backend()}")
        s, spec = shard_to_device(layout, dev)
        ts = torch.from_numpy(index.term_stats).to(dev)
        terms = torch.from_numpy(ql.terms[:q]).to(dev)
        mask = torch.from_numpy(ql.mask[:q]).to(dev)
        serve = isn.hybrid_serve_fn(mesh, forest_depth=depth, **sizes)
        serve(s, fa, ts, terms, mask)       # NCCL's communicator, caches
        torch.cuda.synchronize()
        kernels.reset_launches()
        with PlainWatch() as watch, Recorder(STAGE0_KERNELS) as rec0:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ids, sc, work, route = serve(s, fa, ts, terms, mask)
            end.record()
            torch.cuda.synchronize()
        wall = start.elapsed_time(end)
        got = dict(kernels.LAUNCHES)
        blocks = -(-q // 64)
        want = {name: 0 for name in got}
        want.update(impact_accumulate_batched=blocks,
                    blockmax_score_batched=2 * blocks, stage0_features=1,
                    stage0_forest=1)
        check(got == want, f"isn step: launches {got}, want {want}")
        check(watch.on_card == 0, f"isn step: {watch.on_card} plain-version "
              "calls on CUDA tensors")
        check(ids.shape == (q, sizes["k_global"]) and ids.dtype == torch.int32
              and work.dtype == torch.int32 and route.dtype == torch.bool
              and bool(torch.isfinite(sc).all())
              and bool(((ids >= 0) & (ids < spec.n_docs)).all()),
              "isn step: output shapes, dtypes or ids invalid")
        n_j = int(route.sum())
        jass_max = int(work[route].max()) if n_j else 0
        check(jass_max <= sizes["rho_max"],
              f"isn step: JASS work {jass_max} over rho_max")

        # the same step's engines called directly, no collective
        _, r_j, rho = routes(fa, ts, s.df, terms, mask)
        a = saat_serve(s, terms, mask, rho, n_docs=sizes["n_docs_shard"],
                       k=sizes["k_shard"], tile_d=sizes["tile_d"])
        b = daat_serve(s, terms, mask, torch.ones(q, device=dev),
                       n_docs=sizes["n_docs_shard"],
                       n_blocks=sizes["n_blocks"],
                       block_size=sizes["block_size"], k=sizes["k_shard"],
                       bcap=sizes["daat_bcap"], tile_d=sizes["tile_d"])
        check(torch.equal(route, r_j)
              and torch.equal(ids, torch.where(r_j[:, None], a.topk_docs,
                                               b.topk_docs))
              and torch.equal(sc, torch.where(r_j[:, None], a.topk_scores,
                                              b.topk_scores))
              and torch.equal(work, torch.where(r_j, a.work,
                                                b.work.to(torch.int32))),
              "isn step: differs from saat_serve / daat_serve called "
              "directly")
        # Stage-0 of the whole step on the CPU, bit for bit
        fa_cpu = isn.ForestArrays(*(t.cpu() for t in fa))
        pred, _, _ = routes(fa, ts, s.df, terms, mask)
        pred_cpu, _, _ = routes(fa_cpu, torch.from_numpy(index.term_stats),
                                torch.from_numpy(layout.arrays.df),
                                torch.from_numpy(ql.terms[:q]),
                                torch.from_numpy(ql.mask[:q]))
        for name, u, v in zip(("pk", "prho", "pt"), pred, pred_cpu):
            same_bits(f"isn Stage-0 {name} card vs CPU", u, v)
        # xla_expm1 over both branches, card vs CPU
        rng = np.random.RandomState(SEED % 10_000)
        sweep = np.concatenate([
            rng.uniform(lo, hi, n).astype(np.float32) for lo, hi, n in
            ((-2, 13, 1 << 20), (-0.5, 0.5, 1 << 18))] + [
            np.arange(0, 1 << 32, 4099, dtype=np.uint64).astype(np.uint32)
            .view(np.float32)])
        x = torch.from_numpy(sweep)
        same_bits("xla_expm1 card vs CPU", features.xla_expm1(x.to(dev)),
                  features.xla_expm1(x))
        log(f"isn step (paper_isn.CONFIG's per-chip cell: {spec.n_docs} "
            f"docs, {q} x {ql.terms.shape[1]} queries, {sizes}; mesh "
            f"{info}, NCCL): wall {wall:.3f} ms (CUDA events); routes jass "
            f"{n_j} / bmw {q - n_j}; max work {int(work.max())} (JASS rows "
            f"{jass_max} <= rho_max {sizes['rho_max']}); launches "
            f"{ {k: v for k, v in got.items() if v} }, no plain version on "
            "the card; equal to saat_serve / daat_serve called directly; "
            f"Stage-0 (pk, prho, pt) card = CPU bit for bit; xla_expm1 card "
            f"= CPU on {len(sweep)} values; {card_name}")

        # the card's step against its CPU twin on the cli phase's index
        g = card.system
        cli = isn_sizes(g.shard_specs[0])
        rows = slice(0, ISN_CHECKED)
        step_in = [(g.shards[0], isn.stage0_forest(g.models), dev),
                   (cpu.shards[0], isn.stage0_forest(cpu.models), "cpu")]
        outs, walls = [], []
        for i, (s_, fa_, d) in enumerate(step_in):
            if i:
                dist.destroy_process_group()
                mesh = make_local_mesh(device="cpu")
                check(dist.get_backend() == "gloo",
                      f"isn: CPU mesh on {dist.get_backend()}")
            ts_ = torch.from_numpy(g.index.term_stats).to(d)
            terms_ = torch.from_numpy(card.ql.terms[rows]).to(d)
            mask_ = torch.from_numpy(card.ql.mask[rows]).to(d)
            t = time.perf_counter()
            out = isn.hybrid_serve_fn(mesh, forest_depth=depth, **cli)(
                s_, fa_, ts_, terms_, mask_)
            if d == dev:
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            pred, _, _ = routes(fa_, ts_, s_.df, terms_, mask_)
            outs.append([t_.cpu() for t_ in (*out, *pred)])
        (ids, sc, work, route, *pred), (ids_c, sc_c, work_c, route_c,
                                        *pred_c) = outs
        check(torch.equal(ids, ids_c) and torch.equal(work, work_c)
              and torch.equal(route, route_c)
              and torch.equal(sc[route], sc_c[route])
              and float((sc - sc_c).abs().max()) <= 1e-4,
              "isn step on the cli index: card and CPU differ")
        for name, u, v in zip(("pk", "prho", "pt"), pred, pred_c):
            same_bits(f"isn cli Stage-0 {name} card vs CPU", u, v)
        log(f"isn step on the cli index ({g.shard_specs[0].n_docs} docs, "
            f"first {ISN_CHECKED} queries, {cli}): card (NCCL) = CPU (gloo):"
            f" ids, work, routes (jass {int(route.sum())}) exact, JASS "
            f"scores exact, BMW within 1e-4 (max "
            f"{float((sc - sc_c).abs().max())}), pk/prho/pt bit-equal; walls "
            f"card {walls[0]:.3f} s, CPU {walls[1]:.3f} s; phase "
            f"{time.perf_counter() - t0:.1f} s")
        return rec0.calls
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Stage-0: the features and forest kernels
# ---------------------------------------------------------------------------

def bits_differ(a, b):
    """Where two float tensors differ bit for bit (nan equals nan)."""
    import torch
    return ((a.view(torch.int32) != b.view(torch.int32))
            & ~(torch.isnan(a) & torch.isnan(b)))


def stage0_feature_edges(dev, term_stats, term_df):
    """Edge cases of ``stage0_features``: Q of 1, 32 and 256 on the
    recorded table with one-term and all-padded rows and negative ids; a
    table of +0.0, -0.0 and mixed rows, under int df and under a float df
    that ties +0.0 with -0.0; float df and fractional masks across
    ``xla_log1p``'s small-|x| cut; every integer df below
    STAGE0["log1p_ints"] as a one-term query."""
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED % 10_000)
    vocab, slots = term_stats.shape[0], 8
    calls = []
    for q in STAGE0["queries"]:
        terms = rng.randint(-vocab, vocab, (q, slots)).astype(np.int32)
        n = rng.randint(0, slots + 1, q)
        n[0] = 1
        if q > 1:
            n[1] = 0
        mask = (np.arange(slots)[None] < n[:, None]).astype(np.float32)
        calls.append((term_stats, term_df, torch.from_numpy(terms).to(dev),
                      torch.from_numpy(mask).to(dev)))
    zs = torch.zeros((4, 36), device=dev)
    zs[1] = -0.0
    zs[2, ::2] = -0.0
    zs[3] = 1.0
    terms = torch.tensor([[0, 1, 0], [1, 0, 0], [1, 1, 0], [2, 0, 3],
                          [2, 1, 2]], dtype=torch.int32, device=dev)
    mask = torch.tensor([[1, 1, 0], [1, 1, 0], [1, 1, 1], [1, 1, 1],
                         [1, 0, 1]], dtype=torch.float32, device=dev)
    calls.append((zs, torch.tensor([0, 3, 7, 1], dtype=torch.int32,
                                   device=dev), terms, mask))
    calls.append((zs, torch.tensor([0.0, -0.0, 7.0, -0.0], device=dev),
                  terms, mask))
    cut = np.float32(0.41421354)
    vals = np.array([0.0, -0.0, 1e-30, 1e-8, 0.2, cut, np.nextafter(cut, 1),
                     np.nextafter(cut, 0), -cut, np.nextafter(-cut, 0), 0.41,
                     0.42, -0.3, 0.7, 1.0, 3.0, 1e6, 2 ** 24, 1e30],
                    np.float32)
    k = len(vals)
    stats = torch.from_numpy(rng.randn(k, 36).astype(np.float32)).to(dev)
    df = torch.from_numpy(vals).to(dev)
    one = torch.arange(k, dtype=torch.int32, device=dev)[:, None]
    calls.append((stats, df, one, torch.ones((k, 1), device=dev)))
    pairs = torch.from_numpy(rng.randint(0, k, (64, 2)).astype(np.int32))
    frac = torch.from_numpy(rng.choice(
        np.float32([0.0, 0.25, 0.5, 1.0]), (64, 2))).to(dev)
    calls.append((stats, df, pairs.to(dev), frac))
    n = STAGE0["log1p_ints"]
    ints = torch.arange(n, dtype=torch.int32, device=dev)
    calls.append((torch.zeros((n, 36), device=dev), ints, ints[:, None],
                  torch.ones((n, 1), device=dev)))
    return calls


def stage0_forest_edges(dev):
    """Edge cases of ``stage0_forest``: three seeded models at each tree
    count of STAGE0["trees"] (every ``_sum_trees`` branch) and depth of
    STAGE0["depths"], per-model and shared edges, Q of STAGE0["queries"],
    with features exactly on an edge and NaN features, half of them through
    ``xla_expm1``; and predictions (bases over a -0.0 leaf) whose half
    flushes and that lie on and beside ``xla_expm1``'s 0.5 cut."""
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED % 10_000 + 1)
    n_feat, n_edges, m = 147, 63, 3

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    calls = []
    for shared in (False, True):
        for depth in STAGE0["depths"]:
            for n_trees in STAGE0["trees"]:
                w = 2 ** (depth - 1)
                feat = rng.randint(0, n_feat, (m, n_trees, depth, w))
                thresh = rng.randint(0, n_edges + 1, (m, n_trees, depth, w))
                leaf = (rng.randn(m, n_trees, 2 ** depth)
                        * 10.0 ** rng.uniform(-3, 1, (m, n_trees, 1)))
                base = rng.randn(m)
                shape = (n_feat, n_edges) if shared else (m, n_feat, n_edges)
                edges = np.sort(rng.randn(*shape).astype(np.float32), -1)
                for q in STAGE0["queries"]:
                    x = rng.randn(q, n_feat).astype(np.float32)
                    e = edges if shared else edges[rng.randint(m)]
                    on = rng.randint(0, n_feat, n_feat // 3)
                    x[0, on] = e[on, rng.randint(0, n_edges, len(on))]
                    x[-1, ::7] = np.nan
                    calls.append(((t(x), t(edges), t(feat.astype(np.int32)),
                                   t(thresh.astype(np.int32)),
                                   t(leaf.astype(np.float32)),
                                   t(base.astype(np.float32))),
                                  dict(depth=depth,
                                       expm1=bool(rng.rand() < 0.5))))
    tiny = np.finfo(np.float32).tiny
    half = np.float32(0.5)
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, tiny, -tiny, 2 * tiny,
                     3e-38, -3e-38, half, -half, np.nextafter(half, 1),
                     np.nextafter(half, 0), -np.nextafter(half, 1), 0.0004,
                     -0.0004, 0.0008, 88.7, 88.73, -87.4, 89.0, 16.0, 13.0,
                     -2.0, np.inf, -np.inf, np.nan], np.float32)
    calls.append(expm1_call(dev, vals))
    return calls


def expm1_call(dev, vals):
    """``stage0_forest`` on one query whose M predictions are ``vals``: a
    tree of depth 0 a model, its leaf -0.0 (so base + leaf is the base
    bit for bit), through ``xla_expm1``."""
    import torch
    m = len(vals)
    i32 = dict(dtype=torch.int32, device=dev)
    return ((torch.zeros((1, 4), device=dev), torch.zeros((4, 1), device=dev),
             torch.zeros((m, 1, 1, 1), **i32), torch.zeros((m, 1, 1, 1), **i32),
             torch.full((m, 1, 1), -0.0, device=dev),
             torch.as_tensor(vals, device=dev)), dict(depth=0, expm1=True))


def expm1_sweep(dev):
    """``xla_expm1`` in the forest kernel against its plain version over
    2^20 seeded values of [-2, 13] and [-0.5, 0.5] and every
    STAGE0["expm1_stride"]-th float32 bit pattern, STAGE0["expm1_models"]
    predictions a launch.  Returns the count of values."""
    import numpy as np
    import torch
    from repro_torch.kernels.stage0 import ops as s0
    rng = np.random.RandomState(SEED % 10_000 + 2)
    sweep = np.concatenate([
        rng.uniform(-2, 13, 1 << 19).astype(np.float32),
        rng.uniform(-0.5, 0.5, 1 << 19).astype(np.float32),
        np.arange(0, 1 << 32, STAGE0["expm1_stride"], dtype=np.uint64)
        .astype(np.uint32).view(np.float32)])
    step = STAGE0["expm1_models"]
    for i in range(0, len(sweep), step):
        args, kw = expm1_call(dev, sweep[i:i + step])
        got = s0.stage0_forest(*args, **kw)[:, 0]
        # the plain version's arithmetic here: xla_expm1(base + -0.0), one
        # model at a time; the same values in one call
        bad = bits_differ(got, s0.xla_expm1(args[5]))
        check(not bool(bad.any()), f"stage0_forest: xla_expm1 differs on "
              f"{int(bad.sum())} of the sweep's values from {i}")
    return len(sweep)


def stage0_check(calls, launches):
    """Both Stage-0 kernels against their plain versions on the card, bit
    for bit (nan equal to nan): every recorded call (``calls``: name -> (label,
    args, kw) of the fits' and serves' Stage-0) and the edge cases.  Times
    each kernel beside its plain version
    on the largest recorded serve call (Q = 256, the ISN step's), logs the
    cascade's Q = 32 call and the fit's, and the device times.
    ``launches``: name -> the counted serve path's launches.  Returns the
    two kernel rows."""
    import torch
    from repro_torch.kernels.stage0 import ops as s0
    rows = {}
    feats, forests = calls["stage0_features"], calls["stage0_forest"]
    check(feats and forests, "stage0: a kernel's main path was never called")
    dev = feats[0][1][0].device
    table = next(a for label, a, _ in feats if label == "isn")[:2]
    edges_f = [("edge", a, {}) for a in stage0_feature_edges(dev, *table)]
    for label, args, kw in feats + edges_f:
        got = s0.stage0_features(*args)
        want = s0.stage0_features_plain(*args)
        torch.cuda.synchronize()
        bad = bits_differ(got, want)
        check(got.shape == want.shape and not bool(bad.any()),
              f"stage0_features ({label}, Q={args[2].shape[0]}): "
              f"{int(bad.sum())} of {got.numel()} values differ")
    log(f"stage0_features: {len(feats)} recorded calls and {len(edges_f)} "
        "edge cases bit-equal to the plain version")
    edges_t = [("edge", a, kw) for a, kw in stage0_forest_edges(dev)]
    for label, args, kw in forests + edges_t:
        got = s0.stage0_forest(*args, **kw)
        want = s0.stage0_forest_plain(*args, **kw)
        torch.cuda.synchronize()
        bad = bits_differ(got, want)
        check(got.shape == want.shape and not bool(bad.any()),
              f"stage0_forest ({label}, {tuple(args[2].shape)}, Q="
              f"{args[0].shape[0]}, {kw}): {int(bad.sum())} of "
              f"{got.numel()} values differ")
    n_sweep = expm1_sweep(dev)
    log(f"stage0_forest: {len(forests)} recorded calls, {len(edges_t)} edge "
        f"cases and xla_expm1 over {n_sweep} values bit-equal to the plain "
        "version")
    plain = {"stage0_features": s0.stage0_features_plain,
             "stage0_forest": s0.stage0_forest_plain}
    for name, recorded, n_edges in (("stage0_features", feats, len(edges_f)),
                                    ("stage0_forest", forests,
                                     len(edges_t))):
        kern = getattr(s0, name)
        by_label = {}
        for label, args, kw in recorded:
            by_label.setdefault(label, (args, kw))
        for label, (args, kw) in by_label.items():
            q = args[2].shape[0] if name == "stage0_features" \
                else args[0].shape[0]
            call = lambda: kern(*args, **kw)
            log(f"kernel {name} ({label}, Q={q}): {cuda_ms(call, REPS):.4f}"
                f" ms, device {device_ms(call, REPS)} ms a call; plain "
                f"{cuda_ms(lambda: plain[name](*args, **kw), REPS // 4):.4f}"
                " ms")
        args, kw = by_label["isn"]
        note = (f"{len(recorded)} recorded calls ({', '.join(by_label)}) and"
                f" {n_edges} edge cases bit-equal; timed at the ISN step's "
                "call")
        rows[name] = kernel_row(name, kern, plain[name], None, args, kw, 0.0,
                                note)
        rows[name]["launches"] = launches[name]
    return rows


def stage0_serve_isn(dev, index, layout, corpus, spec, models):
    """The ISN step at ``paper_isn.CONFIG``'s per-chip sizes on ``layout``'s
    shard with ``models``' Stage-0 forests: one warm step, then
    STAGE0["isn_steps"] steps of 256 queries counted from 0 with Stage-0's
    calls recorded.  Requires one launch of each Stage-0 kernel a step and
    no plain Stage-0 version on CUDA tensors.  Returns the recorded calls
    (each (args, kw)) by kernel."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import paper_isn
    from repro_torch.index.corpus import build_queries
    from repro_torch.index.postings import shard_to_device
    from repro_torch.isn import shard as isn
    from repro_torch.launch.mesh import make_local_mesh
    sizes = isn_sizes(layout.spec)
    q, steps = paper_isn.CONFIG.queries_per_step // ISN_DATA_RANKS, \
        STAGE0["isn_steps"]
    ql = build_queries(corpus, q * steps, max_len=paper_isn.CONFIG.query_len,
                       stop_k=spec.index.stop_k, seed=SEED % 10_000)
    fa = isn.stage0_forest(models)
    try:
        mesh = make_local_mesh(device=dev)
        s, _ = shard_to_device(layout, dev)
        ts = torch.from_numpy(index.term_stats).to(dev)
        step = isn.hybrid_serve_fn(mesh, forest_depth=models["k"].params.depth,
                                   **sizes)
        batches = [tuple(torch.from_numpy(a[i * q:(i + 1) * q]).to(dev)
                         for a in (ql.terms, ql.mask)) for i in range(steps)]
        step(s, fa, ts, *batches[0])
        torch.cuda.synchronize()
        kernels.reset_launches()
        with Recorder(STAGE0_KERNELS) as rec, PlainWatch() as watch:
            for terms, mask in batches:
                step(s, fa, ts, terms, mask)
            torch.cuda.synchronize()
        got = {name: kernels.LAUNCHES[name] for name in STAGE0_KERNELS}
        check(got == {name: steps for name in STAGE0_KERNELS},
              f"stage0: the ISN step's {steps} steps launched {got}")
        check(watch.on_card == 0, f"stage0: {watch.on_card} plain-version "
              "calls on CUDA tensors in the ISN step")
        log(f"stage0: ISN step, {steps} steps of {q} queries: launches {got}")
        return rec.calls
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def stage0_alone(dev, n_docs, n_batches):
    """``--only stage0``: the ``paper_200ms`` shard of ``n_docs`` docs, its
    card fit from FIT_QUERIES queries (seed FIT_SEED) and ``n_batches``
    served batches of 32, then STAGE0["isn_steps"] ISN steps of 256 on the
    same shard and forests, every Stage-0 call recorded; each serve
    counted from 0 (one launch of each kernel a batch, and a step); then
    ``stage0_check``."""
    import torch
    from repro_torch import kernels
    from repro_torch.index.corpus import build_queries
    from repro_torch.serving.system import build_system
    spec, corpus, index, ql, layouts = build_shard(n_docs, n_batches)
    fit_ql = build_queries(corpus, FIT_QUERIES, stop_k=spec.index.stop_k,
                           seed=FIT_SEED)
    gpu = build_system(spec, index, corpus=corpus, device=dev,
                       layouts=layouts)
    with Recorder(STAGE0_KERNELS) as rec:
        t = time.perf_counter()
        gpu.fit(fit_ql, None, seed=FIT_SEED)
        torch.cuda.synchronize()
        log(f"stage0: card fit {time.perf_counter() - t:.1f} s")
        fit_calls = {k: list(v) for k, v in rec.calls.items()}
    with Recorder(STAGE0_KERNELS) as rec, PlainWatch() as watch:
        launches, _, _ = serve_phase(gpu, ql, n_batches, n_docs, spec)
    served = {name: launches[name] for name in STAGE0_KERNELS}
    check(served == {name: n_batches for name in STAGE0_KERNELS}
          and watch.on_card == 0,
          f"stage0: {n_batches} served batches launched {served}, "
          f"{watch.on_card} plain calls on CUDA tensors")
    isn_calls = stage0_serve_isn(dev, index, layouts[0], corpus, spec,
                                 gpu.models)
    calls = {name: [("fit", a, kw) for a, kw in fit_calls[name]]
             + [("cascade", a, kw) for a, kw in rec.calls[name]]
             + [("isn", a, kw) for a, kw in isn_calls[name]]
             for name in STAGE0_KERNELS}
    rows = stage0_check(calls, served)
    for name in STAGE0_KERNELS:
        log(f"row {json.dumps(rows[name])}")
    kernels.reset_launches()


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def same_batch(label, a, b, dense=False):
    """Card (a) against CPU (b) results of one served batch."""
    import numpy as np
    check(np.array_equal(a.topk, b.topk), f"{label}: topk differs")
    check(np.array_equal(a.final, b.final), f"{label}: final differs")
    check(np.array_equal(a.latency, b.latency),
          f"{label}: modeled latency differs")
    if dense:
        for key in ("modality", "theta_skip", "fallback"):
            check(np.array_equal(a.dense[key], b.dense[key]),
                  f"{label}: {key} differs")


def calibrate_thetas(system, calib):
    """The ``hybrid_fusion`` θ bands: the preset's, unless a band catches
    none of the calibration queries' top-1 dense scores; then that band
    moves to a quantile of those scores (θ_high the 80th, θ_low the 30th
    percentile), as the preset's own comment describes.  Returns the
    spec."""
    import numpy as np
    ds = system.cascade_spec.dense
    _, sc = system.dense.serve(system.dense.embed(calib.terms, calib.mask),
                               system.k_serve)
    top = sc[:, 0].astype(np.float64)
    hi, lo = ds.theta_high, ds.theta_low
    if not (top >= hi).any():
        hi = float(np.percentile(top, 80))
    if not (top < lo).any():
        lo = float(np.percentile(top, 30))
    log(f"hybrid_fusion: calibration top-1 dense scores "
        f"p0/p30/p50/p80/p100 = "
        + "/".join(f"{v:.4f}" for v in np.percentile(top, [0, 30, 50, 80,
                                                           100]))
        + f"; theta_high {ds.theta_high} -> {hi}, theta_low "
        f"{ds.theta_low} -> {lo}")
    return dataclasses.replace(system.cascade_spec, dense=dataclasses.replace(
        ds, theta_high=hi, theta_low=min(lo, hi)))


def cross_check_rows(system, ql):
    """32 query rows for the hybrid_fusion cross-check that reach every
    dense branch: up to 4 dense-only rows below θ_low (the lexical
    fallback), up to 4 dense rows at or above θ_high (the Stage-2 skip),
    the rest in log order.  Stage-0 and the dense scan change no state of
    the system; the scheduler's route is decided when the batch is
    served."""
    import numpy as np
    from repro_torch.dense import M_DENSE, M_LEX
    ds = system.cascade_spec.dense
    pt = system.stage0(ql.terms, ql.mask)[2]
    modality = system._modality(pt)
    d_rows = np.flatnonzero(modality != M_LEX)
    _, sc = system.dense.serve(
        system.dense.embed(ql.terms[d_rows], ql.mask[d_rows]),
        system.k_serve)
    top = sc[:, 0]
    low = d_rows[(modality[d_rows] == M_DENSE) & (top < ds.theta_low)][:4]
    high = d_rows[top >= ds.theta_high][:4]
    rows = list(dict.fromkeys([*low, *high, *range(len(ql.terms))]))
    return np.asarray(rows[:BATCH])


def laxmap_phase(gpu, cpu, ql, spec):
    """The per-query Stage-1 path (``saat_serve_laxmap`` at ρ = 8,192 and
    ρ_max with cap = ρ, ``daat_serve_laxmap`` at θ = 1.0 and 1.2 with cap =
    max_df and bcap = max_blocks_per_term, k = k_serve) over the 32
    cross-check queries on the systems' shards.  A first pass on the card
    records each per-query kernel's largest call; then, counted from 0, a
    timed pass on the card, the same on the CPU shard (plain versions) and
    the card's batched engines on the same queries.  Requires SAAT equal on
    the card and the CPU (ids, scores, work) and to the batched engine;
    DAAT ids, work, blocks and scores bit-equal on the card and the CPU,
    and ids, work and blocks equal to the batched engine with scores within
    1e-4 (it sums phase 1 and the rest apart).  Returns (launches, the
    recorded calls)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.isn.daat import daat_serve, daat_serve_laxmap
    from repro_torch.isn.saat import saat_serve, saat_serve_laxmap
    sp = gpu.shard_specs[0]
    k = spec.stage2.k_serve
    saat_kw = dict(n_docs=sp.n_docs, k=k)
    daat_kw = dict(n_docs=sp.n_docs, n_blocks=sp.n_blocks,
                   block_size=sp.block_size, k=k,
                   bcap=sp.max_blocks_per_term)
    runs = [("saat", rho) for rho in (8192, spec.routing.rho_max)] + [
        ("daat", theta) for theta in (1.0, 1.2)]

    def laxmap(shard, engine, x, walls=None):
        dev = shard.offsets.device
        terms = torch.from_numpy(ql.terms[:BATCH]).to(dev)
        mask = torch.from_numpy(ql.mask[:BATCH]).to(dev)
        full = torch.full((BATCH,), x, device=dev)
        t = time.perf_counter()
        if engine == "saat":
            res = saat_serve_laxmap(shard, terms, mask, full, cap=x,
                                    **saat_kw)
        else:
            res = daat_serve_laxmap(shard, terms, mask, full, cap=sp.max_df,
                                    **daat_kw)
        if walls is not None:
            torch.cuda.synchronize()
            walls[(engine, x)] = time.perf_counter() - t
        return [np.asarray(f.cpu()) for f in res]

    with Recorder(LAXMAP_KERNELS, largest=True) as rec:
        for engine, x in runs:
            laxmap(gpu.shards[0], engine, x)
        torch.cuda.synchronize()
    walls = {}
    kernels.reset_launches()
    card = {run: laxmap(gpu.shards[0], *run, walls) for run in runs}
    launches = dict(kernels.LAUNCHES)
    t = time.perf_counter()
    host = {run: laxmap(cpu.shards[0], *run) for run in runs}
    t_cpu = time.perf_counter() - t
    dev = gpu.shards[0].offsets.device
    terms = torch.from_numpy(ql.terms[:BATCH]).to(dev)
    mask = torch.from_numpy(ql.mask[:BATCH]).to(dev)
    for engine, x in runs:
        label = f"laxmap {engine} {x}"
        a, b = card[(engine, x)], host[(engine, x)]
        for field, u, v in zip(("ids", "scores", "work", "blocks"), a, b):
            check(np.array_equal(u, v),
                  f"{label}: {field} differ on the card and the CPU")
        full = torch.full((BATCH,), x, device=dev)
        if engine == "saat":
            bat = saat_serve(gpu.shards[0], terms, mask, full, **saat_kw)
        else:
            bat = daat_serve(gpu.shards[0], terms, mask, full, **daat_kw)
        bat = [np.asarray(f.cpu()) for f in bat]
        for field, u, v in zip(("ids", "scores", "work", "blocks"), a, bat):
            if engine == "daat" and field == "scores":
                err = float(np.abs(u - v).max())
                check(err <= 1e-4, f"{label}: scores {err} from the batched "
                      "engine's")
            else:
                check(np.array_equal(u, v), f"{label}: {field} differ from "
                      "the batched engine's")
        extra = (f", blocks mean {a[3].mean():.1f}" if engine == "daat"
                 else "")
        log(f"{label}: card {1e3 * walls[(engine, x)] / BATCH:.3f} ms per "
            f"query ({BATCH} queries, k={k}); work mean {a[2].mean():.1f}"
            f"{extra}; equal on the card and the CPU and to the batched "
            f"engine")
    log(f"laxmap: CPU shard runs {t_cpu:.1f} s; launches {launches}")
    for name in LAXMAP_KERNELS:
        check(launches[name] > 0, f"laxmap: kernel {name} never launched")
    return launches, rec.calls


def serve_phase(system, ql, n_batches, n_docs, spec):
    """The counted main path: launch counts set to 0, ``n_batches``
    batches of 32 served on the card, the counts read.  Returns (launches,
    route counts, dense stat sums, walls, last result)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    routes = {"jass": 0, "bmw": 0, "reranked": 0}
    dense = {}
    for i in range(n_batches):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        jass0, bmw0 = system.sched.stats["jass"], system.sched.stats["bmw"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = system.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        routes["jass"] += system.sched.stats["jass"] - jass0
        routes["bmw"] += system.sched.stats["bmw"] - bmw0
        routes["reranked"] += int((res.candidates_used > 0).sum())
        for key, n in res.stats.get("dense", {}).items():
            dense[key] = dense.get(key, 0) + n
        check(res.topk.shape == (BATCH, spec.stage2.k_serve)
              and res.final.shape == (BATCH, spec.stage2.t_final),
              f"{spec.name} serve: result shapes")
        check(np.isfinite(res.latency).all() and (res.topk >= 0).all()
              and (res.topk < n_docs).all(),
              f"{spec.name} serve: ids or latency invalid")
        check(float(res.latency.max()) <= system.worst_case_us() + 1e-9,
              f"{spec.name} serve: latency above the worst-case bound")
    launches = dict(kernels.LAUNCHES)
    log(f"{spec.name}: served {n_batches} x {BATCH} queries: {routes} "
        f"{dense}; launches {launches}")
    log(f"{spec.name}: wall s per batch: "
        + " ".join(f"{w:.4f}" for w in walls)
        + f" (median {statistics.median(walls):.4f})")
    log(f"{spec.name}: device memory: {torch.cuda.memory_allocated()} B in "
        f"use, {torch.cuda.max_memory_allocated()} B peak during serving; "
        f"modeled p99 {res.stats['p99']:.3f}, worst-case bound "
        f"{system.worst_case_us():.3f}")
    check(routes["reranked"] > 0, f"{spec.name} serve: Stage-2 re-ranked no "
          "query")
    return launches, routes, dense


def build_shard(n_docs, n_batches):
    """The kernels' build, in a thread, beside the host's build of the
    ``paper_200ms`` corpus of ``n_docs`` docs, its index, ``n_batches``
    batches of queries and the shard's host layout.  Returns (spec, corpus,
    index, queries, layouts)."""
    from repro_torch import kernels
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.index.builder import build_index
    from repro_torch.index.corpus import (CorpusParams, build_corpus,
                                          build_queries)
    from repro_torch.index.postings import shard_layouts

    # the kernels build (nvcc, in subprocesses) while the host builds the
    # corpus and the index; both are set-up
    built = {}

    def build():
        t = time.perf_counter()
        try:
            kernels.extension()
        except Exception as e:      # re-raised once the host work is done
            built["error"] = e
        built["s"] = time.perf_counter() - t
    build_thread = threading.Thread(target=build)
    build_thread.start()

    t = time.perf_counter()
    spec = get_preset("paper_200ms")
    corpus = build_corpus(CorpusParams(n_docs=n_docs))
    t_corpus = time.perf_counter() - t
    index = build_index(corpus, block_size=spec.index.block_size,
                        stop_k=spec.index.stop_k)
    log(f"corpus {n_docs} docs in {t_corpus:.1f} s, index "
        f"{index.n_postings} postings in "
        f"{time.perf_counter() - t - t_corpus:.1f} s")
    ql = build_queries(corpus, n_batches * BATCH, stop_k=spec.index.stop_k)
    # the shard's host layout, built once (beside the kernels' build too):
    # the card and CPU systems of the fit and of hybrid_fusion each copy it
    # to their device
    t = time.perf_counter()
    layouts = shard_layouts(index, spec.deploy.n_shards, spec.index.tile_d)
    log(f"host layout of the shard: {time.perf_counter() - t:.1f} s, shared "
        "by the four systems built from it")
    build_thread.join()
    if "error" in built:
        raise built["error"]
    log(f"kernels built in {built['s']:.1f} s, beside the host build")
    return spec, corpus, index, ql, layouts


def run(n_docs, n_batches, lm_layers, lm_prompt, lm_steps, profile=False):
    import torch
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.configs.two_tower_retrieval import REDUCED
    from repro_torch.index.corpus import build_queries
    from repro_torch.models.recsys import TwoTower
    from repro_torch.serving.online import fresh_probe
    from repro_torch.serving.system import build_system

    card = card_line()
    print(card, flush=True)
    dev = torch.device(DEVICE)
    walls, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        walls[name] = now - mark[0]
        mark[0] = now

    spec, corpus, index, ql, layouts = build_shard(n_docs, n_batches)
    lap("build")

    # fit: the card's and the CPU's systems, each fitted on its own device
    with Recorder(STAGE0_KERNELS) as rec0:
        gpu, cpu, fit_launches, fit_calls, fit_ql = fit_phase(
            spec, index, corpus, dev, layouts, profile)
    # the card fit's Stage-0 calls (the CPU fit's take the plain version)
    stage0_calls = {name: [("fit", a, kw) for a, kw in calls
                           if a[0].is_cuda]
                    for name, calls in rec0.calls.items()}
    spec = gpu.cascade_spec
    # the card system as fitted, kept for the online phase (its shard is
    # shared, not copied)
    fitted_shard = fresh_probe(gpu)
    log(f"system on {dev}: shard {gpu.shard_specs[0]}")
    lap("fit")

    # cross-check: one batch through fresh systems on the card and the CPU;
    # the card's kernel calls are recorded for the kernel phase
    sl = slice(0, BATCH)
    with Recorder() as rec:
        t = time.perf_counter()
        a = gpu.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t
    t = time.perf_counter()
    b = cpu.serve(ql.terms[sl], ql.mask[sl], ql.topic[sl])
    log(f"cross-check batch: card {t_first:.2f} s (first call), CPU "
        f"{time.perf_counter() - t:.2f} s")
    same_batch("paper_200ms cross-check", a, b)
    log("cross-check: topk, final and latency equal on the card and CPU")
    recorded = dict(rec.calls)

    # the per-query Stage-1 path on the same shard, card and CPU
    lax_launches, lax_calls = laxmap_phase(gpu, cpu, ql, spec)
    recorded.update(lax_calls)
    cpu_models, cpu_ltr = cpu.models, cpu.ltr
    del cpu

    # the dense modality: hybrid_fusion from the same index; one tower,
    # drawn on the host, embeds the collection for both systems
    t = time.perf_counter()
    # the card-fitted models serve hybrid_fusion too (its Stage-0 and LTR
    # specs and budget are paper_200ms's, so fit() would give the same)
    spec_h = get_preset("hybrid_fusion")
    check(spec_h.stage0 == spec.stage0 and spec_h.stage2 == spec.stage2
          and spec_h.routing.budget == spec.routing.budget,
          "hybrid_fusion: its fit would differ from paper_200ms's")
    spec_h = dataclasses.replace(spec_h, routing=dataclasses.replace(
        spec_h.routing, t_k=spec.routing.t_k, t_time=spec.routing.t_time))
    tower = TwoTower.init(REDUCED, spec_h.dense.seed, device="cpu")
    gpu_h = build_system(spec_h, index, corpus=corpus, models=gpu.models,
                         ltr=gpu.ltr, tower=tower, device=dev,
                         layouts=layouts)
    calib = build_queries(corpus, 256, stop_k=spec_h.index.stop_k,
                          seed=SEED % 10_000)
    spec_h = calibrate_thetas(gpu_h, calib)
    gpu_h.cascade_spec = spec_h
    torch.cuda.synchronize()
    log(f"hybrid_fusion on {dev} built in {time.perf_counter() - t:.1f} s: "
        f"{gpu_h.dense.n_shards} shard of {gpu_h.dense.shard_docs[0]} docs x "
        f"d={gpu_h.dense.d}, {gpu_h.dense.n_tiles(0)} tiles of "
        f"{gpu_h.dense.tile_d}")
    cpu_h = build_system(spec_h, index, corpus=corpus, models=cpu_models,
                         ltr=cpu_ltr, tower=tower, device="cpu",
                         layouts=layouts)
    rows_h = cross_check_rows(gpu_h, ql)
    with Recorder() as rec_h:
        a = gpu_h.serve(ql.terms[rows_h], ql.mask[rows_h], ql.topic[rows_h])
        torch.cuda.synchronize()
    b = cpu_h.serve(ql.terms[rows_h], ql.mask[rows_h], ql.topic[rows_h])
    same_batch("hybrid_fusion cross-check", a, b, dense=True)
    log(f"hybrid_fusion cross-check: topk, final, latency, modality, "
        f"theta_skip and fallback equal on the card and CPU "
        f"({a.stats['dense']})")
    del cpu_h
    recorded["dense_topk_tiles"] = rec_h.calls["dense_topk_tiles"]

    lap("cross-checks")
    rows = kernel_phase(recorded)
    for name in LAXMAP_KERNELS:
        rows[name]["launches"] = lax_launches[name]
    rows.update(fit_kernel_phase(fit_calls))
    for name in ("level_histogram",) + LEVEL_KERNELS:
        rows[name]["launches"] = fit_launches[name]
    del fit_calls

    # serve phases: each preset's main path, counted on its own
    with Recorder(STAGE0_KERNELS) as rec0:
        launches, routes, _ = serve_phase(gpu, ql, n_batches, n_docs, spec)
    check(routes["jass"] > 0 and routes["bmw"] > 0,
          "paper_200ms serve: both routes must take queries")
    stage0_launches = {name: launches[name] for name in STAGE0_KERNELS}
    check(stage0_launches == {name: n_batches for name in STAGE0_KERNELS},
          f"paper_200ms serve: Stage-0 launched {stage0_launches} in "
          f"{n_batches} batches")
    for name, calls in rec0.calls.items():
        stage0_calls[name] += [("cascade", a, kw) for a, kw in calls]
    for name in ("impact_accumulate_batched", "blockmax_score_batched",
                 "qd_feature_gather_lanes"):
        check(launches[name] > 0, f"serve: kernel {name} never launched")
        rows[name]["launches"] = launches[name]
    launches, _, dense = serve_phase(gpu_h, ql, n_batches, n_docs, spec_h)
    for key in ("lexical", "dense_only", "fused"):
        check(dense[key] > 0, f"hybrid_fusion serve: no {key} rows")
    log(f"hybrid_fusion: theta_skips={dense['theta_skips']} "
        f"fallbacks={dense['fallbacks']}")
    check(launches["dense_topk_tiles"] > 0,
          "serve: kernel dense_topk_tiles never launched")
    rows["dense_topk_tiles"]["launches"] = launches["dense_topk_tiles"]
    lap("kernels and serve")

    # what the ingest phase serves the fit's shard with
    shard = dict(index=index, corpus=corpus, layouts=layouts, spec=spec,
                 ql=ql, card_models=(gpu.models, gpu.ltr),
                 cpu_models=(cpu_models, cpu_ltr))

    # the BENCH_tail flow, fitted and served on its own collection
    del gpu, gpu_h, recorded, lax_calls, rec, rec_h, layouts
    torch.cuda.empty_cache()
    tail_phase(dev)
    lap("tail")

    # the serving CLI at its defaults, on the card and the CPU; then the
    # Stage-0 prediction framework and the shims on its run
    torch.cuda.empty_cache()
    served, cli_cpu = cli_phase(dev)
    lap("cli")
    predict_phase(served, dev)
    lap("predict")

    # online serving on the fit's shard and on the cli phase's index
    online_phase(dev, fitted_shard, fit_ql, served, cli_cpu)
    del fit_ql, fitted_shard
    lap("online")

    # the result cache and fault injection on the cli phase's index
    cache_phase(dev, served, cli_cpu)
    lap("cache")
    faults_phase(dev, served, cli_cpu)
    lap("faults")

    # telemetry: the gate's flow, then card = CPU and on = off on the cli
    # phase's index
    obs_phase(dev, served, cli_cpu)
    lap("obs")

    # live ingest on the fit's shard and on the cli phase's index
    ingest_phase(dev, shard, served, cli_cpu)
    lap("ingest")

    # the distributed ISN step at the production per-chip cell, then its
    # CPU twin on the cli phase's index
    for name, calls in isn_phase(dev, shard, served, cli_cpu, card).items():
        stage0_calls[name] += [("isn", a, kw) for a, kw in calls]
    del served, cli_cpu, shard
    lap("isn")
    rows.update(stage0_check(stage0_calls, stage0_launches))
    del stage0_calls
    lap("stage0")

    # the LM serving path, with the retrieval systems freed
    torch.cuda.empty_cache()
    rows.update(lm_phase(dev, lm_layers, lm_prompt, lm_steps, profile))
    lap("lm")

    # MoE and MLA, once Yi-6B's memory is freed
    torch.cuda.empty_cache()
    moe_mla_phase(dev, lm_layers, lm_prompt, lm_steps, profile)
    lap("moe_mla")

    # LM training: card = CPU, Yi-6B at full width, kernel 8's backward,
    # the crash-resume loop
    torch.cuda.empty_cache()
    rows["flash_attention_backward"] = train_phase(dev, lm_layers,
                                                   lm_prompt)
    lap("train")

    # recsys and the GNN: card = CPU, the serve paths' calls of kernels 6
    # and 8, the full-width steps
    torch.cuda.empty_cache()
    _, serve, b4r = recsys_gnn_phase(dev)
    lap("recsys_gnn")

    # the model code under a (1, 1) mesh: MoE, the two-tower serve again,
    # DimeNet's partitioned loss, the lookup, resharding and restoring
    torch.cuda.empty_cache()
    mesh_phase(dev, lm_layers, lm_prompt, serve)
    del serve
    lap("mesh")

    # the dry-run cells on the card: a decode cell, BERT4Rec's serve cell
    # on the recsys_gnn phase's serve, DimeNet's partitioned train cell
    torch.cuda.empty_cache()
    cells_phase(dev, b4r)
    del b4r
    lap("cells")
    log("phase walls s: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      walls.items()))
    return card, rows


def run_alone(phase, lm_layers, lm_prompt, n_docs=None, profile=False,
              n_batches=8):
    """``--only``: the card line, the kernels' build, then ``phase`` alone
    with its wall; no result line.  ``fit`` builds the shard of ``n_docs``
    docs beside the kernels (as the full run does) and runs step 2 and the
    fit's kernel rows of step 6 (``profile``: step 2's profiled fit);
    ``predict`` runs the serving CLI's labelled fit (step 9's ``serve.run``,
    without its CPU cross-checks) and then step 10; ``stage0`` runs step
    16a on its own shard of ``n_docs`` docs (``stage0_alone``)."""
    import torch
    from repro_torch import kernels
    print(card_line(), flush=True)
    dev = torch.device(DEVICE)
    if phase == "stage0":
        t = time.perf_counter()
        stage0_alone(dev, n_docs, n_batches)
        log(f"stage0 alone: {time.perf_counter() - t:.1f} s")
        return 0
    if phase == "fit":
        spec, corpus, index, _, layouts = build_shard(n_docs, 1)
        t = time.perf_counter()
        _, _, launches, calls, _ = fit_phase(spec, index, corpus, dev,
                                             layouts, profile)
        rows = fit_kernel_phase(calls)
        for name in ("level_histogram",) + LEVEL_KERNELS:
            rows[name]["launches"] = launches[name]
            log(f"row {json.dumps(rows[name])}")
        log(f"fit alone: {time.perf_counter() - t:.1f} s")
        return 0
    t = time.perf_counter()
    kernels.extension()
    log(f"kernels built in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    if phase == "predict":
        from repro_torch.launch import serve
        card = serve.run(["--device", str(dev)], say=lambda line: None)
        log(f"predict: the CLI's run (labels and fit) "
            f"{time.perf_counter() - t:.1f} s; walls s: "
            + ", ".join(f"{k} {v:.2f}" for k, v in card.walls.items()))
        predict_phase(card, dev)
    elif phase == "mesh":
        mesh_phase(dev, lm_layers, lm_prompt)
    elif phase == "train":
        train_phase(dev, lm_layers, lm_prompt)
    elif phase == "cells":
        cells_phase(dev)
    else:
        recsys_gnn_phase(dev)
    log(f"{phase} alone: {time.perf_counter() - t:.1f} s")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=196_608)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--lm-layers", type=int, default=32,
                    help="Yi-6B layers served in the LM phase; below 32, "
                         "also the most layers of each MoE and MLA model")
    ap.add_argument("--lm-prompt", type=int, default=LM_PROMPT,
                    help="prompt tokens a request in the LM phase (and at "
                         "most, in the MoE and MLA phase)")
    ap.add_argument("--lm-steps", type=int, default=LM_STEPS,
                    help="greedy decode steps in the LM phase (and at "
                         "most, in the MoE and MLA phase)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile the LM steps and a fit "
                         "(torch.profiler)")
    ap.add_argument("--only", choices=("fit", "predict", "train",
                                       "recsys_gnn", "mesh", "cells",
                                       "stage0"),
                    help="build the kernels and run this phase alone; "
                         "prints no result")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        log("FAIL: src/repro_torch not found: run from a checkout's root")
        return 2
    try:
        import torch
    except ImportError:
        log("FAIL: PyTorch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device")
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if args.only:
            return run_alone(args.only, args.lm_layers, args.lm_prompt,
                             args.n_docs, args.profile, args.batches)
        card, rows = run(args.n_docs, args.batches, args.lm_layers,
                         args.lm_prompt, args.lm_steps, args.profile)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    log(f"total elapsed {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rows[n] for n in KERNELS]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
