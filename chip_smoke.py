#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # the full run, on the first GPU

It imports nothing of JAX and nothing of the JAX package ``repro``.  In
order, it

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   kernels from the sources under ``src/repro_torch``, in a thread while
   the host builds the corpus and the index of step 2: one for each of the
   nine TPU kernels, kernels 8 and 9 each with a bf16 kernel on the tensor
   cores and an fp32 one on the CUDA cores, and the fit's two;
2. builds the ``paper_200ms`` cascade at one shard of 196,608 docs (the
   per-chip shard of the paper's ISN deployment) on the card and on the
   CPU from one host layout of the shard (``postings.shard_layouts``, built
   once and copied to each device; ``hybrid_fusion``'s two systems of step
   5 take it too) and fits each on its own device (``SearchSystem.fit`` from 4,096
   queries, seed 5: three Stage-0 quantile GBRTs and the LTR GBRT, the
   routing thresholds from the 60th/75th percentiles of the predictions),
   the card's fit counted from 0 and its ``level_histogram`` and
   ``boost_update`` calls recorded; requires the four forests (feat,
   thresh, leaf, base, bin edges) and ``t_k``/``t_time`` bit-equal, and
   prints both fit walls (``--profile``: one more card fit under the
   profiler, host time per fit stage);
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
   lanes whose order changes the sum, tile_d 48, every tile empty) and
   times the kernel, its plain version and, where one exists, the
   library call with CUDA events; for the redesigned kernels (1–7 and 9)
   it logs the wrapper's time beside the device time of a call
   (``torch.profiler``) and the earlier design's time, for kernels 4, 6
   and 7 the device times of the kernel and of its library call (kernel 7:
   a stable ``torch.sort``, whose first k it checks against the kernel's
   on the recorded accumulator), and kernel 7's histogram alone beside
   ``torch.bincount``; ``level_histogram`` against its plain version
   (tolerance 0.0) on a sample of the card fit's calls, its largest call
   and edge cases (a constant feature, rows of weight 0, n off the tile,
   1 to 32 nodes, 256 bins), timed beside the plain version and an fp32
   ``index_add_`` (float atomics; how many of its sums differ from the
   ordered ones is logged), and ``boost_update`` against its plain
   version;
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
   (QR must launch ``level_histogram`` and ``boost_update``, RF
   ``level_histogram`` alone); prints each method's ``regression_report``
   (tail quantile 0.95) as ``benchmarks/bench_predict_time.py`` renders
   it, and the walls; fits fold 0 of each method again on the CPU from
   the same rows and requires the QR and RF forests and predictions
   bit-equal to the card's and LR's within 1e-5 of max(1, |prediction|);
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
14. LM phase (Yi-6B, the prefill and KV-cache decode serving path), once
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
      groups 1/4/8, head widths 16-128, fp32 and bf16, the bf16 kernel's
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
      own.  Tolerances: fp32
      1e-5 absolute on the edge cases, 5e-3 of the largest output (and
      1e-5 of it on average) on the recorded fp32 model calls (the same
      near-ties); bf16 2e-2 absolute below magnitude 1 and 2e-2 relative
      above it (a one-ulp rounding flip is 2^-8 to 2^-7 relative);
15. prints the total elapsed time, the ``kernels`` JSON line (ten rows:
    the nine TPU kernels and ``level_histogram``; the launches of kernels
    1-3 are step 7's; the library time of kernels 1 and 2 an
    ``index_add_`` over the (query, lane) pairs each adds), then the card
    line, then the result.

Any failed check exits non-zero without the result line.  ``--n-docs``
and ``--batches`` shrink the retrieval phases for a quick check,
``--lm-layers``, ``--lm-prompt`` and ``--lm-steps`` the LM phase;
``--profile`` adds a ``torch.profiler`` breakdown of one more served batch
of each preset (wall, device busy time, host time per cascade stage,
busiest device kernels) and of one more LM prefill and decode step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    # the fit's split histograms: no TPU kernel, but a float scatter-add
    # whose order the card must keep (ROADMAP rule d)
    "level_histogram": dict(
        source="src/repro_torch/kernels/level_histogram/level_histogram.cu",
        replaces="src/repro/core/trees.py:69 (jax.ops.segment_sum; no "
                 "Pallas kernel)"),
}
# the kernels of the per-query Stage-1 path (saat/daat_serve_laxmap), and
# those of the two served cascades
LAXMAP_KERNELS = ("impact_accumulate_bucketed", "blockmax_score_bucketed",
                  "score_histogram")
LM_KERNELS = ("flash_attention", "flash_decode")
FIT_KERNELS = ("level_histogram", "boost_update")
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
                      if n not in LAXMAP_KERNELS + LM_KERNELS + FIT_KERNELS)
RETRIEVAL_KERNELS = SERVE_KERNELS + LAXMAP_KERNELS

# LM phase (Yi-6B)
XC_PROMPTS, XC_LEN, XC_STEPS = 2, 1024, 8     # card-vs-CPU cross-check
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 4096, 32   # the bf16 serve
DECODE_ROOM = 512             # cache positions past the prompt (4,608)
XC_LOGIT_TOL = 1e-4           # of the largest |logit|, from one cache
XC_CACHE_TOL, XC_CACHE_MEAN_TOL = 1e-3, 1e-5  # of the largest |cache|
MODEL_F32_TOL = 5e-3          # of the largest |output|, recorded fp32 calls
BF16_TOL = 2e-2               # below magnitude 1 absolute, above relative
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
    return {"impact_accumulate_batched": ia, "blockmax_score_batched": bm,
            "qd_feature_gather_lanes": qd, "dense_topk_tiles": dt,
            "impact_accumulate_bucketed": ia, "blockmax_score_bucketed": bm,
            "score_histogram": sh, "flash_attention": fa,
            "flash_decode": fa, "level_histogram": lh, "boost_update": lh}


class Recorder:
    """Records the arguments of every call of the named kernel wrappers (the
    main path's real inputs) while passing the call through; with
    ``largest``, only the call that moves the most bytes is kept, with
    ``first`` only the first; ``clone`` records copies of the tensors (the
    KV cache is written in place later)."""

    def __init__(self, names=SERVE_KERNELS, largest=False, first=False,
                 clone=False):
        mods = kernel_modules()
        self.sites = {name: mods[name] for name in names}
        self.calls = {name: [] for name in self.sites}
        self.largest, self.first, self.clone = largest, first, clone
        self.orig = {}

    def _copy(self, args):
        import torch
        if not self.clone:
            return args
        return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args)

    def __enter__(self):
        for name, mod in self.sites.items():
            fn = getattr(mod, WRAPPERS.get(name, name))
            self.orig[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kw):
                calls = self.calls[_name]
                if not (self.first and calls):
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
    read once and the output written once; 4·D operations (two FMAs) per
    (query, key) pair it must score — the pairs on or below the diagonal
    when causal.  Decode: the cache positions below kv_len (k and v) read
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
        sk = k.shape[2]
        pairs = (b * h * sq * (sq + 1) // 2 if kw.get("causal", True)
                 else b * h * sq * sk)
        return el * (2 * q.numel() + k.numel() + v.numel()), 4 * pairs * d, \
            rate
    _, k, v, kv_len = args
    b, h, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    valid = int(kv_len.long().clamp(0, t).sum())
    return (el * (2 * valid * hkv * d + 2 * q.numel()) + 4 * b,
            4 * h * d * valid, rate)


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
    written once; two fp32 adds per (row, feature)."""
    import torch
    if name == "level_histogram":
        xbt, node, gw, w = args
        n_feat, n = xbt.shape
        cells = kw["n_nodes"] * n_feat * kw["n_bins"]
        return (n_feat * n + 12 * n + 8 * cells, 2 * n * n_feat,
                FP32_FLOPS_PER_S)
    if name in LM_KERNELS:
        return lm_work(name, args, kw)
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


def profile_batch(system, terms, mask, topics):
    """One more served batch under ``torch.profiler``: wall time, device
    busy time, host time per cascade stage, and the busiest device
    kernels."""
    from torch.profiler import record_function

    stages = ("stage0", "_stage1_full", "stage2") + (
        ("_stage1_dense",) if system.dense is not None else ())
    for name in stages:
        def timed(*a, _fn=getattr(system, name), _name=name, **kw):
            with record_function(f"stage:{_name}"):
                return _fn(*a, **kw)
        setattr(system, name, timed)
    try:
        prof, wall_ms = run_profiled(lambda: system.serve(terms, mask,
                                                          topics))
    finally:
        for name in stages:
            delattr(system, name)
    log_profile(prof, wall_ms)


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


def lm_cross_check(dev, xc_len):
    """A 2-layer Yi-6B at full width in fp32, drawn on the host, on the card
    and on the CPU: prefill of 2 prompts and ``XC_STEPS`` greedy steps on
    each, and the card's steps once more from the CPU's prefill cache and
    tokens, which separates the decode path's own error from what it
    inherits from the caches (module docstring, 8a).  Every number is
    logged before any check.  Returns the card's recorded kernel calls."""
    import numpy as np
    import torch
    from repro_torch.configs import yi_6b
    from repro_torch.models import transformer as tr
    c = dataclasses.replace(yi_6b.CONFIG, n_layers=2, dtype="float32")
    t = time.perf_counter()
    host = tr.init(c, seed=SEED, device="cpu")
    card = tree_to(host, dev)
    log(f"LM cross-check: 2-layer Yi-6B fp32, {c.param_count()} parameters, "
        f"drawn on the host and copied in {time.perf_counter() - t:.1f} s")
    toks = np.random.RandomState(SEED).randint(0, c.vocab,
                                               (XC_PROMPTS, xc_len))
    toks = torch.from_numpy(toks)
    with Recorder(LM_KERNELS, clone=True) as rec:
        a_outs, a_fed, a_cache, a_prefill, _ = greedy(card, c, toks.to(dev),
                                                      XC_STEPS)
    t = time.perf_counter()
    logits, cache, _ = prefill_padded(host, c, toks)
    start = {k: v.clone() for k, v in cache.items()}
    b_outs, b_fed, b_cache, _ = decode_greedy(host, c, logits, cache, xc_len,
                                              XC_STEPS)
    log(f"LM cross-check: card prefill {a_prefill:.3f} s (first call), CPU "
        f"prefill and {XC_STEPS} steps {time.perf_counter() - t:.1f} s")
    iso_outs, _, _, _ = decode_greedy(card, c, logits.to(dev),
                                      tree_to(start, dev), xc_len, XC_STEPS,
                                      feed=b_fed)
    e_prefill = _rel_err(a_outs[0], logits)
    e_own = [_rel_err(x, y) for x, y in zip(a_outs[1:], b_outs)]
    e_iso = [_rel_err(x, y) for x, y in zip(iso_outs, b_outs)]
    same = [torch.equal(x.cpu(), y) for x, y in zip(a_fed, b_fed)]
    log(f"LM cross-check: logits error over their largest magnitude: "
        f"prefill {e_prefill:.3e}; steps from each device's own cache "
        + " ".join(f"{e:.3e}" for e in e_own)
        + "; steps from the CPU's cache " + " ".join(f"{e:.3e}" for e in e_iso))
    cache_errs = {}
    for key in ("k", "v"):
        y = b_cache[key]
        d = (a_cache[key].cpu() - y).abs()
        top = float(y.abs().max())
        cache_errs[key] = (float(d.max()) / top, float(d.mean()) / top)
        log(f"LM cross-check: {key} cache max error {cache_errs[key][0]:.3e},"
            f" mean {cache_errs[key][1]:.3e} of its largest magnitude "
            f"{top:.2f}")
    log(f"LM cross-check: greedy tokens equal per step {same} "
        f"({[x.tolist() for x in a_fed]})")
    check(e_prefill <= XC_LOGIT_TOL, f"LM cross-check: prefill logits differ "
          f"by {e_prefill} of their largest magnitude")
    check(max(e_iso) <= XC_LOGIT_TOL, "LM cross-check: decode logits from "
          "the same cache differ beyond the tolerance")
    check(max(e_own) <= XC_CACHE_TOL, "LM cross-check: decode logits from "
          "each device's cache differ beyond the caches' tolerance")
    check(all(same), "LM cross-check: greedy tokens differ")
    for key, (e, mean) in cache_errs.items():
        check(e <= XC_CACHE_TOL and mean <= XC_CACHE_MEAN_TOL,
              f"LM cross-check: {key} cache differs by {e} (mean {mean})")
    return rec.calls


def lm_serve(dev, n_layers, prompt, steps, profile=False):
    """Yi-6B (``n_layers`` of it) in bf16 on the card: a warm-up pass
    (prefill of ``LM_BATCH`` prompts, ``steps`` greedy steps) that records
    layer 0's kernel calls, then the counted pass (module docstring, 8b);
    with ``profile``, one more prefill and one more step under
    ``torch.profiler``.  Returns (launches of the counted pass, the
    recorded calls)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import yi_6b
    from repro_torch.models import transformer as tr
    c = dataclasses.replace(yi_6b.CONFIG, n_layers=n_layers)
    t = time.perf_counter()
    params = tr.init(c, seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"LM serve: Yi-6B, {n_layers} layers, bf16, {c.param_count()} "
        f"parameters drawn on the card in {time.perf_counter() - t:.1f} s; "
        f"{torch.cuda.memory_allocated()} B in use")
    toks = np.random.RandomState(SEED + 1).randint(0, c.vocab,
                                                   (LM_BATCH, prompt))
    toks = torch.from_numpy(toks).to(dev)
    with Recorder(LM_KERNELS, first=True, clone=True) as rec:
        warm = greedy(params, c, toks, steps)
    log(f"LM serve: warm-up prefill {warm[3]:.3f} s, first step "
        f"{1e3 * warm[4][0]:.2f} ms")
    del warm
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    outs, fed, cache, t_prefill, walls = greedy(params, c, toks, steps)
    launches = dict(kernels.LAUNCHES)
    log(f"LM serve: launches {launches}")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          "LM serve: non-finite logits")
    check(launches["flash_attention"] == n_layers,
          f"LM serve: flash_attention launched {launches['flash_attention']}"
          f" times, not once a layer ({n_layers})")
    check(launches["flash_decode"] == n_layers * steps,
          f"LM serve: flash_decode launched {launches['flash_decode']} "
          f"times, not once a layer and step ({n_layers * steps})")
    med = statistics.median(walls)
    log(f"LM serve: prefill {LM_BATCH} x {prompt} tokens in "
        f"{t_prefill:.4f} s ({LM_BATCH * prompt / t_prefill:.0f} tokens/s)")
    log(f"LM serve: decode ms per step ({LM_BATCH} sequences, cache "
        f"{prompt + DECODE_ROOM}): "
        + " ".join(f"{1e3 * w:.2f}" for w in walls)
        + f" (median {1e3 * med:.3f}, {LM_BATCH / med:.1f} tokens/s)")
    log(f"LM serve: device memory {torch.cuda.memory_allocated()} B in use, "
        f"{torch.cuda.max_memory_allocated()} B peak in the counted pass; "
        f"cache {sum(v.numel() * v.element_size() for v in cache.values())} "
        f"B; last greedy tokens {fed[-1].tolist()}")
    if profile:
        prof, wall = run_profiled(lambda: tr.prefill(params, c, toks))
        log_profile(prof, wall, "profile LM prefill")
        nxt = outs[-1][:, :c.vocab].argmax(dim=-1).to(torch.int32)
        kv = torch.full((LM_BATCH,), prompt + steps, dtype=torch.int32,
                        device=dev)
        prof, wall = run_profiled(lambda: tr.decode_step(params, c, nxt,
                                                         cache, kv))
        log_profile(prof, wall, "profile LM decode step")
    return launches, rec.calls


def lm_edge_calls(dev):
    """Seeded edge inputs of the two attention kernels, drawn on the card:
    ragged S (200, 700) causal and not, Sq != Sk, GQA groups 1, 4 and 8,
    head widths 16 to 128, fp32 and bf16, a strided q/k/v as the model
    passes them; in bf16 also the tensor-core kernel's 128-row and 128-key
    tile edges (S = 1, 127, 128, 129, 4,097), D = 16 and 128, Sq != Sk and
    a strided GQA-8 view; for decode ragged T, kv_len 0, 1, 512, 513 and T,
    GQA groups 1 to 32 and head widths 16 to 128 in both types, and
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
            (1, 8, 2, 100, 300, 128, bf16, False)):
        prefill.append(((randn((b, h, sq, d), dt, 0.4),
                      randn((b, hkv, sk, d), dt, 0.4),
                      randn((b, hkv, sk, d), dt)), dict(causal=causal)))
    # (B, S, H, D) viewed as (B, H, S, D), as the model passes q, k, v
    for b, s, h, hkv, d, dt in ((1, 300, 8, 2, 64, f32),
                                (2, 300, 32, 4, 128, bf16)):
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
            (2, 8, 8, 64, 16, bf16, (64, 0))):
        decode.append(((randn((b, h, d), dt, 0.4),
                     randn((b, hkv, t, d), dt, 0.4), randn((b, hkv, t, d), dt),
                     torch.tensor(lens, dtype=torch.int32, device=dev)), {}))
    return {"flash_attention": prefill, "flash_decode": decode}


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
    oracle; raises beyond the stated tolerance (module docstring, 8c)."""
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
    """Rows of kernels 8 and 9 (module docstring, 8c): every recorded call
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
        for args, kw in calls:
            got = kern[name](*args, **kw)
            want = plain[name](*args, **kw)
            torch.cuda.synchronize()
            if got.dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, bf16_rel_err(got, want))
            errs[got.dtype] = max(
                errs[got.dtype], compare_attention(name, got, want, True),
                tc_plain_error(name, got, args, kw),
                split_merge_error(name, got, args, kw, True))
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
        if name == "flash_attention":
            log(f"flash_attention bf16: worst error of max(1, |want|) over "
                f"the recorded and edge calls {worst_bf16}")
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


def lm_phase(dev, n_layers, prompt, steps, profile=False):
    """The LM phase (module docstring, 8): cross-check, serve, kernel rows.
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
    builder, its leaf values, the level histograms and the boosting update
    inside them, the LTR set), the busiest device kernels."""
    from torch.profiler import record_function
    from repro_torch.core import features, gbrt, trees
    from repro_torch.kernels.level_histogram import ops as lh
    from repro_torch.serving import system as system_mod
    from repro_torch.serving.system import build_system
    sites = [(features, "extract"), (trees, "build_tree"),
             (gbrt, "_leaf_values"), (lh, "level_histogram"),
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
    FIT_QUERIES queries on the card (counted from 0, every kernel call
    recorded) and on the CPU (plain versions), both systems built from the
    shard's shared host ``layouts``; requires the four forests and the
    routing thresholds bit-equal.  With ``profile``, one more card fit
    under the profiler.  Returns (card system, CPU system, launches,
    recorded calls, the query log)."""
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
    with Recorder(FIT_KERNELS) as rec:
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
    if profile:
        profile_fit(spec, index, corpus, ql, dev)
    return gpu, cpu, launches, rec.calls, ql


def level_histogram_edge_calls(device):
    """Seeded edge cases: a constant feature (every row in one bin, also at
    depth 0 where one cell takes every row), rows of weight 0, n not a
    multiple of the 1,024-row tile (37, 1,000, 1,025, 4,097), depth 1 and
    depth 5 levels (1 and 16 nodes), 32 nodes (two blocks of cells a
    feature), 256 bins."""
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
            call(1025, 147, 16), call(4097, 3, 32), call(600, 4, 4, 256)]


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
    """``level_histogram`` against its plain version (tolerance 0.0) on a
    sample of the card fit's own calls, its largest and the edge cases,
    timed beside the plain version and ``index_add_`` (whose sums are
    counted where they differ from the ordered ones); ``boost_update``
    against its plain version on a sample of its calls.  Returns the
    ``level_histogram`` row."""
    import torch
    from repro_torch.kernels.level_histogram import ops as lh
    hist = calls["level_histogram"]
    check(hist, "level_histogram: the fit never called it")
    largest = max(hist, key=lambda c: work_of("level_histogram", *c)[0])
    dev = largest[0][0].device
    edges = level_histogram_edge_calls(dev)
    sample = hist[::40] + [largest]
    err = 0.0
    for args, kw in sample + edges:
        got = lh.level_histogram(*args, **kw)
        want = lh.level_histogram_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, compare("level_histogram", got, want, 0.0))
    args, kw = largest
    note = (f"{len(sample)} of the fit's {len(hist)} calls and "
            f"{len(edges)} edge cases checked; (nodes, F, n) = "
            f"({kw['n_nodes']}, {args[0].shape[0]}, {args[0].shape[1]})")
    row = kernel_row("level_histogram", lh.level_histogram,
                     lh.level_histogram_plain, index_add_histograms, args, kw,
                     err, note)
    want = torch.stack(lh.level_histogram(*args, **kw), dim=-1).reshape(-1, 2)
    lib = index_add_histograms(args, kw)
    diff = [int((lib() != want).any(dim=1).sum()) for _ in range(REPS)]
    kern = lambda: lh.level_histogram(*args, **kw)
    log(f"kernel level_histogram: device {device_ms(kern, REPS)} ms a call, "
        f"index_add_ device {device_ms(lib, REPS)} ms (profiler); "
        f"index_add_'s sums differ from the ordered ones in {diff} of "
        f"{want.shape[0]} cells over {REPS} calls")
    boost = calls["boost_update"]
    for args, kw in boost[::16] + boost[-1:]:
        got = lh.boost_update(*args, **kw)
        torch.cuda.synchronize()
        compare("boost_update", got, lh.boost_update_plain(*args, **kw), 0.0)
    log(f"kernel boost_update: {len(boost[::16]) + 1} of the fit's "
        f"{len(boost)} calls equal to the plain version (tolerance 0.0)")
    return row


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
        want = {"qr": (True, True), "rf": (True, False),
                "lr": (False, False)}[method]
        for name, launched in zip(FIT_KERNELS, want):
            check((launches[name] > 0) == launched,
                  f"predict {method}: {launches[name]} {name} launches")
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


def run(n_docs, n_batches, lm_layers, lm_prompt, lm_steps, profile=False):
    import torch
    from repro_torch import kernels
    from repro_torch.configs.cascade_presets import get_preset
    from repro_torch.configs.two_tower_retrieval import REDUCED
    from repro_torch.index.builder import build_index
    from repro_torch.index.corpus import (CorpusParams, build_corpus,
                                          build_queries)
    from repro_torch.index.postings import shard_layouts
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
    build_thread.join()
    if "error" in built:
        raise built["error"]
    log(f"kernels built in {built['s']:.1f} s, beside the host build")
    ql = build_queries(corpus, n_batches * BATCH, stop_k=spec.index.stop_k)
    # the shard's host layout, built once: the card and CPU systems of the
    # fit and of hybrid_fusion each copy it to their device
    t = time.perf_counter()
    layouts = shard_layouts(index, spec.deploy.n_shards, spec.index.tile_d)
    log(f"host layout of the shard: {time.perf_counter() - t:.1f} s, shared "
        "by the four systems built from it")
    lap("build")

    # fit: the card's and the CPU's systems, each fitted on its own device
    gpu, cpu, fit_launches, fit_calls, fit_ql = fit_phase(
        spec, index, corpus, dev, layouts, profile)
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
    del cpu_h, layouts
    recorded["dense_topk_tiles"] = rec_h.calls["dense_topk_tiles"]

    lap("cross-checks")
    rows = kernel_phase(recorded)
    for name in LAXMAP_KERNELS:
        rows[name]["launches"] = lax_launches[name]
    rows["level_histogram"] = fit_kernel_phase(fit_calls)
    rows["level_histogram"]["launches"] = fit_launches["level_histogram"]
    del fit_calls

    # serve phases: each preset's main path, counted on its own
    launches, routes, _ = serve_phase(gpu, ql, n_batches, n_docs, spec)
    check(routes["jass"] > 0 and routes["bmw"] > 0,
          "paper_200ms serve: both routes must take queries")
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
    if profile:
        for system in (gpu, gpu_h):
            log(f"profile of {system.cascade_spec.name}:")
            profile_batch(system, ql.terms[sl], ql.mask[sl], ql.topic[sl])
    lap("kernels and serve")

    # the BENCH_tail flow, fitted and served on its own collection
    del gpu, gpu_h, recorded, lax_calls, rec, rec_h
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
    del served, cli_cpu
    lap("faults")

    # the LM serving path, with the retrieval systems freed
    torch.cuda.empty_cache()
    rows.update(lm_phase(dev, lm_layers, lm_prompt, lm_steps, profile))
    lap("lm")
    log("phase walls s: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      walls.items()))
    return card, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=196_608)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--lm-layers", type=int, default=32,
                    help="Yi-6B layers served in the LM phase")
    ap.add_argument("--lm-prompt", type=int, default=LM_PROMPT,
                    help="prompt tokens a request in the LM phase")
    ap.add_argument("--lm-steps", type=int, default=LM_STEPS,
                    help="greedy decode steps in the LM phase")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one served batch (torch.profiler)")
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
