"""Stage-0 pre-retrieval feature extraction (147 features).

Following Culpepper et al. [16] and the paper: for each query term we read
aggregate statistics of its postings-list *scores* under six similarity
functions (TF·IDF, BM25, query likelihood, Bose-Einstein, DPH, DFR/PL2) —
{max, arithmetic mean, geometric mean, harmonic mean, median, std} — and
aggregate each statistic over the query terms with {max, min, mean, variance},
giving 6 × 6 × 4 = 144 features, plus 3 query-level features (query length,
log total document frequency, log min document frequency) = 147.

The per-term statistics are precomputed at index-build time into a dense
``(vocab, 36)`` table, so query featurization is a gather + masked reduce.

Exactness: the Stage-0 GBRTs bin these features with ``x > edge`` against
edges that are quantiles of the reference's own features, so a one-ulp
difference can flip a bin, a leaf and then a route.  ``extract`` therefore
keeps the reference's float32 arithmetic step for step: the reductions
over query terms run left to right, as the reference's compiled sums do,
and ``log1p`` is ``xla_log1p``, the float32 polynomial the reference's
compiled program evaluates (not the platform's ``log1p``, which differs in
the last bit on about 1 % of inputs).  ``xla_exp`` and ``xla_expm1`` do
the same for the compiled ``exp`` and ``expm1`` that the distributed ISN
step (``isn/shard``) applies to its Stage-0 predictions: one ulp there
flips a route or the integer part of ρ.  On the card ``extract`` is one
launch of the ``stage0_features`` kernel (``kernels/stage0``), which takes
the same steps; on the CPU it runs the kernel's plain version, the torch
sequence of those steps.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.stage0 import ops as s0
from repro_torch.serving.telemetry.host import span

N_SIMS = 6
N_STATS = 6
N_TERM_FEATURES = N_SIMS * N_STATS        # 36
N_QUERY_AGGS = 4
N_FEATURES = N_TERM_FEATURES * N_QUERY_AGGS + 3   # 147

SIM_NAMES = ("tfidf", "bm25", "ql", "bose_einstein", "dph", "pl2")
STAT_NAMES = ("max", "amean", "gmean", "hmean", "median", "std")

# the compiled program's float32 functions, beside the kernels that
# evaluate them on the card
xla_log = s0.xla_log
xla_log1p = s0.xla_log1p
xla_exp = s0.xla_exp
xla_expm1 = s0.xla_expm1


@span("stage0.features")
def extract(term_stats: torch.Tensor, term_df: torch.Tensor,
            query_terms: torch.Tensor, query_mask: torch.Tensor
            ) -> torch.Tensor:
    """Featurize a batch of queries.

    Args:
      term_stats: (V, 36) float32 per-term score statistics.
      term_df: (V,) document frequencies.
      query_terms: (Q, L) padded term ids.
      query_mask: (Q, L) 1.0 for real terms.
    Returns:
      (Q, 147) float32 feature matrix.
    """
    return s0.stage0_features(term_stats, term_df, query_terms, query_mask)
