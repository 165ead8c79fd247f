"""The yardstick's bytes for the first-stage and Stage-2 kernels, counted
from a query's inputs (its terms' postings, their impacts and block
maxima, the candidates), never from the program's tile layout.

Each input byte is counted once and each output byte once:

* JASS (kernel 1): the postings at or above the query's impact cut, a
  4-byte doc id and a 1-byte impact each, and the top k written as a
  4-byte id and a 4-byte score each.
* BMW (kernel 2): the query terms' block maxima, a 4-byte block id and a
  4-byte bound each, the postings of the blocks Block-Max WAND keeps
  (4-byte doc id, 4-byte float32 score), and the top k written.
* Stage-2 (kernel 3): the candidate ids, the postings a candidate's three
  sums need (the query terms' postings once, or a binary search of each
  term's postings a candidate, whichever reads less) and three 4-byte
  sums written a candidate.

The least time is these bytes at the H100 SXM's 3.35 TB/s (the kernels
do integer and float additions and compares, a few per byte, far below
any compute roof).
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA's data sheet
ID_BYTES = 4
SCORE_BYTES = 4
IMPACT_BYTES = 1


def topk_out(k: int) -> int:
    return k * (ID_BYTES + SCORE_BYTES)


def jass_bytes(work, k: int) -> float:
    """Kernel 1's bytes for queries whose impact cut takes ``work``
    postings each."""
    w = np.asarray(work, np.float64)
    return float((w * (ID_BYTES + IMPACT_BYTES)).sum() + len(w) * topk_out(k))


def bmw_bytes(block_entries, kept_postings, k: int) -> float:
    """Kernel 2's bytes for queries with ``block_entries`` (term, block)
    bounds and ``kept_postings`` postings in the blocks BMW keeps."""
    b = np.asarray(block_entries, np.float64)
    p = np.asarray(kept_postings, np.float64)
    return float((b * (ID_BYTES + SCORE_BYTES)
                  + p * (ID_BYTES + SCORE_BYTES)).sum()
                 + len(b) * topk_out(k))


def stage2_bytes(dfs, n_cand: int) -> float:
    """Kernel 3's bytes for queries whose terms have postings counts
    ``dfs`` ((Q, L), 0 for a padded slot), each with a grid of ``n_cand``
    candidates."""
    df = np.asarray(dfs, np.float64)
    scan = df.sum(1) * (ID_BYTES + SCORE_BYTES)
    steps = np.where(df > 0, np.ceil(np.log2(df + 1.0)), 0.0).sum(1)
    search = n_cand * (steps * ID_BYTES + (df > 0).sum(1) * SCORE_BYTES)
    per_q = (np.minimum(scan, search) + n_cand * ID_BYTES
             + n_cand * 3 * SCORE_BYTES)
    return float(per_q.sum())
