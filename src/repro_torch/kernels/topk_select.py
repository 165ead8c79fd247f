"""The shared exact top-k select of kernels 6 and 7, in PyTorch.

``dense_topk.cu`` (pass 2) and ``score_histogram.cu`` select the k largest
of a row of 32-bit keys, ties to the lower index, with one thread-block
cluster a row (``topk_select.cuh``): radix rounds of ``DIGIT_BITS`` bits
for the k-th key K, each block counting the keys of its contiguous index
range; then an ordered compaction in which every key above K is taken at
its block's offset and keys equal to K are taken in index order up to k;
then a sort of the selection.  The kernels' plain twins
(``dense_topk_selected``, ``histogram_topk_selected``) run these steps here;
they run in the tests and in ``chip_smoke.py`` only.  Keys are int64
tensors holding values in [0, 2^32).
"""

from __future__ import annotations

import torch

CLUSTER = 8        # blocks of a cluster, each a contiguous index range
DIGIT_BITS = 8     # bits of a radix round
ROUNDS = 32 // DIGIT_BITS
MAX_K = 2048       # the selection lives in one block's shared memory


def block_of(n: int, device) -> torch.Tensor:
    """(n,) the cluster block that owns each index: ranges of
    ceil(n / CLUSTER), in order (``topk_select::block_range``)."""
    per = max(1, -(-n // CLUSTER))
    return torch.arange(n, device=device) // per


def radix_kth(keys: torch.Tensor, k: int):
    """Per row of the (R, n) keys, the k-th largest key K, and per block of
    the cluster the count of its keys above K and equal to K: ((R,),
    (R, CLUSTER), (R, CLUSTER)), all int64.  Round r histograms digit r of
    the keys that match the digits chosen so far, block by block, and takes
    the bin that holds the k_rem-th largest; a block's keys above K are its
    bins above the chosen digit, summed over the rounds."""
    r_, n = keys.shape
    nb = CLUSTER
    dev = keys.device
    cell = (torch.arange(r_, device=dev)[:, None] * nb
            + block_of(n, dev)[None, :]) * (1 << DIGIT_BITS)
    digits = torch.arange(1 << DIGIT_BITS, device=dev)
    prefix = torch.zeros(r_, dtype=torch.int64, device=dev)
    k_rem = torch.full((r_,), k, dtype=torch.int64, device=dev)
    above = torch.zeros((r_, nb), dtype=torch.int64, device=dev)
    for r in range(ROUNDS):
        shift = 32 - DIGIT_BITS * (r + 1)
        match = ((keys ^ prefix[:, None]) >> (shift + DIGIT_BITS)) == 0
        digit = (keys >> shift) & ((1 << DIGIT_BITS) - 1)
        hist = torch.zeros(r_ * nb << DIGIT_BITS, dtype=torch.int64,
                           device=dev)
        idx = (cell + digit)[match]
        hist.index_add_(0, idx, torch.ones_like(idx))
        hist = hist.view(r_, nb, 1 << DIGIT_BITS)
        tot = hist.sum(dim=1)
        ge = tot.flip(1).cumsum(1).flip(1)
        d = ((ge - tot < k_rem[:, None]) & (ge >= k_rem[:, None])).to(
            torch.int8).argmax(dim=1)
        k_rem = k_rem - (ge - tot).gather(1, d[:, None])[:, 0]
        above += (hist * (digits > d[:, None])[:, None, :]).sum(dim=2)
        prefix = prefix | (d << shift)
    eq = hist.gather(2, d.view(r_, 1, 1).expand(r_, nb, 1))[..., 0]
    return prefix, above, eq


def select(keys: torch.Tensor, k: int, kth: torch.Tensor,
           above: torch.Tensor, eq: torch.Tensor):
    """The ordered compaction and the final sort: per row of the (R, n)
    keys, the k selected (keys, indices), key descending, index ascending.
    ``kth``, ``above`` and ``eq`` are ``radix_kth``'s (or the histogram's)
    K and per-block counts, (R, CLUSTER).  Block b places its keys
    above K from the count above in the blocks before it, in index order,
    and its keys equal to K after all the keys above, from the count equal
    in the blocks before it, while that rank is below k minus the count
    above."""
    r_, n = keys.shape
    dev = keys.device
    blk = block_of(n, dev)
    start = torch.searchsorted(blk, torch.arange(CLUSTER, device=dev))
    start = start.clamp(max=max(n - 1, 0))

    def rank_in_block(flag):
        before = torch.cumsum(flag, dim=1) - flag      # in the row
        return before - before.gather(1, start[blk].expand(r_, n))

    is_a = (keys > kth[:, None]).to(torch.int64)
    is_e = (keys == kth[:, None]).to(torch.int64)
    a_before = torch.cumsum(above, dim=1) - above
    e_before = torch.cumsum(eq, dim=1) - eq
    a_total = above.sum(dim=1, keepdim=True)
    blk = blk.expand(r_, n)
    pos_a = a_before.gather(1, blk) + rank_in_block(is_a)
    e_rank = e_before.gather(1, blk) + rank_in_block(is_e)
    take_e = (is_e > 0) & (e_rank < k - a_total)
    sel_key = torch.full((r_, k), -1, dtype=torch.int64, device=dev)
    sel_idx = torch.full((r_, k), -1, dtype=torch.int64, device=dev)
    for take, pos in ((is_a > 0, pos_a), (take_e, a_total + e_rank)):
        row, i = torch.nonzero(take, as_tuple=True)
        sel_key[row, pos[row, i]] = keys[row, i]
        sel_idx[row, pos[row, i]] = i
    # key descending, then index ascending: two stable sorts
    order = torch.sort(sel_idx, dim=1, stable=True).indices
    sel_key, sel_idx = sel_key.gather(1, order), sel_idx.gather(1, order)
    order = torch.sort(sel_key, dim=1, descending=True, stable=True).indices
    return sel_key.gather(1, order), sel_idx.gather(1, order)


def topk(keys: torch.Tensor, k: int):
    """The k largest of each row of the (R, n) keys, ties to the lower
    index: radix rounds, then the ordered compaction and the sort."""
    return select(keys, k, *radix_kth(keys, k))
