"""The query-group term table of the batched mirror kernels, in PyTorch.

``impact_accumulate.cu`` and ``blockmax_score.cu`` serve one doc tile for
a group of up to ``GROUP`` queries a block, and first build a table of the
group's query terms in shared memory (``term_table.cuh``): per term the
mask of the group's queries that hold it and, for the scoring kernel, per
query the first slot that holds it.  The kernels' plain twins
(``impact_accumulate_grouped``, ``blockmax_score_grouped``) build the same
table here and look each lane's term up in it; they run in the tests and
in ``chip_smoke.py`` only.  The kernel's table is a hash behind a 64 Kbit
filter and this one a sorted list of terms: the layout differs, the
lookups agree.
"""

from __future__ import annotations

import torch

GROUP = 32            # queries a block serves: one bit each of a 32-bit mask
FILTER_WORDS = 2048   # the kernels' 64 Kbit term filter, in 32-bit words
SMEM_OPTIN = 232_448  # shared memory one block may take on the H100 (227 KB,
                      # above 48 KB after cudaFuncSetAttribute)


def table_bits(n_slots: int) -> int:
    """log2 of the kernel's table size for ``n_slots`` query slots: at least
    twice the slots and at least 32 entries (``term_table::bits_for``)."""
    return max(5, (2 * n_slots - 1).bit_length())


def group_table(qt: torch.Tensor):
    """The table of one group's (g, L) query terms, -1 in empty slots.

    Returns (keys, mask, first): the group's distinct terms >= 0, sorted;
    per term the int64 mask of the queries that hold it (bit i: query i of
    the group); and the (n_keys, g) first slot of each query that holds the
    term, -1 where it does not (a repeated term counts at its first slot).
    """
    g = qt.shape[0]
    keys = torch.unique(qt[qt >= 0])
    eq = qt.unsqueeze(0) == keys.view(-1, 1, 1)            # (n_keys, g, L)
    held = eq.any(dim=2)
    bit = torch.ones(g, dtype=torch.int64, device=qt.device) << torch.arange(
        g, device=qt.device)
    mask = (held.to(torch.int64) * bit).sum(dim=1)
    first = torch.where(held, torch.argmax(eq.to(torch.int8), dim=2), -1)
    return keys, mask, first


def lookup(keys: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """Per lane, the entry of its term in ``keys``, or -1 where no query of
    the group holds it (lanes with term < 0 included)."""
    if keys.numel() == 0:
        return torch.full_like(terms, -1, dtype=torch.int64)
    pos = torch.searchsorted(keys, terms).clamp(max=keys.numel() - 1)
    return torch.where((keys[pos] == terms) & (terms >= 0), pos, -1)


def matched_lanes(keys: torch.Tensor, tile_docs: torch.Tensor,
                  tile_terms: torch.Tensor, tile_d: int):
    """The mirror's lanes a block goes on to read after the lookup: those
    whose term the group holds and whose doc lies in [0, tile_d).  Returns
    their (tile, lane) indices and their entries."""
    entry = lookup(keys, tile_terms)
    tile, j = torch.nonzero((entry >= 0) & (tile_docs >= 0)
                            & (tile_docs < tile_d), as_tuple=True)
    return tile, j, entry[tile, j]


def mask_bits(mask: torch.Tensor, g: int) -> torch.Tensor:
    """(n, g) bool: bit i of each int64 mask."""
    shift = torch.arange(g, device=mask.device)
    return ((mask.unsqueeze(1) >> shift) & 1).bool()
