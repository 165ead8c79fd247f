"""Stage-1 of the plain reference: the two first-stage engines by their
definitions, in plain PyTorch, for a block of queries at a time.

* JASS (score at a time, anytime): the ρ budget resolves to the most
  inclusive impact level whose postings over the query's terms number at
  most ρ; every posting at or above that level adds its integer impact to
  its doc.  ``work`` is the postings so taken.
* BMW (rank-safe): every doc's BM25 is its matching terms' float32 scores
  added in query-slot order from 0; the top k of that is the answer.
  ``work`` and ``blocks`` follow Block-Max WAND's pruning: per-block upper
  bounds (the slot-order sum of each term's block maximum), a first set of
  the highest-bound blocks holding 2k candidate postings, its k-th score
  τ, and every block whose bound reaches τ.

The top k is score descending, then the lower doc id.  ``dtype`` sets the
float type of the BMW sums: bfloat16 is the control.
"""

from __future__ import annotations

import numpy as np
import torch


class RefIndex:
    """The reference index's postings on a device (see ``index.build``);
    ``host`` is the index's arrays."""

    def __init__(self, arrays: dict, device):
        self.device = torch.device(device)
        self.host = arrays

        def t(name, dtype=None):
            a = torch.from_numpy(arrays[name])
            return a.to(self.device, dtype) if dtype else a.to(self.device)
        self.offsets = t("offsets", torch.int64)
        self.docs = t("docs", torch.int64)
        self.score = t("score")
        self.impact = t("impact", torch.int32)
        self.n_docs = int(arrays["n_docs"])
        self.block_size = int(arrays["block_size"])
        self.n_blocks = -(-self.n_docs // self.block_size)


def _slot_postings(ref: RefIndex, terms, mask, slot: int):
    """The postings of every query's term in ``slot``: (query row, posting
    position) pairs, flat."""
    t = terms[:, slot]
    live = mask[:, slot] > 0
    lo = ref.offsets[t]
    cnt = torch.where(live, ref.offsets[t + 1] - lo, 0)
    rows = torch.repeat_interleave(torch.arange(len(t), device=t.device),
                                   cnt)
    first = torch.cumsum(cnt, 0) - cnt
    pos = (torch.arange(int(cnt.sum()), device=t.device)
           - torch.repeat_interleave(first, cnt)
           + torch.repeat_interleave(lo, cnt))
    return rows, pos


def _topk(acc, k: int):
    """Top k of each row: score descending, then the lower doc id."""
    sc, ids = torch.sort(acc, dim=1, descending=True, stable=True)
    return ids[:, :k], sc[:, :k]


def level_totals(ref: dict, terms, mask) -> np.ndarray:
    """(Q, 256) int64: each query's postings at or above each impact level
    (level 0 all of them), summed over its live terms (host arrays)."""
    terms = np.asarray(terms)
    live = np.asarray(mask) > 0
    uniq, inv = np.unique(terms, return_inverse=True)
    off = ref["offsets"]
    lo = off[uniq]
    cnt = off[uniq + 1] - lo
    first = np.cumsum(cnt) - cnt
    pos = np.repeat(lo - first, cnt) + np.arange(int(cnt.sum()))
    u = np.repeat(np.arange(len(uniq)), cnt)
    lvl = np.bincount(u * 256 + ref["impact"][pos].astype(np.int64),
                      minlength=len(uniq) * 256).reshape(-1, 256)
    cum = np.flip(np.cumsum(np.flip(lvl, axis=1), axis=1), axis=1)
    inv = inv.reshape(terms.shape)
    total = np.zeros((len(terms), 256), np.int64)
    for slot in range(terms.shape[1]):
        total += cum[inv[:, slot]] * live[:, slot, None]
    return total


def _cut(total, rho):
    """(the deepest level whose postings fit ρ, or 256 where none does;
    those postings, or 0)."""
    ok = total <= np.asarray(rho, np.int64).reshape(-1, 1)
    any_ok = ok.any(1)
    lstar = np.argmax(ok, axis=1)
    work = np.where(any_ok, total[np.arange(len(total)), lstar], 0)
    return np.where(any_ok, lstar, total.shape[1]), work


def cut_work(total, rho) -> np.ndarray:
    """(Q,) int64 postings JASS takes at budgets ``rho`` from the queries'
    ``level_totals``."""
    return _cut(total, rho)[1]


def jass_work(ref: dict, terms, mask, rho):
    """Postings at or above each query's impact cut ((Q,) int64)."""
    return cut_work(level_totals(ref, terms, mask), rho)


def saat(ref: RefIndex, terms, mask, rho, k: int):
    """JASS at per-query budgets ``rho`` (Q,): (ids (Q, k) int64, scores
    (Q, k) float32, work (Q,) int64)."""
    lstar, work = _cut(level_totals(ref.host, terms.numpy(), mask.numpy()),
                       rho.numpy())
    lstar = torch.from_numpy(lstar).to(ref.device)
    work = torch.from_numpy(work)
    terms = terms.to(ref.device).long()
    mask = mask.to(ref.device)
    q = terms.shape[0]
    acc = torch.zeros((q, ref.n_docs), dtype=torch.int64, device=ref.device)
    for slot in range(terms.shape[1]):
        rows, pos = _slot_postings(ref, terms, mask, slot)
        imp = ref.impact[pos]
        keep = imp >= lstar[rows]
        acc.index_put_((rows[keep], ref.docs[pos[keep]]),
                       imp[keep].long(), accumulate=True)
    ids, sc = _topk(acc, k)
    return ids, sc.float(), work


def _bmw_scores(ref: RefIndex, terms, mask, dtype):
    """Every doc's BM25 (its terms' scores added in slot order), each
    block's upper bound and its postings count."""
    terms = terms.to(ref.device).long()
    mask = mask.to(ref.device)
    q = terms.shape[0]
    nb, bs = ref.n_blocks, ref.block_size
    acc = torch.zeros((q, ref.n_docs), dtype=dtype, device=ref.device)
    ub = torch.zeros((q, nb), dtype=torch.float32, device=ref.device)
    ccnt = torch.zeros((q, nb), dtype=torch.int64, device=ref.device)
    for slot in range(terms.shape[1]):
        rows, pos = _slot_postings(ref, terms, mask, slot)
        docs = ref.docs[pos]
        sc = ref.score[pos]
        # one posting a doc in a slot: no two adds meet in one cell
        acc.index_put_((rows, docs), sc.to(dtype), accumulate=True)
        cell = torch.zeros((q, nb), dtype=torch.float32, device=ref.device)
        flat = rows * nb + docs // bs
        cell.view(-1).scatter_reduce_(0, flat, sc, "amax")
        ub = ub + cell
        ccnt.view(-1).index_add_(0, flat, torch.ones_like(flat))
    return acc, ub, ccnt


def _bmw_prune(ref: RefIndex, acc, ub, ccnt, k: int):
    """(work, blocks): the first blocks, highest bound first (ties to the
    lower block) until they hold 2k candidate postings, their k-th score
    τ, and every block whose bound reaches τ."""
    q = acc.shape[0]
    nb, bs = ref.n_blocks, ref.block_size
    cand = torch.clamp(ccnt, max=bs)
    order = torch.argsort(-ub, dim=1, stable=True)
    cum = torch.cumsum(torch.gather(cand, 1, order), 1)
    need = torch.clamp(torch.searchsorted(
        cum, torch.full((q, 1), 2 * k, dtype=cum.dtype,
                        device=ref.device))[:, 0] + 1, max=nb)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(nb, device=ref.device)
                  .expand_as(order).contiguous())
    first = rank < need[:, None]
    doc_block = torch.arange(ref.n_docs, device=ref.device) // bs
    acc1 = torch.where(first[:, doc_block], acc.float(), 0.0)
    tau = torch.topk(acc1, k, dim=1).values[:, k - 1]
    survive = first | (ub >= tau[:, None])
    return torch.where(survive, ccnt, 0).sum(1), survive.sum(1)


def bmw(ref: RefIndex, terms, mask, k: int, dtype=torch.float32):
    """Rank-safe BMW: (ids (Q, k) int64, scores (Q, k) float32, work (Q,)
    int64, blocks (Q,) int64)."""
    acc, ub, ccnt = _bmw_scores(ref, terms, mask, dtype)
    ids, top = _topk(acc, k)
    work, blocks = _bmw_prune(ref, acc, ub, ccnt, k)
    return ids, top.float(), work, blocks


def bmw_work(ref: RefIndex, terms, mask, k: int, dtype=torch.float32):
    """BMW's (work, blocks) alone."""
    return _bmw_prune(ref, *_bmw_scores(ref, terms, mask, dtype), k)


def serve(ref: RefIndex, terms, mask, jass, rho, k: int,
          dtype=torch.float32, block: int = 64):
    """Each query through its route's engine, ``block`` queries at a time:
    host arrays (Q, L) terms and mask, (Q,) bool JASS routes and ρ in,
    (ids (Q, k) int64, scores (Q, k) float32, work (Q,) int64) out."""
    q = len(terms)
    ids = np.zeros((q, k), np.int64)
    sc = np.zeros((q, k), np.float32)
    work = np.zeros(q, np.int64)
    for rows, is_jass in ((np.flatnonzero(jass), True),
                          (np.flatnonzero(~jass), False)):
        for lo in range(0, len(rows), block):
            b = rows[lo:lo + block]
            t = torch.from_numpy(terms[b])
            m = torch.from_numpy(mask[b])
            out = (saat(ref, t, m, torch.as_tensor(rho[b]), k) if is_jass
                   else bmw(ref, t, m, k, dtype)[:3])
            ids[b], sc[b], work[b] = (x.cpu().numpy() for x in out)
    return ids, sc, work
