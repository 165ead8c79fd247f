"""The fits of the plain reference: the forests worked out again from the
benchmark's own fit log, never read from the program.

Stage-0's three forests are gradient-boosted trees with the pinball loss
(each round a histogram tree on the pseudo-gradient, its leaves refitted to
the in-leaf τ-quantile of the residuals); Stage-2's LTR forest the same
with the squared loss (leaf means).  The arithmetic is a frozen copy of
the definition's float32 order, which the fitted trees depend on bit for
bit: quantile bin edges of the features, each histogram cell's rows added
in row order, the bins' prefix sums in windows of 16, the gain with every
operation rounded alone, the first maximum over (feature, bin), the
boosting update as one fused multiply-add.  With ``dtype=torch.bfloat16``
the features and targets are rounded to bfloat16 first: the control's fit.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.stage0 import _vector_sum, _window_sum

NEG_INF = -1e30


def fit_bins(x: np.ndarray, n_bins: int) -> np.ndarray:
    """(F, n_bins - 1) float32 quantile edges, made strictly increasing."""
    qs = np.linspace(0.0, 100.0, n_bins + 1)[1:-1]
    edges = np.percentile(np.asarray(x), qs, axis=0).T.astype(np.float32)
    edges = np.maximum.accumulate(edges + 1e-9 * np.arange(edges.shape[1]),
                                  axis=1)
    return edges.astype(np.float32)


def apply_bins(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(n, F) bins: the count of edges below each value."""
    return (x[:, :, None] > edges[None, :, :]).sum(dim=-1).to(torch.uint8)


def fma32(a, b, c):
    """float32 a·b + c rounded once (float64 with round-to-odd)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, -float("inf")))
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _histogram(xb: np.ndarray, node: np.ndarray, v: np.ndarray,
               n_nodes: int, n_bins: int) -> np.ndarray:
    """(n_nodes, F, n_bins) float32 sums of ``v`` per (node, feature, bin),
    each cell's rows added one at a time in row order from 0."""
    n, n_feat = xb.shape
    keys = ((node.astype(np.int64)[:, None] * n_feat
             + np.arange(n_feat)[None, :]) * n_bins + xb.astype(np.int64))
    out = np.zeros(n_nodes * n_feat * n_bins, np.float32)
    np.add.at(out, keys.reshape(-1),
              np.repeat(v.astype(np.float32), n_feat))
    return out.reshape(n_nodes, n_feat, n_bins)


def _seq_scan(x):
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def bin_cumsum(h):
    """Inclusive prefix sums over the bins: windows of 16 scanned left to
    right, the windows' totals likewise, each window then given the
    running total of those before it."""
    n = h.shape[-1]
    if n <= 16:
        return _seq_scan(h)
    pad = -n % 16
    hp = torch.nn.functional.pad(h, (0, pad))
    local = _seq_scan(hp.reshape(*h.shape[:-1], -1, 16))
    carry = bin_cumsum(local[..., -1])
    out = torch.cat([local[..., :1, :],
                     local[..., 1:, :] + carry[..., :-1, None]], dim=-2)
    return out.reshape(*h.shape[:-1], -1)[..., :n]


def _tree(xb: np.ndarray, g: torch.Tensor, depth: int, n_bins: int,
          l2: float, mcw: float):
    """One variance-reduction tree, level by level: (feat, thresh)
    (depth, 2^(depth-1)) int32 and each row's leaf.  A node no split
    satisfies sends every row left (feature 0, the last bin)."""
    n = xb.shape[0]
    width = 2 ** (depth - 1)
    feat = torch.zeros((depth, width), dtype=torch.int32)
    thresh = torch.zeros((depth, width), dtype=torch.int32)
    node = np.zeros(n, np.int64)
    w = np.ones(n, np.float32)
    gw = (g * torch.from_numpy(w)).numpy()
    rows = np.arange(n)
    for d in range(depth):
        n_nodes = 2 ** d
        hg = torch.from_numpy(_histogram(xb, node, gw, n_nodes, n_bins))
        hw = torch.from_numpy(_histogram(xb, node, w, n_nodes, n_bins))
        cg, cw = bin_cumsum(torch.stack([hg, hw]))
        tg, tw = cg[..., -1:], cw[..., -1:]
        gain = (cg * cg / (cw + l2) + (tg - cg) * (tg - cg) / (tw - cw + l2)
                - tg * tg / (tw + l2))
        ok = (cw >= mcw) & (tw - cw >= mcw)
        val = torch.where(ok, gain, NEG_INF)
        best = torch.argmax(val, dim=-1)
        fgain = val.gather(-1, best[..., None])[..., 0]      # (nodes, F)
        top = torch.argmax(fgain, dim=-1)
        dead = fgain.gather(-1, top[:, None])[:, 0] <= NEG_INF / 2
        bf = torch.where(dead, 0, top).numpy()
        bb = torch.where(dead, n_bins - 1,
                         best.gather(-1, top[:, None])[:, 0]).numpy()
        node = node * 2 + (xb[rows, bf[node]].astype(np.int64)
                           > bb[node]).astype(np.int64)
        feat[d, :n_nodes] = torch.from_numpy(bf.astype(np.int32))
        thresh[d, :n_nodes] = torch.from_numpy(bb.astype(np.int32))
    return feat, thresh, torch.from_numpy(node)


def _leaf_quantiles(leaf, values, n_leaves: int, tau: float):
    """Each leaf's value at rank floor(τ·(count - 1)) of its sorted
    values; 0 for an empty leaf."""
    n = values.shape[0]
    lid = leaf.long()
    by_value = torch.sort(values, stable=True).indices
    order = by_value[torch.sort(lid[by_value], stable=True).indices]
    s_leaf, s_val = lid[order], values[order]
    counts = torch.bincount(lid, minlength=n_leaves + 1).float()
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, dtype=torch.float32) - starts[s_leaf]
    rank = torch.floor(float(np.float32(tau))
                       * torch.clamp(counts - 1.0, min=0.0))
    hit = pos == rank[s_leaf]
    out = torch.zeros((n_leaves + 1,), dtype=torch.float32)
    out[s_leaf[hit]] = s_val[hit] + 0.0
    return out[:n_leaves]


def _leaf_means(leaf, values, n_leaves: int, l2: float):
    """Each leaf's Σ values / (count + l2), rows added in order."""
    lid = leaf.numpy().astype(np.int64)
    sv = np.zeros(n_leaves, np.float32)
    sw = np.zeros(n_leaves, np.float32)
    np.add.at(sv, lid, values.numpy())
    np.add.at(sw, lid, np.ones(len(lid), np.float32))
    return torch.from_numpy(sv) / (torch.from_numpy(sw) + l2)


def _quantile(y, tau: float):
    """The linear-interpolation τ-quantile of ``y``: the position τ·(n-1)
    in float32, lo·(1 - w) + hi·w with the first product fused."""
    s = torch.sort(y).values
    n = np.float32(y.shape[0])
    q = np.float32(tau) * (n - np.float32(1.0))
    lo, hi = np.floor(q), np.ceil(q)
    hw = np.float32(q - lo)
    lw = np.float32(np.float32(1.0) - hw)
    vals = s[[int(np.clip(lo, 0, n - 1)), int(np.clip(hi, 0, n - 1))]]
    t = torch.tensor([lw, hw], dtype=torch.float32)
    return fma32(vals[0], t[0], vals[1] * t[1])


def _mean(y):
    """Σ y (up to 32 left to right, more in windows of 32) times the
    float32 reciprocal of n."""
    n = y.shape[0]
    total = _vector_sum(y) if n <= 32 else _window_sum(y)
    return total * (torch.ones((), dtype=torch.float32) / n)


def fit(x, y, *, n_trees: int, depth: int, loss: str, tau: float = 0.5,
        learning_rate: float = 0.15, n_bins: int = 64,
        min_child_weight: float = 20.0, l2: float = 1.0,
        dtype=torch.float32) -> dict:
    """A fitted forest ({feat, thresh, leaf, base, bin_edges}, the form
    ``stage0.forest_predict`` takes) of (n, F) features ``x`` and (n,)
    targets ``y``; ``loss`` "quantile" (pinball at ``tau``) or "l2"."""
    x = torch.as_tensor(np.asarray(x, np.float32))
    y = torch.as_tensor(np.asarray(y, np.float32))
    if dtype != torch.float32:
        x, y = x.to(dtype).float(), y.to(dtype).float()
    edges = torch.from_numpy(fit_bins(x.numpy(), n_bins))
    xb = apply_bins(x, edges).numpy()
    base = _quantile(y, tau) if loss == "quantile" else _mean(y)
    lr = float(np.float32(learning_rate))
    f = base.expand(len(y)).contiguous()
    n_leaves = 2 ** depth
    feats, threshs, leaves = [], [], []
    for _ in range(n_trees):
        if loss == "quantile":
            g = torch.where(y >= f, float(np.float32(tau)),
                            float(np.float32(tau - 1.0)))
        else:
            g = y - f
        feat, thresh, leaf = _tree(xb, g, depth, n_bins, l2,
                                   min_child_weight)
        raw = (_leaf_quantiles(leaf, y - f, n_leaves, tau)
               if loss == "quantile" else
               _leaf_means(leaf, y - f, n_leaves, l2))
        f = fma32(raw[leaf], torch.tensor(lr, dtype=torch.float32), f)
        feats.append(feat)
        threshs.append(thresh)
        leaves.append(raw * lr)
    return {"feat": torch.stack(feats), "thresh": torch.stack(threshs),
            "leaf": torch.stack(leaves), "base": base.reshape(()),
            "bin_edges": edges}


FOREST_KEYS = ("feat", "thresh", "leaf", "base", "bin_edges")


def forest_gap(got: dict, want: dict) -> int:
    """Entries of two forests that differ (a shape that differs counts
    every entry of the reference's)."""
    n = 0
    for k in FOREST_KEYS:
        a, b = torch.as_tensor(got[k]), torch.as_tensor(want[k])
        if a.shape != b.shape:
            n += b.numel()
        else:
            n += int((a.float() != b.float()).sum())
    return n
