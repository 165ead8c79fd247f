"""One tree level of the GBRT and random-forest fits, and the boosting
update: the kernel wrappers and their plain versions.

Four kernels live in ``level_histogram.cu``, each with a wrapper that
launches it for CUDA tensors and runs its plain version for CPU tensors:

* ``level_histogram`` (plain: ``level_histogram_plain``): per (node,
  feature, bin) cell of one tree level, the sum of g·w and the sum of w
  over the rows in that node with that bin, each cell's rows added one at
  a time in row order from 0.0 — the order of ``jax.ops.segment_sum`` in
  the reference's ``_level_histograms`` (``repro/core/trees.py:69``; no
  Pallas kernel).  The bins come transposed, (F, n) uint8, since they are
  the same for every tree of a fit.  The fit's leaf means take it with one
  feature and the leaf as the bin.
* ``level_split`` (plain: ``level_split_plain``): the same histograms for
  T trees at once, then each (tree, node, feature)'s best split: the bins'
  prefix sums in ``jnp.cumsum``'s XLA-CPU order (``bin_cumsum``), the
  reference's gain, its ``min_child_weight`` and feature masks, and the
  first maximum over the bins (``repro/core/trees.py:102-114``).
* ``level_route`` (plain: ``level_route_plain``): each (tree, node)'s split
  — the first maximum over the features of those candidates, so the first
  over the flattened (feature, bin) order that ``jnp.argmax`` takes, and
  the dead rule — written into row ``level`` of the trees' ``feat`` and
  ``thresh``, and every row's new node, in place (``trees.py:115-128``).
* ``boost_update`` (plain: ``boost_update_plain``): f + raw[leaf] · lr as
  one fused multiply-add a row, the contraction XLA makes of the
  reference's boosting update (``repro/core/gbrt.py:74-75``).

The plain versions of the level are the fit's torch sequence, computed on
the host for tensors on any device (the result on the inputs' device): the
histogram adds with a one-dimensional ``index_add_`` over the (n, F) keys
in row-major order, on the host a serial loop, each cell's rows in
increasing order; on CUDA ``index_add_`` adds through atomics and
``index_put_(..., accumulate=True)`` reduces each key's run across a warp,
neither in row order (nor is the CPU's ``index_put_`` with more than one
thread).  The plain fused multiply-add is ``fma32``, exact in float64 with
round-to-odd, on any device.
"""

from __future__ import annotations

import torch

from repro_torch import kernels

NEG_INF = -1e30
MAX_CELLS = 1024           # the level kernel's (node, bin) cells a block
GRID_YZ = 65535            # CUDA's limit on gridDim.y and gridDim.z


def level_histogram_plain(xbt: torch.Tensor, node: torch.Tensor,
                          gw: torch.Tensor, w: torch.Tensor, *, n_nodes: int,
                          n_bins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ((n_nodes, F, n_bins), (n_nodes, F, n_bins))
    float32 sums of ``gw`` and ``w`` per cell, rows added in order (on the
    host; the result on the inputs' device)."""
    dev = xbt.device
    xbt, node, gw, w = (t.cpu() for t in (xbt, node, gw, w))
    n_feat, n = xbt.shape
    feat = torch.arange(n_feat, dtype=torch.int64)
    keys = ((node.long()[:, None] * n_feat + feat[None, :]) * n_bins
            + xbt.T.long())
    n_seg = n_nodes * n_feat * n_bins
    # rows a segment id does not name are dropped, as segment_sum drops them
    keep = (keys >= 0) & (keys < n_seg)
    keys = torch.where(keep, keys, n_seg).reshape(-1)

    def hist(v):
        vals = v[:, None].expand(n, n_feat).reshape(-1)
        out = torch.zeros(n_seg + 1, dtype=torch.float32)
        out.index_add_(0, keys, vals)
        return out[:n_seg].view(n_nodes, n_feat, n_bins).to(dev)
    return hist(gw), hist(w)


def _groups(n_nodes: int, n_bins: int) -> int:
    """The level kernel's node groups: its blocks a (tree, feature)."""
    group = max(1, min(n_nodes, MAX_CELLS // n_bins))
    return -(-n_nodes // group)


def level_histogram(xbt: torch.Tensor, node: torch.Tensor, gw: torch.Tensor,
                    w: torch.Tensor, *, n_nodes: int, n_bins: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split histograms of one tree level.

    Args:
      xbt: (F, n) uint8 bins, transposed (each below ``n_bins``).
      node: (n,) int32 node of each row in [0, n_nodes).
      gw, w: (n,) float32 g·w and w of each row.
    Returns:
      (hist_g, hist_w), each (n_nodes, F, n_bins) float32.
    """
    n_feat, n = xbt.shape
    if node.shape != (n,) or gw.shape != (n,) or w.shape != (n,):
        raise ValueError(f"node, gw and w must be ({n},)")
    if not 1 <= n_bins <= 256 or n_nodes < 1:
        raise ValueError("level_histogram takes 1..256 bins and >= 1 node")
    if kernels.on_cpu(xbt, node, gw, w):
        return level_histogram_plain(xbt, node, gw, w, n_nodes=n_nodes,
                                     n_bins=n_bins)
    kernels.check_cuda_args(
        "level_histogram", dict(xbt=xbt, node=node, gw=gw, w=w),
        dict(xbt=torch.uint8, node=torch.int32, gw=torch.float32,
             w=torch.float32))
    if _groups(n_nodes, n_bins) > GRID_YZ:
        raise ValueError(f"{n_nodes} nodes x {n_bins} bins exceed the grid")
    hist_g, hist_w = torch.empty((2, n_nodes, n_feat, n_bins),
                                 dtype=torch.float32, device=xbt.device)
    kernels.extension().level_histogram(xbt, node, gw, w, hist_g, hist_w)
    kernels.LAUNCHES["level_histogram"] += 1
    return hist_g, hist_w


def seq_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis, left to right."""
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


def bin_cumsum(h: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in the order of the
    reference's compiled ``jnp.cumsum`` (XLA-CPU rewrites a long cumulative
    sum into windows of 16): each window scanned left to right, the
    windows' totals scanned the same way, and the running total of the
    earlier windows added to each element of the next."""
    n = h.shape[-1]
    if n <= 16:
        return seq_scan(h)
    pad = -n % 16
    hp = torch.nn.functional.pad(h, (0, pad))
    local = seq_scan(hp.reshape(*h.shape[:-1], -1, 16))
    carry = bin_cumsum(local[..., -1])
    out = torch.cat([local[..., :1, :],
                     local[..., 1:, :] + carry[..., :-1, None]], dim=-2)
    return out.reshape(*h.shape[:-1], -1)[..., :n]


def level_split_plain(xbt: torch.Tensor, node: torch.Tensor, g: torch.Tensor,
                      w: torch.Tensor, fmask: torch.Tensor, *, n_nodes: int,
                      n_bins: int, l2: float, min_child_weight: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the fit's torch sequence a tree (the
    histograms, ``bin_cumsum``, the gain, the masks), then the first
    maximum over the bins; (T, n_nodes, F) float32 gains and int32 bins (on
    the host; the result on the inputs' device)."""
    dev = xbt.device
    xbt, node, g, w, fmask = (t.cpu() for t in (xbt, node, g, w, fmask))
    gains, bins = [], []
    for t in range(node.shape[0]):
        hg, hw = level_histogram_plain(xbt, node[t], g * w[t], w[t],
                                       n_nodes=n_nodes, n_bins=n_bins)
        cg, cw = bin_cumsum(torch.stack([hg, hw]))
        tg = cg[..., -1:]
        tw = cw[..., -1:]
        lam = l2
        gain = (cg * cg / (cw + lam) + (tg - cg) * (tg - cg) / (tw - cw + lam)
                - tg * tg / (tw + lam))
        ok = ((cw >= min_child_weight) & (tw - cw >= min_child_weight)
              & fmask[t][None, :, None])
        val = torch.where(ok, gain, NEG_INF)
        best = torch.argmax(val, dim=-1)        # the first maximum
        gains.append(val.gather(-1, best[..., None])[..., 0])
        bins.append(best.to(torch.int32))
    return torch.stack(gains).to(dev), torch.stack(bins).to(dev)


def level_split(xbt: torch.Tensor, node: torch.Tensor, g: torch.Tensor,
                w: torch.Tensor, fmask: torch.Tensor, *, n_nodes: int,
                n_bins: int, l2: float, min_child_weight: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each (tree, node, feature)'s best split of one level of T trees.

    Args:
      xbt: (F, n) uint8 bins, transposed (each below ``n_bins``).
      node: (T, n) int32 node of each row in [0, n_nodes), a tree.
      g: (n,) float32 target (the pseudo-gradient), shared by the trees.
      w: (T, n) float32 row weights.
      fmask: (T, F) bool features each tree may split on.
    Returns:
      (gain, bin), each (T, n_nodes, F): the first maximum over the bins
      of the gain where the split leaves ``min_child_weight`` on both sides
      and the feature is in the tree's mask, NEG_INF elsewhere (float32),
      and its bin (int32; 0 where every bin is NEG_INF).
    """
    n_feat, n = xbt.shape
    if node.dim() != 2 or node.shape[1] != n:
        raise ValueError(f"node must be (T, {n})")
    n_trees = node.shape[0]
    if (g.shape != (n,) or w.shape != (n_trees, n)
            or fmask.shape != (n_trees, n_feat)):
        raise ValueError(f"g must be ({n},), w ({n_trees}, {n}) and fmask "
                         f"({n_trees}, {n_feat})")
    if not 1 <= n_bins <= 256 or n_nodes < 1 or n_feat < 1:
        raise ValueError("level_split takes 1..256 bins, >= 1 node and >= 1 "
                         "feature")
    kw = dict(n_nodes=n_nodes, n_bins=n_bins, l2=l2,
              min_child_weight=min_child_weight)
    if kernels.on_cpu(xbt, node, g, w, fmask):
        return level_split_plain(xbt, node, g, w, fmask, **kw)
    kernels.check_cuda_args(
        "level_split", dict(xbt=xbt, node=node, g=g, w=w, fmask=fmask),
        dict(xbt=torch.uint8, node=torch.int32, g=torch.float32,
             w=torch.float32, fmask=torch.bool))
    if n_trees > GRID_YZ or _groups(n_nodes, n_bins) > GRID_YZ:
        raise ValueError(f"{n_trees} trees x {n_nodes} nodes x {n_bins} bins"
                         " exceed the grid")
    gain = torch.empty((n_trees, n_nodes, n_feat), dtype=torch.float32,
                       device=xbt.device)
    best = torch.empty((n_trees, n_nodes, n_feat), dtype=torch.int32,
                       device=xbt.device)
    kernels.extension().level_split(xbt, node, g, w, fmask, gain, best,
                                    n_bins, float(l2),
                                    float(min_child_weight))
    kernels.LAUNCHES["level_split"] += 1
    return gain, best


def level_route_plain(xbt: torch.Tensor, node: torch.Tensor,
                      gain: torch.Tensor, best: torch.Tensor,
                      feat: torch.Tensor, thresh: torch.Tensor, *, level: int,
                      n_bins: int) -> None:
    """Plain PyTorch version: the fit's torch sequence (the first maximum,
    here over the features of the per-feature candidates, the dead rule,
    the rows' new nodes), on the host, written into the given tensors."""
    xbt, gain, best = xbt.cpu(), gain.cpu(), best.cpu()
    nodes = node.cpu()
    n_nodes = gain.shape[1]
    top = torch.argmax(gain, dim=-1)            # the first maximum
    best_gain = gain.gather(-1, top[..., None])[..., 0]
    dead = best_gain <= NEG_INF / 2
    bf = torch.where(dead, 0, top).to(torch.int32)
    bb = torch.where(dead, n_bins - 1,
                     best.gather(-1, top[..., None])[..., 0]).to(torch.int32)
    nl = nodes.long()
    rows = torch.arange(nodes.shape[1])
    fx = xbt[bf.gather(1, nl).long(), rows[None, :]]
    node.copy_(nodes * 2 + (fx.to(torch.int32) > bb.gather(1, nl)).to(
        torch.int32))
    feat[:, level, :n_nodes] = bf.to(feat.device)
    thresh[:, level, :n_nodes] = bb.to(thresh.device)


def level_route(xbt: torch.Tensor, node: torch.Tensor, gain: torch.Tensor,
                best: torch.Tensor, feat: torch.Tensor, thresh: torch.Tensor,
                *, level: int, n_bins: int) -> None:
    """Each (tree, node)'s split of one level, and the rows routed by it.

    Args:
      xbt: (F, n) uint8 bins, transposed.
      node: (T, n) int32 node of each row; updated in place to
        2·node + (bin of the node's feature > its threshold).
      gain, best: (T, n_nodes, F) from ``level_split``.
      feat, thresh: (T, depth, 2**(depth-1)) int32; row ``level`` gets
        each node's feature and threshold (feature 0 and the last bin for
        a node no split satisfies), the rest is left as it is.
    """
    n_feat, n = xbt.shape
    if node.dim() != 2 or node.shape[1] != n:
        raise ValueError(f"node must be (T, {n})")
    n_trees = node.shape[0]
    if gain.dim() != 3 or gain.shape[::2] != (n_trees, n_feat):
        raise ValueError(f"gain must be ({n_trees}, n_nodes, {n_feat})")
    n_nodes = gain.shape[1]
    if (best.shape != gain.shape or feat.dim() != 3
            or feat.shape != thresh.shape or feat.shape[0] != n_trees
            or not 0 <= level < feat.shape[1]
            or not 1 <= n_nodes <= feat.shape[2]):
        raise ValueError("best must be gain's shape, feat and thresh (T, "
                         "depth, width) with level < depth and n_nodes <= "
                         "width")
    if not 1 <= n_bins <= 256:
        raise ValueError("level_route takes 1..256 bins")
    if kernels.on_cpu(xbt, node, gain, best, feat, thresh):
        return level_route_plain(xbt, node, gain, best, feat, thresh,
                                 level=level, n_bins=n_bins)
    kernels.check_cuda_args(
        "level_route", dict(xbt=xbt, node=node, gain=gain, best=best,
                            feat=feat, thresh=thresh),
        dict(xbt=torch.uint8, node=torch.int32, gain=torch.float32,
             best=torch.int32, feat=torch.int32, thresh=torch.int32))
    if n_trees > GRID_YZ or 8 * n_nodes > 227 * 1024:
        raise ValueError(f"{n_trees} trees x {n_nodes} nodes exceed the "
                         "grid or shared memory")
    kernels.extension().level_route(xbt, node, gain, best, feat, thresh,
                                    level, n_bins)
    kernels.LAUNCHES["level_route"] += 1


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a · b + c for float32 tensors, rounded once to float32 (a fused
    multiply-add), on any device.  The product of two float32 is exact in
    float64; the float64 sum is made round-to-odd (TwoSum's error term says
    whether it was inexact, and which way), so its one rounding to float32
    is the correct one even where the float64 sum lands on a float32 tie."""
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


def boost_update_plain(f: torch.Tensor, raw: torch.Tensor,
                       leaf: torch.Tensor, lr: float) -> torch.Tensor:
    """Plain PyTorch version: fma(raw[leaf], float32(lr), f), (n,) float32."""
    lr32 = torch.tensor(lr, dtype=torch.float32, device=f.device)
    return fma32(raw[leaf.long()], lr32, f)


def boost_update(f: torch.Tensor, raw: torch.Tensor, leaf: torch.Tensor,
                 lr: float) -> torch.Tensor:
    """The boosting update: (n,) float32 f + raw[leaf] · lr, one rounding.

    Args:
      f: (n,) float32 running prediction.
      raw: (n_leaves,) float32 leaf values before the learning rate.
      leaf: (n,) int32 leaf of each row.
    """
    if leaf.shape != f.shape or f.dim() != 1:
        raise ValueError("f and leaf must be (n,)")
    if kernels.on_cpu(f, raw, leaf):
        return boost_update_plain(f, raw, leaf, lr)
    kernels.check_cuda_args(
        "boost_update", dict(f=f, raw=raw, leaf=leaf),
        dict(f=torch.float32, raw=torch.float32, leaf=torch.int32))
    out = torch.empty_like(f)
    kernels.extension().boost_update(f, raw, leaf, float(lr), out)
    kernels.LAUNCHES["boost_update"] += 1
    return out
