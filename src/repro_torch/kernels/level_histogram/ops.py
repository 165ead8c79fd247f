"""The GBRT fit's level histograms and boosting update: the kernel wrappers
and their plain versions.

Two kernels live in ``level_histogram.cu``, each with a wrapper that
launches it for CUDA tensors and runs its plain version for CPU tensors:

* ``level_histogram`` (plain: ``level_histogram_plain``): per (node,
  feature, bin) cell of one tree level, the sum of g·w and the sum of w
  over the rows in that node with that bin, each cell's rows added one at
  a time in row order from 0.0 — the order of ``jax.ops.segment_sum`` in
  the reference's ``_level_histograms`` (``repro/core/trees.py:69``; no
  Pallas kernel).  The bins come transposed, (F, n) uint8, since they are
  the same for every tree of a fit.
* ``boost_update`` (plain: ``boost_update_plain``): f + raw[leaf] · lr as
  one fused multiply-add a row, the contraction XLA makes of the
  reference's boosting update (``repro/core/gbrt.py:74-75``).

The plain version of the histogram adds with a one-dimensional
``index_add_`` over the (n, F) keys in row-major order on the host, where
it is a serial loop: each cell's rows in increasing order.  It runs there
for tensors on any device: on CUDA ``index_add_`` adds through atomics and
``index_put_(..., accumulate=True)`` reduces each key's run across a warp,
neither in row order (nor is the CPU's ``index_put_`` with more than one
thread).  The plain fused multiply-add is ``fma32``, exact in float64 with
round-to-odd, on any device.
"""

from __future__ import annotations

import torch

from repro_torch import kernels

CELLS_PER_BLOCK = 512      # the kernel's (node, bin) cells a block


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


def level_histogram(xbt: torch.Tensor, node: torch.Tensor, gw: torch.Tensor,
                    w: torch.Tensor, *, n_nodes: int, n_bins: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split histograms of one tree level.

    Args:
      xbt: (F, n) uint8 bins, transposed.
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
    if n_nodes * n_bins > 65535 * CELLS_PER_BLOCK:
        raise ValueError(f"{n_nodes} nodes x {n_bins} bins exceed the grid")
    hist_g = torch.empty((n_nodes, n_feat, n_bins), dtype=torch.float32,
                         device=xbt.device)
    hist_w = torch.empty_like(hist_g)
    kernels.extension().level_histogram(xbt, node, gw, w, hist_g, hist_w)
    kernels.LAUNCHES["level_histogram"] += 1
    return hist_g, hist_w


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
