"""Attention of the LM serving path: the kernel wrappers, their plain
versions, and the public ops the model code calls.

``flash_attention`` launches a prefill kernel for CUDA tensors — the
tensor-core kernel of ``flash_attention_sm90.cu`` for bf16, the CUDA-core
kernel of ``flash_attention.cu`` for fp32, a fixed choice by dtype — and
runs ``attention_ref`` for CPU tensors; ``attention_tc_plain`` repeats the
bf16 kernel's arithmetic (its tiles, P as bf16 hi + lo) in plain PyTorch,
``attention_f32_tiles_plain`` the fp32 kernel's (its query tiles and
32-key softmax steps, whose geometry ``f32_forward_tiles`` gives: 8 warps
of 16 rows a block, KV tiles of 64 or 32 keys in a two-stage ring;
``f32_forward_lanes`` maps each lane of a warp to its rows and
accumulator columns);
``flash_decode`` launches the split-KV decode kernel (bf16 on the tensor
cores, fp32 on the CUDA cores, by dtype) and the kernel that merges its
per-split partials (``merge_splits`` of ``decode_partials_plain`` is
their arithmetic in plain PyTorch), or runs ``decode_ref`` for CPU
tensors.  Both compute the functions of the Pallas kernels
``flash_attention`` and ``flash_decode``
(repro/kernels/flash_attention/kernel.py), which the
reference holds to the same two oracles (``ref.py``): softmax attention in
fp32 math with -1e30 masking, output in q's type, GQA by kv head
``h // (H / Hkv)``.  Unlike the Pallas wrappers they take any sequence or
cache length (those drop a ragged tail of S or T).  The prefill's v may be
narrower than q and k (MLA's q/k 96 and v 64); its kernels are built for
the width pairs of ``PREFILL_WIDTHS``, the decode kernels for one width.

Training adds the backward of the prefill (kernel 8's backward, which the
reference does not have: its models train through autodiff of a jnp scan).
``flash_attention(..., return_lse=True)`` also returns each row's
log-sum-exp (fp32, (B, H, Sq)), which the forward kernels write only when
asked; ``flash_attention_backward`` launches the kernels of
``flash_attention_bwd.cu`` (a pre-pass for D = rowsum(dO ∘ O), then for
bf16 the dQ and the dK/dV kernels on ``wgmma`` fed by TMA, for fp32 one
kernel of register tiles and, past its KV tile, a sum of its dQ partials;
no float atomics) for CUDA tensors and runs
``flash_attention_backward_plain`` — the same recurrence from the saved
log-sum-exp in plain PyTorch — for CPU tensors;
``flash_attention_backward_tc_plain`` repeats the bf16 kernels' arithmetic
(P and dS entering their products as bf16, rounded once or as hi + lo).

``attention`` and ``decode_attention`` are the reference's public ops
(``ops.py``); its ``use_kernel`` switch is replaced by the port's rule: the
tensors' device decides.
"""

from __future__ import annotations

import torch

from repro_torch import kernels

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)   # head widths the kernels are built for
# the (q/k width, v width) pairs of the prefill kernels: the equal widths,
# and MLA's (64 + 32 rope, 64)
PREFILL_WIDTHS = tuple((d, d) for d in HEAD_DIMS) + ((96, 64),)
SPLIT = 512                     # cache positions a decode block reduces
TC_TILE = 128                   # query rows and keys of a bf16 prefill tile
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, H, S, D) by GQA head-group repeat."""
    return torch.repeat_interleave(k, n_heads // k.shape[1], dim=1)


def attention_ref(q, k, v, causal: bool = True, scale: float | None = None,
                  return_lse: bool = False):
    """q (B, H, S, D), k (B, Hkv, S, D), v (B, Hkv, S, Dv) -> (B, H, S, Dv),
    fp32 math; the plain version of the prefill kernel (the reference's
    ``attention_ref``).  With ``return_lse`` also each row's log-sum-exp of
    its scaled, masked logits (B, H, S) fp32."""
    b, h, s, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    k = _expand_kv(k, h).float()
    v = _expand_kv(v, h).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask[None, None], logits, NEG_INF)
    mx = logits.amax(dim=-1, keepdim=True)
    w = torch.exp(logits - mx)
    total = w.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", w / total, v).to(q.dtype)
    if return_lse:
        return out, (mx + torch.log(total.clamp(min=1e-30)))[..., 0]
    return out


def attention_tc_plain(q, k, v, causal: bool = True,
                       scale: float | None = None, p_halves: int = 2,
                       return_lse: bool = False):
    """The bf16 prefill kernel's arithmetic in plain PyTorch: for each
    128-row query block, an online softmax over 128-key tiles (up to the
    block's diagonal when causal) with fp32 products of the operands,
    logits scaled after the dot and masked to -1e30, P split into bf16 hi
    + lo halves for P·V (``p_halves=1``: rounded once to bf16, which the
    kernel does not do) while its fp32 values are summed, and the sum
    floored at 1e-30; output (B, H, Sq, Dv) in q's type, and with
    ``return_lse`` each row's log-sum-exp, fp32 (B, H, Sq), as the kernel
    writes it."""
    def halves(p):
        hi = p.to(torch.bfloat16).float()
        return hi + (p - hi).to(torch.bfloat16).float() if p_halves == 2 \
            else hi
    out, lse = _tiled_softmax(q, k, v, causal, scale, TC_TILE, TC_TILE,
                              halves)
    return (out, lse) if return_lse else out


def _tiled_softmax(q, k, v, causal, scale, rows, keys, weights):
    """The prefill kernels' online softmax in plain PyTorch: for each
    ``rows``-row query tile, steps of ``keys`` keys up to the tile's last
    row when causal, fp32 products of the operands, logits scaled after the
    dot and masked to -1e30, P's fp32 values summed and ``weights(P)``
    multiplied into V, the sum floored at 1e-30: (output (B, H, Sq, Dv) in
    q's type, each row's log-sum-exp m + log(max(l, 1e-30)) fp32)."""
    b, h, sq, d = q.shape
    sk, dv = k.shape[2], v.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    k = _expand_kv(k, h).float()
    v = _expand_kv(v, h).float()
    out = torch.empty((b, h, sq, dv), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, rows):
        q1 = min(q0 + rows, sq)
        pos = torch.arange(q0, q1, device=q.device)[:, None]
        qf = q[:, :, q0:q1].float()
        m = torch.full((b, h, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros((b, h, q1 - q0), device=q.device)
        acc = torch.zeros((b, h, q1 - q0, dv), device=q.device)
        for k0 in range(0, min(sk, q1) if causal else sk, keys):
            k1 = min(k0 + keys, sk)
            s = torch.einsum("bhqd,bhkd->bhqk", qf, k[:, :, k0:k1]) * scale
            if causal:
                cols = torch.arange(k0, k1, device=q.device)[None, :]
                s = torch.where(cols <= pos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", weights(p), v[:, :, k0:k1])
            m = m_new
        out[:, :, q0:q1] = acc / torch.clamp(l, min=1e-30)[..., None]
        lse[:, :, q0:q1] = m + torch.log(torch.clamp(l, min=1e-30))
    return out.to(q.dtype), lse


def f32_forward_tiles(d: int, dv: int) -> dict:
    """The fp32 forward kernel's geometry at widths (d, dv) (its ``Fwd``):
    ``warps`` warps of ``rows_warp`` query rows (``rows_lane`` a lane,
    ``rows`` a block), KV tiles of ``keys`` keys in a ring of ``stages``,
    each taken ``chunk`` keys a softmax step; ``min_blocks`` blocks an SM
    (the launch bounds), ``smem_bytes`` of shared memory a block; a lane's
    accumulator columns come in ``col_blocks`` blocks of ``vec``
    (``f32_forward_lanes``)."""
    rows_lane, warps, chunk, stages = 4, 8, 32, 2
    keys = 32 if 64 < d + dv <= 160 else 64
    vec = 4 if dv >= 32 else dv // 8
    rows_warp = 4 * rows_lane
    rows = warps * rows_warp
    floats = (rows * (d + 4) + stages * keys * (d + 4 + dv)
              + warps * rows_warp * (chunk + 4))
    return dict(warps=warps, rows_lane=rows_lane, rows_warp=rows_warp,
                rows=rows, chunk=chunk, keys=keys, stages=stages,
                min_blocks=3 if d + dv <= 64 else 2 if d + dv <= 160 else 1,
                vec=vec, col_blocks=dv // (8 * vec), smem_bytes=4 * floats)


def f32_forward_lanes(d: int, dv: int) -> list:
    """For each lane of a warp of the fp32 forward kernel, the (rows,
    columns) of the warp's (``rows_warp`` x dv) accumulator it owns: lane
    8·rg + g takes rows rg + 4i and, in each block of 8·``vec`` columns,
    the ``vec`` at g·``vec`` (the same lane computes the scores of rows rg
    + 4i and keys g + 8j)."""
    t = f32_forward_tiles(d, dv)
    vec = t["vec"]
    return [([lane // 8 + 4 * i for i in range(t["rows_lane"])],
             [8 * vec * u + (lane % 8) * vec + e
              for u in range(t["col_blocks"]) for e in range(vec)])
            for lane in range(32)]


def attention_f32_tiles_plain(q, k, v, causal: bool = True,
                              scale: float | None = None,
                              return_lse: bool = False):
    """The fp32 forward kernel's arithmetic in plain PyTorch: for each query
    tile of ``f32_forward_tiles``'s ``rows``, an online softmax over
    ``chunk``-key steps (the kernel's KV tiles cut into them) up to the
    tile's last row when causal, fp32 products, logits scaled after the dot
    and masked to -1e30, the sum floored at 1e-30; output (B, H, Sq, Dv)
    in q's type, and with ``return_lse`` each row's log-sum-exp m +
    log(max(l, 1e-30)), fp32 (B, H, Sq), as the kernel writes it.  Steps
    the kernel skips (past a warp's last row) are all masked, which leaves
    (m, l, acc) as they are."""
    t = f32_forward_tiles(q.shape[-1], v.shape[-1])
    out, lse = _tiled_softmax(q, k, v, causal, scale, t["rows"], t["chunk"],
                              lambda p: p)
    return (out, lse) if return_lse else out


def decode_ref(q, k, v, kv_len=None, scale: float | None = None):
    """Single-token decode: q (B, H, D), caches (B, Hkv, T, D) -> (B, H, D);
    positions >= ``kv_len`` (B,) masked.  The plain version of the decode
    kernel (the reference's ``decode_ref``)."""
    b, h, d = q.shape
    t = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    k = _expand_kv(k, h).float()
    v = _expand_kv(v, h).float()
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), k) * scale
    if kv_len is not None:
        pos = torch.arange(t, device=q.device)
        logits = torch.where(pos[None, None, :] < kv_len[:, None, None],
                             logits, NEG_INF)
    w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    return torch.einsum("bhk,bhkd->bhd", w, v).to(q.dtype)


def decode_partials_plain(q, k, v, kv_len, scale: float | None = None):
    """The decode kernel's per-split partials in plain PyTorch: for each
    512-position split, (acc (B, H, n_sp, D), m, l (B, H, n_sp)) of its
    masked scores; a split wholly at or past ``kv_len[b] > 0`` gives
    (0, -1e30, 0), as the kernel writes without reading it."""
    b, h, d = q.shape
    t = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    n_sp = -(-t // SPLIT)
    pad = n_sp * SPLIT - t
    k = torch.nn.functional.pad(_expand_kv(k, h).float(), (0, 0, 0, pad))
    v = torch.nn.functional.pad(_expand_kv(v, h).float(), (0, 0, 0, pad))
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k) * scale
    pos = torch.arange(n_sp * SPLIT, device=q.device)
    s = torch.where(pos[None, None, :] < kv_len[:, None, None], s, NEG_INF)
    # the padding past T is no position of the split: weight exactly 0
    s = torch.where(pos < t, s, -torch.inf).reshape(b, h, n_sp, SPLIT)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhsk,bhskd->bhsd", p, v.reshape(b, h, n_sp, SPLIT, d))
    l = p.sum(dim=-1)
    start = torch.arange(n_sp, device=q.device) * SPLIT
    skip = ((kv_len[:, None] > 0) & (start[None, :] >= kv_len[:, None]))
    skip = skip[:, None, :].expand(b, h, n_sp)
    acc = torch.where(skip[..., None], 0.0, acc)
    return acc, torch.where(skip, NEG_INF, m), torch.where(skip, 0.0, l)


def merge_splits(acc, m, l, dtype):
    """Stable log-sum-exp merge of per-split partials, as the reference's
    ``flash_decode`` wrapper merges them: Σ e^{m_i - m*} acc_i / Σ e^{m_i -
    m*} l_i, the denominator floored at 1e-30."""
    m_star = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - m_star)
    denom = torch.clamp((w * l).sum(dim=-1, keepdim=True), min=1e-30)
    return ((acc * w[..., None]).sum(dim=2) / denom).to(dtype)


def _check_kernel_inputs(name: str, q, k, v, pairs=None) -> None:
    """Raise on what the kernels do not take: what ``_check_widths``
    refuses, and a tensor off the card or off q's card."""
    _check_widths(name, q, k, v, pairs)
    for key, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor")
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one device")


def _check_widths(name: str, q, k, v, pairs=None) -> None:
    """Raise on a dtype other than fp32 or bf16 (or mixed), a k width other
    than q's, a non-unit stride along the width, and widths the kernel is
    not built for: with ``pairs`` (the prefill kernels) a (q/k width, v
    width) pair outside it, without (the decode kernels) a head width
    outside ``HEAD_DIMS`` or a v width other than q's.  These hold on
    either device type, so a kernel's fake checks them too."""
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: dtype must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q, k and v must share one dtype")
    d, dv = q.shape[-1], v.shape[-1]
    if pairs is not None:
        if k.shape[-1] != d:
            raise ValueError(f"{name}: k's width must equal q's ({d}), got "
                             f"{k.shape[-1]}")
        if (d, dv) not in pairs:
            raise ValueError(
                f"{name}: head widths (q/k {d}, v {dv}) are not a pair the "
                f"kernel is built for: widths must equal, at one of "
                f"{HEAD_DIMS}, or be "
                + " or ".join(str(p) for p in pairs if p[0] != p[1]))
    else:
        if d not in HEAD_DIMS:
            raise ValueError(f"{name}: head width {d} is not one the kernel "
                             f"is built for {HEAD_DIMS}")
        if k.shape[-1] != d or dv != d:
            raise ValueError(f"{name}: k and v widths must equal q's ({d}), "
                             f"got {k.shape[-1]} and {dv}")
    for key, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {key} must have unit stride along D")


def _check_tma(name: str, q, k, v, base: bool = True) -> None:
    """Raise on what TMA does not take: a base address off a 16-byte
    boundary (with ``base``; a fake tensor has no address), or a (B, H, S)
    stride that is not a multiple of 16 bytes (an axis of extent 1 has no
    stride to check)."""
    for key, t in (("q", q), ("k", k), ("v", v)):
        if base and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte "
                             f"boundary for TMA")
        for dim in range(3):
            if t.shape[dim] > 1 and t.stride(dim) * t.element_size() % 16:
                raise ValueError(f"{name}: {key}'s stride along axis {dim} "
                                 f"must be a multiple of 16 bytes for TMA")


def _check_heads(name: str, h: int, hkv: int) -> None:
    if hkv < 1 or h % hkv:
        raise ValueError(f"{name}: {h} query heads are not a multiple of "
                         f"{hkv} kv heads")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, return_lse: bool = False):
    """Attention of q (B, H, Sq, D) over k (B, Hkv, Sk, D) and v (B, Hkv,
    Sk, Dv) -> (B, H, Sq, Dv) in q's type: for CUDA tensors the tensor-core
    kernel on bf16 and the CUDA-core kernel on fp32, each built for the
    width pairs ``PREFILL_WIDTHS``; ``attention_ref`` for CPU tensors.
    The fp32 kernel (``attention_f32_tiles_plain`` is its arithmetic) runs
    a block of 8 warps on a 128-row query tile; each warp takes 16 rows
    and its keys 32 a softmax step, a lane 4 rows x 4 keys of the scores
    and 4 rows of the accumulator at every width; Q, K and V are staged by
    cp.async (16-byte copies, 4-byte where a view's rows are off a 16-byte
    boundary; no copy of the view), and rows past Sq and keys past Sk (or
    the diagonal) are not computed.  Causal mode needs Sq == Sk.  With
    ``return_lse``, (output, each row's log-sum-exp (B, H, Sq) fp32),
    which the backward reads; without it the kernel writes none."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    _check_heads("flash_attention", h, hkv)
    if k.shape[0] != b or v.shape[:3] != k.shape[:3]:
        raise ValueError("flash_attention: k and v must be (B, Hkv, Sk, .)")
    kernels.on_cpu(q, k, v)
    out, lse = kernels.call(
        "flash_attention", q, k, v, bool(causal),
        float(scale if scale is not None else d ** -0.5), bool(return_lse))
    return (out, lse) if return_lse else out


def _prefill_checks(name: str, q, k, v, causal: bool, real: bool) -> None:
    """What the prefill kernels and their backward refuse.  ``real``: also
    the device, the bf16 base addresses and the grid's B and H, which a
    fake does not check: it stands for the card's tensor on either device
    type, has no address, and DTensor runs it at the global shapes of the
    dimensions its strategies split (B and H) to find the output's."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    if causal and sq != sk:
        raise ValueError(f"{name}: causal mode needs Sq == Sk, got {sq} and "
                         f"{sk}")
    (_check_kernel_inputs if real else _check_widths)(name, q, k, v,
                                                      PREFILL_WIDTHS)
    if sq < 1 or sk < 1:
        raise ValueError(f"{name}: empty sequence")
    if real and (b > 65535 or h > 65535):
        raise ValueError(f"{name}: B and H must fit the grid")
    if q.dtype == torch.bfloat16:
        _check_tma(name, q, k, v, real)
        if -(-sq // TC_TILE) > 65535:
            raise ValueError(f"{name}: Sq must fit the grid")


def _prefill_outputs(q, v, return_lse: bool):
    b, h, sq, _ = q.shape
    out = torch.empty((b, h, sq, v.shape[-1]), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq if return_lse else 0), dtype=torch.float32,
                      device=q.device)
    return out, lse


def _pairs(q_shape, k_shape, causal: bool) -> int:
    """The (query, key) pairs a prefill call must score: those on or below
    the diagonal when causal."""
    b, h, sq, _ = q_shape
    return b * h * sq * (sq + 1) // 2 if causal else b * h * sq * k_shape[2]


def _prefill_flops(q, k, v, causal, scale, return_lse, *args, **kwargs):
    """2·(D + Dv) operations a pair (chip_smoke.lm_work)."""
    return 2 * _pairs(q, k, causal) * (q[-1] + v[-1])


def _backward_flops(q, k, v, o, lse, do, causal, scale, *args, **kwargs):
    """Five products a pair: 2·(3·D + 2·Dv) (chip_smoke.bwd_work)."""
    return 2 * _pairs(q, k, causal) * (3 * q[-1] + 2 * v[-1])


def _decode_flops(q, k, v, kv_len, scale, *args, **kwargs):
    """4·D operations a (query head, cache position), every position of the
    cache counted: under fake tensors no ``kv_len`` can be read."""
    b, h, d = q
    return 4 * h * d * b * k[2]


def _head_dims(q, k) -> tuple:
    """The dimensions a DTensor may split attention on: the batch, and the
    heads when every rank would hold whole GQA groups (q's and k's heads
    both divisible by the mesh's rank count)."""
    n = q.mesh.size()
    return (0, 1) if q.shape[1] % n == 0 and k.shape[1] % n == 0 else (0,)


def _prefill_shardings(q, k, v, causal, scale, return_lse):
    return kernels.split_strategies(3, 2, _head_dims(q, k), extra_in=3)


def _backward_shardings(q, k, v, o, lse, do, causal, scale):
    return kernels.split_strategies(6, 3, _head_dims(q, k), extra_in=2)


def _decode_shardings(q, k, v, kv_len, scale):
    from torch.distributed.tensor import Replicate, Shard
    out = kernels.split_strategies(4, 1, (0,), extra_in=1)
    if 1 in _head_dims(q, k):
        out.append(([Shard(1)], [Shard(1)] * 3 + [Replicate(), None]))
    return out


def _flash_attention_launch(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool, scale: float,
                            return_lse: bool
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 8's launch on CUDA tensors: (output, log-sum-exp (B, H, Sq),
    or an empty (B, H, 0) tensor without ``return_lse``)."""
    _prefill_checks("flash_attention", q, k, v, causal, True)
    out, lse = _prefill_outputs(q, v, return_lse)
    ext = kernels.extension()
    launch = (ext.flash_attention_sm90 if q.dtype == torch.bfloat16
              else ext.flash_attention)
    launch(q, k, v, out, scale, causal, lse if return_lse else None)
    kernels.LAUNCHES["flash_attention"] += 1
    return out, lse


def _flash_attention_plain(q, k, v, causal, scale, return_lse):
    out, lse = attention_ref(q, k, v, causal=causal, scale=scale,
                             return_lse=True)
    return out, lse if return_lse else lse[..., :0].contiguous()


def _flash_attention_fake(q, k, v, causal, scale, return_lse):
    _prefill_checks("flash_attention", q, k, v, causal, False)
    return _prefill_outputs(q, v, return_lse)


kernels.card_op("flash_attention", _flash_attention_launch,
                _flash_attention_plain, _flash_attention_fake, _prefill_flops, _prefill_shardings)


def flash_attention_backward_plain(q, k, v, o, lse, do, *, causal: bool,
                                   scale: float | None = None,
                                   chunk: int = 512):
    """The backward kernels' recurrence in plain PyTorch: over
    ``chunk``-wide KV tiles, P = exp(scale · q kᵀ - lse) (0 where masked),
    dP = dO vᵀ, dS = P (dP - D) with D = rowsum(dO ∘ O), dQ += scale · dS
    k, and each tile's dK = scale · dSᵀ q and dV = Pᵀ dO, a kv head's summed
    over its group of query heads in head order.  Inputs as
    ``flash_attention_backward``'s; fp32 math, outputs in the inputs'
    types."""
    return _backward_recurrence(q, k, v, o, lse, do, causal, scale, chunk,
                                lambda x: x)


def flash_attention_backward_tc_plain(q, k, v, o, lse, do, *, causal: bool,
                                      scale: float | None = None,
                                      halves: int = 2, chunk: int = 512):
    """The bf16 backward kernels' arithmetic in plain PyTorch: the
    recurrence of ``flash_attention_backward_plain`` (fp32 products of the
    operands, fp32 sums) with P and dS entering dV = Pᵀ dO, dK = scale ·
    dSᵀ q and dQ = scale · dS k as bf16, rounded once (``halves=1``) or
    split into hi + lo halves (``halves=2``: hi rounds each value, lo
    what hi leaves), as ``attention_tc_plain``'s ``p_halves`` does for the
    forward's P.  Outputs in the inputs' types."""
    if halves not in (1, 2):
        raise ValueError(f"halves must be 1 or 2, got {halves}")

    def rounded(x):
        hi = x.to(torch.bfloat16).float()
        return hi if halves == 1 else hi + (x - hi).to(torch.bfloat16).float()
    return _backward_recurrence(q, k, v, o, lse, do, causal, scale, chunk,
                                rounded)


def _backward_recurrence(q, k, v, o, lse, do, causal, scale, chunk, rounded):
    """dq, dk, dv of the backward's recurrence, P and dS passed through
    ``rounded`` where they enter the three products that take them."""
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    kx, vx = _expand_kv(k, h).float(), _expand_kv(v, h).float()
    qf, dof = q.float(), do.float()
    delta = (dof * o.float()).sum(dim=-1)
    dq = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    dkx = torch.empty((b, h, sk, d), dtype=torch.float32, device=q.device)
    dvx = torch.empty((b, h, sk, dv), dtype=torch.float32, device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None]
    for base in range(0, sk, chunk):
        kc, vc = kx[:, :, base:base + chunk], vx[:, :, base:base + chunk]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kc) * scale
        p = torch.exp(s - lse[..., None])
        if causal:
            cols = base + torch.arange(kc.shape[2], device=q.device)[None, :]
            p = torch.where(rows >= cols, p, 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vc)
        ds = rounded(p * (dp - delta[..., None]))
        p = rounded(p)
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kc) * scale
        dkx[:, :, base:base + chunk] = torch.einsum(
            "bhqk,bhqd->bhkd", ds, qf) * scale
        dvx[:, :, base:base + chunk] = torch.einsum("bhqk,bhqd->bhkd", p,
                                                     dof)
    group = h // hkv
    dk = dkx.reshape(b, hkv, group, sk, d).sum(dim=2)
    dvv = dvx.reshape(b, hkv, group, sk, dv).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             scale: float | None = None):
    """Gradients (dq, dk, dv) of ``flash_attention`` given its inputs, its
    output o (B, H, Sq, Dv), its log-sum-exp lse (B, H, Sq) fp32 and the
    output's gradient do: for CUDA tensors the kernels of
    ``flash_attention_bwd.cu`` (bf16 on the tensor cores through ``wgmma``
    fed by TMA, fp32 on the CUDA cores), for CPU tensors
    ``flash_attention_backward_plain``.  dq is (B, H, Sq, D) and dk, dv
    (B, Hkv, Sk, .), contiguous, in the inputs' type.  Takes what the
    forward kernels take (widths, strides, TMA's alignment on bf16); o and
    do of any strides (the kernels read contiguous copies of them)."""
    if any(t.dim() != 4 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_backward: q, k, v, o, do must be "
                         "4-D")
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    _check_heads("flash_attention_backward", h, hkv)
    if k.shape[0] != b or v.shape[:3] != k.shape[:3]:
        raise ValueError("flash_attention_backward: k and v must be (B, "
                         "Hkv, Sk, .)")
    if tuple(o.shape) != (b, h, sq, dv) or do.shape != o.shape:
        raise ValueError(f"flash_attention_backward: o and do must be "
                         f"{(b, h, sq, dv)}")
    if tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"flash_attention_backward: lse must be "
                         f"{(b, h, sq)}")
    kernels.on_cpu(q, k, v, o, lse, do)
    return kernels.call(
        "flash_attention_backward", q, k, v, o, lse, do, bool(causal),
        float(scale if scale is not None else d ** -0.5))


def _backward_checks(q, k, v, o, lse, do, causal: bool, real: bool) -> None:
    _prefill_checks("flash_attention_backward", q, k, v, causal, real)
    kernels.check_cuda_args(
        "flash_attention_backward", {"o": o, "do": do, "lse": lse},
        {"o": q.dtype, "do": q.dtype, "lse": torch.float32}, real)


def _backward_outputs(q, k, v):
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    return (torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device),
            torch.empty((b, hkv, sk, d), dtype=q.dtype, device=q.device),
            torch.empty((b, hkv, sk, dv), dtype=q.dtype, device=q.device))


def f32_key_tile(d: int, dv: int) -> int:
    """Keys of the fp32 backward kernel's KV tile at widths (d, dv) (its
    ``F32::kKeys``): a call past it takes per-tile dQ partials."""
    return 256 if d + dv <= 64 else 128 if d + dv <= 160 else 64


def _row_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read o and do: contiguous and on a 16-byte
    boundary (TMA's), a copy where it is not."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _flash_attention_backward_launch(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, causal: bool, scale: float
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 8's backward launch on CUDA tensors: (dq, dk, dv)."""
    o, do = _row_ready(o), _row_ready(do)
    _backward_checks(q, k, v, o, lse, do, causal, True)
    dq, dk, dvv = _backward_outputs(q, k, v)
    b, h, sq, d = q.shape
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    part = None
    if q.dtype == torch.float32:
        n_kt = -(-k.shape[2] // f32_key_tile(d, v.shape[-1]))
        if n_kt > 1:
            part = torch.empty((n_kt * b * h * sq * d,), dtype=torch.float32,
                               device=q.device)
    kernels.extension().flash_attention_backward(
        q, k, v, o, do, lse, delta, dq, dk, dvv, part, scale, causal)
    kernels.LAUNCHES["flash_attention_backward"] += 1
    return dq, dk, dvv


def _flash_attention_backward_plain(q, k, v, o, lse, do, causal, scale):
    return flash_attention_backward_plain(q, k, v, o, lse, do, causal=causal,
                                          scale=scale)


def _flash_attention_backward_fake(q, k, v, o, lse, do, causal, scale):
    _backward_checks(q, k, v, o.contiguous(), lse, do.contiguous(), causal,
                     False)
    return _backward_outputs(q, k, v)


kernels.card_op("flash_attention_backward", _flash_attention_backward_launch,
                _flash_attention_backward_plain,
                _flash_attention_backward_fake, _backward_flops,
                _backward_shardings)


def flash_decode(q, k, v, kv_len, *, scale: float | None = None):
    """Single-token attention of q (B, H, D) over caches (B, Hkv, T, D),
    positions >= ``kv_len`` (B,) masked -> (B, H, D) in q's type: for CUDA
    tensors the split-KV decode kernel, one block per (split, kv head, b)
    (bf16 on the tensor cores, fp32 on the CUDA cores), and its merge
    kernel (what ``merge_splits`` of ``decode_partials_plain`` computes);
    ``decode_ref`` for CPU tensors."""
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_decode: q must be 3-D, k and v 4-D")
    b, h, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    _check_heads("flash_decode", h, hkv)
    if k.shape[0] != b or v.shape[:3] != k.shape[:3]:
        raise ValueError("flash_decode: k and v must be (B, Hkv, T, .)")
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"flash_decode: kv_len must be ({b},)")
    kernels.on_cpu(q, k, v, kv_len)
    return kernels.call(
        "flash_decode", q, k, v,
        kv_len.to(device=q.device, dtype=torch.int32).contiguous(),
        float(scale if scale is not None else d ** -0.5))


def _decode_checks(q, k, v, real: bool = True) -> None:
    """What the decode kernels refuse (``real``: as ``_prefill_checks``'s)."""
    b, h, _ = q.shape
    (_check_kernel_inputs if real else _check_widths)("flash_decode", q, k,
                                                      v)
    for key, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_decode: {key} must be contiguous")
    if k.shape[2] < 1 or real and (b > 65535 or h > 65535):
        raise ValueError("flash_decode: empty cache, or B / H beyond the "
                         "grid")


def _flash_decode_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """Kernel 9's launches (split and merge) on CUDA tensors."""
    _decode_checks(q, k, v)
    for key, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_decode: {key} must start on a 16-byte "
                             "boundary")
    b, h, d = q.shape
    n_sp = -(-k.shape[2] // SPLIT)
    part = torch.empty((b * h * n_sp * (d + 2),), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    kernels.extension().flash_decode(q, k, v, kv_len, part, out, scale)
    kernels.LAUNCHES["flash_decode"] += 1
    return out


def _flash_decode_plain(q, k, v, kv_len, scale):
    return decode_ref(q, k, v, kv_len, scale=scale)


def _flash_decode_fake(q, k, v, kv_len, scale):
    _decode_checks(q, k, v, False)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


kernels.card_op("flash_decode", _flash_decode_launch, _flash_decode_plain,
                _flash_decode_fake,
                _decode_flops, _decode_shardings)


def attention(q, k, v, causal: bool = True):
    """The reference's ``ops.attention``: the kernel on the card, the plain
    version on the CPU."""
    return flash_attention(q, k, v, causal=causal)


def decode_attention(q, k, v, kv_len):
    """The reference's ``ops.decode_attention``."""
    return flash_decode(q, k, v, kv_len)
