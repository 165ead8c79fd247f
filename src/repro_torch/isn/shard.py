"""Document-sharded distributed ISN — the paper's architecture over ranks.

The port of ``repro.isn.shard`` on ``torch.distributed``.  Documents shard
over the mesh's "model" axis (each model rank is one ISN index partition
holding BOTH mirrors); query batches shard over ("pod", "data").  One
serve step runs the full Stage-0 pipeline on the rank's device:

  features (term-stat gather) → GBRT predictions (k̂, ρ̂, t̂) → route →
  JASS mirror (ρ̂ capped at ρ_max) ∥ BMW mirror (rank-safe) →
  per-shard top-k → ``all_gather`` over "model" → global top-k merge.

Where the reference's ``shard_map`` hands each device its block of the
stacked inputs, each rank here calls the step with its own pieces
(``rank_inputs`` cuts them from the reference's stacked layout).  Both
mirrors run on every query of every rank, through the port's kernel
wrappers (``saat_serve``: kernel 1; ``daat_serve``: kernel 2, two
launches a block of 64 queries), and every collective runs at world size
1 too (NCCL on the card, gloo on the CPU).

Exactness: Stage-0 is the reference's float32 arithmetic bit for bit —
``features.extract``, bins as int32 counts of ``x > edge``, the tree sum
in the reference's compiled order (``trees._sum_trees``, base added
after), and ``features.xla_expm1`` in place of ``expm1`` — since one ulp
flips a route or the integer part of ρ.  On the card that is two launches
a step, ``stage0_features`` and ``stage0_forest`` (``kernels/stage0``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import features
from repro_torch.index.postings import IndexShard
from repro_torch.isn.backend import merge_shard_topk, resolve_backend
from repro_torch.isn.daat import daat_serve
from repro_torch.isn.saat import saat_serve
from repro_torch.kernels.stage0 import ops as s0
from repro_torch.models import common
from repro_torch.serving.telemetry.host import span

STAGE0_TARGETS = ("k", "rho", "t")


class ForestArrays(NamedTuple):
    """Flat GBRT ensemble for in-step Stage-0 inference (3 targets)."""
    feat: torch.Tensor       # (3, T, D, W) int32
    thresh: torch.Tensor     # (3, T, D, W) int32
    leaf: torch.Tensor       # (3, T, 2**D) float32
    base: torch.Tensor       # (3,) float32
    bin_edges: torch.Tensor  # (147, B-1) float32


def forest_specs(n_targets=3, n_trees=64, depth=5, n_feats=147, n_bins=64):
    """Shapes and dtypes of a ``ForestArrays``, as ``meta`` tensors."""
    w = 2 ** (depth - 1)

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return ForestArrays(
        feat=spec((n_targets, n_trees, depth, w), torch.int32),
        thresh=spec((n_targets, n_trees, depth, w), torch.int32),
        leaf=spec((n_targets, n_trees, 2 ** depth), torch.float32),
        base=spec((n_targets,), torch.float32),
        bin_edges=spec((n_feats, n_bins - 1), torch.float32),
    )


def stage0_forest(models: dict) -> ForestArrays:
    """The fitted Stage-0 GBRTs (``{"k", "rho", "t"}`` → ``GBRTModel``) as
    one ``ForestArrays``, targets in that order.  The step bins the
    features once, so the three models' bin edges must be equal; raises
    ValueError when they are not."""
    ms = [models[name] for name in STAGE0_TARGETS]
    edges = ms[0].bin_edges
    for name, m in zip(STAGE0_TARGETS[1:], ms[1:]):
        if m.bin_edges.shape != edges.shape or not torch.equal(
                m.bin_edges, edges):
            raise ValueError(f"Stage-0 model {name!r} bins its features "
                             "with other edges than 'k'")
    return ForestArrays(
        feat=torch.stack([m.forest.feat for m in ms]),
        thresh=torch.stack([m.forest.thresh for m in ms]),
        leaf=torch.stack([m.forest.leaf for m in ms]),
        base=torch.stack([m.base.float().reshape(()) for m in ms]),
        bin_edges=edges.contiguous())


@span("stage0.forest")
def _forest_predict(fa: ForestArrays, x: torch.Tensor,
                    depth: int) -> torch.Tensor:
    """Fixed-depth descent of the three targets' trees: x (Q, F) raw
    features -> (3, Q) predictions, the base added after the tree sum,
    through ``xla_expm1``.  One ``stage0_forest`` launch on the card."""
    return s0.stage0_forest(x, fa.bin_edges, fa.feat, fa.thresh, fa.leaf,
                            fa.base, depth=depth, expm1=True)


@span("stage0")
def _stage0(fa, term_stats, df, terms, mask, depth=5):
    """147 features + three GBRT predictions, each through the compiled
    program's ``expm1``: two launches on the card."""
    x = features.extract(term_stats, df, terms, mask)
    return tuple(_forest_predict(fa, x, depth))


def _query_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _query_rank(mesh) -> tuple[int, int]:
    """(this rank's index over the flattened ("pod", "data") axes, their
    size)."""
    idx, size = 0, 1
    for a in _query_axes(mesh):
        n = mesh.shape[mesh.mesh_dim_names.index(a)]
        idx, size = idx * n + mesh.get_local_rank(a), size * n
    return idx, size


def _model_axis(mesh) -> tuple[int, int]:
    """(this rank's model rank, the model axis's size)."""
    return (mesh.get_local_rank("model"),
            mesh.shape[mesh.mesh_dim_names.index("model")])


def rank_inputs(mesh, index, term_stats, terms, mask):
    """The calling rank's pieces of the reference's stacked step inputs —
    the counterpart of its ``in_specs``: the model rank's slice of every
    field of the stacked index (an ``IndexShard`` of arrays with a leading
    model axis) and of ``term_stats`` (n_model, V, 36), and the query rank's
    block of rows of ``terms`` and ``mask`` (Q, L), the ranks of ("pod",
    "data") flattened.  Arrays or tensors in, tensors on the mesh's device
    out: (shard, term_stats, terms, mask)."""
    dev = torch.device(mesh.device_type)
    m, _ = _model_axis(mesh)
    qi, qn = _query_rank(mesh)

    def take(a, dtype=None):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return torch.from_numpy(np.array(a, dtype, order="C")).to(dev)

    q = np.shape(terms)[0]
    if q % qn:
        raise ValueError(f"{q} query rows do not split over {qn} ranks")
    rows = slice(qi * (q // qn), (qi + 1) * (q // qn))
    shard = IndexShard(*(take(np.asarray(getattr(index, f))[m])
                         for f in IndexShard._fields))
    return (shard, take(np.asarray(term_stats)[m], np.float32),
            take(np.asarray(terms)[rows], np.int32),
            take(np.asarray(mask)[rows], np.float32))


def hybrid_serve_fn(mesh, *, n_docs_shard: int, n_model: int, k_shard: int,
                    k_global: int, rho_max: int, daat_cap: int,
                    daat_bcap: int, n_blocks: int, block_size: int,
                    t_k: float, t_time: float, forest_depth: int = 5,
                    tile_d: int = 128, backend: str | None = None):
    """Builds the hybrid serve step of one rank of ``mesh``.

    Returns ``serve(shard, fa, term_stats, terms, mask)`` → ``(ids, scores,
    work, route)``, which every rank of the mesh calls with its own pieces:
    its ``IndexShard`` (no stacked axis), its (V, 36) term stats, and its
    query rank's (Q_r, L) block of rows.  ``ids`` (Q_r, k_global) int32 are
    global doc ids (shard-local ids + model rank · ``n_docs_shard``, as the
    reference adds them), ``scores`` float32; ties in the merge go to the
    lower model rank, then the lower in-shard position, as ``lax.top_k``
    over the gathered lists gives them.

    ``work`` (int32) and ``route`` (bool, True for JASS) are model rank 0's
    on every rank, broadcast over the "model" group: each rank's Stage-0
    reads its own shard's ``df``, and the reference's ``out_specs`` declare
    the two replicated over "model" (``check_rep=False``), so reading them
    gives model rank 0's.

    ``backend`` is None or a reference backend name and selects nothing:
    the path follows the mesh's device (the kernels on the card, their
    plain versions on the CPU).  ``daat_cap`` and ``rho_max``'s role as the
    gather width size only the reference's jnp gathers: the kernel path
    scores every posting of a matched term, so it equals the reference's
    CPU step where ``daat_cap`` ≥ the shard's largest ``df`` (the
    reference's own parity condition), and ``rho_max`` still caps ρ.
    """
    resolve_backend(backend, mesh.device_type)
    model_rank, n_axis = _model_axis(mesh)
    if n_axis != n_model:
        raise ValueError(f"n_model {n_model} but the mesh's model axis has "
                         f"{n_axis} ranks")
    if k_global > n_model * k_shard:
        raise ValueError(f"k_global {k_global} exceeds the {n_model} x "
                         f"{k_shard} gathered candidates")
    group = mesh.get_group("model")
    root = dist.get_global_rank(group, 0)
    t_k32, t_time32 = (float(np.float32(t)) for t in (t_k, t_time))
    offset = model_rank * n_docs_shard

    @span("serve")
    def serve(shard: IndexShard, fa: ForestArrays, term_stats, terms, mask):
        if shard.df.device.type != mesh.device_type:
            raise ValueError(f"the shard lies on {shard.df.device}, the mesh "
                             f"on {mesh.device_type}")
        pk, prho, pt = _stage0(fa, term_stats, shard.df, terms, mask,
                               forest_depth)
        with span("stage1"):
            route_jass = (pk > t_k32) | (pt > t_time32)   # Algorithm 2
            rho = torch.clamp(prho, 1024, rho_max).to(torch.int32)

            saat = saat_serve(shard, terms, mask, rho, n_docs=n_docs_shard,
                              k=k_shard, tile_d=tile_d)
            theta = torch.ones((terms.shape[0],), dtype=torch.float32,
                               device=terms.device)
            daat = daat_serve(shard, terms, mask, theta, n_docs=n_docs_shard,
                              n_blocks=n_blocks, block_size=block_size,
                              k=k_shard, bcap=daat_bcap, tile_d=tile_d)

            ids = torch.where(route_jass[:, None], saat.topk_docs,
                              daat.topk_docs)
            sc = torch.where(route_jass[:, None], saat.topk_scores,
                             daat.topk_scores).contiguous()
            work = torch.where(route_jass, saat.work,
                               daat.work.to(torch.int32))

            # globalize doc ids and merge across ISN shards
            gids = (ids + offset).contiguous()
            all_sc = [torch.empty_like(sc) for _ in range(n_model)]
            all_ids = [torch.empty_like(gids) for _ in range(n_model)]
            with span("stage1.gather"):
                dist.all_gather(all_sc, sc, group=group)
                dist.all_gather(all_ids, gids, group=group)
            top_ids, top_sc = merge_shard_topk(all_sc, all_ids, k_global)

            # model rank 0's work and route on every rank
            wr = torch.stack([work, route_jass.to(torch.int32)], dim=1)
            with span("stage1.gather"):
                dist.broadcast(wr, src=root, group=group)
        return top_ids, top_sc, wr[:, 0].contiguous(), wr[:, 1] > 0

    return serve



def serve_cell_sizes(cfg, n_model: int) -> dict:
    """``hybrid_serve_fn``'s sizes for one model rank of a mesh whose
    "model" axis has ``n_model`` ranks, under the ISN configuration
    ``cfg``: the reference's ``build_serve_cell`` arithmetic
    (``repro/isn/shard.py:167-185``).  ``daat_cap`` bounds the reference's
    gather backends' lane budget; ``k_global`` is ``k_max``, which only a
    mesh of ``n_model · k_shard >= k_max`` candidates can take."""
    n_docs_shard = cfg.n_docs // n_model
    n_blocks = n_docs_shard // cfg.block_size
    return dict(n_docs_shard=n_docs_shard, n_model=n_model,
                k_shard=min(cfg.k_max // 4, 1024), k_global=cfg.k_max,
                rho_max=cfg.rho_max, daat_cap=min(n_docs_shard, 1 << 19),
                daat_bcap=min(n_blocks, 1 << 14), n_blocks=n_blocks,
                block_size=cfg.block_size, t_k=1000.0, t_time=150.0,
                tile_d=cfg.tile_d)


def _stacked_index_specs(cfg, n_model: int) -> IndexShard:
    """The per-shard index stacked over "model", as ``meta`` tensors of the
    reference's shapes and types (``repro/isn/shard.py:134-152``)."""
    v, p, pb = cfg.vocab, cfg.postings_per_shard, cfg.block_entries_per_shard
    nt = max(1, -(-(cfg.n_docs // n_model) // cfg.tile_d))
    tc = cfg.tile_cap

    def s(shape, dt=torch.int32):
        return torch.empty((n_model,) + shape, dtype=dt, device="meta")

    return IndexShard(
        df=s((v,)), offsets=s((v + 1,)),
        docs_imp=s((p,)), imp=s((p,)), level_cum=s((v, cfg.n_levels)),
        docs=s((p,)), score=s((p,), torch.float32),
        bm_offsets=s((v + 1,)), bm_block_id=s((pb,)),
        bm_block_max=s((pb,), torch.float32), bm_block_cnt=s((pb,)),
        tile_docs=s((nt, tc)), tile_terms=s((nt, tc)),
        tile_scores=s((nt, tc), torch.float32), tile_imps=s((nt, tc)),
    )


def _local(x, mesh, axes, dim=0):
    """This rank's block of a step input: a DTensor's local shard, or the
    block of a whole tensor held by every rank."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.to_local()
    idx, n = common.block_index(mesh, axes)
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


def build_serve_cell(arch_id, cfg, cell, mesh, rules, CellCls):
    """The ISN serve cell of ``launch/steps.build_cell``: the reference's
    ``build_serve_cell`` (``repro/isn/shard.py:155-198``) over this port's
    step.  Its arguments are the stacked (model, ...) index and term stats,
    the forest, and the (Q, L) queries; its ``fn`` gives each rank its own
    slice of each (a DTensor's local shard, or the block of a whole tensor
    as ``rank_inputs`` cuts it), runs ``hybrid_serve_fn`` with
    ``serve_cell_sizes`` on the mesh, and returns the results in the
    out-shardings' layout (DTensors for DTensor inputs; else the query
    blocks gathered, so every rank returns the whole batch).  The step is
    built on the first call, so the cell itself needs no process group."""
    from torch.distributed.tensor import DTensor
    n_model = common.mesh_sizes(mesh).get("model", 1)
    sizes = serve_cell_sizes(cfg, n_model)
    qaxes = tuple(a for a in ("pod", "data") if a in common.mesh_sizes(mesh))
    # one axis by its name, as JAX's PartitionSpec normalizes a 1-tuple
    entry = qaxes[0] if len(qaxes) == 1 else (qaxes or None)
    qspec = common.P(entry, None)
    q1spec = common.P(entry)
    built = {}

    def fn(index, fa, term_stats, terms, mask):
        if "step" not in built:
            built["step"] = hybrid_serve_fn(mesh, **sizes)
        shard = IndexShard(*(_local(a, mesh, "model")[0] for a in index))
        fa_l = ForestArrays(*(a.to_local() if isinstance(a, DTensor) else a
                              for a in fa))
        out = built["step"](shard, fa_l, _local(term_stats, mesh, "model")[0],
                            _local(terms, mesh, qaxes),
                            _local(mask, mesh, qaxes))
        if isinstance(terms, DTensor):
            return tuple(DTensor.from_local(
                o, mesh, common.placements(sp, mesh), run_check=False)
                for o, sp in zip(out, (qspec, qspec, q1spec, q1spec)))
        return tuple(common.all_gather_axes(o, mesh, qaxes) for o in out)

    q = cfg.queries_per_step
    index = _stacked_index_specs(cfg, n_model)
    fa = forest_specs()
    term_stats = torch.empty((n_model, cfg.vocab, 36), dtype=torch.float32,
                             device="meta")
    terms = torch.empty((q, cfg.query_len), dtype=torch.int32, device="meta")
    mask = torch.empty((q, cfg.query_len), dtype=torch.float32,
                       device="meta")
    qsh = common.NamedSharding(mesh, qspec)
    q1 = common.NamedSharding(mesh, q1spec)
    ish = IndexShard(*[common.NamedSharding(mesh, common.P("model"))]
                     * len(IndexShard._fields))
    fsh = ForestArrays(*[common.NamedSharding(mesh, common.P())] * 5)
    tsh = common.NamedSharding(mesh, common.P("model"))
    meta = {"n_docs": cfg.n_docs, "postings": cfg.postings_per_shard * n_model,
            "rho_max": cfg.rho_max, "queries": q}
    return CellCls(arch_id, cell.name, "isn", "serve", fn,
                   (index, fa, term_stats, terms, mask),
                   (ish, fsh, tsh, qsh, qsh), (qsh, qsh, q1, q1), (), meta)
