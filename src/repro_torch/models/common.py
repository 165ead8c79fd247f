"""Numerics shared by the model families: RMS norm, rotary embedding,
SwiGLU, the GELU MLP and the masked cross-entropy; the parameter helpers
(``Leaf`` shapes with their logical axis names, their draw, the plain
MLP); and logical sharding over a ``DeviceMesh``.

Copies of ``rms_norm``, ``rope``, ``swiglu``, ``gelu_mlp`` and
``cross_entropy`` of the reference's ``models/common.py``, with its
promotion order: ``rms_norm`` normalises in fp32 and casts back to x's type
before multiplying by γ; ``rope`` rotates in fp32 and casts back.
``jax.nn.gelu`` is the tanh approximation by default, and so is
``gelu_mlp``'s.  ``dense``, ``mlp_shapes``, ``draw`` and ``mlp`` take
the place of the reference's ``ParamFactory`` and ``_mlp``: a dense leaf
is N(0, 1/first dimension), as ``ParamFactory`` draws it, and each
``Leaf`` carries the logical axis names ``ParamFactory`` records for it
(a stacked leaf's first name is ``"stack"``, as ``_StackedFactory``
prefixes it).

Logical sharding is the reference's (``common.py:60-150``): a leaf's names
resolve under per-run rules to a ``PartitionSpec`` (``resolve_pspec``,
with its axis dropping), fitted to a shape (``fit_spec_to_shape``), and
here turned into DTensor placements on a ``DeviceMesh`` (``placements``).
``use_mesh`` puts a mesh in scope on a process-wide stack (the
``launch/mesh.mesh_context`` of the model code); ``get_abstract_mesh_or_none``
reads it.  The collectives of the mesh branches go over the mesh's groups,
one mesh axis at a time (``all_reduce_axes``, ``all_gather_axes``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, D even); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.gelu(x @ w1 + b1, approximate="tanh")
    return h @ w2 + b2


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean cross-entropy in fp32 over the labels >= 0 (the others are
    ignored).  Logit slots at or past ``vocab`` (padding of the last axis)
    are masked to -1e30 out of the partition function."""
    logits = logits.float()
    if logits.shape[-1] > vocab:
        live = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(live, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    idx = torch.clamp(labels, min=0)[..., None]
    if isinstance(logits, DTensor):
        # each rank selects its own columns (one entry plus zeros)
        cols = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(cols == idx, logits, 0.0).sum(dim=-1)
    else:
        gold = torch.gather(logits, -1, idx)[..., 0]
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class Leaf(NamedTuple):
    """A parameter's shape, fill (``"normal"`` × ``scale``, ``"zeros"`` or
    ``"ones"``) and logical axis names, one a dimension."""
    shape: tuple
    fill: str = "normal"
    scale: float = 0.0
    names: tuple = ()


def _leaf(shape, names, fill, scale, stack) -> Leaf:
    shape = tuple(stack) + tuple(shape)
    names = ("stack",) * len(stack) + tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"names {names} do not fit shape {shape}")
    return Leaf(shape, fill, scale, names)


def dense(shape: tuple, names: tuple, scale: float | None = None,
          stack=()) -> Leaf:
    """A normal leaf at ``scale``, by default 1/√(its first dimension): for
    a leaf with a leading ``stack`` of (L,) that is L, as the reference's
    ``ParamFactory`` draws a stacked leaf."""
    first = (tuple(stack) + tuple(shape))[0]
    return _leaf(shape, names, "normal",
                 scale if scale is not None else 1.0 / math.sqrt(
                     max(first, 1)), stack)


def zeros(shape: tuple, names: tuple, stack=()) -> Leaf:
    return _leaf(shape, names, "zeros", 0.0, stack)


def ones(shape: tuple, names: tuple, stack=()) -> Leaf:
    return _leaf(shape, names, "ones", 0.0, stack)


def shape_leaves(tree) -> list:
    if isinstance(tree, Leaf):
        return [tree]
    return [leaf for v in tree.values() for leaf in shape_leaves(v)]


def leaf_names(tree):
    """The names tree of a ``Leaf`` tree: each leaf's logical axis names."""
    if isinstance(tree, Leaf):
        return tree.names
    return {k: leaf_names(v) for k, v in tree.items()}


def abstract(tree, dtype) -> dict:
    """``meta`` tensors of a ``Leaf`` tree's shapes in ``dtype``: the
    abstract parameters of the dry run (nothing drawn, nothing
    allocated)."""
    if isinstance(tree, dict):
        return {k: abstract(v, dtype) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=dtype, device="meta")


def flat_names(tree, prefix: str = "") -> dict:
    """{"a/b": logical names} of a ``Leaf`` tree, keyed as the reference's
    ``ParamFactory.names`` (``names_tree_of`` reads it back)."""
    if isinstance(tree, Leaf):
        return {prefix[:-1]: tree.names}
    out = {}
    for k, v in tree.items():
        out.update(flat_names(v, f"{prefix}{k}/"))
    return out


def mlp_shapes(dims, stack=()) -> dict:
    """``w{i}`` (a, b) normal, ``b{i}`` (b,) zeros over consecutive
    ``dims``, each with the leading ``stack`` axes; unsharded names, as the
    reference's ``_mlp_params``."""
    ps = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        ps[f"w{i}"] = dense((a, b), (None, None), stack=stack)
        ps[f"b{i}"] = zeros((b,), (None,), stack=stack)
    return ps


def draw(tree, gen: torch.Generator, dtype, device) -> dict:
    """Tensors of a ``Leaf`` tree, the normal leaves drawn from ``gen`` in
    the tree's order."""
    if isinstance(tree, dict):
        return {k: draw(v, gen, dtype, device) for k, v in tree.items()}
    if tree.fill == "zeros":
        return torch.zeros(tree.shape, dtype=dtype, device=device)
    if tree.fill == "ones":
        return torch.ones(tree.shape, dtype=dtype, device=device)
    w = torch.randn(tree.shape, generator=gen, dtype=dtype, device=device)
    return w.mul_(tree.scale)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: (num_segments, ...) sums of ``data``'s rows
    by segment id, ids outside [0, num_segments) dropped.

    One stable sort of the ids, then each segment summed in row order
    (``torch.segment_reduce`` over the sorted rows): the same order on every
    run and on every device, with no float atomics (ROADMAP rule d), the
    order of the reference's host scatter-add.  Differentiable."""
    ids, order = torch.sort(segment_ids.long(), stable=True)
    offsets = torch.searchsorted(
        ids, torch.arange(num_segments + 1, device=ids.device))
    return torch.segment_reduce(data[order], "sum", offsets=offsets, axis=0,
                                unsafe=True)


def promoted(*xs: torch.Tensor) -> tuple:
    """``xs`` in the type JAX computes a product or einsum of them in
    (``torch.promote_types`` over theirs): an fp32 activation times a bf16
    parameter is fp32, and autograd returns the parameter's gradient in
    bf16, as JAX's.  Tensors already of that type are returned as they
    are."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in their promoted type (``promoted``), as ``jnp.matmul``."""
    a, b = promoted(a, b)
    return a @ b


def mlp(params, x: torch.Tensor, act=torch.relu,
        last_act: bool = False) -> torch.Tensor:
    """``x @ w_i + b_i`` for each layer (in the promoted type, as JAX's),
    ``act`` between layers (and after the last with ``last_act``), as the
    reference's ``_mlp``."""
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = matmul(x, params[f"w{i}"]) + params[f"b{i}"]
        if i < n - 1 or last_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# logical sharding
# ---------------------------------------------------------------------------

# default rules for a ("data", "model") mesh; "pod" extends data-parallelism
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "qk": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "seq": None,
    "kv_seq": None,
    "rows": "model",       # embedding-table rows (recsys)
    "cols": None,
    "nodes": ("pod", "data", "model"),   # flat GNN sharding
    "edges": ("pod", "data", "model"),
    "candidates": "model",
    "stack": None,         # scan-over-layers leading axis
}


class PartitionSpec(tuple):
    """A tensor's sharding, one entry a dimension: ``None`` (replicated),
    one mesh axis name, or a tuple of names (major to minor).  A tuple, so
    ``tuple(spec)`` compares with ``tuple(jax.sharding.PartitionSpec)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh(NamedTuple):
    """A mesh's axis names and sizes without devices or ranks (the specs of
    a production mesh, resolved in one process)."""
    axis_names: tuple
    axis_sizes: tuple


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``, in the
    mesh's order."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve_pspec(names: tuple, rules: dict, mesh=None) -> PartitionSpec:
    """Map logical axis names to a ``PartitionSpec`` under ``rules``.

    A mesh axis absent from ``mesh`` (e.g. "pod" on the single-pod mesh) is
    dropped from the spec, and so is one that an earlier entry used."""
    mesh_axes = set(mesh_sizes(mesh)) if mesh is not None else None
    used: set = set()

    def ok(ax):
        return (mesh_axes is None or ax in mesh_axes) and ax not in used

    spec = []
    for n in names:
        r = rules.get(n, None) if n is not None else None
        if r is None:
            spec.append(None)
        elif isinstance(r, tuple):
            kept = tuple(a for a in r if ok(a))
            used.update(kept)
            spec.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            if ok(r):
                used.add(r)
                spec.append(r)
            else:
                spec.append(None)
    return PartitionSpec(*spec)


def tree_pspecs(names_tree, rules: dict, mesh=None):
    """``resolve_pspec`` of every leaf of a names tree (a names tuple is a
    leaf)."""
    if isinstance(names_tree, dict):
        return {k: tree_pspecs(v, rules, mesh) for k, v in names_tree.items()}
    return resolve_pspec(names_tree, rules, mesh)


def _entry_axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else (entry or ())


def fit_spec_to_shape(spec, shape: tuple, mesh) -> PartitionSpec:
    """Drop sharding on dims the mesh axes don't divide evenly."""
    sizes = mesh_sizes(mesh)
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        ways = math.prod(sizes[a] for a in _entry_axes(ax))
        fixed.append(ax if ways > 0 and dim % ways == 0 else None)
    return PartitionSpec(*fixed)


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    axis that splits dimension d, ``Replicate()`` on the others.

    DTensor splits a dimension over its mesh axes in the mesh's order; JAX
    splits it over the spec's tuple major to minor.  The two agree only
    when the tuple lists its axes in mesh order, so any other order
    raises."""
    order = {a: i for i, a in enumerate(mesh_sizes(mesh))}
    out: list = [Replicate()] * len(order)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        pos = [order[a] for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of "
                             f"the mesh's order {tuple(order)}")
        for i in pos:
            out[i] = Shard(d)
    return out


def block_slices(spec, shape: tuple, mesh, coords: dict) -> tuple:
    """The slices of ``shape`` that the rank at mesh coordinates ``coords``
    ({axis: index}) holds under a fitted ``spec``: each dimension cut into
    the product of its axes' sizes, the block index major to minor."""
    sizes = mesh_sizes(mesh)
    out = []
    for dim, entry in zip(shape,
                          tuple(spec) + (None,) * (len(shape) - len(spec))):
        ways, idx = 1, 0
        for a in _entry_axes(entry):
            ways *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        n = dim // ways
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


def mesh_coords(mesh) -> dict:
    """This rank's {axis: index} on a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``DeviceMesh`` and a (fitted) spec: where each block of a tensor
    lives, as ``jax.sharding.NamedSharding``.  (A leaf of a shardings tree,
    not a node: no tuple.)"""
    mesh: Any
    spec: PartitionSpec


def distribute(x, sharding: NamedSharding) -> DTensor:
    """A whole array (a tensor or NumPy array, held by every rank) as a
    DTensor of ``sharding``: this rank keeps its own block
    (``block_slices``), moved to the mesh's device type, and waits on no
    other rank."""
    mesh, spec = sharding.mesh, sharding.spec
    x = torch.as_tensor(x).contiguous()
    block = x[block_slices(spec, x.shape, mesh, mesh_coords(mesh))]
    return DTensor.from_local(
        block.to(torch.device(mesh.device_type)).contiguous(), mesh,
        placements(spec, mesh), run_check=False, shape=x.shape,
        stride=x.stride())


def _whole_unless_even(x: DTensor, dim: int, count: int) -> DTensor:
    """``x`` with ``dim`` gathered whole unless the ranks that split it
    (plain or strided shards) divide ``count``."""
    split = [getattr(pl, "dim", None) == dim for pl in x.placements]
    ways = math.prod(x.device_mesh.size(i) for i, s in enumerate(split) if s)
    if count % ways == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if s else pl for s, pl in zip(split, x.placements)])


def split_last(x, heads: int, width: int):
    """x (..., heads · width) viewed as (..., heads, width).  On a DTensor
    whose last dimension is split over ranks that do not divide ``heads``,
    that dimension is gathered first (each rank then holds whole heads, as
    XLA reshards the reference's reshape)."""
    if isinstance(x, DTensor):
        x = _whole_unless_even(x, x.dim() - 1, heads)
    return x.reshape(*x.shape[:-1], heads, width)


def merge_last(x):
    """x (..., heads, width) viewed as (..., heads · width).  On a DTensor
    whose heads are split over ranks that do not divide them, the heads are
    gathered first, and pending sums reduced."""
    if isinstance(x, DTensor):
        if any(pl.is_partial() for pl in x.placements):
            # sums pending over ranks reduced first: the merge would split
            # the heads to scatter them
            x = x.redistribute(x.device_mesh, [
                Replicate() if pl.is_partial() else pl
                for pl in x.placements])
        x = _whole_unless_even(x, x.dim() - 2, x.shape[-2])
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def to_region(x, mesh, spec):
    """A region's input on this rank (a ``shard_map`` in-spec): a DTensor
    redistributed to ``spec`` and its local block; a plain tensor (each
    rank's whole value) cut to its block of ``spec``."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(spec, mesh)).to_local()
    return x[block_slices(spec, x.shape, mesh, mesh_coords(mesh))]


def from_region(x, mesh, spec) -> DTensor:
    """A region's output (a ``shard_map`` out-spec): this rank's block as a
    DTensor of ``spec``, replicated over the axes ``spec`` leaves out."""
    sizes = mesh_sizes(mesh)
    shape = [dim * math.prod(sizes[a] for a in _entry_axes(entry))
             for dim, entry in zip(x.shape, tuple(spec) + (None,) * (
                 x.dim() - len(spec)))]
    return DTensor.from_local(x, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(math.prod(shape[i + 1:])
                                           for i in range(len(shape))))


# the meshes in scope, one process-wide stack: a backward that recomputes
# a checkpointed layer runs on the autograd engine's device thread, and
# must take the mesh branches its forward took
_MESH_STACK: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Put ``mesh`` in scope for the model code."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def get_abstract_mesh_or_none():
    """The mesh in scope (``use_mesh``), or None."""
    return _MESH_STACK[-1] if _MESH_STACK else None


def constrain(x, names: tuple, rules: dict, mesh=None):
    """Redistribute a DTensor to the fitted spec of its logical names.

    No-op when no mesh is in scope, as the reference's; a plain tensor (each
    rank's whole value) is returned unchanged."""
    m = mesh or get_abstract_mesh_or_none()
    if m is None or not isinstance(x, DTensor):
        return x
    spec = fit_spec_to_shape(resolve_pspec(names, rules, m), x.shape, m)
    return x.redistribute(m, placements(spec, m))


def names_tree_of(params, names: dict):
    """A names tree congruent with ``params`` from a flat {"a/b": names}
    dict, keyed by the '/'-joined nesting keys of each leaf."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        return names[prefix[:-1]]
    return walk(params, "")


def _axes_tuple(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def all_reduce_axes(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (one axis name or a
    tuple), one mesh axis at a time in the mesh's order; a new tensor."""
    out = x.clone()
    for a in _axes_tuple(axes):
        dist.all_reduce(out, group=mesh.get_group(a))
    return out


def all_gather_axes(x: torch.Tensor, mesh, axes, dim: int = 0
                    ) -> torch.Tensor:
    """The blocks of ``x`` over the ranks of ``axes``, concatenated along
    ``dim`` with the block index major to minor over ``axes`` (gathered
    over the minor axis first)."""
    out = x.contiguous()
    for a in reversed(_axes_tuple(axes)):
        group = mesh.get_group(a)
        parts = [torch.empty_like(out)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, out, group=group)
        out = torch.cat(parts, dim=dim)
    return out


def sum_axes_ordered(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, added in a fixed order:
    one axis at a time (in the order given), each axis's blocks gathered
    and added in rank order, with no float atomics and no reduction order
    left to the backend.  An axis of one rank adds nothing."""
    out = x
    for a in _axes_tuple(axes):
        group = mesh.get_group(a)
        n = dist.get_world_size(group)
        if n == 1:
            continue
        parts = [torch.empty_like(out) for _ in range(n)]
        dist.all_gather(parts, out.contiguous(), group=group)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
    return out


def block_index(mesh, axes) -> tuple[int, int]:
    """(this rank's block over ``axes``, major to minor, and the block
    count)."""
    sizes, coords = mesh_sizes(mesh), mesh_coords(mesh)
    idx, n = 0, 1
    for a in _axes_tuple(axes):
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    return idx, n


class _BlockOf(torch.autograd.Function):
    """This rank's block of a whole tensor held by every rank (a region's
    in-spec that splits ``dim`` over ``axes``): its backward gathers the
    blocks' gradients over ``axes``, so every rank holds the whole
    gradient again."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        idx, n = block_index(mesh, axes)
        size = x.shape[dim] // n
        return x.narrow(dim, idx * size, size)

    @staticmethod
    def backward(ctx, g):
        return (all_gather_axes(g, ctx.mesh, ctx.axes, ctx.dim), None, None,
                None)


def block_of(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (see
    ``_BlockOf``)."""
    return _BlockOf.apply(x, mesh, _axes_tuple(axes), dim)


class _GatherBlocks(torch.autograd.Function):
    """The ranks' blocks gathered over ``axes`` into the whole tensor on
    every rank; its backward passes each rank only its own block of the
    gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather_axes(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        idx, n = block_index(ctx.mesh, ctx.axes)
        size = g.shape[ctx.dim] // n
        return g.narrow(ctx.dim, idx * size, size), None, None, None


def gather_blocks(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The blocks of ``axes`` gathered along ``dim`` (see
    ``_GatherBlocks``)."""
    return _GatherBlocks.apply(x, mesh, _axes_tuple(axes), dim)


def _need(mesh):
    if mesh is None:
        raise ValueError("a collective over mesh axes needs a mesh in scope "
                         "(launch/mesh.mesh_context)")
    return mesh


def _axes_size(mesh, axes) -> int:
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in _axes_tuple(axes))


class _Psum(torch.autograd.Function):
    """``lax.psum`` inside ``shard_map``: a sum over the ranks of the axes,
    whose transpose is the same sum."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce_axes(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_axes(g, ctx.mesh, ctx.axes), None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, differentiable as JAX
    differentiates ``psum`` (its backward sums the cotangents too)."""
    return _Psum.apply(x, _need(mesh), axes)


class _ReplicatedIn(torch.autograd.Function):
    """Leaves entering a per-rank region replicated: the identity, whose
    backward sums each leaf's gradient over the region's ranks (the
    transpose of a ``shard_map`` in-spec ``P()``)."""

    @staticmethod
    def forward(ctx, mesh, axes, *leaves):
        ctx.mesh, ctx.axes = mesh, axes
        return tuple(leaf.view_as(leaf) for leaf in leaves)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(
            None if g is None else all_reduce_axes(g, ctx.mesh, ctx.axes)
            for g in grads)


def replicate_in(tree: dict, mesh, axes) -> dict:
    """``tree``'s tensors as a region's replicated inputs on this rank (see
    ``_ReplicatedIn``)."""
    keys, leaves = [], []

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                keys.append(prefix + (k,))
                leaves.append(v)
    walk(tree, ())
    out: dict = {}
    for key, leaf in zip(keys, _ReplicatedIn.apply(_need(mesh), axes,
                                                   *leaves)):
        node = out
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = leaf
    return out


class _ReplicatedOut(torch.autograd.Function):
    """A region's output replicated over its ranks: the identity, whose
    backward divides the cotangent by the rank count (JAX's transpose of a
    ``shard_map`` out-spec ``P()``: each rank carries its share)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def replicate_out(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return _ReplicatedOut.apply(x, _axes_size(_need(mesh), axes))
