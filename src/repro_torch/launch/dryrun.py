"""Dry run: every (arch × shape) cell as one rank of the production mesh,
with its FLOPs, bytes, collectives and memory per rank, and a roofline.

The port of the reference's ``launch/dryrun.py``.  The reference lowers and
compiles each cell on a 512-device host mesh and reads XLA's analyses; the
port has no compiled program to read, so it runs the cell's step itself:

* **The production mesh in one process.**  ``make_production_mesh`` over a
  ``fake`` process group of 256 (16 × 16) or 512 (2 × 16 × 16) ranks
  (``fake_group``), created when no group exists and destroyed after the
  cell; it never leaves a group behind.
* **Each rank's program.**  The cell's arguments become DTensors of its
  in-shardings, each rank's block a fake tensor on the card's device type
  (``--device cuda``, the default; ``--device cpu`` fakes the CPU path), and
  the step runs as rank 0 under ``FakeTensorMode`` inside
  ``mesh_context``: it launches nothing and reads no data, so it needs no
  card.  ``RankCounter`` sees every operation that DTensor issues on the
  local blocks (it returns ``NotImplemented`` to DTensor's own dispatch, so
  an operation on DTensors is counted once, at its local shapes, and the
  global program is never counted as a rank's); DTensor's sharding
  propagation, which runs operations at global shapes to learn their
  output's metadata, is not counted.  A cell whose step the model code
  cannot run on DTensors fails with that error, which the record carries.
* **Kernels under fake tensors.**  Kernels 1, 2, 6, 8 (forward and
  backward) and 9 are custom operators (``kernels.card_op``): their fakes
  run the card wrappers' input checks and give the outputs' shapes, their
  FLOP formulas count what ``PERF.md``'s bounds count, and their DTensor
  strategies run each kernel on a rank's blocks.
* **Collectives** are counted by output bytes, keyed as the reference's
  ``collective_bytes`` keys its five kinds, plus ``n_ops`` and ``total``:
  the functional collectives of DTensor's redistributions and the
  ``torch.distributed`` calls of the model code's mesh branches.  A kind the
  reference has no key for (``broadcast``, which the ISN step issues) has
  one of its own and counts in ``total``.
* **Memory** per rank: ``argument_size`` (the arguments' local blocks),
  ``output_size`` (the outputs' local blocks, those that alias a donated
  argument not counted twice) and ``temp_size`` (the peak of the storages
  the step allocated and held at once).  ``memory_traffic_bytes`` is the
  reference's; ``hlo_bytes_unfused`` is the sum of every operation's operand
  and output bytes at local shapes, the same unfused upper bound.
* **The roofline** keeps the reference's form with the H100 SXM's published
  rates (``PEAK_FLOPS``, ``HBM_BW``, ``NET_BW``): modeled, not measured.
* **``exact_costs``**: the port runs its layers in Python, so each run
  counts every layer.  The record keeps the reference's two-depth fields
  (``per_layer``, ``outside``, ``depth``) from ``config_override`` runs at
  two depths, and ``exact`` says whether their extrapolation equals the
  full-depth count.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out build/dryrun.json
  # on the CPU build of torch the card's fake tensors cannot be indexed:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import make_production_mesh, mesh_context
from repro_torch.launch.steps import build_cell
from repro_torch.models import common

# H100 SXM (per GPU), published rates: NVIDIA H100 Tensor Core GPU
# datasheet — bf16 dense tensor-core peak and HBM3 bandwidth; the network
# rate is one 400 Gb/s NIC (ConnectX-7) a GPU, the link a 16-wide "model"
# axis crosses between two 8-GPU nodes.  Modeled, not measured.
PEAK_FLOPS = 989e12        # bf16 dense, FLOP/s
HBM_BW = 3.35e12           # B/s, HBM3
NET_BW = 50e9              # B/s, 400 Gb/s

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# the collectives a rank issues, by operator, and the key each counts under
_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced":
    "all-gather", "allgather_": "all-gather", "_allgather_base_":
    "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "all_to_all_single": "all-to-all", "alltoall_":
    "all-to-all", "alltoall_base_": "all-to-all", "send": "collective-permute",
    "recv_": "collective-permute", "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional")

# families whose depth a config field sets (the reference's _DEPTH_FIELD)
_DEPTH_FIELD = {"lm": "n_layers", "gnn": "n_blocks", "recsys": "n_blocks"}


class DryRunError(RuntimeError):
    """A cell that the dry run cannot run as one rank."""


def roofline(flops, mem_bytes, coll_bytes, n_chips) -> dict:
    """Three roofline terms in seconds, per rank: the rank's FLOPs over the
    card's peak, its memory traffic over HBM, its collective bytes over the
    network."""
    return {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": mem_bytes / HBM_BW,
        "collective_s": coll_bytes / NET_BW,
    }


def memory_traffic_bytes(mem_info: dict, hlo_bytes: float) -> float:
    """HBM traffic estimate for the memory roofline term (the reference's):
    arguments read + outputs written + temporaries written and read once,
    capped by the unfused operation bytes."""
    a = mem_info.get("argument_size") or 0
    o = mem_info.get("output_size") or 0
    t = mem_info.get("temp_size") or 0
    est = a + o + 2 * t
    if est <= 0:
        return hlo_bytes
    return min(est, hlo_bytes) if hlo_bytes else est


def empty_collectives() -> dict:
    out = {k: 0 for k in _COLLECTIVES}
    out["n_ops"] = {k: 0 for k in _COLLECTIVES}
    out["total"] = 0
    return out


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


def _collective_out(name: str, args, out):
    """The tensors a collective writes: the functional ones return them;
    the in-place ``c10d`` ones write their first (output) argument."""
    if name.endswith("_") or name in ("send",):
        return args[0]
    return out


class _Pause:
    """How deep the dry run is inside DTensor's bookkeeping (process-wide:
    a backward runs on the autograd engine's device thread)."""
    n = 0
    by_frames = False


_PAUSE = _Pause()


def _paused() -> bool:
    if _PAUSE.n > 0:
        return True
    if _PAUSE.by_frames:
        # a torch without the patched entry: look for the propagator's
        # module among the callers
        f = sys._getframe(2)
        while f is not None:
            if f.f_code.co_filename.endswith("_sharding_prop.py"):
                return True
            f = f.f_back
    return False


# results of DTensor's pure bookkeeping functions, kept across cells: its
# specs carry the mesh, so one mesh's entries never answer another's
_MEMO: dict = {}


def _wrap(owner, names, unfake: bool, memo: bool = False):
    """Patch the first of ``names`` that ``owner`` (a class or a module)
    has so that nothing it runs is counted (with ``unfake``, run with no
    fake mode active; with ``memo``, its results kept by argument: the
    function is pure); returns an undo function, or None when ``owner``
    has none of them."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    space = vars(owner)
    name = next((n for n in names if n in space), None)
    if name is None:
        return None
    orig = space[name]
    fn = orig.__func__ if isinstance(orig, staticmethod) else orig
    cache = _MEMO.setdefault((owner, name), {})

    def wrapped(*a, **k):
        key = (a, tuple(sorted(k.items()))) if memo else None
        if memo and key in cache:
            return cache[key]
        _PAUSE.n += 1
        try:
            if unfake:
                with unset_fake_temporarily():
                    out = fn(*a, **k)
            else:
                out = fn(*a, **k)
        finally:
            _PAUSE.n -= 1
        if memo:
            cache[key] = out
        return out

    setattr(owner, name, staticmethod(wrapped)
            if isinstance(orig, staticmethod) else wrapped)
    return lambda: setattr(owner, name, orig)


@contextlib.contextmanager
def _dtensor_bookkeeping():
    """Count nothing of DTensor's own bookkeeping: its sharding propagation,
    which runs operations at global shapes to learn an output's metadata
    (patched where this torch has a known entry for it, else told by the
    callers' frames);
    a strided shard's size and offset, which it computes from an index
    tensor (run with no fake mode active: it reads the indices); and the
    cost of a redistribution, which it plans by search.  The last two are
    pure functions of their arguments and are kept by argument, since the
    search over a three-axis mesh costs seconds a call."""
    from torch.distributed.tensor import _sharding_prop as sp
    from torch.distributed.tensor import placement_types as pt
    undo = [_wrap(sp.ShardingPropagator,
                  ("_propagate_tensor_meta_non_cached",
                   "_propagate_tensor_meta"), False)]
    # without a known entry, tell the propagator's operations by their
    # callers' frames
    _PAUSE.by_frames = undo[0] is None
    if hasattr(pt, "_StridedShard"):
        undo.append(_wrap(pt._StridedShard,
                          ("local_shard_size_and_offset",
                           "_local_shard_size_and_offset"), True, True))
    from torch.distributed.tensor import _redistribute as rd
    undo.append(_wrap(rd, ("_gen_transform_infos_non_cached",), False, True))
    try:
        yield
    finally:
        _PAUSE.by_frames = False
        for u in reversed(undo):
            if u is not None:
                u()


class RankCounter(TorchDispatchMode):
    """Counts one rank's program: every operation on plain (local) tensors,
    at their shapes — FLOPs by ``torch.utils.flop_counter``'s formulas (the
    kernels' custom operators register theirs), operand and output bytes,
    collectives by output bytes — and the storages the operations allocate,
    for the peak held at once.  Operations on DTensors go to DTensor, whose
    local operations come back here."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.op_bytes = 0
        self.coll = empty_collectives()
        self.live = 0
        self.peak = 0
        self._seen = set()

    def _freed(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def _track(self, out):
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            weakref.finalize(st, self._freed, key, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _paused():
            return out
        ns, name = func.namespace, func._opname
        if ns in _NAMESPACES:
            kind = _KIND.get(name)
            if kind is not None:
                nb = _nbytes(_collective_out(name, args, out))
                self.coll[kind] = self.coll.get(kind, 0) + nb
                self.coll["n_ops"][kind] = self.coll["n_ops"].get(kind, 0) + 1
                self.coll["total"] += nb
            self._track(out)
            return out
        if ns == "prim" or func.is_view:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        self.op_bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        self._track(out)
        return out


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks (this process rank
    0) when none exists, destroyed on exit; an existing group is used as it
    is."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed import fake_pg
    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, spec, mesh) -> tuple:
    """Rank 0's block of ``shape`` under ``spec``: DTensor's split (a
    dimension the axes do not divide leaves rank 0 the larger block)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with unset_fake_temporarily():
        local, _ = compute_local_shape_and_global_offset(
            tuple(shape), mesh, common.placements(spec, mesh))
    return tuple(local)


def _fake_args(args, shardings, mesh, device):
    """Each argument a DTensor of its sharding, its local block a fake
    tensor on ``device`` (inside ``FakeTensorMode``)."""
    if isinstance(args, dict):
        return {k: _fake_args(v, shardings[k], mesh, device)
                for k, v in args.items()}
    if isinstance(args, (tuple, list)):
        return type(args)(*(_fake_args(a, s, mesh, device)
                            for a, s in zip(args, shardings))) \
            if hasattr(args, "_fields") else type(args)(
                _fake_args(a, s, mesh, device)
                for a, s in zip(args, shardings))
    spec = shardings.spec
    local = torch.empty(_local_shape(args.shape, spec, mesh),
                        dtype=args.dtype, device=device)
    shape = tuple(args.shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, common.placements(spec, mesh),
                              run_check=False, shape=shape, stride=stride)


def _local_bytes(tree, exclude=()) -> int:
    total = 0
    for t in tree_flatten(tree)[0]:
        if not isinstance(t, torch.Tensor):
            continue
        local = t.to_local() if isinstance(t, DTensor) else t
        if id(local.untyped_storage()) in exclude:
            continue
        total += local.numel() * local.element_size()
    return total


def _storages(tree) -> set:
    return {id((t.to_local() if isinstance(t, DTensor) else t)
               .untyped_storage())
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)}


def _want_autograd(device: str, cell) -> None:
    if (cell.kind == "train" and torch.device(device).type == "cuda"
            and not torch.backends.cuda.is_built()):
        raise DryRunError("a train cell on the fake card needs a CUDA build "
                          "of torch (autograd keeps a device guard for each "
                          "CUDA tensor); run it with --device cpu")


def measure(cell, mesh, device: str = "cuda") -> dict:
    """Run ``cell``'s step as rank 0 of ``mesh`` under fake tensors and
    count it: {"flops", "bytes", "coll" (the collectives dict), "memory"
    (argument / output / temp bytes), "seconds"}."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _want_autograd(device, cell)
    t0 = time.time()
    with FakeTensorMode(), _dtensor_bookkeeping():
        args = _fake_args(cell.args, cell.in_shardings, mesh, device)
        arg_bytes = _local_bytes(args)
        donated = set()
        for i in cell.donate_argnums:
            donated |= _storages(args[i])
        counter = RankCounter()
        with counter, mesh_context(mesh):
            out = cell.fn(*args)
        out_bytes = _local_bytes(out, exclude=donated)
    return {"flops": counter.flops, "bytes": counter.op_bytes,
            "coll": counter.coll,
            "memory": {"argument_size": arg_bytes, "output_size": out_bytes,
                       "temp_size": counter.peak},
            "seconds": time.time() - t0}


def exact_costs(arch, shape, mesh, cell, rules_override=None,
                device: str = "cuda", full=None, config=None):
    """The reference's two-depth extrapolation: cost(L) = outside + L ·
    per_layer from the step at two reduced depths (one microbatch), and
    whether its FLOPs equal ``full``'s (the full-depth counts: flops,
    bytes, collective bytes)."""
    from repro_torch.configs import registry as reg
    if config is None:
        config, _ = reg.get_arch(arch)
    field = _DEPTH_FIELD.get(cell.family)
    depth = getattr(config, field, None) if field else None
    if not depth or depth < 1 or not hasattr(config, "cost_exact"):
        return None
    d_lo, d_hi = (2, 3) if depth >= 3 else (1, 2)
    costs = {}
    for d in (d_lo, d_hi):
        kw = {field: d, "cost_exact": True}
        if hasattr(config, "train_microbatches"):
            kw["train_microbatches"] = 1
        cell_d = build_cell(arch, shape, mesh, rules_override,
                            config_override=dataclasses.replace(config, **kw))
        m = measure(cell_d, mesh, device)
        costs[d] = (m["flops"], m["bytes"], m["coll"]["total"])
    span = d_hi - d_lo
    per = tuple((costs[d_hi][i] - costs[d_lo][i]) / span for i in range(3))
    outside = tuple(costs[d_lo][i] - d_lo * per[i] for i in range(3))
    total = tuple(outside[i] + depth * per[i] for i in range(3))
    rec = {"flops": total[0], "bytes": total[1], "coll": total[2],
           "per_layer": per, "outside": outside, "depth": depth}
    if full is not None:
        rec["equals_full_depth"] = total[0] == full[0]
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, rules_override=None,
             exact: bool = True, device: str = "cuda",
             config_override=None) -> dict:
    """The record of one cell on the production mesh (the reference's keys:
    ``lower_s`` is the cell's build, ``compile_s`` the fake step;
    ``config_override`` replaces the architecture's configuration, as
    ``build_cell``'s does)."""
    world = 512 if multi_pod else 256
    with fake_group(world):
        if dist.get_world_size() != world:
            raise DryRunError(f"a group of {dist.get_world_size()} ranks "
                              f"exists; the mesh needs {world}")
        mesh = make_production_mesh(multi_pod=multi_pod, device=device,
                                    fake=True)
        n_chips = world
        t0 = time.time()
        cell = build_cell(arch, shape, mesh, rules_override, config_override)
        t_lower = time.time() - t0
        m = measure(cell, mesh, device)
        flops, bytes_acc, coll = m["flops"], m["bytes"], m["coll"]
        exact_info = None
        if exact:
            exact_info = exact_costs(arch, shape, mesh, cell, rules_override,
                                     device, (flops, bytes_acc,
                                              coll["total"]), config_override)
    mem_bytes = memory_traffic_bytes(m["memory"], bytes_acc)
    terms = roofline(flops, mem_bytes, coll["total"], n_chips)
    return {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "lower_s": round(t_lower, 1), "compile_s": round(m["seconds"], 1),
        "flops_per_device": flops, "bytes_per_device": mem_bytes,
        "hlo_bytes_unfused": bytes_acc,
        "collective_bytes_per_device": coll["total"],
        "collective_ops": coll["n_ops"],
        "collectives": {k: v for k, v in coll.items() if k != "n_ops"},
        "memory": m["memory"],
        "roofline": terms,
        "dominant": max(terms, key=terms.get),
        "exact": bool(exact_info and exact_info.get("equals_full_depth")),
        "exact_costs": exact_info,
        "meta": cell.meta,
        "device": device,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the device type the ranks' fake tensors take")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import all_cells
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]

    results = []
    for mp in meshes:
        # one group a mesh for every cell on it (DTensor's planning caches
        # are kept by mesh), destroyed after the mesh's last cell
        with fake_group(512 if mp else 256):
            results += _run_cells(cells, mp, args)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2, default=str)
        print(f"wrote {args.out}")
    n_fail = sum(1 for r in results if "error" in r)
    print(f"{len(results) - n_fail}/{len(results)} cells OK")
    return 1 if n_fail else 0


def _run_cells(cells, mp: bool, args) -> list:
    results = []
    for arch, shape in cells:
        tag = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
        try:
            rec = run_cell(arch, shape, mp, device=args.device)
            r = rec["roofline"]
            print(f"[OK] {tag}: step={rec['compile_s']}s "
                  f"flops/dev={rec['flops_per_device']:.3g} "
                  f"compute={r['compute_s']*1e3:.3g}ms "
                  f"mem={r['memory_s']*1e3:.3g}ms "
                  f"coll={r['collective_s']*1e3:.3g}ms "
                  f"dominant={rec['dominant']}", flush=True)
            results.append(rec)
        except Exception as e:
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc(limit=3)
            results.append({"arch": arch, "shape": shape,
                            "mesh": "2x16x16" if mp else "16x16",
                            "error": f"{type(e).__name__}: {e}"})
    return results


if __name__ == "__main__":
    sys.exit(main())
