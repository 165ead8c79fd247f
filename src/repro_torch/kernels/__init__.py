"""Hand-written CUDA kernels for Stage-0 (the features and the stacked
forests' predictions, ``stage0``), the first-stage (lexical and dense) and
Stage-2 hot loops, for the per-query Stage-1 path, for the LM serving
path's attention (prefill and KV-cache decode), and for the tree fits'
levels (split histograms, split choice, row routing) and the boosting
update (``level_histogram``).

Each package holds ``<name>.cu`` (the CUDA C++ kernel and a plain-C launch
function; ``flash_attention`` has a second, ``flash_attention_sm90.cu``,
for bf16 prefill on the tensor cores, and a third,
``flash_attention_bwd.cu``, for the prefill's backward in training; the
bf16 kernels of both share the Hopper helpers of ``hopper.cuh``) and
``ops.py`` (the wrapper the engines import, and the plain PyTorch version
of the same function over the same layout).  A wrapper launches the
kernel for CUDA tensors and runs the plain version for CPU tensors; there
is no fallback between the two.  ``term_table.cuh`` and
``term_table.py`` hold the query-group term table that the batched mirror
kernels (``impact_accumulate``, ``blockmax_score``) build in shared
memory, and its PyTorch form for their plain twins; ``topk_select.cuh``
and ``topk_select.py`` the exact top-k select (one thread-block cluster a
row of keys) that ``dense_topk`` and ``score_histogram`` share, and its
PyTorch form.

All the kernels are compiled together, on first use, by one
``torch.utils.cpp_extension.load`` call: the ``.cu`` sources plus one
small binding file (``binding.cpp``, the only source that includes
PyTorch's headers), for ``sm_90a``, into ``build/kernels`` at the root of
the checkout.  ``torch.utils.cpp_extension`` is imported inside
``extension()``, so importing this package needs no compiler.

``LAUNCHES`` counts kernel launches per wrapper.  A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.

The kernels that the dry-run cells reach (kernels 1, 2, 6, 8 and its
backward, 9, and Stage-0's two) are also custom operators (``card_op``), which only fake
tensors, DTensors and calls under a dispatch mode take (``call``: an
ordinary tensor goes straight to the launch or the plain version).  Under ``FakeTensorMode`` an op's fake
runs the launch's input checks but those of the device (so a dry run on
either device type refuses what the card would) and gives the output
shapes from static sizes, so a dry run launches nothing and reads
no data (the plain versions' host reads lie inside the operator too);
each has a FLOP formula (``torch.utils.flop_counter``) and a DTensor
sharding rule, so on DTensors it runs on each rank's blocks.
"""

from __future__ import annotations

from pathlib import Path

import torch

KERNEL_NAMES = ("impact_accumulate_batched", "blockmax_score_batched",
                "qd_feature_gather_lanes", "dense_topk_tiles",
                "impact_accumulate_bucketed", "blockmax_score_bucketed",
                "score_histogram", "flash_attention", "flash_decode",
                "level_histogram", "boost_update", "flash_attention_backward",
                "level_split", "level_route", "stage0_features",
                "stage0_forest")
LAUNCHES = {name: 0 for name in KERNEL_NAMES}

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "binding.cpp",
           _HERE / "impact_accumulate" / "impact_accumulate.cu",
           _HERE / "blockmax_score" / "blockmax_score.cu",
           _HERE / "qd_feature_gather" / "qd_feature_gather.cu",
           _HERE / "dense_topk" / "dense_topk.cu",
           _HERE / "score_histogram" / "score_histogram.cu",
           _HERE / "flash_attention" / "flash_attention.cu",
           _HERE / "flash_attention" / "flash_attention_sm90.cu",
           _HERE / "flash_attention" / "flash_attention_bwd.cu",
           _HERE / "level_histogram" / "level_histogram.cu",
           _HERE / "stage0" / "stage0.cu")
BUILD_DIR = _HERE.parents[2] / "build" / "kernels"
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

_ext = None
_ORDINARY = (torch.Tensor, torch.nn.Parameter)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def extension():
    """The compiled kernel module (built on first call, then cached)."""
    global _ext
    if _ext is None:
        from torch.utils.cpp_extension import load

        from repro_torch.serving.telemetry.host import phase

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with phase("setup.kernels"):
            _ext = load(name="repro_torch_kernels",
                        sources=[str(s) for s in SOURCES],
                        build_directory=str(BUILD_DIR),
                        extra_cflags=["-O2"],
                        extra_cuda_cflags=list(CUDA_FLAGS))
    return _ext


def check_cuda_args(name: str, args: dict, dtypes: dict,
                    device: bool = True) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype on
    one device — the kernels take nothing else.  Without ``device`` (a
    kernel's fake, whatever device type its fake tensors take) the dtypes
    and contiguity only."""
    dev = None
    for key, t in args.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: {key} must be a CUDA tensor")
        if t.dtype != dtypes[key]:
            raise ValueError(f"{name}: {key} must be {dtypes[key]}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if not device:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor")
        # the card's index: an int, cheaper on the host than a device object
        if dev is None:
            dev = t.get_device()
        elif t.get_device() != dev:
            raise ValueError(f"{name}: all tensors must be on one device")


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain-version path);
    False when every tensor is a CUDA tensor; raises on a mix."""
    cpu = [t.is_cpu for t in tensors]
    if all(cpu):
        return True
    if not any(cpu):
        return False
    raise ValueError("kernel arguments mix CPU and device tensors")


def card_op(name: str, launch, plain, fake, flops, shardings):
    """``launch`` (a kernel's launch on CUDA tensors, typed for the
    operator's schema) as the custom operator ``repro_torch::<name>``, with
    ``plain`` its implementation on CPU tensors (the kernel's plain
    version), ``fake`` its implementation under fake tensors (it runs the
    launch's input checks but the device's), ``flops`` its operation
    count (a ``torch.utils.flop_counter`` formula over the arguments'
    shapes: the count of ``PERF.md``'s bound for the call) and
    ``shardings`` its DTensor strategies (a
    ``torch.distributed.tensor.experimental.register_sharding`` function:
    the (output placements, input placements) that run the kernel on each
    rank's blocks alone).  ``call`` runs it."""
    from torch.distributed.tensor.experimental import register_sharding
    from torch.utils.flop_counter import register_flop_formula

    op = torch.library.custom_op(f"repro_torch::{name}", launch,
                                 mutates_args=())
    op.register_kernel("cpu", plain)
    op.register_fake(fake)
    packet = getattr(torch.ops.repro_torch, name)
    register_flop_formula(packet)(flops)
    register_sharding(packet.default)(shardings)
    _OPS[name] = (packet.default, launch, plain)
    return op


_OPS: dict = {}


def call(name: str, *args):
    """The operator ``repro_torch::<name>`` on ``args``.  Where ``direct``
    holds, the call skips the dispatcher: CPU tensors take the plain
    version (what the operator's CPU kernel runs), CUDA tensors the launch
    (and ``meta`` tensors, the tests' stand-in for device tensors that are
    not CUDA tensors, the launch's checks).  Fake tensors, DTensors and
    calls under a dispatch mode take the operator."""
    op, launch, plain = _OPS[name]
    cpu = _route(args)
    if cpu is None:
        return op(*args)
    return (plain if cpu else launch)(*args)


def direct(*args) -> bool:
    """True when a kernel call on ``args`` may skip its operator: no tensor
    is a subclass (a fake tensor, a DTensor; ``torch.Tensor`` and
    ``torch.nn.Parameter`` only) and no dispatch mode is active (a FLOP
    counter such as the dry run's ``RankCounter`` sees only the
    operator)."""
    return _route(args) is not None


def _route(args):
    """None where the call takes the operator (not ``direct``), else
    whether every tensor lies on the CPU; one pass, as the wrappers' host
    cost a call is what the LM layers and the serve batches pay."""
    if torch._C._len_torch_dispatch_stack():
        return None
    cpu = True
    for a in args:
        if isinstance(a, torch.Tensor):
            if type(a) not in _ORDINARY:
                return None
            if not a.is_cpu:
                cpu = False
    return cpu


def split_strategies(n_in: int, n_out: int, dims, extra_in=0) -> list:
    """DTensor strategies for a kernel whose ``n_in`` tensor inputs and
    ``n_out`` outputs all split along each dimension of ``dims`` (the
    kernel then runs on each rank's blocks alone), plus all replicated;
    ``extra_in`` trailing non-tensor arguments take no placement."""
    from torch.distributed.tensor import Replicate, Shard

    out = [([Replicate()] * n_out,
            [Replicate()] * n_in + [None] * extra_in)]
    for d in dims:
        out.append(([Shard(d)] * n_out, [Shard(d)] * n_in + [None] * extra_in))
    return out
