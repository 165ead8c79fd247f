"""Hand-written CUDA kernels for the first-stage (lexical and dense) and
Stage-2 hot loops, for the per-query Stage-1 path, for the LM serving
path's attention (prefill and KV-cache decode), and for the GBRT fit's
level histograms and boosting update (``level_histogram``).

Each package holds ``<name>.cu`` (the CUDA C++ kernel and a plain-C launch
function; ``flash_attention`` has a second, ``flash_attention_sm90.cu``,
for bf16 prefill on the tensor cores, and a third,
``flash_attention_bwd.cu``, for the prefill's backward in training) and
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
"""

from __future__ import annotations

from pathlib import Path

KERNEL_NAMES = ("impact_accumulate_batched", "blockmax_score_batched",
                "qd_feature_gather_lanes", "dense_topk_tiles",
                "impact_accumulate_bucketed", "blockmax_score_bucketed",
                "score_histogram", "flash_attention", "flash_decode",
                "level_histogram", "boost_update", "flash_attention_backward")
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
           _HERE / "level_histogram" / "level_histogram.cu")
BUILD_DIR = _HERE.parents[2] / "build" / "kernels"
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")

_ext = None


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def extension():
    """The compiled kernel module (built on first call, then cached)."""
    global _ext
    if _ext is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _ext = load(name="repro_torch_kernels",
                    sources=[str(s) for s in SOURCES],
                    build_directory=str(BUILD_DIR),
                    extra_cflags=["-O2"],
                    extra_cuda_cflags=list(CUDA_FLAGS))
    return _ext


def check_cuda_args(name: str, args: dict, dtypes: dict) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype on
    one device — the kernels take nothing else."""
    import torch

    dev = None
    for key, t in args.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: {key} must be a CUDA tensor")
        if t.dtype != dtypes[key]:
            raise ValueError(f"{name}: {key} must be {dtypes[key]}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
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
