"""Kernel 8's fp32 backward at BERT4Rec's training call, taken apart on one card.

    python tools/kernel8_bwd_f32_profile.py

The fp32 backward (``flash_attention_bwd.cu``: ``bwd_delta_kernel``, then
``bwd_dq_f32_kernel`` and ``bwd_dkdv_f32_kernel`` on the CUDA cores) is
read four ways, at width 32 (BERT4Rec's 2 heads of 32):

* the build: ``flash_attention_bwd.cu`` compiled alone to a cubin with
  ``-Xptxas -v`` (each fp32 kernel's registers, stack and spills), and
  ``cuobjdump -sass`` of it: each kernel's static count of shared loads
  (LDS), fp32 FMAs (FFMA), global loads (LDG) and barriers (BAR);
* the occupancy: the cubin loaded through libcuda (`cuModuleLoad`) and
  ``cuOccupancyMaxActiveBlocksPerMultiprocessor`` asked for each kernel at
  its launch's 256 threads and dynamic shared memory;
* the work: the (query, key) pairs each kernel scores with its tiles'
  padding (32 query rows and 64 keys a tile), and the FMAs it does a
  pair, against the pairs the function needs and the 10·D operations a
  pair of ``chip_smoke.work_of``'s bound;
* the times: at (B, H, S, D) = (4,096, 2, S, 32), fp32, non-causal, q, k
  and v the strided (B, S, H·D) views the model passes, drawn from a
  seed, for S 200 (BERT4Rec's) and 256 (no padding): the wrapper's time
  (CUDA events, the median of 20 after a warm-up), each device kernel's
  under ``torch.profiler``, and at S 200 the plain version's and
  ``scaled_dot_product_attention``'s backward.

Prints the card's name and power limit first.  Needs one card, ``nvcc``
and ``cuobjdump`` of the CUDA toolkit; writes only under ``build/``.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/flash_attention/flash_attention_bwd.cu"
CUBIN = ROOT / "build" / "bwd_f32_profile.cubin"
CUDA = os.environ.get("CUDA_HOME", "/usr/local/cuda")
KERNELS = ("bwd_dq_f32_kernel", "bwd_dkdv_f32_kernel")
B, H, D, SEQS, REPS = 4096, 2, 32, (200, 256), 20
THREADS, ROWS, KEYS = 256, 32, 64     # kF32Threads, kF32Rows, kF32Keys


def smem_bytes(name: str) -> int:
    """The launch's dynamic shared memory at D = Dv = 32, as
    ``f32_dq_smem_floats`` / ``f32_dkdv_smem_floats`` compute it."""
    if name == "bwd_dq_f32_kernel":
        floats = (ROWS + KEYS) * (2 * D + 2) + ROWS * (KEYS + 1)
    else:
        floats = ((KEYS + ROWS) * (2 * D + 2) + 2 * KEYS * (ROWS + 1)
                  + 2 * ROWS)
    return 4 * floats


def build() -> dict:
    """ptxas's lines and the SASS counts of each fp32 kernel at width 32,
    keyed by kernel; also the mangled name."""
    CUBIN.parent.mkdir(parents=True, exist_ok=True)
    done = subprocess.run(
        [f"{CUDA}/bin/nvcc", "-O3", "-std=c++17", "-cubin",
         "-gencode=arch=compute_90a,code=sm_90a", "-Xptxas", "-v",
         str(SRC), "-o", str(CUBIN)], capture_output=True, text=True)
    print(f"nvcc -cubin -Xptxas -v: rc {done.returncode}", flush=True)
    if done.returncode:
        print(done.stderr[-4000:])
        sys.exit(1)
    out, cur = {}, None
    for line in (done.stdout + done.stderr).splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            m = re.search(r"'(\S+)'", line) or re.search(r"for (\S+)", line)
            cur = next((k for k in KERNELS
                        if m and f"{k}ILi{D}ELi{D}E" in m.group(1)), None)
            if cur:
                out.setdefault(cur, {"ptxas": []})
        elif cur and re.search(r"spill|registers", line):
            out[cur]["ptxas"].append(line.split("ptxas info    :")[-1]
                                     .strip())
    sass = subprocess.run([f"{CUDA}/bin/cuobjdump", "-sass", str(CUBIN)],
                          capture_output=True, text=True)
    print(f"cuobjdump -sass: rc {sass.returncode}", flush=True)
    cur = None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = next((k for k in KERNELS if f"{k}ILi{D}ELi{D}E" in
                        m.group(1)), None)
            if cur:
                out.setdefault(cur, {"ptxas": []})
                out[cur].update(mangled=m.group(1), sass={})
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if cur and m:
            op = m.group(1)
            counts = out[cur]["sass"]
            counts[op] = counts.get(op, 0) + 1
    return out


def occupancy(info: dict) -> None:
    """Resident blocks an SM of each kernel, from libcuda, beside its
    registers and local memory as libcuda reads them."""
    import torch
    torch.cuda.init()
    torch.empty(1, device="cuda")           # the primary context, current
    cu = ctypes.CDLL("libcuda.so.1")
    mod = ctypes.c_void_p()
    rc = cu.cuModuleLoad(ctypes.byref(mod), str(CUBIN).encode())
    if rc:
        print(f"cuModuleLoad: error {rc}; occupancy not measured")
        return
    for name, d in info.items():
        fn = ctypes.c_void_p()
        rc = cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                    d["mangled"].encode())
        blocks, regs, local = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = rc or cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
            ctypes.byref(blocks), fn, THREADS,
            ctypes.c_size_t(smem_bytes(name)))
        rc = rc or cu.cuFuncGetAttribute(ctypes.byref(regs), 4, fn)
        rc = rc or cu.cuFuncGetAttribute(ctypes.byref(local), 3, fn)
        if rc:
            print(f"{name}: libcuda error {rc}; occupancy not measured")
            continue
        props = torch.cuda.get_device_properties(0)
        warps = blocks.value * THREADS // 32
        most = getattr(props, "max_threads_per_multi_processor", 2048) // 32
        d["occupancy"] = dict(blocks_per_sm=blocks.value, warps=warps,
                              of_warps=most, regs=regs.value,
                              local_bytes=local.value,
                              smem_bytes=smem_bytes(name))
    cu.cuModuleUnload(mod)


def work(s: int) -> dict:
    """Pairs scored with the tiles' padding, FMAs a pair, and the bound's
    operations, at sequence length ``s``."""
    rows_pad = -(-s // ROWS) * ROWS
    keys_pad = -(-s // KEYS) * KEYS
    heads = B * H
    # dQ: S, dP and dS·k a pair (D + D + D FMAs); dK/dV: S, dP, Pᵀ·do and
    # dSᵀ·q (4 D FMAs)
    dq = dict(pairs=heads * rows_pad * keys_pad, fma_per_pair=3 * D)
    dkdv = dict(pairs=heads * keys_pad * rows_pad, fma_per_pair=4 * D)
    need = heads * s * s
    done = 2 * (dq["pairs"] * dq["fma_per_pair"]
                + dkdv["pairs"] * dkdv["fma_per_pair"])
    return dict(pairs_needed=need, dq=dq, dkdv=dkdv,
                ops_done=done, ops_bound=10 * D * need,
                done_over_bound=done / (10 * D * need))


def timed(s: int, with_refs: bool) -> dict:
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def heads(t):
        # the model's (B, S, H·D) projection as a (B, H, S, D) view
        return t.reshape(B, s, H, D).transpose(1, 2)
    q, k, v = (heads(torch.randn(B, s, H * D, generator=gen, device="cuda"))
               for _ in range(3))
    o, lse = fa.flash_attention(q, k, v, causal=False, return_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda")
    args = (q, k, v, o, lse, do)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)
    row = {"shape": (B, H, s, D),
           "kernel_ms": ms(lambda: fa.flash_attention_backward(
               *args, causal=False))}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fa.flash_attention_backward(*args, causal=False)
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        for name in ("bwd_delta_kernel",) + KERNELS:
            if name in e.key and e.device_time_total > 0:
                per[name] = e.device_time_total / e.count / 1e3
    row["device_ms"] = per or "not measured (no device events)"
    if with_refs:
        row["plain_ms"] = ms(lambda: fa.flash_attention_backward_plain(
            *args, causal=False))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = torch.nn.functional.scaled_dot_product_attention(*leaves)
        row["sdpa_backward_ms"] = ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True))
    return row


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import kernels
    kernels.extension()
    info = build()
    occupancy(info)
    for name, d in info.items():
        ops = {op: d.get("sass", {}).get(op, 0)
               for op in ("LDS", "FFMA", "LDG", "STS", "BAR")}
        ratio = ops["LDS"] / max(ops["FFMA"], 1)
        print(f"{name}<{D},{D}>: ptxas {'; '.join(d['ptxas'])}; static SASS "
              f"{ops}, LDS per FFMA {ratio:.2f}; occupancy "
              f"{d.get('occupancy', 'not measured')}", flush=True)
    for s in SEQS:
        print(f"work at S {s}: {work(s)}", flush=True)
        row = timed(s, with_refs=s == SEQS[0])
        print(f"times at S {s}: {row}", flush=True)
        useful = 10 * D * B * H * s * s
        print(f"  useful operations {useful:.4e}: "
              f"{useful / row['kernel_ms'] / 1e9:.2f} TFLOP/s of the "
              f"kernel's time; done operations "
              f"{work(s)['ops_done'] / row['kernel_ms'] / 1e9:.2f} TFLOP/s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
