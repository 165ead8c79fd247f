"""What one warp's 16-byte shared-memory load costs on this card, by how
many distinct addresses its lanes read.

    python tools/lds_probe.py

Writes a small CUDA program under ``build/``, compiles it with ``nvcc``
for ``sm_90a`` and runs it: 132 x 8 blocks of 256 threads each issue
65,536 warp-wide ``LDS.128`` (float4) loads from shared memory (one fp32
add each), with the lanes of a warp reading 1, 4, 8 or 32
distinct float4s (consecutive, so without bank conflicts), and the same
with 4-byte (``LDS.32``) loads; the 8 blocks of an SM run at once (64
warps).  Prints the card's name and power limit, then, for each case, the
time (CUDA events, the median of 5), the SM cycles a block took
(``clock64``, the mean over blocks) and the SM cycles that gives a
warp-wide load.  Kernel 8's fp32 forward (``flash_attention.cu``) sizes
its register tiles by this cost.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                    "bin", "nvcc")
ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cstdio>
#include <vector>
#include <algorithm>
#include <cuda_runtime.h>

constexpr int kIters = 4096, kUnroll = 16;

// Each lane reads float4 (or float) number lane % DISTINCT of a 512-byte
// row, so a warp's load touches DISTINCT consecutive elements; the loads
// are volatile PTX, so each stays one warp-wide LDS of its width (a shared
// store past the rows each iteration keeps them in the loop), and only one
// value of each is added up.
template <int DISTINCT, bool WIDE>
__global__ void __launch_bounds__(256) probe(float* out, long long* cyc) {
  __shared__ float4 buf[1024 + 8];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const long long t0 = clock64();
  const int idx = (threadIdx.x & 31) % DISTINCT;
  const unsigned start =
      static_cast<unsigned>(__cvta_generic_to_shared(buf));
  const unsigned base = start + idx * (WIDE ? 16 : 4);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < kIters; ++it) {
    float r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned addr = base + ((it * kUnroll + u) & 31) * 512;
      if (WIDE) {
        float b, c, d;
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(r[u]), "=f"(b), "=f"(c), "=f"(d)
                     : "r"(addr));
      } else {
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(r[u]) : "r"(addr));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u % 4] += r[u];
    // a store the loads may alias: none of them is hoisted out of the loop
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(start + 16384),
                 "f"(acc[0])
                 : "memory");
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] =
      acc[0] + acc[1] + acc[2] + acc[3];
  __syncthreads();
  if (threadIdx.x == 0) cyc[blockIdx.x] = clock64() - t0;
}

struct Case { const char* name; float ms; double cycles; };

template <int DISTINCT, bool WIDE>
Case run(const char* name, float* out, long long* cyc, int blocks) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  probe<DISTINCT, WIDE><<<blocks, 256>>>(out, cyc);
  std::vector<float> ms;
  for (int r = 0; r < 5; ++r) {
    cudaEventRecord(a);
    probe<DISTINCT, WIDE><<<blocks, 256>>>(out, cyc);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float t;
    cudaEventElapsedTime(&t, a, b);
    ms.push_back(t);
  }
  std::sort(ms.begin(), ms.end());
  std::vector<long long> c(blocks);
  cudaMemcpy(c.data(), cyc, sizeof(long long) * blocks,
             cudaMemcpyDeviceToHost);
  double mean = 0;
  for (long long x : c) mean += static_cast<double>(x) / blocks;
  return {name, ms[2], mean};
}

int main() {
  const int blocks = 132 * 8;
  float* out;
  long long* cyc;
  cudaMalloc(&out, sizeof(float) * blocks * 256);
  cudaMalloc(&cyc, sizeof(long long) * blocks);
  // warp-wide loads an SM while a block runs: 8 blocks x 8 warps x kIters
  // x kUnroll
  const double loads = 8.0 * 8 * kIters * kUnroll;
  Case cases[] = {
      run<1, true>("LDS.128, 1 distinct", out, cyc, blocks),
      run<4, true>("LDS.128, 4 distinct", out, cyc, blocks),
      run<8, true>("LDS.128, 8 distinct", out, cyc, blocks),
      run<32, true>("LDS.128, 32 distinct", out, cyc, blocks),
      run<1, false>("LDS.32, 1 distinct", out, cyc, blocks),
      run<32, false>("LDS.32, 32 distinct", out, cyc, blocks),
  };
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    printf("error %s\n", cudaGetErrorString(err));
    return 1;
  }
  for (const Case& c : cases)
    printf("%s: %.4f ms, %.0f cycles a block, %.3f cycles a warp-wide load "
           "an SM\n", c.name, c.ms, c.cycles, c.cycles / loads);
  return 0;
}
"""


def main() -> int:
    build = ROOT / "build"
    build.mkdir(parents=True, exist_ok=True)
    src, exe = build / "lds_probe.cu", build / "lds_probe"
    src.write_text(SOURCE)
    subprocess.run([NVCC, "-O3", "-std=c++17",
                    "-gencode=arch=compute_90a,code=sm_90a", str(src), "-o",
                    str(exe)], check=True)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    print(subprocess.run([str(exe)], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
