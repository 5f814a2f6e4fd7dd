#!/usr/bin/env python3
"""The card's rate for the tensor-core instruction the f32 flash kernels
issue, mma.sync.m16n8k8 with tf32 operands (and, beside it,
mma.sync.m16n8k16 with bf16 ones): the ceiling of
``ops/csrc/flash_attn_{fwd,bwd}_f32tc.cu``, which the published TF32 peak
(reached through wgmma) does not state.

    python3 scripts/mma_rate.py [--iters N]

Builds a small CUDA source with nvcc for sm_90a into build/ and runs, for
each instruction and each count of warps an SM holds (4 to 32), a grid of
132 x k blocks in which every warp issues ``iters`` rounds of 8
independent mma.sync on its own registers (no memory traffic). Prints one
JSON line a case: TFLOP/s, and clocks an mma takes on one of an SM's four
schedulers at the clock the card ran at (``nvidia-smi`` reads it while
the runs execute). Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <bool kTf32>
__global__ void mma_loop(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4], b[2];
  const uint32_t x = threadIdx.x * 2654435761u;
  for (int i = 0; i < 4; ++i) a[i] = (x >> i) & 0x3f800000u;
  b[0] = a[0] ^ 0x00400000u;
  b[1] = a[1] ^ 0x00200000u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kTf32) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      }
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate_run(int tf32, int blocks, int threads, int iters,
                            void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tf32) {
    mma_loop<true><<<blocks, threads, 0, s>>>(static_cast<float*>(out),
                                              iters);
  } else {
    mma_loop<false><<<blocks, threads, 0, s>>>(static_cast<float*>(out),
                                               iters);
  }
  return cudaGetLastError();
}
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=32768)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("mma_rate: no GPU (torch.cuda.is_available() is false)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    build = os.path.join(root, "build")
    os.makedirs(build, exist_ok=True)
    src, lib = (os.path.join(build, f"mma_rate.{ext}") for ext in ("cu",
                                                                   "so"))
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True)
    fn = ctypes.CDLL(lib).mma_rate_run
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for tf32, name, flops in ((1, "tf32_m16n8k8", 2 * 16 * 8 * 8),
                              (0, "bf16_m16n8k16", 2 * 16 * 8 * 16)):
        for warps in (4, 8, 16, 32):
            blocks, threads = sms * warps // 4, 128
            out = torch.empty(blocks * threads, device="cuda")

            def run():
                rc = fn(tf32, blocks, threads, args.iters, out.data_ptr(),
                        stream)
                if rc:
                    sys.exit(f"mma_rate: launch failed ({rc})")

            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                run()
            end.record()
            # the SM clock while the queued runs execute
            clock = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.strip()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 10
            mmas = blocks * threads // 32 * args.iters * 8
            per_sched = mmas / (sms * 4)
            mhz = float(clock) if clock.replace(".", "").isdigit() else None
            print(json.dumps({
                "mma": name, "warps_per_sm": warps, "ms": ms,
                "tflops": mmas * flops / ms / 1e9,
                "sm_clock_mhz": mhz,
                "clocks_per_mma_per_scheduler": (
                    ms * 1e-3 * mhz * 1e6 / per_sched if mhz else None),
                "card": card.strip()}), flush=True)


if __name__ == "__main__":
    main()
