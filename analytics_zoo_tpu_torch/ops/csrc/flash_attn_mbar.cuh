// Hopper (sm_90a) synchronisation and copy helpers that the TMA / wgmma
// kernels (flash_attn_fwd_sm90.cu, flash_attn_bwd_sm90.cu, through
// flash_attn_sm90.cuh) and the f32 tensor-core kernels
// (flash_attn_fwd_f32tc.cu, flash_attn_bwd_f32tc.cu, through
// flash_attn_f32tc.cuh) share: mbarriers, 1-D bulk copies that complete on
// them, named barriers, and 2^x on the special-function unit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` of barrier `bar` completed.
// (A timeout that traps would make ptxas serialize the wgmma pipeline
// and cap the consumers' registers, so the wait spins.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// 2^x as the hardware approximates it, subnormal results flushed to 0
// (a probability below 2^-126 adds nothing to a row): exp2f's handling
// of them cost 8% at D = 64, where the softmax is a quarter of the time
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory; its bytes count against the barrier's
// transactions
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads) over `count` threads:
// arrive without waiting (the writer's side), or arrive and wait (the
// reader's side, which then sees what the arriving threads wrote)
__device__ __forceinline__ void named_arrive(uint32_t id, uint32_t count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_sync(uint32_t id, uint32_t count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

}  // namespace
