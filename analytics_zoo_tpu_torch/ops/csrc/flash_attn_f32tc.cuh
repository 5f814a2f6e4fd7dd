// Device helpers of the f32 tensor-core kernels (three TF32 mma.sync
// products a product at f32 accuracy, cp.async tiles split once a block
// into hi and lo planes): flash_attn_fwd_f32tc.cu (K1) and
// flash_attn_bwd_f32tc.cu (K2, K3) include it. The design notes are in
// those sources. Every helper is for sm_90a (mma.sync.m16n8k8 with tf32
// operands, ldmatrix, cp.async).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// mbarriers, 1-D bulk copies, named barriers, fast_exp2
#include "flash_attn_mbar.cuh"

namespace {

constexpr int kTcPad = 4;       // f32 of row padding (16 bytes)
constexpr int kTcThreads = 128; // 4 warps: the backward's blocks (copy_tile
                                // takes another count)

// x rounded to tf32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero, 13 low bits zero), by an integer add and mask: the same bits
// for every finite x, and on the card faster than the cvt instruction
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo. Rounded (kRaw false): both tf32, hi = tf32(x) and
// lo = tf32(x - hi), up to 2^-22 |x|. Raw (kRaw true): hi = x with its 13
// low bits cleared (truncated to tf32) and lo = x - hi, exact in f32 and
// handed to the tensor cores as it is: mma.sync reads the top 19 bits of
// a tf32 operand, so lo is truncated there, within 2^-10 |lo| <= 2^-20 |x|;
// two operations where rounding takes five
template <bool kRaw = false>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (kRaw) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
}

template <bool kRaw = false, int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    split_tf32<kRaw>(__uint_as_float(x[i]), hi[i], lo[i]);
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 4 f32 matrices (8 x 8 b16), one row address a lane
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// offset of a lane's row address for the A fragment of 16 rows, k-step 0
// (add 8 * c for k-step c): matrices (rows 0-7, cols 0-3), (8-15, 0-3),
// (0-7, 4-7), (8-15, 4-7) give a0..a3
template <int LD>
__device__ __forceinline__ int a_frag_off(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4;
}

// the same for the B fragments of two n-blocks of 8 rows (K-major): (rows
// 0-7, cols 0-3), (0-7, 4-7), (8-15, 0-3), (8-15, 4-7) give b0 and b1 of
// the first, then of the second
template <int LD>
__device__ __forceinline__ int b_frag_off(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(a), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// start copying `rows` rows of D floats (row stride `sl`) into a tile of
// row pitch LD, 16 bytes a copy, by the block's NT threads
template <int D, int LD, int NT = kTcThreads>
__device__ __forceinline__ void copy_tile(float* t, const float* src,
                                          long long sl, int rows, int tid) {
  constexpr int kChunks = D / 4;
  for (int i = tid; i < rows * kChunks; i += NT) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 4;
    cp_async16(t + r * LD + c, src + r * sl + c);
  }
}

// the A fragment {c0, c2, c1, c3} of accumulator block x (the contraction
// index relabelled within the block of 8), split
template <bool kRaw = false>
__device__ __forceinline__ void acc_as_a(const float (&x)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split_tf32<kRaw>(x[0], hi[0], lo[0]);
  split_tf32<kRaw>(x[2], hi[1], lo[1]);
  split_tf32<kRaw>(x[1], hi[2], lo[2]);
  split_tf32<kRaw>(x[3], hi[3], lo[3]);
}

// c[n] += A B[:, n-block n] for NB n-blocks (the first `nb` of them) of a
// row-major tile whose rows are the contraction index, split into hi and
// lo planes: B's k = t and t + 4 are rows 2t and 2t + 1 from `rh` and `rl`
// (row kr + 2t, column g of the first n-block) of the relabelled block;
// 4 n-blocks at a time, each pass of the three over all of them before
// the next
template <int NB, int LD>
__device__ __forceinline__ void mma_rows(float (&c)[NB][4],
                                         const uint32_t (&ahi)[4],
                                         const uint32_t (&alo)[4],
                                         const float* rh, const float* rl,
                                         int nb = NB) {
  constexpr int kG = 4;
#pragma unroll
  for (int n0 = 0; n0 < NB; n0 += kG) {
    uint32_t bh[kG][2], bl[kG][2];
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      if (n0 + i < NB && n0 + i < nb) {
        bh[i][0] = __float_as_uint(rh[(n0 + i) * 8]);
        bh[i][1] = __float_as_uint(rh[LD + (n0 + i) * 8]);
        bl[i][0] = __float_as_uint(rl[(n0 + i) * 8]);
        bl[i][1] = __float_as_uint(rl[LD + (n0 + i) * 8]);
      }
    }
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      if (n0 + i < NB && n0 + i < nb) {
        mma_tf32(c[n0 + i], alo, bh[i][0], bh[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      if (n0 + i < NB && n0 + i < nb) {
        mma_tf32(c[n0 + i], ahi, bl[i][0], bl[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      if (n0 + i < NB && n0 + i < nb) {
        mma_tf32(c[n0 + i], ahi, bh[i][0], bh[i][1]);
      }
    }
  }
}

// S (or S^T) and dP (dP^T) += A B^T over D for NB n-blocks of 8 rows of two
// K-major tiles: A split here from `a_s` and `a_d`, B from the hi and lo
// planes `b_sh`, `b_sl`, `b_dh`, `b_dl`, each pointing at the lane's
// fragment rows (a_frag_off, b_frag_off)
template <int D, int NB, int LD>
__device__ __forceinline__ void mma_over_d(float (&s)[NB][4],
                                           float (&dp)[NB][4],
                                           const float* a_s, const float* a_d,
                                           const float* b_sh,
                                           const float* b_sl,
                                           const float* b_dh,
                                           const float* b_dl) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    uint32_t x[4], shi[4], slo[4], dhi[4], dlo[4];
    ldsm_x4(x, a_s + 8 * c);
    split_tf32(x, shi, slo);
    ldsm_x4(x, a_d + 8 * c);
    split_tf32(x, dhi, dlo);
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      const int at = n * 8 * LD + 8 * c;
      uint32_t hi[2][4], lo[2][4];
      ldsm_x4(hi[0], b_sh + at);
      ldsm_x4(lo[0], b_sl + at);
      ldsm_x4(hi[1], b_dh + at);
      ldsm_x4(lo[1], b_dl + at);
      // the four products' lo_a hi_b, then hi_a lo_b, then hi_a hi_b: no
      // mma waits on the one before it
      mma_tf32(s[n], slo, hi[0][0], hi[0][1]);
      mma_tf32(s[n + 1], slo, hi[0][2], hi[0][3]);
      mma_tf32(dp[n], dlo, hi[1][0], hi[1][1]);
      mma_tf32(dp[n + 1], dlo, hi[1][2], hi[1][3]);
      mma_tf32(s[n], shi, lo[0][0], lo[0][1]);
      mma_tf32(s[n + 1], shi, lo[0][2], lo[0][3]);
      mma_tf32(dp[n], dhi, lo[1][0], lo[1][1]);
      mma_tf32(dp[n + 1], dhi, lo[1][2], lo[1][3]);
      mma_tf32(s[n], shi, hi[0][0], hi[0][1]);
      mma_tf32(s[n + 1], shi, hi[0][2], hi[0][3]);
      mma_tf32(dp[n], dhi, hi[1][0], hi[1][1]);
      mma_tf32(dp[n + 1], dhi, hi[1][2], hi[1][3]);
    }
  }
}

// S += A B^T over KS k-steps of 8 for NB n-blocks of 8 rows of one K-major
// tile (K1's S = Q K^T): A split here from `a`, B read from the tile `b`
// as it is and split here (split_tf32 as kRaw says), each pointing at the
// lane's fragment rows (a_frag_off, b_frag_off). The odd k-steps run in a
// second accumulator, added to `s` at the end, and each pair of k-steps
// issues its three passes over the n-blocks of both (every lo_a hi_b, then
// hi_a lo_b, then hi_a hi_b): 2 * NB mmas lie between two that depend on
// each other
template <int KS, int NB, int LD, bool kRaw = false>
__device__ __forceinline__ void mma_over_d1(float (&s)[NB][4], const float* a,
                                            const float* b) {
  static_assert(NB % 2 == 0, "n-blocks in pairs (one ldmatrix.x4 each)");
  float u[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) u[n][0] = u[n][1] = u[n][2] = u[n][3] = 0.f;
#pragma unroll
  for (int c = 0; c < KS; c += 2) {
    // k-step c + h: A at [h], B of n-blocks 2j and 2j + 1 at [h][j]
    uint32_t x[4], ahi[2][4], alo[2][4], hi[2][NB / 2][4], lo[2][NB / 2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (c + h < KS) {
        ldsm_x4(x, a + 8 * (c + h));
        split_tf32<kRaw>(x, ahi[h], alo[h]);
#pragma unroll
        for (int n = 0; n < NB; n += 2) {
          ldsm_x4(x, b + n * 8 * LD + 8 * (c + h));
          split_tf32<kRaw>(x, hi[h][n / 2], lo[h][n / 2]);
        }
      }
    }
    // pass 0: lo_a hi_b; 1: hi_a lo_b; 2: hi_a hi_b
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int j = n / 2, e = 2 * (n & 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (c + h < KS) {
            const uint32_t(&br)[4] = pass == 1 ? lo[h][j] : hi[h][j];
            mma_tf32(h == 0 ? s[n] : u[n], pass == 0 ? alo[h] : ahi[h],
                     br[e], br[e + 1]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    s[n][0] += u[n][0];
    s[n][1] += u[n][1];
    s[n][2] += u[n][2];
    s[n][3] += u[n][3];
  }
}

// mma_rows with B read from one row-major tile `r` as it is (f32; the
// lane's rows 2t and 2t + 1 at column g of the first n-block) and split
// here (split_tf32 as kRaw says), kG n-blocks at a time
template <int NB, int LD, int kG = 4, bool kRaw = false>
__device__ __forceinline__ void mma_rows_split(float (&c)[NB][4],
                                               const uint32_t (&ahi)[4],
                                               const uint32_t (&alo)[4],
                                               const float* r, int nb = NB) {
#pragma unroll
  for (int n0 = 0; n0 < NB; n0 += kG) {
    uint32_t bh[kG][2], bl[kG][2];
#pragma unroll
    for (int n = 0; n < kG; ++n) {
      if (n0 + n < NB && n0 + n < nb) {
        split_tf32<kRaw>(r[(n0 + n) * 8], bh[n][0], bl[n][0]);
        split_tf32<kRaw>(r[LD + (n0 + n) * 8], bh[n][1], bl[n][1]);
      }
    }
    // pass 0: lo_a hi_b; 1: hi_a lo_b; 2: hi_a hi_b
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int n = 0; n < kG; ++n) {
        if (n0 + n < NB && n0 + n < nb) {
          const uint32_t(&b)[2] = pass == 1 ? bl[n] : bh[n];
          mma_tf32(c[n0 + n], pass == 0 ? alo : ahi, b[0], b[1]);
        }
      }
    }
  }
}

// split `rows` rows of D floats of a tile in place: the tile keeps hi,
// `lo` (same pitch) gets lo
template <int D, int LD>
__device__ __forceinline__ void split_tile(float* t, float* lo, int rows,
                                           int tid) {
  constexpr int kChunks = D / 4;
  for (int i = tid; i < rows * kChunks; i += kTcThreads) {
    const int r = i / kChunks;
    const int at = r * LD + (i - r * kChunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(t + at);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(t + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

}  // namespace
