// Flash-attention backward (K2 dQ, K3 dK/dV) for Hopper, sm_90a: the bf16
// kernel templates at head dims 320, 384, 448 and 512 (unmasked), and the
// pieces flash_attn_bwd_f32tc.cu shares with them (Params, the launch and
// argument checks, the head-dim dispatch, K3's share of the rows that see
// no key). K2 is instantiated and exported by flash_attn_bwd_dq.cu, K3 by
// flash_attn_bwd_dkv.cu, so the two translation units build side by side.
// Every other call has its own source, and the entries here return 1004
// for it: bf16 at every head dim up to 128, masked or not (K5b among
// them), and at 192 and 256 without a mask runs flash_attn_bwd_sm90.cu
// (TMA, a producer warpgroup, wgmma), and f32 at every D, masked or not
// (up to 128), flash_attn_bwd_f32tc.cu (3xTF32 mma.sync). The mma.sync
// templates that took bf16 up to D = 128 (masked, and K5b) are retired.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_dq_kernel`
// (:209-246, launched at :327) and `_flash_dkv_kernel` (:249-292, launched
// at :345), both driven by `_flash_bwd` (:305), plus the rowsum
// delta = rowsum(dO * O) that `_flash_bwd` takes in plain jnp (:316-320),
// at D % 64 == 0 above 256. Given the forward's Q, K, V, O, its per-row
// logsumexp and the output gradient dO on [B, H, L, D], with P rebuilt as
// exp(scale * Q K^T - lse):
//   dS = P * (dO V^T - delta) * scale            (rounded to bf16)
//   dQ = dS K,   dK = dS^T Q,   dV = P^T dO      (P rounded to bf16)
// f32 accumulation, bf16 outputs, causal mask aligned bottom-right (key j
// visible to query i when j <= i + Lk - Lq). The reference's Pallas
// kernels take any D % 64 == 0 (its dispatch sends an unmasked call
// there: analytics_zoo_tpu/ops/attention.py:107-112; a masked one takes
// its einsum path, so these instantiations are unmasked).
//
// Design. Pallas ran each kernel as a grid whose last axis was a sequential
// accumulation in VMEM scratch. Here a thread block owns one output tile and
// walks the other axis in a loop of its own, so neither kernel needs atomics
// and both are deterministic: K2 (zoo_flash_attn_bwd_dq) a block of q rows
// walking the kv tiles, computing delta for its rows first (written out for
// K3); K3 (zoo_flash_attn_bwd_dkv) a block of keys walking the q tiles,
// with the products taken with kv on the rows, S^T = K Q^T and dP^T = V
// dO^T, so P^T and dS^T come out in mma accumulator layout and are
// re-packed in registers as the A fragments of dV += P^T dO and dK += dS^T
// Q. D split across warps (flash_bwd_dq_bf16_split_kernel,
// flash_bwd_dkv_bf16_split_kernel): 64 + 64 accumulators a warp of K3 at
// D = 512 would leave ptxas 65,536 / 512 = 128 registers a thread for 16
// warps a block of 64 keys, which those 128 accumulators and S^T and dP^T
// pass. So a block owns kSplitRows = 32 rows (K2: queries; K3: keys) as 2
// groups of 16, each of kSplit = D / 64 warps (D threads in all), warp j of
// a group owning dims [64j, 64j + 64) of dQ (32 registers), or of dK and
// dV (64). Each warp computes the partial S and dP (K3: S^T and dP^T) over
// its own 64 dims with mma.sync.m16n8k16 and writes them to shared memory
// in fragment order; after a barrier every warp of the group sums the
// kSplit partials in one fixed order, so all of them build bit-identical P
// and dS. No flop is repeated (6 * D and 8 * D a visible pair; recomputing
// S and dP in every warp would cost 4 * D * kSplit); the exp and rounding
// work is, once a warp. At 128 registers a thread (D = 512) K2 walks kv
// tiles of kWideKv = 32 keys (S and dP 16 registers each) and K3, beside
// its 64 accumulators, q tiles of kSplitQ = 16 rows (8 each). Three
// barriers a tile: staged, partials written, and (the next tile's first)
// every warp done reading both. Shared memory (dynamic): K2 Q, dO, K and V
// [32][D+8] bf16 (rows padded by 16 bytes) and the partials,
// 125,184-198,912 bytes; K3 K and V [32][D+8], Q and dO [16][D+8] and the
// partials, 83,584-132,736. Causal: K2 never loads kv tiles wholly above
// the diagonal; K3 starts at the first q tile whose last row sees its
// first key; a row group whose rows see nothing of a tile skips its
// arithmetic.
//
// What bounds it. At [4, 8, 2048, 512] causal the tensor cores (0.2086 ms
// for K2, 0.2781 for K3 at 989 TFLOP/s); these kernels are far from it:
// synchronous tile loads, mma.sync rather than wgmma, scalar gathers for
// the row-contracted B fragments, and each K/V tile (K2) or Q/dO tile (K3)
// re-read from L2 by every block of its (b, h). The Hopper design of
// flash_attn_bwd_sm90.cu is later work here.
//
// Build (plain C interface, loaded with ctypes), one library a source:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libzoo_flash_attn_bwd_dq.so flash_attn_bwd_dq.cu
// and the same for flash_attn_bwd_dkv.cu.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;        // Lq and Lk: multiples of it
constexpr int kThreads = 128;    // the f32 tensor-core kernels' block
constexpr int kPad = 8;          // bf16 elements of smem row padding
constexpr int kWideKv = 32;      // K2: kv rows a tile
constexpr int kSlice = 64;       // dims of D a warp owns
constexpr int kSplitRows = 32;   // q rows (K2) or keys (K3) a block, 2
                                 // groups of 16
constexpr int kSplitQ = 16;      // K3: q rows a tile
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;                 // K2 only (delta)
  const void* dout;
  const float* lse;              // [B*H, Lq], natural log
  float* delta;                  // [B*H, Lq]: written by K2, read by K3
  const uint8_t* mask;           // [B, Lk] key-padding mask, or nullptr
  long long mask_sb;             // its batch stride
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_sl;    // element strides: batch, head, seq
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  long long do_sb, do_sh, do_sl;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  int h, lq, lk;
  float scale;                   // softmax scale
  float scale_log2;              // scale * log2(e)
  int causal;
};

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (static_cast<uint32_t>(hi) << 16) | static_cast<uint32_t>(lo);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float to_f32(uint16_t x) {  // bf16 bits
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}
__device__ __forceinline__ float to_f32(float x) { return x; }

// K3's share of the rows that see no key (flash_attn_bwd_f32tc.cu's
// masked K3): e[c] = inv_lk * sum of dO[i][c] over the first n_empty rows,
// for c < D. Those rows are a prefix: row i sees no key when the first
// real key lies beyond i + Lk - Lq under causal, or when there is no real
// key at all.
template <int D, typename T>
__device__ void empty_rows_dv(float* e, int* s_first, const uint8_t* mrow,
                              const T* dout, long long do_sl, int lq, int lk,
                              int causal, float inv_lk, int tid) {
  if (tid == 0) *s_first = lk;
  __syncthreads();
  for (int j = tid; j < lk; j += kThreads) {
    if (mrow[j] != 0) {
      atomicMin(s_first, j);
      break;
    }
  }
  __syncthreads();
  const int first = *s_first;
  const int n_empty = causal ? min(max(first - (lk - lq), 0), lq)
                             : (first == lk ? lq : 0);
  if (tid < D) {
    float acc = 0.f;
    for (int i = 0; i < n_empty; ++i) acc += to_f32(dout[i * do_sl + tid]);
    e[tid] = acc * inv_lk;
  }
  __syncthreads();
}

// B fragment of a product contracting down the rows of a smem tile: k runs
// over rows kr.. of `t`, n over column `col`
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const uint16_t* t, int kr, int col) {
  b0 = pack_raw(t[kr * LD + col], t[(kr + 1) * LD + col]);
  b1 = pack_raw(t[(kr + 8) * LD + col], t[(kr + 9) * LD + col]);
}

// copy `rows` rows of D bf16 from device memory (row stride `sl`) into a
// padded smem tile, 16 bytes a thread of the block's NT
template <int D, int LD, int NT = kThreads>
__device__ __forceinline__ void stage(uint16_t* t, const uint16_t* src,
                                      long long sl, int rows, int tid) {
  for (int i = tid; i < rows * D / 8; i += NT) {
    const int r = i / (D / 8);
    const int c = (i - r * (D / 8)) * 8;
    *reinterpret_cast<uint4*>(&t[r * LD + c]) =
        *reinterpret_cast<const uint4*>(src + r * sl + c);
  }
}

// a split block's partial products: two of [D / 32 warps][n-blocks of the
// tile][32 lanes] float4
template <int D, int kN>
constexpr size_t split_partials_bytes() {
  return 2 * (D / 32) * kN * 32 * sizeof(float4);
}

// K2: Q and dO of kSplitRows rows, K and V of kWideKv, the partials, lse
// and delta
template <int D>
constexpr size_t bf16_split_dq_smem_bytes() {
  return (2 * kSplitRows + 2 * kWideKv) * (D + kPad) * sizeof(uint16_t)
         + split_partials_bytes<D, kWideKv / 8>()
         + 2 * kSplitRows * sizeof(float);
}

// K3: K and V of kSplitRows keys, Q and dO of kSplitQ rows, the partials,
// lse and delta
template <int D>
constexpr size_t bf16_split_dkv_smem_bytes() {
  return (2 * kSplitRows + 2 * kSplitQ) * (D + kPad) * sizeof(uint16_t)
         + split_partials_bytes<D, kSplitQ / 8>()
         + 2 * kSplitQ * sizeof(float);
}

// ------------------------------------------------- K2 and K3, D > 256 --
// the sum over the kSplit warps of a group of their partial fragments of
// n-block n, slice 0 first in every warp: `at0` is the group's slice 0
__device__ __forceinline__ void sum_partials(float (&x)[4], const float4* t,
                                             int at0, int stride, int n_split) {
  float4 a = t[at0];
#pragma unroll 1
  for (int j = 1; j < n_split; ++j) {
    const float4 u = t[at0 + j * stride];
    a.x += u.x;
    a.y += u.y;
    a.z += u.z;
    a.w += u.w;
  }
  x[0] = a.x;
  x[1] = a.y;
  x[2] = a.z;
  x[3] = a.w;
}

// A fragment of k-step c (16 rows from `r`, which points at row g, column
// t4 * 2 of the warp's slice)
template <int LD>
__device__ __forceinline__ void load_a_slice(uint32_t (&a)[4],
                                             const uint16_t* r, int c) {
  a[0] = ld32(r + c * 16);
  a[1] = ld32(r + 8 * LD + c * 16);
  a[2] = ld32(r + c * 16 + 8);
  a[3] = ld32(r + 8 * LD + c * 16 + 8);
}

// K2 at D in {320, 384, 448, 512}, unmasked: D split across warps (the
// header's design notes). Block: kSplitRows q rows = 2 row groups of 16,
// each of kSplit warps; D threads in all. Warp w is row group w / kSplit
// and owns slice w % kSplit of D.
template <int D>
__global__ void __launch_bounds__(D)
flash_bwd_dq_bf16_split_kernel(const Params p) {
  static_assert(D % kSlice == 0 && D > 256 && D <= 512,
                "head_dim: 320, 384, 448 or 512");
  constexpr int kSplit = D / kSlice;     // warps of a row group
  constexpr int kWarps = D / 32;
  constexpr int LD = D + kPad;
  constexpr int KV = kWideKv;
  constexpr int kN = KV / 8;             // n-blocks of 8 keys in a tile
  extern __shared__ __align__(16) unsigned char zoo_smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(zoo_smem);
  uint16_t* sDO = sQ + kSplitRows * LD;
  uint16_t* sK = sDO + kSplitRows * LD;
  uint16_t* sV = sK + KV * LD;
  // partial S and dP in fragment order: [warp][n-block][lane]
  float4* sS = reinterpret_cast<float4*>(sV + KV * LD);
  float4* sP = sS + kWarps * kN * 32;
  float* sLse = reinterpret_cast<float*>(sP + kWarps * kN * 32);  // log2
  float* sDelta = sLse + kSplitRows;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rg = warp / kSplit;          // row group
  const int slice = warp - rg * kSplit;  // which 64 dims of D
  const int col0 = slice * kSlice;
  const int q0 = qt * kSplitRows;
  const int offset = p.lk - p.lq;

  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.v_sb + hh * p.v_sh;
  const uint16_t* o = static_cast<const uint16_t*>(p.o) + b * p.o_sb + hh * p.o_sh;
  const uint16_t* dout =
      static_cast<const uint16_t*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  uint16_t* dq = static_cast<uint16_t*>(p.dq) + b * p.dq_sb + hh * p.dq_sh;

  stage<D, LD, D>(sQ, q + q0 * p.q_sl, p.q_sl, kSplitRows, tid);
  stage<D, LD, D>(sDO, dout + q0 * p.do_sl, p.do_sl, kSplitRows, tid);
  __syncthreads();
  // delta = rowsum(dO * O) in f32: a warp takes a row at a time, each
  // lane its 8-element chunks 32 chunks apart, summed by shuffles
  for (int r = warp; r < kSplitRows; r += kWarps) {
    const uint16_t* orow = o + (q0 + r) * p.o_sl;
    const uint16_t* drow = sDO + r * LD;
    float acc = 0.f;
    for (int c = lane * 8; c < D; c += 32 * 8) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
      const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(o2[j]);
        const float2 e = __bfloat1622float2(d2[j]);
        acc = fmaf(a.x, e.x, acc);
        acc = fmaf(a.y, e.y, acc);
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane == 0) {
      const long long at = static_cast<long long>(bh) * p.lq + q0 + r;
      sDelta[r] = acc;
      p.delta[at] = acc;
      sLse[r] = p.lse[at] * kLog2e;
    }
  }
  __syncthreads();

  const int row0 = rg * 16;              // the row group's first row
  const int ra = row0 + g;               // a thread's two rows in the block
  const int rb = ra + 8;
  const float lse_a = sLse[ra], lse_b = sLse[rb];
  const float del_a = sDelta[ra], del_b = sDelta[rb];
  // this thread's A-fragment elements of its slice, rows ra and rb
  const uint16_t* qa = sQ + ra * LD + col0 + t4 * 2;
  const uint16_t* da = sDO + ra * LD + col0 + t4 * 2;

  float acc[kSlice / 8][4];
#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  int n_tiles = p.lk / KV;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kSplitRows - 1 + offset) / KV + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // every warp is done with the last tile and partials
    stage<D, LD, D>(sK, k + static_cast<long long>(kt) * KV * p.k_sl, p.k_sl,
                    KV, tid);
    stage<D, LD, D>(sV, v + static_cast<long long>(kt) * KV * p.v_sl, p.v_sl,
                    KV, tid);
    __syncthreads();

    // the same for every warp of the row group: rows all above the tile
    const bool active = !(p.causal && q0 + row0 + 15 + offset < kt * KV);
    float s[kN][4];
    if (active) {
      // partial S = Q K^T and dP = dO V^T over this warp's 64 dims
      float dp[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kSlice / 16; ++c) {
        uint32_t a[4], e[4];
        load_a_slice<LD>(a, qa, c);
        load_a_slice<LD>(e, da, c);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const int at = (n * 8 + g) * LD + col0 + c * 16 + t4 * 2;
          mma_16816(s[n], a, ld32(sK + at), ld32(sK + at + 8));
          mma_16816(dp[n], e, ld32(sV + at), ld32(sV + at + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int at = (warp * kN + n) * 32 + lane;
        sS[at] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        sP[at] = make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
      }
    }
    __syncthreads();  // every slice's partials are written
    if (!active) continue;

    // S and dP, the sums of the row group's partials (an n-block at a
    // time, so that dP is never held whole), and dS = P * (dP - delta) *
    // scale with P = exp(scale * S - lse)
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int at0 = (rg * kSplit * kN + n) * 32 + lane;
      float dp[4];
      sum_partials(s[n], sS, at0, kN * 32, kSplit);
      sum_partials(dp, sP, at0, kN * 32, kSplit);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool top = e < 2;
        float pr = exp2f(s[n][e] * p.scale_log2 - (top ? lse_a : lse_b));
        const int col = n * 8 + t4 * 2 + (e & 1);  // key within the tile
        if (p.causal && kt * KV + col > q0 + (top ? ra : rb) + offset) {
          pr = 0.f;
        }
        s[n][e] = pr * (dp[e] - (top ? del_a : del_b)) * p.scale;
      }
    }

    // dQ[:, slice] += dS K[:, slice], 16 keys at a time
#pragma unroll
    for (int j = 0; j < KV / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const int kr = j * 16 + t4 * 2;
#pragma unroll
      for (int n = 0; n < kSlice / 8; ++n) {
        uint32_t b0, b1;
        load_b_rows<LD>(b0, b1, sK, kr, col0 + n * 8 + g);
        mma_16816(acc[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n) {
    const int col = col0 + n * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(dq + (q0 + ra) * p.dq_sl + col) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(dq + (q0 + rb) * p.dq_sl + col) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
}

// K3 at D in {320, 384, 448, 512}, unmasked: the same split. Block:
// kSplitRows keys = 2 slabs of 16, each of kSplit warps; D threads in
// all. Warp w is slab w / kSplit and owns slice w % kSplit of dK and dV.
// q tiles of kSplitQ rows: one k-step of dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(D)
flash_bwd_dkv_bf16_split_kernel(const Params p) {
  static_assert(D % kSlice == 0 && D > 256 && D <= 512 && kSplitQ == 16,
                "head_dim: 320, 384, 448 or 512; q tiles of 16 rows");
  constexpr int kSplit = D / kSlice;     // warps of a slab
  constexpr int kWarps = D / 32;
  constexpr int LD = D + kPad;
  constexpr int QT = kSplitQ;
  constexpr int kN = QT / 8;             // n-blocks of 8 queries in a tile
  extern __shared__ __align__(16) unsigned char zoo_smem[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(zoo_smem);
  uint16_t* sV = sK + kSplitRows * LD;
  uint16_t* sQ = sV + kSplitRows * LD;
  uint16_t* sDO = sQ + QT * LD;
  // partial S^T and dP^T in fragment order: [warp][n-block][lane]
  float4* sS = reinterpret_cast<float4*>(sDO + QT * LD);
  float4* sP = sS + kWarps * kN * 32;
  float* sLse = reinterpret_cast<float*>(sP + kWarps * kN * 32);  // log2
  float* sDelta = sLse + QT;

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int slab = warp / kSplit;
  const int slice = warp - slab * kSplit;  // which 64 dims of dK and dV
  const int col0 = slice * kSlice;
  const int k0 = kt * kSplitRows;
  const int offset = p.lk - p.lq;

  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.v_sb + hh * p.v_sh;
  const uint16_t* dout =
      static_cast<const uint16_t*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  uint16_t* dk = static_cast<uint16_t*>(p.dk) + b * p.dk_sb + hh * p.dk_sh;
  uint16_t* dv = static_cast<uint16_t*>(p.dv) + b * p.dv_sb + hh * p.dv_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.lq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.lq;

  // K and V of the block's keys (seen after the first q tile's barrier)
  stage<D, LD, D>(sK, k + k0 * p.k_sl, p.k_sl, kSplitRows, tid);
  stage<D, LD, D>(sV, v + k0 * p.v_sl, p.v_sl, kSplitRows, tid);

  const int row0 = slab * 16;            // the slab's first key in the block
  const int ka = k0 + row0 + g;          // the two keys a thread holds
  const int kb = ka + 8;
  // this thread's A-fragment elements of its slice, keys ka and kb
  const uint16_t* kfa = sK + (row0 + g) * LD + col0 + t4 * 2;
  const uint16_t* vfa = sV + (row0 + g) * LD + col0 + t4 * 2;

  float acc_k[kSlice / 8][4], acc_v[kSlice / 8][4];
#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }

  // the first q tile whose last row sees this block's first key
  int first = 0;
  if (p.causal) {
    const int x = k0 - offset - (QT - 1);
    first = x > 0 ? (x + QT - 1) / QT : 0;
  }
  const int n_tiles = p.lq / QT;

  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * QT;
    __syncthreads();  // every warp is done with the last tile and partials
    stage<D, LD, D>(sQ, q + static_cast<long long>(q0) * p.q_sl, p.q_sl, QT,
                    tid);
    stage<D, LD, D>(sDO, dout + static_cast<long long>(q0) * p.do_sl,
                    p.do_sl, QT, tid);
    if (tid < QT) {
      sLse[tid] = lse[q0 + tid] * kLog2e;
      sDelta[tid] = delta[q0 + tid];
    }
    __syncthreads();

    // the same for every warp of the slab: its first key lies after
    // every row's view
    const bool active = !(p.causal && k0 + row0 > q0 + QT - 1 + offset);
    float s[kN][4], dp[kN][4];
    if (active) {
      // partial S^T = K Q^T and dP^T = V dO^T over this warp's 64 dims
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kSlice / 16; ++c) {
        uint32_t a[4], e[4];
        load_a_slice<LD>(a, kfa, c);
        load_a_slice<LD>(e, vfa, c);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const int at = (n * 8 + g) * LD + col0 + c * 16 + t4 * 2;
          mma_16816(s[n], a, ld32(sQ + at), ld32(sQ + at + 8));
          mma_16816(dp[n], e, ld32(sDO + at), ld32(sDO + at + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int at = (warp * kN + n) * 32 + lane;
        sS[at] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
        sP[at] = make_float4(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
      }
    }
    __syncthreads();  // every slice's partials are written
    if (!active) continue;

#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int at0 = (slab * kSplit * kN + n) * 32 + lane;
      sum_partials(s[n], sS, at0, kN * 32, kSplit);
      sum_partials(dp[n], sP, at0, kN * 32, kSplit);
    }

    // P^T and dS^T; the columns are queries
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + t4 * 2 + (e & 1);
        float pr = exp2f(s[n][e] * p.scale_log2 - sLse[qc]);
        if (p.causal && (e < 2 ? ka : kb) > q0 + qc + offset) pr = 0.f;
        s[n][e] = pr;
        dp[n][e] = pr * (dp[n][e] - sDelta[qc]) * p.scale;
      }
    }

    // dV[:, slice] += P^T dO[:, slice] and dK[:, slice] += dS^T Q[:, slice]
    uint32_t pa[4], da[4];
    pa[0] = pack_bf16(s[0][0], s[0][1]);
    pa[1] = pack_bf16(s[0][2], s[0][3]);
    pa[2] = pack_bf16(s[1][0], s[1][1]);
    pa[3] = pack_bf16(s[1][2], s[1][3]);
    da[0] = pack_bf16(dp[0][0], dp[0][1]);
    da[1] = pack_bf16(dp[0][2], dp[0][3]);
    da[2] = pack_bf16(dp[1][0], dp[1][1]);
    da[3] = pack_bf16(dp[1][2], dp[1][3]);
    const int qr = t4 * 2;
#pragma unroll
    for (int n = 0; n < kSlice / 8; ++n) {
      uint32_t b0, b1;
      load_b_rows<LD>(b0, b1, sDO, qr, col0 + n * 8 + g);
      mma_16816(acc_v[n], pa, b0, b1);
      load_b_rows<LD>(b0, b1, sQ, qr, col0 + n * 8 + g);
      mma_16816(acc_k[n], da, b0, b1);
    }
  }

#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n) {
    const int col = col0 + n * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(dk + ka * p.dk_sl + col) =
        pack_bf16(acc_k[n][0], acc_k[n][1]);
    *reinterpret_cast<uint32_t*>(dk + kb * p.dk_sl + col) =
        pack_bf16(acc_k[n][2], acc_k[n][3]);
    *reinterpret_cast<uint32_t*>(dv + ka * p.dv_sl + col) =
        pack_bf16(acc_v[n][0], acc_v[n][1]);
    *reinterpret_cast<uint32_t*>(dv + kb * p.dv_sl + col) =
        pack_bf16(acc_v[n][2], acc_v[n][3]);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t stream, int threads = kThreads) {
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// 0, or 1000 + n for an argument the kernels do not take
int check(int dtype, int lq, int lk, int batch, int heads, int causal) {
  if (lq % kTile || lk % kTile) return 1001;
  if (causal && lq > lk) return 1002;
  if (batch * heads > 65535) return 1003;
  if (dtype != 0 && dtype != 1) return 1005;
  return 0;
}

// fn(std::integral_constant<int, D>) for head dim d: every multiple of 8
// up to 128, and 192, 256, 320, 384, 448 and 512 (flash_attn_bwd_f32tc.cu
// takes them all in f32; the entries here bf16 at 320 to 512 only); 1004
// for any other d
template <typename Fn>
int with_head_dim(int d, Fn&& fn) {
  switch (d) {
    case 8: return fn(std::integral_constant<int, 8>{});
    case 16: return fn(std::integral_constant<int, 16>{});
    case 24: return fn(std::integral_constant<int, 24>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    case 40: return fn(std::integral_constant<int, 40>{});
    case 48: return fn(std::integral_constant<int, 48>{});
    case 56: return fn(std::integral_constant<int, 56>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 72: return fn(std::integral_constant<int, 72>{});
    case 80: return fn(std::integral_constant<int, 80>{});
    case 88: return fn(std::integral_constant<int, 88>{});
    case 96: return fn(std::integral_constant<int, 96>{});
    case 104: return fn(std::integral_constant<int, 104>{});
    case 112: return fn(std::integral_constant<int, 112>{});
    case 120: return fn(std::integral_constant<int, 120>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 192: return fn(std::integral_constant<int, 192>{});
    case 256: return fn(std::integral_constant<int, 256>{});
    case 320: return fn(std::integral_constant<int, 320>{});
    case 384: return fn(std::integral_constant<int, 384>{});
    case 448: return fn(std::integral_constant<int, 448>{});
    case 512: return fn(std::integral_constant<int, 512>{});
    default: return 1004;
  }
}

}  // namespace
