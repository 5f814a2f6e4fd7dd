// Flash-attention backward (K2 dQ, K3 dK/dV; K5b backward at the other
// head dims) for Hopper, sm_90a: the kernel templates. K2 is instantiated
// and exported by flash_attn_bwd_dq.cu, K3 by flash_attn_bwd_dkv.cu, so the
// two translation units build side by side.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_dq_kernel`
// (:209-246, launched at :327) and `_flash_dkv_kernel` (:249-292, launched
// at :345), both driven by `_flash_bwd` (:305), plus the rowsum
// delta = rowsum(dO * O) that `_flash_bwd` takes in plain jnp (:316-320).
// Given the forward's Q, K, V, O, its per-row logsumexp and the output
// gradient dO on [B, H, L, D], with P rebuilt as exp(scale * Q K^T - lse):
//   dS = P * (dO V^T - delta) * scale            (rounded to the input dtype)
//   dQ = dS K,   dK = dS^T Q,   dV = P^T dO      (P rounded to dO's dtype)
// f32 accumulation, outputs in the input dtype, causal mask aligned
// bottom-right (key j visible to query i when j <= i + Lk - Lq).
//
// Key-padding mask (optional, [B, Lk] bytes, nonzero = real key): the
// backward of the key-padding branch of analytics_zoo_tpu/ops/attention.py
// (:116-127, JAX's stock Pallas kernel with segment ids on the TPU), with
// the reference einsum path's gradients. Masked pairs get P = 0 and dS = 0,
// so padded keys get exactly zero dK, and dV from no row that sees a key.
// A row that sees no key (all-zero mask row, or causal with left padding)
// took the mean of V in the forward: it gives nothing to dQ or dK and
// dO / Lk to the dV of every key. Such rows are always the first n_empty
// rows of a (b, h) (n_empty follows from the first real key), so K3 adds
// their share as one vector, E = (1/Lk) * sum of their dO rows, to every
// key's dV; the q-tile loop gives them P = 0 like any masked pair.
//
// Head dims (K5b backward). Besides D in {64, 128} (K2, K3), the same
// templates take every D <= 128 that is a multiple of 8: the backward of the
// stock-kernel branch of analytics_zoo_tpu/ops/attention.py (:116-127),
// which on the TPU trains through JAX's stock Pallas flash_attention (its
// own dQ and dK/dV kernels) at head_dim % 64 != 0 (a MiniLM-sized BERT at
// D = 32). The bf16 products that contract over D (S = Q K^T, dP = dO V^T
// in K2, S^T = K Q^T, dP^T = V dO^T in K3) run in k-steps of 16, so at
// D = 8 (mod 16) the last step's upper half is zero in both fragments and
// never read: the smem rows' columns D..D+7 are padding (kPad) and hold
// garbage, which must not meet a zero as 0 * NaN. The products whose N side
// is D (dQ, dK, dV) run in n-blocks of 8 and need nothing. K2's delta takes
// a row's 8-element chunks in turn over two threads, so no read passes D.
// The f32 path gives each of 8 threads D/8 dimensions of a row. Each D is
// its own instantiation, so the register arrays stay sized to it.
//
// Design. Pallas ran each kernel as a grid whose last axis was a sequential
// accumulation in VMEM scratch. Here a thread block owns one output tile and
// walks the other axis in a loop of its own, so neither kernel needs atomics
// and both are deterministic:
//   * K2 (zoo_flash_attn_bwd_dq): one block per (b*h, 64-row q tile). It
//     stages its Q and dO rows in shared memory, computes delta for them
//     (written out for K3) and walks the kv tiles; dQ lives in registers.
//   * K3 (zoo_flash_attn_bwd_dkv): one block per (b*h, 64-row kv tile). It
//     stages its K and V rows and walks the q tiles; the products are taken
//     with kv on the rows, S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come
//     out in mma accumulator layout and are re-packed in registers as the A
//     fragments of dV += P^T dO and dK += dS^T Q (P never touches memory,
//     as in K1). dK and dV live in registers.
//   * bf16: 4 warps, 16 rows each, mma.sync.m16n8k16 (bf16 in, f32
//     accumulate). Every operand tile sits in shared memory (rows padded by
//     16 bytes) and fragments are read per 16-wide slice of D, so at most one
//     A fragment is live at a time: K3 at D = 128 holds its two 16x128 f32
//     accumulators (128 registers a thread) plus S and dP (64). Where a
//     product contracts down the rows of a tile (dS K, P^T dO, dS^T Q) the B
//     fragment is gathered from two rows. 4 tiles of 64 x (D + 8) bf16 exceed
//     48 KB at D = 128, so the shared memory is dynamic.
//   * f32: plain FMA (the tensor cores' f32 path is TF32, which would not
//     hold f32 accuracy): 8 threads share one row of the block's 16, each
//     owning D/8 of its dimensions; dot products are reduced with shuffles.
//   * causal: K2 never loads kv tiles wholly above the diagonal; K3 starts at
//     the first q tile whose last row sees its first key. A warp whose rows
//     see nothing of a tile skips its arithmetic; a masked pair gets P = 0
//     (nothing is divided, so a row with no visible key in a tile is safe).
//   * key padding: K2 stages each kv tile's 64 mask bytes in shared memory
//     beside K and V; K3 reads the mask of its own keys once. Fully padded
//     tiles are still walked (skipping them is later work), and K3 writes
//     every key's dK and dV, zeros included (the outputs come from
//     torch.empty). The mask is a template flag (kMask), so a launch
//     without one runs the unmasked kernels as they were.
//
// What bounds it. Per (b, h) K2 reads Q, K, V, dO, O once and writes dQ, and
// does 6*D flops per visible (q, k) pair; K3 reads Q, K, V, dO and writes
// dK, dV with 8*D flops per pair. At L = 384, D = 64 in bf16 that is about
// 150-200 flops per byte, under the H100's ~295 flop/byte ridge: both are
// bound by bytes (chip_smoke.py computes the bound per shape). These simple
// kernels are far from it: synchronous tile loads (no cp.async/TMA
// pipelining), mma.sync rather than wgmma, scalar gathers for the
// row-contracted B fragments (ldmatrix.trans would do it in one instruction),
// and each K/V tile (K2) or Q/dO tile (K3) is re-read from L2 by every block
// of its (b, h). wgmma, TMA and a producer warp are later work. At small D
// (32 for MiniLM) a pair carries the same exp, mask and rounding work for
// 4x fewer flops than at 64, so the kernels sit further from their byte
// bound there.
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

constexpr int kTile = 64;        // rows per block and per staged tile (bf16)
constexpr int kThreads = 128;    // 4 warps
constexpr int kPad = 8;          // bf16 elements of smem row padding
constexpr int kFmaRows = 16;     // rows a block owns on the f32 path
constexpr int kFmaTile = 32;     // rows per staged tile on the f32 path
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

// K3's share of the rows that see no key: e[c] = inv_lk * sum of dO[i][c]
// over the first n_empty rows, for c < D. Those rows
// are a prefix: row i sees no key when the first real key lies beyond
// i + Lk - Lq under causal, or when there is no real key at all.
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

// whether k-step c has an upper half inside D (at D = 8 mod 16 the last
// one does not: its columns D..D+7 are smem padding, taken as zeros)
template <int D>
__device__ __forceinline__ bool upper_in_d(int c) { return c * 16 + 8 < D; }

// A fragment (16 rows x 16 columns, k-step c of D) of a row-major smem tile
// whose row `0` is `t`; zeros past D
template <int LD, int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* t,
                                       int g, int t4, int c) {
  const uint16_t* pa = t + g * LD + c * 16 + t4 * 2;
  const uint16_t* pb = pa + 8 * LD;
  a[0] = ld32(pa);
  a[1] = ld32(pb);
  a[2] = upper_in_d<D>(c) ? ld32(pa + 8) : 0u;
  a[3] = upper_in_d<D>(c) ? ld32(pb + 8) : 0u;
}

// the B fragment's two registers of a product contracting over D whose B
// rows (n) are the rows of a smem tile: `r` points at row n, column
// c * 16 + t4 * 2; zeros past D
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const uint16_t* r, int c) {
  b0 = ld32(r);
  b1 = upper_in_d<D>(c) ? ld32(r + 8) : 0u;
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
// padded smem tile, 16 bytes a thread
template <int D, int LD>
__device__ __forceinline__ void stage(uint16_t* t, const uint16_t* src,
                                      long long sl, int rows, int tid) {
  for (int i = tid; i < rows * D / 8; i += kThreads) {
    const int r = i / (D / 8);
    const int c = (i - r * (D / 8)) * 8;
    *reinterpret_cast<uint4*>(&t[r * LD + c]) =
        *reinterpret_cast<const uint4*>(src + r * sl + c);
  }
}

template <int D>
constexpr size_t bf16_smem_bytes() {
  return 4 * kTile * (D + kPad) * sizeof(uint16_t) + 2 * kTile * sizeof(float)
         + kTile;  // K2: the kv tile's mask bytes
}

// ------------------------------------------------------------ K2, bf16 --
template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const Params p) {
  static_assert(D % 8 == 0 && D <= 128, "head_dim: a multiple of 8, <= 128");
  constexpr int kSteps = (D + 15) / 16;  // k-steps of the products over D
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char zoo_smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(zoo_smem);
  uint16_t* sDO = sQ + kTile * LD;
  uint16_t* sK = sDO + kTile * LD;
  uint16_t* sV = sK + kTile * LD;
  float* sLse = reinterpret_cast<float*>(sV + kTile * LD);  // log2 domain
  float* sDelta = sLse + kTile;
  uint8_t* sM = reinterpret_cast<uint8_t*>(sDelta + kTile);  // tile's mask

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = qt * kTile;
  const int offset = p.lk - p.lq;

  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.v_sb + hh * p.v_sh;
  const uint16_t* o = static_cast<const uint16_t*>(p.o) + b * p.o_sb + hh * p.o_sh;
  const uint16_t* dout =
      static_cast<const uint16_t*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  uint16_t* dq = static_cast<uint16_t*>(p.dq) + b * p.dq_sb + hh * p.dq_sh;
  const uint8_t* mrow = kMask ? p.mask + b * p.mask_sb : nullptr;

  stage<D, LD>(sQ, q + q0 * p.q_sl, p.q_sl, kTile, tid);
  stage<D, LD>(sDO, dout + q0 * p.do_sl, p.do_sl, kTile, tid);
  __syncthreads();
  {
    // delta = rowsum(dO * O) in f32: two threads per row, taking its
    // 8-element chunks in turn (at D = 8 mod 16 the second has one fewer)
    const int r = tid >> 1;
    const int half = tid & 1;
    const uint16_t* orow = o + (q0 + r) * p.o_sl;
    const uint16_t* drow = sDO + r * LD;
    float acc = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += 16) {
      const int c = c0 + half * 8;
      if (c >= D) break;
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
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      const long long at = static_cast<long long>(bh) * p.lq + q0 + r;
      sDelta[r] = acc;
      p.delta[at] = acc;
      sLse[r] = p.lse[at] * kLog2e;
    }
  }
  __syncthreads();

  const int row0 = warp * 16;          // this warp's first row in the tile
  const int ra = row0 + g;
  const int rb = ra + 8;
  const float lse_a = sLse[ra], lse_b = sLse[rb];
  const float del_a = sDelta[ra], del_b = sDelta[rb];

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  int n_tiles = p.lk / kTile;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kTile - 1 + offset) / kTile + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // every warp is done with the previous tile
    stage<D, LD>(sK, k + static_cast<long long>(kt) * kTile * p.k_sl, p.k_sl,
                 kTile, tid);
    stage<D, LD>(sV, v + static_cast<long long>(kt) * kTile * p.v_sl, p.v_sl,
                 kTile, tid);
    if (kMask && tid < kTile) sM[tid] = mrow[kt * kTile + tid];
    __syncthreads();

    // a warp whose rows all lie above this tile has nothing to add
    if (p.causal && q0 + row0 + 15 + offset < kt * kTile) continue;

    // S = Q K^T and dP = dO V^T for 16 rows x 64 keys
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kSteps; ++c) {
      uint32_t qa[4], da[4];
      load_a<LD, D>(qa, sQ + row0 * LD, g, t4, c);
      load_a<LD, D>(da, sDO + row0 * LD, g, t4, c);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const int at = (n * 8 + g) * LD + c * 16 + t4 * 2;
        uint32_t b0, b1;
        load_b_cols<D>(b0, b1, sK + at, c);
        mma_16816(s[n], qa, b0, b1);
        load_b_cols<D>(b0, b1, sV + at, c);
        mma_16816(dp[n], da, b0, b1);
      }
    }

    // dS = P * (dP - delta) * scale, P = exp(scale * S - lse); masked -> 0
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool top = e < 2;
        float pr = exp2f(s[n][e] * p.scale_log2 - (top ? lse_a : lse_b));
        const int col = n * 8 + t4 * 2 + (e & 1);  // key within the tile
        if (p.causal && kt * kTile + col > q0 + (top ? ra : rb) + offset) {
          pr = 0.f;
        }
        if (kMask && sM[col] == 0) pr = 0.f;
        s[n][e] = pr * (dp[n][e] - (top ? del_a : del_b)) * p.scale;
      }
    }

    // dQ += dS K, 16 keys at a time; dS's accumulator fragments of key
    // columns [16j, 16j+16) are exactly its A fragment
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const int kr = j * 16 + t4 * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_rows<LD>(b0, b1, sK, kr, n * 8 + g);
        mma_16816(acc[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(dq + (q0 + ra) * p.dq_sl + col) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(dq + (q0 + rb) * p.dq_sl + col) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
}

// ------------------------------------------------------------ K3, bf16 --
template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const Params p) {
  static_assert(D % 8 == 0 && D <= 128, "head_dim: a multiple of 8, <= 128");
  constexpr int kSteps = (D + 15) / 16;  // k-steps of the products over D
  constexpr int LD = D + kPad;
  extern __shared__ __align__(16) unsigned char zoo_smem[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(zoo_smem);
  uint16_t* sV = sK + kTile * LD;
  uint16_t* sQ = sV + kTile * LD;
  uint16_t* sDO = sQ + kTile * LD;
  float* sLse = reinterpret_cast<float*>(sDO + kTile * LD);  // log2 domain
  float* sDelta = sLse + kTile;
  __shared__ float sE[D];        // dV share of the rows that see no key
  __shared__ int sFirst;         // first real key of this batch row

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = kt * kTile;
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
  const uint8_t* mrow = kMask ? p.mask + b * p.mask_sb : nullptr;

  stage<D, LD>(sK, k + k0 * p.k_sl, p.k_sl, kTile, tid);
  stage<D, LD>(sV, v + k0 * p.v_sl, p.v_sl, kTile, tid);
  if (kMask) {
    // P^T dO for the rows that see no key (P = 1/Lk rounded to bf16, as
    // the probabilities are before P^T dO)
    empty_rows_dv<D>(sE, &sFirst, mrow, dout, p.do_sl, p.lq, p.lk, p.causal,
                     __bfloat162float(__float2bfloat16(1.f / p.lk)), tid);
  }

  const int row0 = warp * 16;          // this warp's first key in the tile
  const int ka = k0 + row0 + g;        // the two keys a thread holds
  const int kb = ka + 8;
  const bool real_a = !kMask || mrow[ka] != 0;
  const bool real_b = !kMask || mrow[kb] != 0;

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }

  // the first q tile whose last row sees this tile's first key
  int first = 0;
  if (p.causal) {
    const int x = k0 - offset - (kTile - 1);
    first = x > 0 ? (x + kTile - 1) / kTile : 0;
  }
  const int n_tiles = p.lq / kTile;

  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // every warp is done with the previous tile
    stage<D, LD>(sQ, q + static_cast<long long>(q0) * p.q_sl, p.q_sl, kTile, tid);
    stage<D, LD>(sDO, dout + static_cast<long long>(q0) * p.do_sl, p.do_sl,
                 kTile, tid);
    if (tid < kTile) {
      sLse[tid] = lse[q0 + tid] * kLog2e;
      sDelta[tid] = delta[q0 + tid];
    }
    __syncthreads();

    // a warp whose first key lies after every row's view has nothing to add
    if (p.causal && k0 + row0 > q0 + kTile - 1 + offset) continue;

    // S^T = K Q^T and dP^T = V dO^T for 16 keys x 64 queries
    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kSteps; ++c) {
      uint32_t ka_f[4], va_f[4];
      load_a<LD, D>(ka_f, sK + row0 * LD, g, t4, c);
      load_a<LD, D>(va_f, sV + row0 * LD, g, t4, c);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const int at = (n * 8 + g) * LD + c * 16 + t4 * 2;
        uint32_t b0, b1;
        load_b_cols<D>(b0, b1, sQ + at, c);
        mma_16816(s[n], ka_f, b0, b1);
        load_b_cols<D>(b0, b1, sDO + at, c);
        mma_16816(dp[n], va_f, b0, b1);
      }
    }

    // P^T and dS^T; the columns are queries
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + t4 * 2 + (e & 1);
        float pr = exp2f(s[n][e] * p.scale_log2 - sLse[qc]);
        if (p.causal && (e < 2 ? ka : kb) > q0 + qc + offset) pr = 0.f;
        if (kMask && !(e < 2 ? real_a : real_b)) pr = 0.f;
        s[n][e] = pr;
        dp[n][e] = pr * (dp[n][e] - sDelta[qc]) * p.scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, 16 queries at a time
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      da[0] = pack_bf16(dp[2 * j][0], dp[2 * j][1]);
      da[1] = pack_bf16(dp[2 * j][2], dp[2 * j][3]);
      da[2] = pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]);
      da[3] = pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3]);
      const int qr = j * 16 + t4 * 2;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_rows<LD>(b0, b1, sDO, qr, n * 8 + g);
        mma_16816(acc_v[n], pa, b0, b1);
        load_b_rows<LD>(b0, b1, sQ, qr, n * 8 + g);
        mma_16816(acc_k[n], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(dk + ka * p.dk_sl + col) =
        pack_bf16(acc_k[n][0], acc_k[n][1]);
    *reinterpret_cast<uint32_t*>(dk + kb * p.dk_sl + col) =
        pack_bf16(acc_k[n][2], acc_k[n][3]);
    const float e0 = kMask ? sE[col] : 0.f;
    const float e1 = kMask ? sE[col + 1] : 0.f;
    *reinterpret_cast<uint32_t*>(dv + ka * p.dv_sl + col) =
        pack_bf16(acc_v[n][0] + e0, acc_v[n][1] + e1);
    *reinterpret_cast<uint32_t*>(dv + kb * p.dv_sl + col) =
        pack_bf16(acc_v[n][2] + e0, acc_v[n][3] + e1);
  }
}

// ------------------------------------------------------------- K2, f32 --
template <int DP>
__device__ __forceinline__ float row_dot(const float (&x)[DP], const float* y) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < DP; ++i) acc = fmaf(x[i], y[i], acc);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  return acc;
}

template <int D>
__device__ __forceinline__ void stage_f32(float (*t)[D], const float* src,
                                          long long sl, int tid) {
  for (int i = tid; i < kFmaTile * D / 4; i += kThreads) {
    const int r = i / (D / 4);
    const int c = (i - r * (D / 4)) * 4;
    *reinterpret_cast<float4*>(&t[r][c]) =
        *reinterpret_cast<const float4*>(src + r * sl + c);
  }
}

template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const Params p) {
  static_assert(D % 8 == 0 && D <= 128, "head_dim: a multiple of 8, <= 128");
  constexpr int DP = D / 8;  // dimensions per thread
  __shared__ __align__(16) float sK[kFmaTile][D];
  __shared__ __align__(16) float sV[kFmaTile][D];
  __shared__ uint8_t sM[kFmaTile];

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int tid = threadIdx.x;
  const int part = tid & 7;                  // 8 consecutive lanes per row
  const int row = qt * kFmaRows + (tid >> 3);
  const int d0 = part * DP;
  const int offset = p.lk - p.lq;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hh * p.v_sh;
  const float* o = static_cast<const float*>(p.o) + b * p.o_sb + hh * p.o_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + hh * p.dq_sh;
  const uint8_t* mrow = kMask ? p.mask + b * p.mask_sb : nullptr;

  float qr[DP], dr[DP], acc[DP];
  float part_delta = 0.f;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = q[row * p.q_sl + d0 + i];
    dr[i] = dout[row * p.do_sl + d0 + i];
    part_delta = fmaf(dr[i], o[row * p.o_sl + d0 + i], part_delta);
    acc[i] = 0.f;
  }
  part_delta += __shfl_xor_sync(0xffffffffu, part_delta, 1);
  part_delta += __shfl_xor_sync(0xffffffffu, part_delta, 2);
  const float del = part_delta + __shfl_xor_sync(0xffffffffu, part_delta, 4);
  const long long at = static_cast<long long>(bh) * p.lq + row;
  if (part == 0) p.delta[at] = del;
  const float lse2 = p.lse[at] * kLog2e;

  int n_tiles = p.lk / kFmaTile;
  if (p.causal) {
    n_tiles = min(n_tiles, (qt * kFmaRows + kFmaRows - 1 + offset) / kFmaTile + 1);
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    stage_f32<D>(sK, k + static_cast<long long>(kt) * kFmaTile * p.k_sl, p.k_sl, tid);
    stage_f32<D>(sV, v + static_cast<long long>(kt) * kFmaTile * p.v_sl, p.v_sl, tid);
    if (kMask && tid < kFmaTile) sM[tid] = mrow[kt * kFmaTile + tid];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kFmaTile; ++j) {
      const float s = row_dot<DP>(qr, &sK[j][d0]);
      const float dpv = row_dot<DP>(dr, &sV[j][d0]);
      float pr = exp2f(s * p.scale_log2 - lse2);
      if (p.causal && kt * kFmaTile + j > row + offset) pr = 0.f;
      if (kMask && sM[j] == 0) pr = 0.f;
      const float ds = pr * (dpv - del) * p.scale;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] = fmaf(ds, sK[j][d0 + i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < DP; ++i) dq[row * p.dq_sl + d0 + i] = acc[i];
}

// ------------------------------------------------------------- K3, f32 --
template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const Params p) {
  static_assert(D % 8 == 0 && D <= 128, "head_dim: a multiple of 8, <= 128");
  constexpr int DP = D / 8;
  __shared__ __align__(16) float sQ[kFmaTile][D];
  __shared__ __align__(16) float sDO[kFmaTile][D];
  __shared__ float sLse[kFmaTile];
  __shared__ float sDelta[kFmaTile];
  __shared__ float sE[D];        // dV share of the rows that see no key
  __shared__ int sFirst;

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int tid = threadIdx.x;
  const int part = tid & 7;
  const int key = kt * kFmaRows + (tid >> 3);
  const int d0 = part * DP;
  const int offset = p.lk - p.lq;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hh * p.v_sh;
  const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  float* dk = static_cast<float*>(p.dk) + b * p.dk_sb + hh * p.dk_sh;
  float* dv = static_cast<float*>(p.dv) + b * p.dv_sb + hh * p.dv_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.lq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.lq;

  const uint8_t* mrow = kMask ? p.mask + b * p.mask_sb : nullptr;
  const bool real = !kMask || mrow[key] != 0;
  if (kMask) {
    empty_rows_dv<D>(sE, &sFirst, mrow, dout, p.do_sl, p.lq, p.lk, p.causal,
                     1.f / p.lk, tid);
  }

  float kr[DP], vr[DP], acc_k[DP], acc_v[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    kr[i] = k[key * p.k_sl + d0 + i];
    vr[i] = v[key * p.v_sl + d0 + i];
    acc_k[i] = acc_v[i] = 0.f;
  }

  int first = 0;
  if (p.causal) {
    const int x = kt * kFmaRows - offset - (kFmaTile - 1);
    first = x > 0 ? (x + kFmaTile - 1) / kFmaTile : 0;
  }
  const int n_tiles = p.lq / kFmaTile;
  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * kFmaTile;
    __syncthreads();
    stage_f32<D>(sQ, q + static_cast<long long>(q0) * p.q_sl, p.q_sl, tid);
    stage_f32<D>(sDO, dout + static_cast<long long>(q0) * p.do_sl, p.do_sl, tid);
    if (tid < kFmaTile) {
      sLse[tid] = lse[q0 + tid] * kLog2e;
      sDelta[tid] = delta[q0 + tid];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kFmaTile; ++i) {
      const float s = row_dot<DP>(kr, &sQ[i][d0]);
      const float dpv = row_dot<DP>(vr, &sDO[i][d0]);
      float pr = exp2f(s * p.scale_log2 - sLse[i]);
      if (p.causal && key > q0 + i + offset) pr = 0.f;
      if (kMask && !real) pr = 0.f;
      const float ds = pr * (dpv - sDelta[i]) * p.scale;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        acc_v[d] = fmaf(pr, sDO[i][d0 + d], acc_v[d]);
        acc_k[d] = fmaf(ds, sQ[i][d0 + d], acc_k[d]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    dk[key * p.dk_sl + d0 + d] = acc_k[d];
    dv[key * p.dv_sl + d0 + d] = kMask ? acc_v[d] + sE[d0 + d] : acc_v[d];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t stream) {
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
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

// fn(std::integral_constant<int, D>) for head dim d: K2/K3 at 64 and 128,
// K5b backward at the other multiples of 8 up to 128; 1004 for any other d
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
    default: return 1004;
  }
}

}  // namespace
