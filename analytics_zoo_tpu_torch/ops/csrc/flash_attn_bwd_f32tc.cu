// Flash-attention backward (K2 dQ and delta, K3 dK/dV) for Hopper, sm_90a:
// the float32 kernels at every head dim up to 128 that is a multiple of 8
// (K2/K3 at 64 and 128, K5b's backward at the others), with or without a
// key-padding mask, and at 192, 256, 320, 384, 448 and 512 without one,
// on the tensor cores at f32 accuracy (3xTF32 mma.sync) with asynchronous
// tile copies (cp.async; above 128 1-D bulk copies).
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_dq_kernel`
// (:209, launched at :327) and `_flash_dkv_kernel` (:249, launched at :345),
// both driven by `_flash_bwd` (:305), plus the rowsum delta = rowsum(dO * O)
// that `_flash_bwd` takes in plain jnp (:316-320); with a key-padding mask,
// or at a head dim that is not a multiple of 64, the backward of the stock
// Pallas kernel that analytics_zoo_tpu/ops/attention.py (:116-127) reaches.
// The semantics are those of the FMA templates that these kernels
// retired (at D <= 128, then above): P = exp(scale * Q K^T -
// lse), dS = P * (dO V^T - delta) * scale, dQ = dS K, dK = dS^T Q,
// dV = P^T dO, all in f32; the causal mask aligned bottom-right (key j
// visible to query i when j <= i + Lk - Lq); masked pairs take P = 0; a
// row that sees no key gives nothing to dQ or dK and dO / Lk to the dV of
// every key (empty_rows_dv).
//
// What bounds them. K2 does 6 * D flops a visible (query, key) pair (S, dP,
// dQ), K3 8 * D (S^T, dP^T, dV, dK). In f32 on plain FMA that is 67
// TFLOP/s of work; the tensor cores take f32 only as TF32 (a 10-bit
// mantissa, about 1e-3 relative a product), which is outside the port's
// f32 tolerance of 1e-4 * (1 + |ref|). Three TF32 products hold it: each
// operand x splits into hi = tf32(x) and lo = tf32(x - hi), rounded to
// nearest with ties away from zero (cvt.rna's rounding), and
// a b = hi_a hi_b + hi_a lo_b + lo_a hi_b + O(2^-21 |a b|), the two small
// terms accumulated first. So a pair costs 3 * 6 * D (K2) or 3 * 8 * D (K3)
// tensor-core flops at 494.7 TFLOP/s dense TF32: at the BERT-base trained
// call [48,12,384,64] 0.198 and 0.264 ms against 0.102 ms of bytes, so the
// kernels are bound by operations (chip_smoke.py `bounds`, f32 rows).
//
// What the design does about it. The FMA kernels they retire gave a row 8
// threads and reduced every S and dP element with shuffles, owned 16 rows a
// block and staged 32-row tiles synchronously, so each (b, h)'s K and V (K2)
// or Q and dO (K3) were read from L2 by 24 blocks at the trained call.
// Here:
//   * mma.sync.m16n8k8 (tf32 in, f32 accumulate), three a product. Not
//     wgmma: with tf32 it takes both shared-memory operands K-major only,
//     and dQ = dS K, dK = dS^T Q and dV = P^T dO contract over the
//     sequence, so their B (K, Q, dO) is MN-major in the tiles: wgmma would
//     need transposed copies of them. mma.sync takes any layout, since each
//     thread loads its own fragments.
//   * A block owns 64 rows (K2: queries; K3: keys up to D = 64), 4 warps
//     of 16, so a (b, h)'s streamed tiles are read by 6 blocks at the
//     trained call.
//     Rows are padded by 4 floats (16 bytes). The A fragments of the
//     products over D (the block's own Q and dO in K2, K and V in K3) are
//     read with ldmatrix on the b16 view (thread `lane` gets row lane / 4,
//     f32 column lane % 4 of each 8 x 4 matrix) and split in registers,
//     once for all the n-blocks of a k-step.
//   * The streamed tiles (K2: K and V of 32 keys; K3: Q and dO of 32 q
//     rows) are split once a block: cp.async.cg copies a
//     tile in, the block splits it in place into a hi plane and a lo plane
//     (same pitch), and every warp then reads its B fragments of both,
//     K-major with ldmatrix (S, dP) or two rows at a time (dQ += dS K,
//     dV += P^T dO, dK += dS^T Q), without splitting again. (Split in the
//     warps, each element of K was split 8 times a block, and the splits
//     took most of the issue slots.) No bank conflicts at a pitch of D + 4.
//     The mask's bytes (K2) and lse and delta (K3) come with the tile, by
//     4-byte cp.async. The rounding is an integer add and mask, the same
//     bits as cvt.rna.tf32.f32 gives, which measured slower on the card.
//   * P and dS never leave registers. The m16n8k8 accumulator gives a
//     thread columns 2t and 2t + 1 of an 8-wide block, where the A fragment
//     wants t and t + 4; so the contraction index of dQ += dS K (and of
//     dV += P^T dO, dK += dS^T Q) is relabelled within each block of 8
//     (k = t -> 2t, k = t + 4 -> 2t + 1): A = {c0, c2, c1, c3} of the
//     accumulator, and B is gathered from rows 2t and 2t + 1 to match.
//   * Occupancy over overlap (TcCfg): f32 tiles are twice bf16's bytes, and
//     on the card more blocks an SM beat a second stage within a block. At
//     D <= 64 one stage, 69,632 bytes of tiles (3 blocks an SM if the
//     registers allow): the other blocks' arithmetic hides a block's copy.
//     K2 above 64 keeps two stages (one block an SM, 202,752 bytes). The
//     three TF32 products are issued pass by pass over independent
//     accumulators (every lo_a hi_b, then hi_a lo_b, then hi_a hi_b), so no
//     mma waits on the one before it.
//   * Long sums leave the accumulators. The tensor cores' f32 accumulation
//     truncates, so dQ, dK and dV summed in them over a long sequence
//     drift one way, by about 2^-23 of the running sum a step: where P is
//     near 1/2 (a row of 2 real keys) that passed the f32 tolerance at
//     L = 1024 on the card. Every kFlushRows = 256 rows of the sequence
//     each thread adds its partial sums into dq (dk, dv) in device memory
//     and starts again from zero.
//   * Registers: K2 holds dQ (D / 2 a thread) beside S and dP of a 32-key
//     tile (16 each); K3 up to D = 64 holds dK and dV (D) beside S^T and
//     dP^T of a 32-row q tile. Above 64 that and the flushes would pass
//     255, so two warps share 16 keys there, each computing their S^T and
//     dP^T and owning half of the n-blocks of dK and dV (12 * D flops a
//     pair, not 8 * D; 32 keys a block, 101,376 bytes, two blocks an SM).
//     ptxas reports no spill at any instantiation.
//   * Causal: K2 never loads kv tiles above its last row, K3 starts at the
//     first q tile whose last row sees its first key, and a warp whose rows
//     see nothing of a tile skips its arithmetic.
//   * Rows that see no key: their lse is EMPTY_LSE (-1e30), so exp gives
//     inf, but every pair of such a row is masked and takes P = 0 before
//     dS is formed: no inf reaches a split.
//   * Head dims 8 to 128 in steps of 8: the k-steps of the products over D
//     are 8 wide, so none reads a padding column; the n-blocks of dQ, dK
//     and dV are 8 wide. Each D is its own instantiation.
//   * Head dims 192 to 512 (flash_bwd_dq_f32tc_wide_kernel and
//     flash_bwd_dkv_f32tc_wide_kernel, unmasked, as the reference's
//     dispatch sends such calls). dQ over 16 rows would be D / 2 registers
//     a thread (256 at 512), dK and dV over 16 keys D, so D is split over
//     the warps that share 16 q rows (K2) or 16 keys (K3), as K1's f32
//     kernel splits it: each warp owns a slice of at most 128 dims, two
//     warps up to 256 and four above (WideCfg). Each warp computes the
//     partial S and dP (K3: S^T and dP^T) over its slice, writes them to
//     shared memory in fragment order, and after a named barrier of its
//     group adds all the group's partials in one order, slice 0 first:
//     with three or more, float addition is not associative, and so every
//     warp of a group holds S and dP, so P and dS, bit for bit. No product
//     is repeated (6 * D flops a visible pair in K2, 8 * D in K3, where
//     K3's kSplitD above costs 12 * D). Each warp then adds dS K (K2), or
//     P^T dO and dS^T Q (K3), over its own slice.
//     Shared memory holds the block's resident rows (K2: Q and dO of 64
//     or 32 q rows; K3: K and V of 32 keys) and one stage of the streamed
//     operands (K2: K and V of 16 or 32 keys; K3: Q and dO of 16 or 32 q
//     rows with their lse and delta). Tiles are raw: each warp splits the
//     fragments of its own slice in registers (K1's raw split), once a row
//     group, where hi and lo planes would double the tiles' bytes. The
//     stage's two operands are refilled in turns, as in K1's ring above
//     256: K2 takes dP from V first, so V's slot takes the next tile while
//     S, dS and dQ run, and K's while the next dP runs; K3 takes dP^T from
//     dO and adds P^T dO before dS^T Q, so dO's slot refills while dK
//     runs and Q's while the next dP^T runs. The copies are 1-D bulk
//     copies on mbarriers, one a row, issued by warp 0; two block barriers
//     a tile free the slots and the partials, beside the group's barrier.
//     On the card (NVIDIA H100 80GB HBM3) K3's slices of up to 128 dims
//     beat slices of 64 (D / 64 warps a slab) at every head dim, and at
//     192 and 256 two blocks of 4 warps an SM beat one of 8 for K3 (not
//     for K2); K2 with slices of 64 at 192 and 256 (16 warps a block)
//     lost.
//
// The device helpers (the tf32 split, mma.sync, ldmatrix, cp.async, the
// tile copy and split, the relabelled A fragments and the two products)
// are in flash_attn_f32tc.cuh, shared with K1's f32 kernel
// (flash_attn_fwd_f32tc.cu). Params, the launch, the argument checks, the
// head-dim dispatch and empty_rows_dv are this source's own (they came
// from flash_attn_bwd.cuh, retired with the bf16 mma.sync templates it
// held). Every bf16 call takes flash_attn_bwd_sm90.cu.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libzoo_flash_attn_bwd_f32tc.so \
//        flash_attn_bwd_f32tc.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attn_f32tc.cuh"

namespace {

constexpr int kTile = 64;        // Lq and Lk: multiples of it
constexpr int kThreads = 128;    // the f32 tensor-core kernels' block
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

__device__ __forceinline__ float to_f32(float x) { return x; }

// K3's share of the rows that see no key (the masked K3): e[c] = inv_lk * sum of dO[i][c] over the first n_empty rows,
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


constexpr int kFlushRows = 256;  // rows of the sequence a partial sum
                                 // takes in the accumulators

// Tiles by head dim, chosen on the card (NVIDIA H100 80GB HBM3): f32 tiles
// are twice bf16's bytes, so blocks an SM are scarce, and more of them beat
// double-buffering within a block.
template <int D>
struct TcCfg {
  // K2: keys a streamed tile, its stages, and the blocks an SM ptxas
  // budgets registers for (__launch_bounds__). Shared memory: Q and dO
  // (64 rows) and K and V with their lo planes (4 x kKv rows a stage),
  // rows of D + 4 floats: 69,632 bytes at D = 64 (3 blocks an SM if the
  // registers allow), 202,752 at D = 128 (one)
  static constexpr int kKv = 32;
  static constexpr int kKvStages = D <= 64 ? 1 : 2;
  static constexpr int kDqBlocks = D <= 64 ? 2 : 1;
  // K3: keys a block, q rows a streamed tile (also the q columns of S^T
  // and dP^T), one stage, two blocks an SM. Up to D = 64 a warp owns 16
  // keys and all of dK and dV (D registers a thread): 69,632 bytes of
  // tiles. Above 64, where dK and dV with the flushes would need more
  // than 255 registers, two warps share 16 keys, each owning half of the
  // n-blocks of dK and dV (both compute the keys' S^T and dP^T: 12 * D
  // flops a pair, not 8 * D), so a block owns 32 keys: 101,376 bytes at
  // D = 128
  static constexpr bool kSplitD = D > 64;
  static constexpr int kKeys = kSplitD ? 32 : 64;
  static constexpr int kQt = 32;
  static constexpr int kDkvBlocks = 2;
};

// K2: Q and dO, the K and V stages (hi and lo), delta, the stages' mask
// bytes
template <int D>
constexpr size_t dq_f32tc_smem_bytes() {
  using C = TcCfg<D>;
  return (2 * kTile + 4 * C::kKvStages * C::kKv) * (D + kTcPad)
             * sizeof(float)
         + kTile * sizeof(float) + C::kKvStages * C::kKv;
}

// K3: K and V of the block's keys, a Q and a dO tile (hi and lo), their
// lse and delta, the dV share of the rows that see no key, the first real
// key
template <int D>
constexpr size_t dkv_f32tc_smem_bytes() {
  using C = TcCfg<D>;
  return (2 * C::kKeys + 4 * C::kQt) * (D + kTcPad) * sizeof(float)
         + 2 * C::kQt * sizeof(float) + D * sizeof(float) + 16;
}

// a thread's accumulator fragments of 16 rows x NB n-blocks (the first
// `nb` of them; rows ra and rb of `out`, row stride sl) stored, or with
// `add` added to what is there; `e` (or null) adds one vector to every row
template <int NB>
__device__ __forceinline__ void store_rows(float* out, long long sl, int ra,
                                           int rb, int t4,
                                           const float (&c)[NB][4],
                                           bool add, const float* e,
                                           int nb = NB) {
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    if (n >= nb) break;
    const int col = n * 8 + t4 * 2;
    float2* pa = reinterpret_cast<float2*>(out + ra * sl + col);
    float2* pb = reinterpret_cast<float2*>(out + rb * sl + col);
    float2 xa = make_float2(c[n][0], c[n][1]);
    float2 xb = make_float2(c[n][2], c[n][3]);
    if (e != nullptr) {
      xa.x += e[col];
      xa.y += e[col + 1];
      xb.x += e[col];
      xb.y += e[col + 1];
    }
    if (add) {
      const float2 oa = *pa, ob = *pb;
      xa.x += oa.x;
      xa.y += oa.y;
      xb.x += ob.x;
      xb.y += ob.y;
    }
    *pa = xa;
    *pb = xb;
  }
}

// ----------------------------------------------------------------- K2 --
template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads, TcCfg<D>::kDqBlocks)
flash_bwd_dq_f32tc_kernel(const Params p) {
  static_assert(D % 8 == 0 && D <= 128, "head_dim: a multiple of 8, <= 128");
  constexpr int LD = D + kTcPad;
  constexpr int KV = TcCfg<D>::kKv;          // keys a tile
  constexpr int ST = TcCfg<D>::kKvStages;
  constexpr int kN = KV / 8;                 // n-blocks of S and dP
  static_assert(kTile % KV == 0 && kN % 2 == 0, "kv tiles");
  extern __shared__ __align__(16) unsigned char zoo_smem[];
  float* sQ = reinterpret_cast<float*>(zoo_smem);
  float* sDO = sQ + kTile * LD;
  // stage s: K (hi after the split), its lo, V, its lo, KV rows each
  float* sKV = sDO + kTile * LD;
  float* sDelta = sKV + 4 * ST * KV * LD;
  uint8_t* sM = reinterpret_cast<uint8_t*>(sDelta + kTile);  // ST x KV

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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hh * p.v_sh;
  const float* o = static_cast<const float*>(p.o) + b * p.o_sb + hh * p.o_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + hh * p.dq_sh;
  const uint8_t* mrow = kMask ? p.mask + b * p.mask_sb : nullptr;

  int n_tiles = p.lk / KV;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kTile - 1 + offset) / KV + 1);

  // tile kt into stage s, and one copy group for it (an empty one past
  // the last tile, so that every iteration waits for the same count)
  auto load_kv = [&](int kt, int s) {
    if (kt < n_tiles) {
      const long long r0 = static_cast<long long>(kt) * KV;
      float* st = sKV + 4 * s * KV * LD;
      copy_tile<D, LD>(st, k + r0 * p.k_sl, p.k_sl, KV, tid);
      copy_tile<D, LD>(st + 2 * KV * LD, v + r0 * p.v_sl, p.v_sl, KV, tid);
      if (kMask && tid < KV / 4) {
        cp_async4(sM + s * KV + 4 * tid, mrow + r0 + 4 * tid);
      }
    }
    cp_async_commit();
  };
  copy_tile<D, LD>(sQ, q + q0 * p.q_sl, p.q_sl, kTile, tid);
  copy_tile<D, LD>(sDO, dout + q0 * p.do_sl, p.do_sl, kTile, tid);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < ST; ++s) load_kv(s, s);
  cp_async_wait<ST>();  // Q and dO
  __syncthreads();
  {
    // delta = rowsum(dO * O) in f32: two threads a row, taking its
    // 4-float chunks in turn
    const int r = tid >> 1;
    const int half = tid & 1;
    const float* orow = o + (q0 + r) * p.o_sl;
    const float* drow = sDO + r * LD;
    float acc = 0.f;
#pragma unroll
    for (int c = half * 4; c < D; c += 8) {
      const float4 a = *reinterpret_cast<const float4*>(orow + c);
      const float4 e = *reinterpret_cast<const float4*>(drow + c);
      acc = fmaf(a.x, e.x, acc);
      acc = fmaf(a.y, e.y, acc);
      acc = fmaf(a.z, e.z, acc);
      acc = fmaf(a.w, e.w, acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      sDelta[r] = acc;
      p.delta[static_cast<long long>(bh) * p.lq + q0 + r] = acc;
    }
  }

  const int row0 = warp * 16;          // this warp's first row in the block
  const int ra = row0 + g;             // a thread's two rows
  const int rb = ra + 8;
  const long long at = static_cast<long long>(bh) * p.lq + q0;
  const float lse_a = p.lse[at + ra] * kLog2e;
  const float lse_b = p.lse[at + rb] * kLog2e;
  const float* qa = sQ + row0 * LD + a_frag_off<LD>(lane);
  const float* da = sDO + row0 * LD + a_frag_off<LD>(lane);
  const int boff = b_frag_off<LD>(lane);
  __syncthreads();  // delta
  const float del_a = sDelta[ra], del_b = sDelta[rb];

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  bool flushed = false;  // dq holds a partial sum
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % ST;
    cp_async_wait<ST - 1>();
    __syncthreads();  // tile kt (and its mask bytes) in stage s
    float* tK = sKV + 4 * s * KV * LD;
    float* tKl = tK + KV * LD;
    float* tV = tKl + KV * LD;
    float* tVl = tV + KV * LD;
    split_tile<D, LD>(tK, tKl, KV, tid);
    split_tile<D, LD>(tV, tVl, KV, tid);
    const uint8_t* tM = sM + s * KV;
    __syncthreads();  // split

    // a warp whose rows all lie above this tile has nothing to add
    if (!(p.causal && q0 + row0 + 15 + offset < kt * KV)) {
      // S = Q K^T and dP = dO V^T for 16 rows x KV keys
      float sc[kN][4], dp[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
      mma_over_d<D, kN, LD>(sc, dp, qa, da, tK + boff, tKl + boff,
                            tV + boff, tVl + boff);

      // dS = P * (dP - delta) * scale, P = exp(scale * S - lse); masked
      // pairs (and so every pair of a row that sees no key) take P = 0
#pragma unroll
      for (int n = 0; n < kN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          const int col = n * 8 + t4 * 2 + (e & 1);  // key within the tile
          float pr = exp2f(sc[n][e] * p.scale_log2 - (top ? lse_a : lse_b));
          if (p.causal && kt * KV + col > q0 + (top ? ra : rb) + offset) {
            pr = 0.f;
          }
          if (kMask && tM[col] == 0) pr = 0.f;
          sc[n][e] = pr * (dp[n][e] - (top ? del_a : del_b)) * p.scale;
        }
      }

      // dQ += dS K, a block of 8 keys at a time
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t ahi[4], alo[4];
        acc_as_a(sc[j], ahi, alo);
        const int at = (j * 8 + 2 * t4) * LD + g;
        mma_rows<D / 8, LD>(acc, ahi, alo, tK + at, tKl + at);
      }
    }
    __syncthreads();  // every warp is done with stage s
    load_kv(kt + ST, s);
    // every kFlushRows keys dQ leaves the accumulators for dq in device
    // memory, as K3's dK and dV do (the truncating accumulation)
    if ((kt + 1) % (kFlushRows / KV) == 0 && kt + 1 < n_tiles) {
      store_rows<D / 8>(dq, p.dq_sl, q0 + ra, q0 + rb, t4, acc, flushed,
                        nullptr);
      flushed = true;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      }
    }
  }

  store_rows<D / 8>(dq, p.dq_sl, q0 + ra, q0 + rb, t4, acc, flushed,
                    nullptr);
}

// ----------------------------------------------------------------- K3 --
template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads, TcCfg<D>::kDkvBlocks)
flash_bwd_dkv_f32tc_kernel(const Params p) {
  static_assert(D % 8 == 0 && D <= 128, "head_dim: a multiple of 8, <= 128");
  constexpr int LD = D + kTcPad;
  constexpr int KB = TcCfg<D>::kKeys;    // keys a block
  constexpr int QT = TcCfg<D>::kQt;      // q rows a tile, columns of S^T
  constexpr int kN = QT / 8;
  constexpr bool kSplitD = TcCfg<D>::kSplitD;
  // n-blocks of dK and dV a warp owns: all, or the first or second half
  constexpr int kNbAll = D / 8;
  constexpr int kNbOwn = kSplitD ? (kNbAll + 1) / 2 : kNbAll;
  static_assert(kTile % QT == 0 && kN % 2 == 0 && 2 * QT <= kThreads
                && KB == (kSplitD ? 2 : 4) * 16, "tiles");
  extern __shared__ __align__(16) unsigned char zoo_smem[];
  float* sK = reinterpret_cast<float*>(zoo_smem);
  float* sV = sK + KB * LD;
  // Q (hi after the split), its lo, dO, its lo, QT rows each
  float* sQ = sV + KB * LD;
  float* sQl = sQ + QT * LD;
  float* sDO = sQl + QT * LD;
  float* sDOl = sDO + QT * LD;
  float* sLse = sDOl + QT * LD;          // QT, then delta's QT
  float* sDelta = sLse + QT;
  float* sE = sDelta + QT;               // D: dV share of rows without a key
  int* sFirst = reinterpret_cast<int*>(sE + D);

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = kt * KB;
  const int offset = p.lk - p.lq;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hh * p.v_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.lq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.lq;
  const uint8_t* mrow = kMask ? p.mask + b * p.mask_sb : nullptr;

  // the first q tile whose last row sees this block's first key
  int first = 0;
  if (p.causal) {
    const int x = k0 - offset - (QT - 1);
    first = x > 0 ? (x + QT - 1) / QT : 0;
  }
  const int n_tiles = p.lq / QT;

  // start copying q tile qt with its lse and delta (one copy group)
  auto load_q = [&](int qt) {
    const long long r0 = static_cast<long long>(qt) * QT;
    copy_tile<D, LD>(sQ, q + r0 * p.q_sl, p.q_sl, QT, tid);
    copy_tile<D, LD>(sDO, dout + r0 * p.do_sl, p.do_sl, QT, tid);
    if (tid < 2 * QT) {
      cp_async4(sLse + tid, tid < QT ? lse + r0 + tid : delta + r0 + tid - QT);
    }
    cp_async_commit();
  };

  copy_tile<D, LD>(sK, k + k0 * p.k_sl, p.k_sl, KB, tid);
  copy_tile<D, LD>(sV, v + k0 * p.v_sl, p.v_sl, KB, tid);
  load_q(first);
  if (kMask) {
    // P^T dO for the rows that see no key (P = 1/Lk)
    empty_rows_dv<D>(sE, sFirst, mrow, dout, p.do_sl, p.lq, p.lk, p.causal,
                     1.f / p.lk, tid);
  }

  // this warp's 16 keys, and the n-blocks of dK and dV it owns: the
  // warps of a pair (split D) take the first kNbOwn and the rest
  const int row0 = (kSplitD ? warp >> 1 : warp) * 16;
  const int nb0 = kSplitD ? (warp & 1) * kNbOwn : 0;
  const int nb = kSplitD && (warp & 1) ? kNbAll - kNbOwn : kNbOwn;
  const int ka = k0 + row0 + g;        // the two keys a thread holds
  const int kb = ka + 8;
  const bool real_a = !kMask || mrow[ka] != 0;
  const bool real_b = !kMask || mrow[kb] != 0;
  const float* kf = sK + row0 * LD + a_frag_off<LD>(lane);
  const float* vf = sV + row0 * LD + a_frag_off<LD>(lane);
  const int boff = b_frag_off<LD>(lane);
  float* dk = static_cast<float*>(p.dk) + b * p.dk_sb + hh * p.dk_sh
              + nb0 * 8;
  float* dv = static_cast<float*>(p.dv) + b * p.dv_sb + hh * p.dv_sh
              + nb0 * 8;

  float acc_k[kNbOwn][4], acc_v[kNbOwn][4];
#pragma unroll
  for (int n = 0; n < kNbOwn; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }

  bool flushed = false;  // dk and dv hold a partial sum
  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * QT;
    cp_async_wait<0>();
    __syncthreads();  // q tile qt (and K, V the first time)
    split_tile<D, LD>(sQ, sQl, QT, tid);
    split_tile<D, LD>(sDO, sDOl, QT, tid);
    __syncthreads();  // split

    // nothing to add where the warp's first key lies after every view
    if (!(p.causal && k0 + row0 > q0 + QT - 1 + offset)) {
      // S^T = K Q^T and dP^T = V dO^T for 16 keys x QT queries
      float sc[kN][4], dp[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
      mma_over_d<D, kN, LD>(sc, dp, kf, vf, sQ + boff, sQl + boff,
                            sDO + boff, sDOl + boff);

      // P^T and dS^T; the columns are queries
#pragma unroll
      for (int n = 0; n < kN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          const int qc = n * 8 + t4 * 2 + (e & 1);
          float pr = exp2f(sc[n][e] * p.scale_log2 - sLse[qc] * kLog2e);
          if (p.causal && (top ? ka : kb) > q0 + qc + offset) pr = 0.f;
          if (kMask && !(top ? real_a : real_b)) pr = 0.f;
          sc[n][e] = pr;
          dp[n][e] = pr * (dp[n][e] - sDelta[qc]) * p.scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q over the owned n-blocks, a block of
      // 8 queries at a time
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int at = (j * 8 + 2 * t4) * LD + g + nb0 * 8;
        uint32_t ahi[4], alo[4];
        acc_as_a(sc[j], ahi, alo);
        mma_rows<kNbOwn, LD>(acc_v, ahi, alo, sDO + at, sDOl + at, nb);
        acc_as_a(dp[j], ahi, alo);
        mma_rows<kNbOwn, LD>(acc_k, ahi, alo, sQ + at, sQl + at, nb);
      }
    }
    __syncthreads();  // every warp is done with the tile
    if (qt + 1 < n_tiles) {
      load_q(qt + 1);
      // every kFlushRows q rows dK and dV leave the accumulators for dk
      // and dv in device memory (each thread adds to its own elements):
      // the tensor cores' accumulation truncates, so a sum run in them
      // over a long sequence drifts one way, about 2^-23 of the running
      // sum a step (past the f32 tolerance at Lq = 1024 where P is near
      // 1/2)
      if ((qt - first + 1) % (kFlushRows / QT) == 0) {
        store_rows<kNbOwn>(dk, p.dk_sl, ka, kb, t4, acc_k, flushed,
                           nullptr, nb);
        store_rows<kNbOwn>(dv, p.dv_sl, ka, kb, t4, acc_v, flushed,
                           nullptr, nb);
        flushed = true;
#pragma unroll
        for (int n = 0; n < kNbOwn; ++n) {
          acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
          acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
        }
      }
    }
  }

  store_rows<kNbOwn>(dk, p.dk_sl, ka, kb, t4, acc_k, flushed, nullptr, nb);
  store_rows<kNbOwn>(dv, p.dv_sl, ka, kb, t4, acc_v, flushed,
                     kMask ? sE + nb0 * 8 : nullptr, nb);
}

// ------------------------------------------------ K2 and K3 above 128 --
// Tiles by head dim above 128, chosen on the card (NVIDIA H100 80GB HBM3).
// Both kernels split D over the warps that share 16 rows (K2: q rows; K3:
// keys) and stream their tiles through one stage whose two operands are
// refilled in turns by 1-D bulk copies; one block an SM.
template <int D>
struct WideCfg {
  // warps that share 16 rows (K2: q rows; K3: keys), each owning D / kSplit
  // dims (at most 128: dQ is at most 64 registers a thread, dK and dV 128)
  static constexpr int kSplit = D <= 256 ? 2 : 4;
  // K2: q rows a block; keys a tile (16 where 32 would pass the shared
  // memory)
  static constexpr int kDqRows = D <= 256 ? 64 : 32;
  static constexpr int kKv = D == 192 || D == 320 || D == 384 ? 32 : 16;
  static constexpr int kDqThreads = kDqRows / 16 * kSplit * 32;
  // K3: keys a block; q rows a tile; blocks an SM
  static constexpr int kKeys = 32;
  static constexpr int kQt = D == 320 || D == 384 ? 32 : 16;
  static constexpr int kDkvBlocks = D <= 256 ? 2 : 1;
  static constexpr int kDkvThreads = kKeys / 16 * kSplit * 32;
};

// shared memory of an SM (228 KB), and what a block takes besides its
// dynamic shared memory: 1 KB CUDA reserves for each block, and the
// mbarriers
constexpr size_t kSmemPerSm = 233472;
constexpr size_t kSmemPerBlock = 1024 + 64;

// K2 above 128: Q and dO, K and V (one stage), the partial S and dP,
// delta
template <int D>
__host__ __device__ constexpr size_t dq_wide_smem_bytes() {
  using C = WideCfg<D>;
  return (2 * C::kDqRows + 2 * C::kKv) * (D + kTcPad) * sizeof(float)
         + 2 * C::kDqRows * C::kSplit * C::kKv * sizeof(float)
         + C::kDqRows * sizeof(float);
}

// K3 above 128: K and V of the block's keys, a Q and a dO tile (one
// stage), the partial S^T and dP^T, the tile's lse and delta
template <int D>
__host__ __device__ constexpr size_t dkv_wide_smem_bytes() {
  using C = WideCfg<D>;
  return (2 * C::kKeys + 2 * C::kQt) * (D + kTcPad) * sizeof(float)
         + 2 * C::kKeys * C::kSplit * C::kQt * sizeof(float)
         + 2 * C::kQt * sizeof(float);
}

// warp 0's lanes start copying `n` rows of D floats (row stride `stride`)
// into a tile of row pitch LD, one 1-D bulk copy a row, counted by the
// mbarrier `bar` (whose bytes lane 0 has announced)
template <int D, int LD>
__device__ __forceinline__ void bulk_rows(float* t, const float* src,
                                          long long stride, int n,
                                          uint32_t bar, int lane) {
  for (int r = lane; r < n; r += 32) {
    bulk_load(smem_addr(t + r * LD), src + r * stride, D * sizeof(float),
              bar);
  }
}

// three mbarriers, each awaiting one arrival (and its bytes)
__device__ __forceinline__ void init_bars(uint32_t bar0, int tid) {
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    mbar_init(bar0 + 16, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
}

// each warp's partial fragments of S and dP (or S^T and dP^T) into its
// slots `mine` of the two buffers ([row group][slice][n-block][lane])
template <int NB>
__device__ __forceinline__ void put_partials(float4* s_buf, float4* p_buf,
                                             int mine, const float (&s)[NB][4],
                                             const float (&p)[NB][4]) {
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    s_buf[mine + n * 32] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    p_buf[mine + n * 32] = make_float4(p[n][0], p[n][1], p[n][2], p[n][3]);
  }
}

// the sum over a group's N warps of their partial fragments of one
// n-block, slice 0 first in every warp (`at0` is slice 0's, `stride` the
// distance between slices): unrolled, so that every load is in flight
// before the first add
template <int N>
__device__ __forceinline__ void sum_slices(float (&x)[4], const float4* t,
                                           int at0, int stride) {
  float4 a = t[at0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
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

template <int D>
__global__ void __launch_bounds__(WideCfg<D>::kDqThreads, 1)
flash_bwd_dq_f32tc_wide_kernel(const Params p) {
  using C = WideCfg<D>;
  constexpr int LD = D + kTcPad;
  constexpr int NT = C::kDqThreads;
  constexpr int ROWS = C::kDqRows;
  constexpr int KV = C::kKv;
  constexpr int kN = KV / 8;             // n-blocks of S and dP
  constexpr int kSplit = C::kSplit;
  constexpr int DW = D / kSplit;         // dims of D a warp owns
  constexpr int kNb = DW / 8;            // n-blocks of dQ a warp owns
  constexpr int kParts = ROWS / 16 * kSplit * kN * 32;  // float4s a buffer
  static_assert(D % 64 == 0 && D > 128 && D <= 512 && DW % 8 == 0
                && DW <= 128 && kTile % ROWS == 0 && kN % 2 == 0
                && kFlushRows % KV == 0
                && dq_wide_smem_bytes<D>() + kSmemPerBlock <= kSmemPerSm,
                "tiles");
  extern __shared__ __align__(16) unsigned char zoo_smem[];
  float* sQ = reinterpret_cast<float*>(zoo_smem);
  float* sDO = sQ + ROWS * LD;
  float* sK = sDO + ROWS * LD;
  float* sV = sK + KV * LD;
  float4* sS = reinterpret_cast<float4*>(sV + KV * LD);
  float4* sP = sS + kParts;
  float* sDelta = reinterpret_cast<float*>(sP + kParts);
  __shared__ __align__(8) uint64_t sBar[3];  // Q and dO, K, V landed

  // causal: the blocks of the last q rows walk the most tiles; start them
  // first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rg = warp / kSplit;          // row group of 16 q rows
  const int sl = warp - rg * kSplit;     // slice of D
  const int q0 = qt * ROWS;
  const int offset = p.lk - p.lq;
  const int row0 = rg * 16;              // the row group's first row
  const int ra = row0 + g;               // a thread's two rows in the block
  const int rb = ra + 8;
  const int col0 = sl * DW;              // the slice's first dim

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hh * p.v_sh;
  const float* o = static_cast<const float*>(p.o) + b * p.o_sb + hh * p.o_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  float* dq = static_cast<float*>(p.dq) + b * p.dq_sb + hh * p.dq_sh + col0;

  int n_tiles = p.lk / KV;
  if (p.causal) n_tiles = min(n_tiles, (q0 + ROWS - 1 + offset) / KV + 1);

  const uint32_t barQ = smem_addr(&sBar[0]);
  const uint32_t barK = barQ + 8, barV = barQ + 16;
  constexpr uint32_t kTileBytes = KV * D * sizeof(float);
  init_bars(barQ, tid);
  if (warp == 0) {
    if (lane == 0) {
      mbar_expect_tx(barQ, 2 * ROWS * D * sizeof(float));
      mbar_expect_tx(barV, kTileBytes);
      mbar_expect_tx(barK, kTileBytes);
    }
    __syncwarp();
    bulk_rows<D, LD>(sQ, q + q0 * p.q_sl, p.q_sl, ROWS, barQ, lane);
    bulk_rows<D, LD>(sDO, dout + q0 * p.do_sl, p.do_sl, ROWS, barQ, lane);
    bulk_rows<D, LD>(sV, v, p.v_sl, KV, barV, lane);
    bulk_rows<D, LD>(sK, k, p.k_sl, KV, barK, lane);
  }
  // the next tile's V or K into its slot (warp 0)
  auto refill = [&](float* t, const float* src, long long stride,
                    uint32_t bar) {
    if (warp == 0) {
      if (lane == 0) mbar_expect_tx(bar, kTileBytes);
      __syncwarp();
      bulk_rows<D, LD>(t, src, stride, KV, bar, lane);
    }
  };

  mbar_wait(barQ, 0);
  // delta = rowsum(dO * O) over the whole D in f32: a warp a row at a
  // time, each lane its 4-float chunks 32 chunks apart, summed by shuffles
  for (int r = warp; r < ROWS; r += NT / 32) {
    const float* orow = o + (q0 + r) * p.o_sl;
    const float* drow = sDO + r * LD;
    float acc = 0.f;
    for (int c = lane * 4; c < D; c += 128) {
      const float4 a = *reinterpret_cast<const float4*>(orow + c);
      const float4 e = *reinterpret_cast<const float4*>(drow + c);
      acc = fmaf(a.x, e.x, acc);
      acc = fmaf(a.y, e.y, acc);
      acc = fmaf(a.z, e.z, acc);
      acc = fmaf(a.w, e.w, acc);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, m);
    }
    if (lane == 0) {
      sDelta[r] = acc;
      p.delta[static_cast<long long>(bh) * p.lq + q0 + r] = acc;
    }
  }
  const long long at = static_cast<long long>(bh) * p.lq + q0;
  const float lse_a = p.lse[at + ra] * kLog2e;
  const float lse_b = p.lse[at + rb] * kLog2e;
  const float* qa = sQ + row0 * LD + a_frag_off<LD>(lane) + col0;
  const float* da = sDO + row0 * LD + a_frag_off<LD>(lane) + col0;
  const int boff = b_frag_off<LD>(lane) + col0;
  // B of dQ += dS K: rows 2t and 2t + 1 of each block of 8 keys, column g
  const int koff = 2 * t4 * LD + g + col0;
  const int mine = (rg * kSplit + sl) * kN * 32 + lane;  // partials' slot
  const int group = rg * kSplit * kN * 32 + lane;        // slice 0's
  __syncthreads();  // delta
  const float del_a = sDelta[ra], del_b = sDelta[rb];

  float acc[kNb][4];
#pragma unroll
  for (int n = 0; n < kNb; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  bool flushed = false;  // dq holds a partial sum
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * KV;
    // a row group whose rows all lie above this tile has nothing to add
    // (the same for every warp of the group)
    const bool active = !(p.causal && q0 + row0 + 15 + offset < k0);
    // dP = dO V^T for 16 rows x KV keys over this warp's slice of D
    float dp[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    mbar_wait(barV, kt & 1);
    if (active) mma_over_d1<DW / 8, kN, LD, true>(dp, da, sV + boff);
    // every warp is done with the V of tile kt: its slot takes tile
    // kt + 1's while S, dS and dQ run
    __syncthreads();
    if (kt + 1 < n_tiles) {
      refill(sV, v + static_cast<long long>(k0 + KV) * p.v_sl, p.v_sl, barV);
    }
    mbar_wait(barK, kt & 1);
    if (active) {
      // S = Q K^T over the slice; then the group's partials of S and dP
      // summed. Three or more terms: float addition is not associative,
      // so every warp of the group adds them in one order, slice 0
      // first, and all of them hold S and dP, so P and dS, bit for bit
      float sc[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      }
      mma_over_d1<DW / 8, kN, LD, true>(sc, qa, sK + boff);
      put_partials<kN>(sS, sP, mine, sc, dp);
      named_sync(1 + rg, 32 * kSplit);

      // dS = P * (dP - delta) * scale, P = exp(scale * S - lse); the
      // causal mask where the tile crosses the row group's diagonal
      const bool diag = p.causal && k0 + KV - 1 > q0 + row0 + offset;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        float x[4];
        sum_slices<kSplit>(sc[n], sS, group + n * 32, kN * 32);
        sum_slices<kSplit>(x, sP, group + n * 32, kN * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          const int col = n * 8 + t4 * 2 + (e & 1);  // key within the tile
          float pr = fast_exp2(sc[n][e] * p.scale_log2
                               - (top ? lse_a : lse_b));
          if (diag && k0 + col > q0 + (top ? ra : rb) + offset) pr = 0.f;
          sc[n][e] = pr * (x[e] - (top ? del_a : del_b)) * p.scale;
        }
      }

      // dQ += dS K over this warp's n-blocks, a block of 8 keys at a time
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t ahi[4], alo[4];
        acc_as_a<true>(sc[j], ahi, alo);
        mma_rows_split<kNb, LD, 4, true>(acc, ahi, alo,
                                         sK + j * 8 * LD + koff);
      }
    }
    // every warp is done with the K of tile kt and with the partials
    __syncthreads();
    if (kt + 1 < n_tiles) {
      refill(sK, k + static_cast<long long>(k0 + KV) * p.k_sl, p.k_sl, barK);
    }
    // every kFlushRows keys dQ leaves the accumulators (the truncating
    // accumulation)
    if ((kt + 1) % (kFlushRows / KV) == 0 && kt + 1 < n_tiles) {
      store_rows<kNb>(dq, p.dq_sl, q0 + ra, q0 + rb, t4, acc, flushed,
                      nullptr);
      flushed = true;
#pragma unroll
      for (int n = 0; n < kNb; ++n) {
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      }
    }
  }

  store_rows<kNb>(dq, p.dq_sl, q0 + ra, q0 + rb, t4, acc, flushed, nullptr);
}

template <int D>
__global__ void __launch_bounds__(WideCfg<D>::kDkvThreads,
                                  WideCfg<D>::kDkvBlocks)
flash_bwd_dkv_f32tc_wide_kernel(const Params p) {
  using C = WideCfg<D>;
  constexpr int LD = D + kTcPad;
  constexpr int KB = C::kKeys;           // keys a block
  constexpr int QT = C::kQt;             // q rows a tile, columns of S^T
  constexpr int kN = QT / 8;
  constexpr int kSplit = C::kSplit;
  constexpr int DW = D / kSplit;         // dims of D a warp owns
  constexpr int kNb = DW / 8;            // n-blocks of dK and dV it owns
  constexpr int kParts = KB / 16 * kSplit * kN * 32;  // float4s a buffer
  static_assert(D % 64 == 0 && D > 128 && D <= 512 && DW % 8 == 0
                && kTile % KB == 0 && kTile % QT == 0 && kN % 2 == 0
                && kFlushRows % QT == 0
                && (dkv_wide_smem_bytes<D>() + kSmemPerBlock) * C::kDkvBlocks
                       <= kSmemPerSm, "tiles");
  extern __shared__ __align__(16) unsigned char zoo_smem[];
  float* sK = reinterpret_cast<float*>(zoo_smem);
  float* sV = sK + KB * LD;
  float* sQ = sV + KB * LD;
  float* sDO = sQ + QT * LD;
  float4* sS = reinterpret_cast<float4*>(sDO + QT * LD);
  float4* sP = sS + kParts;
  float* sLse = reinterpret_cast<float*>(sP + kParts);  // QT, then delta's
  float* sDelta = sLse + QT;
  __shared__ __align__(8) uint64_t sBar[3];  // K and V, Q (lse, delta), dO

  const int kt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int slab = warp / kSplit;        // 16 keys
  const int sl = warp - slab * kSplit;   // slice of D
  const int k0 = kt * KB;
  const int offset = p.lk - p.lq;
  const int row0 = slab * 16;            // the slab's first key in the block
  const int ka = k0 + row0 + g;          // the two keys a thread holds
  const int kb = ka + 8;
  const int col0 = sl * DW;              // the slice's first dim

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hh * p.v_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.do_sb + hh * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.lq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.lq;
  float* dk = static_cast<float*>(p.dk) + b * p.dk_sb + hh * p.dk_sh + col0;
  float* dv = static_cast<float*>(p.dv) + b * p.dv_sb + hh * p.dv_sh + col0;

  // the first q tile whose last row sees this block's first key
  int first = 0;
  if (p.causal) {
    const int x = k0 - offset - (QT - 1);
    first = x > 0 ? (x + QT - 1) / QT : 0;
  }
  const int n_tiles = p.lq / QT;

  const uint32_t barKV = smem_addr(&sBar[0]);
  const uint32_t barQ = barKV + 8, barDO = barKV + 16;
  constexpr uint32_t kTileBytes = QT * D * sizeof(float);
  init_bars(barKV, tid);
  // q tile qt's Q with its lse and delta, or its dO, into its slot (warp 0)
  auto load_q = [&](int qt) {
    if (warp == 0) {
      const long long r0 = static_cast<long long>(qt) * QT;
      if (lane == 0) {
        mbar_expect_tx(barQ, kTileBytes + 2 * QT * sizeof(float));
        bulk_load(smem_addr(sLse), lse + r0, QT * sizeof(float), barQ);
        bulk_load(smem_addr(sDelta), delta + r0, QT * sizeof(float), barQ);
      }
      __syncwarp();
      bulk_rows<D, LD>(sQ, q + r0 * p.q_sl, p.q_sl, QT, barQ, lane);
    }
  };
  auto load_do = [&](int qt) {
    if (warp == 0) {
      if (lane == 0) mbar_expect_tx(barDO, kTileBytes);
      __syncwarp();
      bulk_rows<D, LD>(sDO, dout + static_cast<long long>(qt) * QT * p.do_sl,
                       p.do_sl, QT, barDO, lane);
    }
  };
  if (warp == 0) {
    if (lane == 0) mbar_expect_tx(barKV, 2 * KB * D * sizeof(float));
    __syncwarp();
    bulk_rows<D, LD>(sK, k + k0 * p.k_sl, p.k_sl, KB, barKV, lane);
    bulk_rows<D, LD>(sV, v + k0 * p.v_sl, p.v_sl, KB, barKV, lane);
  }
  load_do(first);
  load_q(first);

  const float* kf = sK + row0 * LD + a_frag_off<LD>(lane) + col0;
  const float* vf = sV + row0 * LD + a_frag_off<LD>(lane) + col0;
  const int boff = b_frag_off<LD>(lane) + col0;
  // B of dV += P^T dO and dK += dS^T Q: rows 2t and 2t + 1 of each block
  // of 8 q rows, column g
  const int roff = 2 * t4 * LD + g + col0;
  const int mine = (slab * kSplit + sl) * kN * 32 + lane;  // partials' slot
  const int group = slab * kSplit * kN * 32 + lane;        // slice 0's

  float acc_k[kNb][4], acc_v[kNb][4];
#pragma unroll
  for (int n = 0; n < kNb; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }
  mbar_wait(barKV, 0);

  bool flushed = false;  // dk and dv hold a partial sum
  for (int qt = first; qt < n_tiles; ++qt) {
    const int i = qt - first;            // tiles walked before this one
    const int q0 = qt * QT;
    // nothing to add where the slab's first key lies after every view (the
    // same for every warp of the slab)
    const bool active = !(p.causal && k0 + row0 > q0 + QT - 1 + offset);
    // dP^T = V dO^T for 16 keys x QT queries over this warp's slice
    float dp[kN][4], sc[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    }
    mbar_wait(barDO, i & 1);
    if (active) mma_over_d1<DW / 8, kN, LD, true>(dp, vf, sDO + boff);
    mbar_wait(barQ, i & 1);
    if (active) {
      // S^T = K Q^T over the slice; then the slab's partials of S^T and
      // dP^T summed in one order, slice 0 first (as in K2)
      mma_over_d1<DW / 8, kN, LD, true>(sc, kf, sQ + boff);
      put_partials<kN>(sS, sP, mine, sc, dp);
      named_sync(1 + slab, 32 * kSplit);

      // P^T and dS^T; the columns are queries. The causal mask where the
      // tile crosses the slab's diagonal
      const bool diag = p.causal && k0 + row0 + 15 > q0 + offset;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        sum_slices<kSplit>(sc[n], sS, group + n * 32, kN * 32);
        sum_slices<kSplit>(dp[n], sP, group + n * 32, kN * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool top = e < 2;
          const int qc = n * 8 + t4 * 2 + (e & 1);
          float pr = fast_exp2(sc[n][e] * p.scale_log2 - sLse[qc] * kLog2e);
          if (diag && (top ? ka : kb) > q0 + qc + offset) pr = 0.f;
          sc[n][e] = pr;
          dp[n][e] = pr * (dp[n][e] - sDelta[qc]) * p.scale;
        }
      }

      // dV += P^T dO over this warp's n-blocks, a block of 8 queries at a
      // time
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t ahi[4], alo[4];
        acc_as_a<true>(sc[j], ahi, alo);
        mma_rows_split<kNb, LD, 4, true>(acc_v, ahi, alo,
                                         sDO + j * 8 * LD + roff);
      }
    }
    // every warp is done with the dO of tile qt: its slot takes tile
    // qt + 1's while dK runs
    __syncthreads();
    if (qt + 1 < n_tiles) load_do(qt + 1);
    if (active) {
      // dK += dS^T Q
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        uint32_t ahi[4], alo[4];
        acc_as_a<true>(dp[j], ahi, alo);
        mma_rows_split<kNb, LD, 4, true>(acc_k, ahi, alo,
                                         sQ + j * 8 * LD + roff);
      }
    }
    // every warp is done with the Q of tile qt, its lse and delta, and
    // the partials
    __syncthreads();
    if (qt + 1 < n_tiles) {
      load_q(qt + 1);
      // every kFlushRows q rows dK and dV leave the accumulators
      if ((i + 1) % (kFlushRows / QT) == 0) {
        store_rows<kNb>(dk, p.dk_sl, ka, kb, t4, acc_k, flushed, nullptr);
        store_rows<kNb>(dv, p.dv_sl, ka, kb, t4, acc_v, flushed, nullptr);
        flushed = true;
#pragma unroll
        for (int n = 0; n < kNb; ++n) {
          acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
          acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
        }
      }
    }
  }

  store_rows<kNb>(dk, p.dk_sl, ka, kb, t4, acc_k, flushed, nullptr);
  store_rows<kNb>(dv, p.dv_sl, ka, kb, t4, acc_v, flushed, nullptr);
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
// up to 128, and 192, 256, 320, 384, 448 and 512; 1004 for any other d
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

// K2 in f32 at a head dim up to 128 (a multiple of 8; with or without a
// mask) or at 192, 256, 320, 384, 448 and 512 (without): q, k, v, o, dout
// and dq are [B, H, L, D] with element strides (batch, head, seq; the last
// dimension contiguous); mask is [B, Lk] bytes (nonzero = real key) with
// batch stride mask_sb, or null for none. Writes dq and delta ([B*H, Lq]
// f32, contiguous). Arguments as zoo_flash_attn_bwd_dq_sm90's
// (flash_attn_bwd_sm90.cu). Returns a cudaError_t (0 = launched); 1000 + n
// flags a call the kernels do not take (1001 Lq or Lk not a multiple of
// 64, 1002 causal with Lq > Lk, 1003 B*H above 65535, 1004 the head dim,
// or bf16, which flash_attn_bwd_sm90.cu takes, 1005 the dtype, 1006 a mask
// above 128).
extern "C" int zoo_flash_attn_bwd_dq_f32tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq,
    int dtype, int batch, int heads, int lq, int lk, int d,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    long long do_sb, long long do_sh, long long do_sl,
    long long dq_sb, long long dq_sh, long long dq_sl,
    const void* mask, long long mask_sb,
    float scale, int causal, void* stream) {
  const int bad = check(dtype, lq, lk, batch, heads, causal);
  if (bad) return bad;
  if (dtype != 0) return 1004;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.mask = static_cast<const uint8_t*>(mask);
  p.mask_sb = mask_sb;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_sl = do_sl;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_sl = dq_sl;
  p.h = heads; p.lq = lq; p.lk = lk;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool masked = mask != nullptr;
  return with_head_dim(d, [&](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    if constexpr (D > 128) {
      // unmasked above 128 (the reference's dispatch sends no masked call
      // there)
      if (masked) return 1006;
      return launch(flash_bwd_dq_f32tc_wide_kernel<D>,
                    dim3(lq / WideCfg<D>::kDqRows, batch * heads),
                    dq_wide_smem_bytes<D>(), p, s, WideCfg<D>::kDqThreads);
    } else {
      const dim3 grid(lq / kTile, batch * heads);
      constexpr size_t smem = dq_f32tc_smem_bytes<D>();
      return masked
          ? launch(flash_bwd_dq_f32tc_kernel<D, true>, grid, smem, p, s)
          : launch(flash_bwd_dq_f32tc_kernel<D, false>, grid, smem, p, s);
    }
  });
}

// K3 in f32 at the same head dims: reads the delta K2 wrote; writes dk
// and dv. Arguments as zoo_flash_attn_bwd_dkv_sm90's, return codes as
// zoo_flash_attn_bwd_dq_f32tc's.
extern "C" int zoo_flash_attn_bwd_dkv_f32tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int dtype, int batch, int heads, int lq, int lk, int d,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long do_sb, long long do_sh, long long do_sl,
    long long dk_sb, long long dk_sh, long long dk_sl,
    long long dv_sb, long long dv_sh, long long dv_sl,
    const void* mask, long long mask_sb,
    float scale, int causal, void* stream) {
  const int bad = check(dtype, lq, lk, batch, heads, causal);
  if (bad) return bad;
  if (dtype != 0) return 1004;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.mask = static_cast<const uint8_t*>(mask);
  p.mask_sb = mask_sb;
  p.lse = static_cast<const float*>(lse);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = dk; p.dv = dv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_sl = do_sl;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_sl = dk_sl;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_sl = dv_sl;
  p.h = heads; p.lq = lq; p.lk = lk;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool masked = mask != nullptr;
  return with_head_dim(d, [&](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    if constexpr (D > 128) {
      if (masked) return 1006;
      return launch(flash_bwd_dkv_f32tc_wide_kernel<D>,
                    dim3(lk / WideCfg<D>::kKeys, batch * heads),
                    dkv_wide_smem_bytes<D>(), p, s, WideCfg<D>::kDkvThreads);
    } else {
      const dim3 grid(lk / TcCfg<D>::kKeys, batch * heads);
      constexpr size_t smem = dkv_f32tc_smem_bytes<D>();
      return masked
          ? launch(flash_bwd_dkv_f32tc_kernel<D, true>, grid, smem, p, s)
          : launch(flash_bwd_dkv_f32tc_kernel<D, false>, grid, smem, p, s);
    }
  });
}
