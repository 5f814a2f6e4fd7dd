// Flash-attention forward (K1; K5b at the other head dims) for Hopper,
// sm_90a: bf16 with a key-padding mask (D <= 128), bf16 K5b, and bf16
// above D = 256. Two kinds of call run elsewhere, and the entry point
// returns 1004 for them: bf16 without a mask at D in {64, 128, 192, 256}
// (flash_attn_fwd_sm90.cu: TMA, a producer warpgroup, wgmma) and every
// f32 call, masked or not (flash_attn_fwd_f32tc.cu: 3xTF32 mma.sync on
// the tensor cores, cp.async).
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_fwd_kernel`
// (:82-134), launched by `_flash_fwd` (:137-189). Computes exact
// softmax(scale * Q K^T) V on [B, H, L, D] with f32 softmax statistics and
// f32 accumulation, output in the input dtype, optional per-row logsumexp
// ([B*H, Lq] f32), and a causal mask aligned bottom-right (key j is visible
// to query i when j <= i + Lk - Lq).
//
// Key-padding mask (optional, [B, Lk] bytes, nonzero = real key): replaces
// the key-padding branch of analytics_zoo_tpu/ops/attention.py (:116-127),
// which on the TPU goes to JAX's stock Pallas flash_attention with segment
// ids. Padded keys are invisible to every query row. A row that sees no key
// at all (an all-zero mask row, or causal with left padding) gets what the
// reference's einsum path gives with its finite -1e30 fill: the mean of V
// over all Lk keys, and logsumexp kEmptyLse. The mask of each kv tile is
// staged in shared memory beside K and V (64 bytes); fully padded tiles are
// still walked (skipping them is later work). The mask is a template flag
// (kMask), so a launch without one runs the unmasked kernel as it was: a
// per-score test that is only predicated off still costs instructions.
//
// Head dims (K5b). Besides D in {64, 128} (K1), the same templates take
// every D <= 128 that is a multiple of 8 and not of 64: the stock-kernel
// branch of analytics_zoo_tpu/ops/attention.py (:116-127), which on the TPU
// sends flash-eligible calls at head_dim % 64 != 0 to JAX's stock Pallas
// flash_attention (TinyGenLM's prefill at D = 16, or 80 at Phi-2's widths).
// The stock kernel aligns a causal mask top-left, but the reference takes
// it only at Lq == Lk, where that is this kernel's bottom-right diagonal.
// The bf16 path contracts Q K^T in k-steps of 16, so at D = 8 (mod 16) the
// upper half of the last k-step is zero in both fragments (never read
// from memory); P V runs in n-blocks of 8 and needs no padding. (f32 at
// these head dims is flash_attn_fwd_f32tc.cu's.) Each D is its own
// instantiation, so the register arrays stay sized to it.
//
// Head dims above 128 (K1 at D in {192, 256}). The reference's Pallas kernel
// takes any D % 64 == 0 (pallas_attention.py:150), and its dispatch sends an
// unmasked flash call there (analytics_zoo_tpu/ops/attention.py:107-112; a
// masked one takes its einsum path, so these instantiations are unmasked).
// bf16 there is flash_attn_fwd_sm90.cu's (it retired the mma.sync kernel
// flash_fwd_bf16_wide_kernel), f32 flash_attn_fwd_f32tc.cu's (it retired
// this source's FMA kernel there, 8 threads a row on 16-row kv tiles).
//
// Head dims 320 to 512 (K1 at D in {320, 384, 448, 512}, unmasked, as
// above; bf16: the 512-head LM's fit; f32 there, TinyGenLM's prefill at
// DeepSeek-V4-Flash's head dim of 512 among it, is
// flash_attn_fwd_f32tc.cu's, which retired this source's FMA kernel):
//   * a warp's O accumulator over all of D would be D/2 f32
//     registers a thread (160-256), past the 255 a thread may hold.
//     flash_fwd_bf16_split_kernel splits D across warps, as K3's wide
//     kernel does: a block owns 32 q rows (2 row groups of 16) and each
//     row group has kSplit = D/64 warps, warp j owning dims [64j, 64j+64)
//     of Q and of O (32 f32 registers). Q is staged in shared memory and a
//     warp reloads the A fragment of its slice every k-step (4 registers,
//     not 16 held: ptxas keeps the kernel at 128 registers a thread at
//     D = 448 and 512, and the first version, with Q in registers,
//     spilled 24 bytes at 448). The
//     scores need every dim, so each warp computes the partial S of its
//     slice (16 rows x 32 keys, 4 k-steps) and writes it to shared memory
//     in fragment order; after a barrier every warp of the row group sums
//     the kSplit partials of its own fragment positions, in one fixed
//     order, so all of them hold the same S bit for bit and run the same
//     softmax (the exp work is repeated kSplit times; the Q K^T flops are
//     not). This is option (a) of two: the other, one warp computing S
//     and staging P for the rest, leaves kSplit - 1 warps idle through
//     the whole of Q K^T, half of the tensor-core work. Three barriers a
//     kv tile: the tile staged, the partials written, and (at the top of
//     the next tile) every warp done reading both. A row group's split
//     warps make the same causal decision for a tile, and every warp
//     reaches every barrier whether or not it computes. Shared memory
//     (dynamic): Q [32][D+8], K and V [32][D+8] bf16 plus the partials,
//     2 x kSplit x 16 x 32 f32 -- 83,456 bytes at D = 320, 132,608 at 512.
//
// Design. The Pallas grid (bh, q-block, kv-block) ran its kv dimension as a
// sequential loop on one TPU core, carrying (m, l, acc) in VMEM scratch.
// Here one thread block owns one (b*h, 64-row q tile) and walks the kv
// tiles in a loop of its own; blocks run in parallel over the SMs.
//   * bf16 (masked calls, and K5b's head dims; the unmasked instantiations
//     at 64 and 128 moved to flash_attn_fwd_sm90.cu): 4 warps, 16 query
//     rows each. Q stays in registers as mma.sync
//     A fragments for the whole kernel; each 64-row K/V tile is staged in
//     shared memory (rows padded by 16 bytes so fragment reads hit distinct
//     banks); S = Q K^T and O += P V run on the tensor cores as
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate). The S accumulator
//     fragment is re-packed in registers as the A fragment of P V, so the
//     probabilities never touch shared or device memory. P is rounded to
//     bf16 before P V, as the Pallas kernel casts p to v.dtype.
//   * causal: kv tiles wholly above the diagonal are never loaded, and a
//     warp whose rows all lie above a tile skips its arithmetic for it.
//   * rows that see no key: masked scores are -inf, so such a row ends the
//     loop with its running max still -inf. A block holding one computes
//     the column means of V in one more pass (tid < D, one column a
//     thread, coalesced) and writes them as that row's output. Only user
//     inputs reach this pass; the loop itself never divides 0 by 0.
//
// What bounds it. Per (b, h) it reads Q, K, V once from device memory and
// writes O once: 4*L*D elements against 4*L*Lk*D flops, so at L = 512,
// D = 64 in bf16 it does 256 flops per byte, just under the H100's
// ~295 flop/byte ridge: both bounds are close (the bound is computed per
// shape in chip_smoke.py). This simple kernel is far from either: it
// issues synchronous tile loads (no cp.async/TMA pipelining) and mma.sync
// rather than wgmma, so it is latency- and issue-bound; several resident
// blocks per SM (about 18 KB shared memory each at D = 64) are what hide
// the load latency. wgmma, TMA and a producer warpgroup are
// flash_attn_fwd_sm90.cu's, for the unmasked bf16 calls; the masked ones
// here are later work.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libzoo_flash_attn_fwd.so flash_attn_fwd.cu

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // q rows per block == kv rows per tile (bf16)
constexpr int kThreads = 128;    // 4 warps
constexpr int kPad = 8;          // bf16 elements of smem row padding
constexpr int kWideKv = 32;      // kv rows per smem tile, bf16 at D > 256
constexpr int kSplitRows = 32;   // q rows per block, bf16 at D > 256
constexpr int kSlice = 64;       // dims of D a warp owns, bf16 at D > 256
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// logsumexp of a row that sees no key: what f32 logsumexp gives for the
// einsum path's row of -1e30 fills (log(Lk) is absorbed)
constexpr float kEmptyLse = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                    // nullptr unless with_lse
  const uint8_t* mask;           // [B, Lk] key-padding mask, or nullptr
  long long mask_sb;             // its batch stride
  long long q_sb, q_sh, q_sl;    // element strides: batch, head, seq
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int h, lq, lk;
  float scale_log2;              // softmax scale * log2(e)
  int causal;
};

__device__ __forceinline__ float bf16_to_f32(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// column means of bf16 V over all Lk keys into `mean` (threads tid < D,
// one column each); the output of a row that sees no key
template <int D>
__device__ __forceinline__ void v_column_means(float* mean, const uint16_t* v,
                                               long long sl, int lk, int tid) {
  if (tid < D) {
    float acc = 0.f;
    for (int j = 0; j < lk; ++j) acc += bf16_to_f32(v[j * sl + tid]);
    mean[tid] = acc / static_cast<float>(lk);
  }
  __syncthreads();
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, `lo` in the low half (the
// element with the lower column index, as the mma fragments expect)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (static_cast<uint32_t>(hi) << 16) | static_cast<uint32_t>(lo);
}

// ---------------------------------------------------------------- bf16 --
template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const Params p) {
  static_assert(D % 8 == 0 && D <= 128, "head_dim: a multiple of 8, <= 128");
  constexpr int kSteps = (D + 15) / 16;  // k-steps of Q K^T
  __shared__ __align__(16) uint16_t sK[kTile][D + kPad];
  __shared__ __align__(16) uint16_t sV[kTile][D + kPad];
  __shared__ uint8_t sM[kTile];  // this kv tile's key-padding mask
  __shared__ float sMean[D];     // column means of V (rows with no key)

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;       // fragment row group
  const int t4 = lane & 3;       // thread within the group

  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.v_sb + hh * p.v_sh;
  uint16_t* o = static_cast<uint16_t*>(p.o) + b * p.o_sb + hh * p.o_sh;
  const uint8_t* mrow = kMask ? p.mask + b * p.mask_sb : nullptr;

  const int row0 = qt * kTile + warp * 16;   // this warp's first q row
  const int ra = row0 + g;                   // the two rows a thread holds
  const int rb = row0 + g + 8;
  const int offset = p.lk - p.lq;

  // Q as A fragments of m16n8k16, one per 16-wide slice of D; at
  // D = 8 (mod 16) the last slice's columns D..D+7 are zeros
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int c = 0; c < kSteps; ++c) {
    const uint16_t* pa = q + ra * p.q_sl + c * 16 + t4 * 2;
    const uint16_t* pb = q + rb * p.q_sl + c * 16 + t4 * 2;
    qf[c][0] = *reinterpret_cast<const uint32_t*>(pa);
    qf[c][1] = *reinterpret_cast<const uint32_t*>(pb);
    const bool upper = c * 16 + 8 < D;
    qf[c][2] = upper ? *reinterpret_cast<const uint32_t*>(pa + 8) : 0u;
    qf[c][3] = upper ? *reinterpret_cast<const uint32_t*>(pb + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_a = -INFINITY, m_b = -INFINITY;  // running max (log2 domain)
  float l_a = 0.f, l_b = 0.f;              // this thread's part of the row sum

  int n_tiles = p.lk / kTile;
  if (p.causal) {
    const int last = (qt * kTile + kTile - 1 + offset) / kTile + 1;
    n_tiles = min(n_tiles, last);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kTile * D / 8; i += kThreads) {
      const int r = i / (D / 8);
      const int c = (i - r * (D / 8)) * 8;
      const long long key = static_cast<long long>(kt) * kTile + r;
      *reinterpret_cast<uint4*>(&sK[r][c]) =
          *reinterpret_cast<const uint4*>(k + key * p.k_sl + c);
      *reinterpret_cast<uint4*>(&sV[r][c]) =
          *reinterpret_cast<const uint4*>(v + key * p.v_sl + c);
    }
    if (kMask && tid < kTile) sM[tid] = mrow[kt * kTile + tid];
    __syncthreads();

    // a warp whose rows all lie above this tile has nothing to add
    if (p.causal && row0 + 15 + offset < kt * kTile) continue;

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 fragments of 16x8
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int c = 0; c < kSteps; ++c) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&sK[n * 8 + g][c * 16 + t4 * 2]);
        // past D (the padding of a half k-step): zero, as Q's columns are
        const uint32_t b1 = c * 16 + 8 < D
            ? *reinterpret_cast<const uint32_t*>(&sK[n * 8 + g][c * 16 + 8 + t4 * 2])
            : 0u;
        mma_16816(s[n], qf[c], b0, b1);
      }
    }

    // scale into the log2 domain, mask, and take the row max
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale_log2;
        const int col = n * 8 + t4 * 2 + (e & 1);  // key within the tile
        if (p.causal && kt * kTile + col > ((e < 2) ? ra : rb) + offset) {
          x = -INFINITY;
        }
        if (kMask && sM[col] == 0) x = -INFINITY;
        s[n][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    // the four threads of a group hold the same two rows
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    // a row with no visible key yet keeps -inf; subtract 0 there
    const float base_a = (mx_a == -INFINITY) ? 0.f : mx_a;
    const float base_b = (mx_b == -INFINITY) ? 0.f : mx_b;
    const float corr_a = exp2f(m_a - base_a);
    const float corr_b = exp2f(m_b - base_b);
    m_a = mx_a;
    m_b = mx_b;

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - base_a);
      s[n][1] = exp2f(s[n][1] - base_a);
      s[n][2] = exp2f(s[n][2] - base_b);
      s[n][3] = exp2f(s[n][3] - base_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }

    // O += P V, 16 keys at a time; the S fragments of key columns
    // [16j, 16j+8) and [16j+8, 16j+16) are exactly P's A fragment
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
        const int col = n * 8 + g;
        const uint32_t b0 = pack_raw(sV[kr][col], sV[kr + 1][col]);
        const uint32_t b1 = pack_raw(sV[kr + 8][col], sV[kr + 9][col]);
        mma_16816(acc[n], a, b0, b1);
      }
    }
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  const float inv_a = 1.f / l_a;
  const float inv_b = 1.f / l_b;
  // a row whose running max is still -inf saw no key (only a mask can
  // do that: under causal alone, with Lq <= Lk, every row sees key 0)
  const bool empty_a = kMask && m_a == -INFINITY;
  const bool empty_b = kMask && m_b == -INFINITY;
  if (kMask && __syncthreads_or(empty_a || empty_b)) {
    v_column_means<D>(sMean, v, p.v_sl, p.lk, tid);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(o + ra * p.o_sl + col) =
        empty_a ? pack_bf16(sMean[col], sMean[col + 1])
                : pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    *reinterpret_cast<uint32_t*>(o + rb * p.o_sl + col) =
        empty_b ? pack_bf16(sMean[col], sMean[col + 1])
                : pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
  }
  if (p.lse != nullptr && t4 == 0) {
    float* lse = p.lse + static_cast<long long>(bh) * p.lq;
    lse[ra] = empty_a ? kEmptyLse : (m_a + log2f(l_a)) * kLn2;
    lse[rb] = empty_b ? kEmptyLse : (m_b + log2f(l_b)) * kLn2;
  }
}

// ------------------------------------------------------- bf16, D > 256 --
// K1 at D in {320, 384, 448, 512}, unmasked: D split across warps (the
// header's design notes). Block: kSplitRows q rows = 2 row groups of 16,
// each of kSplit warps; D threads in all. Warp w is row group w / kSplit
// and owns slice w % kSplit of D.
template <int D>
__global__ void __launch_bounds__(D)
flash_fwd_bf16_split_kernel(const Params p) {
  static_assert(D % kSlice == 0 && D > 256 && D <= 512,
                "head_dim: 320, 384, 448 or 512");
  constexpr int kSplit = D / kSlice;     // warps of a row group
  constexpr int kRow = D + kPad;         // shared-memory row, bf16 elements
  constexpr int kN = kWideKv / 8;        // n-blocks of 8 keys in a tile
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sK = sQ + kSplitRows * kRow;
  uint16_t* sV = sK + kWideKv * kRow;
  // partial scores in fragment order: [row group][slice][n-block][lane]
  // of 4 floats, so a warp writes and reads 32 consecutive float4
  float4* sS = reinterpret_cast<float4*>(sV + kWideKv * kRow);

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

  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.v_sb + hh * p.v_sh;
  uint16_t* o = static_cast<uint16_t*>(p.o) + b * p.o_sb + hh * p.o_sh;

  const int row0 = qt * kSplitRows + rg * 16;
  const int ra = row0 + g;
  const int rb = row0 + g + 8;
  const int offset = p.lk - p.lq;

  // Q in shared memory: a warp's A fragments of its slice are reloaded
  // every k-step (4 registers, not 16: see the header)
  for (int i = tid; i < kSplitRows * D / 8; i += D) {
    const int r = i / (D / 8);
    const int c = (i - r * (D / 8)) * 8;
    const long long row = static_cast<long long>(qt) * kSplitRows + r;
    *reinterpret_cast<uint4*>(&sQ[r * kRow + c]) =
        *reinterpret_cast<const uint4*>(q + row * p.q_sl + c);
  }
  // this thread's A-fragment elements of rows ra and rb (k-step 0)
  const uint16_t* qa = sQ + (rg * 16 + g) * kRow + col0 + t4 * 2;
  const uint16_t* qb = qa + 8 * kRow;

  float acc[kSlice / 8][4];
#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_a = -INFINITY, m_b = -INFINITY;
  float l_a = 0.f, l_b = 0.f;

  int n_tiles = p.lk / kWideKv;
  if (p.causal) {
    const int last = (qt * kSplitRows + kSplitRows - 1 + offset) / kWideKv + 1;
    n_tiles = min(n_tiles, last);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    // Q is staged; every warp is done with the last tile and partials
    __syncthreads();
    for (int i = tid; i < kWideKv * D / 8; i += D) {
      const int r = i / (D / 8);
      const int c = (i - r * (D / 8)) * 8;
      const long long key = static_cast<long long>(kt) * kWideKv + r;
      *reinterpret_cast<uint4*>(&sK[r * kRow + c]) =
          *reinterpret_cast<const uint4*>(k + key * p.k_sl + c);
      *reinterpret_cast<uint4*>(&sV[r * kRow + c]) =
          *reinterpret_cast<const uint4*>(v + key * p.v_sl + c);
    }
    __syncthreads();

    // the same for every warp of the row group: rows all above the tile
    const bool active = !(p.causal && row0 + 15 + offset < kt * kWideKv);
    float s[kN][4];
    if (active) {
      // partial S over this warp's 64 dims: 16 rows x 32 keys; Q's
      // fragment of each k-step is read once and used for the 4 key
      // blocks
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kSlice / 16; ++c) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(qa + c * 16);
        a[1] = *reinterpret_cast<const uint32_t*>(qb + c * 16);
        a[2] = *reinterpret_cast<const uint32_t*>(qa + c * 16 + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(qb + c * 16 + 8);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const uint16_t* kr = sK + (n * 8 + g) * kRow + col0 + c * 16 + t4 * 2;
          mma_16816(s[n], a, *reinterpret_cast<const uint32_t*>(kr),
                    *reinterpret_cast<const uint32_t*>(kr + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        sS[((rg * kSplit + slice) * kN + n) * 32 + lane] =
            make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
      }
    }
    __syncthreads();  // every slice's partial is written
    if (!active) continue;

    // S = the sum of the kSplit partials, slice 0 first in every warp
    // (the slice loop rolled: unrolled, ptxas spilled 4-8 bytes at D =
    // 320 and 448)
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      float4 t = sS[(rg * kSplit * kN + n) * 32 + lane];
#pragma unroll 1
      for (int j = 1; j < kSplit; ++j) {
        const float4 u = sS[((rg * kSplit + j) * kN + n) * 32 + lane];
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
      }
      s[n][0] = t.x;
      s[n][1] = t.y;
      s[n][2] = t.z;
      s[n][3] = t.w;
    }

    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale_log2;
        const int col = n * 8 + t4 * 2 + (e & 1);
        if (p.causal && kt * kWideKv + col > ((e < 2) ? ra : rb) + offset) {
          x = -INFINITY;
        }
        s[n][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    // causal rows above the whole tile (in a row group that straddles
    // it) keep -inf; subtract 0 there
    const float base_a = (mx_a == -INFINITY) ? 0.f : mx_a;
    const float base_b = (mx_b == -INFINITY) ? 0.f : mx_b;
    const float corr_a = exp2f(m_a - base_a);
    const float corr_b = exp2f(m_b - base_b);
    m_a = mx_a;
    m_b = mx_b;

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      s[n][0] = exp2f(s[n][0] - base_a);
      s[n][1] = exp2f(s[n][1] - base_a);
      s[n][2] = exp2f(s[n][2] - base_b);
      s[n][3] = exp2f(s[n][3] - base_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < kSlice / 8; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }

    // O[:, slice] += P V[:, slice]
#pragma unroll
    for (int j = 0; j < kWideKv / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      const uint16_t* vr = sV + (j * 16 + t4 * 2) * kRow + col0 + g;
#pragma unroll
      for (int n = 0; n < kSlice / 8; ++n) {
        const uint16_t* vc = vr + n * 8;
        const uint32_t b0 = pack_raw(vc[0], vc[kRow]);
        const uint32_t b1 = pack_raw(vc[8 * kRow], vc[9 * kRow]);
        mma_16816(acc[n], a, b0, b1);
      }
    }
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  const float inv_a = 1.f / l_a;
  const float inv_b = 1.f / l_b;
#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n) {
    const int col = col0 + n * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(o + ra * p.o_sl + col) =
        pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    *reinterpret_cast<uint32_t*>(o + rb * p.o_sl + col) =
        pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
  }
  // every slice holds the same m and l; the first writes the lse
  if (p.lse != nullptr && slice == 0 && t4 == 0) {
    float* lse = p.lse + static_cast<long long>(bh) * p.lq;
    lse[ra] = (m_a + log2f(l_a)) * kLn2;
    lse[rb] = (m_b + log2f(l_b)) * kLn2;
  }
}

// smem: dynamic shared memory in bytes; above the 48 KB a block gets by
// default the kernel must first be allowed it
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, const Params& p, cudaStream_t stream,
                   int smem = 0, int threads = kThreads) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// the bf16 instantiation for one head dim up to 128 (without a mask at
// 64 and 128 it is flash_attn_fwd_sm90.cu's, and f32
// flash_attn_fwd_f32tc.cu's; the entry point returns 1004 for those)
template <int D>
cudaError_t launch_d(bool masked, int batch_heads, const Params& p,
                     cudaStream_t s) {
  const dim3 grid(p.lq / kTile, batch_heads);
  if constexpr (D % 64 == 0) {
    return launch(flash_fwd_bf16_kernel<D, true>, grid, p, s);
  } else {
    return masked ? launch(flash_fwd_bf16_kernel<D, true>, grid, p, s)
                  : launch(flash_fwd_bf16_kernel<D, false>, grid, p, s);
  }
}

// K1 bf16 at D in {320, 384, 448, 512}: unmasked only (no path takes a
// mask above 128)
template <int D>
cudaError_t launch_split(int batch_heads, const Params& p, cudaStream_t s) {
  constexpr int smem = (kSplitRows + 2 * kWideKv) * (D + kPad) * 2
      + 2 * (D / kSlice) * 16 * kWideKv * 4;
  return launch(flash_fwd_bf16_split_kernel<D>,
                dim3(p.lq / kSplitRows, batch_heads), p, s, smem, D);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask: [B, Lk] bytes (nonzero = real
// key) with batch stride mask_sb, or null for none (required at D > 128).
// Returns a cudaError_t (0 = launched); 1000 + n flags an argument the
// kernel does not take (1004: a head dim it has no kernel for, bf16
// without a mask at 64, 128, 192 and 256 and every f32 call among
// them).
extern "C" int zoo_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int batch, int heads, int lq, int lk, int d,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    const void* mask, long long mask_sb,
    float scale, int causal, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.mask = static_cast<const uint8_t*>(mask);
  p.mask_sb = mask_sb;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sl = q_sl;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sl = k_sl;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.h = heads; p.lq = lq; p.lk = lk;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  if (lq % kTile || lk % kTile) return 1001;
  if (causal && lq > lk) return 1002;
  if (batch * heads > 65535) return 1003;
  if (dtype != 0 && dtype != 1) return 1005;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool masked = mask != nullptr;  // the kMask instantiation or not
  if (masked && d > 128) return 1006;
  // bf16 without a mask at these head dims: flash_attn_fwd_sm90.cu
  if (dtype == 1 && !masked && (d == 64 || d == 128 || d == 192 || d == 256)) {
    return 1004;
  }
  // f32, masked or not: flash_attn_fwd_f32tc.cu
  if (dtype == 0) return 1004;
  const int bh = batch * heads;
  switch (d) {
    // K1 (bf16 with a mask)
    case 64: return launch_d<64>(masked, bh, p, s);
    case 128: return launch_d<128>(masked, bh, p, s);
    // K5b (bf16): the other multiples of 8 up to 128
    case 8: return launch_d<8>(masked, bh, p, s);
    case 16: return launch_d<16>(masked, bh, p, s);
    case 24: return launch_d<24>(masked, bh, p, s);
    case 32: return launch_d<32>(masked, bh, p, s);
    case 40: return launch_d<40>(masked, bh, p, s);
    case 48: return launch_d<48>(masked, bh, p, s);
    case 56: return launch_d<56>(masked, bh, p, s);
    case 72: return launch_d<72>(masked, bh, p, s);
    case 80: return launch_d<80>(masked, bh, p, s);
    case 88: return launch_d<88>(masked, bh, p, s);
    case 96: return launch_d<96>(masked, bh, p, s);
    case 104: return launch_d<104>(masked, bh, p, s);
    case 112: return launch_d<112>(masked, bh, p, s);
    case 120: return launch_d<120>(masked, bh, p, s);
    // K1 above 256: the reference's Pallas kernel at D % 64 == 0
    case 320: return launch_split<320>(bh, p, s);
    case 384: return launch_split<384>(bh, p, s);
    case 448: return launch_split<448>(bh, p, s);
    case 512: return launch_split<512>(bh, p, s);
    default: return 1004;
  }
}
