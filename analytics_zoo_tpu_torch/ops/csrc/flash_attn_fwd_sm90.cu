// Flash-attention forward (K1, K1-lse) for Hopper, sm_90a: the bf16
// kernel without a key-padding mask at head dims 64, 128, 192 and 256,
// built on TMA, mbarriers, a producer warpgroup and wgmma.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_fwd_kernel`
// (:82), launched by `_flash_fwd` (:137), for those calls. It computes
// what that kernel computes: softmax(scale * Q K^T) V on [B, H, L, D]
// with f32 softmax statistics and f32 accumulation, P rounded to bf16
// before P V (the Pallas kernel casts p to v.dtype), O in bf16, with
// `with_lse` the natural-log logsumexp in [B*H, Lq] f32 that K2 and K3
// read, and a causal mask aligned bottom-right (key j is visible to row
// i when j <= i + Lk - Lq). Without a mask and with Lq <= Lk every row
// sees key 0, so no row is empty and no empty-row pass is needed.
//
// What bounds it. Per (b, h) it reads Q, K, V once and writes O once,
// against 4 * D flops per visible (query, key) pair. Causal at D = 256
// ([8, 8, 2048, 256]) that is 138 GFLOP against 33.6 MB: bound by the
// tensor cores (0.139 ms at 989 TFLOP/s, 0.010 ms of bytes). At D = 64
// (the served [32, 12, 512, 64] call) the flops per byte are 256, just
// under the card's ridge of about 295: bound by bytes (0.030 ms), with
// the operations' bound (0.026 ms) close.
//
// What the design does about it. The kernels it retires
// (flash_fwd_bf16_kernel<64|128, false> and flash_fwd_bf16_wide_kernel
// in flash_attn_fwd.cu) loaded tiles synchronously with every thread and
// a __syncthreads() pair a kv tile, ran mma.sync.m16n8k16 and, at D =
// 256, reloaded Q's fragments every k-step, gathered V one scalar at a
// time and held 254 registers. Here:
//   * A block owns 128 q rows and has three warpgroups (384 threads).
//     Warpgroup 0 is the producer: it gives back its registers
//     (setmaxnreg.dec to 24) and one thread issues every load as a TMA
//     copy (cp.async.bulk.tensor) that completes on an mbarrier.
//     Warpgroups 1 and 2 are consumers of 64 q rows each and take the
//     registers (setmaxnreg.inc; O is D/2 f32 registers a thread, 128 at
//     D = 256). setmaxnreg.inc draws on the block's own pool, so what the
//     three warpgroups hold afterwards fits in what the block started
//     with (Tiles' static_assert; more would wait forever).
//   * Shared memory: Q once, then K and V in rings of kStages stages,
//     each stage with a "full" barrier (TMA's transaction count) and an
//     "empty" one (an arrival from each consumer warp) for K and for V
//     apart. The producer loads K of tile kt before V of tile kt - 1, the
//     order the consumers use them in, and refills a K stage as soon as
//     its Q K^T is done. Tiles are D/64 slabs of [rows][64] bf16 with the
//     128-byte swizzle, what TMA's CU_TENSOR_MAP_SWIZZLE_128B writes and
//     the wgmma descriptors' 128B layout reads (slabs 1024-byte aligned).
//   * S = Q K^T is wgmma.m64n{kKv}k16 with A (Q) and B (K, K-major) read
//     from shared memory through descriptors, D/16 k-steps (each wgmma
//     advances one base descriptor inside its asm, so the compiler keeps
//     no descriptor a k-step in registers). The online softmax runs in
//     registers in the accumulator layout (a row's values in the 4
//     threads of a quad, reduced with two shfl_xor; ex2.approx.ftz for
//     the exponentials). O += P V is one wgmma.m64n{D}k16 a k-step of
//     16 keys, with A (P) from registers, the S accumulator re-packed as
//     bf16 A fragments, and B (V) MN-major from shared memory (the
//     transpose flag; the slabs of D are its leading byte offset apart),
//     so P never leaves registers and V is never gathered by hand.
//   * Within a consumer, Q K^T of tile kt is issued before P V of tile
//     kt - 1, and tile kt's softmax runs while that P V is still on the
//     tensor cores. That needs S, P and O in registers at once; at D = 64
//     the kernel instead runs two blocks an SM (kv tiles of 64, 104
//     registers a consumer), which hides one block's load latency behind
//     the other's arithmetic, and its consumers take tile by tile.
//   * Causal: kv tiles above a block's last row are never loaded; a
//     consumer whose 64 rows all lie above a tile skips its arithmetic
//     but still waits and arrives on that tile's barriers; only tiles
//     that cross the diagonal (or Lk's end) are masked element by
//     element. Blocks run longest first (q tiles in reverse blockIdx.x).
//   * Lq % 128 == 64: the last block's second consumer has no rows. It
//     skips its arithmetic, reaches every barrier and stores nothing;
//     TMA zero-fills the rows past Lq (and keys past Lk) it reads.
//   * Tensor maps (4-D: D, L, H, B with the caller's strides, so q/k/v
//     may be views into a fused qkv projection) are encoded on the host
//     each call with cuTensorMapEncodeTiled, reached through the
//     runtime's cudaGetDriverEntryPoint (no -lcuda), and passed as
//     __grid_constant__ parameters.
//   * No wait traps on a timeout: a trap path made ptxas serialize every
//     wgmma and cap the consumers at the 168 registers of the entry.
// Later work: ping-pong scheduling of the two consumers, a persistent
// grid, and the epilogue through shared memory and a TMA store (O is
// written from registers, 4 bytes a thread a row).
//
// flash_attn_fwd.cu keeps the masked bf16 calls, the other head dims
// up to 128 (K5b), every f32 call and bf16 above 256.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libzoo_flash_attn_fwd_sm90.so \
//        flash_attn_fwd_sm90.cu

#include "flash_attn_sm90.cuh"

#include <chrono>

namespace {

constexpr int kRows = 128;      // q rows a block: two consumers of 64
constexpr int kEmptyArrivals = 8;  // one a consumer warp

template <int KV, int STAGES, int BLOCKS, int PRODUCER, int CONSUMER>
struct Tiles {
  static constexpr int kKv = KV, kStages = STAGES, kBlocks = BLOCKS;
  static constexpr int kProducerRegs = PRODUCER, kConsumerRegs = CONSUMER;
  // setmaxnreg.inc takes registers from the block's own pool, which
  // holds what the block started with: more would wait forever
  static_assert(PRODUCER + 2 * CONSUMER <= 3 * launch_regs(BLOCKS),
                "registers");
};
// kv rows a tile, ring stages, blocks an SM and the registers a
// producer and a consumer thread keep after setmaxnreg, by head dim (at
// D = 256: Q 64 KB + 2 x (32 + 32) KB of K and V, 193 KB of the 227)
template <int D> struct Cfg;
template <> struct Cfg<64> : Tiles<64, 3, 2, 24, 104> {};
template <> struct Cfg<128> : Tiles<128, 2, 1, 24, 240> {};
template <> struct Cfg<192> : Tiles<64, 3, 1, 24, 240> {};
template <> struct Cfg<256> : Tiles<64, 2, 1, 24, 240> {};

// dynamic shared memory: 1024 bytes of alignment slack, Q, the K and V
// stages, then the barriers (Q, and K full, V full, K empty, V empty a
// stage)
template <int D>
constexpr int smem_bytes() {
  return 1024 + (kRows + 2 * Cfg<D>::kStages * Cfg<D>::kKv) * D * 2
      + 8 * (1 + 4 * Cfg<D>::kStages);
}

struct Params {
  void* o;
  float* lse;                    // nullptr unless with_lse
  long long o_sb, o_sh, o_sl;    // element strides of O: batch, head, seq
  int h, lq, lk;
  float scale_log2;              // softmax scale * log2(e)
  int causal;
};

template <int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kBlocks)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const Params p) {
  constexpr int kKv = Cfg<D>::kKv;
  constexpr int kStages = Cfg<D>::kStages;
  constexpr int kSlabs = D / kSlab;
  constexpr int kQBytes = kRows * D * 2;
  constexpr int kKvBytes = kKv * D * 2;   // one K (or V) tile
  static_assert(kKv == 64 || kKv == 128, "kv tile: 64 or 128 keys");
  // room for S, P and O of a tile at once (see the consumers' loops):
  // one block an SM
  constexpr bool kPipelined = Cfg<D>::kBlocks == 1;

  extern __shared__ uint8_t smem_raw[];
  // slabs start on 1024-byte boundaries, where the 128B swizzle repeats
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + kQBytes;                  // kStages K tiles
  const uint32_t sV = sK + kStages * kKvBytes;       // kStages V tiles
  const uint32_t barQ = sV + kStages * kKvBytes;
  const uint32_t fullK = barQ + 8;                   // 8 bytes a barrier
  const uint32_t fullV = fullK + 8 * kStages;
  const uint32_t emptyK = fullV + 8 * kStages;
  const uint32_t emptyV = emptyK + 8 * kStages;

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int q0 = qt * kRows;
  const int offset = p.lk - p.lq;

  // kv tiles this block walks: up to its last real row's last key
  int n_tiles = (p.lk + kKv - 1) / kKv;
  if (p.causal) {
    const int last_row = min(q0 + kRows, p.lq) - 1;
    n_tiles = min(n_tiles, (last_row + offset) / kKv + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(fullK + 8 * s, 1);
      mbar_init(fullV + 8 * s, 1);
      mbar_init(emptyK + 8 * s, kEmptyArrivals);
      mbar_init(emptyV + 8 * s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup index, uniform across each warp to the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(Cfg<D>::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(barQ, kQBytes);
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        tma_load(sQ + s * kRows * kSlabRow, &tq, barQ, s * kSlab, q0, hh, b);
      }
      // K of tile kt, then V of tile kt - 1: the order the consumers
      // use them in; each waits for its stage's previous tile to be
      // released (the first round finds every stage empty)
      auto load = [&](const CUtensorMap* map, uint32_t full, uint32_t empty,
                      uint32_t base, int kt) {
        const int stage = kt % kStages;
        mbar_wait(empty + 8 * stage, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * stage, kKvBytes);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(base + stage * kKvBytes + s * kKv * kSlabRow, map,
                   full + 8 * stage, s * kSlab, kt * kKv, hh, b);
        }
      };
      for (int kt = 0; kt < n_tiles + 1; ++kt) {
        if (kt < n_tiles) load(&tk, fullK, emptyK, sK, kt);
        if (kt >= 1) load(&tv, fullV, emptyV, sV, kt - 1);
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(Cfg<D>::kConsumerRegs));
  const int c = wg - 1;                  // consumer: q rows [64c, 64c+64)
  const int t = threadIdx.x - wg * 128;  // thread within the warpgroup
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;               // accumulator row within 8
  const int t4 = lane & 3;               // thread within the quad
  const int r0 = q0 + c * 64;            // this consumer's first row
  const int ra = r0 + warp * 16 + g;     // the two rows a thread holds
  const int rb = ra + 8;
  const bool active = r0 < p.lq;
  // tiles this consumer computes on: all of the block's, or, causal,
  // up to its own last row's last key; none past Lq
  int n_mine = active ? n_tiles : 0;
  if (active && p.causal) n_mine = min(n_tiles, (r0 + 63 + offset) / kKv + 1);
  // the last visible key of each of the two rows
  const int lim_a = p.causal ? min(ra + offset, p.lk - 1) : p.lk - 1;
  const int lim_b = p.causal ? min(rb + offset, p.lk - 1) : p.lk - 1;
  // and of this consumer's first row, the one that sees fewest
  const int lim_first = p.causal ? min(r0 + offset, p.lk - 1) : p.lk - 1;

  float o[kSlabs][32];
#pragma unroll
  for (int n = 0; n < kSlabs; ++n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  }
  float m_a = -INFINITY, m_b = -INFINITY;  // running max (log2 domain)
  float l_a = 0.f, l_b = 0.f;              // this thread's part of the sum
  float s[kKv / 2];          // S of one tile, then its probabilities
  uint32_t pf[kKv / 16][4];  // P as bf16 A fragments, 16 keys a k-step

  if (active) mbar_wait(barQ, 0);
  // this consumer's 64 rows of Q, slab 0, k-step 0
  const uint32_t q_base = sQ + c * 64 * kSlabRow;

  // issue S = Q K^T of tile kt (D/16 k-steps of 32 bytes within a
  // 128-byte slab row) and commit it as one wgmma group
  auto issue_qk = [&](int kt) {
    const uint32_t k_base = sK + (kt % kStages) * kKvBytes;
    wgmma_fence();
    const uint64_t da = sw128_desc(q_base, 16, 1024);
    const uint64_t db = sw128_desc(k_base, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // 16-byte units: slab kk / 4, 32 bytes a k-step within its rows
      const uint32_t step = (kk & 3) * 2;
      const uint32_t a_off = (kk >> 2) * (kRows * kSlabRow / 16) + step;
      const uint32_t b_off = (kk >> 2) * (kKv * kSlabRow / 16) + step;
      if constexpr (kKv == 64) {
        wgmma_ss_n64(s, da, a_off, db, b_off, kk > 0);
      } else {
        wgmma_ss_n128(s, da, a_off, db, b_off, kk > 0);
      }
    }
    wgmma_commit();
  };

  // issue O += P V of tile kt and commit it: one wgmma of N = D a k-step
  // of 16 keys; V's 128-byte rows are the K dimension (MN-major B), 8 of
  // them 1024 bytes apart in each core group, and its slabs of D kKv
  // rows apart (the leading byte offset)
  auto issue_pv = [&](int kt) {
    const uint32_t v_base = sV + (kt % kStages) * kKvBytes;
#pragma unroll
    for (int n = 0; n < kSlabs; ++n) fence_regs(o[n]);
    fence_regs(pf);
    wgmma_fence();
    const uint64_t dv = sw128_desc(v_base, kKv * kSlabRow, 1024);
    float (&acc)[D / 2] = reinterpret_cast<float (&)[D / 2]>(o);
#pragma unroll
    for (int kk = 0; kk < kKv / 16; ++kk) {
      wgmma_rs<D>(acc, pf[kk], dv, kk * 16 * (kSlabRow / 16));
    }
    wgmma_commit();
  };

  // the online softmax of tile kt's S, in place (s becomes unnormalised
  // probabilities); returns the rescale of the rows' old O and sum
  auto softmax = [&](int kt, float& corr_a, float& corr_b) {
    // scale into the log2 domain, mask, and take the row max; only a
    // tile that crosses the diagonal or Lk's end is masked
    const int key0 = kt * kKv;
    const bool edge = key0 + kKv - 1 > lim_first;
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j * 4 + e] * p.scale_log2;
        if (edge) {
          const int key = key0 + j * 8 + t4 * 2 + (e & 1);
          if (key > ((e < 2) ? lim_a : lim_b)) x = -INFINITY;
        }
        s[j * 4 + e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[j * 4], s[j * 4 + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j * 4 + 2], s[j * 4 + 3]));
    }
    // the four threads of a quad hold the same two rows
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    // a row with no visible key yet keeps -inf; subtract 0 there
    const float base_a = (mx_a == -INFINITY) ? 0.f : mx_a;
    const float base_b = (mx_b == -INFINITY) ? 0.f : mx_b;
    corr_a = fast_exp2(m_a - base_a);
    corr_b = fast_exp2(m_b - base_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j) {
      s[j * 4] = fast_exp2(s[j * 4] - base_a);
      s[j * 4 + 1] = fast_exp2(s[j * 4 + 1] - base_a);
      s[j * 4 + 2] = fast_exp2(s[j * 4 + 2] - base_b);
      s[j * 4 + 3] = fast_exp2(s[j * 4 + 3] - base_b);
      sum_a += s[j * 4] + s[j * 4 + 1];
      sum_b += s[j * 4 + 2] + s[j * 4 + 3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
  };

  // O's rows rescaled, and the probabilities packed as P's A fragments
  // (the S fragments of keys [16j, 16j + 8) and [16j + 8, 16j + 16) are
  // exactly P's A fragment for k-step j); only once no P V is in flight
  auto rescale_and_pack = [&](float corr_a, float corr_b) {
#pragma unroll
    for (int n = 0; n < kSlabs; ++n) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[n][j * 4] *= corr_a;
        o[n][j * 4 + 1] *= corr_a;
        o[n][j * 4 + 2] *= corr_b;
        o[n][j * 4 + 3] *= corr_b;
      }
    }
#pragma unroll
    for (int j = 0; j < kKv / 16; ++j) {
      pf[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
      pf[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pf[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pf[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
  };

  // this warp is done reading tile kt's K (or V): its stage may refill
  auto release = [&](uint32_t empty, int kt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (kt % kStages));
  };

  auto parity = [](int kt) {
    return static_cast<uint32_t>((kt / kStages) & 1);
  };

  // Software pipeline within the warpgroup: Q K^T of tile kt is issued,
  // then P V of tile kt - 1, and tile kt's softmax runs while that P V
  // is still on the tensor cores; O is rescaled and P repacked once it
  // is done. That holds S, P and O in registers at once; where a
  // consumer has too few for that (two blocks an SM at D = 64), the
  // tiles run one after the other. The tiles a consumer computes on are
  // a prefix of the block's (kt < n_mine), so the loops over them issue
  // their products unconditionally (ptxas serializes every wgmma where
  // it cannot tell how many groups a wait leaves in flight); past it,
  // the consumer only waits for each tile and releases it.
  if constexpr (kPipelined) {
    if (n_mine > 0) {
      float corr_a, corr_b;
      mbar_wait(fullK, 0);
      issue_qk(0);
      wgmma_wait<0>();
      release(emptyK, 0);
      fence_regs(s);
      softmax(0, corr_a, corr_b);
      rescale_and_pack(corr_a, corr_b);
      for (int kt = 1; kt < n_mine; ++kt) {
        mbar_wait(fullK + 8 * (kt % kStages), parity(kt));
        issue_qk(kt);
        mbar_wait(fullV + 8 * ((kt - 1) % kStages), parity(kt - 1));
        issue_pv(kt - 1);
        // Q K^T of tile kt done; P V of tile kt - 1 may still run
        wgmma_wait<1>();
        release(emptyK, kt);
        fence_regs(s);
        softmax(kt, corr_a, corr_b);
        wgmma_wait<0>();
        release(emptyV, kt - 1);
#pragma unroll
        for (int n = 0; n < kSlabs; ++n) fence_regs(o[n]);
        fence_regs(pf);
        rescale_and_pack(corr_a, corr_b);
      }
      mbar_wait(fullV + 8 * ((n_mine - 1) % kStages), parity(n_mine - 1));
      issue_pv(n_mine - 1);
      wgmma_wait<0>();
      release(emptyV, n_mine - 1);
#pragma unroll
      for (int n = 0; n < kSlabs; ++n) fence_regs(o[n]);
    }
  } else {
    for (int kt = 0; kt < n_mine; ++kt) {
      float corr_a, corr_b;
      mbar_wait(fullK + 8 * (kt % kStages), parity(kt));
      issue_qk(kt);
      wgmma_wait<0>();
      release(emptyK, kt);
      fence_regs(s);
      softmax(kt, corr_a, corr_b);
      rescale_and_pack(corr_a, corr_b);
      mbar_wait(fullV + 8 * (kt % kStages), parity(kt));
      issue_pv(kt);
      wgmma_wait<0>();
      release(emptyV, kt);
#pragma unroll
      for (int n = 0; n < kSlabs; ++n) fence_regs(o[n]);
    }
  }
  for (int kt = n_mine; kt < n_tiles; ++kt) {
    mbar_wait(fullK + 8 * (kt % kStages), parity(kt));
    release(emptyK, kt);
    mbar_wait(fullV + 8 * (kt % kStages), parity(kt));
    release(emptyV, kt);
  }

  if (!active) return;
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  const float inv_a = 1.f / l_a;
  const float inv_b = 1.f / l_b;
  uint16_t* out = static_cast<uint16_t*>(p.o) + b * p.o_sb + hh * p.o_sh;
  uint16_t* oa = out + static_cast<long long>(ra) * p.o_sl + t4 * 2;
  uint16_t* ob = out + static_cast<long long>(rb) * p.o_sl + t4 * 2;
#pragma unroll
  for (int n = 0; n < kSlabs; ++n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n * kSlab + j * 8;
      *reinterpret_cast<uint32_t*>(oa + col) =
          pack_bf16(o[n][j * 4] * inv_a, o[n][j * 4 + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(ob + col) =
          pack_bf16(o[n][j * 4 + 2] * inv_b, o[n][j * 4 + 3] * inv_b);
    }
  }
  if (p.lse != nullptr && t4 == 0) {
    float* lse = p.lse + static_cast<long long>(bh) * p.lq;
    lse[ra] = (m_a + log2f(l_a)) * kLn2;
    lse[rb] = (m_b + log2f(l_b)) * kLn2;
  }
}

// ------------------------------------------------------------- host --
struct Maps {
  CUtensorMap q, k, v;
};

// 0, or the 1000 + n code of what the kernel does not take
int encode_maps(Maps* maps, const void* q, const void* k, const void* v,
                int batch, int heads, int lq, int lk, int d,
                const long long* strides /* q, k, v: sb, sh, sl */) {
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const long long* st = strides + 3 * i;
    if (tma_layout(ptrs[i], st[0], st[1], st[2])) return 1007;
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 1008;
  const int kv = d == 64 ? Cfg<64>::kKv : d == 128 ? Cfg<128>::kKv
      : d == 192 ? Cfg<192>::kKv : Cfg<256>::kKv;
  const bool ok =
      encode(fn, &maps->q, q, batch, heads, lq, d, strides[0], strides[1],
             strides[2], kRows)
      && encode(fn, &maps->k, k, batch, heads, lk, d, strides[3], strides[4],
                strides[5], kv)
      && encode(fn, &maps->v, v, batch, heads, lk, d, strides[6], strides[7],
                strides[8], kv);
  return ok ? 0 : 1008;
}

template <int D>
cudaError_t launch(const Maps& maps, const Params& p, int batch_heads,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.lq + kRows - 1) / kRows, batch_heads);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      maps.q, maps.k, maps.v, p);
  return cudaGetLastError();
}

}  // namespace

// zoo_flash_attn_fwd's interface without the mask: dtype must be 1
// (bfloat16) and d one of 64, 128, 192, 256. Returns a cudaError_t (0 =
// launched); 1000 + n flags a call the kernel does not take (1001 Lq or
// Lk not a multiple of 64, 1002 causal with Lq > Lk, 1003 B*H above
// 65535, 1004 the head dim, 1005 the dtype, 1007 an address or stride
// TMA cannot take, 1008 no tensor map).
extern "C" int zoo_flash_attn_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int batch, int heads, int lq, int lk, int d,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    float scale, int causal, void* stream) {
  if (lq % 64 || lk % 64) return 1001;
  if (causal && lq > lk) return 1002;
  if (batch * heads > 65535) return 1003;
  if (d != 64 && d != 128 && d != 192 && d != 256) return 1004;
  if (dtype != 1) return 1005;
  const long long strides[9] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                                v_sb, v_sh, v_sl};
  Maps maps;
  const int rc = encode_maps(&maps, q, k, v, batch, heads, lq, lk, d, strides);
  if (rc != 0) return rc;
  Params p;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.h = heads; p.lq = lq; p.lk = lk;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (d) {
    case 64: return launch<64>(maps, p, bh, s);
    case 128: return launch<128>(maps, p, bh, s);
    case 192: return launch<192>(maps, p, bh, s);
    default: return launch<256>(maps, p, bh, s);
  }
}

// Host nanoseconds to encode one call's three tensor maps, the mean of
// `iters` encodings (the arguments are zoo_flash_attn_fwd_sm90's); a
// negative value is the 1000 + n code of a call the kernel does not take.
extern "C" double zoo_flash_attn_fwd_sm90_map_ns(
    const void* q, const void* k, const void* v, int batch, int heads,
    int lq, int lk, int d,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl, int iters) {
  const long long strides[9] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                                v_sb, v_sh, v_sl};
  Maps maps;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    const int rc = encode_maps(&maps, q, k, v, batch, heads, lq, lk, d,
                               strides);
    if (rc != 0) return -rc;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / iters;
}
