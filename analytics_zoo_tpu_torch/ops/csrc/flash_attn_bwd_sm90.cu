// Flash-attention backward (K2 dQ and delta, K3 dK/dV) for Hopper, sm_90a:
// the bf16 kernels without a key-padding mask at head dims 64, 128, 192 and
// 256, built on TMA, mbarriers, a producer warpgroup and wgmma (the parts
// of flash_attn_fwd_sm90.cu, shared through flash_attn_sm90.cuh).
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_dq_kernel`
// (:209, launched at :327) and `_flash_dkv_kernel` (:249, launched at :345),
// both driven by `_flash_bwd` (:305), plus the rowsum delta = rowsum(dO * O)
// that `_flash_bwd` takes in plain jnp (:316-319), for those calls. Given the
// forward's Q, K, V, O, its per-row logsumexp and dO on [B, H, L, D]:
//   P = exp(scale * Q K^T - lse),  dS = P * (dO V^T - delta) * scale (bf16)
//   dQ = dS K,  dK = dS^T Q,  dV = P~^T dO  (P~ = P rounded to bf16)
// f32 accumulation, bf16 outputs, a causal mask aligned bottom-right (key j
// is visible to query i when j <= i + Lk - Lq), q/k/v/dO with the caller's
// strides (views into a fused projection), lse and delta [B*H, Lq] f32.
// Two kernels, K2 then K3 on one stream (K3 reads the delta K2 wrote), as
// the reference and the older port run them: no atomics, deterministic.
//
// What bounds them. Per (b, h) K2 reads Q, K, V, O, dO once and writes dQ
// and delta against 6 * D flops per visible (query, key) pair (S, dP, dQ);
// K3 reads Q, K, V, dO, lse, delta and writes dK, dV against 8 * D (S^T,
// dP^T, dV, dK). At the BERT-base trained call [48,12,384,64] that is about
// 190 and 250 flops a byte, under the card's ridge of about 295: bound by
// bytes, 0.0512 ms each (chip_smoke.py `bounds`). At the GPT-J-width LM's
// call [4,16,2048,256] causal: bound by the tensor cores, 0.2086 ms (K2)
// and 0.2781 ms (K3) at 989 TFLOP/s.
//
// What the design does about it. The kernels it retires (the mma.sync
// templates of flash_attn_bwd.cuh at these calls) loaded every tile with
// every thread and a __syncthreads() pair, multiplied with
// mma.sync.m16n8k16, re-read fragments for each 16-wide slice of D,
// gathered the row-contracted B fragments two rows at a time, held 254
// registers at D = 256, and K3 there computed S^T and dP^T twice (12 * D
// flops a pair). Here:
//   * A block has three warpgroups (384 threads). Warpgroup 0 is the
//     producer: it gives back its registers (setmaxnreg.dec) and one thread
//     issues every load as a TMA copy (cp.async.bulk.tensor, 4-D tensor maps
//     with the caller's strides, 128-byte swizzle) that completes on an
//     mbarrier; rings of stages have a "full" barrier (TMA's transaction
//     count) and an "empty" one (an arrival from each consumer warp).
//     Warpgroups 1 and 2 are consumers (setmaxnreg.inc). setmaxnreg.inc
//     draws on the block's own pool, so the static_asserts of DqTiles and
//     DkvTiles keep the three warpgroups inside what the block started with.
//   * K2: a consumer owns 64 q rows (128 a block). Its Q and dO arrive once;
//     it computes delta for its rows from O and dO in device memory (the
//     four threads of a quad share a row) before the loop and writes it for
//     K3. The ring carries the kv tiles of 64 keys, K and V apart (separate
//     barriers: V is released after dP, K only after dQ; K's ring is the
//     deeper). A tile: S = Q K^T and dP = dO V^T are SS wgmmas (A and B
//     K-major from shared memory) committed as two groups, so P's
//     exponentials run while dP is on the tensor cores; dS is formed in the
//     accumulator layout with each row's lse and delta and re-packed as bf16
//     A fragments; dQ += dS K is an RS wgmma of N = D with K read MN-major
//     (the transpose flag, as K1's P V reads V). dQ is D/2 f32 registers a
//     thread (128 at D = 256) beside S and dP (32 each).
//   * K3: keys are on the rows. The block's K and V arrive once; the ring
//     carries q tiles of 64 rows: Q, dO, and their lse and delta (1-D bulk
//     copies), which are per column of S^T. S^T = K Q^T and dP^T = V dO^T are
//     SS wgmmas; P~^T and dS^T come out in the accumulator layout and are
//     the A operands of dV += P~^T dO and dK += dS^T Q, with dO and Q read
//     MN-major from the same tiles that were K-major B a moment before.
//     At D = 128 a consumer owns 64 keys (128 a block) and holds dK and
//     dV, D f32 registers a thread, beside S^T and dP^T (64).
//   * K3 at D = 192 and 256: dK and dV together (D registers) and S^T and
//     dP^T (64) pass the 240 a consumer gets. The two consumers share the
//     block's 64 keys and split the work by product: consumer 0 computes
//     S^T, forms P^T (f32) and accumulates dV += P~^T dO; consumer 1
//     computes dP^T, takes P^T from consumer 0 through shared memory (two
//     16 KB buffers, in the accumulator layout, float4 a thread; named
//     barriers in both directions), forms dS^T and accumulates dK += dS^T Q.
//     Each holds D/2 accumulator registers beside 32, and each pair costs
//     8 * D flops, as at D = 128. Splitting the q columns of S^T and dP^T
//     and then D between the consumers with SS wgmmas of N = D/2 would
//     give each 96 columns at D = 192, not a whole number of the 64-column
//     atoms an MN-major B is read in under the 128-byte swizzle (128 + 64
//     would leave one consumer a third idle). Both consumers computing all
//     of S^T and dP^T, each accumulating dK and dV for half of D (12 * D
//     flops a pair), took 0.71 ms at [4,16,2048,256] against this split's
//     0.53 (H100 80GB HBM3, 700 W), so it went. At D = 64 the same split
//     runs two blocks an SM (DkvCfg).
//   * Causal: K2 never loads kv tiles above a block's last row and K3 never
//     loads q tiles whose rows all lie above its first key; a consumer's
//     tiles are a prefix (K2) or suffix (K3) of the block's, so its loops
//     issue their wgmmas unconditionally (ptxas serializes every wgmma
//     issued under an `if`); past them it only waits for each tile and
//     releases it. Only tiles that cross the diagonal are masked element by
//     element. K2's blocks run longest first (q blocks in reverse order);
//     K3's do by their order (key blocks from the first).
//   * Lq % 128 == 64 (K2) or Lk % 128 == 64 (K3 at D = 128): the last
//     block's second consumer has no rows. It reaches every barrier and
//     stores nothing; TMA zero-fills what it reads past Lq and Lk.
//   * No wait traps on a timeout (a trap made ptxas serialize every wgmma
//     of K1 and spill).
// Later work: one fused kernel with dQ accumulated across key blocks, the
// next tile's S and dP issued while this tile's dQ (or dK, dV) runs, a
// persistent grid, and the outputs stored through shared memory and TMA.
//
// flash_attn_bwd_dq.cu and flash_attn_bwd_dkv.cu keep the masked bf16
// calls, the other head dims up to 128 (K5b), every f32 call and bf16 above
// 256.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libzoo_flash_attn_bwd_sm90.so \
//        flash_attn_bwd_sm90.cu

#include "flash_attn_sm90.cuh"

namespace {

constexpr int kDqRows = 128;       // K2: q rows a block, two consumers of 64
constexpr int kKvTile = 64;        // K2: keys a tile of the ring
constexpr int kQTile = 64;         // K3: q rows a tile of the ring
constexpr int kEmptyArrivals = 8;  // one a consumer warp
// K3 at D > 128: named barriers of the P^T exchange between the two
// consumers, one a buffer ("full": consumer 0 wrote it; "empty": consumer 1
// read it), over both consumer warpgroups
constexpr uint32_t kXFull = 1, kXEmpty = 3, kPair = 256;

// K2 by head dim: K and V stages of the ring, blocks an SM, and the
// registers a producer and a consumer thread keep after setmaxnreg
template <int SK, int SV, int BLOCKS, int PRODUCER, int CONSUMER>
struct DqTiles {
  static constexpr int kStagesK = SK, kStagesV = SV, kBlocks = BLOCKS;
  static constexpr int kProducerRegs = PRODUCER, kConsumerRegs = CONSUMER;
  // setmaxnreg.inc takes registers from the block's own pool, which
  // holds what the block started with: more would wait forever
  static_assert(PRODUCER + 2 * CONSUMER <= 3 * launch_regs(BLOCKS),
                "registers");
};
// at D = 256: Q and dO 2 x 64 KB, K 2 x 32 KB, V 32 KB: 225 KB of the 227
template <int D> struct DqCfg;
template <> struct DqCfg<64> : DqTiles<3, 3, 1, 24, 240> {};
template <> struct DqCfg<128> : DqTiles<3, 2, 1, 24, 240> {};
template <> struct DqCfg<192> : DqTiles<2, 2, 1, 24, 240> {};
template <> struct DqCfg<256> : DqTiles<2, 1, 1, 24, 240> {};

// dynamic shared memory of K2: 1024 bytes of alignment slack, Q, dO, the K
// and V stages, the barriers (Q, then K full, V full, K empty, V empty)
template <int D>
constexpr int dq_smem_bytes() {
  return 1024
      + (2 * kDqRows + (DqCfg<D>::kStagesK + DqCfg<D>::kStagesV) * kKvTile)
          * D * 2
      + 8 * (1 + 2 * (DqCfg<D>::kStagesK + DqCfg<D>::kStagesV));
}

// K3 by head dim: keys a block (two consumers of 64 each, or 64 shared by
// both, which then split the work by product), q-tile stages, blocks an SM
// and registers as DqTiles'. At D = 64 the split runs two blocks an SM
// (104 registers a consumer: D/2 accumulators beside S^T and P^T), which
// hides one block's loads behind the other's work; two blocks of K2 there
// (dQ, S and dP in 104) spilled and serialized its wgmmas.
template <int KEYS, int STAGES, int BLOCKS, int PRODUCER, int CONSUMER>
struct DkvTiles {
  static constexpr int kKeys = KEYS, kStages = STAGES, kBlocks = BLOCKS;
  static constexpr int kProducerRegs = PRODUCER, kConsumerRegs = CONSUMER;
  static constexpr bool kSplit = KEYS == 64;
  static_assert(KEYS == 64 || KEYS == 128, "keys a block");
  static_assert(PRODUCER + 2 * CONSUMER <= 3 * launch_regs(BLOCKS),
                "registers");
};
// at D = 256: K and V 2 x 32 KB, 2 stages of Q and dO (2 x 32 KB), the
// exchange 2 x 16 KB: 226 KB of the 227
template <int D> struct DkvCfg;
template <> struct DkvCfg<64> : DkvTiles<64, 3, 2, 24, 104> {};
template <> struct DkvCfg<128> : DkvTiles<128, 3, 1, 24, 240> {};
template <> struct DkvCfg<192> : DkvTiles<64, 2, 1, 24, 240> {};
template <> struct DkvCfg<256> : DkvTiles<64, 2, 1, 24, 240> {};

// dynamic shared memory of K3: alignment slack, K, V, the stages of Q and
// dO, the exchange buffers (split), each stage's lse and delta, the
// barriers (K and V, then full and empty a stage)
template <int D>
constexpr int dkv_smem_bytes() {
  using C = DkvCfg<D>;
  return 1024 + 2 * C::kKeys * D * 2 + C::kStages * 2 * kQTile * D * 2
      + (C::kSplit ? 2 * 64 * kQTile * 4 : 0) + C::kStages * 2 * kQTile * 4
      + 8 * (1 + 2 * C::kStages);
}

struct Params {
  const void* o;                 // K2: O and dO, read for delta
  const void* dout;
  const float* lse;              // [B*H, Lq], natural log
  float* delta;                  // [B*H, Lq]: written by K2, read by K3
  void* dq;
  void* dk;
  void* dv;
  long long o_sb, o_sh, o_sl;    // element strides: batch, head, seq
  long long do_sb, do_sh, do_sl;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  int h, lq, lk;
  float scale;                   // softmax scale
  float scale_log2;              // scale * log2(e)
  int causal;
};

// this thread's share of rowsum(x * y) over a bf16 row of D: the 16-byte
// chunks part, part + 4, ... (a quad's four threads take one row)
template <int D>
__device__ __forceinline__ float row_dot(const uint16_t* x, const uint16_t* y,
                                         int part) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const int at = (i * 4 + part) * 8;
    const uint4 xv = *reinterpret_cast<const uint4*>(x + at);
    const uint4 yv = *reinterpret_cast<const uint4*>(y + at);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(x2[j]);
      const float2 e = __bfloat1622float2(y2[j]);
      acc = fmaf(a.x, e.x, acc);
      acc = fmaf(a.y, e.y, acc);
    }
  }
  return acc;
}

// an accumulator of 64 rows x 64 columns packed as the bf16 A fragments of
// four k-steps of 16 (columns [16j, 16j + 16) are k-step j's fragment)
__device__ __forceinline__ void pack_a(uint32_t (&f)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j][0] = pack_bf16(x[8 * j], x[8 * j + 1]);
    f[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    f[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    f[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// D[64 x 64] = A[64 x D] B[64 x D]^T, A and B K-major tiles of D/64 slabs in
// shared memory (A's slabs A_ROWS rows apart, B's 64), as one commit group
template <int D, int A_ROWS>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a_base,
                                         uint32_t b_base) {
  wgmma_fence();
  const uint64_t da = sw128_desc(a_base, 16, 1024);
  const uint64_t db = sw128_desc(b_base, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16-byte units: slab kk / 4, 32 bytes a k-step within its rows
    const uint32_t step = (kk & 3) * 2;
    const uint32_t a_off = (kk >> 2) * (A_ROWS * kSlabRow / 16) + step;
    const uint32_t b_off = (kk >> 2) * (64 * kSlabRow / 16) + step;
    wgmma_ss_n64(d, da, a_off, db, b_off, kk > 0);
  }
  wgmma_commit();
}

// D[64 x N] += A[64 x 64] B[64 x N], A as bf16 fragments in registers, B
// a tile of 64 rows (the K dimension) in slabs of 64 columns, MN-major
// (the slabs are the leading byte offset apart), as one commit group
template <int N>
__device__ __forceinline__ void issue_rs(float (&d)[N / 2],
                                         uint32_t (&a)[4][4],
                                         uint32_t b_base) {
  fence_regs(d);
  fence_regs(a);
  wgmma_fence();
  const uint64_t db = sw128_desc(b_base, 64 * kSlabRow, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<N>(d, a[kk], db, kk * 16 * (kSlabRow / 16));
  }
  wgmma_commit();
}

// this warp is done with stage `stage` of a ring: it may refill
__device__ __forceinline__ void release(uint32_t empty, int stage,
                                        int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + 8 * stage);
}

// ------------------------------------------------------------------ K2 --
template <int D>
__global__ void __launch_bounds__(kThreads, DqCfg<D>::kBlocks)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const Params p) {
  using C = DqCfg<D>;
  constexpr int kSK = C::kStagesK;
  constexpr int kSV = C::kStagesV;
  constexpr int kSlabs = D / kSlab;
  constexpr int kRowBytes = kDqRows * D * 2;  // Q (or dO) of the block
  constexpr int kKvBytes = kKvTile * D * 2;   // one K (or V) tile

  extern __shared__ uint8_t smem_raw[];
  // slabs start on 1024-byte boundaries, where the 128B swizzle repeats
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sDO = sQ + kRowBytes;
  const uint32_t sK = sDO + kRowBytes;              // kSK K tiles
  const uint32_t sV = sK + kSK * kKvBytes;          // kSV V tiles
  const uint32_t barQ = sV + kSV * kKvBytes;        // 8 bytes a barrier
  const uint32_t fullK = barQ + 8;
  const uint32_t fullV = fullK + 8 * kSK;
  const uint32_t emptyK = fullV + 8 * kSV;
  const uint32_t emptyV = emptyK + 8 * kSK;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int q0 = qt * kDqRows;
  const int offset = p.lk - p.lq;

  // kv tiles this block walks: up to its last real row's last key
  int n_tiles = p.lk / kKvTile;
  if (p.causal) {
    const int last_row = min(q0 + kDqRows, p.lq) - 1;
    n_tiles = min(n_tiles, (last_row + offset) / kKvTile + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < kSK; ++s) {
      mbar_init(fullK + 8 * s, 1);
      mbar_init(emptyK + 8 * s, kEmptyArrivals);
    }
    for (int s = 0; s < kSV; ++s) {
      mbar_init(fullV + 8 * s, 1);
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
                 :: "n"(C::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(barQ, 2 * kRowBytes);
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        tma_load(sQ + s * kDqRows * kSlabRow, &tq, barQ, s * kSlab, q0, hh, b);
        tma_load(sDO + s * kDqRows * kSlabRow, &tdo, barQ, s * kSlab, q0, hh,
                 b);
      }
      // K, then V of each tile, the order the consumers use them in; each
      // waits for its stage's previous tile to be released (the first
      // round finds every stage empty)
      auto load = [&](const CUtensorMap* map, uint32_t full, uint32_t empty,
                      uint32_t base, int stages, int kt) {
        const int stage = kt % stages;
        mbar_wait(empty + 8 * stage, ((kt / stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * stage, kKvBytes);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(base + stage * kKvBytes + s * kKvTile * kSlabRow, map,
                   full + 8 * stage, s * kSlab, kt * kKvTile, hh, b);
        }
      };
      for (int kt = 0; kt < n_tiles; ++kt) {
        load(&tk, fullK, emptyK, sK, kSK, kt);
        load(&tv, fullV, emptyV, sV, kSV, kt);
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(C::kConsumerRegs));
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
  // tiles this consumer computes on: all of the block's, or, causal, up
  // to its own last row's last key; none past Lq
  int n_mine = active ? n_tiles : 0;
  if (active && p.causal) {
    n_mine = min(n_tiles, (r0 + 63 + offset) / kKvTile + 1);
  }
  // the last visible key of each of the two rows, and of the consumer's
  // first row (the one that sees fewest)
  const int lim_a = p.causal ? min(ra + offset, p.lk - 1) : p.lk - 1;
  const int lim_b = p.causal ? min(rb + offset, p.lk - 1) : p.lk - 1;
  const int lim_first = p.causal ? min(r0 + offset, p.lk - 1) : p.lk - 1;

  // delta = rowsum(dO * O) in f32 of the thread's two rows (written out
  // for K3 by one thread of the quad), and their lse in the log2 domain
  float lse_a = 0.f, lse_b = 0.f, del_a = 0.f, del_b = 0.f;
  if (active) {
    const uint16_t* o =
        static_cast<const uint16_t*>(p.o) + b * p.o_sb + hh * p.o_sh;
    const uint16_t* dout =
        static_cast<const uint16_t*>(p.dout) + b * p.do_sb + hh * p.do_sh;
    del_a = row_dot<D>(o + ra * p.o_sl, dout + ra * p.do_sl, t4);
    del_b = row_dot<D>(o + rb * p.o_sl, dout + rb * p.do_sl, t4);
    del_a += __shfl_xor_sync(0xffffffffu, del_a, 1);
    del_a += __shfl_xor_sync(0xffffffffu, del_a, 2);
    del_b += __shfl_xor_sync(0xffffffffu, del_b, 1);
    del_b += __shfl_xor_sync(0xffffffffu, del_b, 2);
    const long long at = static_cast<long long>(bh) * p.lq;
    if (t4 == 0) {
      p.delta[at + ra] = del_a;
      p.delta[at + rb] = del_b;
    }
    lse_a = p.lse[at + ra] * kLog2e;
    lse_b = p.lse[at + rb] * kLog2e;
  }

  float acc[D / 2];        // dQ
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];     // S (then P), dP of one tile
  uint32_t df[4][4];       // dS as bf16 A fragments

  if (active) mbar_wait(barQ, 0);
  // this consumer's 64 rows of Q and dO
  const uint32_t q_base = sQ + c * 64 * kSlabRow;
  const uint32_t do_base = sDO + c * 64 * kSlabRow;

  // The tiles a consumer computes on are a prefix of the block's (kt <
  // n_mine), so the loop issues its products unconditionally (ptxas
  // serializes every wgmma where it cannot tell how many groups a wait
  // leaves in flight); past it, the consumer only waits and releases.
  for (int kt = 0; kt < n_mine; ++kt) {
    const int sk = kt % kSK;
    const int sv = kt % kSV;
    const uint32_t k_base = sK + sk * kKvBytes;
    mbar_wait(fullK + 8 * sk, (kt / kSK) & 1);
    issue_ss<D, kDqRows>(s, q_base, k_base);
    mbar_wait(fullV + 8 * sv, (kt / kSV) & 1);
    issue_ss<D, kDqRows>(dp, do_base, sV + sv * kKvBytes);
    // S done; dP may still run
    wgmma_wait<1>();
    fence_regs(s);
    // P = 2^(scale * log2(e) * S - lse * log2(e)); only a tile that
    // crosses the diagonal is masked
    const int key0 = kt * kKvTile;
    const bool edge = key0 + kKvTile - 1 > lim_first;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = fast_exp2(
            fmaf(s[j * 4 + e], p.scale_log2, -((e < 2) ? lse_a : lse_b)));
        if (edge && key0 + j * 8 + t4 * 2 + (e & 1) > ((e < 2) ? lim_a
                                                              : lim_b)) {
          pr = 0.f;
        }
        s[j * 4 + e] = pr;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    release(emptyV, sv, lane);
    // dS = P (dP - delta) scale
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = s[i] * (dp[i] - ((i & 2) ? del_b : del_a)) * p.scale;
    }
    pack_a(df, s);
    issue_rs<D>(acc, df, k_base);
    wgmma_wait<0>();
    fence_regs(acc);
    release(emptyK, sk, lane);
  }
  for (int kt = n_mine; kt < n_tiles; ++kt) {
    mbar_wait(fullK + 8 * (kt % kSK), (kt / kSK) & 1);
    release(emptyK, kt % kSK, lane);
    mbar_wait(fullV + 8 * (kt % kSV), (kt / kSV) & 1);
    release(emptyV, kt % kSV, lane);
  }

  if (!active) return;
  uint16_t* dq = static_cast<uint16_t*>(p.dq) + b * p.dq_sb + hh * p.dq_sh;
  uint16_t* qa = dq + static_cast<long long>(ra) * p.dq_sl + t4 * 2;
  uint16_t* qb = dq + static_cast<long long>(rb) * p.dq_sl + t4 * 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(qa + j * 8) =
        pack_bf16(acc[j * 4], acc[j * 4 + 1]);
    *reinterpret_cast<uint32_t*>(qb + j * 8) =
        pack_bf16(acc[j * 4 + 2], acc[j * 4 + 3]);
  }
}

// ------------------------------------------------------------------ K3 --
// the accumulator rows (keys ka, kb) of 64 x D values from column col0, as
// bf16 into a [L, D] row-major output of row stride sl
template <int N>
__device__ __forceinline__ void store_rows(uint16_t* out, long long sl,
                                           int ka, int kb, int col0, int t4,
                                           const float (&x)[N / 2]) {
  uint16_t* ra = out + static_cast<long long>(ka) * sl + col0 + t4 * 2;
  uint16_t* rb = out + static_cast<long long>(kb) * sl + col0 + t4 * 2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    *reinterpret_cast<uint32_t*>(ra + j * 8) =
        pack_bf16(x[j * 4], x[j * 4 + 1]);
    *reinterpret_cast<uint32_t*>(rb + j * 8) =
        pack_bf16(x[j * 4 + 2], x[j * 4 + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, DkvCfg<D>::kBlocks)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const Params p) {
  using C = DkvCfg<D>;
  constexpr int kKeys = C::kKeys;
  constexpr int kStages = C::kStages;
  constexpr bool kSplit = C::kSplit;
  constexpr int kSlabs = D / kSlab;
  constexpr int kKeyBytes = kKeys * D * 2;   // K (or V) of the block
  constexpr int kQBytes = kQTile * D * 2;    // one Q (or dO) tile
  constexpr int kXBytes = 64 * kQTile * 4;   // one P^T exchange buffer
  constexpr int kRowF32 = kQTile * 4;        // one tile's lse (or delta)

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + kKeyBytes;
  const uint32_t sQ = sV + kKeyBytes;       // stage s: Q, then dO
  const uint32_t sX = sQ + kStages * 2 * kQBytes;
  const uint32_t sRow = sX + (kSplit ? 2 * kXBytes : 0);  // lse, delta
  const uint32_t barKV = sRow + kStages * 2 * kRowF32;
  const uint32_t full = barKV + 8;
  const uint32_t empty = full + 8 * kStages;
  // the generic address of shared-memory address a
  auto at = [&](uint32_t a) { return smem_raw + (a - raw); };

  const int k0 = blockIdx.x * kKeys;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int offset = p.lk - p.lq;
  const int n_qt = p.lq / kQTile;
  // the first q tile with a row that sees the block's first key (the last
  // row sees every key, so there is one)
  const int first = p.causal ? min(n_qt - 1, max(0, k0 - offset) / kQTile)
                             : 0;
  const int n_tiles = n_qt - first;

  if (threadIdx.x == 0) {
    mbar_init(barKV, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(C::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(barKV, 2 * kKeyBytes);
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        tma_load(sK + s * kKeys * kSlabRow, &tk, barKV, s * kSlab, k0, hh, b);
        tma_load(sV + s * kKeys * kSlabRow, &tv, barKV, s * kSlab, k0, hh, b);
      }
      const long long row0 = static_cast<long long>(bh) * p.lq;
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % kStages;
        const int q0 = (first + i) * kQTile;
        const uint32_t bar = full + 8 * stage;
        const uint32_t qs = sQ + stage * 2 * kQBytes;
        const uint32_t rs = sRow + stage * 2 * kRowF32;
        mbar_wait(empty + 8 * stage, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar, 2 * kQBytes + 2 * kRowF32);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(qs + s * kQTile * kSlabRow, &tq, bar, s * kSlab, q0, hh, b);
          tma_load(qs + kQBytes + s * kQTile * kSlabRow, &tdo, bar, s * kSlab,
                   q0, hh, b);
        }
        bulk_load(rs, p.lse + row0 + q0, kRowF32, bar);
        bulk_load(rs + kRowF32, p.delta + row0 + q0, kRowF32, bar);
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(C::kConsumerRegs));
  const int c = wg - 1;
  const int t = threadIdx.x - wg * 128;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // this consumer's keys: its own 64, or the block's 64 (split)
  const int kc0 = kSplit ? k0 : k0 + c * 64;
  const int ka = kc0 + warp * 16 + g;    // the two keys a thread holds
  const int kb = ka + 8;
  const bool active = kc0 < p.lk;
  // the tiles it computes on are a suffix of the block's: from the first
  // whose rows see its first key; none past Lk
  int first_mine = active ? first : n_qt;
  if (active && p.causal) {
    first_mine = max(first, min(n_qt, max(0, kc0 - offset) / kQTile));
  }
  const int n_skip = first_mine - first;   // waited for and released only

  // A operand rows: this consumer's 64 keys of K and V (slabs kKeys rows
  // apart)
  const uint32_t k_rows = sK + (kSplit ? 0 : c * 64 * kSlabRow);
  const uint32_t v_rows = sV + (kSplit ? 0 : c * 64 * kSlabRow);
  const float scale = p.scale;
  const float scale_log2 = p.scale_log2;

  for (int i = 0; i < n_skip; ++i) {
    mbar_wait(full + 8 * (i % kStages), (i / kStages) & 1);
    release(empty, i % kStages, lane);
  }
  if (active) mbar_wait(barKV, 0);

  float s[32];             // S^T (then P^T; or dP^T, then dS^T)
  uint32_t pf[4][4];       // as bf16 A fragments

  if constexpr (!kSplit) {
    float dp[32];          // dP^T, then dS^T
    uint32_t df[4][4];
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    for (int i = n_skip; i < n_tiles; ++i) {
      const int stage = i % kStages;
      const int q0 = (first + i) * kQTile;
      const uint32_t qs = sQ + stage * 2 * kQBytes;
      const uint32_t ds = qs + kQBytes;
      const float* lse = reinterpret_cast<const float*>(
          at(sRow + stage * 2 * kRowF32));
      const float* del = lse + kQTile;
      mbar_wait(full + 8 * stage, (i / kStages) & 1);
      issue_ss<D, kKeys>(s, k_rows, qs);
      issue_ss<D, kKeys>(dp, v_rows, ds);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // P^T and dS^T; the columns are queries. Only a tile whose first
      // row does not see the consumer's last key is masked
      const bool edge = p.causal && kc0 + 63 > q0 + offset;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j * 8 + t4 * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
        const float2 d2 = *reinterpret_cast<const float2*>(del + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = ((e & 1) ? l2.y : l2.x) * kLog2e;
          const float dv = (e & 1) ? d2.y : d2.x;
          float pr = fast_exp2(fmaf(s[j * 4 + e], scale_log2, -lv));
          if (edge && ((e < 2) ? ka : kb) > q0 + col + (e & 1) + offset) {
            pr = 0.f;
          }
          s[j * 4 + e] = pr;
          dp[j * 4 + e] = pr * (dp[j * 4 + e] - dv) * scale;
        }
      }
      pack_a(pf, s);
      pack_a(df, dp);
      issue_rs<D>(acc_v, pf, ds);
      issue_rs<D>(acc_k, df, qs);
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      release(empty, stage, lane);
    }
    if (!active) return;
    store_rows<D>(static_cast<uint16_t*>(p.dk) + b * p.dk_sb + hh * p.dk_sh,
                  p.dk_sl, ka, kb, 0, t4, acc_k);
    store_rows<D>(static_cast<uint16_t*>(p.dv) + b * p.dv_sb + hh * p.dv_sh,
                  p.dv_sl, ka, kb, 0, t4, acc_v);
  } else {
    // consumer 0: S^T, P^T, dV += P~^T dO; consumer 1: dP^T, dS^T (with
    // consumer 0's P^T), dK += dS^T Q. The same products, so the same
    // code with other operands
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t a_rows = c == 0 ? k_rows : v_rows;
    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % kStages;
      const int q0 = (first + i) * kQTile;
      const uint32_t qs = sQ + stage * 2 * kQBytes;
      const uint32_t ds = qs + kQBytes;
      const float* lse = reinterpret_cast<const float*>(
          at(sRow + stage * 2 * kRowF32));
      const float* del = lse + kQTile;
      const uint32_t xb = i & 1;
      float4* x = reinterpret_cast<float4*>(at(sX + xb * kXBytes));
      mbar_wait(full + 8 * stage, (i / kStages) & 1);
      issue_ss<D, kKeys>(s, a_rows, c == 0 ? qs : ds);
      wgmma_wait<0>();
      fence_regs(s);
      if (c == 0) {
        const bool edge = p.causal && kc0 + 63 > q0 + offset;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = j * 8 + t4 * 2;
          const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lv = ((e & 1) ? l2.y : l2.x) * kLog2e;
            float pr = fast_exp2(fmaf(s[j * 4 + e], scale_log2, -lv));
            if (edge && ((e < 2) ? ka : kb) > q0 + col + (e & 1) + offset) {
              pr = 0.f;
            }
            s[j * 4 + e] = pr;
          }
        }
        // the buffer is free once consumer 1 read it two tiles ago
        if (i >= 2) named_sync(kXEmpty + xb, kPair);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          x[j * 128 + t] = make_float4(s[j * 4], s[j * 4 + 1], s[j * 4 + 2],
                                       s[j * 4 + 3]);
        }
        named_arrive(kXFull + xb, kPair);
      } else {
        named_sync(kXFull + xb, kPair);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = j * 8 + t4 * 2;
          const float2 d2 = *reinterpret_cast<const float2*>(del + col);
          const float4 pv = x[j * 128 + t];
          s[j * 4] = pv.x * (s[j * 4] - d2.x) * scale;
          s[j * 4 + 1] = pv.y * (s[j * 4 + 1] - d2.y) * scale;
          s[j * 4 + 2] = pv.z * (s[j * 4 + 2] - d2.x) * scale;
          s[j * 4 + 3] = pv.w * (s[j * 4 + 3] - d2.y) * scale;
        }
        // consumer 0 writes this buffer again two tiles on, if any
        if (i + 2 < n_tiles) named_arrive(kXEmpty + xb, kPair);
      }
      pack_a(pf, s);
      issue_rs<D>(acc, pf, c == 0 ? ds : qs);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty, stage, lane);
    }
    if (c == 0) {
      store_rows<D>(static_cast<uint16_t*>(p.dv) + b * p.dv_sb + hh * p.dv_sh,
                    p.dv_sl, ka, kb, 0, t4, acc);
    } else {
      store_rows<D>(static_cast<uint16_t*>(p.dk) + b * p.dk_sb + hh * p.dk_sh,
                    p.dk_sl, ka, kb, 0, t4, acc);
    }
  }
}

// ------------------------------------------------------------- host --
struct Maps {
  CUtensorMap q, k, v, dout;
};

// 0, or the 1000 + n code of what the kernels do not take
int check(int dtype, int batch, int heads, int lq, int lk, int d, int causal) {
  if (lq % 64 || lk % 64) return 1001;
  if (causal && lq > lk) return 1002;
  if (batch * heads > 65535) return 1003;
  if (d != 64 && d != 128 && d != 192 && d != 256) return 1004;
  if (dtype != 1) return 1005;
  return 0;
}

// the four tensor maps, Q and dO read in boxes of q_rows rows, K and V of
// kv_rows; strides: q, k, v, dO (sb, sh, sl each)
int encode_maps(Maps* maps, const void* q, const void* k, const void* v,
                const void* dout, int batch, int heads, int lq, int lk, int d,
                const long long* st, int q_rows, int kv_rows) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    if (tma_layout(ptrs[i], st[3 * i], st[3 * i + 1], st[3 * i + 2])) {
      return 1007;
    }
  }
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return 1008;
  const bool ok =
      encode(fn, &maps->q, q, batch, heads, lq, d, st[0], st[1], st[2], q_rows)
      && encode(fn, &maps->k, k, batch, heads, lk, d, st[3], st[4], st[5],
                kv_rows)
      && encode(fn, &maps->v, v, batch, heads, lk, d, st[6], st[7], st[8],
                kv_rows)
      && encode(fn, &maps->dout, dout, batch, heads, lq, d, st[9], st[10],
                st[11], q_rows);
  return ok ? 0 : 1008;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, const Maps& m,
                   const Params& p, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(m.q, m.k, m.v, m.dout, p);
  return cudaGetLastError();
}

template <int D>
int launch_dq(const Maps& m, const Params& p, int bh, cudaStream_t s) {
  return launch(flash_bwd_dq_sm90_kernel<D>, dq_smem_bytes<D>(),
                dim3((p.lq + kDqRows - 1) / kDqRows, bh), m, p, s);
}

template <int D>
int launch_dkv(const Maps& m, const Params& p, int bh, cudaStream_t s) {
  constexpr int keys = DkvCfg<D>::kKeys;
  return launch(flash_bwd_dkv_sm90_kernel<D>, dkv_smem_bytes<D>(),
                dim3((p.lk + keys - 1) / keys, bh), m, p, s);
}

int dkv_keys(int d) {
  return d == 64 ? DkvCfg<64>::kKeys : d == 128 ? DkvCfg<128>::kKeys
      : d == 192 ? DkvCfg<192>::kKeys : DkvCfg<256>::kKeys;
}

}  // namespace

// zoo_flash_attn_bwd_dq's interface without the mask: dtype must be 1
// (bfloat16) and d one of 64, 128, 192, 256. Writes dq and delta ([B*H,
// Lq] f32, contiguous). Returns a cudaError_t (0 = launched); 1000 + n
// flags a call the kernel does not take (1001 Lq or Lk not a multiple of
// 64, 1002 causal with Lq > Lk, 1003 B*H above 65535, 1004 the head dim,
// 1005 the dtype, 1007 an address or stride TMA cannot take, 1008 no
// tensor map).
extern "C" int zoo_flash_attn_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq,
    int dtype, int batch, int heads, int lq, int lk, int d,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    long long do_sb, long long do_sh, long long do_sl,
    long long dq_sb, long long dq_sh, long long dq_sl,
    float scale, int causal, void* stream) {
  int rc = check(dtype, batch, heads, lq, lk, d, causal);
  if (rc != 0) return rc;
  // O is read 16 bytes at a time, as TMA reads the others
  if (tma_layout(o, o_sb, o_sh, o_sl)) return 1007;
  const long long st[12] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                            v_sb, v_sh, v_sl, do_sb, do_sh, do_sl};
  Maps maps;
  rc = encode_maps(&maps, q, k, v, dout, batch, heads, lq, lk, d, st,
                   kDqRows, kKvTile);
  if (rc != 0) return rc;
  Params p = {};
  p.o = o;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_sl = do_sl;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_sl = dq_sl;
  p.h = heads; p.lq = lq; p.lk = lk;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (d) {
    case 64: return launch_dq<64>(maps, p, bh, s);
    case 128: return launch_dq<128>(maps, p, bh, s);
    case 192: return launch_dq<192>(maps, p, bh, s);
    default: return launch_dq<256>(maps, p, bh, s);
  }
}

// zoo_flash_attn_bwd_dkv's interface without the mask: reads the delta K2
// wrote (and lse; both 16-byte aligned), writes dk and dv. Return codes as
// zoo_flash_attn_bwd_dq_sm90's.
extern "C" int zoo_flash_attn_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int dtype, int batch, int heads, int lq, int lk, int d,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long do_sb, long long do_sh, long long do_sl,
    long long dk_sb, long long dk_sh, long long dk_sl,
    long long dv_sb, long long dv_sh, long long dv_sl,
    float scale, int causal, void* stream) {
  int rc = check(dtype, batch, heads, lq, lk, d, causal);
  if (rc != 0) return rc;
  if (reinterpret_cast<uintptr_t>(lse) % 16
      || reinterpret_cast<uintptr_t>(delta) % 16) {
    return 1007;
  }
  const long long st[12] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                            v_sb, v_sh, v_sl, do_sb, do_sh, do_sl};
  Maps maps;
  rc = encode_maps(&maps, q, k, v, dout, batch, heads, lq, lk, d, st,
                   kQTile, dkv_keys(d));
  if (rc != 0) return rc;
  Params p = {};
  p.lse = static_cast<const float*>(lse);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = dk;
  p.dv = dv;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_sl = dk_sl;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_sl = dv_sl;
  p.h = heads; p.lq = lq; p.lk = lk;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (d) {
    case 64: return launch_dkv<64>(maps, p, bh, s);
    case 128: return launch_dkv<128>(maps, p, bh, s);
    case 192: return launch_dkv<192>(maps, p, bh, s);
    default: return launch_dkv<256>(maps, p, bh, s);
  }
}
