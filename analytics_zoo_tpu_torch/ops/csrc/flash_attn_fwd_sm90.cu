// Flash-attention forward (K1, K1-lse) for Hopper, sm_90a: every bf16
// call at a head dim up to 128 (each multiple of 8; the wrappers pad
// other head dims to one), with or without a key-padding mask, and the
// bf16 calls without a mask at head dims 192, 256, 320, 384, 448 and 512,
// built on TMA, mbarriers, a producer warpgroup and wgmma.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_fwd_kernel`
// (:82), launched by `_flash_fwd` (:137), and JAX's stock Pallas
// flash_attention that analytics_zoo_tpu/ops/attention.py (:116-127)
// reaches with segment ids (a key-padding mask) or at head_dim % 64 != 0
// (K5b), for those calls. It computes what those kernels compute:
// softmax(scale * Q K^T) V on [B, H, L, D] with f32 softmax statistics
// and f32 accumulation, P rounded to bf16 before P V (the Pallas kernel
// casts p to v.dtype), O in bf16, with `with_lse` the natural-log
// logsumexp in [B*H, Lq] f32 that K2 and K3 read, and a causal mask
// aligned bottom-right (key j is visible to row i when j <= i + Lk - Lq;
// the stock kernel aligns it top-left, but the reference takes it only
// at Lq == Lk, where the two agree). The key-padding mask ([B, Lk] bytes,
// nonzero = real key) hides padded keys from every row; a row that then
// sees no key (an all-zero mask row, or causal with left padding) gets
// what the reference's einsum path gives with its finite -1e30 fill: the
// mean of V over all Lk keys, and logsumexp kEmptyLse. Padded query rows
// are computed like any other (the einsum path's values).
//
// What bounds it. Per (b, h) it reads Q, K, V once and writes O once,
// against 4 * D flops per visible (query, key) pair. Causal at D = 256
// ([8, 8, 2048, 256]) that is 138 GFLOP against 33.6 MB: bound by the
// tensor cores (0.139 ms at 989 TFLOP/s, 0.010 ms of bytes). At D = 64
// (the served [32, 12, 512, 64] call) the flops per byte are 256, just
// under the card's ridge of about 295: bound by bytes (0.030 ms), with
// the operations' bound (0.026 ms) close. Below 64 the bytes bound alone
// is not the floor: every score takes one ex2 on the special-function
// units (16 a clock an SM), about 0.022 ms for MiniLM's 85 M scores
// ([48, 12, 384, 32]) against 0.017 ms of bytes.
//
// What the design does about it. The mma.sync kernels it retired
// loaded tiles synchronously with every thread and a __syncthreads()
// pair (above 256 three) a kv tile, ran mma.sync.m16n8k16 and gathered V
// one scalar at a time. Here (up to D = 256; above, the split kernel
// below):
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
//     its Q K^T is done. Tiles are ceil(D/64) slabs of [rows][64] bf16
//     with the 128-byte swizzle, what TMA's CU_TENSOR_MAP_SWIZZLE_128B
//     writes and the wgmma descriptors' 128B layout reads (slabs
//     1024-byte aligned).
//   * S = Q K^T is wgmma.m64n{kKv}k16 with A (Q) and B (K, K-major) read
//     from shared memory through descriptors, D/16 k-steps (each wgmma
//     advances one base descriptor inside its asm, so the compiler keeps
//     no descriptor a k-step in registers). The online softmax runs in
//     registers in the accumulator layout (a row's values in the 4
//     threads of a quad, reduced with two shfl_xor; ex2.approx.ftz for
//     the exponentials). O += P V runs at N = D a k-step of 16 keys:
//     one wgmma.m64n{64 x whole slabs}k16 and, at a head dim that is not
//     a multiple of 64, one m64n{D mod 64}k16 over the first columns of
//     the last slab, with A (P) from registers, the S accumulator
//     re-packed as bf16 A fragments, and B (V) MN-major from shared
//     memory (the transpose flag; the slabs of D are its leading byte
//     offset apart), so P never leaves registers and V is never gathered
//     by hand.
//   * Head dims that are not a multiple of 64 (K5b). The tensor maps'
//     global width is the call's D and their boxes 64 columns, so TMA
//     fills the columns of the last slab past D with zeros in Q, K and
//     V; no host copy is made. An instantiation is built for each
//     multiple of 16 up to 128 and runs D/16 k-steps of Q K^T; a call at
//     D = 8 (mod 16) takes the next one up, whose last k-step reads
//     zeros in its upper half in both operands, and stores only its D
//     columns of O. P V at N = D (above) keeps O at D/2 registers: of
//     the designs weighed on an H100 (PERF.md), P V at the slab width
//     (N = 64 or 128, O at 32 or 64 registers) was 3-9% slower at every
//     such D and left no room for two blocks an SM at D = 80, which took
//     [8, 32, 1024, 80] from 0.188 to 0.145 device ms; a 64- or 32-byte
//     swizzle for D <= 32 was not built, since time moved little with D
//     there (0.056 ms at D = 16, 0.066 at 32, 0.072 at 48 on MiniLM's
//     [48, 12, 384, d]): the scores' exponentials and the waits, not the
//     tensor cores, bound those calls.
//   * Within a consumer, Q K^T of tile kt is issued before P V of tile
//     kt - 1, and tile kt's softmax runs while that P V is still on the
//     tensor cores. That needs S, P and O in registers at once; up to
//     D = 64, and at 80, the kernel instead runs two blocks an SM (kv
//     tiles of 64, 104 registers a consumer), which hides one block's
//     load latency behind the other's arithmetic, and its consumers take
//     tile by tile (pipelined there, D = 32 gained 2% and 48 lost 3%).
//   * The key-padding mask is a template flag (kMask), so the unmasked
//     instantiations are the kernel as it was. Before the loop, the
//     producer's first warp copies the batch row's mask (the keys of the
//     tiles the block may walk) into shared memory, under Q's load, and
//     lists the kv tiles that hold a real key; the producer and both
//     consumers walk that list, so wholly padded tiles are never loaded
//     and every barrier sees the same tiles. The staged row is written
//     once and only read afterwards (a first version brought each tile's
//     mask bytes into its K stage by a bulk copy, and a consumer's reads
//     of them raced the copy of a later tile into the same stage); a
//     consumer reads its keys' bytes of a tile into one register of bits
//     and sets masked scores to -inf before the row max.
//   * Rows that see no key: their running max is still -inf after the
//     walk (only a mask can do that: under causal alone, with Lq <= Lk,
//     every row sees key 0). A warp holding one computes the column
//     means of V over all Lk keys (two columns a lane, read from device
//     memory) and hands each thread its columns with shuffles; such a
//     row stores them and logsumexp kEmptyLse. The loop itself never
//     divides 0 by 0.
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
// Head dims 320 to 512 (flash_fwd_sm90_split_kernel<D>). The layout above
// cannot just be widened: a consumer holding O for 64 rows over all of
// D = 512 would need 256 f32 registers a thread (a thread may hold 255),
// and Q for 128 rows would be 128 KB of the 227. So:
//   * A block owns 64 q rows, and both consumers hold all 64 of them.
//     Consumer c owns a run of whole 64-column slabs of O: the first
//     ceil(D/128) slabs and the rest (N = 256 + 256 at D = 512, 256 + 192
//     at 448, 192 + 192 at 384, 192 + 128 at 320; O is at most 128
//     registers a thread), its P V one wgmma_rs<N> a k-step whose B
//     descriptor starts at its first slab of V.
//   * Each consumer computes the whole 64 x kKv S over all of D itself
//     (wgmma_ss from Q and K in shared memory, D/16 k-steps) and runs the
//     online softmax on it. Q K^T so runs twice, 1.5x the tensor-core
//     work of the call, but the consumers share no barrier and no shared
//     memory beyond the ring, and the softmax runs twice, not D/64 times
//     as in the mma.sync kernel this replaced, whose warps each summed
//     the partial S of every slice of D. The two compute the same S from
//     the same shared memory with the same instructions, so their m, l
//     and logsumexp agree bit for bit; the first alone stores the
//     logsumexp.
//   * Shared memory: Q (64 KB at D = 512) and a ring of K and V tiles
//     (SplitCfg: at 512 one 64-key stage each, 192 KB in all); the
//     producer's order (K of tile i before V of tile i - 1) overlaps one
//     tile's P V with the next tile's K load. Registers as at D = 256
//     (Tiles<..., 1, 24, 240>: O 128 + S 32 + P 16 at D = 512), so Q K^T
//     of tile i is still issued before P V of tile i - 1.
//   * Causal as above: kv tiles past a block's last row are never loaded,
//     only tiles that cross the diagonal are masked element by element,
//     blocks run longest first; with 64-row blocks no consumer is ever
//     without rows.
//   * What bounds it next: a block reads each visible kv tile of K and V
//     once per 64 q rows (64 flops a byte; 4.4 GB at [1, 64, 2048, 512]
//     causal, read from L2, where a head's K and V stay), and the tensor
//     cores at 1.5x the work. Later work: a 2-CTA cluster multicasting K
//     and V to two q blocks of a head (half the L2 feed), and a key split
//     of S between the consumers with the row max and P exchanged through
//     shared memory (no 1.5x).
//
// flash_attn_fwd_f32tc.cu takes every f32 call.
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
// logsumexp of a row that sees no key: what f32 logsumexp gives for the
// einsum path's row of -1e30 fills (log(Lk) is absorbed)
constexpr float kEmptyLse = -1e30f;

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
// producer and a consumer thread keep after setmaxnreg: up to D = 128 by
// the slabs of D (one up to 64, two above), at D = 80 two blocks an SM
// (O is 40 registers; at 96 and 112 the consumers spilled at 104), and
// at 192 and 256 (at D = 256: Q 64 KB + 2 x (32 + 32) KB of K and V,
// 193 KB of the 227)
template <int SLABS> struct SlabCfg;
template <> struct SlabCfg<1> : Tiles<64, 3, 2, 24, 104> {};
template <> struct SlabCfg<2> : Tiles<128, 2, 1, 24, 240> {};
template <int D> struct Cfg : SlabCfg<(D + kSlab - 1) / kSlab> {};
template <> struct Cfg<80> : Tiles<64, 2, 2, 24, 104> {};
template <> struct Cfg<192> : Tiles<64, 3, 1, 24, 240> {};
template <> struct Cfg<256> : Tiles<64, 2, 1, 24, 240> {};

// the head dim an instantiation is built for, for a call at head dim d:
// the next multiple of 16 up to 128 (TMA reads the columns past d as
// zeros), else d
constexpr int inst_dim(int d) { return d <= 128 ? (d + 15) / 16 * 16 : d; }

// bytes of the barriers (Q, and K full, V full, K empty, V empty a
// stage), rounded up to 16
__host__ __device__ constexpr int bar_bytes(int stages) {
  return (8 * (1 + 4 * stages) + 15) & ~15;
}

// dynamic shared memory: 1024 bytes of alignment slack, Q, the K and V
// stages (ceil(D/64) slabs a row), the barriers, and with a mask the
// count of listed kv tiles (16 bytes), the list (4 bytes a kv tile of the
// call, rounded up to 16) and the batch row's mask (Lk bytes): the last
// two depend on Lk (mask_bytes)
template <int D>
constexpr int smem_bytes() {
  constexpr int width = (D + kSlab - 1) / kSlab * kSlab;
  return 1024 + (kRows + 2 * Cfg<D>::kStages * Cfg<D>::kKv) * width * 2
      + bar_bytes(Cfg<D>::kStages);
}

// bytes of the list of kv tiles (4 a tile, rounded up to 16)
__host__ __device__ constexpr int list_bytes(int lk, int kv) {
  return ((lk + kv - 1) / kv * 4 + 15) & ~15;
}

struct Params {
  void* o;
  float* lse;                    // nullptr unless with_lse
  long long o_sb, o_sh, o_sl;    // element strides of O: batch, head, seq
  int h, lq, lk;
  int d;                         // head dim: O's columns stored
  float scale_log2;              // softmax scale * log2(e)
  int causal;
  // kMask: the key-padding mask ([B, Lk] bytes, nonzero = real key, rows
  // 16-byte aligned) and V (the means of rows that see no key)
  const uint8_t* mask;
  long long mask_sb;
  const uint16_t* v;
  long long v_sb, v_sh, v_sl;
};

template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kBlocks)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const Params p) {
  constexpr int kKv = Cfg<D>::kKv;
  constexpr int kStages = Cfg<D>::kStages;
  constexpr int kSlabs = (D + kSlab - 1) / kSlab;
  constexpr int kWidth = kSlabs * kSlab;    // columns of a staged row
  // P V runs at N = D: one wgmma over the whole slabs of V, and one over
  // the first kRem columns of a last, partial one
  constexpr int kFull = D / kSlab;
  constexpr int kRem = D % kSlab;
  constexpr int kQBytes = kRows * kWidth * 2;
  constexpr int kKvBytes = kKv * kWidth * 2;  // one K (or V) tile
  static_assert(D % 16 == 0, "head dim: a multiple of 16 (k-steps)");
  static_assert(kKv == 64 || kKv == 128, "kv tile: 64 or 128 keys");
  static_assert(!kMask || D <= 128, "a mask only up to D = 128");
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
  // kMask: the count and list of the kv tiles that hold a real key, and
  // the batch row's mask, written once before the walk and only read in
  // it (generic pointers)
  uint8_t* const after_bars = smem_raw + (barQ + bar_bytes(kStages) - raw);
  int* const n_live = reinterpret_cast<int*>(after_bars);
  int* const live = n_live + 4;
  uint8_t* const row_mask = after_bars + 16 + list_bytes(p.lk, kKv);

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int q0 = qt * kRows;
  const int offset = p.lk - p.lq;
  const uint8_t* const mrow = kMask ? p.mask + b * p.mask_sb : nullptr;

  // kv tiles this block may walk: up to its last real row's last key
  int n_tiles = (p.lk + kKv - 1) / kKv;
  if (p.causal) {
    const int last_row = min(q0 + kRows, p.lq) - 1;
    n_tiles = min(n_tiles, (last_row + offset) / kKv + 1);
  }

  // Q's load: one TMA box a slab on barQ
  auto load_q = [&]() {
    mbar_expect_tx(barQ, kQBytes);
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      tma_load(sQ + s * kRows * kSlabRow, &tq, barQ, s * kSlab, q0, hh, b);
    }
  };

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
    // with a mask Q's load goes first, so the list below is made under it
    if constexpr (kMask) load_q();
  }
  if constexpr (kMask) {
    // the first warp stages the batch row's mask (the keys of the tiles
    // this block may walk) and lists, in order, the kv tiles with a real
    // key: 32 tiles a round, one a lane, compacted by a ballot
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int n = 0;
      for (int base = 0; base < n_tiles; base += 32) {
        const int kt = base + lane;
        bool real = false;
        if (kt < n_tiles) {
          const uint4* src = reinterpret_cast<const uint4*>(mrow + kt * kKv);
          uint4* dst = reinterpret_cast<uint4*>(row_mask + kt * kKv);
          const int chunks = min(kKv, p.lk - kt * kKv) / 16;
          for (int i = 0; i < chunks; ++i) {
            const uint4 x = src[i];
            dst[i] = x;
            real |= (x.x | x.y | x.z | x.w) != 0u;
          }
        }
        const uint32_t ballot = __ballot_sync(0xffffffffu, real);
        if (real) live[n + __popc(ballot & ((1u << lane) - 1u))] = kt;
        n += __popc(ballot);
      }
      if (lane == 0) *n_live = n;
    }
  }
  __syncthreads();
  // the kv tiles every warpgroup walks, in order: with a mask the listed
  // ones, else all of the block's; tile(i) is the i-th one's index
  const int n_walk = kMask ? *n_live : n_tiles;
  auto tile = [&](int i) {
    if constexpr (kMask) {
      return live[i];
    } else {
      return i;
    }
  };

  // warpgroup index, uniform across each warp to the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(Cfg<D>::kProducerRegs));
    if (threadIdx.x == 0) {
      if constexpr (!kMask) load_q();
      // K of walked tile i, then V of walked tile i - 1: the order the
      // consumers use them in; each waits for its stage's previous tile
      // to be released (the first round finds every stage empty)
      auto load = [&](const CUtensorMap* map, uint32_t full, uint32_t empty,
                      uint32_t base, int i) {
        const int stage = i % kStages;
        mbar_wait(empty + 8 * stage, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * stage, kKvBytes);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(base + stage * kKvBytes + s * kKv * kSlabRow, map,
                   full + 8 * stage, s * kSlab, tile(i) * kKv, hh, b);
        }
      };
      for (int i = 0; i < n_walk + 1; ++i) {
        if (i < n_walk) load(&tk, fullK, emptyK, sK, i);
        if (i >= 1) load(&tv, fullV, emptyV, sV, i - 1);
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
  // walked tiles this consumer computes on, a prefix of the walk: all
  // of them, or, causal, those up to its own last row's last key; none
  // past Lq
  int n_mine = 0;
  if (active) {
    n_mine = n_walk;
    if (p.causal) {
      const int last = (r0 + 63 + offset) / kKv;
      if constexpr (kMask) {
        while (n_mine > 0 && live[n_mine - 1] > last) --n_mine;
      } else {
        n_mine = min(n_walk, last + 1);
      }
    }
  }
  // the last visible key of each of the two rows
  const int lim_a = p.causal ? min(ra + offset, p.lk - 1) : p.lk - 1;
  const int lim_b = p.causal ? min(rb + offset, p.lk - 1) : p.lk - 1;
  // and of this consumer's first row, the one that sees fewest
  const int lim_first = p.causal ? min(r0 + offset, p.lk - 1) : p.lk - 1;

  // O in the accumulator layout: 4 registers for each 8 columns
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max (log2 domain)
  float l_a = 0.f, l_b = 0.f;              // this thread's part of the sum
  float s[kKv / 2];          // S of one tile, then its probabilities
  uint32_t pf[kKv / 16][4];  // P as bf16 A fragments, 16 keys a k-step

  if (active) mbar_wait(barQ, 0);
  // this consumer's 64 rows of Q, slab 0, k-step 0
  const uint32_t q_base = sQ + c * 64 * kSlabRow;

  // issue S = Q K^T of walked tile i (D/16 k-steps of 32 bytes within a
  // 128-byte slab row) and commit it as one wgmma group
  auto issue_qk = [&](int i) {
    const uint32_t k_base = sK + (i % kStages) * kKvBytes;
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

  // issue O += P V of walked tile i and commit it: a k-step of 16 keys
  // is one wgmma of N = 64 x kFull over the whole slabs of V and, at a
  // head dim that is not a multiple of 64, one of N = kRem over the
  // first columns of the last slab; V's 128-byte rows are the K
  // dimension (MN-major B), 8 of them 1024 bytes apart in each core
  // group, and its slabs kKv rows apart (the leading byte offset)
  auto issue_pv = [&](int i) {
    const uint32_t v_base = sV + (i % kStages) * kKvBytes;
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    const uint64_t dv = sw128_desc(v_base, kKv * kSlabRow, 1024);
    const uint64_t dv_rem =
        sw128_desc(v_base + kFull * kKv * kSlabRow, kKv * kSlabRow, 1024);
#pragma unroll
    for (int kk = 0; kk < kKv / 16; ++kk) {
      const uint32_t off = kk * 16 * (kSlabRow / 16);
      if constexpr (kFull > 0) {
        wgmma_rs<kFull * kSlab>(
            reinterpret_cast<float (&)[kFull * kSlab / 2]>(o[0]), pf[kk],
            dv, off);
      }
      if constexpr (kRem > 0) {
        wgmma_rs<kRem>(
            reinterpret_cast<float (&)[kRem / 2]>(o[kFull * kSlab / 2]),
            pf[kk], dv_rem, off);
      }
    }
    wgmma_commit();
  };

  // kMask: kv tile kt's mask for this thread's keys as bits (key
  // j * 8 + t4 * 2 + e of the tile at bit 2j + e), from the staged row;
  // keys past Lk stay 0 (masked)
  auto mask_bits = [&](int kt) {
    uint32_t bits = 0;
    if constexpr (kMask) {
      const uint8_t* m = row_mask + kt * kKv + t4 * 2;
      const int keys = p.lk - kt * kKv;
#pragma unroll
      for (int j = 0; j < kKv / 8; ++j) {
        if (j * 8 < keys) {
          const uint32_t w = *reinterpret_cast<const uint16_t*>(m + j * 8);
          bits |= static_cast<uint32_t>((w & 0xffu) != 0u) << (2 * j);
          bits |= static_cast<uint32_t>((w >> 8) != 0u) << (2 * j + 1);
        }
      }
    }
    return bits;
  };

  // the online softmax of tile kt's S, in place (s becomes unnormalised
  // probabilities); returns the rescale of the rows' old O and sum
  auto softmax = [&](int kt, uint32_t bits, float& corr_a, float& corr_b) {
    // scale into the log2 domain, mask, and take the row max; padded
    // keys are masked in every tile, the diagonal and Lk's end only in a
    // tile that crosses them
    const int key0 = kt * kKv;
    const bool edge = key0 + kKv - 1 > lim_first;
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j * 4 + e] * p.scale_log2;
        if constexpr (kMask) {
          if (!((bits >> (2 * j + (e & 1))) & 1u)) x = -INFINITY;
        }
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
    for (int c = 0; c < D / 8; ++c) {
      o[c * 4] *= corr_a;
      o[c * 4 + 1] *= corr_a;
      o[c * 4 + 2] *= corr_b;
      o[c * 4 + 3] *= corr_b;
    }
#pragma unroll
    for (int j = 0; j < kKv / 16; ++j) {
      pf[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
      pf[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pf[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pf[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
  };

  // this warp is done reading walked tile i's K (or V): its stage may
  // refill
  auto release = [&](uint32_t empty, int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (i % kStages));
  };

  auto parity = [](int i) {
    return static_cast<uint32_t>((i / kStages) & 1);
  };

  // Software pipeline within the warpgroup: Q K^T of tile i is issued,
  // then P V of tile i - 1, and tile i's softmax runs while that P V is
  // still on the tensor cores; O is rescaled and P repacked once it is
  // done. That holds S, P and O in registers at once; where a consumer
  // has too few for that (two blocks an SM up to D = 64 and at 80), the
  // tiles run one after the other. The tiles a consumer computes on are a
  // prefix of the walk (i < n_mine), so the loops over them issue their
  // products unconditionally (ptxas serializes every wgmma where it
  // cannot tell how many groups a wait leaves in flight); past it, the
  // consumer only waits for each tile and releases it.
  if constexpr (kPipelined) {
    if (n_mine > 0) {
      float corr_a, corr_b;
      mbar_wait(fullK, 0);
      issue_qk(0);
      wgmma_wait<0>();
      uint32_t bits = mask_bits(tile(0));
      release(emptyK, 0);
      fence_regs(s);
      softmax(tile(0), bits, corr_a, corr_b);
      rescale_and_pack(corr_a, corr_b);
      for (int i = 1; i < n_mine; ++i) {
        mbar_wait(fullK + 8 * (i % kStages), parity(i));
        issue_qk(i);
        mbar_wait(fullV + 8 * ((i - 1) % kStages), parity(i - 1));
        issue_pv(i - 1);
        // Q K^T of tile i done; P V of tile i - 1 may still run
        wgmma_wait<1>();
        bits = mask_bits(tile(i));
        release(emptyK, i);
        fence_regs(s);
        softmax(tile(i), bits, corr_a, corr_b);
        wgmma_wait<0>();
        release(emptyV, i - 1);
        fence_regs(o);
        fence_regs(pf);
        rescale_and_pack(corr_a, corr_b);
      }
      mbar_wait(fullV + 8 * ((n_mine - 1) % kStages), parity(n_mine - 1));
      issue_pv(n_mine - 1);
      wgmma_wait<0>();
      release(emptyV, n_mine - 1);
      fence_regs(o);
    }
  } else {
    for (int i = 0; i < n_mine; ++i) {
      float corr_a, corr_b;
      mbar_wait(fullK + 8 * (i % kStages), parity(i));
      issue_qk(i);
      wgmma_wait<0>();
      const uint32_t bits = mask_bits(tile(i));
      release(emptyK, i);
      fence_regs(s);
      softmax(tile(i), bits, corr_a, corr_b);
      rescale_and_pack(corr_a, corr_b);
      mbar_wait(fullV + 8 * (i % kStages), parity(i));
      issue_pv(i);
      wgmma_wait<0>();
      release(emptyV, i);
      fence_regs(o);
    }
  }
  for (int i = n_mine; i < n_walk; ++i) {
    mbar_wait(fullK + 8 * (i % kStages), parity(i));
    release(emptyK, i);
    mbar_wait(fullV + 8 * (i % kStages), parity(i));
    release(emptyV, i);
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
  // a row whose running max is still -inf saw no key (only a mask can do
  // that); a warp holding one takes V's column means over all Lk keys,
  // lane l columns 64n + 2l and 64n + 2l + 1
  const bool empty_a = kMask && m_a == -INFINITY;
  const bool empty_b = kMask && m_b == -INFINITY;
  const bool warp_empty = kMask && __any_sync(0xffffffffu, empty_a || empty_b);
  float mean[kSlabs][2];
#pragma unroll
  for (int n = 0; n < kSlabs; ++n) mean[n][0] = mean[n][1] = 0.f;
  if (warp_empty) {
    const uint16_t* vb = p.v + b * p.v_sb + hh * p.v_sh;
#pragma unroll
    for (int n = 0; n < kSlabs; ++n) {
      const int col = n * kSlab + 2 * lane;
      if (col < p.d) {
        for (int j = 0; j < p.lk; ++j) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
              vb + j * p.v_sl + col);
          mean[n][0] += __low2float(x);
          mean[n][1] += __high2float(x);
        }
      }
      mean[n][0] /= static_cast<float>(p.lk);
      mean[n][1] /= static_cast<float>(p.lk);
    }
  }
  uint16_t* out = static_cast<uint16_t*>(p.o) + b * p.o_sb + hh * p.o_sh;
  uint16_t* oa = out + static_cast<long long>(ra) * p.o_sl + t4 * 2;
  uint16_t* ob = out + static_cast<long long>(rb) * p.o_sl + t4 * 2;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    // this thread's two columns of the 8 from col: the means' lane
    // (c % 8) * 4 + t4 of slab c / 8 holds them
    float mean0 = 0.f, mean1 = 0.f;
    if (warp_empty) {
      mean0 = __shfl_sync(0xffffffffu, mean[c / 8][0], (c % 8) * 4 + t4);
      mean1 = __shfl_sync(0xffffffffu, mean[c / 8][1], (c % 8) * 4 + t4);
    }
    // the call's D columns: D, or D - 8 (D rounds a multiple of 8 up to
    // 16), so only the last 8 can be past it (a branch a chunk cost the
    // unmasked D = 64 call 3%)
    const int col = c * 8;
    if (D > 128 || c + 1 < D / 8 || col < p.d) {
      *reinterpret_cast<uint32_t*>(oa + col) = empty_a
          ? pack_bf16(mean0, mean1)
          : pack_bf16(o[c * 4] * inv_a, o[c * 4 + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(ob + col) = empty_b
          ? pack_bf16(mean0, mean1)
          : pack_bf16(o[c * 4 + 2] * inv_b, o[c * 4 + 3] * inv_b);
    }
  }
  if (p.lse != nullptr && t4 == 0) {
    float* lse = p.lse + static_cast<long long>(bh) * p.lq;
    lse[ra] = empty_a ? kEmptyLse : (m_a + log2f(l_a)) * kLn2;
    lse[rb] = empty_b ? kEmptyLse : (m_b + log2f(l_b)) * kLn2;
  }
}

// ------------------------------------------------ head dims 320 to 512 --
// The split kernel (the header's notes): a block owns 64 q rows, which
// both consumers hold; consumer c keeps O's columns [64 * kSlab0,
// 64 * kSlab0 + kN) and computes S over all of D itself.

constexpr int kSplitRows = 64;  // q rows a block above D = 256

// consumer 0's whole slabs of O (the first ceil(D/128)); consumer 1 has
// the rest
__host__ __device__ constexpr int split_slabs0(int d) {
  return (d / kSlab + 1) / 2;
}

// kv rows a tile and ring stages above D = 256, one block an SM. At
// D = 512, Q (64 KB) and one stage of K and of V (64 KB each) fill 192 KB
// of the 227; at 320 two stages fit. 32-key tiles in twice the stages
// (m64n32 products) were 3-18% slower at 320, 384 and 512 and level at
// 448 (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
template <int D> struct SplitCfg;
template <> struct SplitCfg<320> : Tiles<64, 2, 1, 24, 240> {};
template <> struct SplitCfg<384> : Tiles<64, 1, 1, 24, 240> {};
template <> struct SplitCfg<448> : Tiles<64, 1, 1, 24, 240> {};
template <> struct SplitCfg<512> : Tiles<64, 1, 1, 24, 240> {};

template <int D>
__host__ __device__ constexpr int split_smem_bytes() {
  return 1024 + (kSplitRows + 2 * SplitCfg<D>::kStages * SplitCfg<D>::kKv)
      * D * 2 + bar_bytes(SplitCfg<D>::kStages);
}

// One consumer warpgroup of flash_fwd_sm90_split_kernel<D>: the block's
// 64 rows, S = Q K^T over all of D, the online softmax, and O += P V over
// the kN columns of V from slab kSlab0 on; it stores those columns of O
// and, with kSlab0 == 0, the logsumexp. The barriers and the smem
// layout are the kernel's.
template <int D, int kSlab0, int kN>
__device__ __forceinline__ void split_consumer(
    const Params& p, uint32_t sQ, uint32_t sK, uint32_t sV, uint32_t barQ,
    uint32_t fullK, uint32_t fullV, uint32_t emptyK, uint32_t emptyV,
    int n_tiles, int q0, int b, int hh, int bh) {
  constexpr int kKv = SplitCfg<D>::kKv;
  constexpr int kStages = SplitCfg<D>::kStages;
  constexpr int kKvBytes = kKv * D * 2;  // one K (or V) tile
  const int t = threadIdx.x % 128;       // thread within the warpgroup
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;               // accumulator row within 8
  const int t4 = lane & 3;               // thread within the quad
  const int ra = q0 + warp * 16 + g;     // the two rows a thread holds
  const int rb = ra + 8;
  const int offset = p.lk - p.lq;
  // the last visible key of each of the two rows, and of the block's
  // first row, the one that sees fewest
  const int lim_a = p.causal ? min(ra + offset, p.lk - 1) : p.lk - 1;
  const int lim_b = p.causal ? min(rb + offset, p.lk - 1) : p.lk - 1;
  const int lim_first = p.causal ? min(q0 + offset, p.lk - 1) : p.lk - 1;

  // this consumer's columns of O in the accumulator layout
  float o[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY;  // running max (log2 domain)
  float l_a = 0.f, l_b = 0.f;              // this thread's part of the sum
  float s[kKv / 2];          // S of one tile, then its probabilities
  uint32_t pf[kKv / 16][4];  // P as bf16 A fragments, 16 keys a k-step

  mbar_wait(barQ, 0);

  // S = Q K^T of tile i over all of D (D/16 k-steps of 32 bytes within a
  // 128-byte slab row), committed as one wgmma group
  auto issue_qk = [&](int i) {
    const uint32_t k_base = sK + (i % kStages) * kKvBytes;
    wgmma_fence();
    const uint64_t da = sw128_desc(sQ, 16, 1024);
    const uint64_t db = sw128_desc(k_base, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk & 3) * 2;
      const uint32_t a_off = (kk >> 2) * (kSplitRows * kSlabRow / 16) + step;
      const uint32_t b_off = (kk >> 2) * (kKv * kSlabRow / 16) + step;
      wgmma_ss_n64(s, da, a_off, db, b_off, kk > 0);
    }
    wgmma_commit();
  };

  // O += P V of tile i over this consumer's slabs of V (MN-major B, its
  // slabs kKv rows apart: the leading byte offset), committed
  auto issue_pv = [&](int i) {
    const uint32_t v_base =
        sV + (i % kStages) * kKvBytes + kSlab0 * kKv * kSlabRow;
    fence_regs(o);
    fence_regs(pf);
    wgmma_fence();
    const uint64_t dv = sw128_desc(v_base, kKv * kSlabRow, 1024);
#pragma unroll
    for (int kk = 0; kk < kKv / 16; ++kk) {
      wgmma_rs<kN>(o, pf[kk], dv, kk * 16 * (kSlabRow / 16));
    }
    wgmma_commit();
  };

  // the online softmax of tile kt's S, in place; returns the rescale of
  // the rows' old O and sum. Both consumers run it on the same S with the
  // same instructions, so their m and l agree bit for bit
  auto softmax = [&](int kt, float& corr_a, float& corr_b) {
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

  // O's rows rescaled and the probabilities packed as P's A fragments;
  // only once no P V is in flight
  auto rescale_and_pack = [&](float corr_a, float corr_b) {
#pragma unroll
    for (int c = 0; c < kN / 8; ++c) {
      o[c * 4] *= corr_a;
      o[c * 4 + 1] *= corr_a;
      o[c * 4 + 2] *= corr_b;
      o[c * 4 + 3] *= corr_b;
    }
#pragma unroll
    for (int j = 0; j < kKv / 16; ++j) {
      pf[j][0] = pack_bf16(s[8 * j], s[8 * j + 1]);
      pf[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pf[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pf[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
  };

  auto release = [&](uint32_t empty, int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (i % kStages));
  };
  auto parity = [](int i) {
    return static_cast<uint32_t>((i / kStages) & 1);
  };

  // Q K^T of tile i is issued before P V of tile i - 1, and tile i's
  // softmax runs while that P V is on the tensor cores (the D <= 256
  // kernel's pipeline). Every consumer computes on every tile its block
  // walks: the two hold the same rows
  if (n_tiles > 0) {
    float corr_a, corr_b;
    mbar_wait(fullK, 0);
    issue_qk(0);
    wgmma_wait<0>();
    release(emptyK, 0);
    fence_regs(s);
    softmax(0, corr_a, corr_b);
    rescale_and_pack(corr_a, corr_b);
    for (int i = 1; i < n_tiles; ++i) {
      mbar_wait(fullK + 8 * (i % kStages), parity(i));
      issue_qk(i);
      mbar_wait(fullV + 8 * ((i - 1) % kStages), parity(i - 1));
      issue_pv(i - 1);
      // Q K^T of tile i done; P V of tile i - 1 may still run
      wgmma_wait<1>();
      release(emptyK, i);
      fence_regs(s);
      softmax(i, corr_a, corr_b);
      wgmma_wait<0>();
      release(emptyV, i - 1);
      fence_regs(o);
      fence_regs(pf);
      rescale_and_pack(corr_a, corr_b);
    }
    mbar_wait(fullV + 8 * ((n_tiles - 1) % kStages), parity(n_tiles - 1));
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    release(emptyV, n_tiles - 1);
    fence_regs(o);
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  l_a = fmaxf(l_a, 1e-30f);
  l_b = fmaxf(l_b, 1e-30f);
  const float inv_a = 1.f / l_a;
  const float inv_b = 1.f / l_b;
  uint16_t* out = static_cast<uint16_t*>(p.o) + b * p.o_sb + hh * p.o_sh
      + kSlab0 * kSlab + t4 * 2;
  uint16_t* oa = out + static_cast<long long>(ra) * p.o_sl;
  uint16_t* ob = out + static_cast<long long>(rb) * p.o_sl;
#pragma unroll
  for (int c = 0; c < kN / 8; ++c) {
    *reinterpret_cast<uint32_t*>(oa + c * 8) =
        pack_bf16(o[c * 4] * inv_a, o[c * 4 + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(ob + c * 8) =
        pack_bf16(o[c * 4 + 2] * inv_b, o[c * 4 + 3] * inv_b);
  }
  if (kSlab0 == 0 && p.lse != nullptr && t4 == 0) {
    float* lse = p.lse + static_cast<long long>(bh) * p.lq;
    lse[ra] = (m_a + log2f(l_a)) * kLn2;
    lse[rb] = (m_b + log2f(l_b)) * kLn2;
  }
}

// K1 and K1-lse bf16 at D in {320, 384, 448, 512}, without a mask: 64 q
// rows a block, a producer warpgroup and two consumers that split O's
// columns between them (split_consumer)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_split_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const Params p) {
  constexpr int kKv = SplitCfg<D>::kKv;
  constexpr int kStages = SplitCfg<D>::kStages;
  constexpr int kSlabs = D / kSlab;
  constexpr int kQBytes = kSplitRows * D * 2;
  constexpr int kKvBytes = kKv * D * 2;
  constexpr int kSlabs0 = split_slabs0(D);
  static_assert(D % kSlab == 0 && D > 256 && D <= 512, "head dim");
  static_assert(kKv == 64, "kv tile: 64 keys (Q K^T is wgmma m64n64)");
  static_assert(split_smem_bytes<D>() <= 232448, "shared memory");

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

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int q0 = qt * kSplitRows;
  // kv tiles this block walks: up to its last row's last key
  int n_tiles = (p.lk + kKv - 1) / kKv;
  if (p.causal) {
    n_tiles = min(n_tiles, (q0 + kSplitRows - 1 + p.lk - p.lq) / kKv + 1);
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

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(SplitCfg<D>::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(barQ, kQBytes);
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        tma_load(sQ + s * kSplitRows * kSlabRow, &tq, barQ, s * kSlab, q0,
                 hh, b);
      }
      // K of tile i, then V of tile i - 1, each once its stage's
      // previous tile is released by both consumers
      auto load = [&](const CUtensorMap* map, uint32_t full, uint32_t empty,
                      uint32_t base, int i) {
        const int stage = i % kStages;
        mbar_wait(empty + 8 * stage, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * stage, kKvBytes);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(base + stage * kKvBytes + s * kKv * kSlabRow, map,
                   full + 8 * stage, s * kSlab, i * kKv, hh, b);
        }
      };
      for (int i = 0; i < n_tiles + 1; ++i) {
        if (i < n_tiles) load(&tk, fullK, emptyK, sK, i);
        if (i >= 1) load(&tv, fullV, emptyV, sV, i - 1);
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(SplitCfg<D>::kConsumerRegs));
  if (wg == 1) {
    split_consumer<D, 0, kSlabs0 * kSlab>(p, sQ, sK, sV, barQ, fullK, fullV,
                                          emptyK, emptyV, n_tiles, q0, b, hh,
                                          bh);
  } else {
    split_consumer<D, kSlabs0, (kSlabs - kSlabs0) * kSlab>(
        p, sQ, sK, sV, barQ, fullK, fullV, emptyK, emptyV, n_tiles, q0, b,
        hh, bh);
  }
}

// ------------------------------------------------------------- host --
struct Maps {
  CUtensorMap q, k, v;
};

// kv rows a tile of the instantiation for head dim d
int kv_rows(int d) {
  switch (inst_dim(d)) {
    case 16: return Cfg<16>::kKv;
    case 32: return Cfg<32>::kKv;
    case 48: return Cfg<48>::kKv;
    case 64: return Cfg<64>::kKv;
    case 80: return Cfg<80>::kKv;
    case 96: return Cfg<96>::kKv;
    case 112: return Cfg<112>::kKv;
    case 128: return Cfg<128>::kKv;
    case 192: return Cfg<192>::kKv;
    case 256: return Cfg<256>::kKv;
    case 320: return SplitCfg<320>::kKv;
    case 384: return SplitCfg<384>::kKv;
    case 448: return SplitCfg<448>::kKv;
    default: return SplitCfg<512>::kKv;
  }
}

// 0, or the 1000 + n code of what the kernel does not take; the maps'
// global width is the call's head dim d (columns past it read as zeros)
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
  const int kv = kv_rows(d);
  const bool ok =
      encode(fn, &maps->q, q, batch, heads, lq, d, strides[0], strides[1],
             strides[2], d > 256 ? kSplitRows : kRows)
      && encode(fn, &maps->k, k, batch, heads, lk, d, strides[3], strides[4],
                strides[5], kv)
      && encode(fn, &maps->v, v, batch, heads, lk, d, strides[6], strides[7],
                strides[8], kv);
  return ok ? 0 : 1008;
}

template <int D, bool kMask>
cudaError_t launch(const Maps& maps, const Params& p, int batch_heads,
                   cudaStream_t stream) {
  // with a mask: the count, the list of kv tiles and the batch row's
  // mask
  const int smem = smem_bytes<D>()
      + (kMask ? 16 + list_bytes(p.lk, Cfg<D>::kKv) + p.lk : 0);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D, kMask>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.lq + kRows - 1) / kRows, batch_heads);
  flash_fwd_sm90_kernel<D, kMask><<<grid, kThreads, smem, stream>>>(
      maps.q, maps.k, maps.v, p);
  return cudaGetLastError();
}

// the split kernel at D = 320 to 512: 64-row q blocks
template <int D>
cudaError_t launch_split(const Maps& maps, const Params& p, int batch_heads,
                         cudaStream_t stream) {
  const int smem = split_smem_bytes<D>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_split_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.lq + kSplitRows - 1) / kSplitRows, batch_heads);
  flash_fwd_sm90_split_kernel<D><<<grid, kThreads, smem, stream>>>(
      maps.q, maps.k, maps.v, p);
  return cudaGetLastError();
}

// the instantiation for head dim D, with or without the mask (none
// above 128)
template <int D>
cudaError_t launch_d(bool masked, const Maps& maps, const Params& p,
                     int batch_heads, cudaStream_t stream) {
  if constexpr (D > 256) {
    return launch_split<D>(maps, p, batch_heads, stream);
  } else if constexpr (D > 128) {
    return launch<D, false>(maps, p, batch_heads, stream);
  } else {
    return masked ? launch<D, true>(maps, p, batch_heads, stream)
                  : launch<D, false>(maps, p, batch_heads, stream);
  }
}

}  // namespace

// K1 and K1-lse: q, k, v and o are [B, H, L, D] with element strides
// (batch, head, seq; the last dimension contiguous), lse is null or
// [B*H, Lq] f32; dtype must be 1 (bfloat16), d a multiple of 8 up to
// 128, or 192, 256, 320, 384, 448 or 512 without a mask; mask is [B, Lk]
// bytes (nonzero = real key) with batch stride mask_sb, both 16-byte
// aligned, or null for none. Returns a cudaError_t (0 = launched);
// 1000 + n flags a call the kernel does not take (1001 Lq or Lk not a
// multiple of 64, 1002 causal with Lq > Lk, 1003 B*H above 65535, 1004
// the head dim, 1005 the dtype, 1006 a mask above D = 128, 1007 an
// address or stride TMA or the mask's copies cannot take, 1008 no tensor
// map).
extern "C" int zoo_flash_attn_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int batch, int heads, int lq, int lk, int d,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    const void* mask, long long mask_sb,
    float scale, int causal, void* stream) {
  if (lq % 64 || lk % 64) return 1001;
  if (causal && lq > lk) return 1002;
  if (batch * heads > 65535) return 1003;
  if (d < 8 || d % 8 || d > 512 || (d > 128 && d % 64)) return 1004;
  if (dtype != 1) return 1005;
  const bool masked = mask != nullptr;
  if (masked && d > 128) return 1006;
  if (masked && (reinterpret_cast<uintptr_t>(mask) % 16 || mask_sb % 16)) {
    return 1007;
  }
  const long long strides[9] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                                v_sb, v_sh, v_sl};
  Maps maps;
  const int rc = encode_maps(&maps, q, k, v, batch, heads, lq, lk, d, strides);
  if (rc != 0) return rc;
  Params p;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sl = o_sl;
  p.h = heads; p.lq = lq; p.lk = lk; p.d = d;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.mask = static_cast<const uint8_t*>(mask);
  p.mask_sb = mask_sb;
  p.v = static_cast<const uint16_t*>(v);
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sl = v_sl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (inst_dim(d)) {
    case 16: return launch_d<16>(masked, maps, p, bh, s);
    case 32: return launch_d<32>(masked, maps, p, bh, s);
    case 48: return launch_d<48>(masked, maps, p, bh, s);
    case 64: return launch_d<64>(masked, maps, p, bh, s);
    case 80: return launch_d<80>(masked, maps, p, bh, s);
    case 96: return launch_d<96>(masked, maps, p, bh, s);
    case 112: return launch_d<112>(masked, maps, p, bh, s);
    case 128: return launch_d<128>(masked, maps, p, bh, s);
    case 192: return launch_d<192>(masked, maps, p, bh, s);
    case 256: return launch_d<256>(masked, maps, p, bh, s);
    case 320: return launch_d<320>(masked, maps, p, bh, s);
    case 384: return launch_d<384>(masked, maps, p, bh, s);
    case 448: return launch_d<448>(masked, maps, p, bh, s);
    default: return launch_d<512>(masked, maps, p, bh, s);
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
