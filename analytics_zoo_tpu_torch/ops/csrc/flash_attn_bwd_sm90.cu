// Flash-attention backward (K2 dQ and delta, K3 dK/dV) for Hopper, sm_90a:
// every bf16 call at a head dim up to 128 (each multiple of 8; the
// wrappers pad other head dims to one), with or without a key-padding
// mask, and the bf16 calls without a mask at head dims 192, 256, 320, 384,
// 448 and 512, built on TMA, mbarriers, a producer warpgroup and wgmma
// (the parts of flash_attn_fwd_sm90.cu, shared through
// flash_attn_sm90.cuh).
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_dq_kernel`
// (:209, launched at :327) and `_flash_dkv_kernel` (:249, launched at :345),
// both driven by `_flash_bwd` (:305), plus the rowsum delta = rowsum(dO * O)
// that `_flash_bwd` takes in plain jnp (:316-319), for those calls; and the
// dQ and dK/dV kernels behind the custom_vjp of JAX's stock Pallas
// flash_attention, which analytics_zoo_tpu/ops/attention.py (:116-127)
// reaches with segment ids (a key-padding mask, K5a) or at head_dim % 64
// != 0 (K5b). Given the forward's Q, K, V, O, its per-row logsumexp and dO
// on [B, H, L, D]:
//   P = exp(scale * Q K^T - lse),  dS = P * (dO V^T - delta) * scale (bf16)
//   dQ = dS K,  dK = dS^T Q,  dV = P~^T dO  (P~ = P rounded to bf16)
// f32 accumulation, bf16 outputs, a causal mask aligned bottom-right (key j
// is visible to query i when j <= i + Lk - Lq), q/k/v/dO with the caller's
// strides (views into a fused projection), lse and delta [B*H, Lq] f32.
// The key-padding mask ([B, Lk] bytes, nonzero = real key) gives masked
// pairs P = 0 and dS = 0, so padded keys get exactly zero dK; a row that
// sees no key (an all-zero mask row, or causal with left padding; its lse
// is -1e30) took the mean of V in the forward: it gives nothing to dQ or
// dK and dO / Lk to the dV of every key (the reference einsum path's
// gradients). Two kernels, K2 then K3 on one stream (K3 reads the delta K2
// wrote), as the reference runs them: no atomics, deterministic.
//
// What bounds them. Per (b, h) K2 reads Q, K, V, O, dO once and writes dQ
// and delta against 6 * D flops per visible (query, key) pair (S, dP, dQ);
// K3 reads Q, K, V, dO, lse, delta and writes dK, dV against 8 * D (S^T,
// dP^T, dV, dK). At the BERT-base trained call [48,12,384,64] that is about
// 190 and 250 flops a byte, under the card's ridge of about 295: bound by
// bytes, 0.0512 ms each (chip_smoke.py `bounds`). At the GPT-J-width LM's
// call [4,16,2048,256] causal: bound by the tensor cores, 0.2086 ms (K2)
// and 0.2781 ms (K3) at 989 TFLOP/s. Below D = 64 the bytes bound alone is
// not the floor: every score takes one ex2 on the special-function units
// (16 a clock an SM), and K2 and K3 each rebuild P, about 0.022 ms each for
// MiniLM's 85 M scores ([48, 12, 384, 32]) against 0.026 of bytes.
//
// What the design does about it. The kernels it retired (the mma.sync
// templates of flash_attn_bwd.cuh, retired with them) loaded every tile
// with every thread and a __syncthreads() pair, multiplied with
// mma.sync.m16n8k16, re-read
// fragments for each 16-wide slice of D, gathered the row-contracted B
// fragments two rows at a time, walked wholly padded kv tiles, held 254
// registers at D = 256 (K3 255 at D = 120, a few masked ones spilling),
// and K3 above 128 computed S^T and dP^T twice (12 * D flops a pair). Here:
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
//     four threads of a quad share a row, taking its 16-byte chunks in
//     turn up to the call's D) before the loop and writes it for K3. The
//     ring carries the kv tiles of 64 keys, K and V apart (separate
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
//     From D = 80 to 128 a consumer owns 64 keys (128 a block) and holds dK
//     and dV, D f32 registers a thread, beside S^T and dP^T (64).
//   * K3 up to D = 64 and at 192 and 256: the two consumers share the
//     block's 64 keys and split the work by product: consumer 0 computes
//     S^T, forms P^T (f32) and accumulates dV += P~^T dO; consumer 1
//     computes dP^T, takes P^T from consumer 0 through shared memory (two
//     16 KB buffers, in the accumulator layout, float4 a thread; named
//     barriers in both directions), forms dS^T and accumulates dK += dS^T Q.
//     Each holds D/2 accumulator registers beside 32, and each pair costs
//     8 * D flops. Above 128 dK and dV together (D registers) and S^T and
//     dP^T (64) would pass the 240 a consumer gets; up to 64 the split runs
//     two blocks an SM (104 registers a consumer), which hides one block's
//     loads behind the other's work. Splitting the q columns of S^T and
//     dP^T and then D between the consumers with SS wgmmas of N = D/2 would
//     give each 96 columns at D = 192, not a whole number of the 64-column
//     atoms an MN-major B is read in under the 128-byte swizzle. Both
//     consumers computing all of S^T and dP^T, each accumulating dK and dV
//     for half of D (12 * D flops a pair), took 0.71 ms at [4,16,2048,256]
//     against this split's 0.53 (H100 80GB HBM3, 700 W), so it went. Two
//     blocks of K2 an SM at D = 64 (dQ, S and dP in 104 registers) spilled
//     and serialized its wgmmas, so K2 runs one block an SM at every D.
//   * Head dims that are not a multiple of 64 (K5b), as K1's Hopper kernel
//     takes them: the tensor maps' global width is the call's D and their
//     boxes 64 columns, so TMA fills the columns of the last slab past D
//     with zeros in Q, K, V and dO; no host copy is made. An instantiation
//     is built for each multiple of 16 up to 128 and runs D/16 k-steps of
//     the products over D; a call at D = 8 (mod 16) takes the next one up,
//     whose last k-step reads zeros in its upper half in both operands, and
//     stores only its D columns of dQ, dK and dV. The products whose N side
//     is D (dQ += dS K, dV += P~^T dO, dK += dS^T Q) read their B MN-major:
//     one wgmma of N = 64 x the whole slabs and, at a head dim that is not a
//     multiple of 64, one of N = D mod 64 over the first columns of the last
//     slab, so the accumulators stay D/2 registers.
//   * The key-padding mask is a template flag (kMask), so the unmasked
//     instantiations are the kernels as they were.
//     - K2: before the loop, the producer's first warp copies the batch
//       row's mask (the keys of the tiles the block may walk) into shared
//       memory, under Q's and dO's load, and lists the kv tiles that hold a
//       real key; the producer and both consumers walk that list, so wholly
//       padded tiles are never loaded and every barrier sees the same tiles
//       (K1's design; the staged row is written once and only read after).
//       A consumer reads its keys' bytes of a tile into one register of
//       bits and gives a masked pair P = 0 (so dS = 0) after the
//       exponential: a row that sees no key has lse -1e30, its exponentials
//       overflow, and every one of them is masked. Its dQ is 0; its delta is
//       written for K3 like any other.
//     - K3: a block owns keys, and padded query rows are computed like any
//       other, so no q tile is skipped for the mask. Before the loop the
//       producer's first warp finds the batch row's first real key, hence
//       the rows that see no key (the first n_empty rows of a (b, h): all
//       Lq where the row has no real key, else, causal, those above the
//       first real key's diagonal), sums their dO rows into E = bf16(1/Lk)
//       * sum dO (the probability 1/Lk rounded as P~ is), and marks which
//       64 keys of the block hold a real key. A block whose keys are all
//       padding walks no q tile and loads nothing (dK = 0, dV = E); a
//       consumer whose 64 keys are all padding only waits for each tile and
//       releases it; every other gives P = 0 to its padded keys element by
//       element. Every key's dV gets E added.
//   * Causal: K2 never loads kv tiles above a block's last row and K3 never
//     loads q tiles whose rows all lie above its first key; a consumer's
//     tiles are a prefix (K2) or suffix (K3) of the block's walk, so its
//     loops issue their wgmmas unconditionally (ptxas serializes every
//     wgmma issued under an `if`); past them it only waits for each tile
//     and releases it. Only tiles that cross the diagonal are masked
//     element by element. Under the mask with left padding (rows that see
//     no key) both hold: the padded keys by their bits, the rest by the
//     diagonal. K2's blocks run longest first (q blocks in reverse order);
//     K3's do by their order (key blocks from the first).
//   * Lq % 128 == 64 (K2) or Lk % 128 == 64 (K3 with 128 keys a block): the
//     last block's second consumer has no rows. It reaches every barrier
//     and stores nothing; TMA zero-fills what it reads past Lq and Lk.
//   * No wait traps on a timeout (a trap made ptxas serialize every wgmma
//     of K1 and spill).
// Later work: one fused kernel with dQ accumulated across key blocks, the
// next tile's S and dP issued while this tile's dQ (or dK, dV) runs, a
// persistent grid, and the outputs stored through shared memory and TMA.
//
// Head dims 320 to 512 (flash_bwd_dq_sm90_split_kernel<D> and
// flash_bwd_dkv_sm90_split_kernel<D>, unmasked: the reference's dispatch
// sends a masked call there to its einsum path). The layout above cannot
// just be widened: dQ over 64 rows and all of D = 512 is 256 f32
// registers a thread (a thread may hold 255), and dK and dV over 64 keys
// and all of D are 2 x 64 x 512 f32, 256 KB, the whole register file of
// an SM. Shared memory holds 227 KB a block: Q and dO of 64 rows take 128
// KB at D = 512, K and V of 64 keys another 128. So:
//   * K2: a block owns 64 q rows, and both consumers hold all of them.
//     Each computes S and dP over all of D itself (SS wgmmas from the same
//     shared memory with the same instructions, so the two rebuild P bit
//     for bit) and accumulates dQ over its own run of whole 64-column
//     slabs (consumer 0 the first ceil(D/128), consumer 1 the rest: 256 +
//     256 at 512, 256 + 192 at 448, 192 + 192 at 384, 192 + 128 at 320;
//     at most 128 accumulator registers a thread) with one RS wgmma of
//     N = its columns a k-step, whose B descriptor starts at its first
//     slab of K. delta: each consumer sums dO * O over its own columns of
//     its two rows, and the two parts meet in shared memory, added in one
//     order, after a named barrier; consumer 0 writes delta for K3. 10 * D
//     flops a visible pair against 6 * D. The ring (DqSplitCfg): kv tiles
//     of 64 keys, and of 32 at D = 512, where Q, dO and a 64-key K and V
//     would pass the 227 KB.
//   * K3: a block owns 64 keys and one part of D (blockIdx.x = 2 x key
//     block + part; the first part's slabs are the first ceil(D/128)).
//     Its consumers split the products as at 192 and 256 (consumer 0
//     S^T, P^T and dV += P~^T dO, consumer 1 dP^T, dS^T with consumer 0's
//     P^T and dK += dS^T Q), S^T and dP^T over all of D, dK and dV over
//     the block's part. Both parts' blocks compute S^T and dP^T: 12 * D
//     flops a visible pair against 8 * D, and each reads Q and dO. K and
//     V of 64 keys take 128 KB at 512, so the ring holds one stage
//     (DkvSplitCfg: q tiles of 64 rows at 320 and 384, of 32 at 448 and
//     512). A q tile's slabs arrive in two groups, each on its own full
//     and empty barriers: the other part's slabs (read only by S^T and
//     dP^T) early, the block's own (read again by dV and dK) late with
//     the tile's lse and delta. The next tile's early group then loads
//     while this tile's P^T, dS^T, dV and dK run, and its late group
//     while its own S^T and dP^T run over the early slabs: at
//     [4,8,2048,512] that took K3 from 1.28 to 0.96 ms against the whole
//     tile on one barrier pair (NVIDIA H100 80GB HBM3, 700 W). The two
//     parts' blocks of a key block must build the same P^T and dS^T, or
//     dK's and dV's columns would come from two slightly different dS: so
//     each sums S^T (and dP^T) over the first part's slabs and over the
//     second's into two register tiles, each from zero in ascending
//     k-steps, and then adds the two, which gives the same bits in either
//     part whichever group arrived early.
//   * Causal: K2 never loads kv tiles above a block's last row and K3
//     never loads q tiles whose rows all lie above its first key; every
//     consumer computes on every tile its block walks, so the loops issue
//     their wgmmas unconditionally; only tiles that cross the diagonal are
//     masked element by element.
//   * Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at the 512-head
//     LM's [4,8,2048,512] causal call K2 0.68 and K3 0.96 ms, 3.3 and 3.5
//     times their bounds and 4.7 and 4.5 times faster than the mma.sync
//     split templates these replaced; K3's two tiles for S^T and dP^T,
//     which make its parts agree, cost it 2 to 7% (most at 384, where q
//     tiles are 64 rows). What holds them: the repeated
//     products (10 * D and 12 * D flops a pair for 6 * D and 8 * D), the
//     N = 32 products at 512 (about 192 bytes of shared memory a clock
//     at the tensor cores' rate, against 128 at N = 64) and K3's single
//     stage at 448 and 512. A 2-CTA cluster whose CTAs add each other's
//     partial S^T and dP^T (no repeated flop) came out 1.5 to 2.3 times
//     slower: every q tile waited on a round trip to the peer.
//
// flash_attn_bwd_f32tc.cu takes every f32 call.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libzoo_flash_attn_bwd_sm90.so \
//        flash_attn_bwd_sm90.cu

#include "flash_attn_sm90.cuh"

#include <type_traits>

namespace {

constexpr int kDqRows = 128;       // K2: q rows a block, two consumers of 64
constexpr int kKvTile = 64;        // K2: keys a tile of the ring
constexpr int kQTile = 64;         // K3: q rows a tile of the ring
constexpr int kEmptyArrivals = 8;  // one a consumer warp
// K3 split: named barriers of the P^T exchange between the two consumers,
// one a buffer ("full": consumer 0 wrote it; "empty": consumer 1 read it),
// over both consumer warpgroups
constexpr uint32_t kXFull = 1, kXEmpty = 3, kPair = 256;

// the head dim an instantiation is built for, for a call at head dim d:
// the next multiple of 16 up to 128 (TMA reads the columns past d as
// zeros), else d
__host__ __device__ constexpr int inst_dim(int d) {
  return d <= 128 ? (d + 15) / 16 * 16 : d;
}

// columns of a staged row: whole 64-column slabs
__host__ __device__ constexpr int width(int d) {
  return (d + kSlab - 1) / kSlab * kSlab;
}

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
// up to D = 128 by the slabs of D (the rings of D = 64 and 128), and at
// 192 and 256 (at D = 256: Q and dO 2 x 64 KB, K 2 x 32 KB, V 32 KB: 225 KB
// of the 227)
template <int SLABS> struct DqSlabCfg;
template <> struct DqSlabCfg<1> : DqTiles<3, 3, 1, 24, 240> {};
template <> struct DqSlabCfg<2> : DqTiles<3, 2, 1, 24, 240> {};
template <int D> struct DqCfg : DqSlabCfg<width(D) / kSlab> {};
template <> struct DqCfg<192> : DqTiles<2, 2, 1, 24, 240> {};
template <> struct DqCfg<256> : DqTiles<2, 1, 1, 24, 240> {};

// bytes of K2's barriers (Q, then K full, V full, K empty, V empty),
// rounded up to 16
template <int D>
__host__ __device__ constexpr int dq_bar_bytes() {
  return (8 * (1 + 2 * (DqCfg<D>::kStagesK + DqCfg<D>::kStagesV)) + 15)
      & ~15;
}

// dynamic shared memory of K2: 1024 bytes of alignment slack, Q, dO, the K
// and V stages, the barriers; with a mask launch_dq adds the count of
// listed kv tiles (16 bytes), the list and the batch row's mask
template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 1024
      + (2 * kDqRows + (DqCfg<D>::kStagesK + DqCfg<D>::kStagesV) * kKvTile)
          * width(D) * 2
      + dq_bar_bytes<D>();
}

// bytes of the list of kv tiles (4 a tile, rounded up to 16)
__host__ __device__ constexpr int list_bytes(int lk) {
  return ((lk + kKvTile - 1) / kKvTile * 4 + 15) & ~15;
}

// K3 by head dim: keys a block (two consumers of 64 each, or 64 shared by
// both, which then split the work by product), q-tile stages, blocks an SM
// and registers as DqTiles'. Up to D = 64 the split runs two blocks an SM
// (104 registers a consumer: D/2 accumulators beside S^T and P^T).
template <int KEYS, int STAGES, int BLOCKS, int PRODUCER, int CONSUMER>
struct DkvTiles {
  static constexpr int kKeys = KEYS, kStages = STAGES, kBlocks = BLOCKS;
  static constexpr int kProducerRegs = PRODUCER, kConsumerRegs = CONSUMER;
  static constexpr bool kSplit = KEYS == 64;
  static_assert(KEYS == 64 || KEYS == 128, "keys a block");
  static_assert(PRODUCER + 2 * CONSUMER <= 3 * launch_regs(BLOCKS),
                "registers");
};
// up to D = 128 by the slabs of D, and at 192 and 256 (at D = 256: K and V
// 2 x 32 KB, 2 stages of Q and dO (2 x 32 KB), the exchange 2 x 16 KB:
// 226 KB of the 227)
template <int SLABS> struct DkvSlabCfg;
template <> struct DkvSlabCfg<1> : DkvTiles<64, 3, 2, 24, 104> {};
template <> struct DkvSlabCfg<2> : DkvTiles<128, 3, 1, 24, 240> {};
template <int D> struct DkvCfg : DkvSlabCfg<width(D) / kSlab> {};
template <> struct DkvCfg<192> : DkvTiles<64, 2, 1, 24, 240> {};
template <> struct DkvCfg<256> : DkvTiles<64, 2, 1, 24, 240> {};

// bytes of K3's barriers (K and V, then full and empty a stage), rounded
// up to 16
template <int D>
__host__ __device__ constexpr int dkv_bar_bytes() {
  return (8 * (1 + 2 * DkvCfg<D>::kStages) + 15) & ~15;
}

// dynamic shared memory of K3: alignment slack, K, V, the stages of Q and
// dO, the exchange buffers (split), each stage's lse and delta, the
// barriers; with a mask launch_dkv adds 16 bytes of what the first warp
// found and E (4 bytes a column)
template <int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  using C = DkvCfg<D>;
  return 1024 + 2 * C::kKeys * width(D) * 2
      + C::kStages * 2 * kQTile * width(D) * 2
      + (C::kSplit ? 2 * 64 * kQTile * 4 : 0) + C::kStages * 2 * kQTile * 4
      + dkv_bar_bytes<D>();
}

struct Params {
  const void* o;                 // K2: O and dO, read for delta
  const void* dout;              // (K3 with a mask: dO of rows with no key)
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
  int d;                         // the call's head dim: columns stored
  float scale;                   // softmax scale
  float scale_log2;              // scale * log2(e)
  int causal;
  // kMask: the key-padding mask ([B, Lk] bytes, nonzero = real key, rows
  // 16-byte aligned)
  const uint8_t* mask;
  long long mask_sb;
};

// this thread's share of rowsum(x * y) over a bf16 row of the call's
// `chunks` 16-byte chunks (D/8 or D/8 - 1): the chunks part, part + 4, ...
// (a quad's four threads take one row). Only the last round can pass the
// call's chunks, and only up to D = 128; a chunk past them reads chunk 0
// and counts as zeros, so the loads stay unconditional (a branch around
// them slowed K2 at [48, 12, 384, 64], where the prologue weighs)
template <int D>
__device__ __forceinline__ float row_dot(const uint16_t* x, const uint16_t* y,
                                         int part, int chunks) {
  constexpr int kRounds = (D / 8 + 3) / 4;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int c = i * 4 + part;
    const bool in = D > 128 || i + 1 < kRounds || c < chunks;
    uint4 xv = *reinterpret_cast<const uint4*>(x + (in ? c : 0) * 8);
    const uint4 yv = *reinterpret_cast<const uint4*>(y + (in ? c : 0) * 8);
    if (!in) xv = make_uint4(0u, 0u, 0u, 0u);
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

// an accumulator of 64 rows x 16K columns packed as the bf16 A fragments
// of K k-steps of 16 (columns [16j, 16j + 16) are k-step j's fragment)
template <int K>
__device__ __forceinline__ void pack_a(uint32_t (&f)[K][4],
                                       const float (&x)[8 * K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    f[j][0] = pack_bf16(x[8 * j], x[8 * j + 1]);
    f[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    f[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    f[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// D[64 x 64] = A[64 x D] B[64 x D]^T, A and B K-major tiles of ceil(D/64)
// slabs in shared memory (A's slabs A_ROWS rows apart, B's 64), D/16
// k-steps, as one commit group
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

// D[64 x D] += A[64 x 64] B[64 x D], A as bf16 fragments in registers, B
// a tile of 64 rows (the K dimension) in slabs of 64 columns, MN-major
// (the slabs are the leading byte offset apart), as one commit group: a
// k-step of 16 is one wgmma of N = 64 x the whole slabs and, at a head dim
// that is not a multiple of 64, one of N = D mod 64 over the first columns
// of the last slab
template <int D>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2],
                                         uint32_t (&a)[4][4],
                                         uint32_t b_base) {
  constexpr int kFull = D / kSlab;
  constexpr int kRem = D % kSlab;
  fence_regs(d);
  fence_regs(a);
  wgmma_fence();
  const uint64_t db = sw128_desc(b_base, 64 * kSlabRow, 1024);
  const uint64_t db_rem =
      sw128_desc(b_base + kFull * 64 * kSlabRow, 64 * kSlabRow, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t off = kk * 16 * (kSlabRow / 16);
    if constexpr (kFull > 0) {
      wgmma_rs<kFull * kSlab>(
          reinterpret_cast<float (&)[kFull * kSlab / 2]>(d[0]), a[kk], db,
          off);
    }
    if constexpr (kRem > 0) {
      wgmma_rs<kRem>(
          reinterpret_cast<float (&)[kRem / 2]>(d[kFull * kSlab / 2]), a[kk],
          db_rem, off);
    }
  }
  wgmma_commit();
}

// D[64 x N] += A[64 x K] B[K x N], A as the bf16 fragments of K/16
// k-steps in registers, B whole 64-column slabs of a tile of K rows in
// shared memory, MN-major (its slabs K rows apart: the leading byte
// offset), from b_base on, as one commit group: one wgmma of N a k-step
template <int N, int K>
__device__ __forceinline__ void issue_rs_slabs(float (&d)[N / 2],
                                               uint32_t (&a)[K / 16][4],
                                               uint32_t b_base) {
  fence_regs(d);
  fence_regs(a);
  wgmma_fence();
  const uint64_t db = sw128_desc(b_base, K * kSlabRow, 1024);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    wgmma_rs<N>(d, a[kk], db, kk * 16 * (kSlabRow / 16));
  }
  wgmma_commit();
}

// D[64 x N] (+)= A[64 x 64 S] B[N x 64 S]^T over the slabs [S0, S0 + S)
// of K-major tiles in shared memory (A's slabs A_ROWS rows apart, B's N),
// 4 S k-steps, as one commit group; kAcc adds to D, else the first k-step
// overwrites it
template <int A_ROWS, int N, int S0, int S, bool kAcc>
__device__ __forceinline__ void issue_ss_slabs(float (&d)[N / 2],
                                               uint32_t a_base,
                                               uint32_t b_base) {
  static_assert(N == 32 || N == 64, "wgmma N");
  wgmma_fence();
  const uint64_t da = sw128_desc(a_base, 16, 1024);
  const uint64_t db = sw128_desc(b_base, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4 * S; ++kk) {
    const int slab = S0 + kk / 4;
    const uint32_t step = (kk & 3) * 2;
    const uint32_t a_off = slab * (A_ROWS * kSlabRow / 16) + step;
    const uint32_t b_off = slab * (N * kSlabRow / 16) + step;
    if constexpr (N == 64) {
      wgmma_ss_n64(d, da, a_off, db, b_off, kAcc || kk > 0);
    } else {
      wgmma_ss_n32(d, da, a_off, db, b_off, kAcc || kk > 0);
    }
  }
  wgmma_commit();
}

// this warp is done with stage `stage` of a ring: it may refill
__device__ __forceinline__ void release(uint32_t empty, int stage,
                                        int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + 8 * stage);
}

// the accumulator rows (rows ra, rb) of 64 x N values, as bf16 into a
// [L, D] row-major output of row stride sl, the call's d columns only
// (d is N or N - 8, so only the last 8 can be past it); with kAddE plus
// e[col] on each column
template <int N, bool kAddE>
__device__ __forceinline__ void store_rows(uint16_t* out, long long sl,
                                           int ra, int rb, int d, int t4,
                                           const float (&x)[N / 2],
                                           const float* e) {
  uint16_t* pa = out + static_cast<long long>(ra) * sl + t4 * 2;
  uint16_t* pb = out + static_cast<long long>(rb) * sl + t4 * 2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (N > 128 || j + 1 < N / 8 || j * 8 < d) {
      float x0 = x[j * 4], x1 = x[j * 4 + 1];
      float x2 = x[j * 4 + 2], x3 = x[j * 4 + 3];
      if constexpr (kAddE) {
        const float e0 = e[j * 8 + t4 * 2], e1 = e[j * 8 + t4 * 2 + 1];
        x0 += e0;
        x1 += e1;
        x2 += e0;
        x3 += e1;
      }
      *reinterpret_cast<uint32_t*>(pa + j * 8) = pack_bf16(x0, x1);
      *reinterpret_cast<uint32_t*>(pb + j * 8) = pack_bf16(x2, x3);
    }
  }
}

// ------------------------------------------------------------------ K2 --
template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads, DqCfg<D>::kBlocks)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const Params p) {
  using C = DqCfg<D>;
  constexpr int kSK = C::kStagesK;
  constexpr int kSV = C::kStagesV;
  constexpr int kSlabs = width(D) / kSlab;
  constexpr int kRowBytes = kDqRows * width(D) * 2;  // Q (or dO) of a block
  constexpr int kKvBytes = kKvTile * width(D) * 2;   // one K (or V) tile
  static_assert(D % 16 == 0, "head dim: a multiple of 16 (k-steps)");
  static_assert(!kMask || D <= 128, "a mask only up to D = 128");

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
  // kMask: the count and list of the kv tiles that hold a real key, and
  // the batch row's mask, written once before the walk and only read in
  // it (generic pointers)
  uint8_t* const after_bars = smem_raw + (barQ + dq_bar_bytes<D>() - raw);
  int* const n_live = reinterpret_cast<int*>(after_bars);
  int* const live = n_live + 4;
  uint8_t* const row_mask = after_bars + 16 + list_bytes(p.lk);

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int q0 = qt * kDqRows;
  const int offset = p.lk - p.lq;

  // kv tiles this block may walk: up to its last real row's last key
  int n_tiles = p.lk / kKvTile;
  if (p.causal) {
    const int last_row = min(q0 + kDqRows, p.lq) - 1;
    n_tiles = min(n_tiles, (last_row + offset) / kKvTile + 1);
  }

  // Q's and dO's load: one TMA box a slab of each on barQ
  auto load_rows = [&]() {
    mbar_expect_tx(barQ, 2 * kRowBytes);
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      tma_load(sQ + s * kDqRows * kSlabRow, &tq, barQ, s * kSlab, q0, hh, b);
      tma_load(sDO + s * kDqRows * kSlabRow, &tdo, barQ, s * kSlab, q0, hh,
               b);
    }
  };

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
    // with a mask Q's and dO's load go first, so the list below is made
    // under them
    if constexpr (kMask) load_rows();
  }
  if constexpr (kMask) {
    // the first warp stages the batch row's mask (the keys of the tiles
    // this block may walk) and lists, in order, the kv tiles with a real
    // key: 32 tiles a round, one a lane, compacted by a ballot
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const uint8_t* mrow = p.mask + b * p.mask_sb;
      int n = 0;
      for (int base = 0; base < n_tiles; base += 32) {
        const int kt = base + lane;
        bool real = false;
        if (kt < n_tiles) {
          const uint4* src = reinterpret_cast<const uint4*>(mrow
                                                            + kt * kKvTile);
          uint4* dst = reinterpret_cast<uint4*>(row_mask + kt * kKvTile);
#pragma unroll
          for (int i = 0; i < kKvTile / 16; ++i) {
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
                 :: "n"(C::kProducerRegs));
    if (threadIdx.x == 0) {
      if constexpr (!kMask) load_rows();
      // K, then V of each walked tile, the order the consumers use them
      // in; each waits for its stage's previous tile to be released (the
      // first round finds every stage empty)
      auto load = [&](const CUtensorMap* map, uint32_t full, uint32_t empty,
                      uint32_t base, int stages, int i) {
        const int stage = i % stages;
        mbar_wait(empty + 8 * stage, ((i / stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * stage, kKvBytes);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(base + stage * kKvBytes + s * kKvTile * kSlabRow, map,
                   full + 8 * stage, s * kSlab, tile(i) * kKvTile, hh, b);
        }
      };
      for (int i = 0; i < n_walk; ++i) {
        load(&tk, fullK, emptyK, sK, kSK, i);
        load(&tv, fullV, emptyV, sV, kSV, i);
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
  // walked tiles this consumer computes on, a prefix of the walk: all of
  // them, or, causal, those up to its own last row's last key; none past
  // Lq
  int n_mine = 0;
  if (active) {
    n_mine = n_walk;
    if (p.causal) {
      const int last = (r0 + 63 + offset) / kKvTile;
      if constexpr (kMask) {
        while (n_mine > 0 && live[n_mine - 1] > last) --n_mine;
      } else {
        n_mine = min(n_walk, last + 1);
      }
    }
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
    const int chunks = p.d / 8;
    del_a = row_dot<D>(o + ra * p.o_sl, dout + ra * p.do_sl, t4, chunks);
    del_b = row_dot<D>(o + rb * p.o_sl, dout + rb * p.do_sl, t4, chunks);
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

  // kMask: kv tile kt's mask for this thread's keys as bits (key
  // j * 8 + t4 * 2 + e of the tile at bit 2j + e), from the staged row
  auto mask_bits = [&](int kt) {
    uint32_t bits = 0;
    if constexpr (kMask) {
      const uint8_t* m = row_mask + kt * kKvTile + t4 * 2;
#pragma unroll
      for (int j = 0; j < kKvTile / 8; ++j) {
        const uint32_t w = *reinterpret_cast<const uint16_t*>(m + j * 8);
        bits |= static_cast<uint32_t>((w & 0xffu) != 0u) << (2 * j);
        bits |= static_cast<uint32_t>((w >> 8) != 0u) << (2 * j + 1);
      }
    }
    return bits;
  };

  // The tiles a consumer computes on are a prefix of the walk (i <
  // n_mine), so the loop issues its products unconditionally (ptxas
  // serializes every wgmma where it cannot tell how many groups a wait
  // leaves in flight); past it, the consumer only waits and releases.
  for (int i = 0; i < n_mine; ++i) {
    const int sk = i % kSK;
    const int sv = i % kSV;
    const uint32_t k_base = sK + sk * kKvBytes;
    mbar_wait(fullK + 8 * sk, (i / kSK) & 1);
    issue_ss<D, kDqRows>(s, q_base, k_base);
    mbar_wait(fullV + 8 * sv, (i / kSV) & 1);
    issue_ss<D, kDqRows>(dp, do_base, sV + sv * kKvBytes);
    // S done; dP may still run
    wgmma_wait<1>();
    fence_regs(s);
    // P = 2^(scale * log2(e) * S - lse * log2(e)); padded keys are masked
    // in every tile, the diagonal only in a tile that crosses it (a row
    // that sees no key overflows here, and every one of its pairs is
    // masked)
    const int kt = tile(i);
    const uint32_t bits = mask_bits(kt);
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
        if constexpr (kMask) {
          if (!((bits >> (2 * j + (e & 1))) & 1u)) pr = 0.f;
        }
        s[j * 4 + e] = pr;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    release(emptyV, sv, lane);
    // dS = P (dP - delta) scale
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      s[k] = s[k] * (dp[k] - ((k & 2) ? del_b : del_a)) * p.scale;
    }
    pack_a(df, s);
    issue_rs<D>(acc, df, k_base);
    wgmma_wait<0>();
    fence_regs(acc);
    release(emptyK, sk, lane);
  }
  for (int i = n_mine; i < n_walk; ++i) {
    mbar_wait(fullK + 8 * (i % kSK), (i / kSK) & 1);
    release(emptyK, i % kSK, lane);
    mbar_wait(fullV + 8 * (i % kSV), (i / kSV) & 1);
    release(emptyV, i % kSV, lane);
  }

  if (!active) return;
  store_rows<D, false>(
      static_cast<uint16_t*>(p.dq) + b * p.dq_sb + hh * p.dq_sh, p.dq_sl, ra,
      rb, p.d, t4, acc, nullptr);
}

// ------------------------------------------------------------------ K3 --
template <int D, bool kMask>
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
  constexpr int kSlabs = width(D) / kSlab;
  constexpr int kKeyBytes = kKeys * width(D) * 2;  // K (or V) of the block
  constexpr int kQBytes = kQTile * width(D) * 2;   // one Q (or dO) tile
  constexpr int kXBytes = 64 * kQTile * 4;         // one P^T exchange buffer
  constexpr int kRowF32 = kQTile * 4;              // a tile's lse (or delta)
  static_assert(D % 16 == 0, "head dim: a multiple of 16 (k-steps)");
  static_assert(!kMask || D <= 128, "a mask only up to D = 128");

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
  // kMask: what the first warp found (the ballot of the block's 16-key
  // chunks that hold a real key), then E, the dV share of the rows that
  // see no key (a float a column); written once before the walk
  uint32_t* const found = reinterpret_cast<uint32_t*>(
      at(barKV + dkv_bar_bytes<D>()));
  float* const e_vec = reinterpret_cast<float*>(found + 4);

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
  const uint8_t* const mrow = kMask ? p.mask + b * p.mask_sb : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(barKV, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if constexpr (kMask) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      // the batch row's first real key (Lk if it has none): 16 keys a lane,
      // 512 a round
      int first_real = p.lk;
      for (int base = 0; base < p.lk; base += 32 * 16) {
        const int key = base + lane * 16;
        int at_key = p.lk;
        if (key < p.lk) {
          const uint4 x = *reinterpret_cast<const uint4*>(mrow + key);
          const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int j = 3; j >= 0; --j) {
            if (w[j] != 0u) at_key = key + 4 * j + (__ffs(w[j]) - 1) / 8;
          }
        }
        at_key = __reduce_min_sync(0xffffffffu, at_key);
        if (at_key < p.lk) {
          first_real = at_key;
          break;
        }
      }
      // which 16-key chunks of the block's keys hold a real key
      const int key = k0 + lane * 16;
      bool real = false;
      if (lane < kKeys / 16 && key < p.lk) {
        const uint4 x = *reinterpret_cast<const uint4*>(mrow + key);
        real = (x.x | x.y | x.z | x.w) != 0u;
      }
      const uint32_t ballot = __ballot_sync(0xffffffffu, real);
      // the rows that see no key are the first n_empty of the (b, h): E =
      // bf16(1/Lk) * the sum of their dO rows, lane l taking columns
      // 64n + 2l and 64n + 2l + 1
      const int n_empty = p.causal
          ? min(max(first_real - offset, 0), p.lq)
          : (first_real == p.lk ? p.lq : 0);
      const float inv_lk = __bfloat162float(__float2bfloat16(1.f / p.lk));
      const uint16_t* dout = static_cast<const uint16_t*>(p.dout)
          + b * p.do_sb + hh * p.do_sh;
#pragma unroll
      for (int n = 0; n < kSlabs; ++n) {
        const int col = n * kSlab + 2 * lane;
        float e0 = 0.f, e1 = 0.f;
        if (col < p.d) {
          for (int i = 0; i < n_empty; ++i) {
            const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
                dout + static_cast<long long>(i) * p.do_sl + col);
            e0 += __low2float(x);
            e1 += __high2float(x);
          }
        }
        e_vec[col] = e0 * inv_lk;
        e_vec[col + 1] = e1 * inv_lk;
      }
      if (lane == 0) *found = ballot;
    }
  }
  __syncthreads();
  // kMask: whether each 64 keys of the block hold a real key; a block
  // whose keys are all padding walks no q tile
  const uint32_t chunks = kMask ? *found : 0xffffffffu;
  const bool live0 = (chunks & 0xfu) != 0u;
  const bool live1 = (chunks & 0xf0u) != 0u;
  const int n_walk = (live0 || (!kSplit && live1)) ? n_tiles : 0;

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(C::kProducerRegs));
    if (threadIdx.x == 0 && n_walk > 0) {
      mbar_expect_tx(barKV, 2 * kKeyBytes);
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        tma_load(sK + s * kKeys * kSlabRow, &tk, barKV, s * kSlab, k0, hh, b);
        tma_load(sV + s * kKeys * kSlabRow, &tv, barKV, s * kSlab, k0, hh, b);
      }
      const long long row0 = static_cast<long long>(bh) * p.lq;
      for (int i = 0; i < n_walk; ++i) {
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
  // whether it computes: it has keys, and with a mask a real one among
  // them (else it only waits for each tile and releases it)
  const bool computes = active && n_walk > 0
      && (kSplit || (c == 0 ? live0 : live1));
  // the tiles it computes on are a suffix of the walk: from the first whose
  // rows see its first key
  int first_mine = computes ? first : n_qt;
  if (computes && p.causal) {
    first_mine = max(first, min(n_qt, max(0, kc0 - offset) / kQTile));
  }
  const int n_skip = min(first_mine - first, n_walk);
  // kMask: whether each of its two keys is real (padded keys get P = 0)
  const bool real_a = !kMask || !active || mrow[ka] != 0;
  const bool real_b = !kMask || !active || mrow[kb] != 0;

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
  if (computes) mbar_wait(barKV, 0);

  float s[32];             // S^T (then P^T; or dP^T, then dS^T)
  uint32_t pf[4][4];       // as bf16 A fragments

  if constexpr (!kSplit) {
    float dp[32];          // dP^T, then dS^T
    uint32_t df[4][4];
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    for (int i = n_skip; i < n_walk; ++i) {
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
      // row does not see the consumer's last key is masked on the
      // diagonal
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
          if constexpr (kMask) {
            if (!((e < 2) ? real_a : real_b)) pr = 0.f;
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
    store_rows<D, false>(
        static_cast<uint16_t*>(p.dk) + b * p.dk_sb + hh * p.dk_sh, p.dk_sl,
        ka, kb, p.d, t4, acc_k, nullptr);
    store_rows<D, kMask>(
        static_cast<uint16_t*>(p.dv) + b * p.dv_sb + hh * p.dv_sh, p.dv_sl,
        ka, kb, p.d, t4, acc_v, e_vec);
  } else {
    // consumer 0: S^T, P^T, dV += P~^T dO; consumer 1: dP^T, dS^T (with
    // consumer 0's P^T), dK += dS^T Q. The same products, so the same
    // code with other operands
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t a_rows = c == 0 ? k_rows : v_rows;
    for (int i = 0; i < n_walk; ++i) {
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
            if constexpr (kMask) {
              if (!((e < 2) ? real_a : real_b)) pr = 0.f;
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
        if (i + 2 < n_walk) named_arrive(kXEmpty + xb, kPair);
      }
      pack_a(pf, s);
      issue_rs<D>(acc, pf, c == 0 ? ds : qs);
      wgmma_wait<0>();
      fence_regs(acc);
      release(empty, stage, lane);
    }
    if (c == 0) {
      store_rows<D, kMask>(
          static_cast<uint16_t*>(p.dv) + b * p.dv_sb + hh * p.dv_sh, p.dv_sl,
          ka, kb, p.d, t4, acc, e_vec);
    } else {
      store_rows<D, false>(
          static_cast<uint16_t*>(p.dk) + b * p.dk_sb + hh * p.dk_sh, p.dk_sl,
          ka, kb, p.d, t4, acc, nullptr);
    }
  }
}

// ------------------------------------------------ head dims 320 to 512 --
// The split kernels (the header's notes): K2 a block of 64 q rows that
// both consumers hold, each computing S and dP over all of D and dQ over
// its own run of slabs; K3 a block of 64 keys and one part of D (two
// blocks a key block), its consumers splitting the products as at 192
// and 256.

constexpr int kSplitRows = 64;     // K2: q rows a block; K3: keys a block
constexpr uint32_t kDeltaBar = 1;  // K2: the two consumers' delta parts
// registers a producer and a consumer thread keep after setmaxnreg, one
// block an SM; setmaxnreg.inc draws on the block's own pool
constexpr int kSplitProducerRegs = 24, kSplitConsumerRegs = 240;
static_assert(kSplitProducerRegs + 2 * kSplitConsumerRegs
                  <= 3 * launch_regs(1), "registers");

// the first part's whole slabs of D (K2: consumer 0's of dQ; K3: block
// part 0's of dK and dV), ceil(D/128) of them; the second part has the rest
__host__ __device__ constexpr int split_slabs0(int d) {
  return (d / kSlab + 1) / 2;
}

// K2 above 256: keys a kv tile and the K and V stages of the ring. Q and
// dO of 64 rows take 128 KB at D = 512, so its tiles are 32 keys there;
// at 320 tiles of 64 keys beat 32-key tiles in deeper rings (4 K and 3 V
// stages) by a fifth, and were level at 384 and 448 (NVIDIA H100 80GB
// HBM3, 700 W)
template <int KV, int SK, int SV>
struct DqSplitTiles {
  static constexpr int kKv = KV, kStagesK = SK, kStagesV = SV;
};
template <int D> struct DqSplitCfg;
template <> struct DqSplitCfg<320> : DqSplitTiles<64, 2, 1> {};
template <> struct DqSplitCfg<384> : DqSplitTiles<64, 1, 1> {};
template <> struct DqSplitCfg<448> : DqSplitTiles<64, 1, 1> {};
template <> struct DqSplitCfg<512> : DqSplitTiles<32, 2, 1> {};

// bytes of K2's barriers above 256 (Q, then K full, V full, K empty, V
// empty), rounded up to 16
template <int D>
__host__ __device__ constexpr int dq_split_bar_bytes() {
  using C = DqSplitCfg<D>;
  return (8 * (1 + 2 * (C::kStagesK + C::kStagesV)) + 15) & ~15;
}

// dynamic shared memory of K2 above 256: alignment slack, Q, dO, the K
// and V stages, the barriers, the delta parts (two of 64 floats)
template <int D>
__host__ __device__ constexpr int dq_split_smem_bytes() {
  using C = DqSplitCfg<D>;
  return 1024
      + (2 * kSplitRows + (C::kStagesK + C::kStagesV) * C::kKv) * D * 2
      + dq_split_bar_bytes<D>() + 2 * kSplitRows * 4;
}

// K3 above 256: q rows a tile and the stages of the ring. K and V of 64
// keys take 128 KB at D = 512, so its q tiles are 32 rows at 448 and 512;
// at 320 and 384 one stage of 64-row tiles was faster than two of 32
// rows on an H100 (the products over D then run at N = 64)
template <int QT, int STAGES>
struct DkvSplitTiles {
  static constexpr int kQt = QT, kStages = STAGES;
};
template <int D> struct DkvSplitCfg;
template <> struct DkvSplitCfg<320> : DkvSplitTiles<64, 1> {};
template <> struct DkvSplitCfg<384> : DkvSplitTiles<64, 1> {};
template <> struct DkvSplitCfg<448> : DkvSplitTiles<32, 1> {};
template <> struct DkvSplitCfg<512> : DkvSplitTiles<32, 1> {};

// bytes of K3's barriers above 256 (K and V, then a stage's early and
// late slabs: full early, full late, empty early, empty late), rounded up
// to 16
template <int D>
__host__ __device__ constexpr int dkv_split_bar_bytes() {
  return (8 * (1 + 4 * DkvSplitCfg<D>::kStages) + 15) & ~15;
}

// dynamic shared memory of K3 above 256: alignment slack, K and V of 64
// keys, the stages of Q and dO, the two P^T exchange buffers, each
// stage's lse and delta, the barriers
template <int D>
__host__ __device__ constexpr int dkv_split_smem_bytes() {
  using C = DkvSplitCfg<D>;
  return 1024 + 2 * kSplitRows * D * 2 + C::kStages * 2 * C::kQt * D * 2
      + 2 * kSplitRows * C::kQt * 4 + C::kStages * 2 * C::kQt * 4
      + dkv_split_bar_bytes<D>();
}

// One consumer warpgroup (c) of flash_bwd_dq_sm90_split_kernel<D>: the
// block's 64 rows, delta (its part over its own columns, then both parts
// added through shared memory), S and dP over all of D, and dQ over the
// kN columns from slab kSlab0 on, which it stores. The barriers and the
// shared-memory layout are the kernel's.
template <int D, int kSlab0, int kN>
__device__ __forceinline__ void dq_split_consumer(
    const Params& p, uint32_t sQ, uint32_t sDO, uint32_t sK, uint32_t sV,
    uint32_t barQ, uint32_t fullK, uint32_t fullV, uint32_t emptyK,
    uint32_t emptyV, float* xdel, int c, int n_tiles, int q0, int b, int hh,
    int bh) {
  using C = DqSplitCfg<D>;
  constexpr int kKv = C::kKv;
  constexpr int kSK = C::kStagesK;
  constexpr int kSV = C::kStagesV;
  constexpr int kKvBytes = kKv * D * 2;  // one K (or V) tile
  const int t = threadIdx.x % 128;       // thread within the warpgroup
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;               // accumulator row within 8
  const int t4 = lane & 3;               // thread within the quad
  const int ia = warp * 16 + g;          // the thread's two rows in the
  const int ra = q0 + ia;                // block, and in the call
  const int rb = ra + 8;
  const int offset = p.lk - p.lq;
  // the last visible key of each of the two rows, and of the block's
  // first row (the one that sees fewest)
  const int lim_a = p.causal ? min(ra + offset, p.lk - 1) : p.lk - 1;
  const int lim_b = p.causal ? min(rb + offset, p.lk - 1) : p.lk - 1;
  const int lim_first = p.causal ? min(q0 + offset, p.lk - 1) : p.lk - 1;

  // delta = rowsum(dO * O) of the thread's two rows: this consumer's kN
  // columns here, then the two parts added in one order through shared
  // memory, so both consumers hold the same delta; the first writes it
  // out for K3
  const uint16_t* o = static_cast<const uint16_t*>(p.o) + b * p.o_sb
      + hh * p.o_sh + kSlab0 * kSlab;
  const uint16_t* dout = static_cast<const uint16_t*>(p.dout) + b * p.do_sb
      + hh * p.do_sh + kSlab0 * kSlab;
  float part_a = row_dot<kN>(o + ra * p.o_sl, dout + ra * p.do_sl, t4,
                             kN / 8);
  float part_b = row_dot<kN>(o + rb * p.o_sl, dout + rb * p.do_sl, t4,
                             kN / 8);
  part_a += __shfl_xor_sync(0xffffffffu, part_a, 1);
  part_a += __shfl_xor_sync(0xffffffffu, part_a, 2);
  part_b += __shfl_xor_sync(0xffffffffu, part_b, 1);
  part_b += __shfl_xor_sync(0xffffffffu, part_b, 2);
  if (t4 == 0) {
    xdel[c * kSplitRows + ia] = part_a;
    xdel[c * kSplitRows + ia + 8] = part_b;
  }
  named_sync(kDeltaBar, kPair);
  const float del_a = xdel[ia] + xdel[kSplitRows + ia];
  const float del_b = xdel[ia + 8] + xdel[kSplitRows + ia + 8];
  const long long at = static_cast<long long>(bh) * p.lq;
  if (c == 0 && t4 == 0) {
    p.delta[at + ra] = del_a;
    p.delta[at + rb] = del_b;
  }
  const float lse_a = p.lse[at + ra] * kLog2e;
  const float lse_b = p.lse[at + rb] * kLog2e;

  float acc[kN / 2];       // this consumer's columns of dQ
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  float s[kKv / 2], dp[kKv / 2];  // S (then P, then dS), dP of one tile
  uint32_t df[kKv / 16][4];       // dS as bf16 A fragments

  mbar_wait(barQ, 0);
  // both consumers compute on every tile the block walks (they hold the
  // same rows), so the loop issues its products unconditionally
  for (int i = 0; i < n_tiles; ++i) {
    const int sk = i % kSK;
    const int sv = i % kSV;
    const uint32_t k_base = sK + sk * kKvBytes;
    mbar_wait(fullK + 8 * sk, (i / kSK) & 1);
    issue_ss_slabs<kSplitRows, kKv, 0, D / kSlab, false>(s, sQ, k_base);
    mbar_wait(fullV + 8 * sv, (i / kSV) & 1);
    issue_ss_slabs<kSplitRows, kKv, 0, D / kSlab, false>(dp, sDO,
                                                         sV + sv * kKvBytes);
    // S done; dP may still run
    wgmma_wait<1>();
    fence_regs(s);
    // P = 2^(scale * log2(e) * S - lse * log2(e)), the diagonal masked
    // only in a tile that crosses it. Both consumers compute the same S
    // from the same shared memory with the same instructions, so their P
    // agree bit for bit
    const int key0 = i * kKv;
    const bool edge = key0 + kKv - 1 > lim_first;
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j) {
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
    for (int k = 0; k < kKv / 2; ++k) {
      s[k] = s[k] * (dp[k] - ((k & 2) ? del_b : del_a)) * p.scale;
    }
    pack_a(df, s);
    // dQ += dS K over this consumer's slabs of K (read MN-major)
    issue_rs_slabs<kN, kKv>(acc, df, k_base + kSlab0 * kKv * kSlabRow);
    wgmma_wait<0>();
    fence_regs(acc);
    release(emptyK, sk, lane);
  }

  store_rows<kN, false>(
      static_cast<uint16_t*>(p.dq) + b * p.dq_sb + hh * p.dq_sh
          + kSlab0 * kSlab,
      p.dq_sl, ra, rb, kN, t4, acc, nullptr);
}

// K2 bf16 at D in {320, 384, 448, 512}, without a mask: 64 q rows a
// block, a producer warpgroup and two consumers that split dQ's columns
// between them (dq_split_consumer)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_split_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const Params p) {
  using C = DqSplitCfg<D>;
  constexpr int kKv = C::kKv;
  constexpr int kSK = C::kStagesK;
  constexpr int kSV = C::kStagesV;
  constexpr int kSlabs = D / kSlab;
  constexpr int kSlabs0 = split_slabs0(D);
  constexpr int kRowBytes = kSplitRows * D * 2;  // Q (or dO) of a block
  constexpr int kKvBytes = kKv * D * 2;          // one K (or V) tile
  static_assert(D % kSlab == 0 && D > 256 && D <= 512, "head dim");
  static_assert(dq_split_smem_bytes<D>() <= 232448, "shared memory");

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
  float* const xdel = reinterpret_cast<float*>(
      smem_raw + (barQ + dq_split_bar_bytes<D>() - raw));

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal blocks first
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int q0 = qt * kSplitRows;
  // kv tiles this block walks: up to its last row's last key
  int n_tiles = p.lk / kKv;
  if (p.causal) {
    n_tiles = min(n_tiles, (q0 + kSplitRows - 1 + p.lk - p.lq) / kKv + 1);
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

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kSplitProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(barQ, 2 * kRowBytes);
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        tma_load(sQ + s * kSplitRows * kSlabRow, &tq, barQ, s * kSlab, q0,
                 hh, b);
        tma_load(sDO + s * kSplitRows * kSlabRow, &tdo, barQ, s * kSlab, q0,
                 hh, b);
      }
      // K, then V of each tile, the order the consumers use them in;
      // each waits for its stage's previous tile to be released by both
      // consumers
      auto load = [&](const CUtensorMap* map, uint32_t full, uint32_t empty,
                      uint32_t base, int stages, int i) {
        const int stage = i % stages;
        mbar_wait(empty + 8 * stage, ((i / stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * stage, kKvBytes);
#pragma unroll
        for (int s = 0; s < kSlabs; ++s) {
          tma_load(base + stage * kKvBytes + s * kKv * kSlabRow, map,
                   full + 8 * stage, s * kSlab, i * kKv, hh, b);
        }
      };
      for (int i = 0; i < n_tiles; ++i) {
        load(&tk, fullK, emptyK, sK, kSK, i);
        load(&tv, fullV, emptyV, sV, kSV, i);
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kSplitConsumerRegs));
  const int c = wg - 1;
  if (c == 0) {
    dq_split_consumer<D, 0, kSlabs0 * kSlab>(
        p, sQ, sDO, sK, sV, barQ, fullK, fullV, emptyK, emptyV, xdel, c,
        n_tiles, q0, b, hh, bh);
  } else {
    dq_split_consumer<D, kSlabs0, (kSlabs - kSlabs0) * kSlab>(
        p, sQ, sDO, sK, sV, barQ, fullK, fullV, emptyK, emptyV, xdel, c,
        n_tiles, q0, b, hh, bh);
  }
}

// One consumer warpgroup (c) of flash_bwd_dkv_sm90_split_kernel<D>, for
// the block's 64 keys and the kN columns of D from slab kSlab0 on:
// consumer 0 computes S^T over all of D, forms P^T and accumulates
// dV += P~^T dO over those columns; consumer 1 computes dP^T over all of
// D, takes P^T from consumer 0 through shared memory, forms dS^T and
// accumulates dK += dS^T Q over them. A q tile's slabs arrive in two
// groups: the early ones (the other part's columns, read only by S^T and
// dP^T) and the late ones (these columns, read again by dV and dK, with
// the tile's lse and delta), each with its full and empty barriers, so
// the early group of the next tile loads while this tile's dV and dK run.
// The barriers and the shared-memory layout are the kernel's.
template <int D, int kSlab0, int kN>
__device__ __forceinline__ void dkv_split_consumer(
    const Params& p, uint32_t sK, uint32_t sV, uint32_t sQ, uint32_t sX,
    uint32_t sRow, uint32_t barKV, uint32_t fullE, uint32_t fullL,
    uint32_t emptyE, uint32_t emptyL, uint8_t* smem_raw, uint32_t raw, int c,
    int n_walk, int first, int k0, int b, int hh) {
  using C = DkvSplitCfg<D>;
  constexpr int kQt = C::kQt;
  constexpr int kStages = C::kStages;
  constexpr int kOwn = kN / kSlab;                        // late slabs
  constexpr int kEarly0 = kSlab0 == 0 ? kOwn : 0;         // early slabs
  constexpr int kEarly = D / kSlab - kOwn;
  constexpr int kQBytes = kQt * D * 2;          // one Q (or dO) tile
  constexpr int kXBytes = kSplitRows * kQt * 4;  // one P^T exchange buffer
  constexpr int kRowF32 = kQt * 4;               // a tile's lse (or delta)
  const int t = threadIdx.x % 128;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ka = k0 + warp * 16 + g;    // the two keys a thread holds
  const int kb = ka + 8;
  const int offset = p.lk - p.lq;
  const float scale = p.scale;
  const float scale_log2 = p.scale_log2;
  // the generic address of shared-memory address a
  auto at = [&](uint32_t a) { return smem_raw + (a - raw); };

  float acc[kN / 2];       // dV (consumer 0) or dK (consumer 1), kN columns
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  float s[kQt / 2];        // S^T (then P^T), or dP^T (then dS^T)
  float se[kQt / 2];       // its part over the early slabs
  uint32_t pf[kQt / 16][4];  // as bf16 A fragments
  // A operand: the block's 64 keys of K (consumer 0) or V (consumer 1)
  const uint32_t a_rows = c == 0 ? sK : sV;

  mbar_wait(barKV, 0);
  // both consumers compute on every q tile the block walks (the same
  // keys), so the loop issues its products unconditionally
  for (int i = 0; i < n_walk; ++i) {
    const int stage = i % kStages;
    const int q0 = (first + i) * kQt;
    const uint32_t qs = sQ + stage * 2 * kQBytes;
    const uint32_t ds = qs + kQBytes;
    const float* lse = reinterpret_cast<const float*>(
        at(sRow + stage * 2 * kRowF32));
    const float* del = lse + kQt;
    const uint32_t xb = i & 1;
    float4* x = reinterpret_cast<float4*>(at(sX + xb * kXBytes));
    const uint32_t parity = (i / kStages) & 1;
    // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1), over all
    // of D: the early slabs into se and the late ones into s, each from
    // zero, then s += se. Both parts' blocks build the same two tiles
    // (the first part's slabs, and the second's; only which of them
    // comes early differs) with the same k-steps, and a sum of two is
    // the same either way round, so their P^T and dS^T agree bit for bit
    const uint32_t b_tile = c == 0 ? qs : ds;
    mbar_wait(fullE + 8 * stage, parity);
    issue_ss_slabs<kSplitRows, kQt, kEarly0, kEarly, false>(se, a_rows,
                                                            b_tile);
    mbar_wait(fullL + 8 * stage, parity);
    issue_ss_slabs<kSplitRows, kQt, kSlab0, kOwn, false>(s, a_rows, b_tile);
    wgmma_wait<0>();
    fence_regs(se);
    fence_regs(s);
    release(emptyE, stage, lane);
#pragma unroll
    for (int j = 0; j < kQt / 2; ++j) s[j] += se[j];
    if (c == 0) {
      // P^T; the columns are queries. Only a tile whose first row does
      // not see the block's last key is masked on the diagonal
      const bool edge = p.causal && k0 + kSplitRows - 1 > q0 + offset;
#pragma unroll
      for (int j = 0; j < kQt / 8; ++j) {
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
      for (int j = 0; j < kQt / 8; ++j) {
        x[j * 128 + t] = make_float4(s[j * 4], s[j * 4 + 1], s[j * 4 + 2],
                                     s[j * 4 + 3]);
      }
      named_arrive(kXFull + xb, kPair);
    } else {
      named_sync(kXFull + xb, kPair);
#pragma unroll
      for (int j = 0; j < kQt / 8; ++j) {
        const int col = j * 8 + t4 * 2;
        const float2 d2 = *reinterpret_cast<const float2*>(del + col);
        const float4 pv = x[j * 128 + t];
        s[j * 4] = pv.x * (s[j * 4] - d2.x) * scale;
        s[j * 4 + 1] = pv.y * (s[j * 4 + 1] - d2.y) * scale;
        s[j * 4 + 2] = pv.z * (s[j * 4 + 2] - d2.x) * scale;
        s[j * 4 + 3] = pv.w * (s[j * 4 + 3] - d2.y) * scale;
      }
      // consumer 0 writes this buffer again two tiles on, if any
      if (i + 2 < n_walk) named_arrive(kXEmpty + xb, kPair);
    }
    pack_a(pf, s);
    // dV += P~^T dO (consumer 0) or dK += dS^T Q (consumer 1) over the
    // kN columns from slab kSlab0 on (read MN-major)
    issue_rs_slabs<kN, kQt>(acc, pf,
                            (c == 0 ? ds : qs) + kSlab0 * kQt * kSlabRow);
    wgmma_wait<0>();
    fence_regs(acc);
    release(emptyL, stage, lane);
  }

  if (c == 0) {
    store_rows<kN, false>(
        static_cast<uint16_t*>(p.dv) + b * p.dv_sb + hh * p.dv_sh
            + kSlab0 * kSlab,
        p.dv_sl, ka, kb, kN, t4, acc, nullptr);
  } else {
    store_rows<kN, false>(
        static_cast<uint16_t*>(p.dk) + b * p.dk_sb + hh * p.dk_sh
            + kSlab0 * kSlab,
        p.dk_sl, ka, kb, kN, t4, acc, nullptr);
  }
}

// K3 bf16 at D in {320, 384, 448, 512}, without a mask: a block owns 64
// keys and one part of D (blockIdx.x = 2 x key block + part), a producer
// warpgroup and two consumers that split the products
// (dkv_split_consumer)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_split_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const Params p) {
  using C = DkvSplitCfg<D>;
  constexpr int kQt = C::kQt;
  constexpr int kStages = C::kStages;
  constexpr int kSlabs = D / kSlab;
  constexpr int kSlabs0 = split_slabs0(D);
  constexpr int kKeyBytes = kSplitRows * D * 2;  // K (or V) of the block
  constexpr int kQBytes = kQt * D * 2;           // one Q (or dO) tile
  constexpr int kXBytes = kSplitRows * kQt * 4;  // one P^T exchange buffer
  constexpr int kRowF32 = kQt * 4;               // a tile's lse (or delta)
  static_assert(D % kSlab == 0 && D > 256 && D <= 512, "head dim");
  static_assert(dkv_split_smem_bytes<D>() <= 232448, "shared memory");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + kKeyBytes;
  const uint32_t sQ = sV + kKeyBytes;       // stage s: Q, then dO
  const uint32_t sX = sQ + kStages * 2 * kQBytes;
  const uint32_t sRow = sX + 2 * kXBytes;   // stage s: lse, then delta
  const uint32_t barKV = sRow + kStages * 2 * kRowF32;
  const uint32_t fullE = barKV + 8;           // 8 bytes a barrier
  const uint32_t fullL = fullE + 8 * kStages;
  const uint32_t emptyE = fullL + 8 * kStages;
  const uint32_t emptyL = emptyE + 8 * kStages;

  const int part = blockIdx.x & 1;
  const int k0 = (blockIdx.x >> 1) * kSplitRows;
  const int bh = blockIdx.y;
  const int b = bh / p.h;
  const int hh = bh - b * p.h;
  const int offset = p.lk - p.lq;
  const int n_qt = p.lq / kQt;
  // the first q tile with a row that sees the block's first key (the last
  // row sees every key, so there is one)
  const int first = p.causal ? min(n_qt - 1, max(0, k0 - offset) / kQt)
                             : 0;
  const int n_walk = n_qt - first;

  if (threadIdx.x == 0) {
    mbar_init(barKV, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(fullE + 8 * s, 1);
      mbar_init(fullL + 8 * s, 1);
      mbar_init(emptyE + 8 * s, kEmptyArrivals);
      mbar_init(emptyL + 8 * s, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kSplitProducerRegs));
    if (threadIdx.x == 0) {
      // this part's slabs [own0, own0 + n_own) arrive late; the others
      // early
      const int own0 = part == 0 ? 0 : kSlabs0;
      const int n_own = part == 0 ? kSlabs0 : kSlabs - kSlabs0;
      mbar_expect_tx(barKV, 2 * kKeyBytes);
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
        tma_load(sK + s * kSplitRows * kSlabRow, &tk, barKV, s * kSlab, k0,
                 hh, b);
        tma_load(sV + s * kSplitRows * kSlabRow, &tv, barKV, s * kSlab, k0,
                 hh, b);
      }
      const long long row0 = static_cast<long long>(bh) * p.lq;
      // Q's and dO's slabs s of q tile q0 into a stage, on barrier bar
      auto load_slab = [&](uint32_t qs, uint32_t bar, int s, int q0) {
        tma_load(qs + s * kQt * kSlabRow, &tq, bar, s * kSlab, q0, hh, b);
        tma_load(qs + kQBytes + s * kQt * kSlabRow, &tdo, bar, s * kSlab,
                 q0, hh, b);
      };
      for (int i = 0; i < n_walk; ++i) {
        const int stage = i % kStages;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const int q0 = (first + i) * kQt;
        const uint32_t qs = sQ + stage * 2 * kQBytes;
        const uint32_t rs = sRow + stage * 2 * kRowF32;
        // each group waits for its own slabs of the stage's previous
        // tile to be released
        const uint32_t bar_e = fullE + 8 * stage;
        mbar_wait(emptyE + 8 * stage, parity);
        mbar_expect_tx(bar_e, 2 * (kSlabs - n_own) * kQt * kSlabRow);
        for (int s = 0; s < kSlabs; ++s) {
          if (s < own0 || s >= own0 + n_own) load_slab(qs, bar_e, s, q0);
        }
        const uint32_t bar_l = fullL + 8 * stage;
        mbar_wait(emptyL + 8 * stage, parity);
        mbar_expect_tx(bar_l, 2 * n_own * kQt * kSlabRow + 2 * kRowF32);
        for (int s = own0; s < own0 + n_own; ++s) load_slab(qs, bar_l, s, q0);
        bulk_load(rs, p.lse + row0 + q0, kRowF32, bar_l);
        bulk_load(rs + kRowF32, p.delta + row0 + q0, kRowF32, bar_l);
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kSplitConsumerRegs));
  const int c = wg - 1;
  if (part == 0) {
    dkv_split_consumer<D, 0, kSlabs0 * kSlab>(
        p, sK, sV, sQ, sX, sRow, barKV, fullE, fullL, emptyE, emptyL,
        smem_raw, raw, c, n_walk, first, k0, b, hh);
  } else {
    dkv_split_consumer<D, kSlabs0, (kSlabs - kSlabs0) * kSlab>(
        p, sK, sV, sQ, sX, sRow, barKV, fullE, fullL, emptyE, emptyL,
        smem_raw, raw, c, n_walk, first, k0, b, hh);
  }
}

// ------------------------------------------------------------- host --
struct Maps {
  CUtensorMap q, k, v, dout;
};

// 0, or the 1000 + n code of what the kernels do not take
int check(int dtype, int batch, int heads, int lq, int lk, int d, int causal,
          const void* mask, long long mask_sb) {
  if (lq % 64 || lk % 64) return 1001;
  if (causal && lq > lk) return 1002;
  if (batch * heads > 65535) return 1003;
  if (d < 8 || d % 8 || (d > 128 && (d % 64 || d > 512))) return 1004;
  if (dtype != 1) return 1005;
  if (mask != nullptr && d > 128) return 1006;
  if (mask != nullptr
      && (reinterpret_cast<uintptr_t>(mask) % 16 || mask_sb % 16)) {
    return 1007;
  }
  return 0;
}

// the four tensor maps, Q and dO read in boxes of q_rows rows, K and V of
// kv_rows; their global width is the call's head dim d (columns past it
// read as zeros); strides: q, k, v, dO (sb, sh, sl each)
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

// fn(std::integral_constant<int, D>) for the instantiation of a call at
// head dim d (check() took d)
template <typename Fn>
int with_inst_dim(int d, Fn&& fn) {
  switch (inst_dim(d)) {
    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    case 48: return fn(std::integral_constant<int, 48>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 80: return fn(std::integral_constant<int, 80>{});
    case 96: return fn(std::integral_constant<int, 96>{});
    case 112: return fn(std::integral_constant<int, 112>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 192: return fn(std::integral_constant<int, 192>{});
    case 256: return fn(std::integral_constant<int, 256>{});
    case 320: return fn(std::integral_constant<int, 320>{});
    case 384: return fn(std::integral_constant<int, 384>{});
    case 448: return fn(std::integral_constant<int, 448>{});
    default: return fn(std::integral_constant<int, 512>{});
  }
}

template <int D, bool kMask>
int launch_dq(const Maps& m, const Params& p, int bh, cudaStream_t s) {
  // with a mask: the count, the list of kv tiles and the batch row's mask
  const int smem = dq_smem_bytes<D>()
      + (kMask ? 16 + list_bytes(p.lk) + p.lk : 0);
  return launch(flash_bwd_dq_sm90_kernel<D, kMask>, smem,
                dim3((p.lq + kDqRows - 1) / kDqRows, bh), m, p, s);
}

template <int D, bool kMask>
int launch_dkv(const Maps& m, const Params& p, int bh, cudaStream_t s) {
  constexpr int keys = DkvCfg<D>::kKeys;
  // with a mask: what the first warp found, and E
  const int smem = dkv_smem_bytes<D>() + (kMask ? 16 + width(D) * 4 : 0);
  return launch(flash_bwd_dkv_sm90_kernel<D, kMask>, smem,
                dim3((p.lk + keys - 1) / keys, bh), m, p, s);
}

// above 256: 64-row q blocks (K2) and 64-key blocks of one part of D
// each (K3, two blocks a key block)
template <int D>
int launch_dq_split(const Maps& m, const Params& p, int bh, cudaStream_t s) {
  return launch(flash_bwd_dq_sm90_split_kernel<D>, dq_split_smem_bytes<D>(),
                dim3(p.lq / kSplitRows, bh), m, p, s);
}

template <int D>
int launch_dkv_split(const Maps& m, const Params& p, int bh,
                     cudaStream_t s) {
  return launch(flash_bwd_dkv_sm90_split_kernel<D>,
                dkv_split_smem_bytes<D>(), dim3(2 * (p.lk / kSplitRows), bh),
                m, p, s);
}

// the rows of the tensor maps' boxes at head dim d: K2's q rows a block
// and keys a kv tile
int dq_q_rows(int d) { return d > 256 ? kSplitRows : kDqRows; }

int dq_kv_rows(int d) {
  return with_inst_dim(d, [](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    if constexpr (D > 256) {
      return DqSplitCfg<D>::kKv;
    } else {
      return kKvTile;
    }
  });
}

// K3's q rows a tile and keys a block
int dkv_q_rows(int d) {
  return with_inst_dim(d, [](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    if constexpr (D > 256) {
      return DkvSplitCfg<D>::kQt;
    } else {
      return kQTile;
    }
  });
}

int dkv_keys(int d) {
  return with_inst_dim(d, [](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    if constexpr (D > 256) {
      return kSplitRows;
    } else {
      return DkvCfg<D>::kKeys;
    }
  });
}

}  // namespace

// K2: q, k, v, o, dout and dq are [B, H, L, D] with element strides
// (batch, head, seq; the last dimension contiguous); dtype must be 1
// (bfloat16), d a multiple of 8 up to 128, or 192, 256, 320, 384, 448 or
// 512 without a mask;
// mask is [B, Lk] bytes (nonzero = real key) with batch stride mask_sb,
// both 16-byte aligned, or null for none. Writes dq and delta ([B*H, Lq]
// f32, contiguous). Returns a cudaError_t (0 = launched); 1000 + n flags a
// call the kernel does not take (1001 Lq or Lk not a multiple of 64, 1002
// causal with Lq > Lk, 1003 B*H above 65535, 1004 the head dim, 1005 the
// dtype, 1006 a mask above D = 128, 1007 an address or stride TMA or the
// mask's copies cannot take, 1008 no tensor map).
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
    const void* mask, long long mask_sb,
    float scale, int causal, void* stream) {
  int rc = check(dtype, batch, heads, lq, lk, d, causal, mask, mask_sb);
  if (rc != 0) return rc;
  // O is read 16 bytes at a time, as TMA reads the others
  if (tma_layout(o, o_sb, o_sh, o_sl)) return 1007;
  const long long st[12] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                            v_sb, v_sh, v_sl, do_sb, do_sh, do_sl};
  Maps maps;
  rc = encode_maps(&maps, q, k, v, dout, batch, heads, lq, lk, d, st,
                   dq_q_rows(d), dq_kv_rows(d));
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
  p.h = heads; p.lq = lq; p.lk = lk; p.d = d;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.mask = static_cast<const uint8_t*>(mask);
  p.mask_sb = mask_sb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  const bool masked = mask != nullptr;
  return with_inst_dim(d, [&](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    if constexpr (D > 256) {
      return launch_dq_split<D>(maps, p, bh, s);
    } else if constexpr (D > 128) {
      return launch_dq<D, false>(maps, p, bh, s);
    } else {
      return masked ? launch_dq<D, true>(maps, p, bh, s)
                    : launch_dq<D, false>(maps, p, bh, s);
    }
  });
}

// K3: reads the delta K2 wrote (and lse; both 16-byte aligned), writes dk
// and dv. Arguments and return codes as zoo_flash_attn_bwd_dq_sm90's.
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
    const void* mask, long long mask_sb,
    float scale, int causal, void* stream) {
  int rc = check(dtype, batch, heads, lq, lk, d, causal, mask, mask_sb);
  if (rc != 0) return rc;
  if (reinterpret_cast<uintptr_t>(lse) % 16
      || reinterpret_cast<uintptr_t>(delta) % 16) {
    return 1007;
  }
  const long long st[12] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                            v_sb, v_sh, v_sl, do_sb, do_sh, do_sl};
  Maps maps;
  rc = encode_maps(&maps, q, k, v, dout, batch, heads, lq, lk, d, st,
                   dkv_q_rows(d), dkv_keys(d));
  if (rc != 0) return rc;
  Params p = {};
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = dk;
  p.dv = dv;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_sl = do_sl;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_sl = dk_sl;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_sl = dv_sl;
  p.h = heads; p.lq = lq; p.lk = lk; p.d = d;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  p.mask = static_cast<const uint8_t*>(mask);
  p.mask_sb = mask_sb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  const bool masked = mask != nullptr;
  return with_inst_dim(d, [&](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    if constexpr (D > 256) {
      return launch_dkv_split<D>(maps, p, bh, s);
    } else if constexpr (D > 128) {
      return launch_dkv<D, false>(maps, p, bh, s);
    } else {
      return masked ? launch_dkv<D, true>(maps, p, bh, s)
                    : launch_dkv<D, false>(maps, p, bh, s);
    }
  });
}
