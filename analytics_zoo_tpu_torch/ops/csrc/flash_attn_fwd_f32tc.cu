// Flash-attention forward (K1, K1 with logsumexp; K5b's forward at the
// head dims that are not a multiple of 64) for Hopper, sm_90a: the float32
// kernel at every head dim up to 128 that is a multiple of 8, with or
// without a key-padding mask, and at 192, 256, 320, 384, 448 and 512
// without one, on the tensor cores at f32 accuracy (3xTF32 mma.sync) with
// asynchronous tile copies (cp.async; above 256 1-D bulk copies).
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_fwd_kernel`
// (:82, launched at :167 by `_flash_fwd` :137; with its logsumexp through
// `_vjp_fwd` :384), and, with a key-padding mask or at a head dim that is
// not a multiple of 64, the forward of the stock Pallas kernel that
// analytics_zoo_tpu/ops/attention.py (:116-127) reaches. The semantics are
// those of K1's bf16 kernel (flash_attn_fwd_sm90.cu), in f32:
// softmax(scale * Q K^T) V on [B, H, L, D] in f32, the optional per-row
// logsumexp ([B*H, Lq] f32, natural log), the causal mask aligned
// bottom-right (key j visible to query i when j <= i + Lk - Lq); padded
// keys are invisible to every row, and a row that sees no key gets the mean
// of V over all Lk keys and logsumexp kEmptyLse (-1e30), what the
// reference's einsum path gives with its finite -1e30 fill.
//
// What bounds it. 4 * D flops a visible (query, key) pair (S = Q K^T and
// P V). The tensor cores take f32 only as TF32 (a 10-bit mantissa, about
// 1e-3 relative a product), outside the port's f32 tolerance of
// 1e-4 * (1 + |ref|); three TF32 products hold it (x = hi + lo,
// a b = hi_a hi_b + hi_a lo_b + lo_a hi_b, the small terms first;
// flash_attn_bwd_f32tc.cu's notes). So a pair costs 3 * 4 * D tensor-core
// flops at 494.7 TFLOP/s dense TF32: the trained call [48,12,384,64]
// 0.132 ms against 0.068 ms of bytes, [8,8,2048,128] causal 0.417 ms, the
// Gemma-width prefill [1,8,8192,256] causal and the DeepSeek-width one
// [1,64,2048,512] 1.668 ms each: bound by operations (chip_smoke.py
// `kernel_bounds`, f32 rows). The instruction this kernel
// issues, mma.sync.m16n8k8 with tf32 operands, reaches about two thirds of
// that peak (scripts/mma_rate.py), so its own ceiling is 1.5 times those
// bounds.
//
// What the design does about it. The FMA kernel it retires gave a row 8
// threads and reduced every score with three shuffles, owned 16 rows a
// block and staged 32-row tiles synchronously (each (b, h)'s K and V read
// by Lq / 16 blocks). Here:
//   * mma.sync.m16n8k8 (tf32 in, f32 accumulate), three a product. Not
//     wgmma: with tf32 it takes both shared-memory operands K-major only,
//     and O += P V contracts over the keys, so its B (V, rows = keys) is
//     MN-major in the tile: wgmma would need a transposed copy of every V
//     tile. mma.sync takes any layout, since each thread loads its own
//     fragments.
//   * A block owns 64 q rows, 4 row groups of 16 (32 at 448 and 512:
//     below), so a (b, h)'s K and V are read by Lq / 64 blocks. Q is
//     copied in once (cp.async) and scaled
//     by scale * log2(e) in place, so that S comes out in the log2 domain;
//     its A fragments are read with ldmatrix and split per k-step, once for
//     all the n-blocks of the step.
//   * K and V stream as they are through two stages (cp.async.cg, the
//     mask's bytes by 4-byte cp.async with them); each warp reads its B
//     fragments from them, K with ldmatrix (S) and V two rows at a time
//     (P V), and splits them in registers. The split is raw: hi is x with
//     its 13 low bits cleared and lo = x - hi is exact in f32 and handed to
//     the tensor cores whole, which read a tf32 operand's top 19 bits (lo
//     truncated there: within 2^-20 |x|). Two operations an operand, where
//     rounding both halves (flash_attn_bwd_f32tc.cu's split) takes five.
//     K2 and K3 split their streamed tiles once a block into hi and lo
//     planes in shared memory; here that cost more than it saved: the
//     planes triple a tile's shared-memory traffic (a read and two writes
//     before the warps read both planes), and shared-memory bandwidth, not
//     the splits, held that design back (on the card the raw tiles were
//     faster at every call timed). Rows are padded by 4 floats (16
//     bytes): no bank conflicts.
//   * S = Q K^T (mma_over_d1): the even and the odd k-steps run in two
//     accumulators, added at the end, so 2 * (KV / 8) mmas lie between two
//     that depend on each other. P never leaves registers: the m16n8k8
//     accumulator gives a thread columns 2t and 2t + 1 of an 8-wide block,
//     where the A fragment wants t and t + 4, so the keys of O += P V are
//     relabelled within each block of 8 (k = t -> 2t, k = t + 4 -> 2t + 1):
//     A = {c0, c2, c1, c3} (acc_as_a) and B is gathered from V's rows 2t
//     and 2t + 1 (mma_rows_split), K2's dQ += dS K with V in K's place.
//     exp2 runs on the special-function unit (ex2.approx.ftz, about 2^-22
//     relative), one instruction where exp2f takes several.
//   * O leaves the accumulators every tile. The tensor cores' f32
//     accumulation truncates, so O summed in them over a long row (8192
//     keys at the Gemma-width prefill) would drift one way, about 2^-23
//     of the running sum a step (flash_attn_bwd_f32tc.cu, kFlushRows).
//     Each tile's P V is taken kPvGroup n-blocks at a time in a fresh
//     accumulator, then added to O with f32 FMA after the rescale:
//     O = O * corr + P V, the same count of FMAs as the rescale alone.
//     That costs kPvGroup * 4 registers, not a second O.
//   * Head dims 192 and 256: a warp's O over 16 rows would be D / 2 = 128
//     registers a thread at 256, which with P, the fresh accumulator and
//     the fragments passes 255. Two warps share 16 rows (8 warps a block),
//     each owning half of D: of Q and K for S, and of O's n-blocks for
//     P V. Each computes the partial S over its half, writes it to shared
//     memory in fragment order, and after a named barrier of the pair adds
//     its partner's (x + y, commutative, so both hold S bit for bit), then
//     both run the same softmax. This is the second of two options: the
//     first, both warps computing the whole S and each owning half of O
//     (K3's kSplitD), would do 6 * D flops a pair, not 4 * D, on a kernel
//     bound by operations; the exchange costs 2 KB of shared memory a warp
//     and one pair barrier a tile. (Four warps a row group, a quarter of D
//     each, measured slower.)
//   * Head dims 320 to 512: a warp keeps at most 128 dims (the register
//     shape of D = 256: O is 64 registers a thread), so 4 warps share 16
//     rows (80, 112 and 128 dims at 320, 448 and 512) and 3 at 384. With
//     three or more partials the sum's order matters (float addition is
//     not associative), so every warp of a group adds all kSplit partials,
//     its own read back from shared memory, in one order, slice 0 first:
//     all of them hold S bit for bit. A block owns 64 q rows at 320 (16
//     warps at 128 registers a thread, P V in two groups of 5 n-blocks)
//     and 384 (12 warps, 168 registers), but 32 (2 row groups, 8 warps)
//     at 448 and 512, where 16 warps spill. Shared memory: Q and one
//     stage of K and V at 32 keys, rows of D + 4 floats, is 198 KB at
//     512, so the tiles stream through a ring of that one stage whose K
//     and V are refilled in
//     turns: V of tile t is copied while S of t runs, K of t + 1 while
//     P V of t runs. Two block barriers a tile free the slots (every warp
//     done with K, then with V), besides the group's barrier of the
//     exchange. The copies are 1-D bulk copies (cp.async.bulk, one a
//     row, issued by warp 0's lanes) that complete on an mbarrier each
//     for Q, K and V: cp.async at 16 bytes a thread took 32 instructions
//     a thread a tile at 512 and was slower at 448 and 512. On the card
//     this ring beat two stages of 16-key tiles, and block barriers beat
//     a version without them (the last warp done with a slot refilling
//     it, the others spinning on the mbarriers).
//   * Causal: kv tiles above a block's last row are never loaded, a warp
//     whose rows see nothing of a tile skips its arithmetic, the per-pair
//     test runs only on tiles that cross the warp's diagonal, and the
//     blocks of the last q rows (the longest walks) start first.
//   * Rows that see no key: masked scores are -inf, so such a row keeps
//     m = -inf; it subtracts 0 (not -inf) before exp2, so its P is 0 and
//     no inf - inf reaches exp2 or a split. A block holding one takes the
//     column means of V in one more pass and writes them as that row's
//     output, with kEmptyLse.
//   * Head dims 8 to 128 in steps of 8 (K5b among them): the k-steps of S
//     are 8 wide, so none reads a padding column; the n-blocks of P V are
//     8 wide. Each D is its own instantiation.
//   * Tiles, stages and blocks an SM by head dim (FwdCfg), chosen on the
//     card (NVIDIA H100 80GB HBM3): up to 256 two stages beat one, and
//     64-key tiles beat 32 at D <= 64, where registers allow them.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libzoo_flash_attn_fwd_f32tc.so \
//        flash_attn_fwd_f32tc.cu

#include <math.h>

#include "flash_attn_f32tc.cuh"
// kLog2e, kLn2 (mbarriers, 1-D bulk copies, named barriers and fast_exp2
// come through flash_attn_f32tc.cuh)
#include "flash_attn_sm90.cuh"

namespace {

// logsumexp of a row that sees no key (flash_attn_fwd_sm90.cu's kEmptyLse)
constexpr float kEmptyLse = -1e30f;
// q rows a block up to D = 256 (the entry point takes Lq and Lk in
// multiples of it)
constexpr int kRowTile = 64;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
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

// Tiles by head dim, chosen on the card (NVIDIA H100 80GB HBM3). Shared
// memory: Q (kRows rows) and kStages stages of K and V (kKv rows each),
// rows of D + 4 floats, plus (kSplit > 1) the partial scores: 87,168
// bytes at D = 64 and 101,440 at D = 128 (two blocks an SM), 166,976 at
// 192, 216,128 at 256, 198,688 at 320, 223,264 at 384, 189,984 at 448
// and 214,560 at 512 (one)
template <int D>
struct FwdCfg {
  // q rows a block: 4 row groups of 16; 2 at 448 and 512, where 16 warps
  // (128 registers a thread) would spill with O at 56 and 64 registers
  static constexpr int kRows = D == 448 || D == 512 ? 32 : 64;
  // warps that share 16 q rows, each owning D / kSplit of the head dim
  // (at most 128 dims, a multiple of 8)
  static constexpr int kSplit = D <= 128 ? 1 : D <= 256 ? 2 : D == 384 ? 3 : 4;
  static constexpr int kThreads = kRows / 16 * 32 * kSplit;
  static constexpr int kKv = D > 64 ? 32 : 64;     // keys a streamed tile
  // 1: one stage, whose K and V are refilled in turns (the ring)
  static constexpr int kStages = D > 256 ? 1 : 2;
  static constexpr int kBlocks = D > 128 ? 1 : 2;  // __launch_bounds__
  // n-blocks of a fresh P V accumulator (at 320, two groups of a warp's 10)
  static constexpr int kPvGroup = D == 320 ? 5 : 8;
};

template <int D>
constexpr size_t fwd_f32tc_smem_bytes() {
  using C = FwdCfg<D>;
  return (C::kRows + 2 * C::kStages * C::kKv) * (D + kTcPad) * sizeof(float)
         + (C::kSplit > 1 ? C::kRows * C::kSplit * C::kKv * sizeof(float)
                          : 0)
         + C::kStages * C::kKv;
}

// column means of V over all Lk keys into `mean` (the block's NT threads,
// one column at a time each); the output of a row that sees no key
template <int D, int NT>
__device__ void v_column_means(float* mean, const float* v, long long sl,
                               int lk, int tid) {
  for (int c = tid; c < D; c += NT) {
    float acc = 0.f;
    for (int j = 0; j < lk; ++j) acc += v[j * sl + c];
    mean[c] = acc / static_cast<float>(lk);
  }
  __syncthreads();
}

template <int D, bool kMask>
__global__ void __launch_bounds__(FwdCfg<D>::kThreads, FwdCfg<D>::kBlocks)
flash_fwd_f32tc_kernel(const Params p) {
  using C = FwdCfg<D>;
  static_assert(D % 8 == 0 && (D <= 128 || D % 64 == 0) && D <= 512,
                "head_dim: a multiple of 8 up to 128, or of 64 up to 512");
  static_assert(!kMask || D <= 128, "a key-padding mask up to D = 128");
  constexpr int LD = D + kTcPad;
  constexpr int NT = C::kThreads;
  constexpr int ROWS = C::kRows;
  constexpr int KV = C::kKv;
  constexpr int ST = C::kStages;
  constexpr bool kRing = ST == 1;      // K and V refilled in turns
  constexpr int kN = KV / 8;           // n-blocks of S
  constexpr int kSplit = C::kSplit;
  constexpr int DW = D / kSplit;       // dims of D a warp owns
  constexpr int kNb = DW / 8;          // n-blocks of O a warp owns
  constexpr int kG = kNb < C::kPvGroup ? kNb : C::kPvGroup;
  static_assert(ROWS % KV == 0 && kRowTile % ROWS == 0 && kN % 2 == 0
                && DW % 8 == 0 && DW <= 128 && !(kRing && kMask)
                && (kRing || kSplit <= 2), "tiles");
  extern __shared__ __align__(16) unsigned char zoo_smem[];
  float* sQ = reinterpret_cast<float*>(zoo_smem);
  // stage s: K, then V, KV rows each
  float* sKV = sQ + ROWS * LD;
  // kSplit > 1: each warp's partial S, [warp][n-block][lane] of 4 floats
  float4* sS = reinterpret_cast<float4*>(sKV + 2 * ST * KV * LD);
  uint8_t* sM = reinterpret_cast<uint8_t*>(
      sKV + 2 * ST * KV * LD + (kSplit > 1 ? ROWS * kSplit * KV : 0));
  __shared__ float sMean[kMask ? D : 1];
  // the ring's mbarriers: Q, K and V landed
  __shared__ __align__(8) uint64_t sBar[kRing ? 3 : 1];

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
  const int rg = warp / kSplit;        // row group of 16 q rows
  const int sl = warp - rg * kSplit;   // slice of D
  const int q0 = qt * ROWS;
  const int offset = p.lk - p.lq;
  const int row0 = rg * 16;            // the row group's first row in the block
  const int ra = q0 + row0 + g;        // a thread's two rows
  const int rb = ra + 8;
  const int col0 = sl * DW;            // the slice's first dim

  const float* q = p.q + b * p.q_sb + hh * p.q_sh;
  const float* k = p.k + b * p.k_sb + hh * p.k_sh;
  const float* v = p.v + b * p.v_sb + hh * p.v_sh;
  float* o = p.o + b * p.o_sb + hh * p.o_sh;
  const uint8_t* mrow = kMask ? p.mask + b * p.mask_sb : nullptr;

  int n_tiles = p.lk / KV;
  if (p.causal) n_tiles = min(n_tiles, (q0 + ROWS - 1 + offset) / KV + 1);

  // tile kt into stage s, and one copy group for it (an empty one past
  // the last tile, so that every iteration waits for the same count)
  auto load_kv = [&](int kt, int s) {
    if (kt < n_tiles) {
      const long long r0 = static_cast<long long>(kt) * KV;
      float* st = sKV + 2 * s * KV * LD;
      copy_tile<D, LD, NT>(st, k + r0 * p.k_sl, p.k_sl, KV, tid);
      copy_tile<D, LD, NT>(st + KV * LD, v + r0 * p.v_sl, p.v_sl, KV, tid);
      if (kMask && tid < KV / 4) {
        cp_async4(sM + s * KV + 4 * tid, mrow + r0 + 4 * tid);
      }
    }
    cp_async_commit();
  };
  // the ring: `n` rows of an operand (row stride `stride`) into a tile of
  // pitch LD, one bulk copy a row issued by warp 0, counted by `bar`
  const uint32_t barQ = smem_addr(&sBar[0]);
  const uint32_t barK = barQ + 8, barV = barQ + 16;
  auto bulk_rows = [&](float* t, const float* src, long long stride, int n,
                       uint32_t bar) {
    if (warp == 0) {
      if (lane == 0) mbar_expect_tx(bar, n * D * sizeof(float));
      __syncwarp();
      for (int r = lane; r < n; r += 32) {
        bulk_load(smem_addr(t + r * LD), src + r * stride,
                  D * sizeof(float), bar);
      }
    }
  };
  if constexpr (kRing) {
    if (tid == 0) {
      mbar_init(barQ, 1);
      mbar_init(barK, 1);
      mbar_init(barV, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    bulk_rows(sQ, q + q0 * p.q_sl, p.q_sl, ROWS, barQ);
    bulk_rows(sKV, k, p.k_sl, KV, barK);
    mbar_wait(barQ, 0);
  } else {
    copy_tile<D, LD, NT>(sQ, q + q0 * p.q_sl, p.q_sl, ROWS, tid);
    cp_async_commit();
#pragma unroll
    for (int s = 0; s < ST; ++s) load_kv(s, s);
    cp_async_wait<ST>();
  }
  // Q times scale * log2(e), so that S comes out in the log2 domain: each
  // thread scales the chunks it copied (copy_tile's order; in the ring
  // the same chunks, once Q is in); the first tile's barrier shows them
  // to the other warps
  for (int i = tid; i < ROWS * D / 4; i += NT) {
    const int r = i / (D / 4);
    float4* x = reinterpret_cast<float4*>(sQ + r * LD + (i - r * (D / 4)) * 4);
    float4 y = *x;
    y.x *= p.scale_log2;
    y.y *= p.scale_log2;
    y.z *= p.scale_log2;
    y.w *= p.scale_log2;
    *x = y;
  }

  const float* qa = sQ + row0 * LD + a_frag_off<LD>(lane) + col0;
  const int boff = b_frag_off<LD>(lane) + col0;
  // B of P V: rows 2t and 2t + 1 of each block of 8 keys, column g
  const int voff = 2 * t4 * LD + g + col0;

  float acc[kNb][4];
#pragma unroll
  for (int n = 0; n < kNb; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_a = -INFINITY, m_b = -INFINITY;  // running max (log2 domain)
  float l_a = 0.f, l_b = 0.f;              // this thread's part of the sum

  if constexpr (kRing) {
    // D above 256: 3 or 4 warps a row group, no mask. Each tile's V is
    // copied while its S runs, the next tile's K while its P V runs
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * KV;
      // a row group whose rows all lie above this tile has nothing to add
      // (the same for every warp of the group)
      const bool active = !(p.causal && q0 + row0 + 15 + offset < k0);
      // every warp is done with the V of tile kt - 1 (and Q is scaled, the
      // first time): its slot takes the V of tile kt; then wait for the K
      __syncthreads();
      bulk_rows(sKV + KV * LD, v + static_cast<long long>(kt) * KV * p.v_sl,
                p.v_sl, KV, barV);
      mbar_wait(barK, kt & 1);
      float corr_a = 1.f, corr_b = 1.f;
      uint32_t phi[kN][4], plo[kN][4];  // P as split A fragments
      if (active) {
        // S = Q K^T for 16 rows x KV keys over this warp's slice of D,
        // then the group's kSplit partials summed
        float sc[kN][4];
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        }
        mma_over_d1<DW / 8, kN, LD, true>(sc, qa, sKV + boff);
        // the row group's partials, [slice][n-block][lane]
        float4* part = sS + rg * kSplit * kN * 32 + lane;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          part[(sl * kN + n) * 32] =
              make_float4(sc[n][0], sc[n][1], sc[n][2], sc[n][3]);
        }
        named_sync(1 + rg, 32 * kSplit);
        // three or more terms: float addition is not associative, so every
        // warp of the group adds the partials in one order, slice 0 first,
        // and all of them hold S bit for bit and run the same softmax
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          float4 x = part[n * 32];
#pragma unroll
          for (int j = 1; j < kSplit; ++j) {
            const float4 u = part[(j * kN + n) * 32];
            x.x += u.x;
            x.y += u.y;
            x.z += u.z;
            x.w += u.w;
          }
          sc[n][0] = x.x;
          sc[n][1] = x.y;
          sc[n][2] = x.z;
          sc[n][3] = x.w;
        }

        // the causal mask where the tile crosses the row group's
        // diagonal, the row max and the online softmax, as below
        const bool diag = p.causal && k0 + KV - 1 > q0 + row0 + offset;
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n * 8 + t4 * 2 + (e & 1);
            if (diag && k0 + col > (e < 2 ? ra : rb) + offset) {
              sc[n][e] = -INFINITY;
            }
          }
          mx_a = fmaxf(mx_a, fmaxf(sc[n][0], sc[n][1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[n][2], sc[n][3]));
        }
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float base_a = mx_a == -INFINITY ? 0.f : mx_a;
        const float base_b = mx_b == -INFINITY ? 0.f : mx_b;
        corr_a = fast_exp2(m_a - base_a);
        corr_b = fast_exp2(m_b - base_b);
        m_a = mx_a;
        m_b = mx_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          sc[n][0] = fast_exp2(sc[n][0] - base_a);
          sc[n][1] = fast_exp2(sc[n][1] - base_a);
          sc[n][2] = fast_exp2(sc[n][2] - base_b);
          sc[n][3] = fast_exp2(sc[n][3] - base_b);
          sum_a += sc[n][0] + sc[n][1];
          sum_b += sc[n][2] + sc[n][3];
          acc_as_a<true>(sc[n], phi[n], plo[n]);
        }
        l_a = l_a * corr_a + sum_a;
        l_b = l_b * corr_b + sum_b;
      }
      // every warp is done with the K of tile kt: that slot takes the K of
      // tile kt + 1 while P V runs; then wait for the V
      __syncthreads();
      if (kt + 1 < n_tiles) {
        bulk_rows(sKV, k + static_cast<long long>(kt + 1) * KV * p.k_sl,
                  p.k_sl, KV, barK);
      }
      mbar_wait(barV, kt & 1);
      if (active) {
        // O = O * corr + P V, as below
#pragma unroll
        for (int n0 = 0; n0 < kNb; n0 += kG) {
          float pv[kG][4];
#pragma unroll
          for (int n = 0; n < kG; ++n) {
            pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            mma_rows_split<kG, LD, kG, true>(
                pv, phi[j], plo[j], sKV + KV * LD + j * 8 * LD + voff + n0 * 8,
                kNb - n0);
          }
#pragma unroll
          for (int n = 0; n < kG; ++n) {
            if (n0 + n < kNb) {
              acc[n0 + n][0] = fmaf(acc[n0 + n][0], corr_a, pv[n][0]);
              acc[n0 + n][1] = fmaf(acc[n0 + n][1], corr_a, pv[n][1]);
              acc[n0 + n][2] = fmaf(acc[n0 + n][2], corr_b, pv[n][2]);
              acc[n0 + n][3] = fmaf(acc[n0 + n][3], corr_b, pv[n][3]);
            }
          }
        }
      }
    }
  } else {
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s = kt % ST;
      cp_async_wait<ST - 1>();
      __syncthreads();  // Q (the first time), tile kt and its mask bytes
      const float* tK = sKV + 2 * s * KV * LD;
      const float* tV = tK + KV * LD;
      const uint8_t* tM = sM + s * KV;
      const int k0 = kt * KV;

      // a row group whose rows all lie above this tile has nothing to add
      // (the same for both warps of a pair)
      if (!(p.causal && q0 + row0 + 15 + offset < k0)) {
        // S = Q K^T for 16 rows x KV keys (kSplit = 2: over this warp's
        // half of D, then the pair's two halves summed)
        float sc[kN][4];
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        }
        mma_over_d1<DW / 8, kN, LD, true>(sc, qa, tK + boff);
        if constexpr (kSplit > 1) {
          float4* mine = sS + warp * kN * 32 + lane;
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            mine[n * 32] = make_float4(sc[n][0], sc[n][1], sc[n][2], sc[n][3]);
          }
          named_sync(1 + rg, 32 * kSplit);
          const float4* other = sS + (warp ^ 1) * kN * 32 + lane;
#pragma unroll
          for (int n = 0; n < kN; ++n) {
            const float4 u = other[n * 32];
            sc[n][0] += u.x;
            sc[n][1] += u.y;
            sc[n][2] += u.z;
            sc[n][3] += u.w;
          }
        }

        // mask, and take the row max (S is in the log2 domain: Q was
        // scaled); the causal test only where the tile crosses the row
        // group's diagonal
        const bool diag = p.causal && k0 + KV - 1 > q0 + row0 + offset;
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n * 8 + t4 * 2 + (e & 1);  // key within the tile
            if (diag && k0 + col > (e < 2 ? ra : rb) + offset) {
              sc[n][e] = -INFINITY;
            }
            if (kMask && tM[col] == 0) sc[n][e] = -INFINITY;
          }
          mx_a = fmaxf(mx_a, fmaxf(sc[n][0], sc[n][1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[n][2], sc[n][3]));
        }
        // the four threads of a group hold the same two rows
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        // a row with no visible key yet keeps -inf; subtract 0 there, so its
        // P is exp2(-inf) = 0 and no inf - inf is formed
        const float base_a = mx_a == -INFINITY ? 0.f : mx_a;
        const float base_b = mx_b == -INFINITY ? 0.f : mx_b;
        const float corr_a = fast_exp2(m_a - base_a);
        const float corr_b = fast_exp2(m_b - base_b);
        m_a = mx_a;
        m_b = mx_b;

        // P, its row sums, and P as split A fragments (relabelled)
        float sum_a = 0.f, sum_b = 0.f;
        uint32_t phi[kN][4], plo[kN][4];
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          sc[n][0] = fast_exp2(sc[n][0] - base_a);
          sc[n][1] = fast_exp2(sc[n][1] - base_a);
          sc[n][2] = fast_exp2(sc[n][2] - base_b);
          sc[n][3] = fast_exp2(sc[n][3] - base_b);
          sum_a += sc[n][0] + sc[n][1];
          sum_b += sc[n][2] + sc[n][3];
          acc_as_a<true>(sc[n], phi[n], plo[n]);
        }
        l_a = l_a * corr_a + sum_a;
        l_b = l_b * corr_b + sum_b;

        // O = O * corr + P V over this warp's n-blocks, kG at a time, each
        // tile's P V in a fresh accumulator (the truncating accumulation)
#pragma unroll
        for (int n0 = 0; n0 < kNb; n0 += kG) {
          float pv[kG][4];
#pragma unroll
          for (int n = 0; n < kG; ++n) {
            pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            mma_rows_split<kG, LD, kG, true>(
                pv, phi[j], plo[j], tV + j * 8 * LD + voff + n0 * 8, kNb - n0);
          }
#pragma unroll
          for (int n = 0; n < kG; ++n) {
            if (n0 + n < kNb) {
              acc[n0 + n][0] = fmaf(acc[n0 + n][0], corr_a, pv[n][0]);
              acc[n0 + n][1] = fmaf(acc[n0 + n][1], corr_a, pv[n][1]);
              acc[n0 + n][2] = fmaf(acc[n0 + n][2], corr_b, pv[n][2]);
              acc[n0 + n][3] = fmaf(acc[n0 + n][3], corr_b, pv[n][3]);
            }
          }
        }
      }
      __syncthreads();  // every warp is done with stage s (and sS)
      load_kv(kt + ST, s);
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
  // a row whose running max is still -inf saw no key (only a mask can do
  // that: under causal alone, with Lq <= Lk, every row sees key 0)
  const bool empty_a = kMask && m_a == -INFINITY;
  const bool empty_b = kMask && m_b == -INFINITY;
  if constexpr (kMask) {
    if (__syncthreads_or(empty_a || empty_b)) {
      v_column_means<D, NT>(sMean, v, p.v_sl, p.lk, tid);
    }
  }
#pragma unroll
  for (int n = 0; n < kNb; ++n) {
    const int col = col0 + n * 8 + t4 * 2;
    float2 xa = make_float2(acc[n][0] * inv_a, acc[n][1] * inv_a);
    float2 xb = make_float2(acc[n][2] * inv_b, acc[n][3] * inv_b);
    if constexpr (kMask) {
      if (empty_a) xa = make_float2(sMean[col], sMean[col + 1]);
      if (empty_b) xb = make_float2(sMean[col], sMean[col + 1]);
    }
    *reinterpret_cast<float2*>(o + ra * p.o_sl + col) = xa;
    *reinterpret_cast<float2*>(o + rb * p.o_sl + col) = xb;
  }
  // every warp of a row group holds the same m and l; the first writes
  // the lse
  if (p.lse != nullptr && sl == 0 && t4 == 0) {
    float* lse = p.lse + static_cast<long long>(bh) * p.lq;
    lse[ra] = empty_a ? kEmptyLse : (m_a + log2f(l_a)) * kLn2;
    lse[rb] = empty_b ? kEmptyLse : (m_b + log2f(l_b)) * kLn2;
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, int threads,
           const Params& p, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
int launch_d(bool masked, int batch_heads, const Params& p, cudaStream_t s) {
  using C = FwdCfg<D>;
  const dim3 grid(p.lq / C::kRows, batch_heads);
  constexpr size_t smem = fwd_f32tc_smem_bytes<D>();
  if constexpr (D > 128) {
    return launch(flash_fwd_f32tc_kernel<D, false>, grid, smem, C::kThreads,
                  p, s);
  } else {
    return masked ? launch(flash_fwd_f32tc_kernel<D, true>, grid, smem,
                           C::kThreads, p, s)
                  : launch(flash_fwd_f32tc_kernel<D, false>, grid, smem,
                           C::kThreads, p, s);
  }
}

}  // namespace

// K1 (with or without logsumexp) in f32 at a head dim up to 128 (a
// multiple of 8; with or without a mask) or at 192, 256, 320, 384, 448 and
// 512 (without).
// Arguments as zoo_flash_attn_fwd_sm90's (flash_attn_fwd_sm90.cu): dtype 0 =
// float32; mask [B, Lk] bytes (nonzero = real key) with batch stride
// mask_sb, or null. Returns a cudaError_t (0 = launched), or 1000 + n for
// an argument the kernel does not take (1004: bf16, or a head dim it has
// no kernel for; 1006: a mask above D = 128).
extern "C" int zoo_flash_attn_fwd_f32tc(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int batch, int heads, int lq, int lk, int d,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    const void* mask, long long mask_sb,
    float scale, int causal, void* stream) {
  if (lq % kRowTile || lk % kRowTile) return 1001;
  if (causal && lq > lk) return 1002;
  if (batch * heads > 65535) return 1003;
  if (dtype != 0 && dtype != 1) return 1005;
  if (dtype != 0) return 1004;
  const bool masked = mask != nullptr;
  if (masked && d > 128) return 1006;
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (d) {
    case 8: return launch_d<8>(masked, bh, p, s);
    case 16: return launch_d<16>(masked, bh, p, s);
    case 24: return launch_d<24>(masked, bh, p, s);
    case 32: return launch_d<32>(masked, bh, p, s);
    case 40: return launch_d<40>(masked, bh, p, s);
    case 48: return launch_d<48>(masked, bh, p, s);
    case 56: return launch_d<56>(masked, bh, p, s);
    case 64: return launch_d<64>(masked, bh, p, s);
    case 72: return launch_d<72>(masked, bh, p, s);
    case 80: return launch_d<80>(masked, bh, p, s);
    case 88: return launch_d<88>(masked, bh, p, s);
    case 96: return launch_d<96>(masked, bh, p, s);
    case 104: return launch_d<104>(masked, bh, p, s);
    case 112: return launch_d<112>(masked, bh, p, s);
    case 120: return launch_d<120>(masked, bh, p, s);
    case 128: return launch_d<128>(masked, bh, p, s);
    case 192: return launch_d<192>(masked, bh, p, s);
    case 256: return launch_d<256>(masked, bh, p, s);
    case 320: return launch_d<320>(masked, bh, p, s);
    case 384: return launch_d<384>(masked, bh, p, s);
    case 448: return launch_d<448>(masked, bh, p, s);
    case 512: return launch_d<512>(masked, bh, p, s);
    default: return 1004;
  }
}
