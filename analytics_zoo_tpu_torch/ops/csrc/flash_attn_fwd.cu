// Flash-attention forward (K1, K1-lse) for Hopper, sm_90a: bf16 at head
// dims 320, 384, 448 and 512 (without a key-padding mask, as the
// reference's dispatch sends them). Every other call runs elsewhere, and
// the entry point returns 1004 for it: every bf16 call up to D = 128,
// masked or not, and bf16 without a mask at 192 and 256
// (flash_attn_fwd_sm90.cu: TMA, a producer warpgroup, wgmma), and every
// f32 call (flash_attn_fwd_f32tc.cu: 3xTF32 mma.sync on the tensor cores).
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_fwd_kernel`
// (:82-134), launched by `_flash_fwd` (:137-189), at D % 64 == 0 above 256
// (pallas_attention.py:150; the reference's dispatch sends an unmasked
// flash call there, analytics_zoo_tpu/ops/attention.py:107-112). Computes
// exact softmax(scale * Q K^T) V on [B, H, L, D] with f32 softmax
// statistics and f32 accumulation, output in bf16, optional per-row
// logsumexp ([B*H, Lq] f32), and a causal mask aligned bottom-right (key j
// is visible to query i when j <= i + Lk - Lq). The 512-head LM's fit runs
// it (K1-lse); f32 at these head dims, TinyGenLM's prefill at
// DeepSeek-V4-Flash's head dim of 512 among it, is
// flash_attn_fwd_f32tc.cu's.
//
// Design (flash_fwd_bf16_split_kernel):
//   * a warp's O accumulator over all of D would be D/2 f32
//     registers a thread (160-256), past the 255 a thread may hold.
//     The kernel splits D across warps, as K3's wide kernel does: a block
//     owns 32 q rows (2 row groups of 16) and each row group has kSplit =
//     D/64 warps, warp j owning dims [64j, 64j+64) of Q and of O (32 f32
//     registers). Q is staged in shared memory and a warp reloads the A
//     fragment of its slice every k-step (4 registers, not 16 held:
//     ptxas keeps the kernel at 128 registers a thread at D = 448 and
//     512, and the first version, with Q in registers, spilled 24 bytes
//     at 448). The
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
//   * S = Q K^T and O += P V run on the tensor cores as mma.sync.m16n8k16
//     (bf16 in, f32 accumulate); the S accumulator fragment is re-packed in
//     registers as the A fragment of P V, so the probabilities never touch
//     shared or device memory. P is rounded to bf16 before P V, as the
//     Pallas kernel casts p to v.dtype.
//   * causal: kv tiles wholly above the diagonal are never loaded, and a
//     row group whose rows all lie above a tile skips its arithmetic.
//
// What bounds it. Causal at [1, 64, 2048, 512] it does 4 * D flops per
// visible pair, 138 GFLOP against 0.5 GB: bound by the tensor cores. This
// kernel issues synchronous tile loads and mma.sync rather than TMA and
// wgmma, so it is latency- and issue-bound (about 16x its bound); a
// Hopper design must split D over consumers (at 64 rows x 512, O alone
// is 256 registers a thread), later work.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libzoo_flash_attn_fwd.so flash_attn_fwd.cu

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // Lq and Lk are multiples of it
constexpr int kPad = 8;          // bf16 elements of smem row padding
constexpr int kWideKv = 32;      // kv rows per smem tile, bf16 at D > 256
constexpr int kSplitRows = 32;   // q rows per block, bf16 at D > 256
constexpr int kSlice = 64;       // dims of D a warp owns, bf16 at D > 256
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                    // nullptr unless with_lse
  long long q_sb, q_sh, q_sl;    // element strides: batch, head, seq
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int h, lq, lk;
  float scale_log2;              // softmax scale * log2(e)
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

// two floats -> one register of two bf16, `lo` in the low half (the
// element with the lower column index, as the mma fragments expect)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (static_cast<uint32_t>(hi) << 16) | static_cast<uint32_t>(lo);
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
                   int smem, int threads) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
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
// key) with batch stride mask_sb, or null for none (every call this
// source takes has none). Returns a cudaError_t (0 = launched); 1000 + n
// flags an argument the kernel does not take (1004: a head dim it has no
// kernel for, every one but 320, 384, 448 and 512, and every f32 call;
// 1006: a mask).
extern "C" int zoo_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int batch, int heads, int lq, int lk, int d,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
    const void* mask, long long /* mask_sb */,
    float scale, int causal, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
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
  // f32 at every head dim: flash_attn_fwd_f32tc.cu
  if (dtype == 0) return 1004;
  if (d <= 256) return 1004;  // bf16 up to 256: flash_attn_fwd_sm90.cu
  if (mask != nullptr) return 1006;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (d) {
    // K1 above 256: the reference's Pallas kernel at D % 64 == 0
    case 320: return launch_split<320>(bh, p, s);
    case 384: return launch_split<384>(bh, p, s);
    case 448: return launch_split<448>(bh, p, s);
    case 512: return launch_split<512>(bh, p, s);
    default: return 1004;
  }
}
