// Flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_fwd_kernel`
// (:82-134), launched by `_flash_fwd` (:137-189). Computes exact
// softmax(scale * Q K^T) V on [B, H, L, D] with f32 softmax statistics and
// f32 accumulation, output in the input dtype, optional per-row logsumexp
// ([B*H, Lq] f32), and a causal mask aligned bottom-right (key j is visible
// to query i when j <= i + Lk - Lq).
//
// Design. The Pallas grid (bh, q-block, kv-block) ran its kv dimension as a
// sequential loop on one TPU core, carrying (m, l, acc) in VMEM scratch.
// Here one thread block owns one (b*h, 64-row q tile) and walks the kv
// tiles in a loop of its own; blocks run in parallel over the SMs.
//   * bf16: 4 warps, 16 query rows each. Q stays in registers as mma.sync
//     A fragments for the whole kernel; each 64-row K/V tile is staged in
//     shared memory (rows padded by 16 bytes so fragment reads hit distinct
//     banks); S = Q K^T and O += P V run on the tensor cores as
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate). The S accumulator
//     fragment is re-packed in registers as the A fragment of P V, so the
//     probabilities never touch shared or device memory. P is rounded to
//     bf16 before P V, as the Pallas kernel casts p to v.dtype.
//   * f32: plain FMA on the CUDA cores (the tensor cores' f32 path is TF32,
//     which would not hold f32 accuracy). 8 threads share one query row,
//     each owning D/8 of its dimensions; scores are reduced with shuffles.
//   * causal: kv tiles wholly above the diagonal are never loaded, and a
//     warp whose rows all lie above a tile skips its arithmetic for it.
//
// What bounds it. Per (b, h) it reads Q, K, V once from device memory and
// writes O once: 4*L*D elements against 4*L*Lk*D flops, so at L = 512,
// D = 64 in bf16 it does 256 flops per byte, just under the H100's
// ~295 flop/byte ridge: both bounds are close (the bound is computed per
// shape in chip_smoke.py). This simple kernel is far from either: it
// issues synchronous tile loads (no cp.async/TMA pipelining) and mma.sync
// rather than wgmma, so it is latency- and issue-bound; several resident
// blocks per SM (about 18 KB shared memory each at D = 64) are what hide
// the load latency. wgmma, TMA and a producer warp are later work.
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
constexpr int kFmaKv = 32;       // kv rows per smem tile on the f32 path
constexpr int kFmaRows = 16;     // q rows per block on the f32 path
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

// ---------------------------------------------------------------- bf16 --
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const Params p) {
  __shared__ __align__(16) uint16_t sK[kTile][D + kPad];
  __shared__ __align__(16) uint16_t sV[kTile][D + kPad];

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

  const int row0 = qt * kTile + warp * 16;   // this warp's first q row
  const int ra = row0 + g;                   // the two rows a thread holds
  const int rb = row0 + g + 8;
  const int offset = p.lk - p.lq;

  // Q as A fragments of m16n8k16, one per 16-wide slice of D
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const uint16_t* pa = q + ra * p.q_sl + c * 16 + t4 * 2;
    const uint16_t* pb = q + rb * p.q_sl + c * 16 + t4 * 2;
    qf[c][0] = *reinterpret_cast<const uint32_t*>(pa);
    qf[c][1] = *reinterpret_cast<const uint32_t*>(pb);
    qf[c][2] = *reinterpret_cast<const uint32_t*>(pa + 8);
    qf[c][3] = *reinterpret_cast<const uint32_t*>(pb + 8);
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
    __syncthreads();

    // a warp whose rows all lie above this tile has nothing to add
    if (p.causal && row0 + 15 + offset < kt * kTile) continue;

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 fragments of 16x8
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&sK[n * 8 + g][c * 16 + t4 * 2]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&sK[n * 8 + g][c * 16 + 8 + t4 * 2]);
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
        if (p.causal) {
          const int col = kt * kTile + n * 8 + t4 * 2 + (e & 1);
          const int row = (e < 2) ? ra : rb;
          if (col > row + offset) x = -INFINITY;
        }
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
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(o + ra * p.o_sl + col) =
        pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    *reinterpret_cast<uint32_t*>(o + rb * p.o_sl + col) =
        pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
  }
  if (p.lse != nullptr && t4 == 0) {
    float* lse = p.lse + static_cast<long long>(bh) * p.lq;
    lse[ra] = (m_a + log2f(l_a)) * kLn2;
    lse[rb] = (m_b + log2f(l_b)) * kLn2;
  }
}

// ----------------------------------------------------------------- f32 --
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const Params p) {
  constexpr int DP = D / 8;  // dimensions per thread
  __shared__ __align__(16) float sK[kFmaKv][D];
  __shared__ __align__(16) float sV[kFmaKv][D];

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
  float* o = static_cast<float*>(p.o) + b * p.o_sb + hh * p.o_sh;

  float qr[DP];
  float acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = q[row * p.q_sl + d0 + i] * p.scale_log2;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  int n_tiles = p.lk / kFmaKv;
  if (p.causal) {
    const int last = (qt * kFmaRows + kFmaRows - 1 + offset) / kFmaKv + 1;
    n_tiles = min(n_tiles, last);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    for (int i = tid; i < kFmaKv * D / 4; i += kThreads) {
      const int r = i / (D / 4);
      const int c = (i - r * (D / 4)) * 4;
      const long long key = static_cast<long long>(kt) * kFmaKv + r;
      *reinterpret_cast<float4*>(&sK[r][c]) =
          *reinterpret_cast<const float4*>(k + key * p.k_sl + c);
      *reinterpret_cast<float4*>(&sV[r][c]) =
          *reinterpret_cast<const float4*>(v + key * p.v_sl + c);
    }
    __syncthreads();

    float s[kFmaKv];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kFmaKv; ++j) {
      float part_dot = 0.f;
#pragma unroll
      for (int i = 0; i < DP; ++i) part_dot = fmaf(qr[i], sK[j][d0 + i], part_dot);
      part_dot += __shfl_xor_sync(0xffffffffu, part_dot, 1);
      part_dot += __shfl_xor_sync(0xffffffffu, part_dot, 2);
      part_dot += __shfl_xor_sync(0xffffffffu, part_dot, 4);
      if (p.causal && kt * kFmaKv + j > row + offset) part_dot = -INFINITY;
      s[j] = part_dot;
      mx = fmaxf(mx, part_dot);
    }
    const float base = (mx == -INFINITY) ? 0.f : mx;
    const float corr = exp2f(m - base);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kFmaKv; ++j) {
      s[j] = exp2f(s[j] - base);
      sum += s[j];
    }
    l = l * corr + sum;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      float a = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kFmaKv; ++j) a = fmaf(s[j], sV[j][d0 + i], a);
      acc[i] = a;
    }
  }

  l = fmaxf(l, 1e-30f);
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < DP; ++i) o[row * p.o_sl + d0 + i] = acc[i] * inv;
  if (p.lse != nullptr && part == 0) {
    p.lse[static_cast<long long>(bh) * p.lq + row] = (m + log2f(l)) * kLn2;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, const Params& p, cudaStream_t stream) {
  kernel<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched);
// 1000 + n flags an argument the kernel does not take.
extern "C" int zoo_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int batch, int heads, int lq, int lk, int d,
    long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl,
    long long o_sb, long long o_sh, long long o_sl,
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid(lq / kTile, batch * heads);
    if (d == 64) return launch(flash_fwd_bf16_kernel<64>, grid, p, s);
    if (d == 128) return launch(flash_fwd_bf16_kernel<128>, grid, p, s);
    return 1004;
  }
  if (dtype == 0) {
    const dim3 grid(lq / kFmaRows, batch * heads);
    if (d == 64) return launch(flash_fwd_f32_kernel<64>, grid, p, s);
    if (d == 128) return launch(flash_fwd_f32_kernel<128>, grid, p, s);
    return 1004;
  }
  return 1005;
}
