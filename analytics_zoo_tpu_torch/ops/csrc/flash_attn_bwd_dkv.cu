// K3 (flash-attention dK and dV) for Hopper, sm_90a: the exported entry
// point and its instantiations, every multiple of 8 up to 128 (K5b backward
// at all but 64 and 128), bf16 and f32, with and without a key-padding mask.
// The kernel templates and design notes are in flash_attn_bwd.cuh.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_dkv_kernel`
// (:249-292, launched at :345), and the stock Pallas kernel's dK/dV where
// analytics_zoo_tpu/ops/attention.py (:116-127) trains through it.

#include "flash_attn_bwd.cuh"

// Reads the delta K2 wrote; writes dk and dv. Arguments and return codes as
// zoo_flash_attn_bwd_dq's.
extern "C" int zoo_flash_attn_bwd_dkv(
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
  const bool masked = mask != nullptr;  // the kMask instantiation or not
  return with_head_dim(d, [&](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    if (dtype == 1) {
      const dim3 grid(lk / kTile, batch * heads);
      constexpr size_t smem = bf16_smem_bytes<D>();
      return masked ? launch(flash_bwd_dkv_bf16_kernel<D, true>, grid, smem, p, s)
                    : launch(flash_bwd_dkv_bf16_kernel<D, false>, grid, smem, p, s);
    }
    const dim3 grid(lk / kFmaRows, batch * heads);
    return masked ? launch(flash_bwd_dkv_f32_kernel<D, true>, grid, 0, p, s)
                  : launch(flash_bwd_dkv_f32_kernel<D, false>, grid, 0, p, s);
  });
}
