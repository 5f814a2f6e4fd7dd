// K3 (flash-attention dK and dV) for Hopper, sm_90a: the exported entry
// point and its bf16 instantiations at head dims 320, 384, 448 and 512
// without a key-padding mask (flash_attn_bwd.cuh's split template). Every
// other call returns 1004 here: bf16 up to 128, masked or not, and at 192
// and 256 is flash_attn_bwd_sm90.cu's, every f32 call
// flash_attn_bwd_f32tc.cu's. The kernel template and design notes are in
// flash_attn_bwd.cuh.
//
// Replaces: analytics_zoo_tpu/ops/pallas_attention.py `_flash_dkv_kernel`
// (:249-292, launched at :345) at those head dims.

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
  (void)mask_sb;
  const int bad = check(dtype, lq, lk, batch, heads, causal);
  if (bad) return bad;
  // bf16 at 320 to 512 only; the rest is the other sources'
  if (dtype != 1 || d < 320 || d > 512 || d % 64) return 1004;
  if (mask != nullptr) return 1006;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout;
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
  return with_head_dim(d, [&](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    if constexpr (D > 256) {
      return launch(flash_bwd_dkv_bf16_split_kernel<D>,
                    dim3(lk / kSplitRows, batch * heads),
                    bf16_split_dkv_smem_bytes<D>(), p, s, D);
    } else {
      return 1004;
    }
  });
}
