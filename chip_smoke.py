#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases (needs one card)
    python3 chip_smoke.py --profile  # + profiles of one served batch and
                                     #   of one SQuAD, one NER and one
                                     #   MiniLM train step

Phases:
1. Build: compiles the port's CUDA sources (one nvcc per source, side by
   side) for sm_90a into build/ and prints the card, the versions, the
   build time and ptxas' registers and spills per kernel.
2. Forward kernel: runs K1 (flash-attention forward) through its wrapper
   against its plain PyTorch version on the card -- [8,12,512,64] in
   bf16 and f32, causal and not, the served call itself (q/k/v as
   strided views into a fused [32,512,3,12,64] qkv projection, bf16;
   the adaptive batcher grows the served batches to 32), cross-length
   causal [1,2,128->384,128], and the logsumexp output at [2,4,256,64]
   -- and times the kernel, the plain version and torch's
   scaled_dot_product_attention (a yardstick only; the port never calls
   it).
3. Backward kernels: runs K1 without and with logsumexp (out and lse),
   then K2 (dQ and delta) and K3 (dK/dV) on the kernel's checked out and
   lse, each through its wrapper against its plain version on the card
   -- the trained call ([48,12,384,64] q/k/v as views into a
   [48,384,3,12,64] projection, random dO) in bf16 and f32, causal
   [8,12,512,64] bf16, cross-length causal [1,2,128->384,128] in bf16
   and f32 -- and times each kernel (CUDA events, and profiler device
   time), its plain version and SDPA: its forward at inference and with
   inputs that need a gradient (beside K1 and K1 with logsumexp), and its
   backward alone, replayed on one retained graph (beside K2 + K3).
4. Masked kernels: the same checks and timings with a key-padding mask
   (SDPA takes it as a boolean attn_mask [B,1,1,Lk]) -- the NER trained
   call ([32,12,128,64] views into the qkv projection, synthetic real
   lengths uniform in [2,128], one left-padded row) in bf16 and f32, a
   padded SQuAD call ([48,12,384,64] bf16, lengths in [64,384]),
   cross-length causal [1,2,128->384,128] with left padding (rows that
   see no key) in bf16 and f32, and a batch row with no real token in
   bf16 and f32. Also checks that padded keys get exactly zero dK (and
   dV, where every row sees a key) and rows that see no key exactly zero
   dQ. Bounds count the visible pairs' flops and the K/V bytes of the
   keys some row sees.
5. Serving: saves a seeded BERT-base BERTClassifier (bf16), serves 64
   requests of 512 tokens through the port's launch() -> ServingWorker
   -> InferenceModel with zoo.ops.attention_impl = "flash" (every batch
   bucket the batcher can emit is warmed first), checks that
   every request is answered once with finite logits, that K1 ran for
   every encoder layer of every dispatched batch, and that 4 replies
   match the same model run with the einsum attention path.
6. Learn: fine-tunes a seeded BERT-base BERTSQuAD (bf16 encoder, seq 384,
   batch 48, random token ids and spans) through ZooModel.fit ->
   Estimator.fit for 2 epochs of 16 steps (the first warms up, the second
   is timed) with zoo.ops.attention_impl = "flash"; checks finite losses
   and that K1, K2 and K3 each launched at least 12 times per step; runs
   evaluate and predict on the same Estimator; and, before the fit, holds
   one step's gradients (hidden dropout off) with flash attention against
   the same step with einsum attention, in f32 and in bf16; it repeats
   the flash step with the backward's wiring broken on purpose (dQ
   zeroed; dK and dV swapped) and fails unless the f32 check rejects
   each broken step. Prints
   steps/s, samples/s, tokens/s, MFU (bench.py's formula against 989
   TFLOP/s bf16) and peak device memory.
7. NER learn: the same code for BERT-base BERTNER (bert-base-cased,
   vocab 28996, 9 tags, seq 128, batch 32, bf16 encoder) on padded
   batches of synthetic traffic (random ids, real lengths uniform in
   [2,128], attention_mask, tags -1 on padding). The gradient checks
   run with the mask and without it (the learn phase does so for any
   padded batch); the planted fault is
   the mask dropped from K2 and K3, which the f32 check must reject; K1,
   K2 and K3 must each launch with the mask at least 12 times per step;
   predict reports token accuracy and the fitted model is saved. Prints
   real and padded tokens/s; MFU counts padded tokens.
8. NER serving: the same serving code for the saved NER model, loaded
   through InferenceModel, every bucket warmed with a padded example, 64
   padded requests (input_ids and attention_mask, 128 each) through a
   ServingWorker on the memory queue whose input_fn passes both tensors;
   K1 must run with the mask for every encoder layer of every dispatched
   batch, and 4 replies match the einsum path at real tokens.

9. K5b kernels: K1's source at head dims that are not a multiple of 64
   (the stock-kernel branch the reference takes at such head dims),
   through the flash_attention wrapper against its plain version on the
   card: every instantiation once (D = 8..120 in steps of 8 but not 64,
   bf16 and f32, with and without a key-padding mask, with logsumexp),
   then TinyGenLM's prefill calls ([1,32,2048,80] and [1,32,512,80] f32
   causal at Phi-2's widths, [1,2,256,16] f32 causal at the repo
   geometry), [8,32,1024,80] bf16 causal, a masked bf16 call at
   MiniLM-L12-H384's heads ([32,12,128,32], one left-padded row, one row
   with no real token) and [2,4,256,40] with logsumexp in both dtypes
   (D = 8 mod 16), each timed beside its plain version, SDPA and its
   bound. A head dim that is not a multiple of 8 must raise.
10. K5b backward kernels: K2 and K3 (and K1 with logsumexp) at the same
   head dims, through backward_phase: every instantiation once ([4,2,128,
   128,d], D = 8..120 but not 64, bf16 and f32, without a mask and with
   one holding a full row, a row of 2, a left-padded row and a row with
   no real token, causal at lq == lk and not; one summary line, and each
   case must count one K2 and one K3 launch in small_d_launches), then
   MiniLM-L12-H384's trained call ([48,12,384,32] bf16 views into the
   qkv projection) without a mask and padded (lengths uniform in [64,
   384]), timed as phase 3 times the BERT-base call.
11. MiniLM learn: the learn phase's code for BERTSQuAD at
   MiniLM-L12-H384's published widths (vocab 30522, hidden 384, 12
   layers, 12 heads of 32, intermediate 1536, bf16 encoder; 48 x 384, 2
   epochs of 16 steps) on padded batches of synthetic traffic (real
   lengths uniform in [64, 384], spans inside them). The gradient checks
   run with the mask and without it; the f32 check must reject dQ
   zeroed, dK and dV swapped and the mask dropped from K2 and K3. K1, K2
   and K3 must each launch with the mask at least 12 times a step, every
   launch a K5b one (small_d_launches). Prints real and padded tokens/s,
   MFU (padded tokens) and peak memory.
12. Generation, repo geometry: TinyGenLM as the launcher documents it
   (vocab 64, dim 32, 2 heads of 16, 2 layers, max_len 256, 8 slots,
   page 16) served through launch() with a generation: block ->
   GenerationWorker -> DecodeEngine -> PagedKVCache, with
   zoo.ops.attention_impl = "flash": 500 synthetic requests (prompt
   lengths uniform in [1, 240], __max_tokens__ 16), at most 8
   outstanding. Every stream must get contiguous chunks and one terminal
   chunk with in-range tokens, K5b must launch once a layer for every
   prefill in a bucket of 128 tokens or more (warm-up included), and
   every stream must be token-exact against reference_generate. Prints
   TTFT and inter-token p50/p99, tokens/s, decode-step wall and device
   time (a profile with all slots live), prefill ms by bucket, KV-pool
   bytes and peak memory.
13. Generation, Phi-2 widths: the same at microsoft/phi-2's published
   widths in TinyGenLM's block (hidden 2560, 32 heads of 80, 32 layers,
   intermediate 10240, vocab 51200, max_len 2048; f32, seeded weights):
   32 synthetic requests (prompts uniform in [128, 2016],
   __max_tokens__ 32); the first 16 tokens of 4 streams against
   reference_generate, where a divergence at a top-1 - top-2 logit gap
   under 1e-3 is reported as an f32 tie and ends that comparison.

Prints each phase's seconds, a {"kernels": [...]} line (K1, K2 and K3
each with a kv_mask_call at the NER trained call; K5b's forward at the
full-width prefill call with an lse_call at the MiniLM trained call and a
kv_mask_call at the masked D = 32 call; flash_attn_bwd_dq_k5b and
flash_attn_bwd_dkv_k5b at the MiniLM trained call with a kv_mask_call at
its padded call, their launches the MiniLM fit's), the card's name and
power limit, and last {"ok": true, "device": {...}}. Any failed check
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K1_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/flash_attn_fwd.cu"
# the key-padding branch the masked kernels replace (JAX's stock Pallas
# flash_attention with segment ids on the TPU), and the same stock kernel
# at head dims that are not a multiple of 64, which K5b replaces
K5A_REPLACES = "analytics_zoo_tpu/ops/attention.py:116"
K5B_REPLACES = "analytics_zoo_tpu/ops/attention.py:116"
K1_REPLACES = "analytics_zoo_tpu/ops/pallas_attention.py:82"
# K2 and K3 (and K5b's backward): templates in flash_attn_bwd.cuh, built
# and exported by one source each
K2_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/flash_attn_bwd_dq.cu"
K3_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/flash_attn_bwd_dkv.cu"
K2_REPLACES = "analytics_zoo_tpu/ops/pallas_attention.py:209"
K3_REPLACES = "analytics_zoo_tpu/ops/pallas_attention.py:249"
# |kernel - plain| <= TOL * (1 + |plain|): f32 is exact arithmetic in
# another order; bf16 rounds P to bf16 before P.V (as the reference
# kernel does) and rounds the output (one bf16 ulp is 2^-7 relative)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# BERT-base logits, bf16 encoder: flash vs einsum attention on the card
SERVE_TOL = 5e-2
# one BERT-base train step (48 x 384) at the initial weights, bf16
# encoder: ||g_a - g_b|| / ||g_b|| per checked parameter for flash vs
# einsum attention and for flash vs the same step in f32, and the bf16
# losses' absolute difference. The bf16 paths round at other points (the
# flash backward rounds dS to bf16 as _flash_bwd does; einsum's autograd
# keeps the softmax backward in f32), and 12 post-LN layers compound
# that: on an H100 the two bf16 paths came out 3.1% (layer-0 qkv) and
# 3.6% (head) apart with the losses 6e-4 apart, so 2e-2 was too tight.
# MiniLM's step (head dim 32) keeps the same limit: 1.8-2.2% (qkv) and
# 1.2-2.2% (head) apart, with and without the mask
GRAD_TOL = 5e-2
LOSS_TOL = 1e-2
# the same step in f32 (GEMMs without TF32, K1-K3 on FMA): flash and
# einsum attention differ only in the order of exact f32 sums, so a
# broken backward (dQ dropped, dK and dV swapped) shows far above this
F32_GRAD_TOL = 1e-3

# published dense peaks (NVIDIA data sheets): bf16 tensor-core and f32
# CUDA-core FLOP/s, HBM bytes/s
PEAKS = {
    "sxm": {"bf16": 989e12, "f32": 67e12, "bw": 3.35e12},
    "pcie": {"bf16": 756e12, "f32": 51e12, "bw": 2.0e12},
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(log: str) -> list:
    """``nvcc -Xptxas -v`` output as one line per kernel template and mask
    flag: each head dim's registers, and its spill stores/loads in bytes
    where there are any."""
    table, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*(flash_(?:fwd|bwd_dq|"
                      r"bwd_dkv)_(?:bf16|f32)_kernel)ILi(\d+)ELb([01])E", line)
        if m:
            kernel = (m.group(1), int(m.group(3)), int(m.group(2)))
            spill = ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel and m.groups() != ("0", "0"):
            spill = f" (spill {m.group(1)}/{m.group(2)})"
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            table.setdefault(kernel[:2], []).append(
                f"{kernel[2]}:{m.group(1)}{spill}")
            kernel = None
    return [f"{name} mask={mask}: " + " ".join(
        sorted(dims, key=lambda x: int(x.split(":")[0])))
        for (name, mask), dims in sorted(table.items())]


def time_ms(torch, fn, iters: int, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 10) -> float:
    """Device time per call of ``fn`` from a torch.profiler window of
    ``iters`` calls: for each CUDA kernel row, its mean time a launch
    times its launches a call, summed. Beside ``time_ms`` it tells a
    call bound by its kernels from one bound by the host's launch work.
    The profiler drops records now and then (a window once held 8 of 10
    launches of each kernel), so a row's launches a call are its count
    over ``iters`` rounded to a whole number, at least 1. A window that
    recorded no kernel is taken again, up to three times; then the
    reading is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count > 0]
        busy = sum(e.self_device_time_total / e.count
                   * max(1, round(e.count / iters)) for e in rows)
        if busy > 0:
            return busy / 1e3
    return None


def _ms(x) -> str:
    return "n/a" if x is None else f"{x:.4f}"


def _pairs(lq, lk, causal):
    """Visible (query, key) pairs of one head (bottom-right diagonal)."""
    return (sum(min(lk, i + lk - lq + 1) for i in range(lq)) if causal
            else lq * lk)


def _roof(flops, nbytes, peak_flops, bw):
    t_ops, t_bytes = flops / peak_flops, nbytes / bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


KERNELS = ("k1", "k1_lse", "k2", "k3")


def bounds(b, h, lq, lk, d, elt, causal, peak_flops, bw, keep=None):
    """{kernel: (bound_ms, bound_by)} of K1, K1 with logsumexp, K2 and K3
    at one call: the larger of the bytes the function must move (each
    input read once, each output written once) over ``bw`` and its flops
    over ``peak_flops``.

    - K1 reads q, k, v, writes o (and the f32 lse): 4 * d flops per
      visible (query, key) pair (S, P.V).
    - K2 reads q, k, v, o, dO and lse, writes dQ and delta: 6 * d (S, dP,
      dQ).
    - K3 reads q, k, v, dO, lse and delta, writes dK and dV: 8 * d (S,
      dP, dV, dK).

    With a key-padding mask, ``keep`` is the ``[B, Lq, Lk]`` bool of
    visible pairs: the flops are those pairs', the mask's bytes are read
    once, and K and V are read only for the keys some row sees, except
    that K1 reads a batch row's V in full where one of its rows sees no
    key (that row is V's mean). dK and dV are written in full."""
    if keep is None:
        pairs, seen, v_k1, mask_bytes = (b * _pairs(lq, lk, causal),
                                         b * lk, b * lk, 0)
    else:
        seen_b = keep.any(1).sum(1)    # [B]: keys some row sees
        full = keep.any(2).all(1)      # [B]: every row sees a key
        pairs, seen = int(keep.sum()), int(seen_b.sum())
        v_k1 = int((full * seen_b + ~full * lk).sum())
        mask_bytes = b * lk
    rows = b * h * lq * d * elt        # one [B, H, Lq, D] tensor

    def keys(n):                       # K or V rows of n keys
        return n * h * d * elt

    f32 = b * h * lq * 4               # lse or delta
    nbytes = {"k1": 2 * rows + keys(seen + v_k1),
              "k1_lse": 2 * rows + keys(seen + v_k1) + f32,
              "k2": 4 * rows + keys(2 * seen) + 2 * f32,
              "k3": 2 * rows + keys(2 * seen + 2 * b * lk) + 2 * f32}
    flops = {"k1": 4, "k1_lse": 4, "k2": 6, "k3": 8}
    return {k: _roof(flops[k] * d * pairs * h, nbytes[k] + mask_bytes,
                     peak_flops, bw) for k in KERNELS}


def _excess(got, want, tol):
    """(max |got - want|, the largest share of tol * (1 + |want|) that an
    element's error takes: above 1 fails)."""
    diff = (got.float() - want.float()).abs()
    return (diff.max().item(),
            (diff / (tol * (1 + want.float().abs()))).max().item())


def kernel_phase(torch, peaks):
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    cases = [
        # name, (b, h, lq, lk, d), dtype, causal, with_lse. "served" is
        # the call serving makes: the batcher's grown batch of 32, q/k/v
        # strided views into the fused qkv projection
        # (MultiHeadSelfAttention.forward)
        ("serve", (8, 12, 512, 512, 64), "bfloat16", False, False),
        ("serve", (8, 12, 512, 512, 64), "float32", False, False),
        ("served", (32, 12, 512, 512, 64), "bfloat16", False, False),
        ("served", (8, 12, 512, 512, 64), "float32", False, False),
        ("serve_causal", (8, 12, 512, 512, 64), "bfloat16", True, False),
        ("serve_causal", (8, 12, 512, 512, 64), "float32", True, False),
        ("cross_causal", (1, 2, 128, 384, 128), "bfloat16", True, False),
        ("cross_causal", (1, 2, 128, 384, 128), "float32", True, False),
        ("lse", (2, 4, 256, 256, 64), "bfloat16", False, True),
        ("lse", (2, 4, 256, 256, 64), "float32", False, True),
        ("lse_causal", (2, 4, 256, 256, 128), "bfloat16", True, True),
    ]
    rng = np.random.RandomState(0)
    checks = []
    served = {}
    for name, (b, h, lq, lk, d), dt, causal, with_lse in cases:
        dtype = getattr(torch, dt)

        def make(*shape):
            return torch.from_numpy(
                rng.randn(*shape).astype(np.float32)).to("cuda", dtype)

        if name == "served":
            qkv = make(b, lq, 3, h, d)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q, k, v = make(b, h, lq, d), make(b, h, lk, d), make(b, h, lk, d)
        got = fa.flash_attention(q, k, v, causal, None, with_lse)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v, causal, None,
                                           with_lse)
        out, lse = got if with_lse else (got, None)
        ref_out, ref_lse = ref if with_lse else (ref, None)
        if not torch.isfinite(out.float()).all():
            fail(f"K1 {name} {dt}: non-finite output")
        diff = (out.float() - ref_out.float()).abs()
        err = diff.max().item()
        excess = (diff - TOL[dt] * (1 + ref_out.float().abs())).max().item()
        rec = {"case": name, "shape": [b, h, lq, lk, d], "dtype": dt,
               "causal": causal, "max_abs_err": err, "tol": TOL[dt]}
        if with_lse:
            lerr = (lse - ref_lse).abs().max().item()
            rec.update(lse_max_abs_err=lerr, lse_tol=LSE_TOL[dt])
            if not lerr <= LSE_TOL[dt]:
                fail(f"K1 {name} {dt}: lse error {lerr} > {LSE_TOL[dt]}")
        if name.startswith("serve"):
            kind = "bf16" if dt == "bfloat16" else "f32"
            rec["ms"] = time_ms(torch, lambda: fa.flash_attention(
                q, k, v, causal), 50)
            rec["plain_ms"] = time_ms(
                torch, lambda: fa.flash_attention_reference(
                    q, k, v, causal, None), 10)
            rec["library_ms"] = time_ms(
                torch, lambda: torch.nn.functional.
                scaled_dot_product_attention(q, k, v, is_causal=causal),
                50)
            rec["bound_ms"], rec["bound_by"] = bounds(
                b, h, lq, lk, d, q.element_size(), causal, peaks[kind],
                peaks["bw"])["k1"]
            if name == "served" and dt == "bfloat16":
                served = rec
        checks.append(rec)
        print(f"K1 {name} {dt} {[b, h, lq, lk, d]} causal={causal} "
              f"max_abs_err={err:.3g}"
              + (f" lse_err={rec['lse_max_abs_err']:.3g}"
                 if with_lse else "")
              + (f" kernel={rec['ms']:.4f}ms plain={rec['plain_ms']:.4f}ms"
                 f" sdpa={rec['library_ms']:.4f}ms bound="
                 f"{rec['bound_ms']:.4f}ms ({rec['bound_by']})"
                 if "ms" in rec else ""), flush=True)
        if not excess <= 0:
            fail(f"K1 {name} {dt}: error above {TOL[dt]} * (1 + |ref|) "
                 f"(max abs error {err})")
        del q, k, v, got, ref, out, ref_out
    print(json.dumps({"kernel_checks": checks}), flush=True)
    return served


def padding_mask(rng, b, lk, lo, left_rows=(), zero_rows=()):
    """[B, Lk] int32 key-padding mask (1 = real token): real lengths
    uniform in [lo, lk], the first row full and the second at ``lo``;
    ``left_rows`` padded on the left, ``zero_rows`` all padding."""
    lens = rng.randint(lo, lk + 1, b)
    lens[0] = lk
    if b > 1:
        lens[1] = lo
    pos = np.arange(lk)[None, :]
    m = pos < lens[:, None]
    for r in left_rows:
        m[r] = pos[0] >= lk - lens[r]
    for r in zero_rows:
        m[r] = False
    return m.astype(np.int32)


def _right_100(rng, b, lk):
    """100 real keys at the right end: under a bottom-right causal
    diagonal at lq = 128, lk = 384, rows 0-27 see no key."""
    return np.broadcast_to(np.arange(lk) >= lk - 100,
                           (b, lk)).astype(np.int32)


# calls whose q/k/v are views into the fused qkv projection and whose dO
# is laid out as the attention output ([B, L, H, D] memory)
VIEW_CASES = ("trained", "ner_trained", "squad_padded", "minilm_trained",
              "minilm_padded")
# name, (b, h, lq, lk, d), dtype, causal, mask (a function of the rng,
# b and lk; None: no mask), timed. "trained" is the call one BERT-base
# SQuAD train step makes per layer
BACKWARD_CASES = [
    ("trained", (48, 12, 384, 384, 64), "bfloat16", False, None, True),
    ("trained", (48, 12, 384, 384, 64), "float32", False, None, True),
    ("causal", (8, 12, 512, 512, 64), "bfloat16", True, None, True),
    ("cross_causal", (1, 2, 128, 384, 128), "bfloat16", True, None, True),
    ("cross_causal", (1, 2, 128, 384, 128), "float32", True, None, True),
]
# "ner_trained" is one BERT-base NER layer's call on synthetic traffic
# (real lengths uniform in [2, 128], one left-padded row); "squad_padded"
# the SQuAD fine-tune's call with lengths in [64, 384];
# "cross_causal_left" has rows that see no key (left padding past the
# bottom-right diagonal); "all_zero_row" a batch row with no real token
MASKED_CASES = [
    ("ner_trained", (32, 12, 128, 128, 64), "bfloat16", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, left_rows=(2,)), True),
    ("ner_trained", (32, 12, 128, 128, 64), "float32", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, left_rows=(2,)), True),
    ("squad_padded", (48, 12, 384, 384, 64), "bfloat16", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 64), True),
    ("cross_causal_left", (1, 2, 128, 384, 128), "bfloat16", True,
     _right_100, False),
    ("cross_causal_left", (1, 2, 128, 384, 128), "float32", True,
     _right_100, False),
    ("all_zero_row", (4, 12, 128, 128, 64), "bfloat16", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, zero_rows=(1,)), False),
    ("all_zero_row", (4, 12, 128, 128, 64), "float32", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, zero_rows=(1,)), False),
]


def backward_phase(torch, peaks, cases, seed, label, quiet=False):
    """K1 without and with logsumexp, K2 and K3, each through its wrapper
    against its plain version on the card, K2 and K3 reading the kernel's
    own out and lse (as the main path's backward does). With a mask:
    padded keys' dK (and, where every row sees a key, dV) and the dQ of
    rows that see no key must be exactly zero. Timed cases: each kernel
    and SDPA by CUDA events and by profiler device time, the plain
    versions, and bounds. ``quiet`` prints one line for all the cases
    instead of one a case. Returns the cases' records."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.RandomState(seed)
    checks = []
    for name, (b, h, lq, lk, d), dt, causal, mask_of, timed in cases:
        dtype = getattr(torch, dt)
        kind = "bf16" if dt == "bfloat16" else "f32"

        def make(*shape):
            return torch.from_numpy(
                rng.randn(*shape).astype(np.float32)).to("cuda", dtype)

        if name in VIEW_CASES:
            qkv = make(b, lq, 3, h, d)
            q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
            do = make(b, lq, h, d).transpose(1, 2)
        else:
            q, k, v = make(b, h, lq, d), make(b, h, lk, d), make(b, h, lk, d)
            do = make(b, h, lq, d)
        rec = {"case": name, "shape": [b, h, lq, lk, d], "dtype": dt,
               "causal": causal, "tol": TOL[dt], "lse_tol": LSE_TOL[dt]}
        m = keep = None
        if mask_of is not None:
            m = torch.from_numpy(mask_of(rng, b, lk)).cuda()
            keep = fa._visible(lq, lk, causal, m, m.device).expand(
                b, 1, lq, lk)[:, 0]                     # [B, Lq, Lk]
            empty = ~keep.any(-1)                       # [B, Lq]
            rec.update(real_keys=int(m.ne(0).sum()), keys=b * lk,
                       rows_without_key=int(empty.sum()) * h,
                       visible_pairs=int(keep.sum()) * h)

        def check(key, got, want, tol):
            if not torch.isfinite(got.float()).all():
                fail(f"{label} {key} {name} {dt}: non-finite output")
            err, share = _excess(got, want, tol)
            rec[f"{key}_max_abs_err"] = err
            rec[f"{key}_tol_share"] = share
            if not share <= 1:
                fail(f"{label} {key} {name} {dt}: error above {tol} * "
                     f"(1 + |ref|) (max abs error {err})")

        out = fa.flash_attention(q, k, v, causal, None, False, m)
        torch.cuda.synchronize()
        check("k1", out, fa.flash_attention_reference(
            q, k, v, causal, None, False, m), TOL[dt])
        # K1 with logsumexp: out within TOL * (1 + |ref|), lse within
        # LSE_TOL; K2 and K3 below read this out and lse
        o, lse = fa.flash_attention(q, k, v, causal, None, True, m)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, causal, None,
                                                True, m)
        check("k1_lse_out", o, ro, TOL[dt])
        lerr = (lse - rlse).abs().max().item()
        rec["k1_lse_max_abs_err"] = lerr
        if not (torch.isfinite(lse).all() and lerr <= LSE_TOL[dt]):
            fail(f"{label} K1 lse {name} {dt}: error {lerr} > {LSE_TOL[dt]}")
        del ro, rlse
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal,
                                              None, m)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal,
                                            None, m)
        torch.cuda.synchronize()
        rdq, rdelta = fa.flash_attention_bwd_dq_reference(
            q, k, v, o, lse, do, causal, None, m)
        rdk, rdv = fa.flash_attention_bwd_dkv_reference(
            q, k, v, lse, rdelta, do, causal, None, m)
        check("dq", dq, rdq, TOL[dt])
        check("delta", delta, rdelta, TOL["float32"])
        check("dk", dk, rdk, TOL[dt])
        check("dv", dv, rdv, TOL[dt])
        if m is not None:
            # exact zeros: padded keys' dK; their dV where every row of
            # the batch row sees a key; dQ of rows that see no key
            pad = m == 0                                # [B, Lk]
            if torch.count_nonzero(dk[pad[:, None, :, None].expand_as(dk)]):
                fail(f"{label} K3 {name} {dt}: padded keys get a nonzero dK")
            pad_v = (pad & ~empty.any(1)[:, None])[:, None, :, None]
            if torch.count_nonzero(dv[pad_v.expand_as(dv)]):
                fail(f"{label} K3 {name} {dt}: padded keys get a nonzero dV")
            if torch.count_nonzero(dq[empty[:, None, :, None].expand_as(dq)]):
                fail(f"{label} K2 {name} {dt}: a row that sees no key gets "
                     f"a nonzero dQ")
        rec["k2_max_abs_err"] = max(rec["dq_max_abs_err"],
                                    rec["delta_max_abs_err"])
        rec["k3_max_abs_err"] = max(rec["dk_max_abs_err"],
                                    rec["dv_max_abs_err"])
        if timed:
            # the mask as the main path hands it over (BERTModule makes
            # the bytes once a forward)
            mk = fa._kernel_mask(m)
            calls = {
                "k1": lambda: fa.flash_attention(q, k, v, causal, None,
                                                 False, mk),
                "k1_lse": lambda: fa.flash_attention(q, k, v, causal, None,
                                                     True, mk),
                "k2": lambda: fa.flash_attention_bwd_dq(
                    q, k, v, o, lse, do, causal, None, mk),
                "k3": lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, lse, delta, do, causal, None, mk)}
            plain = {
                "k1": lambda: fa.flash_attention_reference(
                    q, k, v, causal, None, False, m),
                "k1_lse": lambda: fa.flash_attention_reference(
                    q, k, v, causal, None, True, m),
                "k2": lambda: fa.flash_attention_bwd_dq_reference(
                    q, k, v, o, lse, do, causal, None, m),
                "k3": lambda: fa.flash_attention_bwd_dkv_reference(
                    q, k, v, lse, rdelta, do, causal, None, m)}
            for key in KERNELS:
                rec[f"{key}_ms"] = time_ms(torch, calls[key], 20)
                rec[f"{key}_device_ms"] = device_ms(torch, calls[key])
                rec[f"{key}_plain_ms"] = time_ms(torch, plain[key], 3)
            for key, bnd in bounds(b, h, lq, lk, d, q.element_size(),
                                   causal, peaks[kind], peaks["bw"],
                                   keep).items():
                rec[f"{key}_bound_ms"], rec[f"{key}_bound_by"] = bnd
            # SDPA (a yardstick; the port never calls it), the mask as a
            # boolean attn_mask: the forward at inference, the forward
            # with inputs that need a gradient (it keeps its logsumexp),
            # and the backward alone replayed on one retained graph. It
            # aligns a causal diagonal top-left and takes no mask beside
            # is_causal, so only equal lengths without both compare
            if lq == lk and not (causal and m is not None):
                attn = None if m is None else m.bool()[:, None, None, :]
                qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
                sout = sdpa(qs, ks, vs, attn_mask=attn, is_causal=causal)
                calls = {
                    "sdpa": lambda: sdpa(q, k, v, attn_mask=attn,
                                         is_causal=causal),
                    "sdpa_fwd": lambda: sdpa(qs, ks, vs, attn_mask=attn,
                                             is_causal=causal),
                    "sdpa_bwd": lambda: torch.autograd.grad(
                        sout, (qs, ks, vs), do, retain_graph=True)}
                for key, fn in calls.items():
                    rec[f"{key}_ms"] = time_ms(torch, fn, 20, warm=5)
                    rec[f"{key}_device_ms"] = device_ms(torch, fn)
                del sout, qs, ks, vs
        checks.append(rec)
        if quiet:
            del q, k, v, do, o, lse, dq, dk, dv, delta, rdq, rdk, rdv, rdelta
            continue
        print(f"{label} {name} {dt} {[b, h, lq, lk, d]} causal={causal}"
              + (f" real keys {rec['real_keys']}/{rec['keys']}, rows "
                 f"without a key {rec['rows_without_key']}"
                 if m is not None else "")
              + "; err " + " ".join(
                  f"{key}={rec[key + '_max_abs_err']:.3g}" for key in (
                      "k1", "k1_lse_out", "k1_lse", "dq", "delta", "dk",
                      "dv")), flush=True)
        if timed:
            both = (None if None in (rec["k2_device_ms"], rec["k3_device_ms"])
                    else rec["k2_device_ms"] + rec["k3_device_ms"])
            print(f"{label} {name} {dt} ms, (device ms): " + "; ".join(
                f"{key} {rec[key + '_ms']:.4f} "
                f"({_ms(rec[key + '_device_ms'])}) plain "
                f"{rec[key + '_plain_ms']:.4f} bound "
                f"{rec[key + '_bound_ms']:.4f} ({rec[key + '_bound_by']})"
                for key in KERNELS) + "".join(
                f"; {key} {rec[key + '_ms']:.4f} "
                f"({_ms(rec[key + '_device_ms'])})"
                for key in ("sdpa", "sdpa_fwd", "sdpa_bwd")
                if key + "_ms" in rec)
                + f"; K2+K3 {rec['k2_ms'] + rec['k3_ms']:.4f} ({_ms(both)})",
                flush=True)
        del q, k, v, do, o, lse, dq, dk, dv, delta, rdq, rdk, rdv, rdelta
    if quiet:
        keys = ("k1", "k1_lse_out", "dq", "delta", "dk", "dv")
        print(f"{label}: all {len(checks)} cases match the plain versions; "
              "largest error, as a share of its tolerance: " + " ".join(
                  f"{key} {max(r[key + '_tol_share'] for r in checks):.3g}"
                  for key in keys), flush=True)
    else:
        print(json.dumps({f"{label}_checks": checks}), flush=True)
    return checks


# K5b: the forward kernel at head dims that are not a multiple of 64.
# name, (b, h, lq, lk, d), dtype, causal, mask (a function of the rng, b
# and lk; None: no mask), with_lse. "gen_full" is TinyGenLM's prefill at
# Phi-2's widths (32 heads of 80, f32) in its top bucket and one of 512,
# "gen_repo" the repo geometry's top bucket (2 heads of 16, f32);
# "minilm_masked" MiniLM-L12-H384's heads (12 of 32) on a padded NER-like
# batch with one left-padded row and one row with no real token
K5B_CASES = [
    ("gen_full", (1, 32, 2048, 2048, 80), "float32", True, None, False),
    ("gen_full", (1, 32, 512, 512, 80), "float32", True, None, False),
    ("gen_repo", (1, 2, 256, 256, 16), "float32", True, None, False),
    ("bf16_d80", (8, 32, 1024, 1024, 80), "bfloat16", True, None, False),
    ("minilm_masked", (32, 12, 128, 128, 32), "bfloat16", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 2, left_rows=(2,),
                                     zero_rows=(3,)), False),
    ("d40", (2, 4, 256, 256, 40), "bfloat16", True, None, True),
    ("d40", (2, 4, 256, 256, 40), "float32", True, None, True),
]
# the head dims K5b is built for: multiples of 8 up to 128 but not of 64
K5B_HEAD_DIMS = [d for d in range(8, 129, 8) if d % 64]


def _k5b_mask(rng, b, lk):
    """A full batch row, one of 2 real keys, one left-padded and one
    with no real token."""
    return padding_mask(rng, b, lk, 2, left_rows=(2,), zero_rows=(3,))


# K5b backward (K1-lse, K2 and K3 at those head dims), in backward_phase's
# case form. Every instantiation once: each D in bf16 and f32, without a
# mask and with _k5b_mask, causal at lq == lk for the unmasked calls at
# D = 8 (mod 16) and the masked ones at D = 0 (mod 16), so each of the two
# residues sees both flags and left padding under causal leaves rows that
# see no key
K5B_BWD_SWEEP = [
    (f"d{d}", (4, 2, 128, 128, d), dt, causal, mask_of, False)
    for d in K5B_HEAD_DIMS for dt in ("bfloat16", "float32")
    for causal, mask_of in ((d % 16 == 8, None), (d % 16 == 0, _k5b_mask))]
# the call one MiniLM-L12-H384 SQuAD train step makes per layer (12 heads
# of 32, views into the qkv projection), without a mask and padded (real
# lengths uniform in [64, 384], the fine-tune's traffic)
K5B_BWD_CASES = [
    ("minilm_trained", (48, 12, 384, 384, 32), "bfloat16", False, None,
     True),
    ("minilm_padded", (48, 12, 384, 384, 32), "bfloat16", False,
     lambda rng, b, lk: padding_mask(rng, b, lk, 64), True),
]


def k5b_bwd_phase(torch, peaks):
    """K5b backward through ``backward_phase``: every instantiation once
    (``K5B_BWD_SWEEP``, one summary line), then the MiniLM trained calls
    (``K5B_BWD_CASES``, timed). Each sweep case must count one K2 and
    one K3 launch in ``small_d_launches``. Returns the timed records."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    wrappers = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [w.small_d_launches for w in wrappers]
    backward_phase(torch, peaks, K5B_BWD_SWEEP, 6, "k5b-bwd-sweep",
                   quiet=True)
    counted = [w.small_d_launches - n for w, n in zip(wrappers, before)]
    if counted != [len(K5B_BWD_SWEEP)] * 2:
        fail(f"K5b backward: K2 and K3 counted {counted} K5b launches in "
             f"{len(K5B_BWD_SWEEP)} sweep cases")
    return backward_phase(torch, peaks, K5B_BWD_CASES, 7, "k5b-bwd")


def k5b_phase(torch, peaks):
    """K5b through the ``flash_attention`` wrapper against its plain
    version on the card: every instantiation once ([2,2,128,d], causal
    without a mask and non-causal with one, with its logsumexp, in bf16
    and f32), then ``K5B_CASES``, each timed (CUDA events and profiler
    device time) beside its plain version, SDPA (a yardstick; the port
    never calls it) and its bound. Also checks the gate: a head dim that
    is not a multiple of 8 raises NotImplementedError. Returns the cases'
    records."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.RandomState(5)

    def make(shape, dtype):
        return torch.from_numpy(
            rng.randn(*shape).astype(np.float32)).to("cuda", dtype)

    def check(label, b, h, lq, lk, d, dt, causal, m, with_lse):
        dtype = getattr(torch, dt)
        q = make((b, h, lq, d), dtype)
        k, v = make((b, h, lk, d), dtype), make((b, h, lk, d), dtype)
        before = fa.flash_attention.small_d_launches
        got = fa.flash_attention(q, k, v, causal, None, with_lse, m)
        torch.cuda.synchronize()
        if fa.flash_attention.small_d_launches != before + 1:
            fail(f"K5b {label}: the wrapper did not count a K5b launch")
        ref = fa.flash_attention_reference(q, k, v, causal, None, with_lse,
                                           m)
        out, lse = got if with_lse else (got, None)
        ref_out, ref_lse = ref if with_lse else (ref, None)
        if not torch.isfinite(out.float()).all():
            fail(f"K5b {label}: non-finite output")
        err, share = _excess(out, ref_out, TOL[dt])
        if not share <= 1:
            fail(f"K5b {label}: error above {TOL[dt]} * (1 + |ref|) "
                 f"(max abs error {err})")
        rec = {"max_abs_err": err, "tol": TOL[dt]}
        if with_lse:
            rec["lse_max_abs_err"] = (lse - ref_lse).abs().max().item()
            if not rec["lse_max_abs_err"] <= LSE_TOL[dt]:
                fail(f"K5b {label}: lse error {rec['lse_max_abs_err']} > "
                     f"{LSE_TOL[dt]}")
        return q, k, v, rec

    sweep = []
    for d in K5B_HEAD_DIMS:
        for dt in ("bfloat16", "float32"):
            for masked in (False, True):
                m = (torch.from_numpy(padding_mask(
                    rng, 2, 128, 2, zero_rows=(1,))).cuda()
                    if masked else None)
                _, _, _, rec = check(f"d={d} {dt} mask={masked}", 2, 2,
                                     128, 128, d, dt, not masked, m, True)
                sweep.append(max(rec["max_abs_err"] / TOL[dt],
                                 rec["lse_max_abs_err"] / LSE_TOL[dt]))
    print(f"K5b: all {len(K5B_HEAD_DIMS)} head dims x bf16/f32 x "
          f"mask/none match the plain version (largest error "
          f"{max(sweep):.3g} of its tolerance)", flush=True)

    x = make((1, 1, 128, 20), torch.float32)
    try:
        fa.flash_attention(x, x, x)
        fail("K5b: head_dim 20 (not a multiple of 8) did not raise")
    except NotImplementedError as e:
        print(f"K5b: head_dim 20 raises: {str(e)[:80]}...", flush=True)
    del x

    checks = []
    for name, (b, h, lq, lk, d), dt, causal, mask_of, with_lse in K5B_CASES:
        kind = "bf16" if dt == "bfloat16" else "f32"
        m = keep = None
        if mask_of is not None:
            m = torch.from_numpy(mask_of(rng, b, lk)).cuda()
            keep = fa._visible(lq, lk, causal, m, m.device).expand(
                b, 1, lq, lk)[:, 0]
        q, k, v, rec = check(f"{name} {dt}", b, h, lq, lk, d, dt, causal, m,
                             with_lse)
        rec.update(case=name, shape=[b, h, lq, lk, d], dtype=dt,
                   causal=causal)
        if m is not None:
            rec.update(real_keys=int(m.ne(0).sum()), keys=b * lk,
                       rows_without_key=int((~keep.any(-1)).sum()) * h)
        mk = fa._kernel_mask(m)
        call = lambda: fa.flash_attention(q, k, v, causal, None, with_lse,
                                          mk)
        attn = None if m is None else m.bool()[:, None, None, :]
        # SDPA aligns a causal diagonal top-left: equal at lq == lk
        lib = lambda: sdpa(q, k, v, attn_mask=attn, is_causal=causal)
        rec["ms"] = time_ms(torch, call, 20)
        rec["device_ms"] = device_ms(torch, call)
        rec["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v, causal, None, with_lse, m), 3)
        rec["library_ms"] = time_ms(torch, lib, 20)
        rec["library_device_ms"] = device_ms(torch, lib)
        rec["bound_ms"], rec["bound_by"] = bounds(
            b, h, lq, lk, d, q.element_size(), causal, peaks[kind],
            peaks["bw"], keep)["k1_lse" if with_lse else "k1"]
        checks.append(rec)
        print(f"K5b {name} {dt} {[b, h, lq, lk, d]} causal={causal}"
              + (f" real keys {rec['real_keys']}/{rec['keys']}, rows "
                 f"without a key {rec['rows_without_key']}"
                 if m is not None else "")
              + f" err={rec['max_abs_err']:.3g}"
              + (f" lse_err={rec['lse_max_abs_err']:.3g}" if with_lse
                 else "")
              + f"; kernel {rec['ms']:.4f} ({_ms(rec['device_ms'])}) ms, "
              f"plain {rec['plain_ms']:.4f}, sdpa {rec['library_ms']:.4f} "
              f"({_ms(rec['library_device_ms'])}), bound "
              f"{rec['bound_ms']:.4f} ({rec['bound_by']})", flush=True)
        del q, k, v
    print(json.dumps({"k5b_checks": checks}), flush=True)
    return checks


def _pick(records, name, dt="bfloat16"):
    return next(r for r in records if r["case"] == name and r["dtype"] == dt)


BERT_BASE = dict(num_classes=2, vocab=30522, hidden_size=768, n_block=12,
                 n_head=12, intermediate_size=3072, max_position_len=512,
                 dtype="bfloat16")
# the JAX package's fine-tune workload (bench.py measure_bert): BERT-base
# BERTSQuAD, seq 384, batch 48, 16 steps an epoch, bf16 encoder
SQUAD_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                  intermediate_size=3072, max_position_len=512,
                  dtype="bfloat16")
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 384, 48, 16
BF16_PEAK = 989e12


def profile_batch(torch, model, x, iters=10) -> None:
    """Where one served batch's time goes: host wall time per predict,
    device time by kernel (torch.profiler), and the device idle share."""
    from torch.profiler import ProfilerActivity, profile

    model.predict(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.predict(x)
    wall = (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            model.predict(x)
        torch.cuda.synchronize()
    shape = x["input_ids"].shape if isinstance(x, dict) else x.shape
    _print_rows(prof, 3, wall, f"batch {shape} predict")


# kernel-name marks of the groups a profile is summed into
KERNEL_GROUPS = (
    ("flash (K1-K3)", ("flash_fwd", "flash_bwd")),
    ("gemm", ("nvjet", "gemm", "cutlass", "Kernel2")),
    ("layer_norm", ("layer_norm", "GammaBeta")),
    ("indexing (KV gathers)", ("index", "gather")),
    ("optimizer", ("multi_tensor_apply",)),
    ("copies and casts", ("copy_kernel", "Memcpy", "Memset")),
)


def _print_rows(prof, n, wall, what, top=14) -> None:
    """Device time by kernel per iteration (``n`` profiled iterations),
    and the idle share against ``wall`` (seconds per iteration, measured
    without the profiler, whose host-side cost would stretch the
    window). Kernel rows only: an operator row repeats its kernels'
    device time."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total / (n * 1e3), e.count / n, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile: {what} wall {wall * 1e3:.3f} ms; device busy "
          f"{busy:.3f} ms per iteration; idle share "
          f"{1 - busy / (wall * 1e3):.3f}", flush=True)
    for ms, calls, name in rows[:top]:
        print(f"profile:   {ms:9.4f} ms {100 * ms / max(busy, 1e-9):5.1f}% "
              f"x{calls:g} {name[:90]}", flush=True)
    groups = {}
    for ms, calls, name in rows:
        key = next((g for g, marks in KERNEL_GROUPS if any(
            m in name for m in marks)), "other")
        groups[key] = groups.get(key, 0.0) + ms
    print("profile:   by group " + ", ".join(
        f"{g} {ms:.3f} ms ({100 * ms / max(busy, 1e-9):.1f}%)"
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])),
        flush=True)


def _reset_launches(fa):
    for w in (fa.flash_attention, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv):
        w.launches = w.masked_launches = w.small_d_launches = 0


def _launches(fa):
    """{kernel: (launches, launches with a mask, launches at a head dim
    that is not a multiple of 64)} since the last reset."""
    return {name: (w.launches, w.masked_launches, w.small_d_launches)
            for name, w in (
        ("K1", fa.flash_attention), ("K2", fa.flash_attention_bwd_dq),
        ("K3", fa.flash_attention_bwd_dkv))}


def serving_phase(torch, start, reqs, input_fn, out_shape, n_block,
                  masked=False, label="serving", device="cuda",
                  profile=False):
    """One closed burst of ``reqs`` ({uri: {name: array}}) through the
    deployment ``start()`` brings up (load and warm-up included); it
    returns (input queue, output queue, InferenceModel, batcher, stop).
    Checks that every request is answered once with finite
    ``out_shape`` logits, that K1 ran (with the mask, where ``masked``)
    for every encoder layer of every dispatched batch, and that 4
    replies match the same model with einsum attention (at real tokens,
    where requests carry an ``attention_mask``). ``input_fn`` maps named
    tensors to the model's input, as the worker does. Returns K1's
    (launches, masked launches)."""
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.obs.metrics import get_registry
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    cfg = get_config()
    # the auto threshold (512) is the reference's TPU figure; serve
    # through the kernel explicitly
    cfg.set("zoo.ops.attention_impl", "flash")
    n_requests = len(reqs)
    dispatch = get_registry().get(
        "zoo_inference_dispatch_total").labels(mode="off")
    d0 = dispatch.value
    _reset_launches(fa)
    # ---- main path: start (load, warm-up) -> ServingWorker ->
    # InferenceModel ----
    t0 = time.perf_counter()
    in_q, out_q, model, batcher, stop = start()
    print(f"{label}: up in {time.perf_counter() - t0:.1f}s", flush=True)
    try:
        sent, got, lat = {}, {}, []
        t_start = time.perf_counter()
        for uri, tensors in reqs.items():
            sent[uri] = time.perf_counter()
            if not in_q.enqueue(uri, **tensors):
                fail(f"{label}: enqueue refused {uri}")
        deadline = time.perf_counter() + 300
        while len(got) < n_requests and time.perf_counter() < deadline:
            item = out_q.dequeue(timeout=1.0)
            if item is None:
                continue
            uri, tensors = item
            if uri in got:
                fail(f"{label}: {uri} answered twice")
            lat.append(time.perf_counter() - sent[uri])
            got[uri] = tensors
        wall = time.perf_counter() - t_start
        k1 = _launches(fa)["K1"]
        dispatched = int(dispatch.value - d0)
        # ---- end of the main path ----
        stats = batcher.stats()
        if set(got) != set(reqs):
            fail(f"{label}: answered {len(got)}/{n_requests} requests")
        for uri, tensors in got.items():
            out = tensors.get("output")
            if out is None or out.shape != out_shape \
                    or not np.isfinite(out).all():
                fail(f"{label} {uri}: bad reply "
                     f"{tensors if out is None else out.shape}")
        need = n_block * dispatched if device == "cuda" else 0
        if k1[int(masked)] < need:
            fail(f"{label}: K1 launched {k1[int(masked)]} times"
                 + (" with a mask" if masked else "") + f" < {n_block} x "
                 f"{dispatched} dispatched batches")

        def batch_of(uris):
            return input_fn({k: np.stack([reqs[u][k] for u in uris])
                             for k in reqs[uris[0]]})

        # reference: the same served model, einsum attention path
        check = sorted(reqs)[:4]
        cfg.set("zoo.ops.attention_impl", "einsum")
        ref = model.predict(batch_of(check))
        cfg.set("zoo.ops.attention_impl", "flash")
        served = np.stack([got[u]["output"] for u in check])
        diff = np.abs(served - ref)
        if "attention_mask" in reqs[check[0]]:
            diff = diff[np.stack([reqs[u]["attention_mask"]
                                  for u in check]) != 0]
        diff = float(diff.max())
        print(f"{label}: flash vs einsum logits max_abs_diff={diff:.4g}"
              f" (tol {SERVE_TOL}); logits[0]={served[0].ravel()[:4]}",
              flush=True)
        if not diff <= SERVE_TOL:
            fail(f"{label}: served logits differ from the einsum path by "
                 f"{diff}")
        if profile:
            # a batch of the size the batcher served the burst in
            x = batch_of(sorted(reqs)[:stats["max_batch_size"]])
            for impl in ("flash", "einsum"):
                cfg.set("zoo.ops.attention_impl", impl)
                print(f"profile: attention_impl={impl}", flush=True)
                profile_batch(torch, model, x)
            cfg.set("zoo.ops.attention_impl", "flash")
    finally:
        stop()
    lat_ms = np.asarray(lat) * 1e3
    first = next(iter(reqs.values()))
    seq = first["input_ids"].shape[0]
    real = sum(int(np.count_nonzero(t["attention_mask"])) if
               "attention_mask" in t else seq for t in reqs.values())
    summary = {
        "requests": n_requests, "seq": seq, "wall_s": wall,
        "rps": n_requests / wall, "real_tokens_per_s": real / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "dispatched_batches": dispatched, "k1_launches": k1[0],
        "k1_masked_launches": k1[1], "served_batches": stats["batches"],
        "mean_occupancy": stats["mean_occupancy"],
        "max_batch_size": stats["max_batch_size"],
        "einsum_max_abs_diff": diff,
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else device)}
    print(f"{label}: " + json.dumps(summary), flush=True)
    return k1


def bert_serving(torch, device="cuda", base=BERT_BASE, n_requests=64,
                 seq=512, batch=8, profile=False):
    """A seeded BERT-base BERTClassifier saved, then served through
    ``launch()`` (which warms every bucket up to the batcher's growth
    cap): ``n_requests`` requests of ``input_ids [seq]``, no mask."""
    from analytics_zoo_tpu_torch.models.text.bert_estimators import (
        BERTClassifier)
    from analytics_zoo_tpu_torch.serving.launcher import launch

    rng = np.random.RandomState(0)
    reqs = {f"req{i:03d}": {"input_ids": rng.randint(
        0, base["vocab"], seq).astype(np.int32)} for i in range(n_requests)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        BERTClassifier(device=device, seed=0, **base).save_model(tmp)
        print(f"serving: BERT-base saved in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

        def start():
            app = launch({
                "model": {"path": tmp},
                "params": {"batch_size": batch,
                           "warm_example": np.zeros((1, seq), np.int32)},
                "http": {"enabled": False}}, device=device)
            return (app.input_queue, app.output_queue, app.model,
                    app.worker.batcher, app.stop)

        return serving_phase(torch, start, reqs,
                             lambda t: t["input_ids"],
                             (base["num_classes"],), base["n_block"],
                             device=device, profile=profile)


def _ner_input(tensors):
    """The NER deployment's input_fn: a request's named tensors as the
    model's input dict (``launch()`` maps several tensors to a tuple)."""
    return {"input_ids": tensors["input_ids"],
            "attention_mask": tensors["attention_mask"]}


def profile_train_step(torch, est, x, y, iters=5) -> None:
    """Where one train step's time goes: host wall time per step and
    device time by kernel (torch.profiler), kernel rows only."""
    from torch.profiler import ProfilerActivity, profile

    est._train_step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        est._train_step(x, y)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            est._train_step(x, y)
        torch.cuda.synchronize()
    _print_rows(prof, 3, wall, f"train step {tuple(y.shape[:1])}", top=20)


GRAD_PARAMS = ("squad.bert.encoder_0.attention.qkv.weight",
               "squad.head.weight")


def step_grads(torch, module, xb, yb, impl, loss_fn, names):
    """(loss, {param: gradient}) of one step at ``module``'s weights with
    ``impl`` attention (``train=False``: hidden dropout off)."""
    from analytics_zoo_tpu_torch.common.config import get_config

    cfg = get_config()
    cfg.set("zoo.ops.attention_impl", impl)
    params = dict(module.named_parameters())
    module.zero_grad(set_to_none=True)
    loss = loss_fn(module(xb, train=False), yb)
    loss.backward()
    grads = {k: params[k].grad.float().clone() for k in names}
    module.zero_grad(set_to_none=True)
    cfg.set("zoo.ops.attention_impl", "flash")
    return float(loss.detach()), grads


def _rel(a, b, keys=None):
    """{param: ||a - b|| / ||b||} over ``keys`` (default: all of b's)."""
    return {k: float((a[k] - b[k]).norm() / b[k].norm())
            for k in (keys or b)}


def grad_check(torch, module, xb, yb, ref, loss_fn, names, label):
    """One step's gradients with flash and with einsum attention at the
    same weights and batch, and each bf16 path's distance from ``ref``
    (loss, grads) of the same step in f32. Returns the relative errors
    ||g_a - g_b|| / ||g_b||, the flash/einsum loss gap and the einsum
    gradients."""
    loss_f, g_f = step_grads(torch, module, xb, yb, "flash", loss_fn, names)
    loss_e, g_e = step_grads(torch, module, xb, yb, "einsum", loss_fn, names)
    rel = {name: _rel(a, b) for name, a, b in (
        ("flash_vs_einsum", g_f, g_e), ("flash_vs_f32", g_f, ref[1]),
        ("einsum_vs_f32", g_e, ref[1]))}
    losses = {"flash": loss_f, "einsum": loss_e, "f32": ref[0]}
    print(f"{label}: gradients rel_err={rel} (tol {GRAD_TOL}); loss "
          f"{losses} (tol {LOSS_TOL})", flush=True)
    return rel, abs(loss_f - loss_e), g_e


def fault_controls(torch, module, xb, yb, g_einsum, tol, faults, loss_fn,
                   names, label):
    """The flash step again with the backward broken on purpose, each
    fault held against the einsum gradients as the gradient check holds
    the sound step: "dq_zeroed", "dk_dv_swapped", or "mask_dropped" (K2
    and K3 without the key-padding mask, K1-lse still masked). Returns
    each fault's relative error on the layer-0 qkv weight; with ``tol``,
    fails unless each exceeds it, so that check is known to tell a
    broken backward from a sound one."""
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    bwd = fa.flash_attention_bwd
    # FlashAttention.backward passes every argument positionally: (q, k,
    # v, o, lse, do, causal, scale, key_padding_mask)
    broken = {
        "dq_zeroed": lambda *a: (lambda dq, dk, dv: (
            torch.zeros_like(dq), dk, dv))(*bwd(*a)),
        "dk_dv_swapped": lambda *a: (lambda dq, dk, dv: (dq, dv, dk))(
            *bwd(*a)),
        "mask_dropped": lambda *a: bwd(*a[:8])}
    qkv = names[:1]
    rel = {}
    try:
        for name in faults:
            fa.flash_attention_bwd = broken[name]
            _, g = step_grads(torch, module, xb, yb, "flash", loss_fn, names)
            rel[name] = _rel(g, g_einsum, qkv)[qkv[0]]
    finally:
        fa.flash_attention_bwd = bwd
    print(f"{label}: planted faults, {qkv[0]} rel_err={rel}"
          + (f" (each must exceed {tol})" if tol else " (recorded)"),
          flush=True)
    for name, r in rel.items():
        if tol and not r > tol:
            fail(f"the gradient check misses a planted fault ({name}): "
                 f"rel_err {r} <= {tol}")
    return rel


def learn_phase(torch, cls, base, x, y, batch, loss_fn, names, faults,
                masked=False, label="learn", save_to=None, device="cuda",
                profile=False):
    """The flash-vs-einsum gradient checks at the initial weights (f32,
    with its planted ``faults``, which it must reject, and bf16; where
    the batch carries an ``attention_mask``, both again without it),
    then the fine-tune of ``cls`` on (``x``, ``y``)
    through ZooModel.fit -> Estimator.fit (2 epochs, the second timed),
    then evaluate and predict; saves the fitted model to ``save_to`` if
    given. K1, K2 and K3 must each launch (with the mask, where
    ``masked``) at least once per encoder layer a step. Returns the
    fit's ``_launches``."""
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.learn.optim import param_tree
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    cfg = get_config()
    # the auto threshold (512) is the reference's TPU figure: at L <= 512
    # it would route around the kernels
    cfg.set("zoo.ops.attention_impl", "flash")
    cuda = device == "cuda"
    n, seq = x["input_ids"].shape
    steps_per_epoch = n // batch
    grad = dict(loss_fn=loss_fn, names=names)
    # one step's gradients at the initial weights and the first batch,
    # hidden dropout off. In f32: flash (K1-lse, K2, K3) against einsum
    # attention, and the same with the backward broken on purpose
    xb = {k: torch.from_numpy(a[:batch]).to(device) for k, a in x.items()}
    yb = torch.from_numpy(y[:batch]).to(device)
    # the batches the checks run on: the first, and without its mask
    batches = {"": xb}
    if "attention_mask" in xb:
        batches[" unmasked"] = {k: t for k, t in xb.items()
                                if k != "attention_mask"}
    f32 = cls(device=device, seed=0, **dict(base, dtype="float32"))
    refs, rel32 = {}, {}
    for tag, xc in batches.items():
        refs[tag] = step_grads(torch, f32.module, xc, yb, "einsum", **grad)
        rel32[tag] = _rel(step_grads(torch, f32.module, xc, yb, "flash",
                                     **grad)[1], refs[tag][1])
        print(f"{label}{tag}: f32 gradients flash vs einsum rel_err="
              f"{rel32[tag]} (tol {F32_GRAD_TOL})", flush=True)
        if not all(r <= F32_GRAD_TOL for r in rel32[tag].values()):
            fail(f"{label}{tag}: f32 gradients flash vs einsum differ: "
                 f"{rel32[tag]}")
    ref = refs[""]
    planted = {"f32": fault_controls(torch, f32.module, xb, yb, ref[1],
                                     F32_GRAD_TOL, faults, label=label,
                                     **grad)}
    del f32
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = cls(device=device, seed=0, **base)
    print(f"{label}: {cls.__name__} built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    rels, dlosses = {}, {}
    for tag, xc in batches.items():
        rels[tag], dlosses[tag], g = grad_check(
            torch, model.module, xc, yb, refs[tag], label=label + tag,
            **grad)
        if tag == "":
            g_einsum = g
        for name in ("flash_vs_einsum", "flash_vs_f32"):
            if not all(r <= GRAD_TOL for r in rels[tag][name].values()):
                fail(f"{label}{tag}: gradients {name} differ: "
                     f"{rels[tag][name]}")
        if not dlosses[tag] <= LOSS_TOL:
            fail(f"{label}{tag}: flash and einsum losses differ by "
                 f"{dlosses[tag]}")
    del g
    # the same faults against the bf16 check, for the record
    planted["bf16"] = fault_controls(torch, model.module, xb, yb, g_einsum,
                                     None, faults, label=label, **grad)
    del g_einsum
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_launches(fa)
    # ---- main path: ZooModel.fit -> Estimator.fit ----
    t0 = time.perf_counter()
    hist = model.fit((x, y), batch_size=batch, epochs=2)
    if cuda:
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launches(fa)
    # ---- end of the main path ----
    peak = torch.cuda.max_memory_allocated() if cuda else None
    est = model.estimator
    steps = est.global_step
    if steps != 2 * steps_per_epoch or len(hist) != 2:
        fail(f"{label}: fit ran {steps} steps in {len(hist)} epochs")
    losses = [h["loss"] for h in hist]
    # an epoch's loss is the mean of its steps' losses: finite means
    # every step's loss was finite
    if not all(np.isfinite(losses)):
        fail(f"{label}: non-finite training loss: {losses}")
    need = base["n_block"] * steps if cuda else 0
    for kname, counts in launches.items():
        if counts[int(masked)] < need:
            fail(f"{label}: {kname} launched {counts[int(masked)]} times"
                 + (" with a mask" if masked else "")
                 + f" in {steps} train steps (< {need})")
    timed = hist[1]["seconds"]
    sps = steps_per_epoch / timed
    # one epoch's real tokens (the mask's ones) and padded tokens
    real = (int(np.count_nonzero(x["attention_mask"]))
            if "attention_mask" in x else n * seq)
    p_dense = sum(p.numel() for pname, p in param_tree(model.module).items()
                  if "embed" not in pname.lower())
    flops_per_token = (6 * p_dense
                       + 12 * base["n_block"] * base["hidden_size"] * seq)
    # bench.py's formula over every position the encoder computes
    # (padding included), as the kernels and GEMMs do the work for it
    mfu = sps * batch * seq * flops_per_token / BF16_PEAK

    # evaluate and predict on the same Estimator
    m = 2 * batch
    xe = {k: a[:m] for k, a in x.items()}
    ev = model.evaluate((xe, y[:m]), batch_size=batch)
    pred = model.predict(xe, batch_size=batch)
    if not np.isfinite(ev["loss"]):
        fail(f"{label} evaluate: non-finite loss {ev}")
    for t in pred if isinstance(pred, (tuple, list)) else (pred,):
        if t.shape[:2] != (m, seq) or not np.isfinite(t).all():
            fail(f"{label} predict: bad output {t.shape}")
    acc = (cls.token_accuracy(pred, y[:m]) if hasattr(cls, "token_accuracy")
           else None)
    if save_to is not None:
        model.save_model(save_to)
    summary = {
        "model": cls.__name__, "config": base, "seq": seq, "batch": batch,
        "steps": steps, "losses": losses, "fit_s": fit_s,
        "timed_epoch_s": timed, "steps_per_s": sps,
        "samples_per_s": sps * batch, "tokens_per_s": sps * batch * seq,
        "real_tokens_per_s": real / timed, "real_token_share": real / (n * seq),
        "dense_params": p_dense, "mfu_bf16": mfu,
        "peak_mem_gib": peak / 2 ** 30 if cuda else None,
        "eval_loss": ev["loss"], "token_accuracy": acc,
        "launches": {k: {"all": a, "masked": mk, "small_d": sd}
                     for k, (a, mk, sd) in launches.items()},
        "grad_rel_err": {tag.strip() or "batch": dict(
            rels[tag], f32_flash_vs_einsum=rel32[tag]) for tag in rels},
        "loss_flash_vs_einsum": {tag.strip() or "batch": dlosses[tag]
                                 for tag in dlosses},
        "planted_fault_rel_err": planted,
        "device": torch.cuda.get_device_name(0) if cuda else device}
    print(f"{label}: " + json.dumps(summary), flush=True)
    if profile:
        profile_train_step(torch, est, xb, yb)
    return launches


def squad_learn(torch, device="cuda", base=SQUAD_BASE, seq=TRAIN_SEQ,
                batch=TRAIN_BATCH, steps_per_epoch=TRAIN_STEPS,
                profile=False):
    """BERT-base BERTSQuAD on random ids and spans, no mask; planted
    faults: dQ zeroed, dK and dV swapped."""
    from analytics_zoo_tpu_torch.models.text.bert_squad import (
        BERTSQuAD, squad_span_loss)

    rng = np.random.RandomState(0)
    n = batch * steps_per_epoch
    x = {"input_ids": rng.randint(0, base["vocab"], (n, seq)
                                  ).astype(np.int32)}
    y = np.stack([rng.randint(0, seq, n), rng.randint(0, seq, n)],
                 axis=1).astype(np.int32)
    return learn_phase(torch, BERTSQuAD, base, x, y, batch, squad_span_loss,
                       GRAD_PARAMS, ("dq_zeroed", "dk_dv_swapped"),
                       device=device, profile=profile)


# MiniLM-L12-H384 (Wang et al. 2020, MiniLM: Deep Self-Attention
# Distillation; microsoft/MiniLM-L12-H384-uncased config.json): vocab
# 30522, hidden 384, 12 layers, 12 heads of 32, intermediate 1536, 512
# positions, in the repo's BERTSQuAD (bf16 encoder, f32 parameters and
# head, hidden dropout 0.1), seeded weights. Nothing is cut; batch 48 at
# seq 384 as the BERT-base fine-tune. Its head dim of 32 takes K5b both
# ways. The traffic is synthetic: real lengths uniform in [64, 384] (SQuAD
# contexts are padded to 384), spans inside the real part
MINILM = dict(vocab=30522, hidden_size=384, n_block=12, n_head=12,
              intermediate_size=1536, max_position_len=512,
              dtype="bfloat16")


def minilm_learn(torch, device="cuda", base=MINILM, seq=TRAIN_SEQ,
                 batch=TRAIN_BATCH, steps_per_epoch=TRAIN_STEPS,
                 profile=False):
    """BERTSQuAD at MiniLM-L12-H384's widths on padded batches, the
    gradient checks with the mask and without; planted faults: dQ
    zeroed, dK and dV swapped, the mask dropped from K2 and K3. Every
    K1, K2 and K3 launch of the fit must be a K5b one."""
    from analytics_zoo_tpu_torch.models.text.bert_squad import (
        BERTSQuAD, squad_span_loss)

    rng = np.random.RandomState(6)
    n = batch * steps_per_epoch
    mask = padding_mask(rng, n, seq, 64)
    lens = mask.sum(1)
    ids = rng.randint(1, base["vocab"], (n, seq)).astype(np.int32) * mask
    start = rng.randint(0, lens)
    end = np.minimum(start + rng.randint(0, 30, n), lens - 1)
    y = np.stack([start, end], axis=1).astype(np.int32)
    launches = learn_phase(
        torch, BERTSQuAD, base, {"input_ids": ids, "attention_mask": mask},
        y, batch, squad_span_loss, GRAD_PARAMS,
        ("dq_zeroed", "dk_dv_swapped", "mask_dropped"), masked=True,
        label="learn-minilm", device=device, profile=profile)
    for kname, (total, _, small) in launches.items():
        if device == "cuda" and small != total:
            fail(f"learn-minilm: {kname} counted {small} K5b launches of "
                 f"{total}")
    return launches


# BERT-base NER (Devlin et al. 2019, section 5.3, CoNLL-2003): the
# bert-base-cased configuration (vocab 28996), 9 BIO tags, sequences of
# 128 tokens, bf16 encoder, f32 head. Nothing is cut. The traffic is
# synthetic: real lengths uniform in [2, 128], about half the positions
# real. CoNLL-2003's published train split (14,041 sentences, 203,621
# tokens, 14.5 words a sentence) would leave far fewer real at 128
NER_BASE = dict(num_classes=9, vocab=28996, hidden_size=768, n_block=12,
                n_head=12, intermediate_size=3072, max_position_len=512,
                dtype="bfloat16")
NER_SEQ, NER_BATCH, NER_STEPS = 128, 32, 16
NER_GRAD_PARAMS = ("bert.encoder_0.attention.qkv.weight", "head.weight")


def ner_data(rng, n, seq, vocab, n_tags):
    """Synthetic NER traffic: random token ids with per-row real lengths
    uniform in [2, seq] (the first row full, the second of 2), their
    attention mask, and tags in [0, n_tags) on real tokens, -1
    (IGNORE_INDEX) on padding."""
    mask = padding_mask(rng, n, seq, 2)
    ids = rng.randint(1, vocab, (n, seq)).astype(np.int32) * mask
    tags = np.where(mask == 1, rng.randint(0, n_tags, (n, seq)), -1)
    return {"input_ids": ids, "attention_mask": mask}, tags.astype(np.int32)


def ner_learn(torch, save_to, device="cuda", base=NER_BASE, seq=NER_SEQ,
              batch=NER_BATCH, steps_per_epoch=NER_STEPS, profile=False):
    """BERT-base BERTNER on padded batches; planted fault: the mask
    dropped from K2 and K3. Saves the fitted model to ``save_to``."""
    from analytics_zoo_tpu_torch.models.text.bert_estimators import (
        BERTNER, token_cross_entropy)

    rng = np.random.RandomState(3)
    x, y = ner_data(rng, batch * steps_per_epoch, seq, base["vocab"],
                    base["num_classes"])
    return learn_phase(torch, BERTNER, base, x, y, batch,
                       token_cross_entropy, NER_GRAD_PARAMS,
                       ("mask_dropped",), masked=True, label="learn-ner",
                       save_to=save_to, device=device, profile=profile)


def ner_serving(torch, path, device="cuda", n_requests=64, seq=NER_SEQ,
                batch=8, base=NER_BASE):
    """The saved NER model through InferenceModel -> ServingWorker on the
    memory queue with ``_ner_input``, every bucket warmed with a padded
    example, then ``n_requests`` padded requests."""
    from analytics_zoo_tpu_torch.inference.inference_model import (
        InferenceModel, bucket_ladder)
    from analytics_zoo_tpu_torch.serving.queues import (
        InputQueue, OutputQueue)
    from analytics_zoo_tpu_torch.serving.worker import ServingWorker

    rng = np.random.RandomState(4)
    x, _ = ner_data(rng, n_requests, seq, base["vocab"], base["num_classes"])
    reqs = {f"ner{i:03d}": {k: a[i] for k, a in x.items()}
            for i in range(n_requests)}

    def start():
        model = InferenceModel(device=device).load_zoo(path)
        in_q = InputQueue(backend="memory")
        out_q = OutputQueue(backend="memory")
        worker = ServingWorker(model, in_q, out_q, batch_size=batch,
                               input_fn=_ner_input)
        cap = getattr(worker.batcher, "max_batch_size",
                      worker.batcher.batch_size)
        # a padded example (the second request: 2 real tokens)
        model.warm_up({k: a[1:2] for k, a in x.items()},
                      batch_sizes=bucket_ladder(cap))
        worker.start()
        print(f"serve-ner: warmed buckets {bucket_ladder(cap)}", flush=True)
        return in_q, out_q, model, worker.batcher, worker.stop

    return serving_phase(torch, start, reqs, _ner_input,
                         (seq, base["num_classes"]), base["n_block"],
                         masked=True, label="serve-ner", device=device)


# TinyGenLM geometries served through launch() with a generation: block.
# "repo": the launcher's documented default (scripts/perf_generation.py's
# model, GEN_r01.json's traffic shape). "full": Phi-2's published widths
# (microsoft/phi-2 config.json: hidden 2560, 32 heads of 80, 32 layers,
# intermediate 10240, vocab 51200, 2048 positions) in TinyGenLM's own
# block (pre-LN, learned positions, ReLU, no biases), f32, seeded weights
GEN_REPO = {"model": dict(vocab=64, dim=32, heads=2, head_dim=16, layers=2,
                          max_len=256, mlp_ratio=2, seed=0),
            "slots": 8, "page_size": 16, "max_len": 256}
GEN_FULL = {"model": dict(vocab=51200, dim=2560, heads=32, head_dim=80,
                          layers=32, max_len=2048, mlp_ratio=4, seed=0),
            "slots": 8, "page_size": 16, "max_len": 2048}
# a full-width divergence from the reference at a top-1 - top-2 logit gap
# below this is an f32 tie (the logits spread about 50)
TIE_GAP = 1e-3


def _hist(name):
    """{label value: (count, sum)} of a registry histogram's series."""
    from analytics_zoo_tpu_torch.obs.metrics import get_registry

    values = get_registry().snapshot(with_buckets=False)[name]["values"]
    return {label.partition("=")[2]: (v["count"], v["sum"])
            for label, v in values.items()}


def _gen_reference_check(torch, engine, prompts, streams, n_check,
                         n_tokens, tie_gap, label):
    """Streams against the port's cache-free ``reference_generate`` (the
    first ``n_tokens`` of the first ``n_check`` requests). A divergence
    prints the reference's top-1 - top-2 logit gap at that step; with
    ``tie_gap`` a gap below it is reported as an f32 tie and that
    stream's comparison stops there; any other divergence fails.
    Returns (tokens compared, ties)."""
    model, params = engine.model, engine.params
    compared, ties = 0, []
    for uri in sorted(prompts)[:n_check]:
        ref = [int(t) for t in model.reference_generate(
            params, prompts[uri], n_tokens)]
        got = streams[uri]["toks"][:n_tokens]
        i = next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b),
                 None)
        compared += len(got) if i is None else i
        if i is None:
            continue
        with torch.inference_mode():
            prefix = np.concatenate([prompts[uri], ref[:i]]).astype(np.int64)
            logits, _, _ = model.prefill(params, torch.as_tensor(
                prefix[None], device=engine.device))
            top = torch.topk(logits[0, -1].float(), 2).values
            gap = float(top[0] - top[1])
        print(f"{label}: {uri} diverges from the reference at token {i} "
              f"(served {got[i]}, reference {ref[i]}); the reference's "
              f"top-1 - top-2 logit gap there is {gap:.3g}", flush=True)
        if tie_gap is None or not gap < tie_gap:
            fail(f"{label}: {uri} is not token-exact against "
                 f"reference_generate (gap {gap} at token {i})")
        ties.append({"uri": uri, "token": i, "gap": gap})
    return compared, ties


def generation_phase(torch, label, block, n_requests, prompt_lens,
                     max_tokens, n_check, check_tokens, tie_gap=None,
                     seed=0):
    """``n_requests`` synthetic generate requests (prompt lengths uniform
    in ``prompt_lens``, tokens uniform over the vocabulary,
    ``__max_tokens__`` ``max_tokens``) through the port's launch() with
    ``block`` as its generation: block -> GenerationWorker ->
    DecodeEngine -> PagedKVCache -> TinyGenLM, at most ``slots`` streams
    outstanding (a bounded admission window, as
    scripts/perf_generation.py drives the JAX package). Checks that
    every stream gets contiguous chunks and one terminal chunk with
    in-range tokens, that K5b launched once a layer for every prefill in
    a bucket of 128 tokens or more (warm-up included), and the streams
    against reference_generate. Then profiles the decode step with all
    slots live at the longest prompts. Returns the summary."""
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.serving.generation import prefill_ladder
    from analytics_zoo_tpu_torch.serving.launcher import launch

    get_config().set("zoo.ops.attention_impl", "flash")
    m = block["model"]
    slots, layers = block["slots"], m["layers"]
    rng = np.random.RandomState(seed)
    prompts = {f"{label}{i:03d}": rng.randint(
        0, m["vocab"], rng.randint(prompt_lens[0], prompt_lens[1] + 1)
    ).astype(np.int32) for i in range(n_requests)}
    ladder = prefill_ladder(block["page_size"], block["max_len"])
    bucket = {u: next(b for b in ladder if b >= len(p))
              for u, p in prompts.items()}
    want_k5b = layers * (sum(b >= 128 for b in ladder)
                         + sum(b >= 128 for b in bucket.values()))
    prefill0, step0 = (_hist("zoo_generation_prefill_duration_seconds"),
                       _hist("zoo_generation_decode_step_duration_seconds"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(fa)
    # ---- main path: launch() -> GenerationWorker -> DecodeEngine ->
    # PagedKVCache -> TinyGenLM (prefill through K5b) ----
    t0 = time.perf_counter()
    app = launch({"generation": block, "http": {"enabled": False}})
    up_s = time.perf_counter() - t0
    print(f"{label}: up in {up_s:.1f}s (seeded weights, warm-up of "
          f"buckets {ladder})", flush=True)
    try:
        engine = app.gen_worker.engine
        streams = {u: {"toks": [], "seqs": [], "t": [], "terminal": 0}
                   for u in prompts}
        order, sent, finished = sorted(prompts), {}, 0
        t_start = time.perf_counter()
        deadline = t_start + 900
        while finished < n_requests:
            while len(sent) < n_requests and len(sent) - finished < slots:
                uri = order[len(sent)]
                sent[uri] = time.perf_counter()
                if not app.gen_input_queue.enqueue_generation(
                        uri, prompts[uri], max_tokens=max_tokens):
                    fail(f"{label}: enqueue refused {uri}")
            item = app.output_queue.dequeue(timeout=1.0)
            if time.perf_counter() > deadline:
                fail(f"{label}: {finished}/{n_requests} streams finished "
                     "in 900 s")
            if item is None:
                continue
            now = time.perf_counter()
            uri, tensors = item
            rec = streams.get(uri)
            if rec is None:
                fail(f"{label}: a chunk for an unknown stream {uri}")
            if "__error__" in tensors:
                fail(f"{label} {uri}: error terminal "
                     f"{np.asarray(tensors['__error__'])}")
            rec["seqs"].append(int(np.asarray(tensors["__stream__"])))
            rec["t"].append(now)
            rec["toks"].extend(int(t) for t in np.asarray(
                tensors.get("token", np.zeros(0, np.int32))).reshape(-1))
            if "finish_reason" in tensors:
                rec["terminal"] += 1
                rec["reason"] = str(np.asarray(tensors["finish_reason"]))
                finished += 1
        wall = time.perf_counter() - t_start
        torch.cuda.synchronize()
        k5b = fa.flash_attention.small_d_launches
        k1 = fa.flash_attention.launches - k5b
        # ---- end of the main path ----
        peak = torch.cuda.max_memory_allocated()
        prefill1, step1 = (
            _hist("zoo_generation_prefill_duration_seconds"),
            _hist("zoo_generation_decode_step_duration_seconds"))
        if not app.drain(deadline_ms=60000):
            fail(f"{label}: the generation worker did not drain")
        time.sleep(0.2)
        extra = app.output_queue.dequeue(timeout=0.5)
        if extra is not None:
            fail(f"{label}: a chunk after every stream ended: {extra[0]}")
        for uri, rec in streams.items():
            if rec["terminal"] != 1 or rec["reason"] != "length":
                fail(f"{label} {uri}: {rec['terminal']} terminal chunks "
                     f"({rec.get('reason')})")
            if rec["seqs"] != list(range(len(rec["seqs"]))):
                fail(f"{label} {uri}: chunk numbers {rec['seqs']}")
            if len(rec["toks"]) != max_tokens or not all(
                    0 <= t < m["vocab"] for t in rec["toks"]):
                fail(f"{label} {uri}: tokens {rec['toks']}")
        if k5b != want_k5b or k1:
            fail(f"{label}: K5b launched {k5b} times (want {layers} layers "
                 f"x {want_k5b // layers} prefills in buckets >= 128, "
                 f"warm-up included), K1 {k1}")
        compared, ties = _gen_reference_check(
            torch, engine, prompts, streams, n_check, check_tokens, tie_gap,
            label)
        print(f"{label}: {compared} tokens of {min(n_check, n_requests)} "
              f"streams token-exact against reference_generate"
              + (f", {len(ties)} f32 ties" if ties else ""), flush=True)
        step_wall, step_device, gather_share = _profile_decode(
            torch, engine, prompts, label)
    finally:
        app.stop()
    ttft = [(r["t"][0] - sent[u]) * 1e3 for u, r in streams.items()]
    gaps = [g * 1e3 for r in streams.values() for g in np.diff(r["t"])]
    by_bucket = {}
    for key, (count, total) in prefill1.items():
        c0, s0 = prefill0.get(key, (0, 0.0))
        if count > c0:
            by_bucket[key] = {"prefills": count - c0,
                              "mean_ms": (total - s0) / (count - c0) * 1e3}
    steps = step1[""][0] - step0.get("", (0, 0.0))[0]
    summary = {
        "requests": n_requests, "prompt_lens": list(prompt_lens),
        "max_tokens": max_tokens, "slots": slots, "layers": layers,
        "traffic": "synthetic", "up_s": up_s, "wall_s": wall,
        "tokens": n_requests * max_tokens,
        "tokens_per_s": n_requests * max_tokens / wall,
        "ttft_ms": {"p50": float(np.percentile(ttft, 50)),
                    "p99": float(np.percentile(ttft, 99))},
        "inter_token_ms": {"p50": float(np.percentile(gaps, 50)),
                           "p99": float(np.percentile(gaps, 99))},
        "decode_steps": steps,
        "decode_step_wall_ms": (step1[""][1] - step0.get("", (0, 0.0))[1])
        / max(steps, 1) * 1e3,
        "decode_step_full_wall_ms": step_wall,
        "decode_step_full_device_ms": step_device,
        "decode_gather_share": gather_share,
        "prefill_ms_by_bucket": by_bucket,
        "k5b_launches": k5b, "k5b_launches_wanted": want_k5b,
        "exact_tokens_compared": compared, "f32_ties": ties,
        "kv_pool_bytes": engine.cache.stats()["bytes"],
        "peak_mem_gib": peak / 2 ** 30,
        "device": torch.cuda.get_device_name(0)}
    print(f"{label}: " + json.dumps(summary), flush=True)
    return summary


def _profile_decode(torch, engine, prompts, label, iters=5):
    """The decode step with every slot live (the longest prompts, a
    budget that outlasts the window): host wall per step, device time by
    kernel (torch.profiler), and the share of device time in the index
    kernels that gather each slot's whole context from the pool."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    longest = sorted(prompts.values(), key=len)[-engine.num_slots:]
    budget = 2 * iters + 4
    slots = [engine.admit(p[:engine.max_len - budget], budget)[0]
             for p in longest]
    try:
        engine.step()
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.step()
        wall = (time.perf_counter() - t0) / iters
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                engine.step()
    finally:
        for s in slots:
            engine.release(s)
    _print_rows(prof, iters, wall, f"{label} decode step, "
                f"{engine.num_slots} live slots")
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(t for _, t in rows)
    gather = sum(t for k, t in rows if "index" in k or "gather" in k)
    return wall * 1e3, busy / (iters * 1e3), gather / max(busy, 1e-9)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one served batch (flash and "
                         "einsum attention), one SQuAD, one NER and one "
                         "MiniLM train step")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a GPU")
    if not os.path.isdir(os.path.join(REPO, "analytics_zoo_tpu_torch")):
        fail("analytics_zoo_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["pcie" if "PCIe" in name else "sxm"]
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    fa.build_kernels()
    print(f"build: {time.perf_counter() - t0:.2f}s "
          f"({fa.build_info['path']})", flush=True)
    for line in ptxas_lines(fa.build_info["log"]):
        print(f"  ptxas: {line}", flush=True)

    def timed(name, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"phase {name}: {time.perf_counter() - t:.1f}s", flush=True)
        return out

    served = timed("kernels", kernel_phase, torch, peaks)
    trained = _pick(timed("backward", backward_phase, torch, peaks,
                          BACKWARD_CASES, 1, "backward"), "trained")
    ner = _pick(timed("masked kernels", backward_phase, torch, peaks,
                      MASKED_CASES, 2, "masked"), "ner_trained")
    runs = [timed("serving", bert_serving, torch, profile=args.profile)]
    squad = timed("learn", squad_learn, torch, profile=args.profile)
    with tempfile.TemporaryDirectory() as ner_dir:
        ner_fit = timed("NER learn", ner_learn, torch, ner_dir,
                        profile=args.profile)
        runs.append(timed("NER serving", ner_serving, torch, ner_dir))
    runs += [squad["K1"], ner_fit["K1"]]
    k1_runs = [sum(r[i] for r in runs) for i in (0, 1)]
    torch.cuda.empty_cache()
    k5b = timed("K5b kernels", k5b_phase, torch, peaks)
    k5b_bwd = timed("K5b backward kernels", k5b_bwd_phase, torch, peaks)
    minilm = timed("MiniLM learn", minilm_learn, torch, profile=args.profile)
    torch.cuda.empty_cache()
    gens = [timed("generation, repo geometry", generation_phase, torch, "gen",
                  GEN_REPO, 500, (1, 240), 16, 500, 16),
            timed("generation, Phi-2 widths", generation_phase, torch,
                  "genfull", GEN_FULL, 32, (128, 2016), 32, 4, 16,
                  tie_gap=TIE_GAP)]
    k5b_full, k5b_masked = _pick(k5b, "gen_full", "float32"), _pick(
        k5b, "minilm_masked")
    mini, mini_padded = (_pick(k5b_bwd, "minilm_trained"),
                         _pick(k5b_bwd, "minilm_padded"))

    def at(rec, key, library_ms=None, library_device_ms=None, **extra):
        """A kernel's numbers at one timed ``backward_phase`` call (with
        its real keys, where the call is masked)."""
        out = {"shape": rec["shape"],
               **{k: rec[f"{key}_{k}"] for k in (
                   "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                   "bound_by")},
               "library_ms": library_ms,
               "library_device_ms": library_device_ms}
        if "real_keys" in rec:
            out.update(real_keys=rec["real_keys"], keys=rec["keys"])
        return dict(out, **extra)

    def lse_call(rec, **extra):
        """K1 with logsumexp at a trained call, beside SDPA's forward on
        inputs that need a gradient."""
        return at(rec, "k1_lse", rec["sdpa_fwd_ms"],
                  rec["sdpa_fwd_device_ms"],
                  max_abs_err=rec["k1_lse_out_max_abs_err"],
                  lse_max_abs_err=rec["k1_lse_max_abs_err"], **extra)

    def bwd_row(name, source, replaces, key, launches, rec, masked_rec,
                mask_replaces):
        """K2 or K3 at a trained call, with its masked call. SDPA's
        backward computes K2 + K3 + delta together, so neither row has a
        single library call of its own (its time is kept beside them)."""
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[0],
                "masked_launches": launches[1],
                "small_d_launches": launches[2], **at(rec, key),
                "library_backward_ms": rec["sdpa_bwd_ms"],
                "library_backward_device_ms": rec["sdpa_bwd_device_ms"],
                "kv_mask_call": at(
                    masked_rec, key, replaces=mask_replaces,
                    library_backward_ms=masked_rec["sdpa_bwd_ms"],
                    library_backward_device_ms=masked_rec[
                        "sdpa_bwd_device_ms"])}

    def fits(kk):
        """(launches, masked, K5b) of one kernel over the BERT-base fits."""
        return tuple(a + b for a, b in zip(squad[kk], ner_fit[kk]))

    # K1 at the served call ([32,12,512,64] bf16 views into the qkv
    # projection), with its logsumexp call at the trained shape beside
    # it; K2 and K3 at the trained call ([48,12,384,64] bf16), masked at
    # the NER trained call ([32,12,128,64], synthetic lengths in [2,
    # 128]); K5b's backward at the MiniLM trained call ([48,12,384,32]
    # bf16), masked at its padded call (lengths in [64, 384])
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": k1_runs[0],
        "masked_launches": k1_runs[1], "shape": served["shape"],
        "max_abs_err": served["max_abs_err"], "ms": served["ms"],
        "plain_ms": served["plain_ms"], "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"],
        "library_ms": served["library_ms"],
        "lse_call": lse_call(trained),
        "kv_mask_call": at(
            ner, "k1", ner["sdpa_ms"], ner["sdpa_device_ms"],
            replaces=K5A_REPLACES,
            lse_call=lse_call(ner, replaces=K5A_REPLACES))},
        bwd_row("flash_attn_bwd_dq", K2_SOURCE, K2_REPLACES, "k2",
                fits("K2"), trained, ner, K5A_REPLACES),
        bwd_row("flash_attn_bwd_dkv", K3_SOURCE, K3_REPLACES, "k3",
                fits("K3"), trained, ner, K5A_REPLACES), {
            # K5b at the full-width prefill call ([1,32,2048,80] f32,
            # causal), launched by both generation phases' prefills and
            # (with logsumexp) by the MiniLM fit
            "name": "flash_attn_fwd_k5b", "route": "cuda",
            "source": K1_SOURCE, "replaces": K5B_REPLACES,
            "launches": (sum(g["k5b_launches"] for g in gens)
                         + minilm["K1"][2]),
            **{key: k5b_full[key] for key in (
                "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms",
                "library_device_ms")},
            "lse_call": lse_call(mini),
            "kv_mask_call": {key: k5b_masked[key] for key in (
                "shape", "real_keys", "keys", "max_abs_err", "ms",
                "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms")}},
        bwd_row("flash_attn_bwd_dq_k5b", K2_SOURCE, K5B_REPLACES, "k2",
                minilm["K2"], mini, mini_padded, K5B_REPLACES),
        bwd_row("flash_attn_bwd_dkv_k5b", K3_SOURCE, K5B_REPLACES, "k3",
                minilm["K3"], mini, mini_padded, K5B_REPLACES)]}),
        flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
