#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases (needs one card)
    python3 chip_smoke.py --profile  # + a profile of one served batch

Phases:
1. Build: compiles the port's CUDA sources with nvcc for sm_90a into
   build/ and prints the card, the versions and the build time.
2. Kernels: runs K1 (flash-attention forward) through its wrapper
   against its plain PyTorch version on the card -- [8,12,512,64] in
   bf16 and f32, causal and not, the served call itself (q/k/v as
   strided views into a fused [32,512,3,12,64] qkv projection, bf16;
   the adaptive batcher grows the served batches to 32), cross-length
   causal [1,2,128->384,128], and the logsumexp output at [2,4,256,64]
   -- and times the kernel, the plain version and torch's
   scaled_dot_product_attention (a yardstick only; the port never calls
   it).
3. Serving: saves a seeded BERT-base BERTClassifier (bf16), serves 64
   requests of 512 tokens through the port's launch() -> ServingWorker
   -> InferenceModel with zoo.ops.attention_impl = "flash" (every batch
   bucket the batcher can emit is warmed first), checks that
   every request is answered once with finite logits, that K1 ran for
   every encoder layer of every dispatched batch, and that 4 replies
   match the same model run with the einsum attention path.

Prints a {"kernels": [...]} line, the card's name and power limit, and
last {"ok": true, "device": {...}}. Any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
K1_SOURCE = "analytics_zoo_tpu_torch/ops/csrc/flash_attn_fwd.cu"
K1_REPLACES = "analytics_zoo_tpu/ops/pallas_attention.py:82"
# |kernel - plain| <= TOL * (1 + |plain|): f32 is exact arithmetic in
# another order; bf16 rounds P to bf16 before P.V (as the reference
# kernel does) and rounds the output (one bf16 ulp is 2^-7 relative)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LSE_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# BERT-base logits, bf16 encoder: flash vs einsum attention on the card
SERVE_TOL = 5e-2

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


def bound(b, h, lq, lk, d, elt, causal, peak_flops, bw):
    """(bound_ms, bound_by): bytes = q, k, v read once + o written once;
    flops = 4 * d per visible (query, key) pair."""
    pairs = (sum(min(lk, i + lk - lq + 1) for i in range(lq)) if causal
             else lq * lk)
    flops = 4.0 * b * h * d * pairs
    nbytes = (2 * lq + 2 * lk) * b * h * d * elt
    t_ops, t_bytes = flops / peak_flops, nbytes / bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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
            rec["bound_ms"], rec["bound_by"] = bound(
                b, h, lq, lk, d, q.element_size(), causal, peaks[kind],
                peaks["bw"])
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


BERT_BASE = dict(num_classes=2, vocab=30522, hidden_size=768, n_block=12,
                 n_head=12, intermediate_size=3072, max_position_len=512,
                 dtype="bfloat16")


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
    from torch.autograd import DeviceType

    # kernel rows only: an operator row repeats its kernels' device time.
    # The idle share is taken against the wall time measured without the
    # profiler, whose host-side cost would stretch the window
    rows = [(e.self_device_time_total / 3e3, e.count / 3, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile: batch {x.shape} predict wall {wall * 1e3:.3f} ms; "
          f"device busy {busy:.3f} ms per batch; idle share "
          f"{1 - busy / (wall * 1e3):.3f}", flush=True)
    for ms, calls, name in rows[:14]:
        print(f"profile:   {ms:9.4f} ms {100 * ms / max(busy, 1e-9):5.1f}% "
              f"x{calls:g} {name[:90]}", flush=True)


def serving_phase(torch, device="cuda", base=BERT_BASE, n_requests=64,
                  seq=512, batch=8, profile=False):
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.models.text.bert_estimators import (
        BERTClassifier)
    from analytics_zoo_tpu_torch.obs.metrics import get_registry
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.serving.launcher import launch

    cfg = get_config()
    # the auto threshold (512) is the reference's TPU figure; serve
    # through the kernel explicitly
    cfg.set("zoo.ops.attention_impl", "flash")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        BERTClassifier(device=device, seed=0, **base).save_model(tmp)
        print(f"serving: BERT-base saved in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        dispatch = get_registry().get(
            "zoo_inference_dispatch_total").labels(mode="off")
        d0 = dispatch.value
        fa.flash_attention.launches = 0
        # ---- main path: launch -> warm-up -> serve ----
        # no warm_batch_sizes: launch() warms every bucket up to the
        # batcher's growth cap, so no first use lands in the burst
        t0 = time.perf_counter()
        app = launch({
            "model": {"path": tmp},
            "params": {"batch_size": batch,
                       "warm_example": np.zeros((1, seq), np.int32)},
            "http": {"enabled": False}}, device=device)
        print(f"serving: launched in {time.perf_counter() - t0:.1f}s",
              flush=True)
        try:
            rng = np.random.RandomState(0)
            reqs = {f"req{i:03d}": rng.randint(
                0, base["vocab"], seq).astype(np.int32)
                for i in range(n_requests)}
            sent, got, lat = {}, {}, []
            t_start = time.perf_counter()
            for uri, ids in reqs.items():
                sent[uri] = time.perf_counter()
                if not app.input_queue.enqueue(uri, input_ids=ids):
                    fail(f"enqueue refused {uri}")
            deadline = time.perf_counter() + 300
            while len(got) < n_requests and time.perf_counter() < deadline:
                item = app.output_queue.dequeue(timeout=1.0)
                if item is None:
                    continue
                uri, tensors = item
                if uri in got:
                    fail(f"{uri} answered twice")
                lat.append(time.perf_counter() - sent[uri])
                got[uri] = tensors
            wall = time.perf_counter() - t_start
            launches = fa.flash_attention.launches
            dispatched = int(dispatch.value - d0)
            # ---- end of the main path ----
            batcher = app.worker.batcher.stats()
            if set(got) != set(reqs):
                fail(f"answered {len(got)}/{n_requests} requests")
            for uri, tensors in got.items():
                if "output" not in tensors:
                    fail(f"{uri}: error reply {tensors}")
                out = tensors["output"]
                if out.shape != (2,) or not np.isfinite(out).all():
                    fail(f"{uri}: bad output {out!r}")
            if launches < base["n_block"] * dispatched:
                fail(f"K1 launches {launches} < {base['n_block']} x "
                     f"{dispatched} dispatched batches")
            # reference: the same served model, einsum attention path
            check = sorted(reqs)[:4]
            cfg.set("zoo.ops.attention_impl", "einsum")
            ref = app.model.predict(np.stack([reqs[u] for u in check]))
            cfg.set("zoo.ops.attention_impl", "flash")
            served = np.stack([got[u]["output"] for u in check])
            diff = float(np.abs(served - ref).max())
            print(f"serving: flash vs einsum logits max_abs_diff={diff:.4g}"
                  f" (tol {SERVE_TOL}); logits[0]={served[0].tolist()}",
                  flush=True)
            if not diff <= SERVE_TOL:
                fail(f"served logits differ from the einsum path by {diff}")
            if profile:
                # a batch of the size the batcher served the burst in
                x = np.stack([reqs[u] for u in
                              sorted(reqs)[:batcher["max_batch_size"]]])
                for impl in ("flash", "einsum"):
                    cfg.set("zoo.ops.attention_impl", impl)
                    print(f"profile: attention_impl={impl}", flush=True)
                    profile_batch(torch, app.model, x)
                cfg.set("zoo.ops.attention_impl", "flash")
        finally:
            app.stop()
    lat_ms = np.asarray(lat) * 1e3
    summary = {
        "requests": n_requests, "seq": seq, "wall_s": wall,
        "rps": n_requests / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "dispatched_batches": dispatched, "k1_launches": launches,
        "served_batches": batcher["batches"],
        "mean_occupancy": batcher["mean_occupancy"],
        "max_batch_size": batcher["max_batch_size"],
        "device": (torch.cuda.get_device_name(0) if device == "cuda"
                   else device)}
    print("serving: " + json.dumps(summary), flush=True)
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one served batch (flash and "
                         "einsum attention) after the serving checks")
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
    for line in fa.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    served = kernel_phase(torch, peaks)
    launches = serving_phase(torch, profile=args.profile)
    # K1 at the served call: [32,12,512,64] bf16 views into the qkv
    # projection
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "shape": served["shape"],
        "max_abs_err": served["max_abs_err"], "ms": served["ms"],
        "plain_ms": served["plain_ms"], "bound_ms": served["bound_ms"],
        "bound_by": served["bound_by"],
        "library_ms": served["library_ms"]}]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
