#!/usr/bin/env python3
"""Compare the PyTorch port's end-to-end figures of two checkouts on one
GPU, in turns.

    python3 scripts/compare_port_commits.py PARENT CHANGE [--pairs N]
        [--only LABEL,...]

PARENT and CHANGE are checkouts of the repository (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Runs alternate parent, change, change, parent,
parent, change, ... (``--pairs`` pairs, 3 by default), each in a fresh
process that imports that checkout's own ``chip_smoke.py`` and drives
its phases whose figures swing with the host: K1, K1-lse, K2 and K3 at
the BERT-base trained call, at the GPT-J-width LM's [4,16,2048,256]
causal call, at [4,16,2048,192] and at [8,8,2048,128] causal, at the NER
trained call [32,12,128,64] with its mask and at MiniLM's
[48,12,384,32] without and with a mask, bf16 (device time), the same in
f32 at every call up to D = 128 that
chip_smoke.py times (the trained call, the NER trained call with its
mask, MiniLM's [48,12,384,32] without and with a mask, cross-length
causal [1,2,128->384,128] and [8,8,2048,128] causal) and at the f32
gradient checks' calls of the GPT-J-width LM ([1,16,2048,256] causal)
and of the 512-head LM ([1,8,2048,512] causal), the same in bf16 at the
512-head LM's trained call ([4,8,2048,512] causal, views into the qkv
projection) and at [4,8,2048,384], [4,8,2048,448] and [4,8,2048,320]
causal, K1 and K1-lse at the served shape
[32,12,512,64] and at [8,8,2048,256] causal, bf16 (device time), K1 and
K1-lse in bf16 at the calls that run K1's Hopper kernel at K5b head dims
or with a key-padding mask (the NER trained call [32,12,128,64] with its
mask, MiniLM's K1-lse [48,12,384,32] without and with a mask,
[8,32,1024,80] causal and [8,12,512,20] causal; device time), K1 and
K1-lse in bf16 at head dims 320-512 (K1 at DeepSeek-V4-Flash's
[1,64,2048,512] and at [2,32,2048,384], K1-lse at the 512-head LM's
[4,8,2048,512] as views into the qkv projection, all causal; device
time), K1 in
f32 at the served shape [8,12,512,64], at the prefills of the f32
generation phases (Phi-2's [1,32,2048,80], the repo geometry's
[1,2,256,16], Gemma-2B's [1,8,8192,256] with its K1-lse at
[1,8,2048,256]), at DeepSeek-V4-Flash's [1,64,2048,512], the 512-head
LM's f32 gradient check's K1-lse [1,8,2048,512] and [2,32,2048,384]
causal (device time),
BERT-base serving (with the seconds its save and its start-up take), the
NER fine-tune, NER serving (start-up seconds too), the MiniLM fine-tune
(its steps/s, and one profiled train step's wall and device-busy ms) and
TinyGenLM generation at the repo geometry, and one profiled train step
of the 512-head LM (``chip_smoke.LM512``, 4 x 2048 tokens: its wall and
device-busy ms). ``--only`` keeps the phases named (a BACKWARD label,
``fwd``, ``serving``, ``ner``, ``minilm``, ``gen``, ``lm512``). Each
checkout builds its
kernels into its own ``build/``. Prints one JSON line a run, then the ptxas registers
and spills of every kernel instantiation both checkouts build that
differ between them (none: the line says so), those only the parent
builds ("retired") and those only the change builds ("new"), each with
its registers, and last each metric's runs and median per side. Needs
one card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np

# (summary-line label, key in its JSON, metric name)
SUMMARIES = (
    ("serving", "rps", "serving_rps"),
    ("serving", "p50_ms", "serving_p50_ms"),
    ("learn-ner", "steps_per_s", "ner_fit_steps_per_s"),
    ("serve-ner", "rps", "ner_serving_rps"),
    ("learn-minilm", "steps_per_s", "minilm_fit_steps_per_s"),
    ("gen", "tokens_per_s", "gen_tokens_per_s"),
)
KERNELS = ("k1", "k1_lse", "k2", "k3")


def _ner_mask(rng, b, lk):
    """The NER trained call's mask (chip_smoke.py's MASKED_CASES), made by
    the checkout's own chip_smoke.py."""
    return sys.modules["chip_smoke"].padding_mask(rng, b, lk, 2,
                                                  left_rows=(2,))


def _squad_mask(rng, b, lk):
    """Real lengths uniform in [64, Lk] (the padded fine-tunes' traffic)."""
    return sys.modules["chip_smoke"].padding_mask(rng, b, lk, 64)


# (backward_phase label, case, metric prefix): the BERT-base trained
# call, the LM's call (D = 256), causal calls at D = 192 and 128, the NER
# trained call (masked) and MiniLM's trained call (D = 32) without and
# with a mask, bf16; then every f32 call up to D = 128 that chip_smoke.py
# times: the trained call, the NER trained call (masked), MiniLM's trained
# call (D = 32) without and with a mask, cross-length causal and
# [8,8,2048,128] causal; and the f32 gradient checks' calls above 128,
# the GPT-J-width LM's (D = 256) and the 512-head LM's (D = 512); then
# bf16 above 256: the 512-head LM's trained call and D = 384, 448 and 320
BACKWARD = (
    ("backward", ("trained", (48, 12, 384, 384, 64), "bfloat16", False, None,
                  True), ""),
    ("d256-bwd", ("gptj_trained", (4, 16, 2048, 2048, 256), "bfloat16",
                  True, None, True), "lm_"),
    ("d192-bwd", ("bf16_d192", (4, 16, 2048, 2048, 192), "bfloat16", True,
                  None, True), "d192_"),
    ("d128-bwd", ("bf16_d128", (8, 8, 2048, 2048, 128), "bfloat16", True,
                  None, True), "d128_"),
    ("ner-bwd", ("ner_trained", (32, 12, 128, 128, 64), "bfloat16", False,
                 _ner_mask, True), "ner_bwd_"),
    ("minilm-bwd", ("minilm_trained", (48, 12, 384, 384, 32), "bfloat16",
                    False, None, True), "minilm_bwd_"),
    ("minilm-masked-bwd", ("minilm_padded", (48, 12, 384, 384, 32),
                           "bfloat16", False, _squad_mask, True),
     "minilm_masked_bwd_"),
    ("f32-bwd", ("trained", (48, 12, 384, 384, 64), "float32", False, None,
                 True), "f32_"),
    ("f32-ner-bwd", ("ner_trained", (32, 12, 128, 128, 64), "float32",
                     False, _ner_mask, True), "f32_ner_"),
    ("f32-minilm-bwd", ("minilm_trained", (48, 12, 384, 384, 32),
                        "float32", False, None, True), "f32_minilm_"),
    ("f32-minilm-masked-bwd", ("minilm_padded", (48, 12, 384, 384, 32),
                               "float32", False, _squad_mask, True),
     "f32_minilm_masked_"),
    ("f32-cross-bwd", ("cross_causal", (1, 2, 128, 384, 128), "float32",
                       True, None, True), "f32_cross_"),
    ("f32-d128-bwd", ("f32_d128", (8, 8, 2048, 2048, 128), "float32", True,
                      None, True), "f32_d128_"),
    ("f32-d256-bwd", ("gptj_f32", (1, 16, 2048, 2048, 256), "float32", True,
                      None, True), "f32_d256_"),
    ("f32-d512-bwd", ("lm512_f32", (1, 8, 2048, 2048, 512), "float32", True,
                      None, True), "f32_d512_"),
    ("d512-bwd", ("lm512_trained", (4, 8, 2048, 2048, 512), "bfloat16",
                  True, None, True), "lm512_"),
    ("d384-bwd", ("bf16_d384", (4, 8, 2048, 2048, 384), "bfloat16", True,
                  None, True), "d384_"),
    ("d448-bwd", ("bf16_d448", (4, 8, 2048, 2048, 448), "bfloat16", True,
                  None, True), "d448_"),
    ("d320-bwd", ("bf16_d320", (4, 8, 2048, 2048, 320), "bfloat16", True,
                  None, True), "d320_"),
)
# K1 and K1-lse timed through chip_smoke.timed_fwd_cases: the served
# shape and the widest head dim the backward also takes, bf16; the bf16
# calls at K5b head dims and with a mask (the NER trained call, MiniLM's
# K1-lse unmasked and padded, [8,32,1024,80] causal and the padded head
# dim 20), bf16 above 256 (K1 at [1,64,2048,512] and [2,32,2048,384],
# the 512-head LM's K1-lse as views into its qkv projection); then f32
# (the K1 f32 calls of BACKWARD aside): the served shape, the f32
# generation phases' prefills at their widths and top buckets (with the
# Gemma width's K1-lse at its 2048 bucket), K1 at D = 512 (the
# DeepSeek-width prefill), K1-lse at D = 512 (the 512-head LM's f32
# gradient check) and K1 at D = 384
FWD_CASES = (
    ("served_k1", (32, 12, 512, 512, 64), "bfloat16", False, None, False),
    ("served_k1_lse", (32, 12, 512, 512, 64), "bfloat16", False, None, True),
    ("d256_k1", (8, 8, 2048, 2048, 256), "bfloat16", True, None, False),
    ("d256_k1_lse", (8, 8, 2048, 2048, 256), "bfloat16", True, None, True),
    ("ner_k1", (32, 12, 128, 128, 64), "bfloat16", False, _ner_mask, False),
    ("ner_k1_lse", (32, 12, 128, 128, 64), "bfloat16", False, _ner_mask,
     True),
    ("minilm_k1_lse", (48, 12, 384, 384, 32), "bfloat16", False, None,
     True),
    ("minilm_masked_k1_lse", (48, 12, 384, 384, 32), "bfloat16", False,
     _squad_mask, True),
    ("k5b_d80_k1", (8, 32, 1024, 1024, 80), "bfloat16", True, None, False),
    ("padded_d20_k1", (8, 12, 512, 512, 20), "bfloat16", True, None, False),
    ("d512_k1", (1, 64, 2048, 2048, 512), "bfloat16", True, None, False),
    ("lm512_k1_lse", (4, 8, 2048, 2048, 512), "bfloat16", True, None, True),
    ("d384_k1", (2, 32, 2048, 2048, 384), "bfloat16", True, None, False),
    ("f32_served_k1", (8, 12, 512, 512, 64), "float32", False, None, False),
    ("f32_phi2_k1", (1, 32, 2048, 2048, 80), "float32", True, None, False),
    ("f32_repo_k1", (1, 2, 256, 256, 16), "float32", True, None, False),
    ("f32_gemma_k1", (1, 8, 8192, 8192, 256), "float32", True, None,
     False),
    ("f32_gemma_k1_lse", (1, 8, 2048, 2048, 256), "float32", True, None,
     True),
    ("f32_d512_k1", (1, 64, 2048, 2048, 512), "float32", True, None, False),
    ("f32_d512_k1_lse", (1, 8, 2048, 2048, 512), "float32", True, None,
     True),
    ("f32_d384_k1", (2, 32, 2048, 2048, 384), "float32", True, None, False),
)
FWD_VIEWS = ("lm512_k1_lse",)
# (line pattern, metric name): seconds the phases print as they go
SECONDS = (
    (r"^serving: BERT-base saved in ([0-9.]+)s", "bert_save_s"),
    (r"^serving: up in ([0-9.]+)s", "serving_up_s"),
    (r"^serve-ner: up in ([0-9.]+)s", "ner_serving_up_s"),
    (r"^profile: train step \(48,\) wall ([0-9.]+) ms", "minilm_step_wall_ms"),
    (r"^profile: train step \(48,\) wall [0-9.]+ ms; device busy ([0-9.]+) ms",
     "minilm_step_busy_ms"),
    (r"^profile: train step \(4,\) wall ([0-9.]+) ms", "lm512_step_wall_ms"),
    (r"^profile: train step \(4,\) wall [0-9.]+ ms; device busy ([0-9.]+) ms",
     "lm512_step_busy_ms"),
)
PHASES = tuple(label for label, _, _ in BACKWARD) + (
    "fwd", "serving", "ner", "minilm", "gen", "lm512")


def lm512_step(torch, cs) -> None:
    """One profiled train step of the 512-head LM (``cs.causal_lm`` at
    ``cs.LM512``, weights drawn on the card from seed 0, Adam), as
    ``chip_smoke.py --profile`` profiles its fit's."""
    from analytics_zoo_tpu_torch.common.config import get_config
    from analytics_zoo_tpu_torch.keras.layers.transformer import (
        reset_parameters)
    from analytics_zoo_tpu_torch.learn.estimator import Estimator
    from analytics_zoo_tpu_torch.learn.optim import Adam

    get_config().set("zoo.ops.attention_impl", "flash")
    base, batch = cs.LM512, cs.LM_BATCH
    x, y = cs.lm_data(np.random.RandomState(9), batch, base["seq_len"],
                      base["vocab"])
    with torch.device("cuda"):
        module = cs.causal_lm(torch, base)
    reset_parameters(module, 0)
    est = Estimator(module, loss="sparse_categorical_crossentropy",
                    optimizer=Adam(lr=1e-4), seed=0, device="cuda")
    est._ensure_built()  # the optimizer state fit would make first
    cs.profile_train_step(torch, est, torch.from_numpy(x).cuda(),
                          torch.from_numpy(y).cuda())


def run_phases(checkout: str, only) -> None:
    """The phases of ``checkout``'s chip_smoke.py named in ``only``, in
    this process."""
    import tempfile

    os.chdir(checkout)
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke as cs
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    fa.build_kernels()
    # registers and spills, where this process compiled the kernels
    for line in cs.ptxas_lines(fa.build_info["log"]):
        print(f"ptxas: {line}", flush=True)
    for label, case, _ in BACKWARD:
        if label in only:
            cs.backward_phase(torch, cs.PEAKS["sxm"], [case], 1, label)
    if "fwd" in only:
        fwd = cs.timed_fwd_cases(torch, cs.PEAKS["sxm"],
                                 np.random.RandomState(0), list(FWD_CASES),
                                 "launches", "fwd", iters=20,
                                 views=FWD_VIEWS)
        print(json.dumps({"fwd_checks": fwd}), flush=True)
    if "serving" in only:
        cs.bert_serving(torch)
    if "ner" in only:
        with tempfile.TemporaryDirectory() as ner_dir:
            cs.ner_learn(torch, ner_dir)
            cs.ner_serving(torch, ner_dir)
    if "minilm" in only:
        cs.minilm_learn(torch, profile=True)
    if "gen" in only:
        cs.generation_phase(torch, "gen", cs.GEN_REPO, 500, (1, 240), 16,
                            500, 16)
    if "lm512" in only:
        torch.cuda.empty_cache()
        lm512_step(torch, cs)


def registers(out: str) -> dict:
    """{"kernel template mask=m D": registers, and spills if any} from the
    ``ptxas:`` lines of one run (empty where the run found its kernels
    built)."""
    got = {}
    for line in out.splitlines():
        if line.startswith("ptxas: "):
            kernel, _, dims = line[len("ptxas: "):].partition(": ")
            for m in re.finditer(r"(\d+):(\d+(?: \(spill \d+/\d+\))?)",
                                 dims):
                got[f"{kernel} {m.group(1)}"] = m.group(2)
    return got


def figures(out: str) -> dict:
    """The metrics of one run from its standard output."""
    got = {}
    for line in out.splitlines():
        label, _, rest = line.partition(": ")
        if rest.startswith("{"):
            for want, key, name in SUMMARIES:
                if label == want:
                    got[name] = json.loads(rest)[key]
        for label, _, prefix in BACKWARD:
            if line.startswith(f'{{"{label}_checks"'):
                rec = json.loads(line)[f"{label}_checks"][0]
                for k in KERNELS:
                    got[f"{prefix}{k}_device_ms"] = rec[f"{k}_device_ms"]
        if line.startswith('{"fwd_checks"'):
            for rec in json.loads(line)["fwd_checks"]:
                got[f"{rec['case']}_device_ms"] = rec["device_ms"]
    for pattern, name in SECONDS:
        found = re.search(pattern, out, re.M)
        if found:
            got[name] = float(found.group(1))
    return got


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", nargs="?")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all of "
                         + ", ".join(PHASES) + ")")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = args.only.split(",")
    unknown = sorted(set(only) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; choose from {list(PHASES)}")
    if args.run:
        run_phases(os.path.abspath(args.run), only)
        return
    if not (args.parent and args.change):
        ap.error("give the parent and the change checkouts")
    sides = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    order = []
    for i in range(args.pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    runs = {"parent": [], "change": []}
    regs = {"parent": {}, "change": {}}
    for n, side in enumerate(order):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", sides[side],
             "--only", args.only],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"run {n} ({side}) failed:\n{proc.stdout[-3000:]}\n"
                     f"{proc.stderr[-3000:]}")
        got = figures(proc.stdout)
        regs[side].update(registers(proc.stdout))
        card = re.search(r"^card: (.*)$", proc.stdout, re.M)
        runs[side].append(got)
        print(json.dumps({"run": n, "side": side, "checkout": sides[side],
                          "card": card and card.group(1), **got}),
              flush=True)
    common = sorted(set(regs["parent"]) & set(regs["change"]))
    moved = {k: {side: regs[side][k] for side in regs} for k in common
             if regs["parent"][k] != regs["change"][k]}
    print(json.dumps({
        "ptxas_instantiations_compared": len(common), "ptxas_differ": moved,
        "ptxas_retired": {k: regs["parent"][k] for k in sorted(
            set(regs["parent"]) - set(regs["change"]))},
        "ptxas_new": {k: regs["change"][k] for k in sorted(
            set(regs["change"]) - set(regs["parent"]))}}), flush=True)
    names = [name for _, _, name in SUMMARIES] + [
        f"{p}{k}_device_ms" for _, _, p in BACKWARD for k in KERNELS] + [
        f"{c[0]}_device_ms" for c in FWD_CASES] + [
        name for _, name in SECONDS]
    print(json.dumps({name: {side: {
        "runs": [r.get(name) for r in rs],
        "median": statistics.median(
            [r[name] for r in rs if r.get(name) is not None] or [None])}
        for side, rs in runs.items()} for name in names
        if any(r.get(name) is not None for rs in runs.values() for r in rs)}),
        flush=True)


if __name__ == "__main__":
    main()
