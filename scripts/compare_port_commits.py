#!/usr/bin/env python3
"""Compare the PyTorch port's end-to-end figures of two checkouts on one
GPU, in turns.

    python3 scripts/compare_port_commits.py PARENT CHANGE [--pairs N]

PARENT and CHANGE are checkouts of the repository (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Runs alternate parent, change, change, parent,
parent, change, ... (``--pairs`` pairs, 3 by default), each in a fresh
process that imports that checkout's own ``chip_smoke.py`` and drives
its phases whose figures swing with the host: K1-lse, K2 and K3 at the
BERT-base trained call (device time), BERT-base serving, the NER
fine-tune, NER serving and TinyGenLM generation at the repo geometry.
Each checkout builds its kernels into its own ``build/``. Prints one
JSON line a run and, last, each metric's runs and median per side.
Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

# (summary-line label, key in its JSON, metric name)
SUMMARIES = (
    ("serving", "rps", "serving_rps"),
    ("serving", "p50_ms", "serving_p50_ms"),
    ("learn-ner", "steps_per_s", "ner_fit_steps_per_s"),
    ("serve-ner", "rps", "ner_serving_rps"),
    ("gen", "tokens_per_s", "gen_tokens_per_s"),
)
KERNELS = ("k1_lse", "k2", "k3")


def run_phases(checkout: str) -> None:
    """The phases of ``checkout``'s chip_smoke.py, in this process."""
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
    trained = [c for c in cs.BACKWARD_CASES
               if c[0] == "trained" and c[2] == "bfloat16"]
    cs.backward_phase(torch, cs.PEAKS["sxm"], trained, 1, "backward")
    cs.bert_serving(torch)
    with tempfile.TemporaryDirectory() as ner_dir:
        cs.ner_learn(torch, ner_dir)
        cs.ner_serving(torch, ner_dir)
    cs.generation_phase(torch, "gen", cs.GEN_REPO, 500, (1, 240), 16, 500,
                        16)


def figures(out: str) -> dict:
    """The metrics of one run from its standard output."""
    got = {}
    for line in out.splitlines():
        label, _, rest = line.partition(": ")
        if rest.startswith("{"):
            for want, key, name in SUMMARIES:
                if label == want:
                    got[name] = json.loads(rest)[key]
        if line.startswith('{"backward_checks"'):
            rec = json.loads(line)["backward_checks"][0]
            for k in KERNELS:
                got[f"{k}_device_ms"] = rec[f"{k}_device_ms"]
    return got


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", nargs="?")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_phases(os.path.abspath(args.run))
        return
    if not (args.parent and args.change):
        ap.error("give the parent and the change checkouts")
    sides = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    order = []
    for i in range(args.pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    runs = {"parent": [], "change": []}
    for n, side in enumerate(order):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", sides[side]],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"run {n} ({side}) failed:\n{proc.stdout[-3000:]}\n"
                     f"{proc.stderr[-3000:]}")
        got = figures(proc.stdout)
        card = re.search(r"^card: (.*)$", proc.stdout, re.M)
        runs[side].append(got)
        print(json.dumps({"run": n, "side": side, "checkout": sides[side],
                          "card": card and card.group(1), **got}),
              flush=True)
    names = [name for _, _, name in SUMMARIES] + [
        f"{k}_device_ms" for k in KERNELS]
    print(json.dumps({name: {side: {
        "runs": [r.get(name) for r in rs],
        "median": statistics.median(r[name] for r in rs if name in r)}
        for side, rs in runs.items()} for name in names}), flush=True)


if __name__ == "__main__":
    main()
