#!/usr/bin/env python3
"""Compare BERT-base serving of two checkouts on one GPU, in turns.

    python3 scripts/compare_serving.py PARENT CHANGE [--pairs N]

Runs ``chip_smoke.bert_serving`` (64 requests of 512 tokens through
``launch()``) of each checkout in a fresh process, parent, change,
change, parent, ... (``--pairs`` pairs, 8 by default), each checkout
building its kernels into its own ``build/``. Prints one JSON line a run
(requests/s, p50 and p99 ms), then each side's median and quartiles of
requests/s and median p50. Serving is bound by the host, whose spread
``scripts/compare_port_commits.py``'s three pairs cannot resolve. Needs
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

RUN = ("import os, sys, torch; sys.path.insert(0, os.getcwd()); "
       "import chip_smoke as cs; "
       "from analytics_zoo_tpu_torch.ops import flash_attention as fa; "
       "fa.build_kernels(); torch.backends.cuda.matmul.allow_tf32 = False; "
       "cs.bert_serving(torch)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=8)
    args = ap.parse_args()
    sides = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    order = []
    for i in range(args.pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    got = {"parent": [], "change": []}
    for n, side in enumerate(order):
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=sides[side],
                              capture_output=True, text=True, timeout=600)
        found = re.search(r"^serving: (\{.*\})$", proc.stdout, re.M)
        if proc.returncode != 0 or not found:
            sys.exit(f"run {n} ({side}) failed:\n{proc.stdout[-2000:]}\n"
                     f"{proc.stderr[-2000:]}")
        rec = json.loads(found.group(1))
        got[side].append(rec)
        print(json.dumps({"run": n, "side": side, **{
            k: rec[k] for k in ("rps", "p50_ms", "p99_ms")}}), flush=True)
    print(json.dumps({side: {
        "rps_median": statistics.median(r["rps"] for r in rs),
        "rps_quartiles": statistics.quantiles([r["rps"] for r in rs], n=4),
        "p50_ms_median": statistics.median(r["p50_ms"] for r in rs)}
        for side, rs in got.items()}), flush=True)


if __name__ == "__main__":
    main()
