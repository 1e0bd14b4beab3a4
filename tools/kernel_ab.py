#!/usr/bin/env python3
"""Times the port's kernels at two checkouts in turns on one card.

    git archive <parent-commit> | tar -x -C _scratch/parent
    python3 tools/kernel_ab.py _scratch/parent [phase ...]

Runs the named timing phases of ``chip_smoke.py`` (default: kernel_time,
decode_attn_time, ssd_time) from the parent checkout and from this one
in ten alternating pairs (parent, change; change, parent; ...), each run
in a fresh process. The first run of each side builds that checkout's
kernels into its own ``_build`` directory, so the parent should be a
throwaway copy; later runs load them. Two versions are compared only
inside one call on one card: cards differ in power limit and in their
neighbours. Prints one line per run, ``<side> {"<phase>/<shape>": ms}``;
then for each timing the median of each side, each side's spread
(max - min over its ten runs, as a share of its median) and the ratio
change / parent of the medians; then the card's name and power limit.
"""
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("kernel_time", "decode_attn_time", "ssd_time")
PAIRS = 10

_RUN = r"""
import json, os, sys
root, phases = sys.argv[1], sys.argv[2:]
sys.path.insert(0, root)
sys.path.insert(0, os.path.join(root, "src"))
import torch
import chip_smoke
from repro_torch.kernels import build
build.build()
dev = torch.device("cuda", 0)
out = {}
for ph in phases:
    for shape, rec in getattr(chip_smoke, "phase_" + ph)(dev).items():
        if isinstance(rec, dict) and "ms" in rec:
            out[ph + "/" + shape] = rec["ms"]
print("AB " + json.dumps(out))
"""


def summary(runs):
    """{timing: {side_median, side_spread, ratio}} over the runs of both
    sides."""
    out = {}
    for key in runs["parent"][0]:
        rec = {}
        for side in ("parent", "change"):
            ms = [r[key] for r in runs[side] if key in r]
            med = statistics.median(ms)
            rec[side + "_median_ms"] = med
            rec[side + "_spread"] = (max(ms) - min(ms)) / med
        rec["ratio"] = rec["change_median_ms"] / rec["parent_median_ms"]
        out[key] = rec
    return out


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    roots = {"parent": os.path.abspath(sys.argv[1]), "change": HERE}
    phases = sys.argv[2:] or list(PHASES)
    runs = {"parent": [], "change": []}
    for i in range(PAIRS):
        for side in (("parent", "change"), ("change", "parent"))[i % 2]:
            run = subprocess.run(
                [sys.executable, "-c", _RUN, roots[side], *phases],
                capture_output=True, text=True)
            line = [ln for ln in run.stdout.splitlines()
                    if ln.startswith("AB ")]
            if run.returncode or not line:
                print(side, "failed", run.stdout[-2000:], run.stderr[-2000:])
                sys.exit(1)
            runs[side].append(json.loads(line[0][3:]))
            print(side, line[0][3:], flush=True)
    for key, rec in summary(runs).items():
        print("SUMMARY", key, json.dumps(rec))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
