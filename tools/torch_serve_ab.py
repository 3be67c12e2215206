#!/usr/bin/env python3
"""Serving (or training) A/B of two checkouts of paddle_tpu_torch on one card.

    python3 tools/torch_serve_ab.py OTHER_CHECKOUT [--pairs N] [--batch B ...]
    python3 tools/torch_serve_ab.py OTHER_CHECKOUT --train [--pairs N]
    python3 tools/torch_serve_ab.py OTHER_CHECKOUT --lane [--pairs N]

Runs the build and serve phases of each checkout's chip_smoke.py (BERT-base
encoder served for a 5 s window per batch size) in a fresh process per
run, alternating OTHER_CHECKOUT (for example the parent commit, unpacked
with ``git archive``) and the checkout this script lives in, and flipping
which side goes first in each pair: other, this, this, other, ... Both
sides therefore share one card and one host, in turns. Prints each run's
[slice] lines prefixed with its side and number, then per batch size the
p50 latencies of each side and their medians. With --train each run is
the build and train phases instead (BERT-base pretraining at batch 32, a
100-step window), and the p50 is the step time's. With --lane each run is
``python3 -m paddle_tpu_torch.bench bert`` (bench.py's BERT-base lane: bf16,
batch 256, a window of 20 steps), and the figure is its ``step_ms``, the
window's time over its steps. Exits non-zero when CUDA is missing or a run
fails.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P50 = {"serve": re.compile(r"^\[slice\] batch\s+(\d+):.*latency p50 "
                           r"([0-9.]+) ms"),
       "train": re.compile(r"^\[train\] batch\s+(\d+):.*step p50 "
                           r"([0-9.]+) ms")}


def _run(checkout: str, batches, mode: str) -> str:
    if mode == "lane":
        cmd = [sys.executable, "-m", "paddle_tpu_torch.bench", "bert"]
        res = subprocess.run(cmd, cwd=checkout, capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"lane run in {checkout} failed:\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        return res.stdout
    phase = ("cs.phase_train()" if mode == "train" else
             f"cs.SERVE_BATCHES = {tuple(batches)!r}; cs.phase_slice()")
    code = ("import sys, torch; sys.path.insert(0, '.'); "
            "import chip_smoke as cs; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "cs.phase_build(); " + phase)
    res = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"{mode} run in {checkout} failed:\n"
                           f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return res.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout, e.g. the parent")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--batch", type=int, action="append")
    ap.add_argument("--train", action="store_true",
                    help="alternate the training phase, not serving")
    ap.add_argument("--lane", action="store_true",
                    help="alternate bench.py's bert lane, not serving")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_ab: CUDA is not available", file=sys.stderr)
        return 2
    mode = "lane" if args.lane else "train" if args.train else "serve"
    batches = {"lane": [256], "train": [32]}.get(mode,
                                                 args.batch or [1, 8, 32])
    sides = {"other": os.path.abspath(args.other), "this": HERE}
    p50 = {(s, b): [] for s in sides for b in batches}
    run = 0
    for pair in range(args.pairs):
        order = ("other", "this") if pair % 2 == 0 else ("this", "other")
        for side in order:
            run += 1
            for line in _run(sides[side], batches, mode).splitlines():
                if mode == "lane":
                    if line.startswith("{"):
                        res = json.loads(line)
                        p50[(side, batches[0])].append(res["step_ms"])
                        print(f"{side} {run} {line}", flush=True)
                    continue
                m = P50[mode].match(line)
                if m:
                    p50[(side, int(m.group(1)))].append(float(m.group(2)))
                    print(f"{side} {run} {line}", flush=True)
    for b in batches:
        o, t = p50[("other", b)], p50[("this", b)]
        what = "step_ms" if mode == "lane" else "p50 ms"
        print(f"batch {b}: {what} other {o} (median "
              f"{statistics.median(o):.3f}), this {t} (median "
              f"{statistics.median(t):.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
