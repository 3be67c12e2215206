#!/usr/bin/env python3
"""Serving (or training) A/B of two checkouts of paddle_tpu_torch on one card.

    python3 tools/torch_serve_ab.py OTHER_CHECKOUT [--pairs N] [--batch B ...]
                                    [--profile]
    python3 tools/torch_serve_ab.py OTHER_CHECKOUT --train [--amp] [--pairs N]
    python3 tools/torch_serve_ab.py OTHER_CHECKOUT --lane [--pairs N]
                                    [--seq S] [--profile]
    python3 tools/torch_serve_ab.py OTHER_CHECKOUT --kernels [--pairs N]

Runs the build and serve phases of each checkout's chip_smoke.py (BERT-base
encoder served for a 5 s window per batch size) in a fresh process per
run, alternating OTHER_CHECKOUT (for example the parent commit, unpacked
with ``git archive``) and the checkout this script lives in, and flipping
which side goes first in each pair: other, this, this, other, ... Both
sides therefore share one card and one host, in turns. Prints each run's
[slice] lines prefixed with its side and number, then per batch size the
p50 latencies of each side and their medians; --profile adds each run's
torch.profiler pass over one request of each batch size (chip_smoke.py's
``_profile``: device busy time, idle share, the longest kernels). With --train each run is
the build and train phases instead (BERT-base pretraining at batch 32, a
100-step window), and the p50 is the step time's; --amp adds each run's
AMP phase after its train phase (the same step with use_amp=True, a 50-step
window) and reports both p50s. With --lane each run is
``python3 -m paddle_tpu_torch.bench bert`` (bench.py's BERT-base lane: bf16,
batch 256, a window of 20 steps), and the figure is its ``step_ms``, the
window's time over its steps; --seq S runs it at S (bench.py's
PADDLE_TPU_BENCH_SEQ) with the batch pinned at 256·128 / S
(PADDLE_TPU_BENCH_BATCH: 64 at S = 512, the tokens of a step unchanged),
and --profile adds a torch.profiler pass over one more step of each run
(chip_smoke.py's ``_profile_step``: device time by kernel name, idle
share), this checkout's chip_smoke.py driving either side's package.
With --kernels each run times, at the bench
lane's shape (batch 256, H=12, S=128, D=64, bf16, no bias), the forward
that ``flash_attention_cuda`` routes to and the fused backward
(``flash_attention_bwd_fused_cuda``), and at the f32 training step's
(batch 32, H=12, S=128, D=64, f32, key-padding bias, dropout 0.1) the
forward and the whole backward (``flash_attention_bwd_cuda``: the
kernels of the route, and bwd_delta where the route takes it) that the
checkout routes f32 to, each as
chip_smoke.py's ``_cuda_ms`` times a kernel (a CUDA graph of 50 calls,
device time). Exits non-zero
when CUDA is missing or a run fails.
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
                           r"([0-9.]+) ms"),
       "amp": re.compile(r"^\[(amp)\] BERT-base use_amp=True:.*step p50 "
                         r"([0-9.]+) ms")}
# one run of --kernels: the lane's shape, each kernel timed in a graph
KERNELS_CODE = """
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from paddle_tpu_torch.ops.cuda import flash_attention as fa
gen = torch.Generator(device='cuda').manual_seed(cs.SEED)
q, k, v = cs._qkv(cs.LANE_BATCH, 12, cs.S, cs.S, 64, torch.bfloat16, gen)
do = torch.randn(q.shape, generator=gen, device='cuda').to(torch.bfloat16)
o, lse = fa.flash_attention_cuda(q, k, v, 0.125)
fwd = cs._cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, 0.125))
bwd = cs._cuda_ms(lambda: fa.flash_attention_bwd_fused_cuda(
    q, k, v, o, lse, do, 0.125))
q, k, v = cs._qkv(cs.TRAIN_BATCH, 12, cs.S, cs.S, 64, torch.float32, gen)
do = torch.randn(q.shape, generator=gen, device='cuda')
bias = cs._padding_bias(cs.TRAIN_BATCH, cs.S, gen)
seed = torch.tensor([1234], dtype=torch.int32, device='cuda')
args = (q, k, v, 0.125, False, 0.1, seed, bias)
o, lse = fa.flash_attention_cuda(*args)
f32_fwd = cs._cuda_ms(lambda: fa.flash_attention_cuda(*args))
f32_bwd = cs._cuda_ms(lambda: fa.flash_attention_bwd_cuda(
    q, k, v, o, lse, do, 0.125, False, 0.1, seed, bias))
print('[kernels] ' + json.dumps({'forward_ms': fwd, 'bwd_fused_ms': bwd,
                                 'f32_forward_ms': f32_fwd,
                                 'f32_backward_ms': f32_bwd}))
"""


# one run of --lane --profile: the lane, then one profiled step, by this
# checkout's chip_smoke.py over the package of the checkout it runs in
LANE_PROFILE_CODE = """
import importlib.util, json, sys
sys.path.insert(0, '.')
spec = importlib.util.spec_from_file_location('chip_smoke_ab', {path!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from paddle_tpu_torch import bench
lane = bench.run_bert_base()
print(json.dumps(lane.res), flush=True)
with cs._lane_flags():
    cs._profile_step(lane.exe, lane.main, lane.fetches[0], lane.scope,
                     lane.feed, 'bert lane batch %d S %d'
                     % (lane.res['batch'], lane.res['seq_len']))
"""


def _run(checkout: str, batches, mode: str, seq=None,
         profile=False) -> str:
    if mode == "lane":
        cmd = [sys.executable, "-m", "paddle_tpu_torch.bench", "bert"]
        if profile:
            cmd = [sys.executable, "-c", LANE_PROFILE_CODE.format(
                path=os.path.join(HERE, "chip_smoke.py"))]
        env = dict(os.environ)
        if seq:
            env.update(PADDLE_TPU_BENCH_SEQ=str(seq),
                       PADDLE_TPU_BENCH_BATCH=str(batches[0]))
        res = subprocess.run(cmd, cwd=checkout, capture_output=True,
                             text=True, timeout=900, env=env)
        if res.returncode != 0:
            raise RuntimeError(f"lane run in {checkout} failed:\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        return res.stdout
    if mode == "kernels":
        code = KERNELS_CODE
    else:
        phase = ("cs.phase_train()" if mode == "train" else
                 "cs.phase_amp(cs.phase_train())" if mode == "amp" else
                 f"cs.SERVE_BATCHES = {tuple(batches)!r}; "
                 f"cs.phase_slice(profile={bool(profile)})")
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
    ap.add_argument("--amp", action="store_true",
                    help="with --train: each run's AMP phase too")
    ap.add_argument("--lane", action="store_true",
                    help="alternate bench.py's bert lane, not serving")
    ap.add_argument("--seq", type=int,
                    help="with --lane: the lane at this S, the batch "
                         "pinned at 256*128/S")
    ap.add_argument("--profile", action="store_true",
                    help="with --lane: a profiled step after each run; "
                         "serving: a profiled request of each batch size")
    ap.add_argument("--kernels", action="store_true",
                    help="alternate the flash kernels' times at the lane's "
                         "shape, not serving")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_ab: CUDA is not available", file=sys.stderr)
        return 2
    mode = ("lane" if args.lane else
            ("amp" if args.amp else "train") if args.train else
            "kernels" if args.kernels else "serve")
    batches = {"lane": [256 * 128 // (args.seq or 128)], "train": [32],
               "amp": [32, "amp"],
               "kernels": ["forward_ms", "bwd_fused_ms", "f32_forward_ms",
                           "f32_backward_ms"]}.get(
        mode, args.batch or [1, 8, 32])
    sides = {"other": os.path.abspath(args.other), "this": HERE}
    p50 = {(s, b): [] for s in sides for b in batches}
    run = 0
    for pair in range(args.pairs):
        order = ("other", "this") if pair % 2 == 0 else ("this", "other")
        for side in order:
            run += 1
            for line in _run(sides[side], batches, mode, args.seq,
                             args.profile).splitlines():
                if mode == "kernels":
                    if line.startswith("[kernels] "):
                        res = json.loads(line[len("[kernels] "):])
                        for name in batches:
                            p50[(side, name)].append(res[name])
                        print(f"{side} {run} {line}", flush=True)
                    continue
                if line.startswith("[profile]") and mode in ("lane",
                                                             "serve"):
                    print(f"{side} {run} {line}", flush=True)
                if mode == "lane":
                    if line.startswith("{"):
                        res = json.loads(line)
                        p50[(side, batches[0])].append(res["step_ms"])
                        print(f"{side} {run} {line}", flush=True)
                    continue
                for pat in ((P50["train"], P50["amp"]) if mode == "amp"
                            else (P50[mode],)):
                    m = pat.match(line)
                    if m:
                        key = m.group(1)
                        p50[(side, key if key == "amp" else int(key))] \
                            .append(float(m.group(2)))
                        print(f"{side} {run} {line}", flush=True)
    for b in batches:
        o, t = p50[("other", b)], p50[("this", b)]
        what = {"lane": "step_ms", "kernels": "ms"}.get(
            mode, "p50 ms")
        print(f"{'batch ' if mode != 'kernels' else ''}{b}: {what} other {o} (median "
              f"{statistics.median(o):.3f}), this {t} (median "
              f"{statistics.median(t):.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
