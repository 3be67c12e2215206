#!/usr/bin/env python3
"""Variants of the f32 flash-attention kernels side by side on one card.

    python3 tools/f32_attention_ab.py [--turns N]

Builds each variant of ``csrc/flash_attention_fwd_f32.cu``,
``csrc/flash_attention_bwd_dkdv_f32.cu`` and
``csrc/flash_attention_bwd_dq_f32.cu`` from the repository's source with
its own preprocessor defines (VARIANTS; one nvcc per variant, all started
together), then, at the shapes the f32 paths run them (BERT-base at batch
8 and 32 with the key-padding bias, batch 32 with dropout 0.1 too; greedy
decode's 80 x 64 cross-attention and causal 80 x 80 self-attention, forward
only), holds every variant to the plain version at chip_smoke.py's
F32_TOL (the dQ kernel's dQ and delta) and times it beside the old route
on the same inputs (the tiled forward; the split route's dK/dV kernel;
``bwd_delta`` and the split route's dQ kernel, in one graph) in turns:
each turn runs every variant and the old route once, the order reversed
on every other turn.
A time is chip_smoke.py's ``_cuda_ms``: CUDA events around the replay of
a graph of 50 calls, device time. Prints the card's name and power limit,
each variant's ptxas registers and spills, a line a shape with each side's
times and median, and last one JSON line of the medians. Exits non-zero
when CUDA is missing or a variant disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# name -> (which kernel, extra nvcc defines)
VARIANTS = {
    "fwd persistent": ("fwd", ["-DPADDLE_F32_PERSISTENT=1"]),
    "fwd one block an item": ("fwd", ["-DPADDLE_F32_PERSISTENT=0"]),
    "dkdv persistent": ("dkdv", ["-DPADDLE_F32_PERSISTENT=1"]),
    "dkdv one block an item": ("dkdv", ["-DPADDLE_F32_PERSISTENT=0"]),
    # 128 rows an item, 64 a warpgroup, each on every key stage (the
    # source's default), persistent or not
    "dq persistent": ("dq", ["-DPADDLE_DQ_SHARED_ROWS=0",
                             "-DPADDLE_F32_PERSISTENT=1"]),
    "dq one block an item": ("dq", ["-DPADDLE_DQ_SHARED_ROWS=0",
                                    "-DPADDLE_F32_PERSISTENT=0"]),
    # 64 rows an item, both warpgroups on them, alternate 32-key stages
    "dq 64 rows, alternate stages": ("dq", ["-DPADDLE_DQ_SHARED_ROWS=1",
                                            "-DPADDLE_F32_PERSISTENT=1"]),
}
# (B, H, S, Sk, dropout, bias, causal, which kernels)
SHAPES = [(8, 12, 128, 128, 0.0, True, False, ("fwd", "dkdv", "dq")),
          (32, 12, 128, 128, 0.0, True, False, ("fwd", "dkdv", "dq")),
          (32, 12, 128, 128, 0.1, True, False, ("fwd", "dkdv", "dq")),
          (8, 16, 80, 64, 0.0, True, False, ("fwd",)),
          (8, 16, 80, 80, 0.0, False, True, ("fwd",))]


def _build(name, source, defines):
    from paddle_tpu_torch.ops.cuda import build
    out_dir = os.path.join(HERE, "build", "f32_ab")
    os.makedirs(out_dir, exist_ok=True)
    tag = hashlib.sha256(("\0".join([name, *defines]) + open(os.path.join(
        build.CSRC, source)).read()).encode()).hexdigest()[:12]
    out = os.path.join(out_dir, f"lib{tag}.so")
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, *defines,
           "-o", out, os.path.join(build.CSRC, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return out, proc.stderr


def _load(path, source):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    lib = ctypes.CDLL(path)
    for fn_name, argtypes in fa._SIGNATURES[source].items():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
    lib.paddle_cuda_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("f32_attention_ab: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    print(f"[card] {cs._card_line()}", flush=True)
    source = {"fwd": fa.FWD_F32_SOURCE, "dkdv": fa.BWD_DKDV_F32_SOURCE,
              "dq": fa.BWD_DQ_F32_SOURCE}
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda n: _build(n, source[VARIANTS[n][0]], VARIANTS[n][1]),
            VARIANTS)))
    libs = {}
    for name, (path, log) in built.items():
        libs[name] = _load(path, source[VARIANTS[name][0]])
        for kern, dt, d, regs, st, ld in cs.ptxas_report(log):
            print(f"[build] {name}: {kern} {dt} D={d}: {regs} registers, "
                  f"spill stores {st} B, spill loads {ld} B", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
    medians = []
    for bs, hh, sq, sk, rate, with_bias, causal, kinds in SHAPES:
        q, k, v = cs._qkv(bs, hh, sq, sk, 64, torch.float32, gen)
        bias = cs._padding_bias(bs, sk, gen) if with_bias else None
        fargs = (q, k, v, 0.125, causal, rate, seed, bias)
        o, lse = fa.flash_attention_reference(*fargs)
        do = torch.randn(q.shape, generator=gen, device="cuda")
        delta = fa.bwd_delta(o, do)
        tail = (0.125, causal, rate, seed, bias)
        bargs = (q, k, v, do, lse, delta, *tail)
        qargs = (q, k, v, o, lse, do, *tail)
        # each kernel: its plain version's result, its new and old routes
        want = {"fwd": (o, lse),
                "dkdv": fa.flash_attention_bwd_kv_reference(*bargs),
                "dq": fa.flash_attention_bwd_dq_f32_reference(*qargs)}
        new = {"fwd": lambda: fa.flash_attention_fwd_f32_cuda(*fargs),
               "dkdv": lambda: fa.flash_attention_bwd_dkdv_f32_cuda(*bargs),
               "dq": lambda: fa.flash_attention_bwd_dq_f32_cuda(*qargs)}

        def old_dq():
            d = fa.bwd_delta(o, do)
            return fa.flash_attention_bwd_q_cuda(q, k, v, do, lse, d,
                                                 *tail), d
        old = {"fwd": lambda: fa.flash_attention_fwd_tiled_cuda(*fargs),
               "dkdv": lambda: fa.flash_attention_bwd_kv_cuda(*bargs),
               "dq": old_dq}
        what = (f"B={bs} H={hh} S={sq} Sk={sk} D=64" +
                (" causal" if causal else "") +
                (" bias" if with_bias else "") +
                (f" dropout {rate}" if rate else ""))
        for kind in kinds:
            sides = {"old route": (old[kind], None)}
            for name, (vk, _) in VARIANTS.items():
                if vk == kind:
                    sides[name] = (new[kind], libs[name])

            def run(side):
                fn, lib = sides[side]
                if lib is not None:
                    fa._libs[source[kind]] = lib
                return fn()
            for side in sides:
                got = run(side)
                torch.cuda.synchronize()
                if not all(torch.allclose(g, w, rtol=cs.F32_TOL,
                                          atol=cs.F32_TOL)
                           for g, w in zip(got, want[kind])):
                    print(f"[ab] {kind} {what} {side}: disagrees with the "
                          "plain version", flush=True)
                    return 1
            times = {side: [] for side in sides}
            order = list(sides)
            for turn in range(args.turns):
                for side in (order if turn % 2 == 0 else order[::-1]):
                    times[side].append(cs._cuda_ms(lambda: run(side)))
            row = {"kernel": kind, "shape": what}
            for side, ts in times.items():
                row[side] = statistics.median(ts)
                print(f"[ab] {kind} {what} {side}: "
                      + " ".join(f"{x:.4f}" for x in ts)
                      + f" ms, median {row[side]:.4f}", flush=True)
            medians.append(row)
    print(json.dumps({"f32_attention_ab": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
