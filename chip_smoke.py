#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU: python3 chip_smoke.py

Phases, each fatal on failure:
  1. build  — compile every CUDA kernel of the served path from csrc/.
  2. kernel — hold each kernel against its plain PyTorch version on the
              card (BERT-base shapes in f32 and bf16 with a key-padding
              bias; ragged S/Sk, causal, a dead row, dropout 0.1, other
              head dims), checking O and lse; time the kernel, the plain
              version and one PyTorch library call as a yardstick.
  3. slice  — build the BERT-base encoder (12 layers, hidden 768, 12
              heads, ffn 3072, vocab 30522) with the port, initialise it
              on the card from a seed, and serve requests of batch 1, 8
              and 32 at S=128 through fluid.Executor(CUDAPlace(0)).run with
              random padding, back to back for a fixed window per batch
              size. Checks: finite outputs, exactly 12 flash launches per
              request, and one request against the same program and
              weights run by the port on the CPU. Reports latency p50/p99
              over every request of the window and sequences/s as all the
              sequences over all the time spent in Executor.run.

Output: the card's name and power limit first, results as lines of text,
then one JSON line {"kernels": [...]} and, last, the JSON result line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when
CUDA is missing or any phase fails. ``--profile`` adds a torch.profiler
pass over one request of each batch size: device time by kernel name, and
the device's idle share against the same request's unprofiled wall time.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED = 20261016
S = 128
SERVE_BATCHES = (1, 8, 32)
WINDOW_S = 5.0                # seconds served per batch size, after warm-up
WARMUP = 3                    # requests per batch size before the window
POOL = 16                     # distinct requests per batch size, cycled
F32_TOL = 1e-4                # kernel vs plain, f32: sums in other orders
BF16_TOL = 2e-2               # kernel vs plain, bf16 operands
SLICE_TOL = 1e-3              # GPU vs CPU through 12 f32 encoder layers
PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s (published)
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core f32, bf16 TC


def _log(*a):
    print(*a, flush=True)


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters=50, warmup=5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# --------------------------------------------------------------------------
# 1. build
# --------------------------------------------------------------------------
def phase_build():
    from paddle_tpu_torch.ops.cuda import build, flash_attention as fa
    t0 = time.perf_counter()
    build.load(fa.KERNEL_SOURCE)
    _log(f"[build] {fa.KERNEL_SOURCE}: {time.perf_counter() - t0:.1f} s "
         "(nvcc -gencode arch=compute_90a,code=sm_90a)")
    for line in build.build_log.get(fa.KERNEL_SOURCE, {}).get(
            "ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            _log("[build] ptxas:", line.strip())


# --------------------------------------------------------------------------
# 2. kernel
# --------------------------------------------------------------------------
def _qkv(B, H, Sq, Sk, D, dtype, gen):
    import torch
    q = torch.randn(B, H, Sq, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, H, Sk, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, H, Sk, D, generator=gen, device="cuda").to(dtype)
    return q, k, v


def _padding_bias(B, Sk, gen, neg=-1e9):
    import torch
    lens = torch.randint(Sk // 4, Sk + 1, (B,), generator=gen, device="cuda")
    keep = torch.arange(Sk, device="cuda")[None, :] < lens[:, None]
    return torch.where(keep, 0.0, neg).float()


def _check(name, got, want, tol):
    import torch
    o, lse = got
    ro, rlse = want
    err_o = (o.float() - ro.float()).abs().max().item()
    err_l = (lse - rlse).abs().max().item()
    ok = (torch.allclose(o.float(), ro.float(), rtol=tol, atol=tol)
          and torch.allclose(lse, rlse, rtol=tol, atol=tol))
    _log(f"[kernel] {name}: max|dO| {err_o:.3e} max|dlse| {err_l:.3e} "
         f"tol {tol:g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{name}")
    return max(err_o, err_l)


def phase_kernel():
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sm = 0.125
    errs = {}

    def both(q, k, v, scale, causal=False, rate=0.0, seed=None, bias=None):
        got = fa.flash_attention_cuda(q, k, v, scale, causal, rate, seed,
                                      bias)
        want = fa.flash_attention_reference(q, k, v, scale, causal, rate,
                                            seed, bias)
        torch.cuda.synchronize()
        return got, want

    # the served shape: BERT-base, batch 8, key-padding bias
    B, H, D = 8, 12, 64
    for dt, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        q, k, v = _qkv(B, H, S, S, D, dt, gen)
        bias = _padding_bias(B, S, gen)
        errs[str(dt)] = _check(f"bert B={B} H={H} S={S} D={D} {dt} bias",
                               *both(q, k, v, sm, bias=bias), tol)
    # ragged, causal, dead row, dropout, other head dims (f32)
    f32 = torch.float32
    q, k, v = _qkv(2, 3, 200, 77, 64, f32, gen)
    _check("ragged S=200 Sk=77 bias", *both(
        q, k, v, sm, bias=_padding_bias(2, 77, gen)), F32_TOL)
    q, k, v = _qkv(2, 3, 200, 200, 64, f32, gen)
    _check("causal ragged S=Sk=200", *both(q, k, v, sm, causal=True),
           F32_TOL)
    q, k, v = _qkv(2, 3, 256, 256, 64, f32, gen)
    dead = torch.zeros(2, 256, device="cuda")
    dead[0] = -1e30
    got, want = both(q, k, v, sm, bias=dead)
    _check("dead row (bias -1e30 on every key of batch 0)", got, want,
           F32_TOL)
    if not (got[0][0].eq(0).all() and got[1][:3].eq(1e30).all()):
        raise AssertionError("dead rows must write O = 0 and lse = +1e30")
    seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
    _check("dropout 0.1 seed 1234 causal bias", *both(
        q, k, v, sm, causal=True, rate=0.1, seed=seed,
        bias=_padding_bias(2, 256, gen)), F32_TOL)
    for d in (8, 16, 32, 128):
        q, k, v = _qkv(2, 2, 96, 80, d, f32, gen)
        _check(f"head dim {d}", *both(q, k, v, d ** -0.5,
                                      bias=_padding_bias(2, 80, gen)),
               F32_TOL)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        _check(f"head dim {d} bf16", *both(q, k, v, d ** -0.5), BF16_TOL)

    # time the served shape
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(B, H, S, S, D, dt, gen)
        bias = _padding_bias(B, S, gen)
        mask = bias[:, None, None, :].to(dt)
        ms = _cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, sm,
                                                      bias=bias))
        plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, sm, bias=bias))
        lib_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=sm))
        name = str(dt).replace("torch.", "")
        ops = 4 * B * H * S * S * D
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
            + bias.numel() * 4 + B * H * S * 4
        t_ops, t_bytes = ops / PEAK_OPS[name] * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        _log(f"[kernel] time {name} B={B} H={H} S={S} D={D}: kernel "
             f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
             f"bound {bound_ms:.4f} ms ({bound_by}: {ops} FLOP, {nbytes} B)")
        rows.append(dict(dtype=name, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by, max_abs_err=errs[str(dt)]))
    return rows


# --------------------------------------------------------------------------
# 3. slice
# --------------------------------------------------------------------------
def _build_encoder(cfg):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.data("src_ids", [S], dtype="int64")
        pos = fluid.data("pos_ids", [S], dtype="int64")
        sent = fluid.data("sent_ids", [S], dtype="int64")
        mask = fluid.data("input_mask", [S], dtype="float32")
        bias = bert.padding_attn_bias(mask)
        x = bert.bert_embedding(src, pos, sent, cfg)
        enc = bert.encoder(x, cfg["layers"], cfg["hidden"], cfg["heads"],
                           cfg["ffn"], attn_bias=bias)
    startup.random_seed = SEED
    return main, startup, enc


def _request(rng, bs, cfg):
    import numpy as np
    lens = rng.randint(S // 4, S + 1, size=bs)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    return {"src_ids": rng.randint(0, cfg["vocab_size"], (bs, S)),
            "pos_ids": np.tile(np.arange(S), (bs, 1)),
            "sent_ids": rng.randint(0, cfg["type_vocab"], (bs, S)),
            "input_mask": mask}


def phase_slice(profile=False):
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    cfg = bert.bert_base_config()
    main, startup, enc = _build_encoder(cfg)
    n_attn = sum(op.type == "fused_attention_qkv"
                 for op in main.global_block().ops)
    if n_attn != cfg["layers"]:
        raise AssertionError(f"{n_attn} attention ops, want {cfg['layers']}")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in (
        scope.find_var(v.name).value().array
        for v in main.global_block().all_parameters()))
    _log(f"[slice] BERT-base encoder: {len(main.global_block().ops)} ops, "
         f"{n_params} parameters, startup on the card "
         f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(SEED)
    pools = {bs: [_request(rng, bs, cfg) for _ in range(POOL)]
             for bs in SERVE_BATCHES}
    first = None
    fa.launch_count = 0
    n_req = 0
    for bs in SERVE_BATCHES:
        pool = pools[bs]
        for i in range(WARMUP):
            exe.run(main, feed=pool[i], fetch_list=[enc], scope=scope)
        n_req += WARMUP
        times, served = [], 0.0
        while served < WINDOW_S:
            feed = pool[len(times) % POOL]
            before = fa.launch_count
            t = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[enc], scope=scope)
            times.append(time.perf_counter() - t)
            served += times[-1]
            if fa.launch_count - before != cfg["layers"]:
                raise AssertionError(
                    f"flash kernel launched {fa.launch_count - before} "
                    f"times in one request, want {cfg['layers']}")
            if out.shape != (bs, S, cfg["hidden"]) \
                    or not np.isfinite(out).all():
                raise AssertionError(f"bad output {out.shape} "
                                     f"finite={np.isfinite(out).all()}")
            if first is None:
                first = (feed, out)
        n_req += len(times)
        ms = np.asarray(times) * 1e3
        _log(f"[slice] batch {bs:2d}: {len(times)} requests in "
             f"{ms.sum() / 1e3:.3f} s of Executor.run, "
             f"{bs * len(times) / (ms.sum() / 1e3):.1f} sequences/s, "
             f"latency p50 {np.percentile(ms, 50):.3f} ms "
             f"p99 {np.percentile(ms, 99):.3f} ms "
             f"max {ms.max():.3f} ms")
    launches = fa.launch_count
    _log(f"[slice] {n_req} requests, flash kernel launches {launches} "
         f"(= {cfg['layers']} per request)")

    # the first request again, by the port on the CPU with the same weights
    cpu_scope = fluid.Scope()
    for v in main.global_block().all_parameters():
        cpu_scope.var(v.name).set_value(fluid.LoDTensor(
            scope.find_var(v.name).value().array.cpu()))
    cpu_out, = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=first[0], fetch_list=[enc], scope=cpu_scope)
    err = float(np.abs(cpu_out - first[1]).max())
    ok = np.allclose(first[1], cpu_out, rtol=SLICE_TOL, atol=SLICE_TOL)
    _log(f"[slice] batch-1 request, card vs CPU: max|d| {err:.3e} "
         f"tol {SLICE_TOL:g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("served output disagrees with the CPU run")
    if profile:
        for bs in SERVE_BATCHES:
            _profile(exe, main, enc, scope, pools[bs][0], bs)
    return launches


def _profile(exe, main, enc, scope, feed, bs):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        t = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[enc], scope=scope)
        torch.cuda.synchronize()
        return time.perf_counter() - t
    walls = [run() for _ in range(20)][5:]
    wall = float(np.median(walls)) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = run() * 1e3
    # device-side events only (kernels, copies): one stream, so their
    # self times add up to the time the device was busy. The idle share is
    # taken against the unprofiled wall of the same request (median of
    # 15), since the profiler slows the host side.
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evts) / 1e3
    _log(f"[profile] batch {bs}: wall {wall:.3f} ms unprofiled (median of "
         f"15), {prof_wall:.3f} ms under the profiler; device busy "
         f"{busy:.3f} ms, idle {100 - 100 * busy / wall:.1f}% of the "
         f"unprofiled wall")
    for e in sorted(evts, key=lambda e: -e.self_device_time_total)[:10]:
        _log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
             f"x{e.count:4d}  {e.key[:90]}")


# --------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401 — fails outside a checkout
    # f32 products in full f32 everywhere, the kernel's plain version too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"[card] {_card_line()}")
    _log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    phase_build()
    rows = phase_kernel()
    launches = phase_slice(profile=args.profile)
    f32 = rows[0]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/cuda/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:298",
        "launches": launches,
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
