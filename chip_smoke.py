#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU: python3 chip_smoke.py

Phases, each fatal on failure:
  1. build  — compile every CUDA kernel from csrc/, one nvcc per source,
              all started together.
  2. kernel — hold each kernel against its plain PyTorch version on the
              card: the forward (O and lse), the backward's dK/dV and dQ
              kernels (dQ, dK, dV) and the dropout kernel (mask and
              output), over BERT-base shapes in f32 and bf16
              with a key-padding bias, ragged S/Sk, causal, a dead row,
              dropout 0.1 and head dims 8 to 128; time each kernel, its
              plain version and one PyTorch library call as a yardstick
              (scaled_dot_product_attention, and its backward): the
              forward at the served shape (batch 8) and the trained one
              (batch 32, also with dropout 0.1), the backward kernels at
              batch 32 in f32 (also with dropout 0.1) and bf16, each beside
              its bound and what sets it; the whole backward of SDPA and
              of the port timed alike, as (forward + backward) minus the
              forward, each captured in a CUDA graph; the dropout kernel
              at the step's shape beside torch.native_dropout; a kernel
              timed faster than its bound fails.
  3. serve  — build the BERT-base encoder (12 layers, hidden 768, 12
              heads, ffn 3072, vocab 30522) with the port, initialise it
              on the card from a seed, and serve requests of batch 1, 8
              and 32 at S=128 through fluid.Executor(CUDAPlace(0)).run with
              random padding, back to back for a fixed window per batch
              size, on the compiled path: per batch size an eager warm-up,
              a CUDA-graph capture, then one graph replay per request.
              Checks: every run compiled; finite outputs; exactly 12
              forward launches per request (through the wrapper in a
              warm-up or a capture, recorded in the graph for a replay,
              and counted by name in a profiler trace of one replay); a
              weight replaced by the caller is copied into the graph's
              tensor before the next replay; replayed outputs against the
              interpreter (the oracle) on the card; one request against
              the port on the CPU. Reports latency p50/p99 over every
              request of the window and sequences/s as all the sequences
              over all the time spent in Executor.run, and the
              interpreter's latency over a shorter window.
  4. train  — build the BERT-base masked-LM pretraining step with the port
              (build_bert_pretrain_program: dropout 0.1, input mask, Adam
              lr 1e-4), run its startup on the card and train at batch 32,
              S=128, 15 % of positions masked, compiled: 3 warm-up steps
              (eager, capture, replay), then a fixed window of replayed
              steps, then 10 steps on one repeated batch. Checks: every
              step compiled, a finite loss every step, exact kernel
              launches per step (12 forward + 12 forward re-run by the
              generic grad, 12 dK/dV, 12 dQ, one dropout launch per
              dropout op; for replays as recorded in the graph and in a
              profiler trace, which must hold device events), dropout
              masks that
              differ from step to step under replay, the loss falling on
              the repeated batch; at batch 2 with dropout 0 one step on
              the card against the port on the CPU from the same weights
              (loss and the grads of the word embedding, layer 0's Q
              weight and the MLM head); at batch 2 with dropout 0.1 three
              steps compiled (eager, capture, replay) against interpreted
              (losses, masks). Reports step time p50/p90/p99, samples/s,
              peak device memory (less what earlier phases left
              allocated), capture time, and the interpreter's step time
              and peak memory.
  5. big    — bench.py's BERT lane: 5 compiled training steps at batch
              256, or at the largest of 128 and 64 that fits; finite
              losses, each step's time and the peak device memory.

Output: the card's name and power limit first, results as lines of text,
then one JSON line {"kernels": [...]} (per kernel, ``launches`` and
``launches_by_path``: what the main path ran on the card, replays
included; ``wrapper_calls_by_path``: the wrappers' counts, warm-ups and
captures only) and, last, the JSON result line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when
CUDA is missing or any phase fails. ``--profile`` adds torch.profiler
passes over one request of each batch size and over one training step:
device time by kernel name, and the device's idle share against the same
work's unprofiled wall time.
"""
from __future__ import annotations

import argparse
import json
import os
import re
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
TRAIN_BATCH = 32
TRAIN_WARMUP = 3              # steps before the window
TRAIN_WINDOW = 100            # steps timed: p90 has 10 beyond it
FALL_STEPS = 10               # steps on one repeated batch
TRAIN_LR = 1e-4               # bench.py's BERT-base lane
TRAIN_DROPOUT = 0.1           # BERT's pretraining hidden/attention dropout
MLM_FRAC = 0.15               # masked positions per batch (bench.py)
CHECK_BATCH = 2               # card vs CPU step
LOSS_TOL = 1e-4               # card vs CPU loss, relative: f32 sums in
GRAD_TOL = 1e-3               # other orders; grads: of each max |grad|,
                              # after 12 layers forward and back
INTERP_WINDOW_S = 2.0         # seconds served per batch size, interpreted
INTERP_STEPS = 8              # interpreted training steps (2 warm-up)
GRAPH_TOL = 1e-6              # graph replay vs interpreted on the card,
                              # relative: the same kernels in the same
                              # order, so expected bit for bit
GRAPH_BATCH = 2               # compiled vs interpreted training steps
GRAPH_STEPS = 3               # eager warm-up, capture, replay
BIG_BATCHES = (256, 128, 64)  # bench.py's BERT lane, then what fits
BIG_STEPS = 5
KERNELS = ("flash_attention_fwd", "flash_attention_bwd_kv",
           "flash_attention_bwd_q", "dropout_fwd")
DEVICE_KERNELS = ("flash_fwd_kernel", "flash_bwd_kv_kernel",
                  "flash_bwd_q_kernel", "dropout_fwd_kernel")
DROPOUT_TOL = 1e-6            # dropout kernel vs plain, relative: the same
                              # f32 product, so expected bit for bit
DROPOUT_SETS = 4              # input sets cycled when timing dropout: 4 x
                              # 28 MB exceeds the 50 MB L2
PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s (published)
# FLOP/s of the card's fastest route to each dtype's product (H100 SXM,
# dense, published): an f32-accurate product as split TF32, three TF32
# products for each at 495 TFLOP/s (faster than the CUDA cores' 67);
# bf16 on the tensor cores at 989
PEAK_OPS = {"float32": 495e12 / 3, "bfloat16": 989e12,
            # integer ops on the CUDA cores: half the published 67 TFLOP/s
            # of f32 outside the tensor cores (Hopper issues 64 INT32 and
            # 128 FP32 lanes per SM and clock)
            "int32": 67e12 / 2}


def _log(*a):
    print(*a, flush=True)


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _cuda_ms(fn, iters=50, warmup=5, graph=True) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``iters`` back-to-back calls, after ``warmup`` calls. With ``graph``
    the calls are captured into one CUDA graph and the graph is replayed,
    so the time is the device's alone: the host's dispatch of each call
    (Python, ctypes, PyTorch's dispatcher) is not in it. The warm-up then
    runs on a side stream, as torch.cuda.graphs asks of a capture that
    runs autograd's backward. Without, the calls are issued from Python
    one by one, and a call whose host cost exceeds its device time is
    timed by the host."""
    import torch
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run = g.replay
        run()  # the first replay uploads the graph
    else:
        for _ in range(warmup):
            fn()

        def run():
            for _ in range(iters):
                fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(flop, nbytes, dtype):
    """(ms, what bounds it): the least time the card could take for
    ``flop`` FLOP of ``dtype`` products moving ``nbytes`` bytes."""
    t_ops = flop / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def fwd_bound(B, H, S, Sk, D, dtype):
    """(bound_ms, bound_by, flop, bytes) of the forward with a key-padding
    bias: 4·B·H·S·Sk·D FLOP; q, k, v and the bias read once, o and lse
    written once."""
    elt = 4 if dtype == "float32" else 2
    flop = 4 * B * H * S * Sk * D
    nbytes = (2 * B * H * S * D + 2 * B * H * Sk * D) * elt \
        + B * Sk * 4 + B * H * S * 4
    return (*bound(flop, nbytes, dtype), flop, nbytes)


def _check_bound(name, ms, bound_ms):
    if ms < bound_ms:
        raise AssertionError(f"{name} timed at {ms:.4f} ms, under its bound "
                             f"{bound_ms:.4f} ms: the timing or the bound "
                             "is wrong")


# --------------------------------------------------------------------------
# 1. build
# --------------------------------------------------------------------------
# a kernel instance's mangled name: <length>flash_..._kernel I <T> Li<D> E
_PTXAS_ENTRY = re.compile(
    r"Compiling entry function '\w*?\d(flash_[a-z_]+_kernel|"
    r"dropout_fwd_kernel)I(f|13__nv_bfloat16)(?:Li(\d+))?E")


def ptxas_report(text):
    """[(kernel, dtype, head dim, registers, spill stores B, spill loads
    B)] of each kernel instance in ``nvcc -Xptxas -v`` output."""
    out, cur, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = (m.group(1), "f32" if m.group(2) == "f" else "bf16",
                   int(m.group(3) or 0))
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.append((*cur, int(m.group(1)), *spill))
            cur = None
    return out


def phase_build():
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.ops.cuda import build, dropout as dk
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    sources = (fa.KERNEL_SOURCE, fa.BWD_KERNEL_SOURCE, dk.KERNEL_SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    for src in sources:
        build.load(src)
    _log(f"[build] {', '.join(sources)}: {time.perf_counter() - t0:.1f} s "
         "(nvcc -gencode arch=compute_90a,code=sm_90a, in parallel)")
    for src in sources:
        text = build.build_log.get(src, {}).get("ptxas", "")
        for kern, dt, d, regs, st, ld in ptxas_report(text):
            _log(f"[build] ptxas {kern} {dt}" + (f" D={d}" if d else "") +
                 f": {regs} registers, "
                 f"spill stores {st} B, spill loads {ld} B")


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
    seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
    q, k, v = _qkv(TRAIN_BATCH, H, S, S, D, torch.float32, gen)
    _check(f"bert B={TRAIN_BATCH} H={H} S={S} D={D} f32 bias dropout 0.1",
           *both(q, k, v, sm, rate=0.1, seed=seed,
                 bias=_padding_bias(TRAIN_BATCH, S, gen)), F32_TOL)
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

    # time the served shape (batch 8, f32 and bf16) and the trained one
    # (batch 32, f32, also with dropout 0.1), SDPA beside each
    rows = []
    for bs, dt, rate in ((B, torch.float32, 0.0), (B, torch.bfloat16, 0.0),
                         (TRAIN_BATCH, torch.float32, 0.0),
                         (TRAIN_BATCH, torch.float32, 0.1)):
        q, k, v = _qkv(bs, H, S, S, D, dt, gen)
        bias = _padding_bias(bs, S, gen)
        mask = bias[:, None, None, :].to(dt)

        def kernel():
            return fa.flash_attention_cuda(q, k, v, sm, False, rate, seed,
                                           bias)
        ms = _cuda_ms(kernel)
        eager_ms = _cuda_ms(kernel, graph=False)
        # the plain version's dropout mask reads the seed on the host,
        # which a graph cannot capture: with dropout it is timed eagerly
        plain_ms = _cuda_ms(lambda: fa.flash_attention_reference(
            q, k, v, sm, False, rate, seed, bias), graph=not rate)
        lib_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=rate, scale=sm))
        name = str(dt).replace("torch.", "")
        bound_ms, bound_by, ops, nbytes = fwd_bound(bs, H, S, S, D, name)
        what = f"{name} B={bs} H={H} S={S} D={D} bias" + (
            f" dropout {rate}" if rate else "")
        _log(f"[kernel] time forward {what}: kernel {ms:.4f} ms (issued "
             f"one by one from Python {eager_ms:.4f} ms), plain "
             f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
             f"{bound_ms:.4f} ms ({bound_by}: {ops} FLOP, {nbytes} B)")
        _check_bound(f"forward {what}", ms, bound_ms)
        rows.append(dict(shape=what, ms=ms, eager_ms=eager_ms,
                         plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by,
                         max_abs_err=errs[str(dt)]))
    return rows


def _check_bwd(name, got, want, tol):
    import torch
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    ok = all(torch.allclose(g.float(), w.float(), rtol=tol, atol=tol)
             for g, w in zip(got, want))
    _log(f"[kernel] bwd {name}: max|d dQ| {errs[0]:.3e} max|d dK| "
         f"{errs[1]:.3e} max|d dV| {errs[2]:.3e} tol {tol:g} -> "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"backward kernels disagree with their plain "
                             f"version: {name}")
    return errs


def _bwd_bound(B, H, S, Sk, D, flop_units, n_out, dtype="float32"):
    """(bound_ms, bound_by, flop, bytes) of a backward function doing
    ``flop_units``·B·H·S·Sk·D FLOP of ``dtype`` products that reads q, k,
    v, dO, lse, delta and the bias once and writes ``n_out`` outputs of
    q's or k's size once (n_out: "q" = dQ, "kv" = dK and dV, "qkv" =
    all)."""
    elt = 4 if dtype == "float32" else 2
    flop = flop_units * B * H * S * Sk * D
    q_b, kv_b = B * H * S * D * elt, B * H * Sk * D * elt
    nbytes = 2 * q_b + 2 * kv_b + 2 * B * H * S * 4 + B * Sk * 4
    nbytes += {"q": q_b, "kv": 2 * kv_b, "qkv": q_b + 2 * kv_b}[n_out]
    return (*bound(flop, nbytes, dtype), flop, nbytes)


def _bwd_yardstick(q, k, v, do, bias, sm, rate, seed):
    """The whole backward (dQ, dK and dV) of SDPA and of the port, each
    timed on the device as (forward + backward) minus the forward alone,
    both captured into CUDA graphs (SDPA's dropout RNG captures too): →
    (sdpa_ms, port_ms). The port's backward is bwd_delta and its two
    kernels."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    mask = bias[:, None, None, :].to(q.dtype)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              dropout_p=rate, scale=sm)

    def port():
        return fa.flash_attention_cuda(q, k, v, sm, False, rate, seed, bias)

    def port_fwd_bwd():
        o, lse = port()
        return fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, sm, False,
                                           rate, seed, bias)
    sdpa_ms = _cuda_ms(lambda: torch.autograd.grad(
        sdpa(), (qs, ks, vs), do)) - _cuda_ms(sdpa)
    return sdpa_ms, _cuda_ms(port_fwd_bwd) - _cuda_ms(port)


def phase_kernel_bwd():
    """The dK/dV and dQ kernels against the plain backward, on the forward
    kernel's O and lse, over the forward phase's cases; then each timed
    at the training shape, in f32 without and with dropout 0.1 and in
    bf16, beside the graph-timed whole backward of SDPA and of the port."""
    import torch
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    sm = 0.125
    errs = {}  # (kernel, dtype) -> max |kernel - plain| over the cases

    def both(name, q, k, v, scale, tol, causal=False, rate=0.0, seed=None,
             bias=None):
        o, lse = fa.flash_attention_cuda(q, k, v, scale, causal, rate, seed,
                                         bias)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, scale, causal,
                                          rate, seed, bias)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, scale,
                                                causal, rate, seed, bias)
        torch.cuda.synchronize()
        e_q, e_k, e_v = _check_bwd(name, got, want, tol)
        for kern, e in (("flash_attention_bwd_q", e_q),
                        ("flash_attention_bwd_kv", max(e_k, e_v))):
            key = (kern, q.dtype)
            errs[key] = max(errs.get(key, 0.0), e)
        return got

    seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
    B, H, D = TRAIN_BATCH, 12, 64
    f32, bf16 = torch.float32, torch.bfloat16
    for dt, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
        q, k, v = _qkv(B, H, S, S, D, dt, gen)
        both(f"bert B={B} H={H} S={S} D={D} {dt} bias dropout 0.1", q, k, v,
             sm, tol, rate=0.1, seed=seed, bias=_padding_bias(B, S, gen))
    q, k, v = _qkv(2, 3, 200, 77, 64, f32, gen)
    both("ragged S=200 Sk=77 bias", q, k, v, sm, F32_TOL,
         bias=_padding_bias(2, 77, gen))
    q, k, v = _qkv(2, 3, 200, 200, 64, f32, gen)
    both("causal ragged S=Sk=200", q, k, v, sm, F32_TOL, causal=True)
    q, k, v = _qkv(2, 3, 256, 256, 64, f32, gen)
    dead = torch.zeros(2, 256, device="cuda")
    dead[0] = -1e30
    dq, dk, dv = both("dead row (bias -1e30 on every key of batch 0)",
                      q, k, v, sm, F32_TOL, bias=dead)
    if not (dq[0].eq(0).all() and dk[0].eq(0).all() and dv[0].eq(0).all()):
        raise AssertionError("dead rows must give zero dQ, dK and dV")
    both("dropout 0.1 seed 1234 causal bias", q, k, v, sm, F32_TOL,
         causal=True, rate=0.1, seed=seed, bias=_padding_bias(2, 256, gen))
    for d in (8, 16, 32, 128):
        q, k, v = _qkv(2, 2, 96, 80, d, f32, gen)
        both(f"head dim {d}", q, k, v, d ** -0.5, F32_TOL,
             bias=_padding_bias(2, 80, gen))
        q, k, v = (t.to(bf16) for t in (q, k, v))
        both(f"head dim {d} bf16", q, k, v, d ** -0.5, BF16_TOL)

    # time at the training shape: B=32, H=12, S=128, D=64, bias; f32
    # without and with dropout 0.1 (as the training step runs them), bf16
    kernels = (("flash_attention_bwd_kv", fa.flash_attention_bwd_kv_cuda,
                fa.flash_attention_bwd_kv_reference, 8, "kv"),
               ("flash_attention_bwd_q", fa.flash_attention_bwd_q_cuda,
                fa.flash_attention_bwd_q_reference, 6, "q"))
    rows, timings = {}, {}
    for dt, rate in ((f32, 0.0), (f32, 0.1), (bf16, 0.0)):
        q, k, v = _qkv(B, H, S, S, D, dt, gen)
        bias = _padding_bias(B, S, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        o, lse = fa.flash_attention_cuda(q, k, v, sm, False, rate, seed, bias)
        delta = fa.bwd_delta(o, do)
        args = (q, k, v, do, lse, delta, sm, False, rate, seed, bias)
        name_dt = str(dt).replace("torch.", "")
        what = f"{name_dt} B={B} H={H} S={S} D={D} bias" + (
            f" dropout {rate}" if rate else "")
        lib_ms, port_ms = _bwd_yardstick(q, k, v, do, bias, sm, rate, seed)
        kern_ms = 0.0
        for name, cuda_fn, plain_fn, units, outs in kernels:
            ms = _cuda_ms(lambda: cuda_fn(*args))
            eager_ms = _cuda_ms(lambda: cuda_fn(*args), graph=False)
            # the plain version's dropout mask reads the seed on the host,
            # which a graph cannot capture: with dropout it is timed eagerly
            plain = _cuda_ms(lambda: plain_fn(*args), graph=not rate)
            bnd, by, flop, nbytes = _bwd_bound(B, H, S, S, D, units, outs,
                                               name_dt)
            _log(f"[kernel] time {name} {what}: kernel {ms:.4f} ms (issued "
                 f"one by one from Python {eager_ms:.4f} ms), plain "
                 f"{plain:.4f} ms, SDPA backward (dQ, dK, dV together, "
                 f"graph-timed) {lib_ms:.4f} ms, bound {bnd:.4f} ms ({by}: "
                 f"{flop} FLOP, {nbytes} B)")
            _check_bound(f"{name} {what}", ms, bnd)
            kern_ms += ms
            row = dict(shape=what, ms=ms, eager_ms=eager_ms, plain_ms=plain,
                       library_ms=lib_ms, bound_ms=bnd, bound_by=by,
                       max_abs_err=errs[(name, dt)])
            rows.setdefault(name, row)  # f32 without dropout first
            timings.setdefault(name, []).append(row)
        bnd, by, flop, nbytes = _bwd_bound(B, H, S, S, D, 10, "qkv", name_dt)
        _log(f"[kernel] time whole backward {what}, graph-timed as (forward "
             f"+ backward) - forward: the port (bwd_delta, dK/dV, dQ) "
             f"{port_ms:.4f} ms, SDPA {lib_ms:.4f} ms; the two kernels alone "
             f"{kern_ms:.4f} ms; bound {bnd:.4f} ms ({by}: {flop} FLOP = "
             f"10·B·H·S·Sk·D, {nbytes} B; the two kernels execute "
             f"14·B·H·S·Sk·D, recomputing QK^T and dO·V^T in each)")
        _check_bound(f"the port's whole backward {what}", port_ms, bnd)
    for name in rows:
        rows[name] = dict(rows[name], timings=timings[name])
    return rows


def phase_kernel_dropout():
    """The dropout kernel against its plain version on the card: the mask
    exactly and the output within DROPOUT_TOL, at the training step's
    shape ([32, 128, 768] f32, rate 0.1, both implementations), in bf16,
    at a size that is no multiple of 4 and on a misaligned view; then
    timed at the training shape beside its plain version, the library's
    dropout and its bound, cycling DROPOUT_SETS input sets so that the
    inputs come from HBM, as they would after the step's other ops."""
    import torch
    from paddle_tpu_torch.ops.cuda import dropout as dk
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    shape = (TRAIN_BATCH, S, 768)
    rate = TRAIN_DROPOUT
    err = 0.0
    cases = [("f32 upscale_in_train", shape, torch.float32, True, None),
             ("f32 downgrade_in_infer", shape, torch.float32, False, None),
             ("bf16 upscale_in_train", shape, torch.bfloat16, True, None),
             ("f32 n=4099", (4099,), torch.float32, True, None),
             ("f32 view at offset 1", (4097,), torch.float32, True, 1)]
    for i, (what, shp, dt, up, offset) in enumerate(cases):
        x = torch.randn(shp, generator=gen, device="cuda").to(dt)
        if offset:
            x = x[offset:]
        key = torch.tensor([0xC0FFEE + 7919 * i], dtype=torch.int64,
                           device="cuda")
        o, m = dk.dropout_cuda(x, key, rate, up)
        ro, rm = dk.dropout_reference(x, key, rate, up)
        torch.cuda.synchronize()
        e = (o.float() - ro.float()).abs().max().item()
        scale = ro.float().abs().max().item()
        ok = torch.equal(m, rm) and e <= DROPOUT_TOL * scale
        _log(f"[kernel] dropout {what} {tuple(x.shape)}: masks "
             f"{'equal' if torch.equal(m, rm) else 'DIFFER'}, kept "
             f"{m.float().mean().item():.4f}, max|d out| {e:.3e} of max "
             f"{scale:.3e} (tol {DROPOUT_TOL:g} relative) -> "
             f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"dropout kernel disagrees with its plain "
                                 f"version: {what}")
        if dt == torch.float32 and offset is None:
            err = max(err, e)
    xs = [torch.randn(shape, generator=gen, device="cuda")
          for _ in range(DROPOUT_SETS)]
    key = torch.tensor([99], dtype=torch.int64, device="cuda")
    turn = [0]

    def cycled(fn):
        def call():
            turn[0] += 1
            return fn(xs[turn[0] % DROPOUT_SETS])
        return call
    ms = _cuda_ms(cycled(lambda x: dk.dropout_cuda(x, key, rate, True)))
    plain_ms = _cuda_ms(cycled(
        lambda x: dk.dropout_reference(x, key, rate, True)))
    lib_ms = _cuda_ms(cycled(lambda x: torch.native_dropout(x, rate, True)))
    n = xs[0].numel()
    # x read once, out (f32) and the mask (uint8) written once, the key
    # read; the hash's 11 integer operations, the compare and the select
    # per element, and the product by 1 / (1 - rate)
    nbytes = n * (4 + 4 + 1) + 8
    bnd, by = bound(13 * n, nbytes, "int32")
    _log(f"[kernel] time dropout f32 {shape} rate {rate}: kernel {ms:.4f} "
         f"ms, plain {plain_ms:.4f} ms, torch.native_dropout (philox: the "
         f"same distribution, other bits) {lib_ms:.4f} ms, bound "
         f"{bnd:.4f} ms ({by}: {nbytes} B, {13 * n} integer operations)")
    _check_bound("dropout", ms, bnd)
    return dict(shape=f"float32 {list(shape)} rate {rate} upscale_in_train",
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                bound_by=by, max_abs_err=err)


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


def _gate_run(exe, delta, want, what):
    """One Executor.run on the compiled path against the exact kernel
    launches ``want`` (forward, dK/dV, dQ, dropout) of one request or
    step. An
    eager run launches them through the wrappers; a capture launches them
    through the wrappers into the graph, which must record exactly
    ``want``; a replay calls no wrapper and launches what its graph
    recorded. → how the run executed: "eager", "capture" or "replay"."""
    if exe._last_run_mode != "compiled":
        raise AssertionError(f"{what} ran {exe._last_run_mode}, "
                             "want compiled")
    cb = exe._last_block
    graph = tuple(cb.graph_launches.get(k, 0) for k in KERNELS)
    if cb.last_exec == "replay":
        ok = not any(delta) and graph == want
    elif cb.last_exec == "capture":
        ok = delta == want and graph == want
    else:
        ok = delta == want
    if not ok:
        raise AssertionError(
            f"{what} ({cb.last_exec}): launches through the wrappers "
            f"{delta}, recorded in the graph {graph}; want {want} a run")
    return cb.last_exec


def _device_kernel_counts(fn):
    """(forward, dK/dV, dQ, dropout) kernels the card ran during ``fn()``,
    counted by name in a torch.profiler trace. A trace that holds no
    device event at all fails: the gate would rest on the launches
    recorded at capture alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not evts:
        raise AssertionError("the profiler recorded no device event on the "
                             "card: the replay's kernels cannot be counted")
    return tuple(sum(e.count for e in evts if name in e.key)
                 for name in DEVICE_KERNELS)


def _check_trace(counts, want, what):
    if counts != want:
        raise AssertionError(f"{what}: the card ran {counts} (forward, "
                             f"dK/dV, dQ, dropout) kernels, want {want}")
    _log(f"[graph] {what}: the trace of one replay holds {counts} "
         "(forward, dK/dV, dQ, dropout) kernels, as recorded")


def _agree(what, got, ref):
    """Graph replay against the interpreter on the card: bitwise, or
    within GRAPH_TOL of the reference's largest magnitude."""
    import numpy as np
    same = np.array_equal(got, ref)
    err = float(np.abs(got - ref).max())
    scale = float(np.abs(ref).max())
    ok = same or err <= GRAPH_TOL * scale
    _log(f"[graph] {what}, compiled (graph replay) vs interpreted: " +
         ("bitwise equal" if same else
          f"max|d| {err:.3e} of max {scale:.3e}") +
         f" (tol {GRAPH_TOL:g} relative) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the graph replay disagrees with the "
                             "interpreter")
    return same


def _latency_line(prefix, bs, times):
    import numpy as np
    ms = np.asarray(times) * 1e3
    _log(f"{prefix} {bs:2d}: {len(times)} requests in "
         f"{ms.sum() / 1e3:.3f} s of Executor.run, "
         f"{bs * len(times) / (ms.sum() / 1e3):.1f} sequences/s, "
         f"latency p50 {np.percentile(ms, 50):.3f} ms "
         f"p99 {np.percentile(ms, 99):.3f} ms "
         f"max {ms.max():.3f} ms")


def phase_slice(profile=False):
    import collections
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    L = cfg["layers"]
    want = (L, 0, 0, 0)
    main, startup, enc = _build_encoder(cfg)
    n_attn = sum(op.type == "fused_attention_qkv"
                 for op in main.global_block().ops)
    if n_attn != L:
        raise AssertionError(f"{n_attn} attention ops, want {L}")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    n_params = sum(scope.find_var(v.name).value().array.numel()
                   for v in params)
    _log(f"[slice] BERT-base encoder: {len(main.global_block().ops)} ops, "
         f"{n_params} parameters, startup on the card "
         f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(SEED)
    pools = {bs: [_request(rng, bs, cfg) for _ in range(POOL)]
             for bs in SERVE_BATCHES}
    runs = collections.Counter()

    def request(feed, what):
        before = _launch_counts()
        t = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[enc], scope=scope)
        dt = time.perf_counter() - t
        delta = tuple(a - b for a, b in zip(_launch_counts(), before))
        runs[_gate_run(exe, delta, want, what)] += 1
        if out.shape != (feed["src_ids"].shape[0], S, cfg["hidden"]) \
                or not np.isfinite(out).all():
            raise AssertionError(f"bad output {out.shape} "
                                 f"finite={np.isfinite(out).all()}")
        return out, dt

    first, replayed = None, {}
    _reset_launch_counts()
    for bs in SERVE_BATCHES:
        pool = pools[bs]
        for i in range(WARMUP):
            request(pool[i], f"batch-{bs} warm-up request {i}")
        times, served = [], 0.0
        while served < WINDOW_S:
            feed = pool[len(times) % POOL]
            out, dt = request(feed, f"a batch-{bs} request")
            times.append(dt)
            served += dt
            replayed.setdefault(bs, (feed, out))
            if first is None:
                first = (feed, out)
        _latency_line("[slice] batch", bs, times)
    mid = SERVE_BATCHES[len(SERVE_BATCHES) // 2]
    _check_trace(_device_kernel_counts(
        lambda: request(pools[mid][1], "a traced request")), want,
        f"batch-{mid} request")
    # a caller replaces a weight: the next replay must read the new one
    w_var = scope.find_var("word_embedding")
    w = w_var.value().array
    orig = w.clone()
    w_var.set_value(fluid.LoDTensor(w * 0.5))
    new_out, _ = request(pools[mid][2], "a request after a weight was "
                         "replaced")
    if exe._last_block.last_exec != "replay" \
            or scope.find_var("word_embedding").value().array is not w \
            or not torch.equal(w, orig * 0.5):
        raise AssertionError("a replaced weight was not copied into the "
                             "graph's tensor before the replay")
    launches = _launch_counts()
    n_runs = sum(runs.values())
    if launches != tuple((runs["eager"] + runs["capture"]) * x
                         for x in want):
        raise AssertionError(f"launches {launches} over runs {dict(runs)}")
    st = exe.graph_stats()
    _log(f"[slice] {n_runs} requests, compiled: {runs['eager']} eager "
         f"warm-ups, {runs['capture']} captures ({st['capture_s']:.2f} s "
         f"in all), {runs['replay']} replays; flash kernel launches "
         f"{launches[0]} through the wrapper (warm-ups and captures), "
         f"{n_runs * L} run on the card (= {L} per request); backward "
         f"and dropout launches {sum(launches[1:])}")

    # the interpreter on the same weights: replays against the eager plan,
    # and its own latency in this run
    iexe, iscope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    for v in params:
        iscope.var(v.name).set_value(fluid.LoDTensor(
            scope.find_var(v.name).value().array))
    fluid.core.set_flag("FLAGS_executor_mode", "interpreted")
    try:
        def interp(feed):
            t = time.perf_counter()
            out, = iexe.run(main, feed=feed, fetch_list=[enc], scope=iscope)
            dt = time.perf_counter() - t
            if iexe._last_run_mode != "interpreted":
                raise AssertionError("the oracle did not run interpreted")
            return out, dt
        _agree(f"batch-{mid} request, word embedding replaced",
               new_out, interp(pools[mid][2])[0])
        w.copy_(orig)
        for bs in SERVE_BATCHES:
            _agree(f"batch-{bs} request", replayed[bs][1],
                   interp(replayed[bs][0])[0])
        # the interpreter's latency, each window followed by a compiled
        # one of the same length: host-bound latency drifts within a run
        for bs in SERVE_BATCHES:
            for mode, label, fn in (
                    ("interpreted", "interpreted", interp),
                    ("compiled", "compiled again,",
                     lambda f: request(f, "a request"))):
                fluid.core.set_flag("FLAGS_executor_mode", mode)
                for i in range(2):
                    fn(pools[bs][i])
                times = []
                while sum(times) < INTERP_WINDOW_S:
                    times.append(fn(pools[bs][len(times) % POOL])[1])
                _latency_line(f"[slice] {label} batch", bs, times)
    finally:
        fluid.core.set_flag("FLAGS_executor_mode", "compiled")
    del iexe, iscope

    # the first request again, by the port on the CPU with the same weights
    cpu_scope = fluid.Scope()
    for v in params:
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
    exe.close()
    return {"wrapper": launches, "executed": (n_runs * L, 0, 0, 0),
            "runs": dict(runs)}


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
# 4. train
# --------------------------------------------------------------------------
def _train_batch(rng, bs, cfg):
    """A pretraining batch as bench.py's BERT lane makes it, with random
    padding lengths: 15 % of the B·S positions masked, at random."""
    import numpy as np
    lens = rng.randint(S // 4, S + 1, size=bs)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.float32)
    n_mask = max(1, int(bs * S * MLM_FRAC))
    return {"src_ids": rng.randint(0, cfg["vocab_size"], (bs, S)),
            "pos_ids": np.tile(np.arange(S), (bs, 1)),
            "sent_ids": rng.randint(0, cfg["type_vocab"], (bs, S)),
            "mask_pos": rng.randint(0, bs * S, (n_mask, 1)),
            "mask_label": rng.randint(0, cfg["vocab_size"], (n_mask, 1)),
            "input_mask": mask}


def _pretrain_program(cfg, dropout):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    with fluid.unique_name.guard():
        main, startup, _, (loss,) = bert.build_bert_pretrain_program(
            cfg, seq_len=S, dropout=dropout, lr=TRAIN_LR,
            use_input_mask=True)
    startup.random_seed = main.random_seed = SEED
    return main, startup, loss


def _launch_counts():
    from paddle_tpu_torch.ops.cuda import dropout as dk
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    return (fa.launch_count, fa.bwd_kv_launch_count, fa.bwd_q_launch_count,
            dk.launch_count)


def _reset_launch_counts():
    from paddle_tpu_torch.ops.cuda import dropout as dk
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    fa.launch_count = fa.bwd_kv_launch_count = fa.bwd_q_launch_count = 0
    dk.launch_count = 0


def _dropout_ops(ops):
    """Dropout ops that draw in a training step (each launches the
    dropout kernel once)."""
    return sum(op.type == "dropout" and not op.attr("is_test")
               for op in ops)


def phase_train(profile=False):
    import collections
    import gc
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    L = cfg["layers"]
    main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT)
    ops = main.global_block().ops
    n_fwd = sum(op.type == "fused_attention_qkv" for op in ops)
    n_grad = sum(op.type == "fused_attention_qkv_grad" for op in ops)
    if n_fwd != L or n_grad != L:
        raise AssertionError(f"{n_fwd} attention ops and {n_grad} grads, "
                             f"want {L} each")
    # per step: each attention op launches the forward once; its grad op
    # re-runs the forward under autograd (the generic grad), whose
    # backward launches the dK/dV and the dQ kernel once each; each
    # dropout op launches the dropout kernel once (its grad is a mask
    # product: no re-draw)
    want = (2 * L, L, L, _dropout_ops(ops))
    if not want[3]:
        raise AssertionError("the training step has no dropout op")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    # what earlier phases of this process left allocated (the cuBLAS
    # workspace of each stream they used) is not the step's memory
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block().all_parameters()
    n_params = sum(scope.find_var(p.name).value().array.numel()
                   for p in params)
    _log(f"[train] BERT-base pretraining step: {len(ops)} ops, "
         f"{len(params)} parameters ({n_params} values), dropout "
         f"{TRAIN_DROPOUT}, Adam lr {TRAIN_LR}; startup on the card "
         f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(SEED + 2)
    pool = [_train_batch(rng, TRAIN_BATCH, cfg) for _ in range(POOL)]
    mask = [op for op in ops if op.type == "dropout"][0].output("Mask")[0]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    runs = collections.Counter()

    def step(feed, fetch=(loss,)):
        before = _launch_counts()
        t = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=list(fetch), scope=scope)
        dt = time.perf_counter() - t
        delta = tuple(a - b for a, b in zip(_launch_counts(), before))
        runs[_gate_run(exe, delta, want, "a training step")] += 1
        value = float(out[0].reshape(-1)[0])
        if not np.isfinite(value):
            raise AssertionError(f"non-finite loss {value}")
        return value, dt, out

    for i in range(TRAIN_WARMUP):
        step(pool[i])
    times, losses = [], []
    for i in range(TRAIN_WINDOW):
        value, dt, _ = step(pool[(TRAIN_WARMUP + i) % POOL])
        times.append(dt)
        losses.append(value)
    fall = [step(pool[0])[0] for _ in range(FALL_STEPS)]
    peak = torch.cuda.max_memory_allocated() - before
    _check_trace(_device_kernel_counts(lambda: step(pool[1])), want,
                 "training step")
    # the fetch list is part of the key: a graph of its own, whose
    # replays (steps 3 and 4) must draw new masks
    masks = [step(pool[2 + i], (loss, mask))[2][1] for i in range(4)]
    if exe._last_block.stats != dict(exe._last_block.stats, eager=1,
                                     captures=1, replays=3):
        raise AssertionError(f"mask runs: {exe._last_block.stats}")
    for i in range(1, 4):
        for j in range(i):
            if np.array_equal(masks[i], masks[j]):
                raise AssertionError(f"steps {j} and {i} drew the same "
                                     "dropout mask")
    keep = [float(m.mean()) for m in masks]
    if not all(abs(k - (1 - TRAIN_DROPOUT)) < 0.01 for k in keep):
        raise AssertionError(f"kept fractions {keep}")
    _log(f"[graph] dropout masks of 4 steps (eager, capture, 2 replays) "
         f"all differ; kept fractions " + " ".join(f"{k:.4f}" for k in keep))
    launches = _launch_counts()
    n_runs = sum(runs.values())
    if launches != tuple((runs["eager"] + runs["capture"]) * w
                         for w in want):
        raise AssertionError(f"launches {launches} over runs {dict(runs)}")
    st = exe.graph_stats()
    ms = np.asarray(times) * 1e3
    _log(f"[train] batch {TRAIN_BATCH}: {TRAIN_WINDOW} steps in "
         f"{ms.sum() / 1e3:.3f} s of Executor.run, "
         f"{TRAIN_BATCH * TRAIN_WINDOW / (ms.sum() / 1e3):.2f} samples/s, "
         f"step p50 {np.percentile(ms, 50):.3f} ms p90 "
         f"{np.percentile(ms, 90):.3f} ms p99 {np.percentile(ms, 99):.3f} "
         f"ms max {ms.max():.3f} ms (n={len(ms)}); losses "
         f"{losses[0]:.4f} .. {losses[-1]:.4f}")
    _log(f"[train] peak device memory {peak / 2**30:.3f} GiB "
         f"(max_memory_allocated over warm-up, window and repeated steps, "
         f"less the {before / 2**30:.3f} GiB allocated before the phase)")
    _log(f"[train] {n_runs} steps, compiled: {runs['eager']} eager "
         f"warm-ups, {runs['capture']} captures ({st['capture_s']:.2f} s in "
         f"all), {runs['replay']} replays; launches through the wrappers "
         f"(warm-ups and captures) forward {launches[0]}, dK/dV "
         f"{launches[1]}, dQ {launches[2]}, dropout {launches[3]}; run on "
         f"the card "
         f"{tuple(n_runs * w for w in want)} (= {want} per step)")
    _log(f"[train] repeated batch, {FALL_STEPS} steps: " +
         " ".join(f"{x:.4f}" for x in fall))
    if not (fall[-1] < fall[0] and np.mean(fall[-3:]) < np.mean(fall[:3])):
        raise AssertionError("the loss does not fall on a repeated batch")
    if profile:
        _profile_step(exe, main, loss, scope, pool[1])
    exe.close()
    del exe, scope
    _interpreted_train(main, startup, loss, pool)
    _check_train_against_cpu(cfg)
    _check_graph_against_interpreter(cfg)
    return {"wrapper": launches,
            "executed": tuple(n_runs * w for w in want), "runs": dict(runs)}



def _interpreted_train(main, startup, loss, pool):
    """The oracle's step time and memory in this run, for comparison."""
    import gc
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fluid.core.set_flag("FLAGS_executor_mode", "interpreted")
    try:
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        times = []
        for i in range(INTERP_STEPS):
            t = time.perf_counter()
            out, = exe.run(main, feed=pool[i % POOL], fetch_list=[loss],
                           scope=scope)
            times.append(time.perf_counter() - t)
            if exe._last_run_mode != "interpreted" \
                    or not np.isfinite(out).all():
                raise AssertionError("the interpreted step failed")
    finally:
        fluid.core.set_flag("FLAGS_executor_mode", "compiled")
    peak = torch.cuda.max_memory_allocated() - before
    ms = np.asarray(times[2:]) * 1e3
    _log(f"[train] interpreted batch {TRAIN_BATCH}: step p50 "
         f"{np.percentile(ms, 50):.3f} ms max {ms.max():.3f} ms "
         f"(n={len(ms)}, after 2 warm-ups); peak device memory "
         f"{peak / 2**30:.3f} GiB")


def _check_graph_against_interpreter(cfg):
    """GRAPH_STEPS steps at batch GRAPH_BATCH, dropout 0.1, on the card:
    compiled (eager warm-up, capture, replay) against interpreted, each
    from its own startup run. The losses agree bitwise or within
    GRAPH_TOL, the first dropout mask of each step exactly, and the
    startup weights exactly."""
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT)
    mask = [op for op in main.global_block().ops
            if op.type == "dropout"][0].output("Mask")[0]
    rng = np.random.RandomState(SEED + 4)
    feeds = [_train_batch(rng, GRAPH_BATCH, cfg) for _ in range(GRAPH_STEPS)]
    params = main.global_block().all_parameters()
    got, scopes, init = {}, {}, {}
    try:
        # the interpreter twice: how far two eager runs of the step drift
        # apart on their own
        for mode in ("compiled", "interpreted", "interpreted again"):
            fluid.core.set_flag("FLAGS_executor_mode", mode.split()[0])
            exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
            exe.run(startup, scope=scope)
            scopes[mode] = scope
            init[mode] = [scope.find_var(p.name).value().array.clone()
                          for p in params]
            got[mode] = []
            for f in feeds:
                got[mode].append(exe.run(main, feed=f,
                                         fetch_list=[loss, mask],
                                         scope=scope))
                got[mode][-1].append(exe._last_run_mode + (
                    ":" + exe._last_block.last_exec
                    if mode == "compiled" else ""))
    finally:
        fluid.core.set_flag("FLAGS_executor_mode", "compiled")
    for p, a, b in zip(params, init["compiled"], init["interpreted"]):
        if not torch.equal(a, b):
            raise AssertionError(f"the two startup runs differ: {p.name}")
    def param_diff(a, b):
        """(max |d|, the parameter where it is) between two scopes."""
        return max((float((scopes[a].find_var(p.name).value().array
                           - scopes[b].find_var(p.name).value().array)
                          .abs().max()), p.name) for p in params)

    twice = [float(np.abs(a[0] - b[0]).max()) for a, b in
             zip(got["interpreted"], got["interpreted again"])]
    _log(f"[graph] the interpreter against itself, {GRAPH_STEPS} steps: "
         f"loss max|d| " + " ".join(f"{x:.3e}" for x in twice) +
         "; parameters max|d| {:.3e} ({})".format(
             *param_diff("interpreted", "interpreted again")))
    kinds = [r[2] for r in got["compiled"]]
    if kinds != ["compiled:eager", "compiled:capture", "compiled:replay"]:
        raise AssertionError(f"compiled runs {kinds}")
    for i, (c, r) in enumerate(zip(got["compiled"], got["interpreted"])):
        _agree(f"training step {i} ({kinds[i]}) loss {float(c[0][0]):.7f}, "
               f"batch {GRAPH_BATCH} dropout {TRAIN_DROPOUT}", c[0], r[0])
        if not np.array_equal(c[1], r[1]):
            raise AssertionError(f"step {i}: dropout masks differ")
    _log(f"[graph] dropout masks equal at each step; parameters after "
         f"{GRAPH_STEPS} steps: max|d| " + "{:.3e} ({})".format(
             *param_diff("compiled", "interpreted")) +
         f" over {len(params)} tensors")



def _check_train_against_cpu(cfg):
    """One step at batch 2, dropout 0, on the card and by the port on the
    CPU from the same weights: the loss and three grads. Post-Adam
    parameters are not compared: Adam's m/(√v+ε) turns rounding noise on
    a near-zero grad into a step of ±lr."""
    import numpy as np
    from paddle_tpu_torch import fluid
    main, startup, loss = _pretrain_program(cfg, 0.0)
    muls = [op for op in main.global_block().ops if op.type == "mul"]
    names = ["word_embedding", muls[0].input("Y")[0],
             muls[-1].input("Y")[0]]  # layer 0's Q weight, the MLM head
    fetch = [loss] + [n + "@GRAD" for n in names]
    gpu_scope, cpu_scope = fluid.Scope(), fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=gpu_scope)
    for v in main.global_block().vars.values():
        if v.persistable:
            cpu_scope.var(v.name).set_value(fluid.LoDTensor(
                gpu_scope.find_var(v.name).value().array.cpu()))
    feed = _train_batch(np.random.RandomState(SEED + 3), CHECK_BATCH, cfg)
    gpu = exe.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    cpu = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                               fetch_list=fetch,
                                               scope=cpu_scope)
    ok = abs(float(gpu[0][0]) - float(cpu[0][0])) \
        <= LOSS_TOL * abs(float(cpu[0][0]))
    _log(f"[train] batch {CHECK_BATCH} dropout 0, card vs CPU: loss "
         f"{float(gpu[0][0]):.6f} vs {float(cpu[0][0]):.6f} "
         f"(tol {LOSS_TOL:g} relative)")
    for name, g, c in zip(names, gpu[1:], cpu[1:]):
        scale = float(np.abs(c).max())
        err = float(np.abs(g - c).max())
        ok = ok and err <= GRAD_TOL * scale
        _log(f"[train]   {name}@GRAD {tuple(c.shape)}: max|d| {err:.3e}, "
             f"max|grad| {scale:.3e} (tol {GRAD_TOL:g} of it)")
    if not ok:
        raise AssertionError("the training step on the card disagrees with "
                             "the CPU run")


def _profile_step(exe, main, loss, scope, feed):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        t = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        return time.perf_counter() - t
    wall = float(np.median([run() for _ in range(7)][2:])) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = run() * 1e3
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evts) / 1e3
    _log(f"[profile] train step batch {TRAIN_BATCH}: wall {wall:.3f} ms "
         f"unprofiled (median of 5), {prof_wall:.3f} ms under the profiler; "
         f"device busy {busy:.3f} ms, idle {100 - 100 * busy / wall:.1f}% "
         f"of the unprofiled wall; {sum(e.count for e in evts)} device "
         "events")
    top = sorted(evts, key=lambda e: -e.self_device_time_total)
    for e in top[:15]:
        _log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
             f"x{e.count:5d}  {e.key[:90]}")
    attn = [e for e in top if "flash_" in e.key]
    for e in attn:
        if e not in top[:15]:
            _log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
                 f"x{e.count:5d}  {e.key[:90]}")
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3
    _log(f"[profile] attention kernels {attn_ms:.3f} ms of the step's "
         f"{busy:.3f} ms device time ({100 * attn_ms / busy:.1f}%)")
    drop = [e for e in top if "dropout_fwd_kernel" in e.key]
    drop_ms = sum(e.self_device_time_total for e in drop) / 1e3
    _log(f"[profile] dropout kernel {drop_ms:.3f} ms for "
         f"{sum(e.count for e in drop)} launches "
         f"({100 * drop_ms / busy:.2f}% of the step's device time)")


def phase_big():
    """bench.py's BERT lane: BIG_STEPS compiled training steps at batch
    256 (dropout 0.1, input mask, Adam), or at the largest batch of
    BIG_BATCHES that fits: finite losses, the steps' times and peak
    memory."""
    import gc
    import numpy as np
    import torch
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    cfg = bert.bert_base_config()
    L = cfg["layers"]
    main, startup, loss = _pretrain_program(cfg, TRAIN_DROPOUT)
    n_drop = _dropout_ops(main.global_block().ops)
    for bs in BIG_BATCHES:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        rng = np.random.RandomState(SEED + 5)
        steps = []
        try:
            exe.run(startup, scope=scope)
            for _ in range(BIG_STEPS):
                feed = _train_batch(rng, bs, cfg)
                b = _launch_counts()
                t = time.perf_counter()
                out, = exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)
                dt = time.perf_counter() - t
                delta = tuple(x - y for x, y in zip(_launch_counts(), b))
                kind = _gate_run(exe, delta, (2 * L, L, L, n_drop),
                                 f"a batch-{bs} step")
                steps.append((kind, dt * 1e3, float(out.reshape(-1)[0])))
        except torch.cuda.OutOfMemoryError as e:
            _log(f"[big] batch {bs}: out of memory after {len(steps)} "
                 f"steps ({str(e).splitlines()[0][:160]})")
            exe.close()
            del exe, scope
            continue
        peak = torch.cuda.max_memory_allocated() - before
        if not all(np.isfinite(x[2]) for x in steps):
            raise AssertionError(f"batch {bs}: non-finite loss {steps}")
        _log(f"[big] batch {bs} (bench.py's BERT lane is 256), "
             f"{BIG_STEPS} compiled steps: " + "; ".join(
                 f"{k} {ms:.1f} ms loss {x:.4f}" for k, ms, x in steps))
        _log(f"[big] batch {bs}: peak device memory {peak / 2**30:.3f} GiB "
             f"(max_memory_allocated less the {before / 2**30:.3f} GiB "
             f"allocated before), reserved "
             f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB at most, "
             f"of {torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}"
             " GiB on the card")
        exe.close()
        return bs, peak
    raise AssertionError(f"no batch of {BIG_BATCHES} fits")


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
    bwd_rows = phase_kernel_bwd()
    drop_row = phase_kernel_dropout()
    serve = phase_slice(profile=args.profile)
    train = phase_train(profile=args.profile)
    phase_big()
    # launches: what the training path ran on the card (each warm-up or
    # capture through the wrappers, each replay as its graph recorded and
    # as the profiler counted), by path beside it; wrapper_calls: the
    # wrappers' own counts, which a replay does not move
    f32 = rows[0]
    src = "paddle_tpu_torch/ops/cuda/csrc/"
    replaces = "paddle_tpu/ops/pallas/flash_attention.py:"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    entries = [("flash_attention_fwd", "flash_attention_fwd.cu",
                replaces + "298", dict(f32, timings=rows)),
               ("flash_attention_bwd_kv", "flash_attention_bwd.cu",
                replaces + "514", bwd_rows["flash_attention_bwd_kv"]),
               ("flash_attention_bwd_q", "flash_attention_bwd.cu",
                replaces + "543", bwd_rows["flash_attention_bwd_q"]),
               # no Pallas kernel: jax.random.bernoulli in an XLA fusion
               ("dropout_fwd", "dropout.cu", "paddle_tpu/ops/nn_ops.py:263",
                drop_row)]
    kernels = []
    for i, (name, source, repl, r) in enumerate(entries):
        kernels.append(dict(
            name=name, route="cuda", source=src + source, replaces=repl,
            launches=train["executed"][i],
            launches_by_path={"serve": serve["executed"][i],
                              "train": train["executed"][i]},
            wrapper_calls_by_path={"serve": serve["wrapper"][i],
                                   "train": train["wrapper"][i]},
            **{k: r[k] for k in keys},
            **({"timings": r["timings"]} if "timings" in r else {})))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
