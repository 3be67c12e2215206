"""The port's benchmark entry point; prints ONE JSON line:

    python3 -m paddle_tpu_torch.bench
        [bert|mnist|resnet|transformer|wide_deep|mnist_realdata|
         mnist_guard|wide_deep_realdata|longctx] [--device cpu]

Each lane is the function of the same name in the repository's bench.py
(the TPU package's), with what it configures ported unchanged: the model,
the batch, the optimizer, the data made from ``RandomState(0)``, and the
timing of ``steps`` optimizer steps as one ``Executor.run(n_steps=steps)``
window after a warm window of the same length (on the card: the first
window holds the eager warm-up and the CUDA-graph capture, the timed one
is all graph replays).

  bert   BERT-base masked-LM pretraining step, FLAGS_use_bf16_matmul on,
         dropout 0, no input mask, Adam lr 1e-4, batch 256 at S=128 with
         the OOM ladder 256/128/64/32, 20 steps. bench.py's switches:
         PADDLE_TPU_BENCH_BATCH and PADDLE_TPU_BENCH_SEQ set the batch
         (the ladder walks down from it) and S on the card (the CPU smoke
         configuration ignores them); PADDLE_TPU_BENCH_RECOMPUTE=1 builds
         the step with per-layer recompute checkpoints.
  mnist  MLP 784-1024-1024-10 with relu and softmax, cross-entropy,
         Momentum(0.01, 0.9), batch 256, 60 steps.
  resnet ResNet-50 ImageNet training step (1000 classes, 224×224 images
         from ``rand``, labels from ``randint(0, 1000)``),
         FLAGS_use_bf16_matmul on (bf16 convolutions), Momentum(0.1,
         0.9), batch 64 with the OOM ladder 64/32/16, 10 steps.
  transformer
         bench.py's bench_allreduce_dp at one device: the WMT Transformer
         training step at transformer_big's widths (d_model 1024, d_inner
         4096, 16 heads) with vocab 4096, 2 + 2 layers, dropout 0,
         FLAGS_use_bf16_matmul on, Adam lr 1e-4, batch 8 at S = 64, random
         ids and all-ones masks, 10 steps timed after a warm window of 3.
  wide_deep
         Wide&Deep CTR training (13 dense features, 26 slots of 1e6 ids,
         embeddings of 16, hidden 400-400-400, Adam lr 1e-3) with the
         streaming AUC in the program, batch 4096, one feed from
         ``ctr_reader(4096, seed=0)``: a warm window of 5 steps, then 20
         timed steps (the block runs segmented: a window is a host loop
         of single steps, its auc island acting every step).

  longctx
         the single-card half of bench.py's bench_longctx (:1653-1700):
         causal bf16 attention at B = 1, H = 12, S = Sk = 8192, D = 64,
         forward and backward through ``flash_attention``'s autograd
         function (on the card the streamed kernels: 64 key tiles of
         128, the masked half of the tiles skipped), the loss the sum
         of O² in f32 plus the squared grads; q, k, v from
         ``RandomState(0).randn · 0.3``. 8 fwd+bwd steps timed after 2,
         CUDA events around them. Its line is bench.py's (``metric``
         longctx_attention_tokens_per_sec, ``value`` in tokens/s,
         ``seq_len``, ``heads``, ``head_dim``, ``mode``
         flash_causal_1card, ``devices`` 1, ``step_ms``,
         ``attn_tflops``: bench.py's 4·B·H·S²·D / 2 · 3.5 = 360.8 GFLOP
         a step) with ``loss``, ``device`` and, on the card,
         ``bound_ms`` (that count at 989 TFLOP/s of dense bf16: 0.365
         ms). bench.py's CPU half,
         ring attention over 8 devices, is ROADMAP A8; ``--device cpu``
         runs the plain versions at S = 384, H = 2.

The real-data lanes (bench.py:173-437, ``_realdata_pair``) train on
distinct batches fed by ``fluid.DataLoader.from_generator``, one full pass
timed as one ``Executor.run`` a batch (``loop``) and as one
``Executor.run(n_steps=8)`` a ``DataLoader.window(8)`` (``scan_realdata``,
the next window copied to the card while this one computes), each after
two warm runs; ``parity_ok``: the first window's losses within 1e-4 of 8
single runs.

  mnist_realdata
         MLP 784-256-256-10, Momentum(0.01, 0.9), batch 64, 64 batches.
  mnist_guard
         the mnist_realdata window pass with FLAGS_check_nan_inf off and
         on (skip), best of 3 each; ``guard_overhead_pct``, and
         ``parity_ok``: the first window's losses bitwise alike.
  wide_deep_realdata
         Wide&Deep without the AUC (the block compiles whole), 26 slots of
         1e5 ids (1e4 on the CPU), hidden 64-64, Adam lr 1e-3, batch 256,
         32 batches.

Their lines are bench.py's (``metric``, ``value`` in samples/s of the
scan pass, ``loop_samples_per_sec``, ``speedup_vs_loop``,
``executor_mode``, ``parity_ok``, ...) with ``device`` and, on the card,
``power_limit``.

The lanes run on the card (``cuda``); ``--device cpu`` runs them on the
CPU, the bert lane at bench.py's CPU smoke configuration (2 layers, hidden
256, 4 heads, ffn 1024, batch 8, S=64, 3 steps), the resnet lane at its
own (batch 8, image 64, 3 steps), the transformer lane at its own
(d_model 128, d_inner 256, 4 heads, batch 2, S = 16), the wide_deep lane
at bench.py's (batch 256, 5 steps). Without a card and
without ``--device cpu`` the lane fails: nothing falls back to the CPU.

Keys of the line: ``metric``, ``value`` (samples/s), ``unit``,
``vs_baseline``, ``batch``, ``steps``, ``step_ms``, ``device``,
``executor_mode``, ``timed_window`` (the timed window's eager runs,
captures and replays), ``loss`` (its last step's) and, for bert,
``seq_len`` and ``recompute``, for resnet ``image_size``. The transformer
lane's line is bench.py's (``metric`` fleet_dp_step_ms_transformer_big,
``value`` in ms/step, ``devices`` 1, ``batch``) with ``samples_per_sec``,
``seq_len`` and the keys above. The wide_deep lane's is bench.py's
(``metric`` wide_deep_ctr_samples_per_sec_per_chip, ``batch``,
``embedding_params``, ``compiled_metric``: true when the segmented path
ran, ``executor_mode``, ``auc``: the final step's) with the keys above
(``timed_window`` also counts island runs). On the card
also ``power_limit`` (as nvidia-smi reports the card's name and power
limit) and ``peak_memory_gib`` (``torch.cuda.max_memory_allocated``), and
for bert, resnet and transformer ``mfu_vs_h100_bf16_peak``: bench.py's
FLOP count (bert: 6·N·tokens + attention; resnet: 3 · 3.8 GFLOP a 224×224
sample, scaled with the pixels; transformer: ``transformer_flops_per_step``)
over the H100's 989 TFLOP/s of dense bf16. A
failure prints bench.py's error form (``<lane>_error``) and exits with 1.

``run_bert_base``, ``run_mnist_mlp``, ``run_resnet50``,
``run_transformer`` and ``run_wide_deep`` run a lane and
return a ``Lane``: the result with the executor, scope, program, feed and
fetches it ran, for a caller that looks further into the run;
``Lane.close()`` frees the card. ``bench_bert_base``, ``bench_mnist_mlp``,
``bench_resnet50``, ``bench_transformer`` and ``bench_wide_deep`` return
the result alone.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import NamedTuple

import numpy as np

H100_BF16_PEAK_FLOPS = 989e12  # dense bf16, H100 SXM (published)
BERT_CPU_SMOKE = dict(layers=2, hidden=256, heads=4, ffn=1024)

def _free(exe=None):
    """Close ``exe`` (its graphs, memory pool and cached feeds) and
    return the card's memory."""
    if exe is not None:
        exe.close()
    gc.collect()
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Lane(NamedTuple):
    """A lane's result and what it ran: the executor (its compiled block
    holds the graph), the scope, the program, the feed and the fetches."""
    res: dict
    exe: object
    scope: object
    main: object
    feed: dict
    fetches: list

    def close(self):
        _free(self.exe)


def _card():
    """(name, power limit) as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return name, limit


def _timed_steps(exe, main, feed, fetch_list, steps, scope, warmup=None):
    """bench.py's harness: a warm window of ``warmup`` steps (default
    ``steps``), then the timed one of ``steps``, each ONE
    Executor.run(n_steps=...); the clock stops after the timed window's
    last loss is on the host. A segmented block runs a window as a host
    loop of single steps, each with its islands: bench.py's per-step
    loop less Executor.run's front end on every step after the first. → (seconds, the timed window's
    eager/capture/replay counts and, for a segmented block, island runs,
    its last loss)."""
    from .fluid import core
    core.set_flag("FLAGS_feed_device_cache", True)
    exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope,
            return_numpy=False, n_steps=steps if warmup is None else warmup)
    blocks = list(exe._compiled_cache.values())
    before = [dict(cb.stats) for cb in blocks]
    if exe.device.type == "cuda":
        import torch
        torch.cuda.synchronize(exe.device)
    t0 = time.perf_counter()
    out = exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope,
                  return_numpy=False, n_steps=steps)
    loss = float(out[0].numpy().ravel()[-1])  # the one copy to the host
    dt = time.perf_counter() - t0
    # a timed window that ran another block than the warm one's shows no
    # runs here
    keys = ("eager", "captures", "replays") + (
        ("islands",) if any("islands" in b for b in before) else ())
    window = {k: sum(cb.stats.get(k, 0) - b.get(k, 0)
                     for cb, b in zip(blocks, before)) for k in keys}
    return dt, window, loss


def _is_oom(e) -> bool:
    import torch
    return isinstance(e, torch.cuda.OutOfMemoryError) \
        or "out of memory" in str(e)


def _run_lane(name, build, feed_of, batches, steps, device, warmup=None):
    """Run ``steps``-step windows at the first
    batch of ``batches`` that fits (bench.py's OOM ladder): on an OOM the
    executor's graphs, memory pool and cached feeds and the scope are
    dropped and the cache emptied before the next rung. → (batch,
    seconds, timed window, loss, peak bytes or None, (exe, scope, main,
    feed, fetches))."""
    import torch
    from . import fluid
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host: the lanes "
                           "run on the card, or on the CPU with --device "
                           "cpu")
    cuda = device != "cpu"
    main, startup, fetches = build()
    last_err = None
    for i, b in enumerate(batches):
        _free()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        exe = fluid.Executor(fluid.CUDAPlace(0) if cuda else fluid.CPUPlace())
        scope = fluid.Scope()
        feed = feed_of(b)
        try:
            exe.run(startup, scope=scope)
            dt, window, loss = _timed_steps(exe, main, feed, fetches,
                                            steps, scope, warmup)
        except Exception as e:  # noqa: BLE001 — the ladder's own test
            exe.close()
            del exe, scope
            if not _is_oom(e):
                raise
            last_err = e
            if i + 1 < len(batches):
                print(f"{name}: batch {b} OOM, retrying at {batches[i + 1]}",
                      file=sys.stderr)
            continue
        peak = torch.cuda.max_memory_allocated() if cuda else None
        return b, dt, window, loss, peak, (exe, scope, main, feed, fetches)
    _free()
    raise last_err


def _result(metric, batch, steps, dt, window, loss, peak, exe_mode,
            device):
    res = {"metric": metric, "value": round(batch * steps / dt, 2),
           "unit": "samples/s", "vs_baseline": 1.0, "batch": batch,
           "steps": steps, "step_ms": round(dt / steps * 1e3, 3),
           "executor_mode": exe_mode, "timed_window": window,
           "loss": loss}
    if device == "cpu":
        res["device"] = "cpu"
    else:
        res["device"], res["power_limit"] = _card()
        res["peak_memory_gib"] = round(peak / 2 ** 30, 3)
    return res


def run_mnist_mlp(batch=256, steps=60, device="cuda") -> Lane:
    """bench.py's mnist lane."""
    from . import fluid

    def build():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.data("img", shape=[784], dtype="float32")
            label = fluid.data("label", shape=[1], dtype="int64")
            h = fluid.layers.fc(img, 1024, act="relu")
            h = fluid.layers.fc(h, 1024, act="relu")
            pred = fluid.layers.fc(h, 10, act="softmax")
            loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
            fluid.optimizer.Momentum(0.01, momentum=0.9).minimize(loss)
        return main, startup, [loss]

    rng = np.random.RandomState(0)
    X = rng.rand(batch, 784).astype("float32")
    Y = rng.randint(0, 10, (batch, 1)).astype("int64")
    batch, dt, window, loss, peak, ran = _run_lane(
        "mnist", build, lambda b: {"img": X, "label": Y}, (batch,), steps,
        device)
    return Lane(_result("mnist_mlp_samples_per_sec", batch, steps, dt,
                        window, loss, peak, ran[0]._last_run_mode, device),
                *ran)


def bert_flops_per_sample(cfg, seq_len):
    """bench.py's count: 6·N·S for the transformer's N parameters (no
    embeddings), plus the attention scores' 12·L·S²·H, forward and
    backward."""
    h, L, f = cfg["hidden"], cfg["layers"], cfg["ffn"]
    n_params = L * (4 * h * h + 2 * h * f)
    return 6 * n_params * seq_len + 12 * L * seq_len * seq_len * h


def run_bert_base(batch=256, seq_len=128, steps=20, device="cuda") -> Lane:
    """bench.py's bert lane (bench.py:463-527), with its environment
    switches (bench.py:481-488)."""
    from .fluid import core
    from .models import bert

    cfg = bert.bert_base_config()
    smoke = device == "cpu"
    if smoke:  # bench.py's CPU configuration: the path, not the number
        cfg.update(BERT_CPU_SMOKE)
        batch, seq_len, steps = 8, 64, 3
    else:
        batch = int(os.environ.get("PADDLE_TPU_BENCH_BATCH", batch))
        seq_len = int(os.environ.get("PADDLE_TPU_BENCH_SEQ", seq_len))
    recompute = os.environ.get("PADDLE_TPU_BENCH_RECOMPUTE") == "1"
    core.set_flag("FLAGS_use_bf16_matmul", True)  # bf16 tensor cores

    def build():
        from . import fluid
        with fluid.unique_name.guard():
            main, startup, _, fetches = bert.build_bert_pretrain_program(
                cfg, seq_len=seq_len, dropout=0.0, lr=1e-4,
                recompute=recompute)
        return main, startup, fetches

    rng = np.random.RandomState(0)

    def feed_of(b):
        n_mask = max(1, int(b * seq_len * 0.15))
        return {
            "src_ids": rng.randint(0, cfg["vocab_size"],
                                   (b, seq_len)).astype("int64"),
            "pos_ids": np.tile(np.arange(seq_len), (b, 1)).astype("int64"),
            "sent_ids": np.zeros((b, seq_len), "int64"),
            "mask_pos": rng.randint(0, b * seq_len,
                                    (n_mask, 1)).astype("int64"),
            "mask_label": rng.randint(0, cfg["vocab_size"],
                                      (n_mask, 1)).astype("int64"),
        }

    try:
        batch, dt, window, loss, peak, ran = _run_lane(
            "bert", build, feed_of,
            (batch, batch // 2, batch // 4, batch // 8), steps, device)
    finally:
        core.set_flag("FLAGS_use_bf16_matmul", False)
    res = _result("bert_base_samples_per_sec_per_chip", batch, steps, dt,
                  window, loss, peak, ran[0]._last_run_mode, device)
    res["seq_len"] = seq_len
    res["recompute"] = recompute
    if smoke:
        res["cpu_smoke"] = True
    else:
        res["mfu_vs_h100_bf16_peak"] = round(
            res["value"] * bert_flops_per_sample(cfg, seq_len)
            / H100_BF16_PEAK_FLOPS, 4)
    return Lane(res, *ran)


def resnet50_flops_per_sample(image_size):
    """bench.py's count: ~3.8 GFLOP forward a 224×224 sample, scaled with
    the pixels; ×3 for forward and backward."""
    return 3 * 3.8e9 * (image_size / 224.0) ** 2


def run_resnet50(batch=64, image_size=224, steps=10,
                 device="cuda") -> Lane:
    """bench.py's resnet lane (bench.py:530-565)."""
    from .fluid import core
    from .models.resnet import build_resnet_train_program

    smoke = device == "cpu"
    if smoke:  # bench.py's CPU configuration: the path, not the number
        batch, image_size, steps = 8, 64, 3
    core.set_flag("FLAGS_use_bf16_matmul", True)  # bf16 convolutions

    def build():
        from . import fluid
        with fluid.unique_name.guard():
            main, startup, _, fetches = build_resnet_train_program(
                depth=50, class_dim=1000, image_size=image_size)
        return main, startup, fetches[:1]

    rng = np.random.RandomState(0)

    def feed_of(b):
        return {"image": rng.rand(b, 3, image_size,
                                  image_size).astype("float32"),
                "label": rng.randint(0, 1000, (b, 1)).astype("int64")}

    try:
        batch, dt, window, loss, peak, ran = _run_lane(
            "resnet", build, feed_of, (batch, batch // 2, batch // 4),
            steps, device)
    finally:
        core.set_flag("FLAGS_use_bf16_matmul", False)
    res = _result("resnet50_samples_per_sec_per_chip", batch, steps, dt,
                  window, loss, peak, ran[0]._last_run_mode, device)
    res["image_size"] = image_size
    if smoke:
        res["cpu_smoke"] = True
    else:
        res["mfu_vs_h100_bf16_peak"] = round(
            res["value"] * resnet50_flops_per_sample(image_size)
            / H100_BF16_PEAK_FLOPS, 4)
    return Lane(res, *ran)


def transformer_flops_per_step(cfg, batch, src_len, trg_len):
    """FLOPs of one training step of the WMT Transformer, counted from the
    program's shapes: every GEMM at 2 FLOP a multiply-add (the Q, K, V
    and output projections, the FFN's two, the vocabulary projection)
    plus the attention's two products, 4·B·H·S·Sk·D a forward (causal
    attention counted whole), and ×3 for the forward and backward."""
    d, f, v = cfg["d_model"], cfg["d_inner"], cfg["trg_vocab"]
    ts, tt = batch * src_len, batch * trg_len
    enc = 8 * d * d * ts + 4 * d * f * ts + 4 * batch * src_len ** 2 * d
    dec = (8 * d * d * tt + 4 * batch * trg_len ** 2 * d  # self-attention
           + 4 * d * d * tt + 4 * d * d * ts             # cross: Q, O; K, V
           + 4 * batch * trg_len * src_len * d
           + 4 * d * f * tt)
    fwd = (cfg["enc_layers"] * enc + cfg["dec_layers"] * dec
           + 2 * d * v * tt)
    return 3 * fwd


def run_transformer(batch=8, seq_len=64, steps=10, warmup=3,
                    device="cuda") -> Lane:
    """bench.py's bench_allreduce_dp lane (bench.py:568-609) at one
    device."""
    from .fluid import core
    from .models import transformer

    cfg = transformer.transformer_big_config()
    cfg.update(src_vocab=4096, trg_vocab=4096, enc_layers=2, dec_layers=2,
               dropout=0.0)
    smoke = device == "cpu"
    if smoke:  # bench.py's CPU configuration: the path, not the number
        cfg.update(d_model=128, d_inner=256, heads=4)
        batch, seq_len = 2, 16
    core.set_flag("FLAGS_use_bf16_matmul", True)  # bf16 tensor cores

    def build():
        from . import fluid
        with fluid.unique_name.guard():
            main, startup, _, loss = transformer.build_wmt_train_program(
                cfg, src_len=seq_len, trg_len=seq_len, lr=1e-4)
        return main, startup, [loss]

    rng = np.random.RandomState(0)

    def feed_of(b):
        sv, tv = cfg["src_vocab"], cfg["trg_vocab"]
        return {
            "src_ids": rng.randint(0, sv, (b, seq_len)).astype("int64"),
            "src_mask": np.ones((b, seq_len), "float32"),
            "trg_ids": rng.randint(0, tv, (b, seq_len)).astype("int64"),
            "trg_mask": np.ones((b, seq_len), "float32"),
            "labels": rng.randint(0, tv, (b, seq_len, 1)).astype("int64"),
        }

    try:
        batch, dt, window, loss, peak, ran = _run_lane(
            "transformer", build, feed_of, (batch,), steps, device, warmup)
    finally:
        core.set_flag("FLAGS_use_bf16_matmul", False)
    res = _result("fleet_dp_step_ms_transformer_big", batch, steps, dt,
                  window, loss, peak, ran[0]._last_run_mode, device)
    res["samples_per_sec"] = res["value"]
    res.update(value=res["step_ms"], unit="ms/step", devices=1,
               seq_len=seq_len)
    if smoke:
        res["cpu_smoke"] = True
    else:
        res["mfu_vs_h100_bf16_peak"] = round(
            transformer_flops_per_step(cfg, batch, seq_len, seq_len)
            / (dt / steps) / H100_BF16_PEAK_FLOPS, 4)
    return Lane(res, *ran)


WIDE_DEEP = dict(num_dense=13, num_slots=26, embedding_dim=16,
                 hidden=(400, 400, 400), lr=1e-3)  # bench.py's widths


def run_wide_deep(batch=4096, steps=20, warmup=5, sparse_dim=int(1e6),
                  device="cuda") -> Lane:
    """bench.py's wide_deep lane (bench.py:611-652): ``sparse_dim`` ids a
    slot (1e6 there). The reported AUC is the final step's, swept from
    the histograms it left (the fetched value to the bit)."""
    from .models import wide_deep
    from .utils.metrics import auc_from_histograms

    if device == "cpu":  # bench.py's CPU configuration
        batch, steps = 256, 5

    def build():
        from . import fluid
        with fluid.unique_name.guard():
            main, startup, _, loss, auc = \
                wide_deep.build_wide_deep_program(sparse_dim=sparse_dim,
                                                  **WIDE_DEEP)
        return main, startup, [loss, auc]

    def feed_of(b):
        return wide_deep.ctr_reader(b, num_dense=WIDE_DEEP["num_dense"],
                                    num_slots=WIDE_DEEP["num_slots"],
                                    sparse_dim=sparse_dim, seed=0)()

    batch, dt, window, loss, peak, ran = _run_lane(
        "wide_deep", build, feed_of, (batch,), steps, device, warmup)
    res = _result("wide_deep_ctr_samples_per_sec_per_chip", batch, steps,
                  dt, window, loss, peak, ran[0]._last_run_mode, device)
    exe, scope, main = ran[:3]
    auc_op = next(op for op in main.global_block().ops if op.type == "auc")
    hist = [scope.find_var(auc_op.output(s)[0]).value().array.cpu()
            for s in ("StatPosOut", "StatNegOut")]
    n = WIDE_DEEP["num_slots"] * sparse_dim
    res.update(embedding_params=n * WIDE_DEEP["embedding_dim"] + n,
               compiled_metric=exe._last_run_mode == "segmented",
               auc=round(auc_from_histograms(*hist), 4))
    if device == "cpu":
        res["cpu_smoke"] = True
    return Lane(res, *ran)


def bench_bert_base(**kw) -> dict:
    """``run_bert_base``'s result line, the card freed."""
    lane = run_bert_base(**kw)
    lane.close()
    return lane.res


def bench_mnist_mlp(**kw) -> dict:
    """``run_mnist_mlp``'s result line, the card freed."""
    lane = run_mnist_mlp(**kw)
    lane.close()
    return lane.res

def bench_resnet50(**kw) -> dict:
    """``run_resnet50``'s result line, the card freed."""
    lane = run_resnet50(**kw)
    lane.close()
    return lane.res


def bench_transformer(**kw) -> dict:
    """``run_transformer``'s result line, the card freed."""
    lane = run_transformer(**kw)
    lane.close()
    return lane.res


def bench_wide_deep(**kw) -> dict:
    """``run_wide_deep``'s result line, the card freed."""
    lane = run_wide_deep(**kw)
    lane.close()
    return lane.res


# ---------------------------------------------------------------------------
# the long-context attention lane (bench.py:1653-1700, its one-card half)
LONGCTX = dict(batch=1, heads=12, seq_len=8192, head_dim=64)
LONGCTX_CPU = dict(batch=1, heads=2, seq_len=384, head_dim=64)


def longctx_flops(batch, heads, seq_len, head_dim) -> float:
    """bench.py's count for a causal fwd+bwd: 4·B·H·S²·D FLOP of the
    dense forward, halved for the mask, × 3.5 for the backward."""
    return 4.0 * batch * heads * seq_len * seq_len * head_dim / 2.0 * 3.5


def longctx_inputs(batch, heads, seq_len, head_dim, device):
    """q, k, v [B, H, S, D] in bf16 from ``RandomState(0).randn · 0.3``
    (bench.py's draw, one array after the other)."""
    import torch
    rng = np.random.RandomState(0)
    return tuple(
        torch.from_numpy(rng.randn(batch, heads, seq_len, head_dim) * 0.3)
        .to(device=device, dtype=torch.bfloat16) for _ in range(3))


def longctx_step(q, k, v):
    """One step of the lane: causal attention of leaves q, k, v through
    ``flash_attention``, the loss sum(O²) in f32, its grads by autograd,
    → (loss + Σ sum(g²) in f32, loss, (dq, dk, dv))."""
    import torch
    from .ops.cuda.flash_attention import flash_attention
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    sm = 1.0 / math.sqrt(q.shape[-1])
    with torch.enable_grad():
        loss = (flash_attention(q, k, v, sm, causal=True)
                .to(torch.float32) ** 2).sum()
        grads = torch.autograd.grad(loss, (q, k, v))
    total = loss.detach() + sum((g.to(torch.float32) ** 2).sum()
                                for g in grads)
    return total, loss.detach(), grads


def bench_longctx(iters=8, warmup=2, device="cuda") -> dict:
    """The longctx lane's line (module docstring)."""
    import torch
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host: the lanes "
                           "run on the card, or on the CPU with --device "
                           "cpu")
    shape = LONGCTX if device != "cpu" else LONGCTX_CPU
    dev = torch.device("cuda", 0) if device != "cpu" else torch.device("cpu")
    q, k, v = longctx_inputs(device=dev, **shape)
    for _ in range(warmup):
        total = longctx_step(q, k, v)[0]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(iters):
            total = longctx_step(q, k, v)[0]
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            total = longctx_step(q, k, v)[0]
        ms = (time.perf_counter() - t0) * 1e3 / iters
    flops = longctx_flops(**shape)
    B, S = shape["batch"], shape["seq_len"]
    res = {"metric": "longctx_attention_tokens_per_sec",
           "value": round(B * S / (ms / 1e3), 1), "unit": "tokens/s",
           "vs_baseline": 1.0, "seq_len": S, "heads": shape["heads"],
           "head_dim": shape["head_dim"], "mode": "flash_causal_1card",
           "devices": 1, "step_ms": round(ms, 4),
           "attn_tflops": round(flops / (ms / 1e3) / 1e12, 3),
           "loss": float(total)}
    if device == "cpu":
        res["device"] = "cpu"
    else:
        res["bound_ms"] = round(flops / H100_BF16_PEAK_FLOPS * 1e3, 4)
        res["device"], res["power_limit"] = _card()
    return res


# ---------------------------------------------------------------------------
# the real-data lanes: distinct batches through the DataLoader
# ---------------------------------------------------------------------------
def _realdata_pair(build_fn, batches, k, device, warmup=2):
    """bench.py's ``_realdata_pair`` (bench.py:173): one full pass over
    ``batches`` (all distinct) two ways, each from a fresh program and
    scope fed by ``DataLoader.from_generator`` —

      loop           one ``Executor.run`` a batch
      scan_realdata  ``DataLoader.window(k)`` stacks k batches and copies
                     the next window to the device while this one
                     computes; one ``Executor.run(n_steps=k)`` a window

    and the first window's k losses against k single runs (fresh
    programs, same seed). → the seconds, steps and run modes of both, and
    the parity."""
    from . import fluid
    cuda = device != "cpu"
    if cuda:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available on this host: the "
                               "lanes run on the card, or on the CPU with "
                               "--device cpu")
    place = fluid.CUDAPlace(0) if cuda else fluid.CPUPlace()
    n = len(batches)

    def loader_of():
        dl = fluid.DataLoader.from_generator(capacity=4)
        dl.set_batch_generator(lambda: iter(batches), places=place)
        return dl

    def fresh():
        main, startup, fetch_list = build_fn()
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)
        return main, fetch_list, exe, scope

    def timed_pass(windowed):
        """Warm both keys (the first run's and the second's) as the timed
        pass runs them, then time one pass to the last loss on the
        host."""
        main, fetch_list, exe, scope = fresh()

        def source():
            return (loader_of().window(k, drop_last=True) if windowed
                    else loader_of())
        for b, _ in zip(source(), range(max(1, warmup))):
            exe.run(main, feed=b, fetch_list=fetch_list, scope=scope,
                    return_numpy=False)
        t0 = time.perf_counter()
        for b in source():
            out = exe.run(main, feed=b, fetch_list=fetch_list, scope=scope,
                          return_numpy=False)
        float(out[0].numpy().ravel()[-1])  # the sync
        dt = time.perf_counter() - t0
        mode = exe._last_run_mode
        _free(exe)
        return dt, mode

    loop_dt, loop_mode = timed_pass(False)
    scan_dt, scan_mode = timed_pass(True)
    wfeed = {name: np.stack([np.asarray(b[name]) for b in batches[:k]])
             for name in batches[0]}

    def first_losses(windowed):
        main, fetch_list, exe, scope = fresh()
        if windowed:
            (l,) = exe.run(main, feed=wfeed, fetch_list=fetch_list[:1],
                           scope=scope, n_steps=k)
            got = np.asarray(l).ravel()
        else:
            got = np.asarray([float(np.asarray(exe.run(
                main, feed=b, fetch_list=fetch_list[:1],
                scope=scope)[0]).ravel()[0]) for b in batches[:k]])
        _free(exe)
        return got

    diff = float(np.max(np.abs(first_losses(True) - first_losses(False))))
    return {"loop_dt": loop_dt, "scan_dt": scan_dt,
            "loop_steps": n, "scan_steps": (n // k) * k,
            "loop_mode": loop_mode, "scan_mode": scan_mode,
            "parity_max_diff": diff, "parity_ok": diff < 1e-4}


def _realdata_result(metric, batch, k, r, device, **extra):
    res = {"metric": metric,
           "value": round(batch * r["scan_steps"] / r["scan_dt"], 1),
           "unit": "samples/s", "vs_baseline": 1.0,
           "mode": "scan_realdata", "window": k, "batch": batch, **extra,
           "loop_samples_per_sec":
               round(batch * r["loop_steps"] / r["loop_dt"], 1),
           "speedup_vs_loop":
               round((batch * r["scan_steps"] / r["scan_dt"])
                     / (batch * r["loop_steps"] / r["loop_dt"]), 3),
           "executor_mode": r["scan_mode"],
           "parity_ok": r["parity_ok"],
           "parity_max_diff": r["parity_max_diff"]}
    _device_keys(res, device)
    return res


def _device_keys(res, device):
    if device == "cpu":
        res["device"] = "cpu"
    else:
        res["device"], res["power_limit"] = _card()


def _mnist_realdata_build(hidden):
    """bench.py's realdata MLP: 784-hidden-hidden-10, relu, softmax,
    cross-entropy, Momentum(0.01, 0.9), seed 5."""
    from . import fluid

    def build():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 5
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.data("img", shape=[784], dtype="float32")
            label = fluid.data("label", shape=[1], dtype="int64")
            h = fluid.layers.fc(img, hidden, act="relu")
            h = fluid.layers.fc(h, hidden, act="relu")
            pred = fluid.layers.fc(h, 10, act="softmax")
            loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
            fluid.optimizer.Momentum(0.01, momentum=0.9).minimize(loss)
        return main, startup, [loss]
    return build


def _mnist_batches(batch, n_batches):
    rng = np.random.RandomState(0)
    return [{"img": rng.rand(batch, 784).astype("float32"),
             "label": rng.randint(0, 10, (batch, 1)).astype("int64")}
            for _ in range(n_batches)]


def bench_mnist_realdata(batch=64, hidden=256, n_batches=64, k=8,
                         device="cuda") -> dict:
    """bench.py's mnist_realdata lane (bench.py:265): the MLP trained on
    ``n_batches`` distinct batches, a window of ``k`` a run, beside one
    run a batch."""
    r = _realdata_pair(_mnist_realdata_build(hidden),
                       _mnist_batches(batch, n_batches), k, device)
    return _realdata_result("mnist_mlp_realdata_samples_per_sec", batch, k,
                            r, device, hidden=hidden,
                            distinct_batches=n_batches)


def bench_mnist_realdata_guard(batch=64, hidden=256, n_batches=64, k=8,
                               repeats=3, device="cuda") -> dict:
    """bench.py's mnist_guard lane (bench.py:307): the windowed
    mnist_realdata pass with the numeric guard off and then on
    (``FLAGS_check_nan_inf``, action ``skip``), the best of ``repeats``
    passes each; the first window's losses bitwise alike."""
    from . import fluid
    from .fluid import core
    if n_batches < k:
        raise ValueError(
            f"mnist_guard needs n_batches >= window k "
            f"({n_batches} < {k}): drop_last windows would yield "
            f"nothing to time")
    build = _mnist_realdata_build(hidden)
    batches = _mnist_batches(batch, n_batches)
    place = fluid.CUDAPlace(0) if device != "cpu" else fluid.CPUPlace()

    def scan_pass():
        """One timed pass over the windowed loader (a fresh program and
        scope, both keys warm). → (seconds, the first window's losses)."""
        main, startup, fetch_list = build()
        exe, scope = fluid.Executor(place), fluid.Scope()
        exe.run(startup, scope=scope)

        def windows():
            dl = fluid.DataLoader.from_generator(capacity=4)
            dl.set_batch_generator(lambda: iter(batches), places=place)
            return dl.window(k, drop_last=True)
        for w, _ in zip(windows(), range(2)):
            first = exe.run(main, feed=w, fetch_list=fetch_list,
                            scope=scope, return_numpy=False)
        first_losses = first[0].numpy().ravel().copy()
        t0 = time.perf_counter()
        for w in windows():
            out = exe.run(main, feed=w, fetch_list=fetch_list, scope=scope,
                          return_numpy=False)
        float(out[0].numpy().ravel()[-1])  # the sync
        dt = time.perf_counter() - t0
        _free(exe)
        return dt, first_losses

    def lane():
        return min((scan_pass() for _ in range(repeats)), key=lambda r: r[0])

    saved = (core.globals_["FLAGS_check_nan_inf"],
             core.globals_["FLAGS_nan_inf_action"])
    try:
        core.set_flag("FLAGS_check_nan_inf", False)
        off_dt, off_losses = lane()
        core.set_flag("FLAGS_check_nan_inf", True)
        core.set_flag("FLAGS_nan_inf_action", "skip")
        on_dt, on_losses = lane()
    finally:
        core.set_flag("FLAGS_check_nan_inf", saved[0])
        core.set_flag("FLAGS_nan_inf_action", saved[1])
    steps = (n_batches // k) * k
    off_sps = batch * steps / off_dt
    on_sps = batch * steps / on_dt
    res = {"metric": "mnist_realdata_guard_samples_per_sec",
           "value": round(on_sps, 1), "unit": "samples/s",
           "vs_baseline": 1.0, "mode": "scan_realdata", "window": k,
           "batch": batch, "hidden": hidden,
           "guard": "skip", "guard_off_samples_per_sec": round(off_sps, 1),
           "guard_overhead_pct": round((off_sps / on_sps - 1.0) * 100, 2),
           "best_of": repeats,
           "parity_ok": bool(np.array_equal(off_losses, on_losses))}
    _device_keys(res, device)
    return res


def bench_wide_deep_realdata(batch=256, n_batches=32, k=8,
                             sparse_dim=int(1e5), device="cuda") -> dict:
    """bench.py's wide_deep_realdata lane (bench.py:402): Wide&Deep
    without the AUC (the block compiles whole, so a window is one
    compiled run), 26 slots of ``sparse_dim`` ids, hidden 64-64, on
    ``n_batches`` distinct ``ctr_reader`` batches. On the CPU it runs at
    1e4 ids a slot (the path, not the number)."""
    from .models import wide_deep
    smoke = device == "cpu"
    if smoke:
        sparse_dim = int(1e4)

    def build():
        from . import fluid
        with fluid.unique_name.guard():
            main, startup, _, loss, _ = wide_deep.build_wide_deep_program(
                num_dense=13, num_slots=26, sparse_dim=sparse_dim,
                embedding_dim=16, hidden=(64, 64), lr=1e-3, with_auc=False)
        main.random_seed = startup.random_seed = 5
        return main, startup, [loss]

    nb = wide_deep.ctr_reader(batch, num_dense=13, num_slots=26,
                              sparse_dim=sparse_dim, seed=0)
    r = _realdata_pair(build, [nb() for _ in range(n_batches)], k, device)
    res = _realdata_result("wide_deep_realdata_samples_per_sec", batch, k,
                           r, device, distinct_batches=n_batches,
                           with_auc=False, sparse_dim=sparse_dim)
    if smoke:
        res["cpu_smoke"] = True
    return res


LANES = {"bert": bench_bert_base, "mnist": bench_mnist_mlp,
         "resnet": bench_resnet50, "transformer": bench_transformer,
         "wide_deep": bench_wide_deep,
         "mnist_realdata": bench_mnist_realdata,
         "mnist_guard": bench_mnist_realdata_guard,
         "wide_deep_realdata": bench_wide_deep_realdata,
         "longctx": bench_longctx}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m paddle_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("lane", nargs="?", default="bert", choices=sorted(LANES))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        res = LANES[args.lane](device=args.device)
        if not math.isfinite(res.get("loss", 0.0)):
            raise FloatingPointError(f"non-finite loss {res['loss']}")
    except Exception as e:  # noqa: BLE001 — the contract is one JSON line
        traceback.print_exc(file=sys.stderr)
        print(json.dumps({"metric": f"{args.lane}_error", "value": 0.0,
                          "unit": "error", "vs_baseline": 0.0,
                          "error": repr(e)[:500]}), flush=True)
        return 1
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
