"""The port's benchmark entry point; prints ONE JSON line:

    python3 -m paddle_tpu_torch.bench [bert|mnist|resnet] [--device cpu]

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

The lanes run on the card (``cuda``); ``--device cpu`` runs them on the
CPU, the bert lane at bench.py's CPU smoke configuration (2 layers, hidden
256, 4 heads, ffn 1024, batch 8, S=64, 3 steps), the resnet lane at its
own (batch 8, image 64, 3 steps). Without a card and without ``--device
cpu`` the lane fails: nothing falls back to the CPU.

Keys of the line: ``metric``, ``value`` (samples/s), ``unit``,
``vs_baseline``, ``batch``, ``steps``, ``step_ms``, ``device``,
``executor_mode``, ``timed_window`` (the timed window's eager runs,
captures and replays), ``loss`` (its last step's) and, for bert,
``seq_len`` and ``recompute``, for resnet ``image_size``. On the card
also ``power_limit`` (as nvidia-smi reports the card's name and power
limit) and ``peak_memory_gib`` (``torch.cuda.max_memory_allocated``), and
for bert and resnet ``mfu_vs_h100_bf16_peak``: bench.py's FLOP count
(bert: 6·N·tokens + attention; resnet: 3 · 3.8 GFLOP a 224×224 sample,
scaled with the pixels) over the H100's 989 TFLOP/s of dense bf16. A
failure prints bench.py's error form (``<lane>_error``) and exits with 1.

``run_bert_base``, ``run_mnist_mlp`` and ``run_resnet50`` run a lane and
return a ``Lane``: the result with the executor, scope, program, feed and
fetches it ran, for a caller that looks further into the run;
``Lane.close()`` frees the card. ``bench_bert_base``, ``bench_mnist_mlp``
and ``bench_resnet50`` return the result alone.
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


def _timed_steps(exe, main, feed, fetch_list, steps, scope):
    """bench.py's harness: a warm window of ``steps`` steps, then the
    timed one, each ONE Executor.run(n_steps=steps); the clock stops after
    the timed window's last loss is on the host. → (seconds, the timed
    window's eager/capture/replay counts, its last loss)."""
    from .fluid import core
    core.set_flag("FLAGS_feed_device_cache", True)
    exe.run(main, feed=feed, fetch_list=fetch_list, scope=scope,
            return_numpy=False, n_steps=steps)
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
    window = {k: sum(cb.stats[k] - b[k] for cb, b in zip(blocks, before))
              for k in ("eager", "captures", "replays")}
    return dt, window, loss


def _is_oom(e) -> bool:
    import torch
    return isinstance(e, torch.cuda.OutOfMemoryError) \
        or "out of memory" in str(e)


def _run_lane(name, build, feed_of, batches, steps, device):
    """Run ``steps``-step windows at the first batch of ``batches`` that
    fits (bench.py's OOM ladder): on an OOM the executor's graphs, memory
    pool and cached feeds and the scope are dropped and the cache emptied
    before the next rung. → (batch, seconds, timed window, loss, peak
    bytes or None, (exe, scope, main, feed, fetches))."""
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
            dt, window, loss = _timed_steps(exe, main, feed, fetches, steps,
                                            scope)
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


LANES = {"bert": bench_bert_base, "mnist": bench_mnist_mlp,
         "resnet": bench_resnet50}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m paddle_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("lane", nargs="?", default="bert", choices=sorted(LANES))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        res = LANES[args.lane](device=args.device)
        if not math.isfinite(res["loss"]):
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
