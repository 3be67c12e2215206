"""The port's bench entry point, ``python -m paddle_tpu_torch.bench``, on
the CPU, in a subprocess that cannot import jax or paddle_tpu: each lane
with ``--device cpu`` prints one JSON line in bench.py's form with the
documented keys (the bert and resnet lanes at bench.py's CPU smoke
configurations);
without ``--device cpu`` on a host without CUDA it prints the lane's
error line and exits non-zero (the six lanes' entry points run in turn
in one process, with ``--device cpu`` and without). bench.py's switches of the bert lane
(PADDLE_TPU_BENCH_BATCH, _SEQ, _RECOMPUTE) reach its program and its feed,
and the line says whether it recomputes. What the lanes measure on the
card is chip_smoke.py's (its lane and remat phases)."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the entry point as ``python -m`` runs it, with jax and paddle_tpu made
# unimportable
RUN = ("import runpy, sys; sys.modules['jax'] = None; "
       "sys.modules['paddle_tpu'] = None; sys.argv = ['bench'] + "
       "sys.argv[1:]; runpy.run_module('paddle_tpu_torch.bench', "
       "run_name='__main__')")
KEYS = {"metric", "value", "unit", "vs_baseline", "batch", "steps",
        "step_ms", "device", "executor_mode", "timed_window", "loss"}


# each lane before ``--`` through the entry point in turn in one process,
# as ``python -m`` runs it with the arguments after ``--``, each followed
# by a line with its exit code
RUN_EACH = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['paddle_tpu'] = None\n"
            "cut = sys.argv.index('--')\n"
            "lanes, args = sys.argv[1:cut], sys.argv[cut + 1:]\n"
            "for lane in lanes:\n"
            "    sys.argv = ['bench', lane] + args\n"
            "    try:\n"
            "        runpy.run_module('paddle_tpu_torch.bench',"
            " run_name='__main__')\n"
            "        code = 0\n"
            "    except SystemExit as e:\n"
            "        code = e.code\n"
            "    print('rc', code, flush=True)\n")
LANES = ("bert", "mnist", "resnet", "mnist_realdata", "mnist_guard",
         "wide_deep_realdata")


def _bench_each(*args):
    """Each lane of LANES with ``args``, one after another in one process
    on a host without CUDA (the imports paid once): {lane: (exit code,
    its JSON line, the process's stderr)}."""
    env = dict(os.environ, OMP_NUM_THREADS="4", CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", RUN_EACH, *LANES, "--", *args],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    lines = p.stdout.strip().splitlines()
    assert p.returncode == 0 and len(lines) == 2 * len(LANES), \
        (p.stdout, p.stderr[-2000:])
    return {lane: (int(lines[2 * i + 1].split()[1]),
                   json.loads(lines[2 * i]), p.stderr)
            for i, lane in enumerate(LANES)}


@pytest.fixture(scope="module")
def no_card():
    return _bench_each()


@pytest.fixture(scope="module")
def on_the_cpu():
    return _bench_each("--device", "cpu")


def _bench(*args, **env_vars):
    env = dict(os.environ, OMP_NUM_THREADS="4", CUDA_VISIBLE_DEVICES="",
               **env_vars)
    p = subprocess.run([sys.executable, "-c", RUN, *args], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1, (p.stdout, p.stderr[-2000:])
    return p.returncode, json.loads(lines[0]), p.stderr


@pytest.mark.parametrize("lane,metric,batch", [
    ("bert", "bert_base_samples_per_sec_per_chip", 8),
    ("mnist", "mnist_mlp_samples_per_sec", 256),
    ("resnet", "resnet50_samples_per_sec_per_chip", 8)])
def test_lane_on_the_cpu(lane, metric, batch, on_the_cpu):
    rc, res, err = on_the_cpu[lane]
    assert rc == 0, err[-2000:]
    assert KEYS <= set(res), res
    assert res["metric"] == metric and res["unit"] == "samples/s"
    assert res["batch"] == batch and res["device"] == "cpu"
    assert res["value"] > 0 and res["executor_mode"] == "compiled"
    # the timed window: every step of it ran, eagerly on the CPU
    assert sum(res["timed_window"].values()) == res["steps"]
    # no device metric from a CPU run, and never the TPU's peak
    assert not {"mfu_vs_v5e_bf16_peak", "mfu_vs_h100_bf16_peak",
                "peak_memory_gib", "power_limit"} & set(res)
    if lane == "bert":
        assert res["seq_len"] == 64 and res["cpu_smoke"] is True
        assert res["steps"] == 3
    elif lane == "resnet":  # bench.py's CPU smoke: batch 8, image 64
        assert res["image_size"] == 64 and res["cpu_smoke"] is True
        assert res["steps"] == 3
    else:
        assert res["steps"] == 60


@pytest.mark.parametrize("lane", ["bert", "mnist", "resnet"])
def test_lane_without_a_card_fails(lane, no_card):
    rc, res, _ = no_card[lane]
    assert rc == 1
    assert res["metric"] == f"{lane}_error" and res["unit"] == "error"
    assert "CUDA is not available" in res["error"]


def test_bert_lane_recompute_on_the_cpu():
    """PADDLE_TPU_BENCH_RECOMPUTE=1 in the CPU smoke configuration: the
    lane trains through the remat plan and says so; the batch and S
    switches are the card's, ignored here as bench.py ignores them."""
    rc, res, err = _bench("bert", "--device", "cpu",
                          PADDLE_TPU_BENCH_RECOMPUTE="1",
                          PADDLE_TPU_BENCH_BATCH="4",
                          PADDLE_TPU_BENCH_SEQ="32")
    assert rc == 0, err[-2000:]
    assert res["recompute"] is True and res["cpu_smoke"] is True
    assert res["batch"] == 8 and res["seq_len"] == 64
    assert "not lowerable" not in err  # the plan engaged


@pytest.mark.parametrize("recompute", [False, True])
def test_bert_lane_switches_reach_the_program(monkeypatch, recompute):
    """On the card's path the switches set the first rung of the OOM
    ladder, the feed's S and the program's recompute; the lane's run is
    replaced by a stand-in that builds the program and the feed only."""
    from paddle_tpu_torch import bench
    monkeypatch.setenv("PADDLE_TPU_BENCH_BATCH", "48")
    monkeypatch.setenv("PADDLE_TPU_BENCH_SEQ", "64")
    monkeypatch.setenv("PADDLE_TPU_BENCH_RECOMPUTE",
                       "1" if recompute else "0")
    seen = {}

    class _Exe:
        _last_run_mode = "compiled"

    def run_lane(name, build, feed_of, batches, steps, device):
        main, startup, fetches = build()
        feed = feed_of(batches[0])
        seen.update(batches=batches, main=main, feed=feed)
        return (batches[0], 1.0, {"eager": 0, "captures": 0,
                                  "replays": steps}, 1.0, 2 ** 30,
                (_Exe(), None, main, feed, fetches))
    monkeypatch.setattr(bench, "_run_lane", run_lane)
    monkeypatch.setattr(bench, "_card", lambda: ("stand-in", "0 W"))
    res = bench.run_bert_base().res
    assert seen["batches"] == (48, 24, 12, 6)
    assert seen["feed"]["src_ids"].shape == (48, 64)
    assert res["batch"] == 48 and res["seq_len"] == 64
    assert res["recompute"] is recompute
    ckpts = getattr(seen["main"], "_recompute_opt", None)
    assert (ckpts is not None) is recompute
    if recompute:
        assert len(ckpts["checkpoints"]) == 11  # layers 1-11 of 12


@pytest.mark.parametrize("lane,metric,batch", [
    ("mnist_realdata", "mnist_mlp_realdata_samples_per_sec", 64),
    ("mnist_guard", "mnist_realdata_guard_samples_per_sec", 64),
    ("wide_deep_realdata", "wide_deep_realdata_samples_per_sec", 256)])
def test_realdata_lane_on_the_cpu(lane, metric, batch, on_the_cpu):
    """bench.py's real-data lanes (bench.py:265, :307, :402) on the CPU:
    one JSON line in bench.py's form, a window of 8 whose losses agree
    with 8 single runs (mnist_guard: guard off and on bitwise alike), and
    no device metric."""
    rc, res, err = on_the_cpu[lane]
    assert rc == 0, err[-2000:]
    assert res["metric"] == metric and res["unit"] == "samples/s"
    assert res["batch"] == batch and res["device"] == "cpu"
    assert res["value"] > 0 and res["window"] == 8
    assert res["mode"] == "scan_realdata" and res["parity_ok"] is True
    assert not {"peak_memory_gib", "power_limit"} & set(res)
    if lane == "mnist_guard":
        assert res["guard"] == "skip" and res["best_of"] == 3
        assert "guard_overhead_pct" in res
    else:
        assert res["executor_mode"] == "compiled"
        assert res["parity_max_diff"] == 0.0
        assert res["loop_samples_per_sec"] > 0
    if lane == "wide_deep_realdata":  # the CPU's size: 1e4 ids a slot
        assert res["sparse_dim"] == 10000 and res["cpu_smoke"] is True


@pytest.mark.parametrize("lane", ["mnist_realdata", "mnist_guard",
                                  "wide_deep_realdata"])
def test_realdata_lane_without_a_card_fails(lane, no_card):
    rc, res, _ = no_card[lane]
    assert rc == 1
    assert res["metric"] == f"{lane}_error" and res["unit"] == "error"
    assert "CUDA is not available" in res["error"]
