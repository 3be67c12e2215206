"""The port's bench entry point, ``python -m paddle_tpu_torch.bench``, on
the CPU, in a subprocess that cannot import jax or paddle_tpu: each lane
with ``--device cpu`` prints one JSON line in bench.py's form with the
documented keys (the bert lane at bench.py's CPU smoke configuration);
without ``--device cpu`` on a host without CUDA it prints the lane's
error line and exits non-zero. What the lanes measure on the card is
chip_smoke.py's (its lane phase)."""
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


def _bench(*args):
    env = dict(os.environ, OMP_NUM_THREADS="4", CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", RUN, *args], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1, (p.stdout, p.stderr[-2000:])
    return p.returncode, json.loads(lines[0]), p.stderr


@pytest.mark.parametrize("lane,metric,batch", [
    ("bert", "bert_base_samples_per_sec_per_chip", 8),
    ("mnist", "mnist_mlp_samples_per_sec", 256)])
def test_lane_on_the_cpu(lane, metric, batch):
    rc, res, err = _bench(lane, "--device", "cpu")
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
    else:
        assert res["steps"] == 60


@pytest.mark.parametrize("lane", ["bert", "mnist"])
def test_lane_without_a_card_fails(lane):
    rc, res, err = _bench(lane)
    assert rc == 1
    assert res["metric"] == f"{lane}_error" and res["unit"] == "error"
    assert "CUDA is not available" in res["error"]
