"""chip_smoke.py's phase 23 (the detection batch) on the CPU:

- its op battery (d) holds the batch's 44 op types, and each host op's
  case (the card holds them exactly against the CPU port) gives the TPU
  package's outputs exactly (the pure ops' cases are the shapes of
  test_torch_detection_ops.py's and test_torch_vision_ops2.py's, which
  hold them and their grads against the TPU package);
- ``IslandTape``: a replay that finds an island's outputs other than the
  record's on the recorded inputs fails, and a selection that parts on
  the replaying side's own inputs is counted;
- phase_detection rehearsed at small sizes (YOLOv3, SSD and Faster
  R-CNN at width 1/16 and small images, 4 steps), every comparison it
  makes on the card made here with the CPU standing in for it, each
  compiled or segmented run's kind as a card run's (eager, capture,
  replays).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.ops.registry import OPS as TOPS
from tests.test_torch_rnn_layers import cs
from tests.test_torch_vision_ops import run_both

BATTERY = cs._det_battery()


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_battery_holds_the_44_op_types():
    from tests.test_torch_detection_ops import DETECTION_OPS
    from tests.test_torch_detection_train_ops import TRAIN_OPS
    from tests.test_torch_vision_ops2 import VISION_OPS
    types = [c[0] for c in BATTERY]
    assert len(types) == len(set(types)) == 44
    assert set(types) == set(DETECTION_OPS) | set(TRAIN_OPS) | set(
        VISION_OPS)
    assert set(cs.DET_HOST_OPS) == {t for t in types
                                    if TOPS.get(t).stateful} - {
        "inplace_abn"}


HOST_CASES = [c for c in BATTERY if c[0] in cs.DET_HOST_OPS]


@pytest.mark.parametrize("case", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_chip_smoke_battery_against_the_tpu_package(case):
    op_type, ins, attrs, lod, diff = case
    run_both(op_type, ins, attrs, lod=lod, grad=False, tol=(0.0, 0.0))


def _nms_case():
    op_type, ins, attrs, lod, _ = next(c for c in BATTERY
                                       if c[0] == "multiclass_nms")
    tins = {s: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
            for s, v in ins.items()}
    return tins, dict(TOPS.get(op_type).attr_defaults, _lod=lod, **attrs)


_np, _from_np = cs._det_card_np, cs._det_cpu_from_np


def test_island_tape_replays_counts_and_fails():
    tins, attrs = _nms_case()
    kernel = lambda ins: TOPS.get("multiclass_nms").kernel(  # noqa: E731
        ins, attrs)
    tape = cs.IslandTape()
    with tape.recording(TOPS, _np):
        want = kernel(tins)
    # the same inputs: held, nothing parted
    with tape.replaying(TOPS, _from_np, _np):
        got = kernel(tins)
    assert tape.held == 1 and tape.parted == 0
    assert torch.equal(got["Out"][0], want["Out"][0])
    # other inputs on the replaying side: the record's selection returned,
    # the parting counted
    moved = dict(tins, Scores=[tins["Scores"][0].flip(-1)])
    tape.rewind()
    with tape.replaying(TOPS, _from_np, _np):
        got = kernel(moved)
    assert tape.parted == 1 and torch.equal(got["Out"][0], want["Out"][0])
    # a record the island does not reproduce fails
    rec_ins, rec_lod, rec_outs = tape.records["multiclass_nms"][0]
    rec_outs.arrays["Out"][0] = rec_outs.arrays["Out"][0] + 1.0
    tape.rewind()
    with tape.replaying(TOPS, _from_np, _np), \
            pytest.raises(AssertionError, match="multiclass_nms"):
        kernel(tins)


def test_chip_smoke_phase_23_rehearsed(monkeypatch):
    """phase_detection on the CPU at small sizes: every comparison it
    makes on the card, each run's kind as a card run's."""
    import paddle_tpu_torch.inference as tinference
    from tests.test_torch_rnn_layers import _interpreted
    zeros = cs.NO_KERNELS
    monkeypatch.setattr(tfluid, "CUDAPlace", lambda i=0: tfluid.CPUPlace())
    for name, value in (
            ("DET_WIDTH", 1 / 16), ("YOLO_IMAGE", 64), ("YOLO_BATCH", 2),
            ("YOLO_STAGES", (0, 0, 0, 0, 0)), ("YOLO_CLASSES", 3),
            ("SSD_IMAGE", 96), ("SSD_BATCH", 2), ("SSD_BLOCKS", 1),
            ("FRCN_IMAGE", (128, 192)), ("FRCN_STAGES", (1, 1, 1, 1)),
            ("FRCN_PROPOSALS", (60, 30)), ("FRCN_ROIS", 16),
            ("MD_STEPS", 4), ("DET_EVAL_RUNS", 1),
            ("YOLO_CHECK", dict(depth=(0, 0, 0, 0, 0), width=1 / 16,
                                image=64, classes=3)),
            ("SSD_CHECK", dict(depth=1, width=1 / 16, image=96)),
            ("FRCN_CHECK", dict(depth=(1, 1, 1, 1), width=1 / 16,
                                image=(128, 192), proposals=(60, 30),
                                rois=16))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_launch_counts", lambda: zeros)
    monkeypatch.setattr(cs, "_device_kernel_counts",
                        lambda fn, **k: (fn(), zeros)[1])
    monkeypatch.setattr(cs, "_check_trace", lambda *a: None)
    monkeypatch.setattr(cs, "_card_line", lambda: "CPU")
    clone = cs._clone_scope
    monkeypatch.setattr(cs, "_clone_scope",
                        lambda scope, names, dev: clone(scope, names, "cpu"))
    config = tinference.Config

    def cpu_config(d):
        c = config(d)
        c.disable_gpu()
        return c
    monkeypatch.setattr(tinference, "Config", cpu_config)
    battery = cs._det_battery
    monkeypatch.setattr(cs, "_det_battery", lambda: [
        c for c in battery() if c[0] in ("multiclass_nms", "roi_align",
                                         "generate_proposals")])
    monkeypatch.setattr(cs, "VS_CARD", "cpu")
    runs = {}

    def kind(exe, mode, what):
        assert exe._last_run_mode == mode, (what, exe._last_run_mode)
        if mode == "interpreted":
            return mode
        # the block is held, so that a later block cannot take its id
        seen = runs.setdefault(id(exe._last_block), [exe._last_block, 0])
        seen[1] += 1
        n = seen[1]
        return ("eager", "capture")[n - 1] if n <= 2 else "replay"
    monkeypatch.setattr(cs, "_gate_run", lambda exe, delta, want, what:
                        kind(exe, "compiled", what))
    monkeypatch.setattr(cs, "_rnn_gate", lambda exe, before, mode, what,
                        book: kind(exe, mode, what))
    monkeypatch.setattr(cs, "_interpreted", lambda iexe, main, feed, fetch,
                        scope, want, book, what: _interpreted(iexe, main,
                                                              feed, fetch,
                                                              scope))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    lines = []
    monkeypatch.setattr(cs, "_log", lambda *a: lines.append(" ".join(
        str(x) for x in a)))
    out = cs.phase_detection()
    text = "\n".join(lines)
    assert "FAIL" not in text and "DIFFER" not in text
    for want in ("(a) YOLOv3 DarkNet-53 64x64 batch 2",
                 "(a) the eval program at batch 2",
                 "served by AnalysisPredictor at batch 1",
                 "(b) MobileNet-SSD 96x96 batch 2",
                 "compiled segments and", "(b) the eval program",
                 "(c) Faster R-CNN R50-FPN 128x192 batch 1",
                 "(c) the eval program", "island calls held exactly",
                 "(d) 3 op types", "phase 23 in"):
        assert want in text, want
    assert out["wrapper"] == zeros and out["executed"] == zeros
    for name in ("yolov3", "ssd", "faster_rcnn"):
        assert out["checks"][name][0] > (0 if name == "yolov3" else 2)
