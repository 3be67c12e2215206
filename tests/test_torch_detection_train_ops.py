"""Detection training's ops (ops/detection_train_ops.py) and detection_map
(ops/metrics_misc_ops.py) of paddle_tpu_torch against the TPU package's
kernels, on the CPU, on numpy inputs made from a seed:

- every host op exactly: sampled indices, labels, targets, rows, masks
  and LoD. The samplers draw alike in both packages from a pinned
  ``seed`` attr, from ``use_random=False``, and from the modules' own
  streams (both seeded 12345) when both are reset;
- box_decoder_and_assign (pure) at rtol 1e-5, atol 1e-6;
- detection_map over two batches with its accumulated state, both AP
  types, with and without the difficult ground truths;
- the registration flags as the TPU package registers them.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops import detection_train_ops as jtrain
from paddle_tpu.ops.registry import OPS as JOPS
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch.ops import detection_ops as tdet
from paddle_tpu_torch.ops import detection_train_ops as ttrain
from paddle_tpu_torch.ops.registry import OPS as TOPS
from tests.test_torch_detection_ops import _boxes
from tests.test_torch_vision_ops import run_both

TOL = (1e-5, 1e-6)
EXACT = (0.0, 0.0)

TRAIN_OPS = (
    "rpn_target_assign", "retinanet_target_assign",
    "retinanet_detection_output", "locality_aware_nms",
    "box_decoder_and_assign", "mine_hard_examples",
    "generate_proposal_labels", "generate_mask_labels",
    "roi_perspective_transform", "detection_map")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("op_type", TRAIN_OPS)
def test_registered_with_the_reference_flags(op_type):
    ti, ji = TOPS.get(op_type), JOPS.get(op_type)
    for flag in ("no_grad", "stateful", "needs_rng", "needs_lod"):
        assert getattr(ti, flag) == getattr(ji, flag), flag
    assert list(ti.diff_input_slots or []) == list(ji.diff_input_slots or [])
    assert tuple(ti.input_slots or ()) == tuple(ji.input_slots or ())
    assert ti.attr_defaults == ji.attr_defaults


# ---------------------------------------------------------- RPN targets
def _anchors():
    return tdet._anchor_np(6, 8, {
        "anchor_sizes": [16.0, 32.0], "aspect_ratios": [0.5, 1.0, 2.0],
        "stride": [8.0, 8.0], "variances": [0.1, 0.1, 0.2, 0.2]})[0] \
        .reshape(-1, 4)


def _gt(r, n_per):
    boxes = np.concatenate([_boxes(r, k, 60.0, 0.2) for k in n_per])
    return boxes, ((0,) + tuple(int(v) for v in np.cumsum(n_per)),)


def _rpn_ins(r, retinanet=False):
    gt, lod = _gt(r, (3, 2))
    crowd = np.zeros((len(gt), 1), np.int32)
    crowd[1] = 1
    ins = {"Anchor": [_anchors()], "GtBoxes": [gt], "IsCrowd": [crowd],
           "ImInfo": [np.array([[48, 64, 1.0], [48, 64, 1.0]], np.float32)]}
    if retinanet:
        ins["GtLabels"] = [r.randint(1, 5, (len(gt), 1)).astype(np.int32)]
    return ins, {"GtBoxes": [lod]}


@pytest.mark.parametrize("attrs", [
    dict(seed=7, rpn_batch_size_per_im=32, rpn_straddle_thresh=0.0),
    dict(use_random=False, rpn_batch_size_per_im=16,
         rpn_positive_overlap=0.5, rpn_straddle_thresh=-1.0)],
    ids=["seeded", "first"])
def test_rpn_target_assign(attrs):
    ins, lod = _rpn_ins(np.random.RandomState(1))
    run_both("rpn_target_assign", ins, attrs, lod=lod, grad=False,
             tol=EXACT)


def test_rpn_target_assign_module_stream(monkeypatch):
    """The seed attr 0 draws from the module's stream, seeded 12345 in
    both packages: reset alike, two calls draw alike."""
    monkeypatch.setattr(jtrain, "_SAMPLER", np.random.RandomState(12345))
    monkeypatch.setattr(ttrain, "_SAMPLER", np.random.RandomState(12345))
    ins, lod = _rpn_ins(np.random.RandomState(2))
    for _ in range(2):
        run_both("rpn_target_assign", ins, {"rpn_batch_size_per_im": 24},
                 lod=lod, grad=False, tol=EXACT)


def test_retinanet_target_assign():
    ins, lod = _rpn_ins(np.random.RandomState(3), retinanet=True)
    run_both("retinanet_target_assign", ins, {}, lod=lod, grad=False,
             tol=EXACT)


def test_retinanet_detection_output():
    r = np.random.RandomState(4)
    levels = [(12, 4), (6, 4)]
    ins = {"BBoxes": [r.normal(0, 0.3, (2, a, 4)).astype(np.float32)
                      for a, _ in levels],
           "Scores": [r.rand(2, a, c).astype(np.float32)
                      for a, c in levels],
           "Anchors": [_boxes(r, a, 50.0, 0.2) for a, _ in levels],
           "ImInfo": [np.array([[50, 50, 1.0], [50, 50, 1.0]], np.float32)]}
    ins["Scores"][0][0, :4, 1] = 0.75                 # tied scores
    run_both("retinanet_detection_output", ins,
             {"score_threshold": 0.3, "nms_top_k": 10, "keep_top_k": 12,
              "nms_threshold": 0.4}, lod={}, grad=False, tol=EXACT)


@pytest.mark.parametrize("attrs", [
    dict(score_threshold=0.2, nms_threshold=0.3),
    dict(score_threshold=0.1, nms_threshold=0.5, keep_top_k=6,
         normalized=True, nms_eta=0.8, background_label=0)],
    ids=["plain", "eta"])
def test_locality_aware_nms(attrs):
    r = np.random.RandomState(5)
    base = _boxes(r, 6, 40.0, 0.2)
    boxes = np.repeat(base, 4, 0) + r.uniform(-1, 1, (24, 4)).astype(
        np.float32)                          # runs of overlapping boxes
    if attrs.get("normalized"):
        boxes = boxes / 40.0
    run_both("locality_aware_nms",
             {"BBoxes": [boxes[None]],
              "Scores": [r.rand(1, 2, 24).astype(np.float32)]},
             attrs, lod={}, grad=False, tol=EXACT)


@pytest.mark.parametrize("var", ["one", "per_roi", "none"])
def test_box_decoder_and_assign(var):
    r = np.random.RandomState(6)
    ins = {"PriorBox": [_boxes(r, 5, 50.0, 0.2)],
           "TargetBox": [r.normal(0, 1.0, (5, 12)).astype(np.float32)],
           "BoxScore": [r.rand(5, 3).astype(np.float32)]}
    if var == "one":
        ins["PriorBoxVar"] = [np.array([0.1, 0.1, 0.2, 0.2], np.float32)]
    elif var == "per_roi":
        ins["PriorBoxVar"] = [r.uniform(0.1, 0.3, (5, 4)).astype(
            np.float32)]
    run_both("box_decoder_and_assign", ins, {"box_clip": 1.0}, grad=False,
             tol=TOL)


@pytest.mark.parametrize("mode", ["max_negative", "hard_example"])
def test_mine_hard_examples(mode):
    r = np.random.RandomState(7)
    match = r.randint(-1, 3, (3, 20)).astype(np.int32)
    match[r.rand(3, 20) < 0.5] = -1
    cls = r.rand(3, 20).astype(np.float32)
    cls[0, :5] = 0.5                                   # tied losses
    run_both("mine_hard_examples",
             {"ClsLoss": [cls], "LocLoss": [r.rand(3, 20).astype(
                 np.float32)], "MatchIndices": [match],
              "MatchDist": [r.rand(3, 20).astype(np.float32)]},
             {"mining_type": mode, "sample_size": 4, "neg_pos_ratio": 2.0},
             lod={}, grad=False, tol=EXACT)


# ---------------------------------------------------- Fast R-CNN targets
def _proposal_ins(r):
    rois = np.concatenate([_boxes(r, 40, 60.0, 0.1), _boxes(r, 30, 60.0,
                                                            0.1)])
    gt, glod = _gt(r, (3, 2))
    gt_cls = r.randint(1, 6, (len(gt), 1)).astype(np.int32)
    crowd = np.zeros((len(gt), 1), np.int32)
    crowd[4] = 1
    ins = {"RpnRois": [rois], "GtClasses": [gt_cls], "IsCrowd": [crowd],
           "GtBoxes": [gt], "ImInfo": [np.array([[60, 60, 1.0]] * 2,
                                                np.float32)]}
    return ins, {"RpnRois": [((0, 40, 70),)], "GtBoxes": [glod],
                 "GtClasses": [glod]}


@pytest.mark.parametrize("attrs", [
    dict(seed=3, batch_size_per_im=24, class_nums=6, fg_thresh=0.3),
    dict(use_random=False, batch_size_per_im=16, class_nums=6,
         is_cls_agnostic=True, fg_thresh=0.25, bg_thresh_lo=0.05)],
    ids=["seeded", "first_agnostic"])
def test_generate_proposal_labels(attrs):
    ins, lod = _proposal_ins(np.random.RandomState(8))
    run_both("generate_proposal_labels", ins, attrs, lod=lod, grad=False,
             tol=EXACT)


def test_generate_mask_labels():
    r = np.random.RandomState(9)
    # three ground truths over two images; polygons of 4-6 points
    polys = [[r.uniform(5, 50, (k, 2)) for k in ks]
             for ks in ((4, 5), (6,), (4,))]
    pts = np.concatenate([p for g in polys for p in g]).astype(np.float32)
    per_gt = np.cumsum([0] + [len(g) for g in polys])
    per_poly = np.cumsum([0] + [len(p) for g in polys for p in g])
    rois = _boxes(r, 7, 60.0, 0.2)
    labels = np.array([[2], [0], [1], [3], [0], [1], [2]], np.int32)
    ins = {"ImInfo": [np.array([[60, 60, 1.0]] * 2, np.float32)],
           "GtClasses": [np.array([[1], [2], [3]], np.int32)],
           "IsCrowd": [np.zeros((3, 1), np.int32)],
           "GtSegms": [pts], "Rois": [rois], "LabelsInt32": [labels]}
    lod = {"GtSegms": [(tuple(int(v) for v in per_gt),
                        tuple(int(v) for v in per_poly))],
           "GtClasses": [((0, 2, 3),)], "Rois": [((0, 4, 7),)]}
    run_both("generate_mask_labels", ins, {"num_classes": 4,
                                           "resolution": 6},
             lod=lod, grad=False, tol=EXACT)


def test_roi_perspective_transform():
    r = np.random.RandomState(10)
    x = r.normal(size=(2, 2, 10, 12)).astype(np.float32)
    quads = np.array([[1, 1, 8, 2, 9, 7, 2, 8], [0, 0, 11, 0, 11, 9, 0, 9],
                      [3, 2, 6, 1, 7, 5, 2, 6]], np.float32)
    run_both("roi_perspective_transform", {"X": [x], "ROIs": [quads]},
             {"transformed_height": 4, "transformed_width": 5,
              "spatial_scale": 0.9}, lod={"ROIs": [((0, 2, 3),)]},
             grad=False, tol=EXACT)


# --------------------------------------------------------- detection_map
def _map_batch(r, n_img, classes, difficult):
    dets, dlens, gts, glens = [], [], [], []
    for _ in range(n_img):
        g = _boxes(r, 3, 50.0, 0.2)
        lab = r.randint(1, classes, 3)
        diff = (r.rand(3) < 0.3).astype(np.float32)
        cols = [lab[:, None].astype(np.float32)]
        if difficult:
            cols.append(diff[:, None])
        gts.append(np.concatenate(cols + [g], 1))
        glens.append(3)
        k = r.randint(2, 6)
        jitter = g[r.randint(0, 3, k)] + r.uniform(-4, 4, (k, 4))
        d = np.concatenate([r.randint(1, classes, (k, 1)),
                            np.round(r.rand(k, 1) * 8) / 8, jitter], 1)
        dets.append(d.astype(np.float32))
        dlens.append(k)
    lod = lambda lens: ((0,) + tuple(int(v) for v in np.cumsum(lens)),)
    return (np.concatenate(dets), lod(dlens), np.concatenate(gts).astype(
        np.float32), lod(glens))


@pytest.mark.parametrize("ap_type", ["integral", "11point"])
@pytest.mark.parametrize("difficult", [True, False])
def test_detection_map_with_state(ap_type, difficult):
    """Two batches: the second carries the first's accumulated state in
    both packages (the port's state fed to both)."""
    r = np.random.RandomState(11)
    attrs = {"class_num": 5, "ap_type": ap_type, "overlap_threshold": 0.4,
             "evaluate_difficult": not difficult}
    det, dlod, gt, glod = _map_batch(r, 3, 5, difficult)
    first = run_both("detection_map", {"DetectRes": [det], "Label": [gt]},
                     attrs, lod={"DetectRes": [dlod], "Label": [glod]},
                     grad=False, tol=EXACT)
    det, dlod, gt, glod = _map_batch(r, 2, 5, difficult)
    state = {"HasState": [np.array([1], np.int32)],
             "PosCount": [first["AccumPosCount"][0].numpy()],
             "TruePos": [first["AccumTruePos"][0].numpy()],
             "FalsePos": [first["AccumFalsePos"][0].numpy()]}
    run_both("detection_map", dict({"DetectRes": [det], "Label": [gt]},
                                   **state), attrs,
             lod={"DetectRes": [dlod], "Label": [glod],
                  "TruePos": list(first["_lod"]["AccumTruePos"]),
                  "FalsePos": list(first["_lod"]["AccumFalsePos"])},
             grad=False, tol=EXACT)
