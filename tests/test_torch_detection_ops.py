"""The detection ops of paddle_tpu_torch (ops/detection_ops.py) against the
TPU package's kernels, on the CPU, on numpy inputs made from a seed:

- the pure ops (the generators, box_coder, box_clip, yolo_box,
  yolov3_loss, roi_align) at rtol 1e-5, atol 1e-6, and the generic grads
  of those with diff_inputs under a seeded output grad at the same
  tolerance;
- the host ops (bipartite_match, target_assign, multiclass_nms and
  multiclass_nms2, roi_pool, generate_proposals, distribute_fpn_proposals,
  collect_fpn_proposals) exactly: kept indices, rows, LoD, Argmax,
  matches; with tied scores, ``nms_eta`` < 1 and an empty result;
- ``_nms``'s kept indices against the TPU package's scalar loop, tied
  scores included;
- roi_pool's backward raising in a program, as the reference's does;
- the registration flags as the TPU package registers them.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops import detection_ops as jdet
from paddle_tpu.ops.registry import OPS as JOPS
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch.ops import detection_ops as tdet
from paddle_tpu_torch.ops.registry import OPS as TOPS
from tests.test_torch_vision_ops import run_both

TOL = (1e-5, 1e-6)
EXACT = (0.0, 0.0)

DETECTION_OPS = (
    "prior_box", "density_prior_box", "anchor_generator", "box_coder",
    "box_clip", "bipartite_match", "target_assign", "multiclass_nms",
    "multiclass_nms2", "yolo_box", "yolov3_loss", "roi_align", "roi_pool",
    "generate_proposals", "distribute_fpn_proposals",
    "collect_fpn_proposals")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.RandomState(seed)


def _boxes(rng, n, size=1.0, min_wh=0.05):
    """n random valid xyxy boxes in [0, size]."""
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(min_wh * size, size * 0.5, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, size)], 1).astype(
        np.float32)


@pytest.mark.parametrize("op_type", DETECTION_OPS)
def test_registered_with_the_reference_flags(op_type):
    ti, ji = TOPS.get(op_type), JOPS.get(op_type)
    for flag in ("no_grad", "stateful", "needs_rng", "needs_lod"):
        assert getattr(ti, flag) == getattr(ji, flag), flag
    assert list(ti.diff_input_slots or []) == list(ji.diff_input_slots or [])
    assert tuple(ti.host_inputs) == tuple(ji.host_inputs)
    assert ti.attr_defaults == ji.attr_defaults


# ------------------------------------------------------------ generators
PRIOR_CASES = [
    dict(min_sizes=[2.0, 4.0], max_sizes=[3.0, 6.0], aspect_ratios=[2.0, 3.0],
         flip=True, clip=True),
    dict(min_sizes=[3.0], aspect_ratios=[1.0, 2.0], flip=False,
         step_w=4.0, step_h=3.0, offset=0.3),
]


@pytest.mark.parametrize("attrs", PRIOR_CASES, ids=["flip_clip", "steps"])
def test_prior_box(attrs):
    ins = {"Input": [np.zeros((1, 4, 3, 4), np.float32)],
           "Image": [np.zeros((1, 3, 12, 16), np.float32)]}
    out = run_both("prior_box", ins, attrs, grad=False, tol=EXACT)
    # built once: a second call returns equal copies of the kept constant
    again = TOPS.get("prior_box").kernel(
        {k: [torch.from_numpy(v[0])] for k, v in ins.items()},
        dict(TOPS.get("prior_box").attr_defaults, **attrs))
    assert torch.equal(again["Boxes"][0], out["Boxes"][0])
    assert again["Boxes"][0].data_ptr() != out["Boxes"][0].data_ptr()


@pytest.mark.parametrize("flat", [False, True])
def test_density_prior_box(flat):
    ins = {"Input": [np.zeros((1, 2, 2, 3), np.float32)],
           "Image": [np.zeros((1, 3, 16, 24), np.float32)]}
    run_both("density_prior_box", ins,
             dict(densities=[2, 1], fixed_sizes=[4.0, 8.0],
                  fixed_ratios=[1.0, 2.0], clip=True, flatten_to_2d=flat),
             grad=False, tol=EXACT)


def test_anchor_generator():
    run_both("anchor_generator",
             {"Input": [np.zeros((1, 2, 3, 4), np.float32)]},
             dict(anchor_sizes=[32.0, 64.0], aspect_ratios=[0.5, 1.0, 2.0],
                  stride=[8.0, 8.0]), grad=False, tol=EXACT)


# ----------------------------------------------------- box_coder / clip
@pytest.mark.parametrize("var", ["tensor", "attr", "none"])
@pytest.mark.parametrize("norm", [True, False])
def test_box_coder_encode(var, norm):
    r = _rng(1)
    size = 1.0 if norm else 40.0
    ins = {"PriorBox": [_boxes(r, 7, size)], "TargetBox": [_boxes(r, 5, size)]}
    attrs = {"code_type": "encode_center_size", "box_normalized": norm}
    if var == "tensor":
        ins["PriorBoxVar"] = [r.uniform(0.1, 0.3, (7, 4)).astype(np.float32)]
    elif var == "attr":
        attrs["variance"] = [0.1, 0.1, 0.2, 0.2]
    run_both("box_coder", ins, attrs, tol=TOL, diff=["TargetBox"])


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("var", ["tensor", "attr"])
def test_box_coder_decode(axis, var):
    r = _rng(2)
    ins = {"PriorBox": [_boxes(r, 6)],
           "TargetBox": [r.normal(0, 0.5, (6, 6, 4)).astype(np.float32)]}
    attrs = {"code_type": "decode_center_size", "axis": axis}
    if var == "tensor":
        ins["PriorBoxVar"] = [r.uniform(0.1, 0.3, (6, 4)).astype(np.float32)]
    else:
        attrs["variance"] = [0.1, 0.1, 0.2, 0.2]
    run_both("box_coder", ins, attrs, tol=TOL, diff=["TargetBox"])


def test_box_coder_decode_2d_target():
    r = _rng(3)
    run_both("box_coder", {"PriorBox": [_boxes(r, 5)],
                           "PriorBoxVar": [np.full((5, 4), 0.2, np.float32)],
                           "TargetBox": [r.normal(size=(5, 4)).astype(
                               np.float32)]},
             {"code_type": "decode_center_size"}, tol=TOL,
             diff=["TargetBox"])


@pytest.mark.parametrize("lod", [True, False])
def test_box_clip(lod):
    r = _rng(4)
    im = np.array([[20, 30, 1.0], [16, 12, 2.0]], np.float32)
    if lod:
        ins = {"Input": [r.uniform(-5, 40, (5, 4)).astype(np.float32)],
               "ImInfo": [im]}
        run_both("box_clip", ins, {}, lod={"Input": [((0, 2, 5),)]},
                 tol=TOL, diff=["Input"])
    else:
        ins = {"Input": [r.uniform(-5, 40, (2, 3, 4)).astype(np.float32)],
               "ImInfo": [im]}
        run_both("box_clip", ins, {}, lod={"Input": [None]}, tol=TOL,
                 diff=["Input"])


# ------------------------------------------------------------- matching
def _dist(r, rows, cols):
    d = r.choice([0.0, 0.2, 0.5, 0.7], (rows, cols)).astype(np.float32)
    d += r.uniform(0, 0.01, (rows, cols)).astype(np.float32) \
        * (r.rand(rows, cols) < 0.5)
    return d


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match(match_type):
    r = _rng(5)
    d = _dist(r, 5, 9)                       # ties among the 0.7s
    run_both("bipartite_match", {"DistMat": [d]},
             {"match_type": match_type, "dist_threshold": 0.4},
             lod={"DistMat": [((0, 3, 5),)]}, grad=False, tol=EXACT)


def test_bipartite_match_without_lod():
    r = _rng(6)
    run_both("bipartite_match", {"DistMat": [_dist(r, 4, 6)]}, {},
             lod={"DistMat": [None]}, grad=False, tol=EXACT)


@pytest.mark.parametrize("kind", ["codes", "labels"])
def test_target_assign(kind):
    r = _rng(7)
    mi = r.randint(-1, 3, (2, 6)).astype(np.int32)
    mi[1] = np.minimum(mi[1], 1)
    if kind == "codes":
        x = r.normal(size=(5, 6, 4)).astype(np.float32)
        attrs = {}
    else:
        x = r.randint(0, 9, (5, 1)).astype(np.int64)
        attrs = {"mismatch_value": 3}
    run_both("target_assign", {"X": [x], "MatchIndices": [mi]}, attrs,
             lod={"X": [((0, 3, 5),)]}, grad=False, tol=EXACT)


# ------------------------------------------------------------------ NMS
def _nms_inputs(r, n=2, c=4, m=40, tie=True, pixels=False):
    size = 60.0 if pixels else 1.0
    boxes = np.stack([_boxes(r, m, size) for _ in range(n)])
    scores = r.rand(n, c, m).astype(np.float32)
    if tie:   # a third of the scores on a coarse grid: ties
        q = r.rand(n, c, m) < 0.35
        scores[q] = np.round(scores[q] * 4) / 4
    return boxes, scores


NMS_CASES = {
    "ties": dict(score_threshold=0.1, nms_top_k=30, keep_top_k=25,
                 nms_threshold=0.3),
    "eta": dict(score_threshold=0.05, nms_top_k=-1, keep_top_k=-1,
                nms_threshold=0.9, nms_eta=0.8),
    "no_background": dict(score_threshold=0.2, nms_top_k=20, keep_top_k=10,
                          nms_threshold=0.5, background_label=-1),
    "pixels": dict(score_threshold=0.1, nms_top_k=40, keep_top_k=50,
                   nms_threshold=0.4, normalized=False),
    "empty": dict(score_threshold=2.0, nms_top_k=10, keep_top_k=10),
}


@pytest.mark.parametrize("op_type", ["multiclass_nms", "multiclass_nms2"])
@pytest.mark.parametrize("case", list(NMS_CASES))
def test_multiclass_nms(op_type, case):
    boxes, scores = _nms_inputs(_rng(8), pixels=case == "pixels")
    out = run_both(op_type, {"BBoxes": [boxes], "Scores": [scores]},
                   NMS_CASES[case], lod={}, grad=False, tol=EXACT)
    if case == "empty":
        assert out["Out"][0].tolist() == [[-1.0]]
        assert out["_lod"]["Out"] == [((0, 1, 1),)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("eta", [1.0, 0.7])
@pytest.mark.parametrize("norm", [True, False])
def test_nms_keeps_the_reference_indices(seed, eta, norm):
    """The vectorised ``_nms`` against the TPU package's scalar loop:
    the same kept indices in the same order, with many tied scores."""
    r = _rng(100 + seed)
    boxes = _boxes(r, 120, 1.0 if norm else 50.0)
    scores = (r.randint(0, 12, 120) / 12.0).astype(np.float32)
    for thresh, top_k in ((0.3, -1), (0.6, 50), (0.95, 80)):
        want = jdet._nms(boxes, scores, thresh, top_k, norm, eta)
        got = tdet._nms(boxes, scores, thresh, top_k, norm, eta)
        assert got == want
    assert tdet._nms(boxes[:0], scores[:0], 0.3, -1) == []


# -------------------------------------------------------------- YOLO
ANCHORS = [4, 5, 6, 9, 11, 8, 10, 14, 16, 12, 15, 20, 22, 18, 25, 30,
           34, 28]


def test_yolo_box():
    r = _rng(9)
    x = r.normal(0, 1.5, (2, 3 * 9, 5, 6)).astype(np.float32)
    run_both("yolo_box", {"X": [x], "ImgSize": [np.array(
        [[40, 48], [33, 50]], np.int32)]},
        {"anchors": ANCHORS[:6], "class_num": 4, "conf_thresh": 0.3,
         "downsample_ratio": 8}, grad=False, tol=TOL)


def _yolo_gt(r, n, b):
    wh = r.uniform(0.05, 0.6, (n, b, 2))
    xy = r.uniform(0.0, 1.0, (n, b, 2))
    gt = np.concatenate([xy, wh], -1).astype(np.float32)
    gt[:, -2:] = 0.0                       # padding boxes
    gt[0, 1, 2] = 0.0
    return gt, r.randint(0, 4, (n, b)).astype(np.int32)


@pytest.mark.parametrize("mask", [[3, 4, 5], [0, 1, 2]])
def test_yolov3_loss(mask):
    r = _rng(10)
    x = r.normal(0, 0.5, (2, 3 * 9, 4, 4)).astype(np.float32)
    gt, lab = _yolo_gt(r, 2, 7)
    run_both("yolov3_loss", {"X": [x], "GTBox": [gt], "GTLabel": [lab]},
             {"anchors": ANCHORS, "anchor_mask": mask, "class_num": 4,
              "ignore_thresh": 0.7, "downsample_ratio": 8}, tol=TOL,
             diff=["X"])


def test_yolov3_loss_shared_cell_and_score():
    """Two boxes in one cell of one anchor (the objectness scatter-max),
    and a GTScore the kernel does not read."""
    r = _rng(11)
    x = r.normal(0, 0.5, (1, 3 * 9, 4, 4)).astype(np.float32)
    gt = np.array([[[0.3, 0.3, 0.2, 0.25], [0.32, 0.31, 0.21, 0.24],
                    [0.8, 0.6, 0.5, 0.5]]], np.float32)
    lab = np.array([[1, 2, 3]], np.int32)
    run_both("yolov3_loss", {"X": [x], "GTBox": [gt], "GTLabel": [lab],
                             "GTScore": [np.full((1, 3), 0.5, np.float32)]},
             {"anchors": ANCHORS, "anchor_mask": [0, 1, 2], "class_num": 4,
              "downsample_ratio": 8}, tol=TOL, diff=["X"])


# -------------------------------------------------------------- RoI ops
def _rois(r, n, h, w):
    x1 = r.uniform(0, w * 0.6, n)
    y1 = r.uniform(0, h * 0.6, n)
    return np.stack([x1, y1, x1 + r.uniform(1, w * 0.6, n),
                     y1 + r.uniform(1, h * 0.6, n)], 1).astype(np.float32)


@pytest.mark.parametrize("sampling", [2, -1, 3])
def test_roi_align(sampling):
    r = _rng(12)
    x = r.normal(size=(2, 3, 8, 10)).astype(np.float32)
    run_both("roi_align", {"X": [x], "ROIs": [_rois(r, 5, 16, 20)]},
             {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5,
              "sampling_ratio": sampling},
             lod={"ROIs": [((0, 2, 5),)]}, tol=TOL, diff=["X"])


def test_roi_align_without_rois():
    r = _rng(13)
    run_both("roi_align", {"X": [r.normal(size=(1, 2, 4, 4)).astype(
        np.float32)], "ROIs": [np.zeros((0, 4), np.float32)]},
        {"pooled_height": 2, "pooled_width": 2}, lod={"ROIs": [None]},
        grad=False, tol=TOL)


def test_roi_pool_forward_and_argmax():
    r = _rng(14)
    x = r.normal(size=(2, 3, 8, 10)).astype(np.float32)
    x[0, :, 2:4, 2:4] = 1.5                # ties inside a bin
    run_both("roi_pool", {"X": [x], "ROIs": [_rois(r, 6, 16, 20)]},
             {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5},
             lod={"ROIs": [((0, 4, 6),)]}, grad=False, tol=EXACT)


def _roi_pool_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [2, 8, 8], "float32")
        x.stop_gradient = False
        rois = fluid.data("rois", [4], "float32", lod_level=1)
        y = fluid.layers.roi_pool(fluid.layers.scale(x, 2.0), rois, 2, 2)
        loss = fluid.layers.mean(y)
        fluid.backward.append_backward(loss)
    return main, loss


def test_roi_pool_backward_raises_as_the_reference():
    """The TPU package registers no roi_pool_grad; running the backward
    raises NotImplementedError in both packages."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid import core as jcore
    from paddle_tpu_torch import fluid as tfluid
    x = np.ones((1, 2, 8, 8), np.float32)
    rois = np.array([[0, 0, 4, 4], [1, 1, 6, 6]], np.float32)
    with jfluid.unique_name.guard():
        jmain, jloss = _roi_pool_program(jfluid)
    jt = jcore.LoDTensor()
    jt.set(rois, jfluid.CPUPlace())
    jt.set_lod([[0, 2]])
    with pytest.raises(NotImplementedError, match="roi_pool_grad"):
        jfluid.Executor().run(jmain, feed={"x": x, "rois": jt},
                              fetch_list=[jloss])
    with tfluid.unique_name.guard():
        tmain, tloss = _roi_pool_program(tfluid)
    tt = tfluid.LoDTensor(torch.from_numpy(rois))
    tt.set_lod([[0, 2]])
    with pytest.raises(NotImplementedError, match="roi_pool_grad"):
        tfluid.Executor(tfluid.CPUPlace()).run(
            tmain, feed={"x": x, "rois": tt}, fetch_list=[tloss])


# ---------------------------------------------------- proposal generation
def _rpn_inputs(r, n=2, a=3, h=4, w=5):
    anchors = np.asarray(tdet._anchor_np(h, w, {
        "anchor_sizes": [8.0, 16.0, 32.0], "aspect_ratios": [1.0],
        "stride": [8.0, 8.0], "variances": [0.1, 0.1, 0.2, 0.2]})[0])
    scores = r.rand(n, a, h, w).astype(np.float32)
    scores[0, 0, :2] = 0.5                              # ties
    return {"Scores": [scores],
            "BboxDeltas": [r.normal(0, 0.5, (n, 4 * a, h, w)).astype(
                np.float32)],
            "ImInfo": [np.array([[32, 40, 1.0], [30, 36, 1.5]][:n],
                                np.float32)],
            "Anchors": [anchors],
            "Variances": [np.full(anchors.shape, 0.5, np.float32)]}


@pytest.mark.parametrize("attrs", [
    dict(pre_nms_topN=40, post_nms_topN=15, nms_thresh=0.5, min_size=2.0),
    dict(pre_nms_topN=60, post_nms_topN=60, nms_thresh=0.7, min_size=0.1)],
    ids=["cut", "all"])
def test_generate_proposals(attrs):
    run_both("generate_proposals", _rpn_inputs(_rng(15)), attrs, grad=False,
             tol=EXACT)


def test_distribute_and_collect_fpn_proposals():
    r = _rng(16)
    rois = _boxes(r, 30, 600.0, min_wh=0.01)
    run_both("distribute_fpn_proposals", {"FpnRois": [rois]},
             {"min_level": 2, "max_level": 5, "refer_level": 4,
              "refer_scale": 224}, lod={"FpnRois": [((0, 18, 30),)]},
             grad=False, tol=EXACT)
    levels = [_boxes(r, k, 300.0) for k in (5, 0, 7)]
    scores = [r.rand(len(b), 1).astype(np.float32) for b in levels]
    scores[2][:3] = scores[0][0]                        # ties
    run_both("collect_fpn_proposals", {"MultiLevelRois": levels,
                                       "MultiLevelScores": scores},
             {"post_nms_topN": 9}, lod={}, grad=False, tol=EXACT)
