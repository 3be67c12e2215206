"""The second vision batch of paddle_tpu_torch (ops/vision_ops.py: crop,
crop_tensor, affine_grid, unpool, spp, psroi_pool, prroi_pool,
conv3d_transpose, depthwise_conv2d_transpose, deformable_conv,
deformable_conv_v1, deformable_psroi_pooling, conv_shift,
bicubic_interp, trilinear_interp, similarity_focus,
polygon_box_transform, inplace_abn) against the TPU package's kernels,
on the CPU (the deformable ones in test_torch_vision_layers2.py, to keep
each file under a minute):

- each op's outputs on numpy inputs made from a seed at rtol 1e-5, atol
  1e-6, the convolutions at rtol 1e-4, atol 1e-5 (a product's sums in
  another order); the generic grads of each differentiable op under a
  seeded output grad at the same tolerance;
- unpool's repeated indices (its scatter adds them in a fixed order);
- the registration flags as the TPU package registers them.
The layers over these ops: test_torch_vision_layers2.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops.registry import OPS as JOPS
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch.ops.registry import OPS as TOPS
from tests.test_torch_detection_ops import _rois
from tests.test_torch_vision_ops import run_both

TOL = (1e-5, 1e-6)
MM_TOL = (1e-4, 1e-5)

VISION_OPS = (
    "crop", "crop_tensor", "affine_grid", "unpool", "spp", "psroi_pool",
    "prroi_pool", "conv3d_transpose", "depthwise_conv2d_transpose",
    "deformable_conv", "deformable_conv_v1", "deformable_psroi_pooling",
    "conv_shift", "bicubic_interp", "trilinear_interp", "similarity_focus",
    "polygon_box_transform", "inplace_abn")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("op_type", VISION_OPS)
def test_registered_with_the_reference_flags(op_type):
    ti, ji = TOPS.get(op_type), JOPS.get(op_type)
    for flag in ("no_grad", "stateful", "needs_rng", "needs_lod"):
        assert getattr(ti, flag) == getattr(ji, flag), flag
    assert list(ti.diff_input_slots or []) == list(ji.diff_input_slots or [])
    assert tuple(ti.input_slots or ()) == tuple(ji.input_slots or ())
    assert tuple(ti.host_inputs) == tuple(ji.host_inputs)
    assert ti.attr_defaults == ji.attr_defaults


# ------------------------------------------------------------------ crop
def test_crop_by_y_and_offsets_tensor():
    run_both("crop", {"X": [_x(3, 5, 6)], "Y": [_x(2, 3, 4, seed=1)],
                      "Offsets": [np.array([1, 2, 1], np.int32)]},
             tol=TOL, diff=["X"])


def test_crop_by_attrs():
    run_both("crop", {"X": [_x(3, 5, 6)]},
             {"shape": [2, -1, 3], "offsets": [0, 0, 2]}, tol=TOL,
             diff=["X"])


@pytest.mark.parametrize("how", ["tensor", "scalars", "attrs"])
def test_crop_tensor(how):
    x = _x(2, 4, 5, 6)
    if how == "tensor":
        ins = {"X": [x], "Shape": [np.array([1, 2, 3, 4], np.int32)],
               "Offsets": [np.array([1, 1, 2, 0], np.int32)]}
        attrs = {}
    elif how == "scalars":
        ins = {"X": [x],
               "ShapeTensor": [np.array([v], np.int32) for v in (2, 3, 3,
                                                                 5)],
               "OffsetsTensor": [np.array([v], np.int32)
                                 for v in (0, 1, 1, 1)]}
        attrs = {}
    else:
        ins = {"X": [x]}
        attrs = {"shape": [2, 2, -1, 3], "offsets": [0, 2, 0, 3]}
    run_both("crop_tensor", ins, attrs, tol=TOL, diff=["X"])


# ---------------------------------------------- affine_grid / unpool / spp
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape_tensor", [True, False])
def test_affine_grid(align, shape_tensor):
    ins = {"Theta": [_x(2, 2, 3)]}
    attrs = {"align_corners": align}
    if shape_tensor:
        ins["OutputShape"] = [np.array([2, 3, 4, 5], np.int32)]
    else:
        attrs["output_shape"] = [2, 3, 5, 4]
    run_both("affine_grid", ins, attrs, tol=TOL, diff=["Theta"])


def test_unpool_with_repeated_indices():
    r = np.random.RandomState(3)
    idx = r.randint(0, 36, (2, 3, 3, 3)).astype(np.int32)
    idx[0, 0, 0, :] = 7                              # one cell, three adds
    run_both("unpool", {"X": [_x(2, 3, 3, 3)], "Indices": [idx]},
             {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]},
             tol=TOL, diff=["X"])


@pytest.mark.parametrize("ptype", ["max", "avg"])
def test_spp(ptype):
    run_both("spp", {"X": [_x(2, 3, 7, 9)]},
             {"pyramid_height": 3, "pooling_type": ptype}, tol=TOL)


# -------------------------------------------------------------- RoI pools
def test_psroi_pool():
    r = np.random.RandomState(4)
    run_both("psroi_pool", {"X": [_x(2, 12, 8, 8)],
                            "ROIs": [_rois(r, 5, 16, 16)]},
             {"output_channels": 3, "spatial_scale": 0.5,
              "pooled_height": 2, "pooled_width": 2},
             lod={"ROIs": [((0, 2, 5),)]}, tol=TOL, diff=["X"])


@pytest.mark.parametrize("nums", [True, False])
def test_prroi_pool(nums):
    r = np.random.RandomState(5)
    ins = {"X": [_x(2, 3, 8, 8)], "ROIs": [_rois(r, 5, 16, 16)]}
    if nums:
        ins["BatchRoINums"] = [np.array([3, 2], np.int64)]
    run_both("prroi_pool", ins, {"spatial_scale": 0.5, "pooled_height": 3,
                                 "pooled_width": 2},
             lod={"ROIs": [((0, 2, 5),)]}, tol=TOL, diff=["X"])


# ------------------------------------------------------ transposed convs
@pytest.mark.parametrize("case", ["plain", "output_size", "groups"])
def test_conv3d_transpose(case):
    attrs = {"strides": [2, 2, 2], "paddings": [1, 1, 1]}
    ins = {"Input": [_x(1, 2, 3, 4, 4)], "Filter": [_x(2, 3, 2, 3, 2,
                                                       seed=1)],
           "Bias": [_x(3, seed=2)]}
    if case == "output_size":
        attrs["output_size"] = [5, 8, 7]
    elif case == "groups":
        ins = {"Input": [_x(1, 4, 3, 3, 3)], "Filter": [_x(4, 1, 2, 2, 2,
                                                           seed=1)]}
        attrs = {"groups": 2, "strides": [1, 2, 1], "paddings": [0, 1, 0],
                 "dilations": [2, 1, 1]}
    run_both("conv3d_transpose", ins, attrs, tol=MM_TOL)


def test_depthwise_conv2d_transpose():
    run_both("depthwise_conv2d_transpose",
             {"Input": [_x(1, 4, 5, 5)], "Filter": [_x(4, 1, 3, 3, seed=1)]},
             {"groups": 4, "strides": [2, 2], "paddings": [1, 1]},
             tol=MM_TOL)


# --------------------------------------------------------- the rest
def test_conv_shift():
    run_both("conv_shift", {"X": [_x(3, 7)], "Y": [_x(3, 3, seed=1)]},
             tol=TOL)


@pytest.mark.parametrize("align", [True, False])
def test_bicubic_interp(align):
    run_both("bicubic_interp", {"X": [_x(1, 2, 5, 6)]},
             {"out_h": 8, "out_w": 9, "align_corners": align}, tol=TOL,
             diff=["X"])


@pytest.mark.parametrize("align,mode", [(True, 1), (False, 0), (False, 1)])
def test_trilinear_interp(align, mode):
    run_both("trilinear_interp", {"X": [_x(1, 2, 3, 4, 5)]},
             {"out_d": 4, "out_h": 6, "out_w": 7, "align_corners": align,
              "align_mode": mode}, tol=TOL, diff=["X"])


def test_trilinear_interp_by_out_size_and_scale():
    run_both("trilinear_interp", {"X": [_x(1, 2, 3, 4, 5)],
                                  "OutSize": [np.array([5, 5, 6],
                                                       np.int32)]},
             {}, tol=TOL, diff=["X"])
    run_both("trilinear_interp", {"X": [_x(1, 2, 3, 4, 5)]}, {"scale": 1.5},
             tol=TOL, diff=["X"])


@pytest.mark.parametrize("axis", [1, 2, 3])
def test_similarity_focus(axis):
    x = _x(2, 3, 4, 5)
    x[0, 0, 1, :2] = 3.0                                   # a tied row
    run_both("similarity_focus", {"X": [x]},
             {"axis": axis, "indexes": [0, 2]}, grad=False, tol=TOL)


def test_polygon_box_transform():
    x = _x(1, 4, 3, 3)
    x[0, 1, 0, :] = 0.0
    run_both("polygon_box_transform", {"Input": [x]}, tol=TOL)


@pytest.mark.parametrize("act", ["identity", "elu", "leaky_relu"])
def test_inplace_abn(act):
    ins = {"X": [_x(2, 3, 4, 4)], "Scale": [_x(3, seed=1)],
           "Bias": [_x(3, seed=2)],
           "Mean": [np.zeros(3, np.float32)],
           "Variance": [np.ones(3, np.float32)]}
    run_both("inplace_abn", ins, {"activation": act, "alpha": 0.3},
             tol=TOL, diff=["X", "Scale", "Bias"])
