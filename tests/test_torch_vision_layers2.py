"""The deformable ops of the second vision batch (deformable_conv,
deformable_conv_v1, deformable_psroi_pooling: outputs and generic grads
at rtol 1e-4, atol 1e-5, as test_torch_vision_ops2.py holds the others)
and the layers over the batch and the RoI ops on paddle_tpu_torch
against the TPU package, on the CPU: the layers that
raised before (conv3d_transpose, resize_trilinear, image_resize's
TRILINEAR, affine_grid, crop, crop_tensor, deformable_conv,
deformable_roi_pooling, inplace_abn, prroi_pool, psroi_pool,
similarity_focus) and roi_pool and roi_align in one program in both
packages: two SGD steps, every output and the loss at rtol 1e-4, atol
1e-5, the port's segmented run bitwise its interpreter's;
image_resize's BICUBIC is a KeyError in both.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_detection_ops import _rois
from tests.test_torch_vision_ops import run_both
from tests.test_torch_vision_ops2 import MM_TOL, TOL, _x


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _deform_ins(modulated, dg=2, seed=8):
    r = np.random.RandomState(seed)
    ins = {"Input": [_x(2, 4, 6, 6, seed=seed)],
           "Offset": [(r.normal(0, 1.5, (2, dg * 18, 6, 6))).astype(
               np.float32)],
           "Filter": [_x(6, 2, 3, 3, seed=seed + 1)]}
    if modulated:
        ins["Mask"] = [r.rand(2, dg * 9, 6, 6).astype(np.float32)]
    return ins


ATTRS_DEFORM = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
                "groups": 2, "deformable_groups": 2}


def test_deformable_conv():
    run_both("deformable_conv", _deform_ins(True), ATTRS_DEFORM,
             tol=MM_TOL)


def test_deformable_conv_v1_strided():
    ins = _deform_ins(False, dg=1, seed=9)
    ins["Offset"] = [ins["Offset"][0][:, :, ::2, ::2].copy()]
    run_both("deformable_conv_v1", ins,
             dict(ATTRS_DEFORM, strides=[2, 2], deformable_groups=1),
             tol=MM_TOL)


@pytest.mark.parametrize("no_trans", [False, True])
def test_deformable_psroi_pooling(no_trans):
    r = np.random.RandomState(6)
    ins = {"Input": [_x(2, 8, 8, 8)], "ROIs": [_rois(r, 4, 16, 16)],
           "Trans": [_x(4, 2, 2, 2, seed=7) * 0.3]}
    run_both("deformable_psroi_pooling", ins,
             {"no_trans": no_trans, "spatial_scale": 0.5, "output_dim": 2,
              "group_size": [2, 2], "pooled_height": 2, "pooled_width": 2,
              "part_size": [2, 2], "sample_per_part": 2, "trans_std": 0.2},
             lod={"ROIs": [((0, 1, 4),)]}, tol=TOL,
             diff=["Input", "Trans"])



def vision2_layers_program(fluid):
    """Every layer that raised before this batch, and roi_pool and
    roi_align, in one program; the loss over the differentiable ones (the
    backward of roi_pool and inplace_abn raises in both packages)."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        v5 = fluid.data("v5", [2, 3, 4, 4], "float32")
        img = fluid.data("img", [4, 8, 8], "float32")
        rois = fluid.data("rois", [4], "float32", lod_level=1)
        theta = fluid.data("theta", [2, 3], "float32")
        trans = fluid.data("trans", [2, 2, 2], "float32")
        h = L.conv2d(img, 4, 3, padding=1)
        off = L.conv2d(img, 18, 3, padding=1)
        msk = L.sigmoid(L.conv2d(img, 9, 3, padding=1))
        diff = [
            L.conv3d_transpose(v5, 3, filter_size=2, stride=2, padding=1),
            L.resize_trilinear(L.scale(v5, 2.0), out_shape=[4, 6, 5]),
            L.image_resize(L.scale(v5, 3.0), scale=2.0,
                           resample="TRILINEAR"),
            L.affine_grid(L.scale(theta, 1.5), [2, 4, 5, 6]),
            L.crop(h, shape=[2, 2, 5, 5], offsets=[0, 1, 2, 1]),
            L.crop_tensor(h, shape=[1, 4, 6, 6], offsets=[1, 0, 1, 2]),
            L.deformable_conv(h, off, msk, 4, 3, padding=1),
            L.deformable_conv(h, off, None, 4, 3, padding=1,
                              modulated=False),
            L.deformable_roi_pooling(h, rois, trans, pooled_height=2,
                                     pooled_width=2, part_size=[2, 2],
                                     sample_per_part=2),
            L.prroi_pool(h, rois, 0.5, 2, 2),
            L.psroi_pool(h, rois, 1, 0.5, 2, 2),
            L.roi_align(h, rois, 2, 2, 0.5, 2)]
        fwd = [L.inplace_abn(img, act="leaky_relu", act_alpha=0.2),
               L.similarity_focus(img, axis=1, indexes=[0, 2]),
               L.roi_pool(img, rois, 2, 2, 0.5)]
        loss = L.sums([L.reduce_mean(v) for v in diff])
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, diff + fwd


def _layers_feed(r):
    rois = _rois(r, 5, 16, 16)
    return {"v5": r.normal(size=(2, 2, 3, 4, 4)).astype(np.float32),
            "img": r.normal(size=(2, 4, 8, 8)).astype(np.float32),
            "rois": (rois, [0, 2, 5]),
            "theta": r.normal(size=(2, 2, 3)).astype(np.float32),
            "trans": (r.normal(size=(5, 2, 2, 2)) * 0.3).astype(np.float32)}


def test_the_layers_in_both_packages():
    from tests.test_torch_vision_models import _Pair, _agree, _both
    from tests.test_torch_models_a7 import _persistables
    j, t = _both(vision2_layers_program)
    assert [op.type for op in t[0].global_block().ops] == \
        [op.type for op in j[0].global_block().ops]
    pair = _Pair([t[1]], _persistables(j[0]))
    feed = _layers_feed(np.random.RandomState(12))
    for step in range(2):
        jo, to = pair.run(j[0], t[0], feed, [j[2]] + list(j[3]),
                          [t[2]] + list(t[3]), mode="segmented")
        _agree(jo, to, f"step {step}")
    pair.same_state(t[0])


def test_image_resize_bicubic_is_a_key_error_in_both():
    import paddle_tpu.fluid as jfluid
    from paddle_tpu_torch import fluid as tfluid
    for fluid in (jfluid, tfluid):
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            x = fluid.data("x", [2, 4, 4], "float32")
            with pytest.raises(KeyError, match="BICUBIC"):
                fluid.layers.image_resize(x, [8, 8], resample="BICUBIC")
