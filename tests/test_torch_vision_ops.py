"""The vision and math op batch in paddle_tpu_torch against the TPU
package's kernels, on the CPU: nn_ops.py's norms (instance_norm,
group_norm, norm, data_norm, lrn, sync_batch_norm), convolutions and
pools (conv3d, conv2d_transpose, pool3d, max_pool2d_with_index,
max_pool3d_with_index), resizes and rearrangements (nearest_interp,
bilinear_interp, pixel_shuffle, space_to_depth, shuffle_channel),
math_ops.py's 17 (matmul_v2 ... cholesky) and nn_extra_ops.py's 13
(maxout ... squared_l2_distance):

- each op's outputs on numpy inputs made from a seed: integer outputs
  (the pools' Mask, mean_iou's counts, allclose) exactly, float outputs
  at rtol 1e-5, atol 1e-6 (the port's op tests' tolerance,
  tests/test_torch_sequence_ops.py); the convolutions and the linear
  algebra at rtol 1e-4, atol 1e-5 (a product's sums in another order);
- the generic grads of each differentiable op under a seeded output
  grad, at the same tolerance;
- ties: the indexed max pools' Mask holds the first of equal maxima, as
  ``jnp.argmax``; their grads split a tie evenly, as ``jnp.max``'s;
- mean_iou over labels 255 and −1 (outside the classes): the port masks
  such an index before its scatter, the TPU kernel's scatter drops it;
- the resizes' every ``align_corners`` / ``align_mode`` branch;
- the registration flags as the TPU package registers them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad

RTOL, ATOL = 1e-5, 1e-6
MM_TOL = (1e-4, 1e-5)

NEW_OPS = (
    "instance_norm", "group_norm", "norm", "data_norm", "lrn",
    "sync_batch_norm", "conv3d", "conv2d_transpose", "pool3d",
    "max_pool2d_with_index", "max_pool3d_with_index", "nearest_interp",
    "bilinear_interp", "pixel_shuffle", "space_to_depth", "shuffle_channel",
    "matmul_v2", "bmm", "dot", "mv", "addmm", "kron", "trace", "logsumexp",
    "frobenius_norm", "p_norm", "dist", "prelu", "maximum", "minus",
    "allclose", "inverse", "cholesky",
    "maxout", "affine_channel", "bilinear_tensor_product", "cvm", "fsp",
    "temporal_shift", "unfold", "mean_iou", "row_conv", "sigmoid_focal_loss",
    "iou_similarity", "pad_constant_batch_size_like", "squared_l2_distance")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: small kernels, several test processes share
    the host's cores, and bitwise reruns must not see a product split
    differently."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _attrs(ops, op_type, attrs):
    return dict(ops.get(op_type).attr_defaults, **attrs)


def run_both(op_type, ins, attrs=None, grad=True, grad_seed=7, tol=None,
             lod=None, diff=None):
    """Both packages' kernels on numpy ``ins`` (slot → list of arrays):
    every output compared (integers exactly, floats at ``tol``), then
    with ``grad`` the generic grads of the ``diff`` slots (all the input
    slots by default). ``lod``: the ``_lod`` attr of a LoD op. → the
    port's outputs."""
    rtol, atol = tol or (RTOL, ATOL)
    attrs = dict(attrs or {})
    if lod is not None:
        attrs["_lod"] = lod
    tattrs = _attrs(TOPS, op_type, attrs)
    jattrs = _attrs(JOPS, op_type, attrs)
    tins = {s: [torch.from_numpy(np.asarray(a)) for a in v]
            for s, v in ins.items()}
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    tout = TOPS.get(op_type).kernel(tins, tattrs)
    jout = JOPS.get(op_type).kernel(jins, jattrs)
    assert {k for k in tout if not k.startswith("_")} == \
        {k for k in jout if not k.startswith("_")}
    r = np.random.RandomState(grad_seed)
    for slot in jout:
        if slot.startswith("_"):
            assert tout[slot] == jout[slot], slot
            continue
        assert len(tout[slot]) == len(jout[slot]), slot
        for i, (tv, jv) in enumerate(zip(tout[slot], jout[slot])):
            t, j = tv.detach().numpy(), np.asarray(jv)
            assert t.shape == j.shape, (slot, i, t.shape, j.shape)
            if np.issubdtype(j.dtype, np.floating):
                np.testing.assert_allclose(t, j, rtol=rtol, atol=atol,
                                           err_msg=f"{slot}[{i}]")
            else:
                np.testing.assert_array_equal(t, j, err_msg=f"{slot}[{i}]")
        if grad and np.issubdtype(np.asarray(jout[slot][0]).dtype,
                                  np.floating):
            gs = [r.normal(size=np.asarray(j).shape).astype(np.float32)
                  for j in jout[slot]]
            tins[slot + "@GRAD"] = [torch.from_numpy(g) for g in gs]
            jins[slot + "@GRAD"] = [jnp.asarray(g) for g in gs]
    if grad:
        slots = list(diff or ins)
        wanted = [s + "@GRAD" for s in slots]
        tg = t_generic_grad(op_type, tins, tattrs, wanted, list(ins))
        jg = j_generic_grad(op_type, jins, jattrs, wanted, list(ins))
        assert any(v is not None for s in jg for v in jg[s])
        for slot in jg:
            for t, j in zip(tg.get(slot) or [], jg[slot]):
                assert (t is None) == (j is None), slot
                if j is not None:
                    np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                               rtol=rtol, atol=atol,
                                               err_msg=slot)
    return tout


def test_every_op_registered_with_the_reference_flags():
    for t in NEW_OPS:
        ti, ji = TOPS.get(t), JOPS.get(t)
        for flag in ("no_grad", "stateful", "needs_rng", "needs_lod"):
            assert getattr(ti, flag) == getattr(ji, flag), (t, flag)
        assert list(ti.diff_input_slots or []) == \
            list(ji.diff_input_slots or []), t
        assert tuple(ti.host_inputs) == tuple(ji.host_inputs), t


# ------------------------------------------------------------- norms
X4 = _x((2, 6, 5, 4))
SCALE6, BIAS6 = _x((6,), 1) + 1.0, _x((6,), 2)
NORMS = [
    ("instance_norm", {"X": [X4], "Scale": [SCALE6], "Bias": [BIAS6]},
     {"epsilon": 1e-5}),
    ("instance_norm", {"X": [_x((3, 4, 7))]}, {}),
    ("group_norm", {"X": [X4], "Scale": [SCALE6], "Bias": [BIAS6]},
     {"groups": 3}),
    # read as NCHW whatever data_layout says, as the TPU kernel
    ("group_norm", {"X": [X4]}, {"groups": 2, "data_layout": "NHWC"}),
    ("norm", {"X": [_x((3, 5, 4))]}, {"axis": 1}),
    ("data_norm", {"X": [_x((4, 3))], "BatchSize": [np.full(3, 8.0, "f4")],
                   "BatchSum": [_x((3,), 3)],
                   "BatchSquareSum": [np.abs(_x((3,), 4)) + 4.0]}, {}),
    ("lrn", {"X": [X4]}, {"n": 5, "k": 1.0, "alpha": 1e-2, "beta": 0.75}),
    ("lrn", {"X": [X4.transpose(0, 2, 3, 1).copy()]},
     {"n": 3, "data_format": "NHWC"}),
    ("sync_batch_norm", {"X": [X4], "Scale": [SCALE6], "Bias": [BIAS6],
                         "Mean": [np.zeros(6, "f4")],
                         "Variance": [np.ones(6, "f4")]}, {}),
]


@pytest.mark.parametrize("op_type,ins,attrs", NORMS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(NORMS)])
def test_norms(op_type, ins, attrs):
    diff = [s for s in ("X", "Scale", "Bias") if s in ins]
    run_both(op_type, ins, attrs, diff=diff)


def test_instance_norm_saved_variance_is_the_inverse_std():
    o = run_both("instance_norm", {"X": [X4]}, grad=False)
    var = X4.reshape(2 * 6, -1).var(-1)
    np.testing.assert_allclose(o["SavedVariance"][0].numpy(),
                               1 / np.sqrt(var + 1e-5), rtol=1e-5)


# ----------------------------------------------------- conv and pool
CONVS = [
    ("conv3d", {"Input": [_x((2, 3, 5, 6, 4))],
                "Filter": [_x((4, 3, 3, 2, 3), 1)]},
     {"strides": [1, 2, 1], "paddings": [1, 0, 1]}),
    ("conv3d", {"Input": [_x((1, 4, 4, 5, 5))],
                "Filter": [_x((4, 2, 2, 3, 3), 1)]},
     {"groups": 2, "dilations": [1, 1, 2], "padding_algorithm": "SAME"}),
    ("conv2d_transpose", {"Input": [_x((2, 4, 5, 6))],
                          "Filter": [_x((4, 3, 3, 3), 1)]},
     {"strides": [2, 2], "paddings": [1, 1], "output_size": [10, 12]}),
    ("conv2d_transpose", {"Input": [_x((2, 4, 5, 6))],
                          "Filter": [_x((4, 3, 3, 3), 1)]},
     {"strides": [2, 2], "paddings": [1, 1], "output_size": [8, 10]}),
    ("conv2d_transpose", {"Input": [_x((1, 4, 4, 4))],
                          "Filter": [_x((4, 2, 3, 2), 1)],
                          "Bias": [_x((4,), 2)]},
     {"strides": [1, 2], "paddings": [0, 2, 1, 0], "groups": 2,
      "dilations": [2, 1]}),
    ("conv2d_transpose", {"Input": [_x((1, 3, 5, 5))],
                          "Filter": [_x((3, 2, 4, 4), 1)]},
     {"strides": [2, 2], "paddings": [1, 1]}),
]


@pytest.mark.parametrize("op_type,ins,attrs", CONVS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONVS)])
def test_convolutions(op_type, ins, attrs):
    run_both(op_type, ins, attrs, tol=MM_TOL)


X5 = _x((2, 3, 6, 5, 4))
POOLS = [
    ("pool3d", {"X": [X5]}, {"ksize": [2, 2, 2], "strides": [2, 1, 2],
                             "paddings": [1, 0, 1]}),
    ("pool3d", {"X": [X5]}, {"pooling_type": "avg", "ksize": [3, 2, 2],
                             "strides": [1, 2, 1], "paddings": [1, 1, 0]}),
    ("pool3d", {"X": [X5]}, {"pooling_type": "avg", "ksize": [3, 2, 2],
                             "strides": [1, 2, 1], "paddings": [1, 1, 0],
                             "exclusive": False}),
    ("pool3d", {"X": [X5]}, {"pooling_type": "avg", "ksize": [3, 5, 2],
                             "adaptive": True}),
    ("pool3d", {"X": [X5]}, {"ksize": [2, 1, 2], "adaptive": True}),
    ("pool3d", {"X": [X5]}, {"global_pooling": True, "ksize": [2, 2, 2]}),
    ("max_pool2d_with_index", {"X": [_x((2, 3, 7, 6))]},
     {"ksize": [3, 2], "strides": [2, 2], "paddings": [1, 0]}),
    ("max_pool2d_with_index", {"X": [_x((2, 3, 4, 4))]},
     {"global_pooling": True}),
    ("max_pool3d_with_index", {"X": [X5]},
     {"ksize": [2, 2, 2], "strides": [2, 2, 1], "paddings": [0, 1, 1]}),
    ("max_pool3d_with_index", {"X": [X5]},
     {"ksize": [3, 5, 2], "adaptive": True}),
]


@pytest.mark.parametrize("op_type,ins,attrs", POOLS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(POOLS)])
def test_pools(op_type, ins, attrs):
    run_both(op_type, ins, attrs)


def test_indexed_max_pools_ties_take_the_first():
    """A plane of equal values: Mask holds each window's first element,
    and the grad splits evenly over the tied elements, in both."""
    x = np.ones((1, 2, 4, 4), np.float32)
    x[0, 1, :2, :2] = 3.0
    run_both("max_pool2d_with_index", {"X": [x]},
             {"ksize": [2, 2], "strides": [2, 2]})
    run_both("max_pool3d_with_index", {"X": [x[:, :, None]]},
             {"ksize": [1, 2, 2], "strides": [1, 2, 2]})


# ----------------------------------------------------------- resize
XR = _x((2, 3, 5, 7))
RESIZES = [(op, {"out_h": oh, "out_w": ow, "align_corners": ac,
                 "align_mode": am})
           for op in ("bilinear_interp", "nearest_interp")
           for oh, ow in ((9, 12), (3, 4), (5, 7))
           for ac in (True, False) for am in (0, 1)]


@pytest.mark.parametrize("op_type,attrs", RESIZES,
                         ids=[f"{o}-{a['out_h']}x{a['out_w']}-"
                              f"ac{int(a['align_corners'])}-am"
                              f"{a['align_mode']}" for o, a in RESIZES])
def test_resizes(op_type, attrs):
    run_both(op_type, {"X": [XR]}, attrs)


@pytest.mark.parametrize("op_type", ["bilinear_interp", "nearest_interp"])
def test_resize_size_from_tensors_and_scale(op_type):
    run_both(op_type, {"X": [XR], "OutSize": [np.array([8, 6], np.int32)]},
             {"out_h": 3, "out_w": 3}, diff=["X"])
    run_both(op_type, {"X": [XR]}, {"scale": 1.5})
    run_both(op_type, {"X": [XR], "Scale": [np.array([2.0], np.float32)]},
             diff=["X"])


REARRANGE = [
    ("pixel_shuffle", {"X": [_x((2, 8, 3, 4))]}, {"upscale_factor": 2}),
    ("space_to_depth", {"X": [_x((2, 3, 4, 6))]}, {"blocksize": 2}),
    ("shuffle_channel", {"X": [_x((2, 6, 3, 2))]}, {"group": 3}),
]


@pytest.mark.parametrize("op_type,ins,attrs", REARRANGE,
                         ids=[c[0] for c in REARRANGE])
def test_rearrangements(op_type, ins, attrs):
    run_both(op_type, ins, attrs)


# ------------------------------------------------------------- math
def _spd(n, seed):
    a = _x((n, n), seed)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


MATH = [
    ("matmul_v2", {"X": [_x((2, 3, 4))], "Y": [_x((2, 5, 4), 1)]},
     {"trans_y": True}),
    ("matmul_v2", {"X": [_x((4, 3))], "Y": [_x((4, 2), 1)]},
     {"trans_x": True}),
    ("bmm", {"X": [_x((2, 3, 4))], "Y": [_x((2, 4, 5), 1)]}, {}),
    ("dot", {"X": [_x((3, 4))], "Y": [_x((3, 4), 1)]}, {}),
    ("dot", {"X": [_x((5,))], "Y": [_x((5,), 1)]}, {}),
    ("mv", {"X": [_x((3, 4))], "Vec": [_x((4,), 1)]}, {}),
    ("addmm", {"Input": [_x((3, 5))], "X": [_x((3, 4), 1)],
               "Y": [_x((4, 5), 2)]}, {"Alpha": 0.5, "Beta": 2.0}),
    ("kron", {"X": [_x((2, 3))], "Y": [_x((3, 2), 1)]}, {}),
    ("trace", {"Input": [_x((3, 4, 5))]}, {"offset": 1, "axis1": 1,
                                           "axis2": 2}),
    ("logsumexp", {"X": [_x((3, 4, 5))]}, {"axis": [1, 2]}),
    ("logsumexp", {"X": [_x((3, 4))]}, {"reduce_all": True}),
    ("frobenius_norm", {"X": [_x((3, 4, 5))]}, {"dim": [1, 2],
                                                "keep_dim": True}),
    ("p_norm", {"X": [np.abs(_x((3, 4))) + 0.1]}, {"porder": 3.0,
                                                    "axis": 1}),
    ("dist", {"X": [_x((3, 4))], "Y": [_x((3, 4), 1)]}, {"p": 2.0}),
    ("dist", {"X": [_x((3, 4))], "Y": [_x((3, 4), 1)]}, {"p": float("inf")}),
    ("dist", {"X": [_x((3, 4))], "Y": [_x((3, 4), 1)]}, {"p": 0.0}),
    ("prelu", {"X": [X4], "Alpha": [np.array([0.2], np.float32)]}, {}),
    ("prelu", {"X": [X4], "Alpha": [_x((6,), 1)]}, {"mode": "channel"}),
    ("prelu", {"X": [X4], "Alpha": [_x((6, 5, 4), 1)]}, {"mode": "element"}),
    ("maximum", {"X": [_x((3, 4))], "Y": [_x((3, 4), 1)]}, {}),
    ("minus", {"X": [_x((3, 4))], "Y": [_x((3, 4), 1)]}, {}),
    ("inverse", {"Input": [_spd(4, 1)]}, {}),
    ("cholesky", {"X": [_spd(4, 2)]}, {}),
    ("cholesky", {"X": [np.stack([_spd(3, 3), _spd(3, 4)])]},
     {"upper": True}),
]


@pytest.mark.parametrize("op_type,ins,attrs", MATH,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(MATH)])
def test_math(op_type, ins, attrs):
    run_both(op_type, ins, attrs, tol=MM_TOL)


def test_allclose():
    a = _x((3, 4))
    for b, kw in ((a + 1e-7, {}), (a + 1e-3, {}),
                  (a + 1e-3, {"atol": 1e-2})):
        o = run_both("allclose", {"Input": [a], "Other": [b]}, kw,
                     grad=False)
        assert o["Out"][0].dtype == torch.bool


# -------------------------------------------------------- nn_extra
EXTRA = [
    ("maxout", {"X": [X4]}, {"groups": 3}),
    ("maxout", {"X": [X4.transpose(0, 2, 3, 1).copy()]},
     {"groups": 2, "axis": -1}),
    ("affine_channel", {"X": [X4], "Scale": [SCALE6], "Bias": [BIAS6]}, {}),
    ("affine_channel", {"X": [X4.transpose(0, 2, 3, 1).copy()],
                        "Scale": [SCALE6], "Bias": [BIAS6]},
     {"data_layout": "NHWC"}),
    ("bilinear_tensor_product", {"X": [_x((3, 4))], "Y": [_x((3, 5), 1)],
                                 "Weight": [_x((2, 4, 5), 2)],
                                 "Bias": [_x((1, 2), 3)]}, {}),
    ("cvm", {"X": [np.abs(_x((4, 5))) * 3], "CVM": [_x((4, 2), 1)]}, {}),
    ("cvm", {"X": [_x((4, 5))], "CVM": [_x((4, 2), 1)]},
     {"use_cvm": False}),
    ("fsp", {"X": [_x((2, 3, 4, 5))], "Y": [_x((2, 4, 4, 5), 1)]}, {}),
    ("temporal_shift", {"X": [_x((6, 8, 3, 2))]}, {"seg_num": 3}),
    ("temporal_shift", {"X": [_x((4, 6, 2, 2))]},
     {"seg_num": 2, "shift_ratio": 0.3}),
    ("unfold", {"X": [_x((2, 3, 6, 5))]},
     {"kernel_sizes": [3, 2], "strides": [2, 1], "paddings": [1, 0, 1, 1],
      "dilations": [1, 2]}),
    ("row_conv", {"X": [_x((2, 6, 4))], "Filter": [_x((3, 4), 1)]}, {}),
    ("sigmoid_focal_loss", {"X": [_x((5, 4))],
                            "Label": [np.array([[0], [1], [4], [2], [-1]],
                                               np.int32)],
                            "FgNum": [np.array([3], np.int32)]},
     {"gamma": 2.0, "alpha": 0.25}),
    ("iou_similarity", {"X": [np.sort(np.abs(_x((3, 4))), -1)[:, [0, 1, 2,
                                                                   3]]],
                        "Y": [np.sort(np.abs(_x((5, 4), 1)), -1)]}, {}),
    ("iou_similarity", {"X": [np.sort(np.abs(_x((3, 4))) * 10, -1)],
                        "Y": [np.sort(np.abs(_x((5, 4), 1)) * 10, -1)]},
     {"box_normalized": False}),
    ("pad_constant_batch_size_like", {"X": [_x((4, 3))],
                                      "Y": [_x((2, 3), 1)]}, {}),
    ("squared_l2_distance", {"X": [_x((4, 3, 2))], "Y": [_x((4, 3, 2), 1)]},
     {}),
]


@pytest.mark.parametrize("op_type,ins,attrs", EXTRA,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(EXTRA)])
def test_nn_extra(op_type, ins, attrs):
    diff = list(TOPS.get(op_type).diff_input_slots or
                [s for s, v in ins.items()
                 if np.issubdtype(np.asarray(v[0]).dtype, np.floating)])
    run_both(op_type, ins, attrs, diff=[s for s in diff if s in ins],
             grad=not TOPS.get(op_type).no_grad)


@pytest.mark.parametrize("bad", [255, -1])
def test_mean_iou_with_labels_outside_the_classes(bad):
    """Labels 255 and −1 (DeepLabv3+'s ignored pixels): their index lies
    outside the k·k matrix (or wraps into it with 0 added, for −1); the
    counts, wrong and correct match the TPU kernel's exactly."""
    r = np.random.RandomState(3)
    k = 5
    label = r.randint(0, k, (2, 8, 8)).astype(np.int32)
    label[r.rand(2, 8, 8) < 0.3] = bad
    pred = r.randint(0, k, (2, 8, 8)).astype(np.int32)
    o = run_both("mean_iou", {"Predictions": [pred], "Labels": [label]},
                 {"num_classes": k}, grad=False)
    ok = (label >= 0) & (label < k)
    cm = np.zeros((k, k), np.int64)
    np.add.at(cm, (label[ok], pred[ok]), 1)
    np.testing.assert_array_equal(o["OutCorrect"][0].numpy(), np.diag(cm))
