"""The conv-net ops of paddle_tpu_torch against the TPU package, on the CPU:
conv2d (and depthwise_conv2d), batch_norm, pool2d, flatten and flatten2
(paddle_tpu/ops/nn_ops.py:304-751, tensor_ops.py:308-320).

Each case feeds the same seeded numpy inputs to both packages' kernels:
every output at rtol = atol = 1e-5, and the port's generic grad (torch
autograd over the kernel) against the TPU package's (``jax.vjp`` of the
reference kernel) at 1e-5, the tolerance of
tests/test_torch_train_slice.py. The max pool over tied windows holds the
reference's split of a tie (lax.max's JVP), which ``F.max_pool2d`` does
not give.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels

from test_torch_mnist import _same
from test_torch_train_slice import _grad_both


def _r(seed):
    return np.random.RandomState(seed)


def _f32(r, *shape, scale=1.0):
    return (r.normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------------------ conv2d
# (id, input NCHW shape, filter shape, attrs, bias)
CONV_CASES = [
    ("explicit", (2, 4, 9, 9), (6, 4, 3, 3), {"paddings": [1, 1]}, False),
    ("explicit_pairs", (2, 4, 9, 8), (6, 4, 3, 3),
     {"paddings": [1, 0, 2, 1]}, False),
    ("same_stride2", (2, 4, 8, 8), (6, 4, 3, 3),
     {"padding_algorithm": "SAME", "strides": [2, 2]}, False),
    ("same_even_kernel", (2, 4, 7, 7), (6, 4, 4, 4),
     {"padding_algorithm": "SAME"}, False),
    ("valid", (2, 4, 9, 9), (6, 4, 3, 3),
     {"padding_algorithm": "VALID", "paddings": [1, 1]}, False),
    ("stride2", (2, 4, 11, 11), (6, 4, 3, 3),
     {"strides": [2, 2], "paddings": [1, 1]}, False),
    ("dilation2", (2, 4, 11, 11), (6, 4, 3, 3),
     {"dilations": [2, 2], "paddings": [2, 2]}, False),
    ("groups2", (2, 4, 9, 9), (6, 2, 3, 3),
     {"groups": 2, "paddings": [1, 1]}, False),
    ("bias", (2, 4, 9, 9), (6, 4, 3, 3), {"paddings": [1, 1]}, True),
    ("stem_7x7_s2", (2, 3, 16, 16), (8, 3, 7, 7),
     {"strides": [2, 2], "paddings": [3, 3]}, False),
    ("nhwc_bias", (2, 4, 9, 9), (6, 4, 3, 3),
     {"data_format": "NHWC", "paddings": [1, 1], "strides": [2, 2]}, True),
]


def _conv_ins(shape, wshape, attrs, bias, seed):
    r = _r(seed)
    x = _f32(r, *shape)
    if attrs.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    ins = {"Input": x, "Filter": _f32(r, *wshape, scale=0.3)}
    if bias:
        ins["Bias"] = _f32(r, wshape[0])
    return ins


@pytest.mark.parametrize("shape,wshape,attrs,bias",
                         [c[1:] for c in CONV_CASES],
                         ids=[c[0] for c in CONV_CASES])
def test_conv2d_forward(shape, wshape, attrs, bias):
    t = _same("conv2d", _conv_ins(shape, wshape, attrs, bias, 0), attrs)
    assert np.isfinite(t["Output"]).all()


@pytest.mark.parametrize("shape,wshape,attrs,bias",
                         [c[1:] for c in CONV_CASES],
                         ids=[c[0] for c in CONV_CASES])
def test_conv2d_grad(shape, wshape, attrs, bias):
    _grad_both("conv2d", _conv_ins(shape, wshape, attrs, bias, 1), attrs)


def test_depthwise_conv2d_forward_and_grad():
    attrs = {"groups": 4, "paddings": [1, 1], "strides": [2, 2]}
    ins = _conv_ins((2, 4, 9, 9), (4, 1, 3, 3), attrs, True, 2)
    _same("depthwise_conv2d", ins, attrs)
    _grad_both("depthwise_conv2d", ins, attrs)


def test_conv2d_padding_rule():
    """SAME's uneven split puts the odd element after, as
    _conv_padding does in the TPU package."""
    from paddle_tpu.ops.nn_ops import _conv_padding as jpad
    from paddle_tpu_torch.ops.nn_ops import _conv_padding as tpad
    for args in ((None, "SAME", 2, (3, 3), (2, 2), (1, 1), (8, 9)),
                 (None, "SAME", 2, (4, 4), (1, 1), (1, 1), (7, 7)),
                 (None, "SAME", 2, (3, 3), (1, 1), (2, 2), (5, 6)),
                 ([1, 2], "EXPLICIT", 2, (3, 3), (1, 1), (1, 1), (5, 5)),
                 ([1, 0, 2, 1], "EXPLICIT", 2, (3, 3), (1, 1), (1, 1),
                  (5, 5)),
                 ([3, 3], "VALID", 2, (3, 3), (1, 1), (1, 1), (5, 5))):
        assert tpad(*args) == jpad(*args), args
    assert tpad(None, "SAME", 2, (3, 3), (2, 2), (1, 1), (8, 8)) == \
        [(0, 1), (0, 1)]


# -------------------------------------------------------------- batch_norm
# (id, x shape, attrs)
BN_CASES = [
    ("train", (4, 3, 5, 5), {}),
    ("train_momentum_eps", (4, 3, 5, 5), {"momentum": 0.8,
                                          "epsilon": 1e-3}),
    ("is_test", (4, 3, 5, 5), {"is_test": True}),
    ("global_stats", (4, 3, 5, 5), {"use_global_stats": True}),
    ("fuse_relu", (4, 3, 5, 5), {"fuse_with_relu": True}),
    ("nhwc", (4, 5, 5, 3), {"data_layout": "NHWC"}),
    ("rows", (6, 3), {}),
]


def _bn_ins(shape, attrs, seed):
    r = _r(seed)
    c = shape[-1] if attrs.get("data_layout") == "NHWC" else shape[1]
    return {"X": _f32(r, *shape, scale=2.0) + 1.0,
            "Scale": _f32(r, c) + 1.0, "Bias": _f32(r, c),
            "Mean": _f32(r, c, scale=0.5),
            "Variance": (r.rand(c) + 0.5).astype(np.float32)}


@pytest.mark.parametrize("shape,attrs", [c[1:] for c in BN_CASES],
                         ids=[c[0] for c in BN_CASES])
def test_batch_norm_forward(shape, attrs):
    """All five outputs; in training MeanOut and VarianceOut are the
    moving statistics after one call, SavedVariance the inverse std."""
    ins = _bn_ins(shape, attrs, 3)
    t = _same("batch_norm", ins, attrs)
    x = ins["X"].astype(np.float64)
    axes = tuple(i for i in range(x.ndim)
                 if i != (x.ndim - 1 if attrs.get("data_layout") == "NHWC"
                          else 1))
    eps, mom = attrs.get("epsilon", 1e-5), attrs.get("momentum", 0.9)
    if attrs.get("is_test") or attrs.get("use_global_stats"):
        bm, bv = ins["Mean"], ins["Variance"]
        np.testing.assert_array_equal(t["MeanOut"], ins["Mean"])
        np.testing.assert_array_equal(t["VarianceOut"], ins["Variance"])
    else:
        bm, bv = x.mean(axes), x.var(axes)  # the biased variance
        np.testing.assert_allclose(
            t["MeanOut"], mom * ins["Mean"] + (1 - mom) * bm, rtol=1e-5,
            atol=1e-5)
        np.testing.assert_allclose(
            t["VarianceOut"], mom * ins["Variance"] + (1 - mom) * bv,
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t["SavedMean"], bm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t["SavedVariance"], 1 / np.sqrt(bv + eps),
                               rtol=1e-5, atol=1e-5)
    if attrs.get("fuse_with_relu"):
        assert (t["Y"] >= 0).all() and (t["Y"] == 0).any()


@pytest.mark.parametrize("shape,attrs", [c[1:] for c in BN_CASES],
                         ids=[c[0] for c in BN_CASES])
def test_batch_norm_grad(shape, attrs):
    g = _grad_both("batch_norm", _bn_ins(shape, attrs, 4), attrs)
    # the moving statistics take no grad; X, Scale and Bias do
    assert set(g) == {s + "@GRAD" for s in
                      ("X", "Scale", "Bias", "Mean", "Variance")}
    assert g["Mean@GRAD"] == [None] and g["Variance@GRAD"] == [None]


def test_batch_norm_is_not_torch_batch_norm():
    """``F.batch_norm``'s running variance is the unbiased one: after one
    training call it differs from the op's VarianceOut."""
    from paddle_tpu_torch.ops.registry import OPS
    ins = _bn_ins((2, 3, 2, 2), {}, 5)
    t = {k: torch.from_numpy(v) for k, v in ins.items()}
    got = OPS.get("batch_norm").kernel(
        {k: [v] for k, v in t.items()},
        dict(OPS.get("batch_norm").attr_defaults))
    rv = t["Variance"].clone()
    F.batch_norm(t["X"], t["Mean"].clone(), rv, t["Scale"], t["Bias"],
                 training=True, momentum=0.1, eps=1e-5)
    assert not torch.allclose(rv, got["VarianceOut"][0], rtol=1e-4)


# ------------------------------------------------------------------ pool2d
# (id, x shape, attrs)
POOL_CASES = [
    ("max_3x3_s2_p1", (2, 3, 9, 9), {"pooling_type": "max", "ksize": [3, 3],
                                     "strides": [2, 2],
                                     "paddings": [1, 1]}),
    ("max_2x2_s2", (2, 3, 8, 8), {"pooling_type": "max", "ksize": [2, 2],
                                  "strides": [2, 2]}),
    ("max_same", (2, 3, 7, 8), {"pooling_type": "max", "ksize": [2, 2],
                                "strides": [2, 2],
                                "padding_algorithm": "SAME"}),
    ("avg_p1_exclusive", (2, 3, 7, 7), {"pooling_type": "avg",
                                        "ksize": [3, 3],
                                        "paddings": [1, 1]}),
    ("avg_s2_p1_inclusive", (2, 3, 7, 7), {"pooling_type": "avg",
                                           "ksize": [3, 3],
                                           "strides": [2, 2],
                                           "paddings": [1, 1],
                                           "exclusive": False}),
    ("avg_unpadded", (2, 3, 8, 8), {"pooling_type": "avg", "ksize": [2, 2],
                                    "strides": [2, 2]}),
    ("global_max", (2, 3, 5, 6), {"pooling_type": "max",
                                  "global_pooling": True}),
    ("global_avg", (2, 3, 5, 6), {"pooling_type": "avg",
                                  "global_pooling": True}),
    ("adaptive_max", (2, 3, 4, 6), {"pooling_type": "max", "adaptive": True,
                                    "ksize": [2, 3]}),
    ("adaptive_avg", (2, 3, 4, 6), {"pooling_type": "avg", "adaptive": True,
                                    "ksize": [2, 2]}),
    ("adaptive_1x1", (2, 3, 4, 6), {"pooling_type": "avg", "adaptive": True,
                                    "ksize": [1, 1]}),
    ("nhwc_max", (2, 7, 7, 3), {"pooling_type": "max", "ksize": [3, 3],
                                "strides": [2, 2], "paddings": [1, 1],
                                "data_format": "NHWC"}),
    ("nhwc_avg", (2, 7, 7, 3), {"pooling_type": "avg", "ksize": [3, 3],
                                "paddings": [1, 1], "data_format": "NHWC"}),
    ("nhwc_adaptive", (2, 4, 6, 3), {"pooling_type": "max",
                                     "adaptive": True, "ksize": [2, 3],
                                     "data_format": "NHWC"}),
]


@pytest.mark.parametrize("shape,attrs", [c[1:] for c in POOL_CASES],
                         ids=[c[0] for c in POOL_CASES])
def test_pool2d_forward(shape, attrs):
    _same("pool2d", {"X": _f32(_r(6), *shape)}, attrs)


@pytest.mark.parametrize("shape,attrs", [c[1:] for c in POOL_CASES],
                         ids=[c[0] for c in POOL_CASES])
def test_pool2d_grad(shape, attrs):
    _grad_both("pool2d", {"X": _f32(_r(7), *shape)}, attrs)


def _tied(shape, seed):
    """A ReLU's output as the stem pools it: many exact zeros, and small
    integers that repeat within a window."""
    x = _r(seed).randint(-3, 3, size=shape).astype(np.float32)
    return np.maximum(x, 0.0)


@pytest.mark.parametrize("shape,attrs", [
    ((2, 3, 9, 9), {"pooling_type": "max", "ksize": [3, 3],
                    "strides": [2, 2], "paddings": [1, 1]}),
    ((2, 3, 8, 8), {"pooling_type": "max", "ksize": [2, 2],
                    "strides": [2, 2]}),
    ((2, 3, 4, 6), {"pooling_type": "max", "global_pooling": True}),
    ((2, 3, 4, 6), {"pooling_type": "max", "adaptive": True,
                    "ksize": [2, 3]}),
], ids=["stem", "lenet", "global", "adaptive"])
def test_max_pool_tied_windows_grad_matches_jax_vjp(shape, attrs):
    x = _tied(shape, 8)
    g = _grad_both("pool2d", {"X": x}, attrs)["X@GRAD"][0].numpy()
    if attrs.get("global_pooling") or attrs.get("adaptive"):
        return
    # a split tie leaves fractions of the cotangent where F.max_pool2d
    # sends all of it to one element
    xt = torch.from_numpy(x).requires_grad_()
    o = F.max_pool2d(xt, attrs["ksize"], attrs["strides"],
                     attrs.get("paddings", [0, 0]))
    gout = np.random.RandomState(99).normal(size=o.shape).astype(np.float32)
    ref = torch.autograd.grad(o, xt, torch.from_numpy(gout))[0].numpy()
    assert not np.allclose(g, ref, atol=1e-5)


def test_max_pool_three_way_tie_splits_quarter_quarter_half():
    """Three equal slices chained: ¼, ¼, ½ of the cotangent (JAX's
    lax.max JVP at each link)."""
    from paddle_tpu_torch.ops.registry import OPS
    x = torch.zeros(1, 1, 1, 3, requires_grad=True)
    o = OPS.get("pool2d").kernel({"X": [x]}, dict(
        OPS.get("pool2d").attr_defaults, ksize=[1, 3],
        strides=[1, 1]))["Out"][0]
    (g,) = torch.autograd.grad(o, x, torch.ones_like(o))
    assert g.reshape(-1).tolist() == [0.25, 0.25, 0.5]


# ------------------------------------------------------------- flatten(2)
@pytest.mark.parametrize("op_type", ["flatten", "flatten2"])
@pytest.mark.parametrize("axis", [1, 2])
def test_flatten(op_type, axis):
    x = _f32(_r(9), 2, 3, 4, 5)
    t = _same(op_type, {"X": x}, {"axis": axis})
    assert t["Out"].shape == (int(np.prod(x.shape[:axis])),
                              int(np.prod(x.shape[axis:])))
    if op_type == "flatten2":
        assert t["XShape"].shape == (0,) + x.shape
    _grad_both(op_type, {"X": x}, {"axis": axis})
