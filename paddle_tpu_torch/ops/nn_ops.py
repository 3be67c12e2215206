"""NN op kernels (counterpart of paddle_tpu/ops/nn_ops.py: every op type
it registers): the embedding, the convolutions (conv2d, depthwise_conv2d,
conv3d, conv2d_transpose), the pools (pool2d, pool3d and the two indexed
max pools), the norms (batch_norm, sync_batch_norm, layer_norm,
instance_norm, group_norm, norm, data_norm, lrn), softmax, log_softmax
and the losses, the metrics accuracy and auc, dropout with its
dropout_grad, and the resizes and rearrangements (nearest_interp,
bilinear_interp, pixel_shuffle, space_to_depth, shuffle_channel).

The convolutions are cuDNN's, through ``aten.convolution``, as the TPU
package's are XLA's ``lax.conv_general_dilated``; pooling, the norms and
the resizes are torch expressions of the TPU package's own formulas."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .cuda import dropout as cuda_dropout
from .math_ops import bf16_matmul_enabled, scalar_as
from .registry import register_grad_maker, register_op, first, out
from .tensor_ops import take_index, take_rows


# --------------------------------------------------------------------------
# embedding
# --------------------------------------------------------------------------
def _lookup(w, ids, padding_idx):
    """Rows ``ids`` of ``w`` by ``tensor_ops.take_rows`` (a repeated id's
    rows summed in a fixed order in the grad), the ``padding_idx`` rows
    zero."""
    o = take_rows(w, ids)
    if padding_idx is not None and padding_idx >= 0:
        o = torch.where((ids == padding_idx)[..., None],
                        torch.zeros((), dtype=o.dtype, device=o.device), o)
    return o


@register_op("lookup_table", inputs=("W", "Ids"), diff_inputs=("W",),
             attr_defaults={"padding_idx": -1, "is_sparse": False,
                            "is_distributed": False, "remote_prefetch": False})
def _lookup_table(ins, attrs):
    """The v1 op: Ids [..., 1], the trailing 1 squeezed; its grad is
    ``_lookup``'s, the rows summed in a fixed order."""
    w, ids = first(ins, "W"), first(ins, "Ids")
    pad = attrs.get("padding_idx", -1)
    return out(Out=_lookup(w, ids.squeeze(-1), pad if pad >= 0 else None))


@register_op("lookup_table_v2", inputs=("W", "Ids"), diff_inputs=("W",),
             attr_defaults={"padding_idx": -1, "is_sparse": False,
                            "is_distributed": False, "remote_prefetch": False})
def _lookup_table_v2(ins, attrs):
    w, ids = first(ins, "W"), first(ins, "Ids")
    pad = attrs.get("padding_idx", -1)
    return out(Out=_lookup(w, ids, pad if pad >= 0 else None))


# --------------------------------------------------------------------------
# conv / pool
# --------------------------------------------------------------------------
def _conv_padding(paddings, algo, ndim, ksize, strides, dilations, in_shape):
    """[(before, after)] a spatial dim. SAME pads what keeps ceil(in /
    stride) outputs, the odd element after (unevenly with an even kernel
    or a stride of 2); VALID pads nothing; EXPLICIT gives one pad a dim
    for both sides, or a (before, after) pair a dim."""
    if algo == "SAME":
        pads = []
        for i in range(ndim):
            o = -(-in_shape[i] // strides[i])
            eff = (ksize[i] - 1) * dilations[i] + 1
            total = max((o - 1) * strides[i] + eff - in_shape[i], 0)
            pads.append((total // 2, total - total // 2))
        return pads
    if algo == "VALID":
        return [(0, 0)] * ndim
    p = list(paddings)
    if len(p) == ndim:
        return [(x, x) for x in p]
    return [(p[2 * i], p[2 * i + 1]) for i in range(ndim)]


def _cudnn_pinned():
    """cuDNN set to compute as the TPU package's convolution does: f32
    operands in full f32 (torch lets cuDNN round them to TF32 by default),
    deterministic algorithms (no atomics, so a step is bitwise
    reproducible: ROADMAP C2), and no algorithm search (it cannot run
    inside a CUDA-graph capture). Only this op's calls see the flags."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _Conv(torch.autograd.Function):
    """A convolution without bias (``transposed``: its transpose, the
    filter [in_c, out_c/g, k...]) whose backward runs under
    ``_cudnn_pinned`` too: autograd runs it after the forward's ``with``
    block has closed, and cuDNN reads the flags when it runs. The
    transpose's grads are cuDNN's dgrad and wgrad of a forward conv."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, transposed, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, transposed, groups)
        with _cudnn_pinned():
            return torch.ops.aten.convolution(
                x, w, None, stride, padding, dilation, transposed,
                [0] * len(stride), groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, transposed, groups = ctx.conf
        with _cudnn_pinned():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, dilation, transposed,
                [0] * len(stride), groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None, None, None


_CONV_ATTRS = {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
               "groups": 1, "padding_algorithm": "EXPLICIT",
               "data_format": "NCHW"}


@register_op("conv2d", inputs=("Input", "Filter", "Bias", "ResidualData"),
             diff_inputs=("Input", "Filter", "Bias"),
             attr_defaults=dict(_CONV_ATTRS, use_cudnn=True,
                                exhaustive_search=False))
def _conv2d(ins, attrs):
    """Input NCHW (or NHWC), Filter OIHW. Uneven padding goes through
    ``F.pad`` first (``F.conv2d`` pads both sides alike). Under
    FLAGS_use_bf16_matmul on the card: bf16 operands AND a bf16 output
    (cuDNN accumulates in f32), cast back to f32, as the TPU package's
    conv rounds its output to bf16 once (unlike ``mul``, whose output is
    f32)."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    nchw = attrs.get("data_format", "NCHW") in ("NCHW", "AnyLayout")
    if not nchw:
        x = x.permute(0, 3, 1, 2)
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    dil = [int(d) for d in attrs.get("dilations", [1, 1])]
    (pt, pb), (pl, pr) = _conv_padding(
        attrs.get("paddings", [0, 0]),
        attrs.get("padding_algorithm", "EXPLICIT"), 2, w.shape[2:],
        strides, dil, x.shape[2:])
    orig_dtype = x.dtype
    if bf16_matmul_enabled(x):
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if pt != pb or pl != pr:
        x = F.pad(x, (pl, pr, pt, pb))
        pt = pl = 0
    o = _Conv.apply(x, w, strides, [pt, pl], dil, False,
                    int(attrs.get("groups", 1))).to(orig_dtype)
    if not nchw:
        o = o.permute(0, 2, 3, 1)
    b = first(ins, "Bias")
    if b is not None:
        o = o + b.reshape([1, -1, 1, 1] if nchw else [1, 1, 1, -1])
    return out(Output=o)


@register_op("depthwise_conv2d", inputs=("Input", "Filter", "Bias"),
             diff_inputs=("Input", "Filter", "Bias"),
             attr_defaults=dict(_CONV_ATTRS, use_cudnn=False))
def _depthwise_conv2d(ins, attrs):
    return _conv2d(ins, attrs)


def _window_slices(xp, ksize, strides, oh, ow):
    """The kh·kw strided slices of padded NCHW ``xp``, one a window
    offset, each [n, c, oh, ow] (views)."""
    (kh, kw), (sh, sw) = ksize, strides
    for i in range(kh):
        for j in range(kw):
            yield xp[:, :, i:i + (oh - 1) * sh + 1:sh,
                     j:j + (ow - 1) * sw + 1:sw]


def _pool_out(hw, ksize, strides, pads):
    return tuple((hw[d] + sum(pads[d]) - ksize[d]) // strides[d] + 1
                 for d in range(2))


def _avg_pool_slices(x, ksize, strides, pads, exclusive):
    """NCHW average pool: the sum of the kh·kw strided slices in window
    order, over the count of the window's elements that are not padding
    (``exclusive`` and padded) or over kh·kw. The count map is summed on
    x's device from a padded tensor of ones: no host copy, so a CUDA
    graph captures it."""
    (pt, pb), (pl, pr) = pads
    oh, ow = _pool_out(x.shape[2:], ksize, strides, pads)
    o = None
    for s in _window_slices(F.pad(x, (pl, pr, pt, pb)), ksize, strides,
                            oh, ow):
        o = s if o is None else o + s
    if exclusive and (pt or pb or pl or pr):
        ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]),
                                dtype=torch.float32, device=x.device),
                     (pl, pr, pt, pb))
        cnt = None
        for s in _window_slices(ones, ksize, strides, oh, ow):
            cnt = s if cnt is None else cnt + s
        return o / torch.clamp(cnt, min=1.0).to(x.dtype)
    return o / float(ksize[0] * ksize[1])


def _max_pool_slices(x, ksize, strides, pads, init):
    """NCHW max pool: ``torch.maximum`` chained over the kh·kw strided
    slices of x padded with ``init``. Its grad splits a tie evenly at
    each link, as the TPU package's chained ``jnp.maximum`` does (for
    three equal slices ¼, ¼, ½), where ``F.max_pool2d`` sends the whole
    grad to one element."""
    (pt, pb), (pl, pr) = pads
    oh, ow = _pool_out(x.shape[2:], ksize, strides, pads)
    o = None
    for s in _window_slices(F.pad(x, (pl, pr, pt, pb), value=init), ksize,
                            strides, oh, ow):
        o = s if o is None else torch.maximum(o, s)
    return o


def _pool2d_impl(x, attrs):
    """pool2d over NCHW or NHWC ``x``: global (or adaptive to 1×1) as one
    reduction, adaptive at sizes that divide, else the strided-slice max
    or average with EXPLICIT, SAME or VALID padding. ``ceil_mode`` is
    ignored, as in the TPU package."""
    ptype = attrs.get("pooling_type", "max")
    ksize = [int(k) for k in attrs.get("ksize", [1, 1])]
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    ch_last = attrs.get("data_format", "NCHW") == "NHWC"
    hw = tuple(x.shape[1:3] if ch_last else x.shape[2:4])
    axes = (1, 2) if ch_last else (2, 3)
    if attrs.get("global_pooling", False) or (
            attrs.get("adaptive", False) and ksize == [1, 1]):
        if ptype == "max":
            return torch.amax(x, dim=axes, keepdim=True)
        return torch.mean(x, dim=axes, keepdim=True)
    if attrs.get("adaptive", False):
        oh, ow = ksize
        if hw[0] % oh or hw[1] % ow:
            raise ValueError("adaptive pool requires divisible sizes in "
                             "this build")
        n, c = x.shape[0], x.shape[3 if ch_last else 1]
        if ch_last:
            xr = x.reshape(n, oh, hw[0] // oh, ow, hw[1] // ow, c)
            rax = (2, 4)
        else:
            xr = x.reshape(n, c, oh, hw[0] // oh, ow, hw[1] // ow)
            rax = (3, 5)
        if ptype == "max":
            return torch.amax(xr, dim=rax)
        return torch.mean(xr, dim=rax)
    pads = _conv_padding(attrs.get("paddings", [0, 0]),
                         attrs.get("padding_algorithm", "EXPLICIT"),
                         2, ksize, strides, [1, 1], hw)
    if ch_last:
        x = x.permute(0, 3, 1, 2)
    if ptype == "max":
        init = (float("-inf") if x.is_floating_point()
                else torch.iinfo(x.dtype).min)
        o = _max_pool_slices(x, ksize, strides, pads, init)
    else:
        o = _avg_pool_slices(x, ksize, strides, pads,
                             attrs.get("exclusive", True))
    return o.permute(0, 2, 3, 1) if ch_last else o


@register_op("pool2d", inputs=("X",),
             attr_defaults={"pooling_type": "max", "ksize": [1, 1],
                            "global_pooling": False, "strides": [1, 1],
                            "paddings": [0, 0], "exclusive": True,
                            "adaptive": False, "ceil_mode": False,
                            "use_cudnn": True, "data_format": "NCHW",
                            "padding_algorithm": "EXPLICIT"})
def _pool2d(ins, attrs):
    return out(Out=_pool2d_impl(first(ins, "X"), attrs))


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------
@register_op("batch_norm",
             inputs=("X", "Scale", "Bias", "Mean", "Variance",
                     "MomentumTensor"),
             diff_inputs=("X", "Scale", "Bias"),
             attr_defaults={"momentum": 0.9, "epsilon": 1e-5,
                            "data_layout": "NCHW", "is_test": False,
                            "use_global_stats": False,
                            "trainable_statistics": False,
                            "fuse_with_relu": False})
def _batch_norm(ins, attrs):
    """The TPU package's formulas: in training the batch statistics in
    f32, the mean and the biased variance mean(x²) − mean(x)², and the
    moving statistics momentum·old + (1 − momentum)·batch; under
    ``is_test`` or ``use_global_stats`` the moving ones. SavedVariance is
    the inverse std rsqrt(var + eps). (``F.batch_norm`` is not this op:
    it computes the variance another way, and its running variance is
    the unbiased one.) ``MomentumTensor`` is ignored, as there."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    mean, var = first(ins, "Mean"), first(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        bm, bv = mean, var
        new_mean, new_var = mean, var
    else:
        x32 = x.to(torch.float32)
        bm = torch.mean(x32, axes)
        bv = torch.mean(torch.square(x32), axes) - torch.square(bm)
        bm, bv = bm.to(x.dtype), bv.to(x.dtype)
        # the scalars in the statistics' dtype, as JAX's weak typing
        mom, rest = (scalar_as(m, mean.dtype) for m in (momentum,
                                                        1 - momentum))
        new_mean = mom * mean + rest * bm
        new_var = mom * var + rest * bv
    saved_var_inv = torch.rsqrt(bv + scalar_as(eps, bv.dtype))
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    y = (x - bm.reshape(bshape)) * saved_var_inv.reshape(bshape)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    if attrs.get("fuse_with_relu", False):
        y = torch.maximum(y, torch.zeros((), dtype=y.dtype, device=y.device))
    return out(Y=y, MeanOut=new_mean, VarianceOut=new_var, SavedMean=bm,
               SavedVariance=saved_var_inv)


@register_op("layer_norm", inputs=("X", "Scale", "Bias"),
             diff_inputs=("X", "Scale", "Bias"),
             attr_defaults={"epsilon": 1e-5, "begin_norm_axis": 1})
def _layer_norm(ins, attrs):
    """Statistics in f32 with the biased variance; Mean and Variance have
    shape ``x.shape[:begin_norm_axis]``."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(bna, x.dim()))
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, axes, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), axes, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    norm_shape = (1,) * bna + tuple(x.shape[bna:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    flat = tuple(x.shape[:bna])
    return out(Y=y, Mean=mean.reshape(flat).to(x.dtype),
               Variance=var.reshape(flat).to(x.dtype))


# --------------------------------------------------------------------------
# softmax & losses
# --------------------------------------------------------------------------
@register_op("softmax", inputs=("X",), attr_defaults={"axis": -1})
def _softmax(ins, attrs):
    return out(Out=torch.softmax(first(ins, "X"), dim=attrs.get("axis", -1)))


@register_op("cross_entropy", inputs=("X", "Label"), diff_inputs=("X",),
             attr_defaults={"soft_label": False, "ignore_index": -100})
def _cross_entropy(ins, attrs):
    """-log(x[label] + 1e-20) over probabilities x (the TPU package's
    kernel); an ignored label gives 0."""
    x, label = first(ins, "X"), first(ins, "Label")
    eps = 1e-20
    if attrs.get("soft_label", False):
        return out(Y=-torch.sum(label * torch.log(x + eps), dim=-1,
                                keepdim=True))
    lbl = label
    if lbl.dim() == x.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    lbl = lbl.long()[..., None]
    ign = attrs.get("ignore_index", -100)
    # an ignored label may lie outside the classes: gather at 0, then
    # zero the loss
    picked = torch.gather(x, -1, torch.where(lbl == ign, 0, lbl))
    loss = -torch.log(picked + eps)
    return out(Y=torch.where(lbl == ign, torch.zeros((), dtype=loss.dtype,
                                                     device=loss.device),
                             loss))



@register_op("softmax_with_cross_entropy", inputs=("Logits", "Label"),
             diff_inputs=("Logits",),
             attr_defaults={"soft_label": False, "ignore_index": -100,
                            "numeric_stable_mode": True, "axis": -1})
def _softmax_with_cross_entropy(ins, attrs):
    logits, label = first(ins, "Logits"), first(ins, "Label")
    axis = attrs.get("axis", -1) % logits.dim()
    logp = torch.log_softmax(logits, dim=axis)
    softmax = torch.exp(logp)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        lbl = lbl.unsqueeze(axis).long()
        ign = attrs.get("ignore_index", -100)
        # an ignored label may lie outside the classes: gather at 0, then
        # zero the loss
        picked = torch.gather(logp, axis,
                              torch.where(lbl == ign, 0, lbl))
        loss = torch.where(lbl == ign,
                           torch.zeros((), dtype=logp.dtype,
                                       device=logp.device), -picked)
    return out(Softmax=softmax, Loss=loss)


@register_op("square_error_cost", inputs=("X", "Y"))
def _square_error_cost(ins, attrs):
    return out(Out=torch.square(first(ins, "X") - first(ins, "Y")))


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------
@register_op("log_loss", inputs=("Predicted", "Labels"),
             diff_inputs=("Predicted",), attr_defaults={"epsilon": 1e-4})
def _log_loss(ins, attrs):
    """-l·log(p + ε) - (1 - l)·log(1 - p + ε), ε = 1e-4 by default."""
    p, lbl = first(ins, "Predicted"), first(ins, "Labels")
    eps = attrs.get("epsilon", 1e-4)
    return out(Loss=-lbl * torch.log(p + eps)
               - (1 - lbl) * torch.log(1 - p + eps))


@register_op("accuracy", inputs=("Out", "Indices", "Label"), no_grad=True)
def _accuracy(ins, attrs):
    """Top-k accuracy from top_k's Indices: a row counts when any of its k
    indices is its label. Total is a device fill, not a host copy, so a
    CUDA graph can capture the op."""
    idx, label = first(ins, "Indices"), first(ins, "Label")
    correct = torch.any(idx == label.reshape(-1, 1).to(idx.dtype), dim=1)
    num_correct = torch.sum(correct.to(torch.float32))
    total = idx.shape[0]
    return out(Accuracy=(num_correct / total).reshape((1,)),
               Correct=num_correct.to(torch.int32).reshape((1,)),
               Total=torch.full((1,), total, dtype=torch.int32,
                                device=idx.device))


@register_op("auc", inputs=("Predict", "Label", "StatPos", "StatNeg"),
             no_grad=True, stateful=True,
             attr_defaults={"curve": "ROC", "num_thresholds": 4095,
                            "slide_steps": 1})
def _auc(ins, attrs):
    """The streaming ROC AUC (reference: operators/metrics/auc_op.h): each
    row's positive-class probability falls in bucket b = min(trunc(p·nt),
    nt), the product in f32 as the TPU kernel's numpy takes it. A
    negative b in [-(nt + 1), 0) is b + nt + 1, where numpy's indexing
    wraps it in the TPU kernel; a NaN, or a b below -(nt + 1), where the
    TPU kernel raises, counts in bucket 0, so a poisoned step reaches the
    numeric fault guard rather than an out-of-range scatter. The product
    is clamped in f32 before the cast, and NaN is tested before it: a
    cast of NaN or of an out-of-range float to int64 differs between the
    CPU and the card. The positive
    and negative labels are counted into StatPos and StatNeg, and the AUC
    is ``utils.metrics.auc_from_histograms_device``'s sweep, f32 [1].
    All on the tensors' device with no host read: the counts are exact
    integer scatter-adds (``torch.bincount`` reads its input's maximum on
    the host). Stateful: the histograms accumulate across steps, so a
    compiled block runs the op as an island."""
    from ..utils.metrics import auc_from_histograms_device
    pred, label = first(ins, "Predict"), first(ins, "Label")
    stat_pos = first(ins, "StatPos").reshape(-1)
    stat_neg = first(ins, "StatNeg").reshape(-1)
    nt = int(attrs.get("num_thresholds", 4095))
    p = pred[:, 1] * nt
    b = torch.clamp(p, -(nt + 2), nt).to(torch.int64)
    b = torch.where(b < 0, b + (nt + 1), b)
    bucket = torch.where(torch.isnan(p) | (b < 0), torch.zeros_like(b), b)
    pos = (label.reshape(-1) != 0).to(stat_pos.dtype)
    new_pos = stat_pos.scatter_add(0, bucket, pos)
    new_neg = stat_neg.scatter_add(0, bucket, 1 - pos)
    auc = auc_from_histograms_device(new_pos, new_neg)
    return out(AUC=auc.to(torch.float32).reshape(1), StatPosOut=new_pos,
               StatNegOut=new_neg)


# --------------------------------------------------------------------------
# dropout — the Mask output contract is kept, so the grad is a mask multiply
# --------------------------------------------------------------------------
@register_op("dropout", inputs=("X", "Seed"), needs_rng=True,
             attr_defaults={"dropout_prob": 0.5, "is_test": False,
                            "dropout_implementation": "downgrade_in_infer",
                            "fix_seed": False, "seed": 0})
def _dropout(ins, attrs):
    """Keeps each element with probability 1 - dropout_prob, a
    counter-based draw from the op's key (ops/rng.py; the TPU package
    draws from jax.random: the same distribution, other bits), in one
    kernel on the card (ops/cuda/dropout.py)."""
    x = first(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        o = x if impl == "upscale_in_train" \
            else x * scalar_as(1.0 - p, x.dtype)
        return out(Out=o, Mask=torch.ones_like(x, dtype=torch.uint8))
    o, mask = cuda_dropout.dropout(x, attrs["_rng"](), p,
                                   impl == "upscale_in_train")
    return out(Out=o, Mask=mask)


@register_op("dropout_grad", no_grad=True)
def _dropout_grad(ins, attrs):
    g = first(ins, "Out@GRAD")
    mask = first(ins, "Mask")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    gx = g * mask.to(g.dtype)
    if impl == "upscale_in_train" and p < 1.0:
        gx = gx / (1.0 - p)
    return out(**{"X@GRAD": gx})


@register_grad_maker("dropout")
def _dropout_grad_maker(op, grad_map):
    return [{
        "type": "dropout_grad",
        "inputs": {"Out@GRAD": [grad_map[op.output("Out")[0]]],
                   "Mask": op.output("Mask")},
        "outputs": {"X@GRAD": [grad_map[op.input("X")[0]]]},
        "attrs": {k: v for k, v in op.attrs.items() if not k.startswith("_")},
    }]


# --------------------------------------------------------------------------
# the losses of the TPU package's nn_ops.py
# --------------------------------------------------------------------------
def take_along(x, idx, dim):
    """``jnp.take_along_axis`` in its default ``fill`` mode: a negative
    index counts from the end, one outside the axis gives NaN (its grad
    0)."""
    n = x.shape[dim]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    picked = torch.gather(x, dim, torch.where(ok, idx, 0))
    return torch.where(ok, picked, torch.full((), float("nan"),
                                              dtype=x.dtype,
                                              device=x.device))


def _zero_like(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@register_op("log_softmax", inputs=("X",), attr_defaults={"axis": -1})
def _log_softmax(ins, attrs):
    return out(Out=torch.log_softmax(first(ins, "X"),
                                     dim=attrs.get("axis", -1)))


@register_op("cross_entropy2", inputs=("X", "Label"), diff_inputs=("X",),
             attr_defaults={"ignore_index": -100})
def _cross_entropy2(ins, attrs):
    """-log(x[label] + 1e-20) with the picked probability as MatchX and
    an empty XShape. ``ignore_index`` is not applied, as in the TPU
    kernel: a label outside the classes picks NaN."""
    x, label = first(ins, "X"), first(ins, "Label")
    lbl = label.squeeze(-1) if label.dim() == x.dim() else label
    picked = take_along(x, lbl[..., None], -1)
    return out(Y=-torch.log(picked + 1e-20),
               XShape=torch.zeros((0,) + tuple(x.shape), dtype=x.dtype,
                                  device=x.device),
               MatchX=picked)


@register_op("sigmoid_cross_entropy_with_logits", inputs=("X", "Label"),
             diff_inputs=("X",),
             attr_defaults={"ignore_index": -100, "normalize": False})
def _sigmoid_ce(ins, attrs):
    """max(x, 0) − x·label + log1p(e^−|x|), 0 where the label is
    ``ignore_index``; with ``normalize`` over the count of the others
    (at least 1)."""
    x, label = first(ins, "X"), first(ins, "Label")
    loss = torch.clamp(x, min=0) - x * label + torch.log1p(
        torch.exp(-torch.abs(x)))
    mask = label != attrs.get("ignore_index", -100)
    loss = torch.where(mask, loss, _zero_like(loss))
    if attrs.get("normalize", False):
        loss = loss / torch.clamp(mask.to(x.dtype).sum(), min=1.0)
    return out(Out=loss)


@register_op("bce_loss", inputs=("X", "Label"), diff_inputs=("X",))
def _bce_loss(ins, attrs):
    x, label = first(ins, "X"), first(ins, "Label")
    eps = 1e-12
    return out(Out=-(label * torch.log(x + eps)
                     + (1 - label) * torch.log(1 - x + eps)))


@register_op("huber_loss", inputs=("X", "Y"), diff_inputs=("X",),
             attr_defaults={"delta": 1.0})
def _huber_loss(ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    d = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    loss = torch.where(ar <= d, 0.5 * r * r, d * (ar - 0.5 * d))
    return out(Out=loss, Residual=r)


@register_op("smooth_l1_loss",
             inputs=("X", "Y", "InsideWeight", "OutsideWeight"),
             diff_inputs=("X",), attr_defaults={"sigma": 1.0})
def _smooth_l1(ins, attrs):
    """Each row's sum of the smooth L1 of (X − Y)·InsideWeight, times
    OutsideWeight; Diff is the weighted difference."""
    x, y = first(ins, "X"), first(ins, "Y")
    iw, ow = first(ins, "InsideWeight"), first(ins, "OutsideWeight")
    sigma2 = attrs.get("sigma", 1.0) ** 2
    d = x - y
    if iw is not None:
        d = d * iw
    ad = torch.abs(d)
    l1 = torch.where(ad < 1.0 / sigma2, 0.5 * d * d * sigma2,
                     ad - 0.5 / sigma2)
    if ow is not None:
        l1 = l1 * ow
    return out(Out=l1.reshape(l1.shape[0], -1).sum(-1, keepdim=True),
               Diff=d)


def _reduced(loss, red, n):
    """``mean``, ``sum`` or ``batchmean`` (the sum over ``n``) as [1];
    ``none`` as it is."""
    if red == "mean":
        return loss.mean().reshape((1,))
    if red == "sum":
        return loss.sum().reshape((1,))
    if red == "batchmean":
        return (loss.sum() / n).reshape((1,))
    return loss


@register_op("kldiv_loss", inputs=("X", "Target"), diff_inputs=("X",),
             attr_defaults={"reduction": "mean"})
def _kldiv_loss(ins, attrs):
    x, t = first(ins, "X"), first(ins, "Target")
    loss = torch.where(t > 0, t * (torch.log(t) - x), _zero_like(x))
    return out(Loss=_reduced(loss, attrs.get("reduction", "mean"),
                             x.shape[0]))


@register_op("hinge_loss", inputs=("Logits", "Labels"),
             diff_inputs=("Logits",))
def _hinge_loss(ins, attrs):
    logits, labels = first(ins, "Logits"), first(ins, "Labels")
    return out(Loss=torch.clamp(1.0 - (2.0 * labels - 1.0) * logits,
                                min=0.0))


@register_op("rank_loss", inputs=("Label", "Left", "Right"),
             diff_inputs=("Left", "Right"))
def _rank_loss(ins, attrs):
    label = first(ins, "Label")
    d = first(ins, "Left") - first(ins, "Right")
    return out(Out=torch.log1p(torch.exp(d)) - label * d)


@register_op("margin_rank_loss", inputs=("Label", "X1", "X2"),
             diff_inputs=("X1", "X2"), attr_defaults={"margin": 0.0})
def _margin_rank_loss(ins, attrs):
    label, x1, x2 = first(ins, "Label"), first(ins, "X1"), first(ins, "X2")
    o = torch.clamp(-label * (x1 - x2) + attrs.get("margin", 0.0), min=0.0)
    return out(Out=o, Activated=(o > 0).to(x1.dtype))


@register_op("nll_loss", inputs=("X", "Label", "Weight"), diff_inputs=("X",),
             attr_defaults={"ignore_index": -100, "reduction": "mean"})
def _nll_loss(ins, attrs):
    """−X[i, label_i]·w, the weight 0 at ``ignore_index``; a label outside
    the classes picks NaN, as the TPU kernel's gather does, and an
    ignored one's NaN stays in the sum (NaN·0)."""
    x, label, w = first(ins, "X"), first(ins, "Label"), first(ins, "Weight")
    lbl = label.long()
    picked = -take_along(x, lbl[:, None], 1)[:, 0]
    wt = torch.ones_like(picked) if w is None \
        else take_along(w[None, :], lbl[None, :], 1)[0]
    wt = torch.where(label == attrs.get("ignore_index", -100),
                     _zero_like(wt), wt)
    loss = picked * wt
    total = wt.sum()
    red = attrs.get("reduction", "mean")
    if red == "mean":
        return out(Out=(loss.sum() / torch.clamp(total, min=1e-10))
                   .reshape((1,)), Total_weight=total.reshape((1,)))
    if red == "sum":
        return out(Out=loss.sum().reshape((1,)),
                   Total_weight=total.reshape((1,)))
    return out(Out=loss, Total_weight=total.reshape((1,)))


@register_op("mse_loss", inputs=("X", "Y"))
def _mse_loss(ins, attrs):
    return out(Out=torch.square(first(ins, "X") - first(ins, "Y")).mean()
               .reshape((1,)))


@register_op("bpr_loss", inputs=("X", "Label"), diff_inputs=("X",))
def _bpr_loss(ins, attrs):
    """The mean over the N − 1 negative columns of −log(σ(x_pos − x) +
    1e-8) (reference: operators/bpr_loss_op.h)."""
    x, label = first(ins, "X"), first(ins, "Label")
    lbl = (label.squeeze(-1) if label.dim() == x.dim() else label).long()
    pos = take_along(x, lbl[:, None], 1)
    terms = -torch.log(torch.sigmoid(pos - x) + 1e-8)
    neg = lbl[:, None] != torch.arange(x.shape[1], device=x.device)
    return out(Y=(terms * neg.to(x.dtype)).sum(1, keepdim=True)
               / (x.shape[1] - 1))


# --------------------------------------------------------------------------
# the other norms
# --------------------------------------------------------------------------
def _affine(y, scale, bias, c, nd):
    bshape = (1, c) + (1,) * (nd - 2)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return y


@register_op("instance_norm", inputs=("X", "Scale", "Bias"),
             diff_inputs=("X", "Scale", "Bias"),
             attr_defaults={"epsilon": 1e-5})
def _instance_norm(ins, attrs):
    """Each (sample, channel) plane normalized by its own mean and biased
    variance, in X's dtype. SavedVariance holds 1/√(var + ε), as the TPU
    kernel's does, not the variance."""
    x = first(ins, "X")
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mean = x.mean(axes, keepdim=True)
    inv = torch.rsqrt(torch.square(x - mean).mean(axes, keepdim=True)
                      + scalar_as(eps, x.dtype))
    n, c = x.shape[0], x.shape[1]
    y = _affine((x - mean) * inv, first(ins, "Scale"), first(ins, "Bias"),
                c, x.dim())
    return out(Y=y, SavedMean=mean.reshape(n * c),
               SavedVariance=inv.reshape(n * c))


@register_op("group_norm", inputs=("X", "Scale", "Bias"),
             diff_inputs=("X", "Scale", "Bias"),
             attr_defaults={"epsilon": 1e-5, "groups": 1,
                            "data_layout": "NCHW"})
def _group_norm(ins, attrs):
    """X's dim 1 split into ``groups``, each group normalized over the rest
    of its sample. X is read as NCHW whatever ``data_layout`` says, as the
    TPU kernel does."""
    x = first(ins, "X")
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(axes, keepdim=True)
    var = torch.square(xg - mean).mean(axes, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + scalar_as(eps, x.dtype))) \
        .reshape(x.shape)
    y = _affine(y, first(ins, "Scale"), first(ins, "Bias"), c, x.dim())
    return out(Y=y, Mean=mean.reshape(n, g), Variance=var.reshape(n, g))


@register_op("norm", inputs=("X",),
             attr_defaults={"axis": -1, "epsilon": 1e-10})
def _norm(ins, attrs):
    x = first(ins, "X")
    norm = torch.sqrt(torch.square(x).sum(attrs.get("axis", -1),
                                          keepdim=True)
                      + attrs.get("epsilon", 1e-10))
    return out(Out=x / norm, Norm=norm)


@register_op("data_norm",
             inputs=("X", "BatchSize", "BatchSum", "BatchSquareSum"),
             diff_inputs=("X",), attr_defaults={"epsilon": 1e-4})
def _data_norm(ins, attrs):
    """(X − sum/size)·√(size/square_sum) from the accumulated statistics
    (``epsilon`` is not used, as in the TPU kernel)."""
    x, bsize = first(ins, "X"), first(ins, "BatchSize")
    means = first(ins, "BatchSum") / bsize
    scales = torch.sqrt(bsize / first(ins, "BatchSquareSum"))
    return out(Y=(x - means) * scales, Means=means, Scales=scales)


@register_op("lrn", inputs=("X",),
             attr_defaults={"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75,
                            "data_format": "NCHW"})
def _lrn(ins, attrs):
    """x / (k + α·Σ x²)^β, the sum over the ``n`` channels around each
    (zero-padded), with no 1/n, as the TPU kernel has it."""
    x = first(ins, "X")
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    n, k = attrs.get("n", 5), attrs.get("k", 2.0)
    alpha, beta = attrs.get("alpha", 1e-4), attrs.get("beta", 0.75)
    half = n // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    c = x.shape[1]
    mid = 0
    for i in range(n):
        mid = mid + sq[:, i:i + c]
    mid = k + alpha * mid
    o = x / mid ** beta
    if nhwc:
        o, mid = o.permute(0, 2, 3, 1), mid.permute(0, 2, 3, 1)
    return out(Out=o, MidOut=mid)


# the TPU package's sync_batch_norm is batch_norm's kernel: on one card
# the batch statistics are the whole batch's
register_op("sync_batch_norm",
            inputs=("X", "Scale", "Bias", "Mean", "Variance",
                    "MomentumTensor"),
            diff_inputs=("X", "Scale", "Bias"),
            attr_defaults={"momentum": 0.9, "epsilon": 1e-5,
                           "data_layout": "NCHW", "is_test": False,
                           "use_global_stats": False,
                           "trainable_statistics": False,
                           "fuse_with_relu": False})(_batch_norm)


# --------------------------------------------------------------------------
# conv3d, conv2d_transpose, pool3d and the indexed max pools
# --------------------------------------------------------------------------
def _bf16_operands(x, w):
    """(x, w) in bf16 under FLAGS_use_bf16_matmul on the card, as
    ``conv2d`` takes them; else as they are."""
    if bf16_matmul_enabled(x):
        return x.to(torch.bfloat16), w.to(torch.bfloat16)
    return x, w


@register_op("conv3d", inputs=("Input", "Filter", "Bias"),
             diff_inputs=("Input", "Filter", "Bias"),
             attr_defaults={"strides": [1, 1, 1], "paddings": [0, 0, 0],
                            "dilations": [1, 1, 1], "groups": 1,
                            "padding_algorithm": "EXPLICIT",
                            "data_format": "NCDHW", "use_cudnn": True})
def _conv3d(ins, attrs):
    """NCDHW by OIDHW on cuDNN under ``_cudnn_pinned``, uneven padding
    through ``F.pad`` first. Bias is not added, as in the TPU kernel."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    strides = [int(s) for s in attrs.get("strides", [1, 1, 1])]
    dil = [int(d) for d in attrs.get("dilations", [1, 1, 1])]
    pads = _conv_padding(attrs.get("paddings", [0, 0, 0]),
                         attrs.get("padding_algorithm", "EXPLICIT"), 3,
                         w.shape[2:], strides, dil, x.shape[2:])
    orig = x.dtype
    x, w = _bf16_operands(x, w)
    if any(a != b for a, b in pads):
        x = F.pad(x, [p for a, b in reversed(pads) for p in (a, b)])
        pads = [(0, 0)] * 3
    o = _Conv.apply(x, w, strides, [a for a, _ in pads], dil, False,
                    int(attrs.get("groups", 1)))
    return out(Output=o.to(orig))


@register_op("conv2d_transpose", inputs=("Input", "Filter", "Bias"),
             diff_inputs=("Input", "Filter", "Bias"),
             attr_defaults={"strides": [1, 1], "paddings": [0, 0],
                            "dilations": [1, 1], "groups": 1,
                            "output_size": [],
                            "padding_algorithm": "EXPLICIT",
                            "data_format": "NCHW", "use_cudnn": True})
def _conv2d_transpose(ins, attrs):
    """The transposed convolution of NCHW X by Paddle's [in_c, out_c/g,
    kh, kw] filter (torch's layout) on cuDNN under ``_cudnn_pinned``,
    unpadded: then its (before, after) paddings cropped off each side,
    and with ``output_size`` zeros added below and right or rows and
    columns cropped to that size (:575-583 of the TPU kernel, which
    takes any size)."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    dil = [int(d) for d in attrs.get("dilations", [1, 1])]
    (pt, pb), (pl, pr) = _conv_padding(
        attrs.get("paddings", [0, 0]),
        attrs.get("padding_algorithm", "EXPLICIT"), 2, w.shape[2:],
        strides, dil, x.shape[2:])
    orig = x.dtype
    x, w = _bf16_operands(x, w)
    o = _Conv.apply(x, w, strides, [0, 0], dil, True,
                    int(attrs.get("groups", 1))).to(orig)
    o = o[:, :, pt:o.shape[2] - pb, pl:o.shape[3] - pr]
    osize = attrs.get("output_size") or []
    if osize:
        grow = [max(0, int(osize[i]) - o.shape[2 + i]) for i in (0, 1)]
        if any(grow):
            o = F.pad(o, (0, grow[1], 0, grow[0]))
        o = o[:, :, :int(osize[0]), :int(osize[1])]
    b = first(ins, "Bias")
    if b is not None:
        o = o + b.reshape(1, -1, 1, 1)
    return out(Output=o)


def _windows3d(xp, ksize, strides, odims):
    """The kd·kh·kw strided slices of padded NCDHW ``xp`` in window
    order, each [n, c, od, oh, ow]."""
    (kd, kh, kw), (sd, sh, sw), (od, oh, ow) = ksize, strides, odims
    for a in range(kd):
        for i in range(kh):
            for j in range(kw):
                yield xp[:, :, a:a + (od - 1) * sd + 1:sd,
                         i:i + (oh - 1) * sh + 1:sh,
                         j:j + (ow - 1) * sw + 1:sw]


@register_op("pool3d", inputs=("X",),
             attr_defaults={"pooling_type": "max", "ksize": [1, 1, 1],
                            "global_pooling": False, "strides": [1, 1, 1],
                            "paddings": [0, 0, 0], "exclusive": True,
                            "adaptive": False, "ceil_mode": False,
                            "use_cudnn": True, "data_format": "NCDHW",
                            "padding_algorithm": "EXPLICIT"})
def _pool3d(ins, attrs):
    """NCDHW pooling in the TPU kernel's slicing form: global (or adaptive
    to 1³) as one reduction, adaptive at sizes that divide the input,
    else the max chained over the window's strided slices (padded with
    −inf) or their sum (padded with 0) over the count of the window's
    elements that are not padding (``exclusive``) or over its size.
    ``ceil_mode`` is ignored."""
    x = first(ins, "X")
    ksize = [int(k) for k in attrs.get("ksize")]
    strides = [int(s) for s in attrs.get("strides")]
    is_max = attrs.get("pooling_type", "max") == "max"
    if attrs.get("global_pooling", False) or (
            attrs.get("adaptive", False) and ksize == [1, 1, 1]):
        return out(Out=torch.amax(x, dim=(2, 3, 4), keepdim=True) if is_max
                   else x.mean(dim=(2, 3, 4), keepdim=True))
    n, c, d, h, w = x.shape
    if attrs.get("adaptive", False):
        od, oh, ow = ksize
        if d % od or h % oh or w % ow:
            raise ValueError("adaptive pool3d requires divisible sizes in "
                             "this build")
        xr = x.reshape(n, c, od, d // od, oh, h // oh, ow, w // ow)
        return out(Out=torch.amax(xr, dim=(3, 5, 7)) if is_max
                   else xr.mean(dim=(3, 5, 7)))
    pads = _conv_padding(attrs.get("paddings"),
                         attrs.get("padding_algorithm"), 3, ksize, strides,
                         [1, 1, 1], x.shape[2:])
    odims = [(x.shape[2 + i] + sum(pads[i]) - ksize[i]) // strides[i] + 1
             for i in range(3)]
    flat = [p for a, b in reversed(pads) for p in (a, b)]
    xp = F.pad(x, flat, value=float("-inf") if is_max else 0.0)
    o = None
    for s in _windows3d(xp, ksize, strides, odims):
        o = s if o is None else (torch.maximum(o, s) if is_max else o + s)
    if is_max:
        return out(Out=o)
    if attrs.get("exclusive", True) and any(flat):
        ones = F.pad(torch.ones((1, 1, d, h, w), dtype=torch.float32,
                                device=x.device), flat)
        cnt = None
        for s in _windows3d(ones, ksize, strides, odims):
            cnt = s if cnt is None else cnt + s
        return out(Out=o / torch.clamp(cnt, min=1.0).to(x.dtype))
    return out(Out=o / float(ksize[0] * ksize[1] * ksize[2]))


def _argmax_windows(x, ksize, strides, pads):
    """(max, flat index in the unpadded input) of each window of NC+spatial
    ``x``, padded symmetrically by ``pads`` with −inf: the windows'
    elements stacked last, the max by ``amax`` (a tie's grad split evenly,
    as ``jnp.max``'s) and the index of the first max (``jnp.argmax``)."""
    nd = len(ksize)
    spatial = tuple(x.shape[2:])
    xp = F.pad(x, [p for q in reversed(pads) for p in (q, q)],
               value=float("-inf"))
    odims = [(spatial[i] + 2 * pads[i] - ksize[i]) // strides[i] + 1
             for i in range(nd)]
    dev = x.device
    flat = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(nd):
        pos = torch.arange(spatial[i] + 2 * pads[i], device=dev) - pads[i]
        flat = flat[..., None] * spatial[i] + pos.reshape(
            (1,) * i + (-1,))
    patches, idx = [], []
    for off in np.ndindex(*ksize):
        sl = tuple(slice(off[i], off[i] + (odims[i] - 1) * strides[i] + 1,
                         strides[i]) for i in range(nd))
        patches.append(xp[(slice(None), slice(None)) + sl])
        idx.append(flat[sl])
    stacked = torch.stack(patches, -1)
    sidx = torch.stack(idx, -1).expand(stacked.shape)
    arg = torch.argmax(stacked, -1, keepdim=True)
    return (torch.amax(stacked, -1),
            torch.gather(sidx, -1, arg)[..., 0].to(torch.int32))


@register_op("max_pool2d_with_index", inputs=("X",),
             attr_defaults={"ksize": [1, 1], "strides": [1, 1],
                            "paddings": [0, 0], "global_pooling": False,
                            "adaptive": False})
def _max_pool2d_with_index(ins, attrs):
    """2-d max pool with Mask, the flat H·W index of each window's max
    (reference: math/pooling.cc MaxPool2dWithIndex); ``adaptive`` is
    ignored, as in the TPU kernel."""
    x = first(ins, "X")
    ksize = [int(k) for k in attrs.get("ksize", [1, 1])]
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    pads = [int(p) for p in attrs.get("paddings", [0, 0])]
    if attrs.get("global_pooling", False):
        ksize = list(x.shape[2:])
        strides, pads = list(ksize), [0, 0]
    o, mask = _argmax_windows(x, ksize, strides, pads)
    return out(Out=o, Mask=mask)


@register_op("max_pool3d_with_index", inputs=("X",),
             attr_defaults={"ksize": [1, 1, 1], "strides": [1, 1, 1],
                            "paddings": [0, 0, 0], "global_pooling": False,
                            "adaptive": False})
def _max_pool3d_with_index(ins, attrs):
    """3-d max pool with Mask, the flat D·H·W index of each window's max
    (reference: math/pooling.cc MaxPool3dWithIndex); ``adaptive`` bins
    need sizes that divide the input."""
    x = first(ins, "X")
    ksize = [int(k) for k in attrs.get("ksize")]
    strides = [int(s) for s in attrs.get("strides")]
    pads = [int(p) for p in attrs.get("paddings")]
    if attrs.get("adaptive", False):
        dims = x.shape[2:]
        if any(dims[i] % ksize[i] for i in range(3)):
            raise ValueError("adaptive max_pool3d_with_index requires "
                             "divisible sizes in this build")
        ksize = [dims[i] // ksize[i] for i in range(3)]
        strides, pads = list(ksize), [0, 0, 0]
    elif attrs.get("global_pooling", False):
        ksize = list(x.shape[2:])
        strides, pads = list(ksize), [0, 0, 0]
    o, mask = _argmax_windows(x, ksize, strides, pads)
    return out(Out=o, Mask=mask)


# --------------------------------------------------------------------------
# resize and rearrangement
# --------------------------------------------------------------------------
def _interp_size(ins, attrs, x):
    """(out_h, out_w): OutSize, else SizeTensor, else Scale (tensor or
    attr) times X's size, else the attrs. A tensor is read on the host,
    as the TPU kernel reads it; the registrations declare these slots
    ``host_inputs`` (the TPU package's declare none), so a connected one
    makes the op an island rather than a host read in a CUDA graph."""
    ost = first(ins, "OutSize")
    if ost is not None:
        v = ost.reshape(-1).tolist()
        return int(v[0]), int(v[1])
    st = ins.get("SizeTensor") or []
    if st:
        return int(st[0].reshape(()).item()), int(st[1].reshape(()).item())
    sc = first(ins, "Scale")
    scale = (float(sc.reshape(()).item()) if sc is not None
             else attrs.get("scale", 0.0))
    if scale and scale > 0:
        return int(x.shape[2] * scale), int(x.shape[3] * scale)
    return attrs.get("out_h", -1), attrs.get("out_w", -1)


INTERP_HOST_INPUTS = ("OutSize", "SizeTensor", "Scale")


def _i32_ratio(n, num, den, dev):
    """f32(i·num) / f32(den) for i < n, as the TPU kernel's int32
    ``jnp.arange(n) * num / den`` divides."""
    return (torch.arange(n, dtype=torch.int64, device=dev) * num).to(
        torch.float32) / float(den)


@register_op("nearest_interp", inputs=("X", "OutSize", "SizeTensor", "Scale"),
             diff_inputs=("X",),
             host_inputs=INTERP_HOST_INPUTS,
             attr_defaults={"out_h": -1, "out_w": -1, "scale": 0.0,
                            "interp_method": "nearest",
                            "align_corners": True, "align_mode": 1,
                            "data_layout": "NCHW"})
def _nearest_interp(ins, attrs):
    """NCHW nearest resize: with ``align_corners`` (and more than one
    output row and column) the source index is round(i·(h−1)/(oh−1)),
    half to even; else floor(i·h/oh). The indices are computed on the
    device in f32 as the TPU kernel's."""
    x = first(ins, "X")
    oh, ow = _interp_size(ins, attrs, x)
    h, w = x.shape[2], x.shape[3]
    dev = x.device
    if attrs.get("align_corners", True) and oh > 1 and ow > 1:
        hi = torch.round(_i32_ratio(oh, h - 1, oh - 1, dev))
        wi = torch.round(_i32_ratio(ow, w - 1, ow - 1, dev))
    else:
        hi = torch.floor(_i32_ratio(oh, h, oh, dev))
        wi = torch.floor(_i32_ratio(ow, w, ow, dev))
    return out(Out=take_index(take_index(x, 2, hi.long()), 3, wi.long()))


def _bilinear_src(n_out, n_in, ac, am, dev):
    """The f32 source coordinates of ``n_out`` outputs over ``n_in``
    inputs, as the TPU kernel computes them for ``align_corners`` and
    ``align_mode`` 0 or 1."""
    if ac:
        return torch.arange(n_out, dtype=torch.float32, device=dev) \
            * scalar_as((n_in - 1) / max(n_out - 1, 1), torch.float32)
    if am == 0:
        s = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) \
            * float(n_in) / float(n_out) - 0.5
    else:
        s = _i32_ratio(n_out, n_in, n_out, dev)
    return torch.clamp(s, 0, n_in - 1)


@register_op("bilinear_interp",
             inputs=("X", "OutSize", "SizeTensor", "Scale"),
             diff_inputs=("X",),
             host_inputs=INTERP_HOST_INPUTS,
             attr_defaults={"out_h": -1, "out_w": -1, "scale": 0.0,
                            "interp_method": "bilinear",
                            "align_corners": True, "align_mode": 1,
                            "data_layout": "NCHW"})
def _bilinear_interp(ins, attrs):
    """NCHW bilinear resize: each output the four neighbours of its f32
    source point (``_bilinear_src``) weighted as the TPU kernel weighs
    them, v00·(1−a)(1−b) + v01·(1−a)b + v10·a(1−b) + v11·ab. Rows and
    columns are gathered by ``take_rows``, so the grad adds in a fixed
    order (autograd's ``index_add_`` adds with atomics on the card)."""
    x = first(ins, "X")
    oh, ow = _interp_size(ins, attrs, x)
    h, w = x.shape[2], x.shape[3]
    dev = x.device
    ac = attrs.get("align_corners", True)
    am = attrs.get("align_mode", 1)
    hs = _bilinear_src(oh, h, ac, am, dev)
    ws = _bilinear_src(ow, w, ac, am, dev)
    h0, w0 = torch.floor(hs).long(), torch.floor(ws).long()
    h1, w1 = torch.clamp(h0 + 1, max=h - 1), torch.clamp(w0 + 1, max=w - 1)
    ah = (hs - h0)[None, None, :, None]
    aw = (ws - w0)[None, None, None, :]
    r0, r1 = take_index(x, 2, h0), take_index(x, 2, h1)
    v00, v01 = take_index(r0, 3, w0), take_index(r0, 3, w1)
    v10, v11 = take_index(r1, 3, w0), take_index(r1, 3, w1)
    o = (v00 * (1 - ah) * (1 - aw) + v01 * (1 - ah) * aw
         + v10 * ah * (1 - aw) + v11 * ah * aw)
    return out(Out=o.to(x.dtype))


@register_op("pixel_shuffle", inputs=("X",),
             attr_defaults={"upscale_factor": 1})
def _pixel_shuffle(ins, attrs):
    x = first(ins, "X")
    r = attrs.get("upscale_factor", 1)
    n, c, h, w = x.shape
    o = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return out(Out=o.reshape(n, c // (r * r), h * r, w * r))


@register_op("space_to_depth", inputs=("X",), attr_defaults={"blocksize": 1})
def _space_to_depth(ins, attrs):
    x = first(ins, "X")
    b = attrs.get("blocksize", 1)
    n, c, h, w = x.shape
    o = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return out(Out=o.reshape(n, c * b * b, h // b, w // b))


@register_op("shuffle_channel", inputs=("X",), attr_defaults={"group": 1})
def _shuffle_channel(ins, attrs):
    x = first(ins, "X")
    g = attrs.get("group", 1)
    n, c, h, w = x.shape
    return out(Out=x.reshape(n, g, c // g, h, w).transpose(1, 2)
               .reshape(x.shape))
