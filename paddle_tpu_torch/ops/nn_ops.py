"""NN op kernels (counterpart of paddle_tpu/ops/nn_ops.py; so far:
lookup_table, lookup_table_v2, conv2d, depthwise_conv2d, pool2d,
batch_norm, layer_norm, softmax, cross_entropy, softmax_with_cross_entropy,
square_error_cost, log_loss, accuracy, auc and dropout with its
dropout_grad).

The convolution is cuDNN's, through ``torch.nn.functional.conv2d``, as
the TPU package's is XLA's ``lax.conv_general_dilated``; pooling and
batch norm are torch expressions of the TPU package's own formulas."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda import dropout as cuda_dropout
from .math_ops import bf16_matmul_enabled, scalar_as
from .registry import register_grad_maker, register_op, first, out
from .tensor_ops import take_rows


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


class _Conv2d(torch.autograd.Function):
    """NCHW ``F.conv2d`` without bias whose backward runs under
    ``_cudnn_pinned`` too: autograd runs it after the forward's ``with``
    block has closed, and cuDNN reads the flags when it runs."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        with _cudnn_pinned():
            return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        with _cudnn_pinned():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, dilation, False, [0, 0],
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False])
        return gx, gw, None, None, None, None


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
    o = _Conv2d.apply(x, w, strides, [pt, pl], dil,
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
