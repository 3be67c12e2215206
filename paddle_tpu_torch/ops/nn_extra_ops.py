"""Additional NN op kernels (counterpart of paddle_tpu/ops/nn_extra_ops.py:
every op type it registers last; its center_loss and grid_sampler are
registered again by loss_extra_ops.py, whose kernels are the ones in its
registry, so the port's are there): add_position_encoding, maxout,
affine_channel, bilinear_tensor_product, cvm, fsp, temporal_shift,
unfold, mean_iou, row_conv, sigmoid_focal_loss, iou_similarity,
pad_constant_batch_size_like and squared_l2_distance.

Each is a torch expression of the TPU kernel's formula. The one scatter,
mean_iou's confusion matrix, adds integer counts: exact in any order."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .math_ops import scalar_as
from .registry import register_op, first, out


@register_op("add_position_encoding", inputs=("X",),
             attr_defaults={"alpha": 1.0, "beta": 1.0})
def _add_position_encoding(ins, attrs):
    """alpha·X + beta·PE for X [B, T, D]: PE's first D/2 columns are
    sin(t / 10000^(i / (D/2))), the others the cos. As the TPU kernel,
    the positions and divisors are built in X's dtype (so in bf16 the
    base 10000 is bf16's 9984) and every scalar is rounded to it."""
    x = first(ins, "X")
    _, t, d = x.shape
    half = d // 2
    dt = x.dtype
    pos = torch.arange(t, dtype=dt, device=x.device)[:, None]
    expo = torch.arange(half, dtype=dt, device=x.device) / half
    div = torch.pow(scalar_as(10000.0, dt), expo)[None, :]
    enc = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    return out(Out=scalar_as(attrs.get("alpha", 1.0), dt) * x
               + scalar_as(attrs.get("beta", 1.0), dt) * enc[None, :, :])


@register_op("maxout", inputs=("X",), attr_defaults={"groups": 1, "axis": 1})
def _maxout(ins, attrs):
    """The max over each run of ``groups`` channels along ``axis`` (a
    tie's grad split evenly, as ``jnp.max``'s)."""
    x = first(ins, "X")
    g = attrs.get("groups", 1)
    ax = attrs.get("axis", 1) % x.dim()
    shape = tuple(x.shape[:ax]) + (x.shape[ax] // g, g) \
        + tuple(x.shape[ax + 1:])
    return out(Out=torch.amax(x.reshape(shape), dim=ax + 1))


@register_op("affine_channel", inputs=("X", "Scale", "Bias"),
             diff_inputs=("X", "Scale", "Bias"),
             attr_defaults={"data_layout": "NCHW"})
def _affine_channel(ins, attrs):
    """X·Scale + Bias, one pair a channel (dim 1 for NCHW, else the
    last)."""
    x, scale, bias = first(ins, "X"), first(ins, "Scale"), first(ins, "Bias")
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    shp = [1] * x.dim()
    shp[c_axis] = x.shape[c_axis]
    return out(Out=x * scale.reshape(shp) + bias.reshape(shp))


@register_op("bilinear_tensor_product", inputs=("X", "Y", "Weight", "Bias"),
             diff_inputs=("X", "Y", "Weight", "Bias"))
def _bilinear_tensor_product(ins, attrs):
    """out[b, k] = x[b]ᵀ·W[k]·y[b] (+ Bias[k])."""
    x, y, w = first(ins, "X"), first(ins, "Y"), first(ins, "Weight")
    o = torch.einsum("bi,kij,bj->bk", x, w, y)
    b = first(ins, "Bias")
    return out(Out=o if b is None else o + b.reshape(1, -1))


@register_op("cvm", inputs=("X", "CVM"), diff_inputs=("X",),
             attr_defaults={"use_cvm": True})
def _cvm(ins, attrs):
    """With ``use_cvm`` the show and click columns (0, 1) become
    log(max(x, 0) + 1); without it they are dropped."""
    x = first(ins, "X")
    if attrs.get("use_cvm", True):
        show_clk = torch.log(torch.clamp(x[:, :2], min=0.0) + 1.0)
        return out(Y=torch.cat([show_clk, x[:, 2:]], dim=1))
    return out(Y=x[:, 2:])


@register_op("fsp", inputs=("X", "Y"))
def _fsp(ins, attrs):
    """The flow-of-solution-procedure matrix: X's and Y's channels' inner
    products over the H·W positions, over H·W."""
    x, y = first(ins, "X"), first(ins, "Y")
    n, h = x.shape[0], x.shape[2] * x.shape[3]
    return out(Out=torch.einsum("nch,ndh->ncd", x.reshape(n, -1, h),
                                y.reshape(n, -1, h)) / h)


@register_op("temporal_shift", inputs=("X",),
             attr_defaults={"seg_num": 1, "shift_ratio": 0.25})
def _temporal_shift(ins, attrs):
    """X [N·T, C, H, W] as N clips of T = ``seg_num`` frames: the first
    C·ratio channels take the previous frame's, the next C·ratio the next
    frame's, zero at a clip's ends."""
    x = first(ins, "X")
    seg = attrs["seg_num"]
    ratio = attrs.get("shift_ratio", 0.25)
    nt, c, h, w = x.shape
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    pad = F.pad(x.reshape(nt // seg, seg, c, h, w),
                (0, 0, 0, 0, 0, 0, 1, 1))
    return out(Out=torch.cat([pad[:, :seg, :c1], pad[:, 2:seg + 2, c1:c2],
                              pad[:, 1:seg + 1, c2:]], dim=2)
               .reshape(nt, c, h, w))


@register_op("unfold", inputs=("X",), diff_inputs=("X",),
             attr_defaults={"kernel_sizes": [1, 1], "strides": [1, 1],
                            "paddings": [0, 0, 0, 0], "dilations": [1, 1]})
def _unfold(ins, attrs):
    """im2col: [N, C·kh·kw, L] of the kh·kw strided slices of X padded
    (top, left, bottom, right), stacked in window order. Slices, no
    gather: the grad adds each slice's in a fixed order."""
    x = first(ins, "X")
    kh, kw = attrs["kernel_sizes"]
    sh, sw = attrs["strides"]
    p = attrs["paddings"]
    dh, dw = attrs["dilations"]
    n, c = x.shape[0], x.shape[1]
    xp = F.pad(x, (p[1], p[3], p[0], p[2]))
    hh, ww = xp.shape[2], xp.shape[3]
    oh = (hh - (dh * (kh - 1) + 1)) // sh + 1
    ow = (ww - (dw * (kw - 1) + 1)) // sw + 1
    patches = [xp[:, :, i * dh:i * dh + (oh - 1) * sh + 1:sh,
                  j * dw:j * dw + (ow - 1) * sw + 1:sw]
               for i in range(kh) for j in range(kw)]
    return out(Y=torch.stack(patches, 2).reshape(n, c * kh * kw, oh * ow))


@register_op("mean_iou", inputs=("Predictions", "Labels"), no_grad=True,
             attr_defaults={"num_classes": 2})
def _mean_iou(ins, attrs):
    """The confusion matrix cm[label, pred] of the pixels whose label is a
    class, then the mean IoU over the classes present in either, and
    each class's wrong (its column's sum off the diagonal) and correct
    counts. The TPU kernel scatters to label·k + pred with ``.at[].add``,
    which takes a negative index from the end and drops one past the
    end; here such an index goes to a spare slot first (a label of 255
    or −1 would assert on the card or land elsewhere), then the index is
    taken as JAX takes it. An invalid pixel adds 0 either way."""
    pred = first(ins, "Predictions").reshape(-1).long()
    label = first(ins, "Labels").reshape(-1).long()
    k = attrs["num_classes"]
    kk = k * k
    valid = (label >= 0) & (label < k)
    idx = label * k + pred
    idx = torch.where(idx < 0, idx + kk, idx)
    idx = torch.where((idx >= 0) & (idx < kk), idx,
                      torch.full_like(idx, kk))
    cm = torch.zeros((kk + 1,), dtype=torch.int32, device=pred.device) \
        .scatter_add_(0, idx, valid.to(torch.int32))[:kk].reshape(k, k)
    diag = torch.diagonal(cm)
    inter = diag.to(torch.float32)
    union = (cm.sum(0) + cm.sum(1)).to(torch.float32) - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                      torch.zeros((), dtype=torch.float32,
                                  device=pred.device))
    denom = torch.clamp((union > 0).sum(), min=1)
    return out(OutMeanIou=(iou.sum() / denom).reshape((1,)),
               OutWrong=(cm.sum(0) - diag).to(torch.int32),
               OutCorrect=diag.to(torch.int32))


@register_op("row_conv", inputs=("X", "Filter"), diff_inputs=("X", "Filter"))
def _row_conv(ins, attrs):
    """Lookahead convolution over X [..., T, D]: out[t] = Σ_i x[t + i]·
    w[i] for the ``future + 1`` rows of Filter, zero past the end."""
    x, w = first(ins, "X"), first(ins, "Filter")
    k, t = w.shape[0], x.shape[-2]
    pad = F.pad(x, (0, 0, 0, k - 1))
    o = 0
    for i in range(k):
        o = o + pad[..., i:i + t, :] * w[i]
    return out(Out=o)


@register_op("sigmoid_focal_loss", inputs=("X", "Label", "FgNum"),
             diff_inputs=("X",),
             attr_defaults={"gamma": 2.0, "alpha": 0.25})
def _sigmoid_focal_loss(ins, attrs):
    """α_t·(1 − p_t)^γ·CE(x, t) / max(FgNum, 1), t the one-hot of Label
    (1-based; 0 the background) over the C columns."""
    x, label, fg = first(ins, "X"), first(ins, "Label"), first(ins, "FgNum")
    gamma, alpha = attrs.get("gamma", 2.0), attrs.get("alpha", 0.25)
    c = x.shape[1]
    fg = torch.clamp(fg.reshape(()).to(x.dtype), min=1.0)
    lbl = (label.squeeze(-1) if label.dim() == 2 else label).long()
    t = (lbl[:, None] == torch.arange(1, c + 1, device=x.device)).to(
        x.dtype)
    p = torch.sigmoid(x)
    ce = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    return out(Out=a_t * (1 - p_t) ** gamma * ce / fg)


@register_op("iou_similarity", inputs=("X", "Y"), no_grad=True,
             attr_defaults={"box_normalized": True})
def _iou_similarity(ins, attrs):
    """The [N, M] IoU of X's and Y's (x1, y1, x2, y2) boxes; unnormalized
    boxes count their end pixels (+1)."""
    x, y = first(ins, "X"), first(ins, "Y")
    eps = 0.0 if attrs.get("box_normalized", True) else 1.0
    ax1, ay1, ax2, ay2 = (x[..., i] for i in range(4))
    bx1, by1, bx2, by2 = (y[..., i] for i in range(4))
    area_a = (ax2 - ax1 + eps) * (ay2 - ay1 + eps)
    area_b = (bx2 - bx1 + eps) * (by2 - by1 + eps)
    iw = torch.clamp(torch.minimum(ax2[:, None], bx2[None, :])
                     - torch.maximum(ax1[:, None], bx1[None, :]) + eps,
                     min=0.0)
    ih = torch.clamp(torch.minimum(ay2[:, None], by2[None, :])
                     - torch.maximum(ay1[:, None], by1[None, :]) + eps,
                     min=0.0)
    inter = iw * ih
    return out(Out=inter / (area_a[:, None] + area_b[None, :] - inter))


@register_op("pad_constant_batch_size_like", inputs=("X", "Y"),
             diff_inputs=("Y",))
def _pad_constant_bsl(ins, attrs):
    """Y as it is, as the TPU kernel gives it."""
    return out(Out=first(ins, "Y"))


@register_op("squared_l2_distance", inputs=("X", "Y"))
def _squared_l2_distance(ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    d = x - y
    return out(sub_result=d, Out=torch.square(d).reshape(d.shape[0], -1)
               .sum(-1, keepdim=True))
