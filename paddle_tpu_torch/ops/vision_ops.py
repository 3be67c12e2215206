"""Vision op batch 2 (counterpart of paddle_tpu/ops/vision_ops.py: every
op type it registers): crop, affine_grid, unpool, SPP, position-sensitive
and precise RoI pooling, the transposed 3d and depthwise convolutions,
the deformable convolutions, conv_shift, the bicubic and trilinear
resizes, similarity_focus, polygon_box_transform and inplace_abn.

Each is a torch expression of the TPU kernel's formula. The transposed
convolutions are cuDNN's through ``nn_ops._Conv`` (f32 with TF32 off,
deterministic algorithms, bf16 operands under FLAGS_use_bf16_matmul).
Every gather of a sample or a cell goes through ``tensor_ops.take_rows``
and unpool's scatter through ``scatter_rows_add``: their grads add in a
fixed order, never with atomics, so a step is bitwise reproducible."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .nn_ops import (_Conv, _bf16_operands, _conv2d_transpose, _conv_padding,
                     INTERP_HOST_INPUTS, _i32_ratio, _interp_size)
from .detection_ops import roi_batch_ids
from .registry import register_op, first, seq, out
from .tensor_ops import scatter_rows_add, take_index, take_rows


def _elems(x, idx):
    """``x.reshape(-1)[idx]`` through ``take_rows`` (a fixed-order grad)."""
    return take_rows(x.reshape(-1, 1), idx)[..., 0]


def _ints(t):
    return [int(v) for v in t.reshape(-1).tolist()]


# --------------------------------------------------------------------------
# crop family
# --------------------------------------------------------------------------
def _crop_impl(x, offsets, shape):
    shape = [x.shape[i] if s in (-1, 0) else int(s)
             for i, s in enumerate(shape)]
    for d, (o, s) in enumerate(zip(offsets, shape)):
        x = x.narrow(d, int(o), s)
    return x


@register_op("crop", inputs=("X", "Y", "Offsets"), diff_inputs=("X",),
             host_inputs=("Offsets",),
             attr_defaults={"offsets": [], "shape": []})
def _crop(ins, attrs):
    """X's window of Y's shape (else the ``shape`` attr) at the Offsets
    tensor's offsets (read on the host; else the attr's)."""
    x, y = first(ins, "X"), first(ins, "Y")
    shape = (list(y.shape) if y is not None
             else attrs.get("shape") or list(x.shape))
    off_t = first(ins, "Offsets")
    offsets = (_ints(off_t) if off_t is not None
               else attrs.get("offsets") or [0] * x.dim())
    return out(Out=_crop_impl(x, offsets, shape))


@register_op("crop_tensor", inputs=("X", "Shape", "Offsets", "ShapeTensor",
                                    "OffsetsTensor"),
             diff_inputs=("X",),
             host_inputs=("Shape", "Offsets", "ShapeTensor",
                          "OffsetsTensor"),
             attr_defaults={"offsets": [], "shape": []})
def _crop_tensor(ins, attrs):
    """``crop`` with the shape and offsets from a tensor or from scalar
    tensors a dim (read on the host), else from the attrs."""
    x = first(ins, "X")
    sh_t = first(ins, "Shape")
    if sh_t is not None:
        shape = _ints(sh_t)
    elif seq(ins, "ShapeTensor"):
        shape = [_ints(s)[0] for s in seq(ins, "ShapeTensor")]
    else:
        shape = attrs.get("shape") or list(x.shape)
    off_t = first(ins, "Offsets")
    if off_t is not None:
        offsets = _ints(off_t)
    elif seq(ins, "OffsetsTensor"):
        offsets = [_ints(o)[0] for o in seq(ins, "OffsetsTensor")]
    else:
        offsets = attrs.get("offsets") or [0] * x.dim()
    return out(Out=_crop_impl(x, offsets, shape))


# --------------------------------------------------------------------------
# affine_grid, unpool, spp
# --------------------------------------------------------------------------
@register_op("affine_grid", inputs=("Theta", "OutputShape"),
             diff_inputs=("Theta",),
             host_inputs=("OutputShape",),
             attr_defaults={"output_shape": [], "align_corners": True})
def _affine_grid(ins, attrs):
    """Theta [N, 2, 3] applied to the [-1, 1] grid of the output shape
    (OutputShape read on the host, else the attr) → [N, H, W, 2]."""
    theta = first(ins, "Theta")
    osh = first(ins, "OutputShape")
    n, c, h, w = (_ints(osh) if osh is not None
                  else [int(v) for v in attrs.get("output_shape")])
    dev = theta.device
    if attrs.get("align_corners", True):
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1.0
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).to(theta.dtype)
    return out(Output=torch.einsum("hwk,njk->nhwj", base, theta))


@register_op("unpool", inputs=("X", "Indices"), diff_inputs=("X",),
             attr_defaults={"unpooling_type": "max", "ksize": [2, 2],
                            "strides": [2, 2], "paddings": [0, 0]})
def _unpool(ins, attrs):
    """Max-unpooling: each value of X added at its Indices position (of
    max_pool2d_with_index's Mask) in the output plane, repeats summed in
    a fixed order (``scatter_rows_add``)."""
    x, idx = first(ins, "X"), first(ins, "Indices")
    n, c, ih, iw = x.shape
    kh, kw = [int(k) for k in attrs.get("ksize", [2, 2])]
    sh, sw = [int(s) for s in attrs.get("strides", [2, 2])]
    ph, pw = [int(p) for p in attrs.get("paddings", [0, 0])]
    oh = (ih - 1) * sh - 2 * ph + kh
    ow = (iw - 1) * sw - 2 * pw + kw
    plane = torch.arange(n * c, device=x.device).reshape(n, c, 1) * (oh * ow)
    rows = (plane + idx.reshape(n, c, ih * iw).long()).reshape(-1)
    flat = scatter_rows_add(n * c * oh * ow, rows, x.reshape(-1, 1))
    return out(Out=flat.reshape(n, c, oh, ow))


@register_op("spp", inputs=("X",),
             attr_defaults={"pyramid_height": 1, "pooling_type": "max"})
def _spp(ins, attrs):
    """Spatial pyramid pooling: level p pools X to 2^p × 2^p bins (padded
    evenly, −inf for max, 0 for avg), the levels flattened and joined."""
    x = first(ins, "X")
    n, c, h, w = x.shape
    ptype = attrs.get("pooling_type", "max")
    pieces = []
    for p in range(int(attrs.get("pyramid_height", 1))):
        bins = 2 ** p
        kh, kw = int(np.ceil(h / bins)), int(np.ceil(w / bins))
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pads = (pw, kw * bins - w - pw, ph, kh * bins - h - ph)
        if ptype == "max":
            neg = (-float("inf") if x.is_floating_point()
                   else torch.iinfo(x.dtype).min)
            xp = F.pad(x, pads, value=neg)
            r = torch.amax(xp.reshape(n, c, bins, kh, bins, kw), dim=(3, 5))
        else:
            xp = F.pad(x, pads)
            r = torch.mean(xp.reshape(n, c, bins, kh, bins, kw), dim=(3, 5))
        pieces.append(r.reshape(n, c * bins * bins))
    return out(Out=torch.cat(pieces, dim=1))


# --------------------------------------------------------------------------
# position-sensitive / precise RoI pooling
# --------------------------------------------------------------------------
@register_op("psroi_pool", inputs=("X", "ROIs"), diff_inputs=("X",),
             needs_lod=True,
             attr_defaults={"output_channels": 1, "spatial_scale": 1.0,
                            "pooled_height": 1, "pooled_width": 1})
def _psroi_pool(ins, attrs):
    """Position-sensitive RoI pooling: output channel k's bin (i, j) the
    mean of a fixed 2 × 2 grid of X's channel k·ph·pw + i·pw + j (the
    TPU kernel's static sample grid)."""
    x, rois = first(ins, "X"), first(ins, "ROIs")
    n, c, h, w = x.shape
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    oc = int(attrs.get("output_channels", 1))
    scale = attrs.get("spatial_scale", 1.0)
    dev, dt = x.device, x.dtype
    bids = roi_batch_ids(attrs, "ROIs", rois.shape[0], dev)
    x0 = torch.round(rois[:, 0]) * scale
    y0 = torch.round(rois[:, 1]) * scale
    x1 = torch.round(rois[:, 2] + 1.0) * scale
    y1 = torch.round(rois[:, 3] + 1.0) * scale
    tenth = torch.full((), 0.1, dtype=dt, device=dev)
    bin_h = torch.maximum(y1 - y0, tenth) / ph
    bin_w = torch.maximum(x1 - x0, tenth) / pw
    S = 2
    iy = torch.arange(ph, device=dev)
    ix = torch.arange(pw, device=dev)
    sy = (torch.arange(S, dtype=dt, device=dev) + 0.5) / S
    ys = y0[:, None, None] + (iy[None, :, None] + sy[None, None, :]) \
        * bin_h[:, None, None]
    xs = x0[:, None, None] + (ix[None, :, None] + sy[None, None, :]) \
        * bin_w[:, None, None]
    yc = torch.clamp(ys, 0, h - 1).to(torch.int32).long()
    xc = torch.clamp(xs, 0, w - 1).to(torch.int32).long()
    chan = (torch.arange(oc, device=dev)[:, None, None] * (ph * pw)
            + iy[None, :, None] * pw + ix[None, None, :])
    idx = (((bids[:, None, None, None, None, None] * c
             + chan[None, :, :, :, None, None]) * h
            + yc[:, None, :, None, :, None]) * w
           + xc[:, None, None, :, None, :])
    return out(Out=torch.mean(_elems(x, idx), dim=(4, 5)))


@register_op("prroi_pool", inputs=("X", "ROIs", "BatchRoINums"),
             diff_inputs=("X",), needs_lod=True,
             host_inputs=("BatchRoINums",),
             attr_defaults={"spatial_scale": 1.0, "pooled_height": 1,
                            "pooled_width": 1})
def _prroi_pool(ins, attrs):
    """Precise RoI pooling as the TPU kernel approximates it: each bin the
    mean of a 4 × 4 grid of bilinear samples (clamped into X). The RoIs'
    images from BatchRoINums (read on the host), else from the LoD."""
    x, rois = first(ins, "X"), first(ins, "ROIs")
    n, c, h, w = x.shape
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = attrs.get("spatial_scale", 1.0)
    dev, dt = x.device, x.dtype
    R = rois.shape[0]
    brn = first(ins, "BatchRoINums")
    if brn is not None:
        counts = np.asarray(_ints(brn), np.int64)
        bids_np = np.repeat(np.arange(len(counts)), counts)
        if len(bids_np) < R:
            bids_np = np.pad(bids_np, (0, R - len(bids_np)))
        bids = torch.from_numpy(bids_np[:R]).to(dev)
    else:
        bids = roi_batch_ids(attrs, "ROIs", R, dev)
    x0, y0 = rois[:, 0] * scale, rois[:, 1] * scale
    x1, y1 = rois[:, 2] * scale, rois[:, 3] * scale
    zero = torch.zeros((), dtype=dt, device=dev)
    bin_h = torch.maximum(y1 - y0, zero) / ph
    bin_w = torch.maximum(x1 - x0, zero) / pw
    S = 4
    fy = (torch.arange(S, dtype=dt, device=dev) + 0.5) / S
    ys = y0[:, None, None] + (torch.arange(ph, device=dev)[None, :, None]
                              + fy[None, None, :]) * bin_h[:, None, None]
    xs = x0[:, None, None] + (torch.arange(pw, device=dev)[None, :, None]
                              + fy[None, None, :]) * bin_w[:, None, None]
    ysc = torch.clamp(ys, 0, h - 1)
    xsc = torch.clamp(xs, 0, w - 1)
    yi0 = torch.floor(ysc).long()
    xi0 = torch.floor(xsc).long()
    yi1 = torch.clamp(yi0 + 1, max=h - 1)
    xi1 = torch.clamp(xi0 + 1, max=w - 1)
    wy = ysc - yi0
    wx = xsc - xi0
    b = bids[:, None, None, None, None, None]
    ch = torch.arange(c, device=dev)[None, :, None, None, None, None]

    def g(yi, xi):
        return _elems(x, (((b * c + ch) * h + yi[:, None, :, None, :, None])
                          * w + xi[:, None, None, :, None, :]))
    wyE = wy[:, None, :, None, :, None]
    wxE = wx[:, None, None, :, None, :]
    v = (g(yi0, xi0) * (1 - wyE) * (1 - wxE)
         + g(yi0, xi1) * (1 - wyE) * wxE
         + g(yi1, xi0) * wyE * (1 - wxE)
         + g(yi1, xi1) * wyE * wxE)
    return out(Out=torch.mean(v, dim=(4, 5)))


# --------------------------------------------------------------------------
# transposed convs (3d / depthwise)
# --------------------------------------------------------------------------
@register_op("conv3d_transpose", inputs=("Input", "Filter", "Bias"),
             diff_inputs=("Input", "Filter", "Bias"),
             attr_defaults={"strides": [1, 1, 1], "paddings": [0, 0, 0],
                            "dilations": [1, 1, 1], "groups": 1,
                            "output_size": [], "padding_algorithm": "EXPLICIT",
                            "data_format": "NCDHW", "use_cudnn": True})
def _conv3d_transpose(ins, attrs):
    """The transposed convolution of NCDHW Input by Paddle's [in_c,
    out_c/g, kd, kh, kw] filter on cuDNN (``_Conv``), unpadded, then its
    (before, after) paddings cropped off, and with ``output_size`` zeros
    added after or the excess cropped (the TPU kernel's :282-289)."""
    x, w = first(ins, "Input"), first(ins, "Filter")
    strides = [int(s) for s in attrs.get("strides", [1, 1, 1])]
    dil = [int(d) for d in attrs.get("dilations", [1, 1, 1])]
    pads = _conv_padding(attrs.get("paddings", [0, 0, 0]),
                         attrs.get("padding_algorithm", "EXPLICIT"), 3,
                         w.shape[2:], strides, dil, x.shape[2:])
    orig = x.dtype
    x, w = _bf16_operands(x, w)
    o = _Conv.apply(x, w, strides, [0, 0, 0], dil, True,
                    int(attrs.get("groups", 1))).to(orig)
    for d, (a, b) in enumerate(pads):
        o = o.narrow(2 + d, a, o.shape[2 + d] - a - b)
    osize = attrs.get("output_size") or []
    if osize:
        grow = [max(0, int(osize[i]) - o.shape[2 + i]) for i in (0, 1, 2)]
        if any(grow):
            o = F.pad(o, (0, grow[2], 0, grow[1], 0, grow[0]))
        o = o[:, :, :int(osize[0]), :int(osize[1]), :int(osize[2])]
    b = first(ins, "Bias")
    if b is not None:
        o = o + b.reshape(1, -1, 1, 1, 1)
    return out(Output=o)


@register_op("depthwise_conv2d_transpose", inputs=("Input", "Filter", "Bias"),
             diff_inputs=("Input", "Filter", "Bias"),
             attr_defaults={"strides": [1, 1], "paddings": [0, 0],
                            "dilations": [1, 1], "groups": 1,
                            "output_size": [], "padding_algorithm": "EXPLICIT",
                            "data_format": "NCHW", "use_cudnn": False})
def _depthwise_conv2d_transpose(ins, attrs):
    return _conv2d_transpose(ins, attrs)


# --------------------------------------------------------------------------
# deformable convs: bilinear samples at the offset positions, then a
# contraction with the filter
# --------------------------------------------------------------------------
def _bilinear_rows(rows, base, ys, xs, h, w):
    """Bilinear samples of the image rows ``rows`` ([N·H·W, C], an image
    ``base`` rows apart) at ``ys``, ``xs`` ([n, ...]) → [n, ..., C]; a
    corner outside the image adds 0, so a border sample keeps its
    fractional weight (the TPU package's ``_bilinear_at``)."""
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    y0 = y0f.long()
    x0 = x0f.long()
    wy = ys - y0f
    wx = xs - x0f

    def corner(yi, xi, wgt):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = base + torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0,
                                                                 w - 1)
        return take_rows(rows, idx) * (wgt * valid)[..., None]
    return (corner(y0, x0, (1 - wy) * (1 - wx))
            + corner(y0, x0 + 1, (1 - wy) * wx)
            + corner(y0 + 1, x0, wy * (1 - wx))
            + corner(y0 + 1, x0 + 1, wy * wx))


def _deformable_conv_impl(ins, attrs, modulated):
    x = first(ins, "Input")
    offset = first(ins, "Offset")
    mask = first(ins, "Mask") if modulated else None
    w = first(ins, "Filter")
    n, cin, H, W = x.shape
    oc, cpg, kh, kw = w.shape
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    pads = [int(p) for p in attrs.get("paddings", [0, 0])]
    dil = [int(d) for d in attrs.get("dilations", [1, 1])]
    g = int(attrs.get("groups", 1))
    dg = int(attrs.get("deformable_groups", 1))
    oh = (H + 2 * pads[0] - (dil[0] * (kh - 1) + 1)) // strides[0] + 1
    ow = (W + 2 * pads[1] - (dil[1] * (kw - 1) + 1)) // strides[1] + 1
    dev, dt = x.device, x.dtype
    py = (torch.arange(oh, device=dev)[:, None, None, None] * strides[0]
          - pads[0] + torch.arange(kh, device=dev)[None, None, :, None]
          * dil[0])
    px = (torch.arange(ow, device=dev)[None, :, None, None] * strides[1]
          - pads[1] + torch.arange(kw, device=dev)[None, None, None, :]
          * dil[1])
    py = py.expand(oh, ow, kh, kw).to(dt)
    px = px.expand(oh, ow, kh, kw).to(dt)
    # offsets [N, dg·2·kh·kw, oh, ow]: (dy, dx) interleaved a tap
    off = offset.reshape(n, dg, kh * kw, 2, oh, ow)
    dy = off[:, :, :, 0].permute(0, 1, 3, 4, 2).reshape(n, dg, oh, ow, kh, kw)
    dx = off[:, :, :, 1].permute(0, 1, 3, 4, 2).reshape(n, dg, oh, ow, kh, kw)
    if mask is not None:
        m = mask.reshape(n, dg, kh * kw, oh, ow).permute(0, 1, 3, 4, 2) \
            .reshape(n, dg, oh, ow, kh, kw)
    rows = x.permute(0, 2, 3, 1).reshape(n * H * W, cin)
    base = (torch.arange(n, device=dev) * (H * W))[:, None, None, None, None]
    cper = cin // dg
    cols = []
    for d in range(dg):
        s = _bilinear_rows(rows[:, d * cper:(d + 1) * cper], base,
                           py[None] + dy[:, d], px[None] + dx[:, d], H, W)
        if mask is not None:
            s = s * m[:, d][..., None]
        cols.append(s)                            # [n, oh, ow, kh, kw, cper]
    col = torch.cat(cols, dim=-1).permute(0, 5, 1, 2, 3, 4)
    col = col.reshape(n, g, cin // g, oh, ow, kh, kw)
    wg = w.reshape(g, oc // g, cpg, kh, kw)
    o = torch.einsum("ngchwij,gocij->ngohw", col, wg).reshape(n, oc, oh, ow)
    return out(Output=o)


@register_op("deformable_conv",
             inputs=("Input", "Offset", "Mask", "Filter"),
             diff_inputs=("Input", "Offset", "Mask", "Filter"),
             attr_defaults={"strides": [1, 1], "paddings": [0, 0],
                            "dilations": [1, 1], "groups": 1,
                            "deformable_groups": 1, "im2col_step": 64})
def _deformable_conv(ins, attrs):
    """Modulated deformable convolution (v2): each tap sampled at its
    offset, times its Mask."""
    return _deformable_conv_impl(ins, attrs, modulated=True)


@register_op("deformable_conv_v1", inputs=("Input", "Offset", "Filter"),
             diff_inputs=("Input", "Offset", "Filter"),
             attr_defaults={"strides": [1, 1], "paddings": [0, 0],
                            "dilations": [1, 1], "groups": 1,
                            "deformable_groups": 1, "im2col_step": 64})
def _deformable_conv_v1(ins, attrs):
    return _deformable_conv_impl(ins, attrs, modulated=False)


@register_op("deformable_psroi_pooling",
             inputs=("Input", "ROIs", "Trans"),
             diff_inputs=("Input", "Trans"), needs_lod=True,
             attr_defaults={"no_trans": False, "spatial_scale": 1.0,
                            "output_dim": 1, "group_size": [1],
                            "pooled_height": 1, "pooled_width": 1,
                            "part_size": [1], "sample_per_part": 4,
                            "trans_std": 0.1})
def _deformable_psroi_pooling(ins, attrs):
    """Deformable position-sensitive RoI pooling: each bin shifted by its
    part's Trans (× trans_std × the RoI's size) and the mean of
    sample_per_part² bilinear samples (clamped into X) of its
    group_size channel."""
    x, rois = first(ins, "Input"), first(ins, "ROIs")
    trans = first(ins, "Trans")
    n, c, h, w = x.shape
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    od = int(attrs.get("output_dim", 1))
    scale = attrs.get("spatial_scale", 1.0)
    ts = attrs.get("trans_std", 0.1)
    dev, dt = x.device, x.dtype
    R = rois.shape[0]
    bids = roi_batch_ids(attrs, "ROIs", R, dev)
    x0 = torch.round(rois[:, 0]) * scale - 0.5
    y0 = torch.round(rois[:, 1]) * scale - 0.5
    x1 = (torch.round(rois[:, 2]) + 1.0) * scale - 0.5
    y1 = (torch.round(rois[:, 3]) + 1.0) * scale - 0.5
    tenth = torch.full((), 0.1, dtype=dt, device=dev)
    rw = torch.maximum(x1 - x0, tenth)
    rh = torch.maximum(y1 - y0, tenth)
    bin_h = (rh / ph)[:, None, None]
    bin_w = (rw / pw)[:, None, None]
    iy = torch.arange(ph, device=dev)[None, :, None]
    ix = torch.arange(pw, device=dev)[None, None, :]
    if attrs.get("no_trans", False) or trans is None:
        dy = torch.zeros((R, ph, pw), dtype=dt, device=dev)
        dx = torch.zeros((R, ph, pw), dtype=dt, device=dev)
    else:
        pth, ptw = trans.shape[2], trans.shape[3]
        pyi = torch.clamp(iy * pth // ph, 0, pth - 1)
        pxi = torch.clamp(ix * ptw // pw, 0, ptw - 1)
        r_ = torch.arange(R, device=dev)[:, None, None]
        at = ((r_ * 2) * pth + pyi) * ptw + pxi
        dy = _elems(trans, at) * ts * rh[:, None, None]
        dx = _elems(trans, at + pth * ptw) * ts * rw[:, None, None]
    S = int(attrs.get("sample_per_part", 4))
    fs = (torch.arange(S, dtype=dt, device=dev) + 0.5) / S
    ys = (y0[:, None, None] + iy * bin_h + dy)[..., None] \
        + fs * bin_h[..., None]
    xs = (x0[:, None, None] + ix * bin_w + dx)[..., None] \
        + fs * bin_w[..., None]
    gs = attrs.get("group_size", [1])
    gh = int(gs[0])
    gw = int(gs[1] if len(gs) > 1 else gs[0])
    gy = torch.arange(ph, device=dev) * gh // ph
    gx = torch.arange(pw, device=dev) * gw // pw
    chan = ((torch.arange(od, device=dev)[:, None, None] * gh
             + gy[None, :, None]) * gw + gx[None, None, :])
    yc = torch.clamp(ys, 0, h - 1)
    xc = torch.clamp(xs, 0, w - 1)
    yi0 = torch.floor(yc).long()
    xi0 = torch.floor(xc).long()
    yi1 = torch.clamp(yi0 + 1, max=h - 1)
    xi1 = torch.clamp(xi0 + 1, max=w - 1)
    wy = yc - yi0
    wx = xc - xi0
    b = bids[:, None, None, None, None, None]
    ch = chan[None, :, :, :, None, None]

    def g(yi, xi):
        return _elems(x, ((b * c + ch) * h + yi[:, None, :, :, :, None])
                      * w + xi[:, None, :, :, None, :])
    wyE = wy[:, None, :, :, :, None]
    wxE = wx[:, None, :, :, None, :]
    v = (g(yi0, xi0) * (1 - wyE) * (1 - wxE) + g(yi0, xi1) * (1 - wyE) * wxE
         + g(yi1, xi0) * wyE * (1 - wxE) + g(yi1, xi1) * wyE * wxE)
    o = torch.mean(v, dim=(4, 5)).to(dt)
    return out(Output=o, TopCount=torch.ones_like(o))


# --------------------------------------------------------------------------
# conv_shift — circular correlation (NTM addressing)
# --------------------------------------------------------------------------
@register_op("conv_shift", inputs=("X", "Y"), diff_inputs=("X", "Y"))
def _conv_shift(ins, attrs):
    """out[b, i] = Σ_j X[b, (i + j − k/2) mod W] · Y[b, j]."""
    x, y = first(ins, "X"), first(ins, "Y")
    k = y.shape[1]
    half = k // 2
    stacked = torch.stack([torch.roll(x, half - j, dims=1)
                           for j in range(k)], dim=2)
    return out(Out=torch.einsum("bwk,bk->bw", stacked, y))


# --------------------------------------------------------------------------
# bicubic / trilinear interpolation
# --------------------------------------------------------------------------
def _cubic_w(t, a=-0.75):
    t = torch.abs(t)
    t2, t3 = t * t, t * t * t
    w1 = (a + 2) * t3 - (a + 3) * t2 + 1
    w2 = a * t3 - 5 * a * t2 + 8 * a * t - 4 * a
    return torch.where(t <= 1, w1,
                       torch.where(t < 2, w2, torch.zeros_like(t)))


@register_op("bicubic_interp", inputs=("X", "OutSize", "SizeTensor", "Scale"),
             diff_inputs=("X",),
             host_inputs=INTERP_HOST_INPUTS,
             attr_defaults={"out_h": -1, "out_w": -1, "scale": 0.0,
                            "interp_method": "bicubic", "align_corners": True,
                            "align_mode": 1, "data_layout": "NCHW"})
def _bicubic_interp(ins, attrs):
    """NCHW bicubic resize (a = −0.75): each output the 4 × 4 neighbours
    of its source point, clamped into X, weighted by Keys' kernel; rows
    and columns gathered by ``take_index``."""
    x = first(ins, "X")
    oh, ow = _interp_size(ins, attrs, x)
    h, w = x.shape[2], x.shape[3]
    dev = x.device
    if attrs.get("align_corners", True):
        hs = torch.arange(oh, dtype=torch.float32, device=dev) \
            * ((h - 1) / max(oh - 1, 1))
        ws = torch.arange(ow, dtype=torch.float32, device=dev) \
            * ((w - 1) / max(ow - 1, 1))
    else:
        hs = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) \
            * h / oh - 0.5
        ws = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) \
            * w / ow - 0.5
    h0 = torch.floor(hs).long()
    w0 = torch.floor(ws).long()
    fy = hs - h0
    fx = ws - w0
    o = None
    for i in range(-1, 3):
        wyi = _cubic_w(fy - i)[None, None, :, None]
        rows = take_index(x, 2, torch.clamp(h0 + i, 0, h - 1))
        row = None
        for j in range(-1, 3):
            wxj = _cubic_w(fx - j)[None, None, None, :]
            t = take_index(rows, 3, torch.clamp(w0 + j, 0, w - 1)) * wxj
            row = t if row is None else row + t
        o = row * wyi if o is None else o + row * wyi
    return out(Out=o.to(x.dtype))


@register_op("trilinear_interp",
             inputs=("X", "OutSize", "SizeTensor", "Scale"),
             diff_inputs=("X",),
             host_inputs=INTERP_HOST_INPUTS,
             attr_defaults={"out_d": -1, "out_h": -1, "out_w": -1,
                            "scale": 0.0, "interp_method": "trilinear",
                            "align_corners": True, "align_mode": 1,
                            "data_layout": "NCDHW"})
def _trilinear_interp(ins, attrs):
    """NCDHW trilinear resize: the eight neighbours of each output's
    source point weighted as the TPU kernel weighs them; the sizes from
    OutSize, SizeTensor or Scale (read on the host), else the attrs."""
    x = first(ins, "X")
    ost = first(ins, "OutSize")
    st = seq(ins, "SizeTensor")
    if ost is not None:
        od, oh, ow = _ints(ost)
    elif st:
        od, oh, ow = [_ints(s)[0] for s in st[:3]]
    else:
        sct = first(ins, "Scale")
        sc = (float(sct.reshape(()).item()) if sct is not None
              else attrs.get("scale", 0.0))
        if sc and sc > 0:
            od, oh, ow = (int(x.shape[2] * sc), int(x.shape[3] * sc),
                          int(x.shape[4] * sc))
        else:
            od, oh, ow = (attrs.get("out_d"), attrs.get("out_h"),
                          attrs.get("out_w"))
    d, h, w = x.shape[2:]
    ac = attrs.get("align_corners", True)
    dev = x.device

    def axis_coords(o, n):
        if ac:
            return torch.arange(o, dtype=torch.float32, device=dev) \
                * ((n - 1) / max(o - 1, 1))
        if attrs.get("align_mode", 1) == 0:
            return torch.clamp((torch.arange(o, dtype=torch.float32,
                                             device=dev) + 0.5) * n / o
                               - 0.5, 0, n - 1)
        return torch.clamp(_i32_ratio(o, n, o, dev), 0, n - 1)
    ds, hs, ws = axis_coords(od, d), axis_coords(oh, h), axis_coords(ow, w)
    d0 = torch.floor(ds).long()
    d1 = torch.clamp(d0 + 1, max=d - 1)
    h0 = torch.floor(hs).long()
    h1 = torch.clamp(h0 + 1, max=h - 1)
    w0 = torch.floor(ws).long()
    w1 = torch.clamp(w0 + 1, max=w - 1)
    ad = (ds - d0)[None, None, :, None, None]
    ah = (hs - h0)[None, None, None, :, None]
    aw = (ws - w0)[None, None, None, None, :]

    def gv(di, hi, wi):
        return take_index(take_index(take_index(x, 2, di), 3, hi), 4, wi)
    o = (gv(d0, h0, w0) * (1 - ad) * (1 - ah) * (1 - aw)
         + gv(d0, h0, w1) * (1 - ad) * (1 - ah) * aw
         + gv(d0, h1, w0) * (1 - ad) * ah * (1 - aw)
         + gv(d0, h1, w1) * (1 - ad) * ah * aw
         + gv(d1, h0, w0) * ad * (1 - ah) * (1 - aw)
         + gv(d1, h0, w1) * ad * (1 - ah) * aw
         + gv(d1, h1, w0) * ad * ah * (1 - aw)
         + gv(d1, h1, w1) * ad * ah * aw)
    return out(Out=o.to(x.dtype))


# --------------------------------------------------------------------------
# similarity_focus / polygon_box_transform / inplace_abn
# --------------------------------------------------------------------------
@register_op("similarity_focus", inputs=("X",),
             attr_defaults={"axis": 1, "indexes": [0]})
def _similarity_focus(ins, attrs):
    """For each selected plane (``indexes`` along ``axis``) 1 at each
    row's and each column's first maximum, the union over the planes,
    broadcast along ``axis`` (the TPU kernel's row/column-argmax
    formulation of the reference's greedy selection)."""
    x = first(ins, "X")
    ax = attrs.get("axis", 1)
    rem = [a for a in (1, 2, 3) if a != ax]
    d1, d2 = x.shape[rem[0]], x.shape[rem[1]]
    dev = x.device
    masks = torch.zeros((x.shape[0], d1, d2), dtype=x.dtype, device=dev)
    for k in attrs.get("indexes", [0]):
        plane = x.select(ax, int(k))                        # [n, d1, d2]
        rm = (torch.argmax(plane, dim=2)[..., None]
              == torch.arange(d2, device=dev)).to(x.dtype)
        cm = (torch.argmax(plane, dim=1)[:, None, :]
              == torch.arange(d1, device=dev)[:, None]).to(x.dtype)
        masks = torch.maximum(masks, torch.maximum(rm, cm))
    return out(Out=masks.unsqueeze(ax).expand(x.shape).contiguous())


@register_op("polygon_box_transform", inputs=("Input",))
def _polygon_box_transform(ins, attrs):
    """EAST's geometry decode: an even (x) channel's non-zero offsets
    become 4·col − offset, an odd (y) one's 4·row − offset."""
    x = first(ins, "Input")
    n, c, h, w = x.shape
    dev = x.device
    col = torch.arange(w, dtype=x.dtype, device=dev)[None, :].expand(h, w)
    row = torch.arange(h, dtype=x.dtype, device=dev)[:, None].expand(h, w)
    is_x = (torch.arange(c, device=dev) % 2 == 0)[None, :, None, None]
    base = torch.where(is_x, col[None, None], row[None, None]) * 4.0
    return out(Output=torch.where(x != 0, base - x, x))


@register_op("inplace_abn",
             inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             diff_inputs=("X", "Scale", "Bias"), stateful=True,
             attr_defaults={"momentum": 0.9, "epsilon": 1e-5,
                            "is_test": False, "data_layout": "NCHW",
                            "activation": "identity", "alpha": 0.01,
                            "use_global_stats": False,
                            "trainable_statistics": False})
def _inplace_abn(ins, attrs):
    """``batch_norm``'s kernel, then identity, elu or leaky_relu on Y
    (the in-place memory saving is the allocator's business here).
    Registered stateful, as in the TPU package: as there, it has no grad
    kernel."""
    from .nn_ops import _batch_norm
    r = _batch_norm(ins, attrs)
    act = attrs.get("activation", "identity")
    y = r["Y"][0]
    if act == "elu":
        a = attrs.get("alpha", 1.0)
        y = torch.where(y > 0, y, a * (torch.exp(y) - 1.0))
    elif act == "leaky_relu":
        y = torch.where(y > 0, y, attrs.get("alpha", 0.01) * y)
    r["Y"] = [y]
    return r
