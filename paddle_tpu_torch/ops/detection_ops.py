"""Detection operators (counterpart of paddle_tpu/ops/detection_ops.py:
every op type it registers; reference: paddle/fluid/operators/detection/).

The split is the TPU package's:
- the generators (prior_box, density_prior_box, anchor_generator) depend
  on shapes and attrs alone: built with numpy on the host exactly as the
  TPU kernel builds them, once a (shape, attrs, device), and kept on the
  device, so a CUDA graph holds a device constant, not a host build;
- the decoders and the losses (box_coder, box_clip, yolo_box,
  yolov3_loss, roi_align) are torch expressions of the TPU kernel's
  formulas. Their gathers go through ``tensor_ops.take_rows``, whose
  grad adds repeated rows in a fixed order (never atomics), so a step is
  bitwise reproducible; yolov3_loss is vectorised over the ground-truth
  boxes and roi_align over the RoIs and their samples;
- the selections with data-dependent output sizes (the matching, the NMS
  family, roi_pool, the proposal ops) are host ops (``stateful``): their
  inputs come to the host as numpy and their outputs, with LoD, go back
  to the inputs' device. They are exactly the TPU kernel's numpy, with
  its Python loops vectorised: ``_nms`` computes the IoU matrix at once
  in the dtype and op order of the TPU package's ``_iou_xyxy`` and runs
  the same greedy scan (on bit rows for a fixed threshold), so it keeps
  the same indices in the same order.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op, first, seq, out
from .sequence_ops import _const
from .tensor_ops import take_rows


def _host(t):
    return t.detach().cpu().numpy()


def _dev(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _lod_offs(attrs, slot, n):
    """The finest offsets of ``slot``'s LoD, or one sequence of ``n``."""
    lods = (attrs.get("_lod") or {}).get(slot)
    if lods and lods[0]:
        return np.asarray(lods[0][-1], np.int64)
    return np.asarray([0, n], np.int64)


def _lod0(lens):
    return (tuple(int(v) for v in np.concatenate([[0], np.cumsum(lens)])),)


def roi_batch_ids(attrs, slot, num_rois, device):
    """Each RoI's image from the slot's LoD (a plan's device constant,
    ``sequence_ops._const``), else image 0."""
    lod = (attrs.get("_lod") or {}).get(slot)
    if lod and lod[0]:
        offs = np.asarray(lod[0][-1], np.int64)
        return _const(attrs, f"roi_batch_{slot}", lambda: np.repeat(
            np.arange(len(offs) - 1), offs[1:] - offs[:-1])[:num_rois],
            device, torch.int64)
    return torch.zeros(num_rois, dtype=torch.int64, device=device)


# --------------------------------------------------------------------------
# prior / anchor generators (host-built device constants)
# --------------------------------------------------------------------------
_GENERATED = {}


def _frozen(v):
    if isinstance(v, (list, tuple)):
        return tuple(_frozen(x) for x in v)
    return v


def _generated(op_type, shapes, attrs, device, build):
    """``build()``'s numpy arrays as tensors on ``device``, built once a
    (op type, input shapes, attrs, device); each call returns copies, so
    no caller can write into the kept constants."""
    key = (op_type, shapes, str(device), tuple(sorted(
        (k, _frozen(v)) for k, v in attrs.items() if not k.startswith("_"))))
    got = _GENERATED.get(key)
    if got is None:
        got = tuple(_dev(a, device) for a in build())
        _GENERATED[key] = got
    return tuple(t.clone() for t in got)


def _prior_box_np(H, W, IH, IW, attrs):
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes") or []]
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", [1.0]):
        ar = float(ar)
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if attrs.get("flip", False):
                ars.append(1.0 / ar)
    step_w = attrs.get("step_w") or IW / W
    step_h = attrs.get("step_h") or IH / H
    offset = attrs.get("offset", 0.5)
    boxes = []
    for ms in min_sizes:
        for ar in ars:
            boxes.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        if max_sizes:
            mx = max_sizes[min_sizes.index(ms)]
            boxes.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
    bw = np.asarray([b[0] for b in boxes], np.float32) / 2.0
    bh = np.asarray([b[1] for b in boxes], np.float32) / 2.0
    cx = (np.arange(W, dtype=np.float32) + offset) * step_w
    cy = (np.arange(H, dtype=np.float32) + offset) * step_h
    cxg, cyg = np.meshgrid(cx, cy)
    cxg = cxg[..., None]
    cyg = cyg[..., None]
    out_boxes = np.stack([
        (cxg - bw) / IW, (cyg - bh) / IH,
        (cxg + bw) / IW, (cyg + bh) / IH], axis=-1)       # [H, W, P, 4]
    if attrs.get("clip", False):
        out_boxes = np.clip(out_boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(attrs["variances"], np.float32),
                          out_boxes.shape).copy()
    return out_boxes.astype(np.float32), var


@register_op("prior_box", no_grad=True,
             attr_defaults={"min_sizes": [], "max_sizes": [],
                            "aspect_ratios": [1.0], "variances":
                            [0.1, 0.1, 0.2, 0.2], "flip": False,
                            "clip": False, "step_w": 0.0, "step_h": 0.0,
                            "offset": 0.5, "min_max_aspect_ratios_order":
                            False})
def _prior_box(ins, attrs):
    """SSD's prior boxes [H, W, P, 4] of each feature-map cell and their
    variances, in the TPU kernel's prior order."""
    feat, image = first(ins, "Input"), first(ins, "Image")
    H, W = feat.shape[2], feat.shape[3]
    IH, IW = image.shape[2], image.shape[3]
    boxes, var = _generated("prior_box", (H, W, IH, IW), attrs, feat.device,
                            lambda: _prior_box_np(H, W, IH, IW, attrs))
    return out(Boxes=boxes, Variances=var)


def _density_prior_box_np(H, W, IH, IW, attrs):
    step_w = attrs.get("step_w") or IW / W
    step_h = attrs.get("step_h") or IH / H
    offset = attrs.get("offset", 0.5)
    fixed_sizes = [float(s) for s in attrs["fixed_sizes"]]
    fixed_ratios = [float(r) for r in attrs["fixed_ratios"]]
    densities = [int(d) for d in attrs["densities"]]
    all_boxes = []
    for y in range(H):
        for x in range(W):
            cx = (x + offset) * step_w
            cy = (y + offset) * step_h
            for size, dens in zip(fixed_sizes, densities):
                for ratio in fixed_ratios:
                    bw = size * np.sqrt(ratio)
                    bh = size / np.sqrt(ratio)
                    shift = size / dens
                    for di in range(dens):
                        for dj in range(dens):
                            ccx = cx - size / 2.0 + shift / 2.0 + dj * shift
                            ccy = cy - size / 2.0 + shift / 2.0 + di * shift
                            all_boxes.append([
                                (ccx - bw / 2.0) / IW, (ccy - bh / 2.0) / IH,
                                (ccx + bw / 2.0) / IW, (ccy + bh / 2.0) / IH])
    boxes = np.asarray(all_boxes, np.float32)
    if attrs.get("clip", False):
        boxes = np.clip(boxes, 0.0, 1.0)
    P = len(boxes) // (H * W)
    boxes = boxes.reshape(H, W, P, 4)
    var = np.broadcast_to(np.asarray(attrs["variances"], np.float32),
                          boxes.shape).copy()
    if attrs.get("flatten_to_2d", False):
        boxes = boxes.reshape(-1, 4)
        var = var.reshape(-1, 4)
    return boxes, var


@register_op("density_prior_box", no_grad=True,
             attr_defaults={"variances": [0.1, 0.1, 0.2, 0.2], "clip": False,
                            "step_w": 0.0, "step_h": 0.0, "offset": 0.5,
                            "fixed_sizes": [], "fixed_ratios": [],
                            "densities": [], "flatten_to_2d": False})
def _density_prior_box(ins, attrs):
    """Densified priors: ``densities[k]``² shifted boxes of each fixed
    size and ratio a cell."""
    feat, image = first(ins, "Input"), first(ins, "Image")
    H, W = feat.shape[2], feat.shape[3]
    IH, IW = image.shape[2], image.shape[3]
    boxes, var = _generated(
        "density_prior_box", (H, W, IH, IW), attrs, feat.device,
        lambda: _density_prior_box_np(H, W, IH, IW, attrs))
    return out(Boxes=boxes, Variances=var)


def _anchor_np(H, W, attrs):
    sizes = [float(s) for s in attrs["anchor_sizes"]]
    ratios = [float(r) for r in attrs["aspect_ratios"]]
    sw, sh = [float(s) for s in attrs["stride"]]
    offset = attrs.get("offset", 0.5)
    base = []
    for r in ratios:
        for s in sizes:
            area = sw * sh
            area_ratio = area / r
            bw = np.sqrt(area_ratio)
            bh = bw * r
            sc_w = s / sw * bw / 2.0
            sc_h = s / sh * bh / 2.0
            base.append([-sc_w, -sc_h, sc_w, sc_h])
    base = np.asarray(base, np.float32)
    cx = (np.arange(W, dtype=np.float32) + offset) * sw
    cy = (np.arange(H, dtype=np.float32) + offset) * sh
    cxg, cyg = np.meshgrid(cx, cy)
    shift = np.stack([cxg, cyg, cxg, cyg], -1)[..., None, :]
    anchors = shift + base[None, None]
    var = np.broadcast_to(np.asarray(attrs["variances"], np.float32),
                          anchors.shape).copy()
    return anchors.astype(np.float32), var


@register_op("anchor_generator", no_grad=True,
             attr_defaults={"anchor_sizes": [64.0, 128.0, 256.0, 512.0],
                            "aspect_ratios": [0.5, 1.0, 2.0],
                            "variances": [0.1, 0.1, 0.2, 0.2],
                            "stride": [16.0, 16.0], "offset": 0.5})
def _anchor_generator(ins, attrs):
    """RPN anchors [H, W, A, 4], ratio-major, of each feature-map cell."""
    feat = first(ins, "Input")
    H, W = feat.shape[2], feat.shape[3]
    anchors, var = _generated("anchor_generator", (H, W), attrs,
                              feat.device, lambda: _anchor_np(H, W, attrs))
    return out(Anchors=anchors, Variances=var)


# --------------------------------------------------------------------------
# box_coder / box_clip (pure)
# --------------------------------------------------------------------------
@register_op("box_coder", diff_inputs=["TargetBox"],
             attr_defaults={"code_type": "encode_center_size",
                            "box_normalized": True, "axis": 0,
                            "variance": []})
def _box_coder(ins, attrs):
    """Encode TargetBox [N, 4] against PriorBox [M, 4] into [N, M, 4], or
    decode [N, M, 4] deltas (``axis`` picks the prior's broadcast dim)."""
    prior = first(ins, "PriorBox")
    pvar = first(ins, "PriorBoxVar")
    target = first(ins, "TargetBox")
    code_type = attrs.get("code_type", "encode_center_size")
    norm = attrs.get("box_normalized", True)
    axis = int(attrs.get("axis", 0))
    avar = attrs.get("variance") or []
    off = 0.0 if norm else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if code_type.lower() == "encode_center_size":
        tw = (target[:, 2] - target[:, 0] + off)[:, None]
        th = (target[:, 3] - target[:, 1] + off)[:, None]
        tcx = (target[:, 0:1] + target[:, 2:3]) * 0.5 + (0 if norm else 0.5)
        tcy = (target[:, 1:2] + target[:, 3:4]) * 0.5 + (0 if norm else 0.5)
        ex = (tcx - pcx[None, :]) / pw[None, :]
        ey = (tcy - pcy[None, :]) / ph[None, :]
        ew = torch.log(torch.abs(tw / pw[None, :]))
        eh = torch.log(torch.abs(th / ph[None, :]))
        o = torch.stack([ex, ey, ew, eh], -1)
        if pvar is not None:
            o = o / pvar[None, :, :]
        elif avar:
            o = torch.stack([o[..., k] / float(avar[k]) for k in range(4)],
                            -1)
        return out(OutputBox=o)
    if target.dim() == 2:
        target = target[:, None, :]
    if axis == 0:
        pw_, ph_, pcx_, pcy_ = (pw[None, :, None], ph[None, :, None],
                                pcx[None, :, None], pcy[None, :, None])
        pvar_b = pvar[None, :, :] if pvar is not None else None
    else:
        pw_, ph_, pcx_, pcy_ = (pw[:, None, None], ph[:, None, None],
                                pcx[:, None, None], pcy[:, None, None])
        pvar_b = pvar[:, None, :] if pvar is not None else None
    t = target
    if pvar_b is not None:
        t = t * pvar_b
    elif avar:
        t = torch.stack([t[..., k] * float(avar[k]) for k in range(4)], -1)
    dcx = t[..., 0:1] * pw_ + pcx_
    dcy = t[..., 1:2] * ph_ + pcy_
    dw = torch.exp(t[..., 2:3]) * pw_
    dh = torch.exp(t[..., 3:4]) * ph_
    o = torch.cat([dcx - dw * 0.5, dcy - dh * 0.5,
                   dcx + dw * 0.5 - off, dcy + dh * 0.5 - off], -1)
    if o.shape[1] == 1 and target.shape[1] == 1:
        o = o[:, 0, :]
    return out(OutputBox=o)


@register_op("box_clip", needs_lod=True, diff_inputs=["Input"])
def _box_clip(ins, attrs):
    """Boxes clipped to [0, w / scale − 1] × [0, h / scale − 1] of their
    image's ImInfo row (h, w, scale); LoD [T, 4] boxes take their row by
    their sequence, [N, B, 4] by their batch index."""
    boxes = first(ins, "Input")
    im_info = first(ins, "ImInfo")
    lods = (attrs.get("_lod") or {}).get("Input")
    if lods and lods[0]:
        offs = np.asarray(lods[0][-1], np.int64)
        segs = _const(attrs, "box_clip_segs", lambda: np.repeat(
            np.arange(len(offs) - 1), offs[1:] - offs[:-1]), boxes.device,
            torch.int64)
        rows = im_info.index_select(0, segs)
        h = (rows[:, 0] / rows[:, 2])[:, None] - 1
        w = (rows[:, 1] / rows[:, 2])[:, None] - 1
    else:
        h = (im_info[:, 0] / im_info[:, 2] - 1).reshape(-1, 1, 1)
        w = (im_info[:, 1] / im_info[:, 2] - 1).reshape(-1, 1, 1)
    x1 = torch.clamp(boxes[..., 0::2], min=0)
    y1 = torch.clamp(boxes[..., 1::2], min=0)
    x1 = torch.minimum(x1, w[..., None] if x1.dim() > w.dim() else w)
    y1 = torch.minimum(y1, h[..., None] if y1.dim() > h.dim() else h)
    o = torch.stack([x1[..., 0], y1[..., 0], x1[..., 1], y1[..., 1]], -1)
    return {"Output": [o]}


# --------------------------------------------------------------------------
# matching / assignment (host)
# --------------------------------------------------------------------------
@register_op("bipartite_match", stateful=True, no_grad=True, needs_lod=True,
             attr_defaults={"match_type": "bipartite",
                            "dist_threshold": 0.5})
def _bipartite_match(ins, attrs):
    """Greedy bipartite matching of DistMat's rows (LoD: an image's
    ground truths) to its columns (priors): the global maximum first,
    its row and column then out, while it is positive; with
    ``per_prediction`` each column still unmatched then takes its best
    row at ``dist_threshold`` or above. Sequential over the rows,
    vectorised over the columns."""
    dist_t = first(ins, "DistMat")
    dist = _host(dist_t)
    offs = _lod_offs(attrs, "DistMat", dist.shape[0])
    M = dist.shape[1]
    n_img = len(offs) - 1
    match_idx = np.full((n_img, M), -1, np.int32)
    match_dist = np.zeros((n_img, M), np.float32)
    per_pred = attrs.get("match_type") == "per_prediction"
    thr = float(attrs.get("dist_threshold", 0.5))
    for i in range(n_img):
        sub = dist[offs[i]:offs[i + 1]]
        rows = sub.shape[0]
        masked = sub.copy()
        for _ in range(min(rows, M)):
            r, c = divmod(int(np.argmax(masked)), M)
            if sub[r, c] <= 0:
                break
            match_idx[i, c] = r
            match_dist[i, c] = sub[r, c]
            masked[r, :] = -np.inf
            masked[:, c] = -np.inf
        if per_pred:
            cols = np.flatnonzero(match_idx[i] == -1)
            best = np.argmax(sub[:, cols], axis=0)
            d = sub[best, cols]
            hit = d >= thr
            match_idx[i, cols[hit]] = best[hit]
            match_dist[i, cols[hit]] = d[hit]
    dev = dist_t.device
    return out(ColToRowMatchIndices=_dev(match_idx, dev),
               ColToRowMatchDist=_dev(match_dist, dev))


@register_op("target_assign", stateful=True, no_grad=True, needs_lod=True,
             attr_defaults={"mismatch_value": 0})
def _target_assign(ins, attrs):
    """Each prior's target: X's row (LoD: an image's rows) at its match
    index, or for X [T, M, K] (per-prior encodings) that row's entry of
    the prior; ``mismatch_value`` and weight 0 where unmatched."""
    x_t = first(ins, "X")
    x = _host(x_t)
    mi = _host(first(ins, "MatchIndices"))
    offs = _lod_offs(attrs, "X", x.shape[0])
    mismatch = attrs.get("mismatch_value", 0)
    N, M = mi.shape
    K = x.shape[-1] if x.ndim > 1 else 1
    o = np.full((N, M, K), mismatch, x.dtype)
    w = np.zeros((N, M, 1), np.float32)
    flat = x.reshape(-1, K) if x.ndim != 3 else None
    for i in range(N):
        cols = np.flatnonzero(mi[i] >= 0)
        rows = offs[i] + mi[i, cols].astype(np.int64)
        o[i, cols] = x[rows, cols] if x.ndim == 3 else flat[rows]
        w[i, cols] = 1.0
    dev = x_t.device
    return out(Out=_dev(o, dev), OutWeight=_dev(w, dev))


# --------------------------------------------------------------------------
# NMS family (host)
# --------------------------------------------------------------------------
def _iou_xyxy(a, b, norm=True):
    """The TPU package's scalar IoU of two boxes (the locality merge's)."""
    off = 0.0 if norm else 1.0
    ix1 = np.maximum(a[0], b[0])
    iy1 = np.maximum(a[1], b[1])
    ix2 = np.minimum(a[2], b[2])
    iy2 = np.minimum(a[3], b[3])
    iw = np.maximum(ix2 - ix1 + off, 0)
    ih = np.maximum(iy2 - iy1 + off, 0)
    inter = iw * ih
    ua = ((a[2] - a[0] + off) * (a[3] - a[1] + off)
          + (b[2] - b[0] + off) * (b[3] - b[1] + off) - inter)
    return inter / ua if ua > 0 else 0.0


def _iou_rows(a, b, norm=True):
    """``_iou_xyxy(a[i], b[j])`` for every pair: the same numpy ops in the
    same order and dtype (in place where a temporary is not read again),
    one IoU matrix [len(a), len(b)], 0 where the union is not
    positive."""
    off = 0.0 if norm else 1.0
    iw = np.minimum(a[:, None, 2], b[None, :, 2])
    iw -= np.maximum(a[:, None, 0], b[None, :, 0])
    iw += off
    np.maximum(iw, 0, out=iw)
    ih = np.minimum(a[:, None, 3], b[None, :, 3])
    ih -= np.maximum(a[:, None, 1], b[None, :, 1])
    ih += off
    np.maximum(ih, 0, out=ih)
    iw *= ih                                              # the intersection
    ua = np.add(((a[:, 2] - a[:, 0] + off) * (a[:, 3] - a[:, 1] + off))[
        :, None], ((b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off))[
        None, :], out=ih)
    ua -= iw
    iou = np.zeros(iw.shape, iw.dtype)
    np.divide(iw, ua, out=iou, where=ua > 0)
    return iou


def _nms(boxes, scores, thresh, top_k, norm=True, eta=1.0):
    """Greedy NMS: the indices kept, best score first. The order is
    ``np.argsort(-scores)`` (numpy's own order of ties), cut to
    ``top_k``; the IoU of the whole cut is computed at once
    (``_iou_rows``) and scanned greedily, a box kept unless its IoU with
    a kept one exceeds the threshold, which ``eta`` < 1 lowers after
    each kept box while it is above 0.5."""
    order = np.argsort(-scores)
    if top_k > 0:
        order = order[:top_k]
    if not len(order):
        return []
    b = np.asarray(boxes)[order]
    iou = _iou_rows(b, b, norm)
    if eta < 1.0 and thresh > 0.5:
        alive = np.ones(len(order), bool)
        keep = []
        adaptive = thresh
        for p in range(len(order)):
            if not alive[p]:
                continue
            keep.append(int(order[p]))
            alive[p + 1:] &= iou[p, p + 1:] <= adaptive
            if adaptive > 0.5:
                adaptive *= eta
        return keep
    # a fixed threshold: each row's suppressions as the bits of an int
    # (IoU has no NaN: an IoU not <= thresh is > thresh)
    rows = np.packbits(iou > thresh, axis=1, bitorder="little")
    gone, keep = 0, []
    for p, row in enumerate(rows):
        if not gone >> p & 1:
            keep.append(int(order[p]))
            gone |= int.from_bytes(row.tobytes(), "little")
    return keep


def _empty_nms(N, dev):
    """The reference's empty result: one row [-1], the first image's."""
    offs = np.concatenate([[0], np.cumsum([1] + [0] * (N - 1))])
    return {"Out": [_dev(np.full((1, 1), -1.0, np.float32), dev)],
            "_lod": {"Out": [(tuple(int(v) for v in offs),)]}}


@register_op("multiclass_nms", stateful=True, no_grad=True, needs_lod=True,
             attr_defaults={"score_threshold": 0.05, "nms_top_k": 400,
                            "keep_top_k": 200, "nms_threshold": 0.3,
                            "nms_eta": 1.0, "background_label": 0,
                            "normalized": True})
def _multiclass_nms(ins, attrs):
    """Per-class NMS over the boxes above ``score_threshold``, then the
    ``keep_top_k`` best over the classes (a stable sort by score). BBoxes
    [N, M, 4], Scores [N, C, M]; Out LoD [T, 6] rows [label, score, x1,
    y1, x2, y2], or one row [-1] when nothing is kept."""
    b_t = first(ins, "BBoxes")
    bboxes = _host(b_t)
    scores = _host(first(ins, "Scores"))
    st = float(attrs["score_threshold"])
    nt = float(attrs["nms_threshold"])
    ntk = int(attrs["nms_top_k"])
    ktk = int(attrs["keep_top_k"])
    bg = int(attrs.get("background_label", 0))
    norm = bool(attrs.get("normalized", True))
    eta = float(attrs.get("nms_eta", 1.0))
    N, C, M = scores.shape
    parts, lens = [], []
    for n in range(N):
        labs, scs, rows = [], [], []
        for c in range(C):
            if c == bg:
                continue
            idx = np.where(scores[n, c] > st)[0]
            if not len(idx):
                continue
            keep = idx[np.asarray(_nms(bboxes[n][idx], scores[n, c][idx],
                                       nt, ntk, norm, eta), np.int64)]
            labs.append(np.full(len(keep), c, np.float64))
            scs.append(scores[n, c, keep].astype(np.float64))
            rows.append(bboxes[n, keep].astype(np.float64))
        if labs:
            s = np.concatenate(scs)
            dets = np.concatenate([np.concatenate(labs)[:, None], s[:, None],
                                   np.concatenate(rows)], 1)
            dets = dets[np.argsort(-s, kind="stable")]
            if ktk > 0:
                dets = dets[:ktk]
        else:
            dets = np.zeros((0, 6))
        parts.append(dets)
        lens.append(len(dets))
    dev = b_t.device
    if not sum(lens):
        return _empty_nms(N, dev)
    o = np.concatenate(parts).astype(np.float32)
    return {"Out": [_dev(o, dev)], "_lod": {"Out": [_lod0(lens)]}}


register_op("multiclass_nms2", stateful=True, no_grad=True, needs_lod=True,
            attr_defaults={"score_threshold": 0.05, "nms_top_k": 400,
                           "keep_top_k": 200, "nms_threshold": 0.3,
                           "nms_eta": 1.0, "background_label": 0,
                           "normalized": True})(_multiclass_nms)


# --------------------------------------------------------------------------
# YOLO (pure decode and loss)
# --------------------------------------------------------------------------
@register_op("yolo_box", no_grad=True,
             attr_defaults={"anchors": [], "class_num": 1,
                            "conf_thresh": 0.01, "downsample_ratio": 32,
                            "clip_bbox": True})
def _yolo_box(ins, attrs):
    """A YOLOv3 head [N, A·(5+C), H, W] decoded to boxes [N, A·H·W, 4]
    in the image's pixels (ImgSize rows h, w) and scores [N, A·H·W, C],
    objectness below ``conf_thresh`` zeroed."""
    x = first(ins, "X")
    img_size = first(ins, "ImgSize")
    anchors = [int(a) for a in attrs["anchors"]]
    A = len(anchors) // 2
    C = int(attrs["class_num"])
    ds = int(attrs["downsample_ratio"])
    conf = float(attrs["conf_thresh"])
    N, _, H, W = x.shape
    x = x.reshape(N, A, 5 + C, H, W)
    dt, dev = x.dtype, x.device
    gx = torch.arange(W, dtype=dt, device=dev)[None, None, None, :]
    gy = torch.arange(H, dtype=dt, device=dev)[None, None, :, None]
    aw = torch.stack([torch.full((), float(a), dtype=dt, device=dev)
                      for a in anchors[0::2]])[None, :, None, None]
    ah = torch.stack([torch.full((), float(a), dtype=dt, device=dev)
                      for a in anchors[1::2]])[None, :, None, None]
    cx = (torch.sigmoid(x[:, :, 0]) + gx) / W
    cy = (torch.sigmoid(x[:, :, 1]) + gy) / H
    bw = torch.exp(x[:, :, 2]) * aw / (ds * W)
    bh = torch.exp(x[:, :, 3]) * ah / (ds * H)
    obj = torch.sigmoid(x[:, :, 4])
    cls = torch.sigmoid(x[:, :, 5:])
    obj = torch.where(obj < conf, torch.zeros((), dtype=dt, device=dev), obj)
    imh = img_size[:, 0].to(dt)[:, None, None, None]
    imw = img_size[:, 1].to(dt)[:, None, None, None]
    x1 = (cx - bw / 2) * imw
    y1 = (cy - bh / 2) * imh
    x2 = (cx + bw / 2) * imw
    y2 = (cy + bh / 2) * imh
    if attrs.get("clip_bbox", True):
        zero = torch.zeros((), dtype=dt, device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], -1).reshape(N, A * H * W, 4)
    scores = (obj[..., None] * torch.movedim(cls, 2, -1)).reshape(
        N, A * H * W, C)
    return out(Boxes=boxes, Scores=scores)


def _bce_logit(p, t):
    """The TPU kernel's BCE on a logit: sigmoid, clipped to [1e-7,
    1 − 1e-7], then −(t·log p + (1 − t)·log(1 − p))."""
    p = torch.clamp(torch.sigmoid(p), 1e-7, 1 - 1e-7)
    return -(t * torch.log(p) + (1 - t) * torch.log(1 - p))


@register_op("yolov3_loss", diff_inputs=["X"],
             attr_defaults={"anchors": [], "anchor_mask": [], "class_num": 1,
                            "ignore_thresh": 0.7, "downsample_ratio": 32,
                            "use_label_smooth": True})
def _yolov3_loss(ins, attrs):
    """YOLOv3's loss a image, vectorised over the B ground-truth boxes:
    each valid box (w, h > 0; GTBox rows cx, cy, w, h relative) picks the
    anchor of best wh-IoU over all anchors (a tie to the lower index),
    and where that anchor is in this head's mask its cell's coordinate
    BCEs and L1s (× 2 − w·h) and class BCEs are added; the objectness
    target is 1 at those cells (a scatter-max, order-free) and its BCE
    is summed over every cell. As the TPU kernel, ``ignore_thresh``,
    ``use_label_smooth`` and GTScore are not read."""
    x = first(ins, "X")
    gt_box = first(ins, "GTBox")
    gt_label = first(ins, "GTLabel")
    anchors = [float(a) for a in attrs["anchors"]]
    mask = [int(m) for m in attrs["anchor_mask"]]
    C = int(attrs["class_num"])
    ds = int(attrs["downsample_ratio"])
    N, _, H, W = x.shape
    A = len(mask)
    B = gt_box.shape[1]
    dt, dev = x.dtype, x.device
    x5 = x.reshape(N, A, 5 + C, H, W)
    input_size = ds * H
    gx, gy = gt_box[:, :, 0] * W, gt_box[:, :, 1] * H      # [N, B]
    gw, gh = gt_box[:, :, 2], gt_box[:, :, 3]
    valid = (gw > 0) & (gh > 0)
    gi = torch.clamp(gx.to(torch.int32), 0, W - 1).long()
    gj = torch.clamp(gy.to(torch.int32), 0, H - 1).long()
    gw_pix, gh_pix = gw * input_size, gh * input_size
    best_iou = None
    best_a = torch.zeros((N, B), dtype=torch.int64, device=dev)
    for ai in range(len(anchors) // 2):
        aw, ah = anchors[2 * ai], anchors[2 * ai + 1]
        inter = torch.clamp(gw_pix, max=aw) * torch.clamp(gh_pix, max=ah)
        iou = inter / (gw_pix * gh_pix + aw * ah - inter + 1e-9)
        if best_iou is None:
            best_iou = iou
        else:
            best_a = torch.where(iou > best_iou,
                                 torch.full((), ai, dtype=torch.int64,
                                            device=dev), best_a)
            best_iou = torch.maximum(iou, best_iou)
    scale = 2.0 - gw * gh
    tx = gx - torch.floor(gx)
    ty = gy - torch.floor(gy)
    # the prediction rows of every (box, masked anchor): [N, B, A, 5 + C]
    rows = x5.permute(0, 1, 3, 4, 2).reshape(N * A * H * W, 5 + C)
    nb = torch.arange(N, device=dev)[:, None, None]
    mi = torch.arange(A, device=dev)[None, None, :]
    cell = ((nb * A + mi) * H + gj[..., None]) * W + gi[..., None]
    pred = take_rows(rows, cell)
    aw_m = torch.stack([torch.full((), anchors[2 * a], dtype=dt, device=dev)
                        for a in mask])
    ah_m = torch.stack([torch.full((), anchors[2 * a + 1], dtype=dt,
                                   device=dev) for a in mask])
    tw = torch.log(gw_pix[..., None] / aw_m + 1e-9)
    th = torch.log(gh_pix[..., None] / ah_m + 1e-9)
    coord = (_bce_logit(pred[..., 0], tx[..., None])
             + _bce_logit(pred[..., 1], ty[..., None])
             + scale[..., None] * (torch.abs(pred[..., 2] - tw)
                                   + torch.abs(pred[..., 3] - th)))
    tcls = (gt_label.long()[..., None]
            == torch.arange(C, device=dev)).to(dt)    # 0s out of range
    cls_loss = _bce_logit(pred[..., 5:], tcls[:, :, None, :]).sum(-1)
    mask_ids = torch.stack([torch.full((), a, dtype=torch.int64, device=dev)
                            for a in mask])
    sel = valid[..., None] & (best_a[..., None] == mask_ids)    # [N, B, A]
    term = torch.where(sel, scale[..., None] * coord + cls_loss,
                       torch.zeros((), dtype=dt, device=dev))
    total = term.sum((1, 2))
    obj_target = torch.zeros(N * A * H * W, dtype=dt, device=dev)
    obj_target = obj_target.scatter_reduce(
        0, cell.reshape(-1), sel.reshape(-1).to(dt), reduce="amax")
    obj_loss = _bce_logit(x5[:, :, 4], obj_target.reshape(N, A, H, W))
    return out(Loss=total + obj_loss.sum((1, 2, 3)))


# --------------------------------------------------------------------------
# RoI ops
# --------------------------------------------------------------------------
@register_op("roi_align", needs_lod=True, diff_inputs=["X"],
             attr_defaults={"pooled_height": 1, "pooled_width": 1,
                            "spatial_scale": 1.0, "sampling_ratio": -1})
def _roi_align(ins, attrs):
    """RoIAlign: each bin the mean of s × s bilinear samples (s =
    ``sampling_ratio``, 2 when it is ≤ 0, as the TPU kernel), all RoIs'
    samples gathered at once as rows of X laid out [N·H·W, C]
    (``take_rows``: the grad into X adds in a fixed order)."""
    x = first(ins, "X")
    rois = first(ins, "ROIs")
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs["spatial_scale"])
    sratio = int(attrs.get("sampling_ratio", -1))
    s = sratio if sratio > 0 else 2
    N, C, H, W = x.shape
    R = rois.shape[0]
    dt, dev = x.dtype, x.device
    if R == 0:
        return {"Out": [x.new_zeros((0, C, ph, pw))]}
    bidx = roi_batch_ids(attrs, "ROIs", R, dev)
    r = rois * scale
    x1, y1, x2, y2 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    one = torch.ones((), dtype=dt, device=dev)
    bin_w = torch.maximum(x2 - x1, one) / pw
    bin_h = torch.maximum(y2 - y1, one) / ph
    frac = (torch.arange(s, dtype=dt, device=dev) + 0.5) / s
    py = y1[:, None, None] + (torch.arange(ph, dtype=dt, device=dev)[
        None, :, None] + frac[None, None, :]) * bin_h[:, None, None]
    px = x1[:, None, None] + (torch.arange(pw, dtype=dt, device=dev)[
        None, :, None] + frac[None, None, :]) * bin_w[:, None, None]
    # [R, ph, s] rows and [R, pw, s] columns of the samples
    y0 = torch.clamp(torch.floor(py), 0, H - 1)
    x0 = torch.clamp(torch.floor(px), 0, W - 1)
    y1_ = torch.clamp(y0 + 1, 0, H - 1)
    x1_ = torch.clamp(x0 + 1, 0, W - 1)
    ly = torch.clamp(py - y0, 0, 1)
    lx = torch.clamp(px - x0, 0, 1)
    flat = x.permute(0, 2, 3, 1).reshape(N * H * W, C)
    base = bidx[:, None, None, None, None] * (H * W)

    def at(yy, xx):
        # [R, ph, s, pw, s, C]
        idx = base + yy.long()[:, :, :, None, None] * W \
            + xx.long()[:, None, None, :, :]
        return take_rows(flat, idx)
    wy = ly[:, :, :, None, None, None]
    wx = lx[:, None, None, :, :, None]
    v = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1_) * (1 - wy) * wx
         + at(y1_, x0) * wy * (1 - wx) + at(y1_, x1_) * wy * wx)
    acc = None
    for i in range(s):
        for j in range(s):
            t = v[:, :, i, :, j]
            acc = t if acc is None else acc + t
    o = (acc / (s * s)).permute(0, 3, 1, 2)
    return {"Out": [o]}


@register_op("roi_pool", stateful=True, needs_lod=True, diff_inputs=["X"],
             attr_defaults={"pooled_height": 1, "pooled_width": 1,
                            "spatial_scale": 1.0})
def _roi_pool(ins, attrs):
    """Max RoI pooling on the host, the TPU kernel's loops: each bin's
    maximum and its Argmax (the first maximum's offset in the bin's
    patch). As in the TPU package, the op has no grad kernel."""
    x_t = first(ins, "X")
    x = _host(x_t)
    rois = _host(first(ins, "ROIs"))
    offs = _lod_offs(attrs, "ROIs", rois.shape[0])
    batch_of = np.repeat(np.arange(len(offs) - 1), offs[1:] - offs[:-1])
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    scale = float(attrs["spatial_scale"])
    N, C, H, W = x.shape
    R = rois.shape[0]
    o = np.zeros((R, C, ph, pw), x.dtype)
    argmax = np.zeros((R, C, ph, pw), np.int64)
    for r in range(R):
        b = batch_of[r]
        x1, y1, x2, y2 = np.round(rois[r] * scale).astype(np.int64)
        rh = max(y2 - y1 + 1, 1)
        rw = max(x2 - x1 + 1, 1)
        for i in range(ph):
            hs = y1 + (i * rh) // ph
            he = y1 + ((i + 1) * rh + ph - 1) // ph
            hs, he = np.clip([hs, he], 0, H)
            for j in range(pw):
                ws = x1 + (j * rw) // pw
                we = x1 + ((j + 1) * rw + pw - 1) // pw
                ws, we = np.clip([ws, we], 0, W)
                if he > hs and we > ws:
                    patch = x[b, :, hs:he, ws:we].reshape(C, -1)
                    o[r, :, i, j] = patch.max(-1)
                    argmax[r, :, i, j] = patch.argmax(-1)
    dev = x_t.device
    return out(Out=_dev(o, dev), Argmax=_dev(argmax.astype(np.int32), dev))


# --------------------------------------------------------------------------
# proposal generation (host)
# --------------------------------------------------------------------------
@register_op("generate_proposals", stateful=True, no_grad=True,
             attr_defaults={"pre_nms_topN": 6000, "post_nms_topN": 1000,
                            "nms_thresh": 0.5, "min_size": 0.1, "eta": 1.0})
def _generate_proposals(ins, attrs):
    """RPN proposals an image: the ``pre_nms_topN`` best anchors' deltas
    decoded, clipped to the image, those under ``min_size`` dropped,
    then NMS, whose top-k is ``post_nms_topN`` (as in the TPU kernel,
    which also does not read ``eta``)."""
    s_t = first(ins, "Scores")
    scores = _host(s_t)
    deltas = _host(first(ins, "BboxDeltas"))
    im_info = _host(first(ins, "ImInfo"))
    anchors = _host(first(ins, "Anchors")).reshape(-1, 4)
    variances = _host(first(ins, "Variances")).reshape(-1, 4)
    pre_n = int(attrs["pre_nms_topN"])
    post_n = int(attrs["post_nms_topN"])
    nt = float(attrs["nms_thresh"])
    min_size = float(attrs["min_size"])
    N = scores.shape[0]
    all_rois, all_scores, lens = [], [], []
    for n in range(N):
        sc = scores[n].transpose(1, 2, 0).reshape(-1)
        dl = deltas[n].reshape(-1, 4, *deltas.shape[2:]) \
            .transpose(2, 3, 0, 1).reshape(-1, 4)
        order = np.argsort(-sc)[:pre_n]
        sc, dl = sc[order], dl[order]
        an, va = anchors[order], variances[order]
        aw = an[:, 2] - an[:, 0] + 1
        ah = an[:, 3] - an[:, 1] + 1
        acx = an[:, 0] + aw / 2
        acy = an[:, 1] + ah / 2
        cx = va[:, 0] * dl[:, 0] * aw + acx
        cy = va[:, 1] * dl[:, 1] * ah + acy
        w = np.exp(np.minimum(va[:, 2] * dl[:, 2], 10.0)) * aw
        h = np.exp(np.minimum(va[:, 3] * dl[:, 3], 10.0)) * ah
        boxes = np.stack([cx - w / 2, cy - h / 2,
                          cx + w / 2 - 1, cy + h / 2 - 1], 1)
        ih, iw = im_info[n, 0], im_info[n, 1]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, iw - 1)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ih - 1)
        ms = min_size * im_info[n, 2]
        keep = np.where((boxes[:, 2] - boxes[:, 0] + 1 >= ms)
                        & (boxes[:, 3] - boxes[:, 1] + 1 >= ms))[0]
        boxes, sc = boxes[keep], sc[keep]
        keep = np.asarray(_nms(boxes, sc, nt, post_n, norm=False), np.int64)
        boxes, sc = boxes[keep], sc[keep]
        all_rois.append(boxes)
        all_scores.append(sc)
        lens.append(len(boxes))
    rois = (np.concatenate(all_rois) if all_rois
            else np.zeros((0, 4), np.float32))
    scs = (np.concatenate(all_scores) if all_scores
           else np.zeros((0,), np.float32))
    lod = _lod0(lens)
    dev = s_t.device
    return {"RpnRois": [_dev(rois.astype(np.float32), dev)],
            "RpnRoiProbs": [_dev(scs.astype(np.float32).reshape(-1, 1),
                                 dev)],
            "RpnRoisNum": [_dev(np.asarray(lens, np.int32), dev)],
            "_lod": {"RpnRois": [lod], "RpnRoiProbs": [lod]}}


@register_op("distribute_fpn_proposals", stateful=True, no_grad=True,
             needs_lod=True,
             attr_defaults={"min_level": 2, "max_level": 5,
                            "refer_level": 4, "refer_scale": 224})
def _distribute_fpn_proposals(ins, attrs):
    """Each RoI to the FPN level floor(log2(√(wh) / refer_scale) +
    refer_level), clipped to [min_level, max_level]; RestoreIndex gives
    each RoI's row in the levels' concatenation."""
    r_t = first(ins, "FpnRois")
    rois = _host(r_t)
    offs = _lod_offs(attrs, "FpnRois", rois.shape[0])
    lo, hi = int(attrs["min_level"]), int(attrs["max_level"])
    rl, rs = int(attrs["refer_level"]), int(attrs["refer_scale"])
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    scale = np.sqrt(np.maximum(w * h, 1e-6))
    lvl = np.floor(np.log2(scale / rs + 1e-6) + rl).astype(np.int64)
    lvl = np.clip(lvl, lo, hi)
    dev = r_t.device
    outs, out_lods, restore = [], [], np.zeros(len(rois), np.int64)
    pos = 0
    for L in range(lo, hi + 1):
        idx = np.where(lvl == L)[0]
        outs.append(_dev(rois[idx], dev))
        out_lods.append(_lod0([int((lvl[offs[i]:offs[i + 1]] == L).sum())
                               for i in range(len(offs) - 1)]))
        restore[idx] = np.arange(pos, pos + len(idx))
        pos += len(idx)
    return {"MultiFpnRois": outs,
            "RestoreIndex": [_dev(restore.astype(np.int32).reshape(-1, 1),
                                  dev)],
            "_lod": {"MultiFpnRois": out_lods}}


@register_op("collect_fpn_proposals", stateful=True, no_grad=True,
             needs_lod=True, attr_defaults={"post_nms_topN": 100})
def _collect_fpn_proposals(ins, attrs):
    """The levels' RoIs merged and the ``post_nms_topN`` best kept. As in
    the TPU kernel, the whole batch becomes one sequence: an FPN program
    is right at one image a batch."""
    roi_list = [_host(r) for r in seq(ins, "MultiLevelRois")]
    score_list = [_host(s).reshape(-1) for s in seq(ins, "MultiLevelScores")]
    rois = np.concatenate(roi_list) if roi_list else np.zeros((0, 4))
    scores = np.concatenate(score_list) if score_list else np.zeros((0,))
    topn = int(attrs["post_nms_topN"])
    order = np.argsort(-scores)[:topn]
    dev = seq(ins, "MultiLevelRois")[0].device
    return {"FpnRois": [_dev(rois[order].astype(np.float32), dev)],
            "_lod": {"FpnRois": [((0, len(order)),)]}}
