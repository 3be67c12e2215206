"""Detection training's long tail (counterpart of
paddle_tpu/ops/detection_train_ops.py: every op type it registers;
reference: paddle/fluid/operators/detection/ — rpn_target_assign_op.cc
with its retinanet variant, retinanet_detection_output_op.cc,
locality_aware_nms_op.cc, box_decoder_and_assign_op.cc,
generate_proposal_labels_op.cc, generate_mask_labels_op.cc,
mine_hard_examples_op.cc, roi_perspective_transform_op.cc).

All but box_decoder_and_assign are host ops (``stateful``) as in the TPU
package, whose numpy they are: their blocks run in the interpreter,
islands of a segmented step. The samplers draw from this module's own
stream, seeded 12345 as the TPU package's, or from RandomState(seed)
when the ``seed`` attr is non-zero; the two packages draw alike from the
same seed. Boxes are xyxy with the +1 pixel convention."""
from __future__ import annotations

import numpy as np
import torch

from .detection_ops import _dev, _host, _iou_xyxy, _lod0, _lod_offs, _nms
from .registry import register_op, first, seq

# the module's sampling stream: a RandomState(0) a call would draw the
# same foreground and background sample at every step
_SAMPLER = np.random.RandomState(12345)


def _rng_of(attrs):
    seed = int(attrs.get("seed", 0))
    return np.random.RandomState(seed) if seed else _SAMPLER


def _box_encode(gt, anchor, weights=(1.0, 1.0, 1.0, 1.0)):
    """encode_center_size deltas of ``gt`` against ``anchor`` ([n, 4])."""
    aw = anchor[:, 2] - anchor[:, 0] + 1.0
    ah = anchor[:, 3] - anchor[:, 1] + 1.0
    ax = anchor[:, 0] + aw * 0.5
    ay = anchor[:, 1] + ah * 0.5
    gw = gt[:, 2] - gt[:, 0] + 1.0
    gh = gt[:, 3] - gt[:, 1] + 1.0
    gx = gt[:, 0] + gw * 0.5
    gy = gt[:, 1] + gh * 0.5
    wx, wy, ww, wh = weights
    return np.stack([wx * (gx - ax) / aw, wy * (gy - ay) / ah,
                     ww * np.log(gw / aw), wh * np.log(gh / ah)], axis=1)


def _iou_matrix(a, b, norm=False):
    """[Na, 4] × [Nb, 4] → [Na, Nb] IoU, the union floored at 1e-10."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    off = 0.0 if norm else 1.0
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(ix2 - ix1 + off, 0) * np.maximum(iy2 - iy1 + off, 0)
    ar_a = (a[:, 2] - a[:, 0] + off) * (a[:, 3] - a[:, 1] + off)
    ar_b = (b[:, 2] - b[:, 0] + off) * (b[:, 3] - b[:, 1] + off)
    return inter / np.maximum(ar_a[:, None] + ar_b[None, :] - inter, 1e-10)


def _rpn_assign_one(anchors, gts, rng, pos_thr, neg_thr, fg_frac, batch,
                    use_random, retinanet=False, valid=None):
    """One image's anchor sample → (foreground, background, the
    foreground's ground truths): foreground at ``pos_thr`` and each
    ground truth's best anchor, background below ``neg_thr``; without
    ``retinanet`` at most ``batch · fg_frac`` foreground and ``batch`` in
    all, drawn from ``rng`` (``use_random``) or the first ones."""
    if valid is None:
        valid = np.ones(len(anchors), bool)
    iou = _iou_matrix(anchors, gts)
    if iou.size == 0:
        return (np.zeros(0, np.int64),
                np.where(valid)[0][:batch], np.zeros(0, np.int64))
    best_gt = iou.argmax(axis=1)
    best_iou = iou.max(axis=1)
    fg_mask = best_iou >= pos_thr
    fg_mask[iou.argmax(axis=0)] = True
    fg_mask &= valid
    bg_mask = (best_iou < neg_thr) & ~fg_mask & valid
    fg_idx = np.where(fg_mask)[0]
    bg_idx = np.where(bg_mask)[0]
    if retinanet:
        return fg_idx, bg_idx, best_gt[fg_idx]
    n_fg = int(batch * fg_frac)
    if len(fg_idx) > n_fg:
        fg_idx = (rng.permutation(fg_idx)[:n_fg] if use_random
                  else fg_idx[:n_fg])
    n_bg = batch - len(fg_idx)
    if len(bg_idx) > n_bg:
        bg_idx = (rng.permutation(bg_idx)[:n_bg] if use_random
                  else bg_idx[:n_bg])
    return fg_idx, bg_idx, best_gt[fg_idx]


def _rpn_like(ins, attrs, retinanet):
    a_t = first(ins, "Anchor")
    anchors = _host(a_t).reshape(-1, 4)
    gtb = _host(first(ins, "GtBoxes"))
    goffs = _lod_offs(attrs, "GtBoxes", len(gtb))
    glab = (_host(first(ins, "GtLabels")).reshape(-1)
            if retinanet else None)
    crowd_in = first(ins, "IsCrowd")
    crowd = (_host(crowd_in).reshape(-1).astype(bool)
             if crowd_in is not None else np.zeros(len(gtb), bool))
    im_info = first(ins, "ImInfo")
    rng = _rng_of(attrs)
    A = len(anchors)
    # anchors further than rpn_straddle_thresh outside the image are not
    # sampled (reference rpn_target_assign_op.cc)
    straddle = attrs.get("rpn_straddle_thresh", 0.0)
    if im_info is not None and straddle >= 0 and not retinanet:
        hi = _host(im_info)[0]
        h, w = float(hi[0]), float(hi[1])
        inside = ((anchors[:, 0] >= -straddle) & (anchors[:, 1] >= -straddle)
                  & (anchors[:, 2] < w + straddle)
                  & (anchors[:, 3] < h + straddle))
    else:
        inside = np.ones(A, bool)
    loc_idx, score_idx, tgt_lab, tgt_box, fg_counts = [], [], [], [], []
    lens_loc, lens_score = [], []
    for i in range(len(goffs) - 1):
        keep_gt = ~crowd[goffs[i]:goffs[i + 1]]
        gts = gtb[goffs[i]:goffs[i + 1]][keep_gt]
        labs = (glab[goffs[i]:goffs[i + 1]][keep_gt]
                if retinanet else None)
        fg, bg, gt_of = _rpn_assign_one(
            anchors, gts, rng,
            attrs.get("rpn_positive_overlap", 0.7),
            attrs.get("rpn_negative_overlap", 0.3),
            attrs.get("rpn_fg_fraction", 0.5),
            int(attrs.get("rpn_batch_size_per_im", 256)),
            attrs.get("use_random", True), retinanet=retinanet,
            valid=inside)
        base = i * A
        loc_idx.extend(base + fg)
        score_idx.extend(base + np.concatenate([fg, bg]))
        if retinanet:
            tgt_lab.extend([int(labs[g]) for g in gt_of] + [0] * len(bg))
        else:
            tgt_lab.extend([1] * len(fg) + [0] * len(bg))
        if len(fg):
            tgt_box.append(_box_encode(gts[gt_of], anchors[fg]))
        fg_counts.append(len(fg))
        lens_loc.append(len(fg))
        lens_score.append(len(fg) + len(bg))
    tb = (np.concatenate(tgt_box, axis=0) if tgt_box
          else np.zeros((0, 4), np.float32))
    dev = a_t.device
    res = {"LocationIndex": [_dev(np.asarray(loc_idx, np.int32), dev)],
           "ScoreIndex": [_dev(np.asarray(score_idx, np.int32), dev)],
           "TargetLabel": [_dev(np.asarray(tgt_lab, np.int32)[:, None],
                                dev)],
           "TargetBBox": [_dev(tb.astype(np.float32), dev)],
           "BBoxInsideWeight": [torch.ones((len(tb), 4),
                                           dtype=torch.float32,
                                           device=dev)],
           "_lod": {"LocationIndex": [_lod0(lens_loc)],
                    "ScoreIndex": [_lod0(lens_score)],
                    "TargetLabel": [_lod0(lens_score)],
                    "TargetBBox": [_lod0(lens_loc)]}}
    if retinanet:
        res["ForegroundNumber"] = [_dev(
            np.asarray(fg_counts, np.int32)[:, None], dev)]
    return res


@register_op("rpn_target_assign", stateful=True, no_grad=True,
             needs_lod=True,
             inputs=("Anchor", "GtBoxes", "IsCrowd", "ImInfo"),
             attr_defaults={"rpn_batch_size_per_im": 256,
                            "rpn_straddle_thresh": 0.0,
                            "rpn_fg_fraction": 0.5,
                            "rpn_positive_overlap": 0.7,
                            "rpn_negative_overlap": 0.3,
                            "use_random": True, "seed": 0})
def _rpn_target_assign(ins, attrs):
    """The RPN's anchor sample an image (GtBoxes' LoD), crowd boxes
    dropped: the sampled anchors' indices into the batch's anchors, their
    labels, and the foreground's encoded targets."""
    return _rpn_like(ins, attrs, retinanet=False)


@register_op("retinanet_target_assign", stateful=True, no_grad=True,
             needs_lod=True,
             inputs=("Anchor", "GtBoxes", "GtLabels", "IsCrowd", "ImInfo"),
             attr_defaults={"positive_overlap": 0.5,
                            "negative_overlap": 0.4, "seed": 0})
def _retinanet_target_assign(ins, attrs):
    """RetinaNet's anchor assignment: every foreground and background
    anchor kept, the foreground labelled by its ground truth's class."""
    a2 = dict(attrs)
    a2["rpn_positive_overlap"] = attrs.get("positive_overlap", 0.5)
    a2["rpn_negative_overlap"] = attrs.get("negative_overlap", 0.4)
    return _rpn_like(ins, a2, retinanet=True)


def _nms_rows(boxes, scores, labels, attrs, keep_top_k):
    """Per-label NMS of one image's candidates → rows [label, score, x1,
    y1, x2, y2], best score first (a stable sort), the first
    ``keep_top_k``."""
    rows = []
    for c in np.unique(labels):
        selc = labels == c
        keep = _nms(boxes[selc], scores[selc],
                    attrs.get("nms_threshold", 0.3),
                    attrs.get("nms_top_k", 1000), norm=False,
                    eta=attrs.get("nms_eta", 1.0))
        for b, s_ in zip(boxes[selc][keep], scores[selc][keep]):
            rows.append([float(c), float(s_), *map(float, b)])
    rows.sort(key=lambda r: -r[1])
    return rows[:keep_top_k]


@register_op("retinanet_detection_output", stateful=True, no_grad=True,
             needs_lod=True,
             inputs=("BBoxes", "Scores", "Anchors", "ImInfo"),
             attr_defaults={"score_threshold": 0.05, "nms_top_k": 1000,
                            "nms_threshold": 0.3, "keep_top_k": 100,
                            "nms_eta": 1.0})
def _retinanet_detection_output(ins, attrs):
    """Each FPN level's deltas decoded against its anchors, the scores
    above ``score_threshold`` of every class gathered over the levels,
    then per-class NMS (``_nms``) and the ``keep_top_k`` best an image
    (ImInfo's rows)."""
    bbox_levels = [_host(b) for b in seq(ins, "BBoxes")]
    score_levels = [_host(s) for s in seq(ins, "Scores")]
    anchor_levels = [_host(a).reshape(-1, 4) for a in seq(ins, "Anchors")]
    im_t = first(ins, "ImInfo")
    n_img = im_t.shape[0]
    thr = attrs.get("score_threshold", 0.05)
    out_rows, lens = [], []
    for i in range(n_img):
        boxes_all, scores_all, labels_all = [], [], []
        for bl, sl, al in zip(bbox_levels, score_levels, anchor_levels):
            deltas = bl[i] if bl.ndim == 3 else bl
            scores = sl[i] if sl.ndim == 3 else sl
            aw = al[:, 2] - al[:, 0] + 1.0
            ah = al[:, 3] - al[:, 1] + 1.0
            ax = al[:, 0] + aw / 2
            ay = al[:, 1] + ah / 2
            cx = deltas[:, 0] * aw + ax
            cy = deltas[:, 1] * ah + ay
            w = np.exp(np.clip(deltas[:, 2], -10, 10)) * aw
            h = np.exp(np.clip(deltas[:, 3], -10, 10)) * ah
            dec = np.stack([cx - w / 2, cy - h / 2,
                            cx + w / 2, cy + h / 2], axis=1)
            for c in range(scores.shape[1]):
                sel = np.where(scores[:, c] > thr)[0]
                boxes_all.append(dec[sel])
                scores_all.append(scores[sel, c])
                labels_all.append(np.full(len(sel), c, np.int64))
        boxes = np.concatenate(boxes_all) if boxes_all else np.zeros((0, 4))
        scores = np.concatenate(scores_all) if scores_all else np.zeros(0)
        labels = (np.concatenate(labels_all) if labels_all
                  else np.zeros(0, np.int64))
        rows = _nms_rows(boxes, scores, labels, attrs,
                         int(attrs.get("keep_top_k", 100)))
        out_rows.extend(rows)
        lens.append(len(rows))
    o = (np.asarray(out_rows, np.float32) if out_rows
         else np.zeros((0, 6), np.float32))
    return {"Out": [_dev(o, im_t.device)], "_lod": {"Out": [_lod0(lens)]}}


@register_op("locality_aware_nms", stateful=True, no_grad=True,
             needs_lod=True, inputs=("BBoxes", "Scores"),
             attr_defaults={"score_threshold": 0.0, "nms_top_k": -1,
                            "nms_threshold": 0.3, "keep_top_k": -1,
                            "background_label": -1, "normalized": False,
                            "nms_eta": 1.0})
def _locality_aware_nms(ins, attrs):
    """EAST's NMS: a pass that merges each box above the score threshold
    into the previous merged one where they overlap (their score-weighted
    mean, in float64), then ``_nms`` of the merged boxes a class."""
    b_t = first(ins, "BBoxes")
    boxes = _host(b_t)
    scores = _host(first(ins, "Scores"))
    if boxes.ndim == 3:
        boxes = boxes[0]
    if scores.ndim == 3:
        scores = scores[0]
    C = scores.shape[0] if scores.ndim == 2 else 1
    scores = scores.reshape(C, -1)
    thr = attrs.get("nms_threshold", 0.3)
    norm = attrs.get("normalized", False)
    rows = []
    for c in range(C):
        if c == attrs.get("background_label", -1):
            continue
        s = scores[c]
        sel = np.where(s > attrs.get("score_threshold", 0.0))[0]
        merged_boxes, merged_scores = [], []
        for i in sel:
            b, sc = boxes[i].astype(np.float64), float(s[i])
            if merged_boxes and _iou_xyxy(merged_boxes[-1], b, norm) > thr:
                pb, ps = merged_boxes[-1], merged_scores[-1]
                wsum = ps + sc
                merged_boxes[-1] = (pb * ps + b * sc) / wsum
                merged_scores[-1] = wsum
            else:
                merged_boxes.append(b)
                merged_scores.append(sc)
        if not merged_boxes:
            continue
        mb = np.asarray(merged_boxes)
        ms = np.asarray(merged_scores)
        keep = _nms(mb, ms, thr, attrs.get("nms_top_k", -1), norm,
                    attrs.get("nms_eta", 1.0))
        for k in keep:
            rows.append([float(c), float(ms[k]), *map(float, mb[k])])
    rows.sort(key=lambda r: -r[1])
    if attrs.get("keep_top_k", -1) > 0:
        rows = rows[:attrs["keep_top_k"]]
    o = (np.asarray(rows, np.float32) if rows
         else np.zeros((0, 6), np.float32))
    return {"Out": [_dev(o, b_t.device)],
            "_lod": {"Out": [((0, len(rows)),)]}}


@register_op("box_decoder_and_assign", no_grad=True,
             inputs=("PriorBox", "PriorBoxVar", "TargetBox", "BoxScore"),
             attr_defaults={"box_clip": 4.135})
def _box_decoder_and_assign(ins, attrs):
    """Each RoI's per-class deltas decoded against it (the log-sizes
    clipped at ``box_clip``) and its best class's box picked."""
    prior = first(ins, "PriorBox")
    pvar = first(ins, "PriorBoxVar")
    deltas = first(ins, "TargetBox")
    score = first(ins, "BoxScore")
    clip = attrs.get("box_clip", 4.135)
    R = prior.shape[0]
    C = score.shape[1]
    d = deltas.reshape(R, C, 4)
    if pvar is not None:
        pv = pvar.reshape(-1, 4) if pvar.dim() > 1 else pvar.reshape(1, 4)
        d = d * pv[:, None, :] if pv.shape[0] == R else d * pv[None, :, :]
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    px = prior[:, 0] + pw * 0.5
    py = prior[:, 1] + ph * 0.5
    cx = d[:, :, 0] * pw[:, None] + px[:, None]
    cy = d[:, :, 1] * ph[:, None] + py[:, None]
    w = torch.exp(torch.clamp(d[:, :, 2], max=clip)) * pw[:, None]
    h = torch.exp(torch.clamp(d[:, :, 3], max=clip)) * ph[:, None]
    dec = torch.stack([cx - w / 2, cy - h / 2,
                       cx + w / 2 - 1.0, cy + h / 2 - 1.0], dim=2)
    best = torch.argmax(score, dim=1)
    assigned = torch.gather(dec, 1, best[:, None, None].expand(R, 1, 4))
    return {"DecodeBox": [dec.reshape(R, C * 4)],
            "OutputAssignBox": [assigned[:, 0]]}


@register_op("mine_hard_examples", stateful=True, no_grad=True,
             needs_lod=True,
             inputs=("ClsLoss", "LocLoss", "MatchIndices", "MatchDist"),
             attr_defaults={"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
                            "mining_type": "max_negative", "sample_size": 0})
def _mine_hard_examples(ins, attrs):
    """SSD's hard negatives an image: the unmatched priors below
    ``neg_dist_threshold`` of highest loss, ``neg_pos_ratio`` × the
    positives of them (``sample_size`` in ``hard_example`` mode, which
    also unmatches every prior outside the positives and those)."""
    c_t = first(ins, "ClsLoss")
    cls_loss = _host(c_t)
    loc_loss = first(ins, "LocLoss")
    loss = cls_loss + (_host(loc_loss) if loc_loss is not None else 0.0)
    match = _host(first(ins, "MatchIndices"))
    dist = first(ins, "MatchDist")
    dist = _host(dist) if dist is not None else None
    ratio = attrs.get("neg_pos_ratio", 3.0)
    neg_thr = attrs.get("neg_dist_threshold", 0.5)
    N, P = match.shape
    hard_mode = attrs.get("mining_type", "max_negative") == "hard_example"
    neg_rows, neg_lens = [], []
    upd = match.copy()
    for i in range(N):
        pos = match[i] != -1
        n_neg = int(int(pos.sum()) * ratio)
        if hard_mode and attrs.get("sample_size", 0):
            n_neg = int(attrs["sample_size"])
        cand = np.where(~pos & ((dist[i] < neg_thr) if dist is not None
                                else np.ones(P, bool)))[0]
        cand = cand[np.argsort(-loss[i][cand])][:n_neg]
        neg_rows.extend(int(c) for c in sorted(cand))
        neg_lens.append(len(cand))
        if hard_mode:
            keep = pos.copy()
            keep[cand] = True
            upd[i][~keep] = -1
    neg = (np.asarray(neg_rows, np.int32)[:, None] if neg_rows
           else np.zeros((0, 1), np.int32))
    dev = c_t.device
    return {"NegIndices": [_dev(neg, dev)],
            "UpdatedMatchIndices": [_dev(upd, dev)],
            "_lod": {"NegIndices": [_lod0(neg_lens)]}}


@register_op("generate_proposal_labels", stateful=True, no_grad=True,
             needs_lod=True,
             inputs=("RpnRois", "GtClasses", "IsCrowd", "GtBoxes", "ImInfo"),
             attr_defaults={"batch_size_per_im": 256, "fg_fraction": 0.25,
                            "fg_thresh": 0.5, "bg_thresh_hi": 0.5,
                            "bg_thresh_lo": 0.0,
                            "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2],
                            "class_nums": 81, "use_random": True,
                            "is_cls_agnostic": False, "is_cascade_rcnn": False,
                            "seed": 0})
def _generate_proposal_labels(ins, attrs):
    """Fast R-CNN's RoI sample an image: the proposals and the ground
    truths (which join the pool) matched by IoU, foreground at
    ``fg_thresh``, background in [bg_thresh_lo, bg_thresh_hi), at most
    ``batch_size_per_im · fg_fraction`` foreground, drawn from the
    sampler (``use_random``) or the first ones; labels and each
    foreground RoI's encoded target in its class's four columns."""
    r_t = first(ins, "RpnRois")
    rois = _host(r_t)
    gcls = _host(first(ins, "GtClasses")).reshape(-1)
    gbox = _host(first(ins, "GtBoxes"))
    roffs = _lod_offs(attrs, "RpnRois", len(rois))
    goffs = _lod_offs(attrs, "GtBoxes", len(gbox))
    B = int(attrs.get("batch_size_per_im", 256))
    fgf = attrs.get("fg_fraction", 0.25)
    fgt = attrs.get("fg_thresh", 0.5)
    bgh = attrs.get("bg_thresh_hi", 0.5)
    bgl = attrs.get("bg_thresh_lo", 0.0)
    C = int(attrs.get("class_nums", 81))
    wts = attrs.get("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2])
    rng = _rng_of(attrs)
    use_rand = attrs.get("use_random", True)
    crowd_in = first(ins, "IsCrowd")
    crowd = (_host(crowd_in).reshape(-1).astype(bool)
             if crowd_in is not None else np.zeros(len(gbox), bool))
    o_rois, o_lab, o_tgt, o_inw, lens = [], [], [], [], []
    for i in range(len(roffs) - 1):
        r = rois[roffs[i]:roffs[i + 1]]
        keep_gt = ~crowd[goffs[i]:goffs[i + 1]]
        g = gbox[goffs[i]:goffs[i + 1]][keep_gt]
        gl = gcls[goffs[i]:goffs[i + 1]][keep_gt]
        r = np.concatenate([r, g], axis=0) if len(g) else r
        iou = _iou_matrix(r, g, norm=True)
        best = iou.argmax(axis=1) if iou.size else np.zeros(len(r), np.int64)
        biou = iou.max(axis=1) if iou.size else np.zeros(len(r))
        fg = np.where(biou >= fgt)[0]
        bg = np.where((biou < bgh) & (biou >= bgl))[0]
        nfg = min(int(B * fgf), len(fg))
        nbg = min(B - nfg, len(bg))
        if use_rand:
            fg = rng.permutation(fg)[:nfg]
            bg = rng.permutation(bg)[:nbg]
        else:
            fg, bg = fg[:nfg], bg[:nbg]
        sel = np.concatenate([fg, bg]).astype(np.int64)
        labs = np.concatenate([gl[best[fg]].astype(np.int64),
                               np.zeros(len(bg), np.int64)])
        tgts = np.zeros((len(sel), 4 * C), np.float32)
        inw = np.zeros((len(sel), 4 * C), np.float32)
        if len(fg):
            enc = _box_encode(g[best[fg]], r[fg], [1.0 / w for w in wts])
            cls = (np.ones(len(fg), np.int64)
                   if attrs.get("is_cls_agnostic", False)
                   else labs[:len(fg)].astype(np.int64))
            k = np.arange(len(fg))[:, None]
            cols = 4 * cls[:, None] + np.arange(4)[None, :]
            tgts[k, cols] = enc
            inw[k, cols] = 1.0
        o_rois.append(r[sel])
        o_lab.append(labs)
        o_tgt.append(tgts)
        o_inw.append(inw)
        lens.append(len(sel))
    rois_o = np.concatenate(o_rois) if o_rois else np.zeros((0, 4), np.float32)
    lab_o = np.concatenate(o_lab) if o_lab else np.zeros(0, np.int64)
    tgt_o = (np.concatenate(o_tgt) if o_tgt
             else np.zeros((0, 4 * C), np.float32))
    inw_o = (np.concatenate(o_inw) if o_inw
             else np.zeros((0, 4 * C), np.float32))
    lod = _lod0(lens)
    dev = r_t.device
    return {"Rois": [_dev(rois_o.astype(np.float32), dev)],
            "LabelsInt32": [_dev(lab_o.astype(np.int32)[:, None], dev)],
            "BboxTargets": [_dev(tgt_o, dev)],
            "BboxInsideWeights": [_dev(inw_o, dev)],
            "BboxOutsideWeights": [_dev((inw_o > 0).astype(np.float32),
                                        dev)],
            "_lod": {"Rois": [lod], "LabelsInt32": [lod],
                     "BboxTargets": [lod], "BboxInsideWeights": [lod],
                     "BboxOutsideWeights": [lod]}}


def _rasterize_polygon(poly, h, w):
    """Even-odd fill of one polygon [x0, y0, x1, y1, ...] onto an h × w
    grid, pixel centres tested."""
    ys, xs = np.mgrid[0:h, 0:w]
    px = np.asarray(poly[0::2])
    py = np.asarray(poly[1::2])
    n = len(px)
    inside = np.zeros((h, w), bool)
    j = n - 1
    for i in range(n):
        cond = ((py[i] > ys + 0.5) != (py[j] > ys + 0.5))
        with np.errstate(divide="ignore", invalid="ignore"):
            xcross = (px[j] - px[i]) * (ys + 0.5 - py[i]) \
                / (py[j] - py[i] + 1e-12) + px[i]
        inside ^= cond & (xs + 0.5 < xcross)
        j = i
    return inside


@register_op("generate_mask_labels", stateful=True, no_grad=True,
             needs_lod=True,
             inputs=("ImInfo", "GtClasses", "IsCrowd", "GtSegms", "Rois",
                     "LabelsInt32"),
             attr_defaults={"num_classes": 81, "resolution": 14})
def _generate_mask_labels(ins, attrs):
    """Mask R-CNN's mask targets: each foreground RoI matched to its
    image's ground truth of best box IoU (the box of the ground truth's
    first polygon), that polygon rasterised into the RoI's resolution²
    grid, in the RoI's class's plane. GtSegms' 2-level LoD: ground truth
    → polygons → points."""
    r_t = first(ins, "Rois")
    rois = _host(r_t)
    labels = _host(first(ins, "LabelsInt32")).reshape(-1)
    segs = _host(first(ins, "GtSegms"))
    roffs = _lod_offs(attrs, "Rois", len(rois))
    lods = (attrs.get("_lod") or {}).get("GtSegms")
    res = int(attrs.get("resolution", 14))
    C = int(attrs.get("num_classes", 81))
    if lods and lods[0] and len(lods[0]) >= 2:
        gt_offs = np.asarray(lods[0][0], np.int64)
        pt_offs = np.asarray(lods[0][-1], np.int64)
    else:
        gt_offs = np.asarray([0, 1], np.int64)
        pt_offs = np.asarray([0, len(segs)], np.int64)
    gcls_offs = _lod_offs(attrs, "GtClasses", len(gt_offs) - 1)
    n_gt = len(gt_offs) - 1
    gt_polys, gt_boxes = [], np.zeros((n_gt, 4), np.float64)
    for g_ in range(n_gt):
        p0 = pt_offs[gt_offs[g_]]
        p1 = pt_offs[min(gt_offs[g_] + 1, len(pt_offs) - 1)]
        poly_ = segs[p0:p1].reshape(-1)
        gt_polys.append(poly_)
        xs_, ys_ = poly_[0::2], poly_[1::2]
        if len(xs_):
            gt_boxes[g_] = [xs_.min(), ys_.min(), xs_.max(), ys_.max()]
    mask_rois, mask_lens, roi_has, masks = [], [], [], []
    for i in range(len(roffs) - 1):
        rs = rois[roffs[i]:roffs[i + 1]]
        ls = labels[roffs[i]:roffs[i + 1]]
        g_lo = int(gcls_offs[min(i, len(gcls_offs) - 2)])
        g_hi = int(gcls_offs[min(i + 1, len(gcls_offs) - 1)])
        n_this = 0
        for k, (r, lab) in enumerate(zip(rs, ls)):
            if lab <= 0 or g_hi <= g_lo:
                continue
            ious = _iou_matrix(r[None, :4].astype(np.float64),
                               gt_boxes[g_lo:g_hi], norm=True)[0]
            poly = gt_polys[g_lo + int(np.argmax(ious))]
            x1, y1, x2, y2 = r[:4]
            w = max(x2 - x1, 1e-3)
            h = max(y2 - y1, 1e-3)
            local = poly.copy().astype(np.float64)
            local[0::2] = (local[0::2] - x1) / w * res
            local[1::2] = (local[1::2] - y1) / h * res
            m = _rasterize_polygon(local, res, res)
            cls_mask = np.full((C, res, res), 0, np.int32)
            cls_mask[int(lab)] = m.astype(np.int32)
            masks.append(cls_mask.reshape(-1))
            mask_rois.append(r[:4])
            roi_has.append(k + int(roffs[i]))
            n_this += 1
        mask_lens.append(n_this)
    mr = (np.asarray(mask_rois, np.float32) if mask_rois
          else np.zeros((0, 4), np.float32))
    mi = (np.asarray(masks, np.int32) if masks
          else np.zeros((0, C * res * res), np.int32))
    ridx = (np.asarray(roi_has, np.int32)[:, None] if roi_has
            else np.zeros((0, 1), np.int32))
    lod = _lod0(mask_lens)
    dev = r_t.device
    return {"MaskRois": [_dev(mr, dev)],
            "RoiHasMaskInt32": [_dev(ridx, dev)],
            "MaskInt32": [_dev(mi, dev)],
            "_lod": {"MaskRois": [lod], "RoiHasMaskInt32": [lod],
                     "MaskInt32": [lod]}}


@register_op("roi_perspective_transform", stateful=True,
             needs_lod=True, inputs=("X", "ROIs"),
             attr_defaults={"transformed_height": 8, "transformed_width": 8,
                            "spatial_scale": 1.0})
def _roi_perspective_transform(ins, attrs):
    """Each quadrilateral RoI (8 coords, clockwise from the top left)
    warped onto a transformed_height × transformed_width rectangle by the
    homography of the rectangle's corners onto it (a 4-point DLT by SVD,
    float64), X sampled bilinearly (0 outside the image); as in the TPU
    package, the op has no grad kernel."""
    x_t = first(ins, "X")
    x = _host(x_t)
    rois = _host(first(ins, "ROIs"))
    offs = _lod_offs(attrs, "ROIs", len(rois))
    bids = np.repeat(np.arange(len(offs) - 1), offs[1:] - offs[:-1])
    th = int(attrs.get("transformed_height", 8))
    tw = int(attrs.get("transformed_width", 8))
    scale = attrs.get("spatial_scale", 1.0)
    n, c, H, W = x.shape
    outs, mats, masks = [], [], []
    src = np.asarray([[0, 0], [tw - 1, 0], [tw - 1, th - 1], [0, th - 1]],
                     np.float64)
    gy, gx = np.mgrid[0:th, 0:tw]
    grid = np.stack([gx.ravel(), gy.ravel(),
                     np.ones_like(gx).ravel()]).astype(np.float64)
    for r in range(len(rois)):
        quad = rois[r].reshape(4, 2) * scale
        A = []
        for (sx, sy), (dx_, dy_) in zip(src, quad):
            A.append([sx, sy, 1, 0, 0, 0, -dx_ * sx, -dx_ * sy, -dx_])
            A.append([0, 0, 0, sx, sy, 1, -dy_ * sx, -dy_ * sy, -dy_])
        _, _, vt = np.linalg.svd(np.asarray(A))
        Hm = vt[-1].reshape(3, 3)
        pts = Hm @ grid
        px = pts[0] / (pts[2] + 1e-12)
        py = pts[1] / (pts[2] + 1e-12)
        x0 = np.floor(px).astype(int)
        y0 = np.floor(py).astype(int)
        wx = px - x0
        wy = py - y0
        img = x[bids[r]]

        def g(yi, xi):
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            return img[:, np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)] \
                * valid
        v = (g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x0 + 1) * (1 - wy) * wx
             + g(y0 + 1, x0) * wy * (1 - wx) + g(y0 + 1, x0 + 1) * wy * wx)
        outs.append(v.reshape(c, th, tw))
        mats.append(Hm.reshape(9) / (Hm[2, 2] if Hm[2, 2] != 0 else 1.0))
        masks.append(((px >= 0) & (px <= W - 1) & (py >= 0)
                      & (py <= H - 1)).reshape(1, th, tw))
    o = np.stack(outs) if outs else np.zeros((0, c, th, tw), np.float32)
    mat = np.stack(mats) if mats else np.zeros((0, 9), np.float32)
    msk = np.stack(masks) if masks else np.zeros((0, 1, th, tw), bool)
    dev = x_t.device
    R = len(rois)
    return {"Out": [_dev(o.astype(np.float32), dev)],
            "Out2InIdx": [torch.zeros((R, 1), dtype=torch.int32,
                                      device=dev)],
            "Out2InWeights": [torch.ones((R, 1), dtype=torch.float32,
                                         device=dev)],
            "Mask": [_dev(msk.astype(np.int32), dev)],
            "TransformMatrix": [_dev(mat.astype(np.float32), dev)]}
