"""Detection layers (counterpart of paddle_tpu/fluid/layers/detection.py:
every layer it defines; reference: python/paddle/fluid/layers/
detection.py). The ops are ops/detection_ops.py's, detection_train_ops.py's
and metrics_misc_ops.py's: geometry in torch on the device, matching, NMS
and sampling on the host (islands of a segmented step)."""
from __future__ import annotations

from ..core import VarDesc
from ..layer_helper import LayerHelper

__all__ = [
    "prior_box", "density_prior_box", "multi_box_head", "bipartite_match",
    "target_assign", "detection_output", "ssd_loss", "rpn_target_assign",
    "retinanet_target_assign", "sigmoid_focal_loss", "anchor_generator",
    "roi_perspective_transform", "generate_proposal_labels",
    "generate_proposals", "generate_mask_labels", "iou_similarity",
    "box_coder", "polygon_box_transform", "yolov3_loss", "yolo_box",
    "box_clip", "multiclass_nms", "locality_aware_nms",
    "retinanet_detection_output", "distribute_fpn_proposals",
    "box_decoder_and_assign", "collect_fpn_proposals",
    "detection_map",
]


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="polygon_box_transform",
                     inputs={"Input": [input]},
                     outputs={"Output": [out]})
    return out


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    helper = LayerHelper("rpn_target_assign", **locals())
    i32 = VarDesc.VarType.INT32
    loc_index = _mk_out(helper, i32)
    score_index = _mk_out(helper, i32)
    loc_index.shape = (-1,)
    score_index.shape = (-1,)
    target_label = _mk_out(helper, i32)
    target_bbox = _mk_out(helper)
    bbox_inside_weight = _mk_out(helper)
    helper.append_op(
        type="rpn_target_assign",
        inputs={"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
                "IsCrowd": [is_crowd], "ImInfo": [im_info]},
        outputs={"LocationIndex": [loc_index], "ScoreIndex": [score_index],
                 "TargetLabel": [target_label], "TargetBBox": [target_bbox],
                 "BBoxInsideWeight": [bbox_inside_weight]},
        attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
               "rpn_straddle_thresh": rpn_straddle_thresh,
               "rpn_fg_fraction": rpn_fg_fraction,
               "rpn_positive_overlap": rpn_positive_overlap,
               "rpn_negative_overlap": rpn_negative_overlap,
               "use_random": use_random})
    from .nn import gather as _gather, reshape as _reshape
    pred_loc = _gather(_reshape(bbox_pred, [-1, 4]), loc_index)
    pred_score = _gather(_reshape(cls_logits, [-1, 1]), score_index)
    return (pred_score, pred_loc, target_label, target_bbox,
            bbox_inside_weight)


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd, im_info,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    helper = LayerHelper("retinanet_target_assign", **locals())
    i32 = VarDesc.VarType.INT32
    loc_index = _mk_out(helper, i32)
    score_index = _mk_out(helper, i32)
    loc_index.shape = (-1,)
    score_index.shape = (-1,)
    target_label = _mk_out(helper, i32)
    target_bbox = _mk_out(helper)
    bbox_inside_weight = _mk_out(helper)
    fg_num = _mk_out(helper, i32)
    helper.append_op(
        type="retinanet_target_assign",
        inputs={"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
                "GtLabels": [gt_labels], "IsCrowd": [is_crowd],
                "ImInfo": [im_info]},
        outputs={"LocationIndex": [loc_index], "ScoreIndex": [score_index],
                 "TargetLabel": [target_label], "TargetBBox": [target_bbox],
                 "BBoxInsideWeight": [bbox_inside_weight],
                 "ForegroundNumber": [fg_num]},
        attrs={"positive_overlap": positive_overlap,
               "negative_overlap": negative_overlap})
    from .nn import gather as _gather, reshape as _reshape
    pred_loc = _gather(_reshape(bbox_pred, [-1, 4]), loc_index)
    pred_score = _gather(_reshape(cls_logits, [-1, num_classes]),
                         score_index)
    return (pred_score, pred_loc, target_label, target_bbox,
            bbox_inside_weight, fg_num)


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    helper = LayerHelper("retinanet_detection_output", **locals())
    out = _mk_out(helper)
    helper.append_op(
        type="retinanet_detection_output",
        inputs={"BBoxes": list(bboxes), "Scores": list(scores),
                "Anchors": list(anchors), "ImInfo": [im_info]},
        outputs={"Out": [out]},
        attrs={"score_threshold": score_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
               "nms_eta": nms_eta})
    return out


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    helper = LayerHelper("locality_aware_nms", **locals())
    out = _mk_out(helper)
    helper.append_op(
        type="locality_aware_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out]},
        attrs={"score_threshold": score_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
               "normalized": normalized, "nms_eta": nms_eta,
               "background_label": background_label})
    return out


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip, name=None):
    helper = LayerHelper("box_decoder_and_assign", **locals())
    decoded = _mk_out(helper)
    assigned = _mk_out(helper)
    helper.append_op(
        type="box_decoder_and_assign",
        inputs={"PriorBox": [prior_box], "PriorBoxVar": [prior_box_var],
                "TargetBox": [target_box], "BoxScore": [box_score]},
        outputs={"DecodeBox": [decoded], "OutputAssignBox": [assigned]},
        attrs={"box_clip": box_clip})
    return decoded, assigned


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=[0.1, 0.1, 0.2, 0.2],
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False):
    helper = LayerHelper("generate_proposal_labels", **locals())
    rois = _mk_out(helper)
    labels_int32 = _mk_out(helper, VarDesc.VarType.INT32)
    bbox_targets = _mk_out(helper)
    bbox_inside_weights = _mk_out(helper)
    bbox_outside_weights = _mk_out(helper)
    helper.append_op(
        type="generate_proposal_labels",
        inputs={"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
                "IsCrowd": [is_crowd], "GtBoxes": [gt_boxes],
                "ImInfo": [im_info]},
        outputs={"Rois": [rois], "LabelsInt32": [labels_int32],
                 "BboxTargets": [bbox_targets],
                 "BboxInsideWeights": [bbox_inside_weights],
                 "BboxOutsideWeights": [bbox_outside_weights]},
        attrs={"batch_size_per_im": batch_size_per_im,
               "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
               "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": bbox_reg_weights,
               "class_nums": class_nums or 81, "use_random": use_random,
               "is_cls_agnostic": is_cls_agnostic,
               "is_cascade_rcnn": is_cascade_rcnn})
    return (rois, labels_int32, bbox_targets, bbox_inside_weights,
            bbox_outside_weights)


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution):
    helper = LayerHelper("generate_mask_labels", **locals())
    mask_rois = _mk_out(helper)
    roi_has_mask_int32 = _mk_out(helper, VarDesc.VarType.INT32)
    mask_int32 = _mk_out(helper, VarDesc.VarType.INT32)
    helper.append_op(
        type="generate_mask_labels",
        inputs={"ImInfo": [im_info], "GtClasses": [gt_classes],
                "IsCrowd": [is_crowd], "GtSegms": [gt_segms],
                "Rois": [rois], "LabelsInt32": [labels_int32]},
        outputs={"MaskRois": [mask_rois],
                 "RoiHasMaskInt32": [roi_has_mask_int32],
                 "MaskInt32": [mask_int32]},
        attrs={"num_classes": num_classes, "resolution": resolution})
    return mask_rois, roi_has_mask_int32, mask_int32


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0):
    helper = LayerHelper("roi_perspective_transform", **locals())
    out = _mk_out(helper)
    mask = _mk_out(helper, VarDesc.VarType.INT32)
    matrix = _mk_out(helper)
    out2in_idx = _mk_out(helper, VarDesc.VarType.INT32)
    out2in_w = _mk_out(helper)
    helper.append_op(
        type="roi_perspective_transform",
        inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out], "Mask": [mask], "TransformMatrix": [matrix],
                 "Out2InIdx": [out2in_idx], "Out2InWeights": [out2in_w]},
        attrs={"transformed_height": transformed_height,
               "transformed_width": transformed_width,
               "spatial_scale": spatial_scale})
    return out, mask, matrix


def _mk_out(helper, dtype=None):
    return helper.create_variable_for_type_inference(
        dtype or VarDesc.VarType.FP32)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=[1.],
              variance=[0.1, 0.1, 0.2, 0.2], flip=False, clip=False,
              steps=[0.0, 0.0], offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", name=name)
    box = _mk_out(helper)
    var = _mk_out(helper)
    helper.append_op(
        type="prior_box", inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [box], "Variances": [var]},
        attrs={"min_sizes": list(map(float, min_sizes)),
               "max_sizes": list(map(float, max_sizes or [])),
               "aspect_ratios": list(map(float, aspect_ratios)),
               "variances": list(map(float, variance)),
               "flip": flip, "clip": clip, "step_w": float(steps[0]),
               "step_h": float(steps[1]), "offset": offset,
               "min_max_aspect_ratios_order": min_max_aspect_ratios_order})
    return box, var


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=[0.1, 0.1, 0.2, 0.2],
                      clip=False, steps=[0.0, 0.0], offset=0.5,
                      flatten_to_2d=False, name=None):
    helper = LayerHelper("density_prior_box", name=name)
    box = _mk_out(helper)
    var = _mk_out(helper)
    helper.append_op(
        type="density_prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [box], "Variances": [var]},
        attrs={"densities": list(map(int, densities or [])),
               "fixed_sizes": list(map(float, fixed_sizes or [])),
               "fixed_ratios": list(map(float, fixed_ratios or [])),
               "variances": list(map(float, variance)), "clip": clip,
               "step_w": float(steps[0]), "step_h": float(steps[1]),
               "offset": offset, "flatten_to_2d": flatten_to_2d})
    return box, var


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=[0.1, 0.1, 0.2, 0.2], stride=None, offset=0.5,
                     name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchor = _mk_out(helper)
    var = _mk_out(helper)
    helper.append_op(
        type="anchor_generator", inputs={"Input": [input]},
        outputs={"Anchors": [anchor], "Variances": [var]},
        attrs={"anchor_sizes": list(map(float, anchor_sizes
                                        or [64., 128., 256., 512.])),
               "aspect_ratios": list(map(float, aspect_ratios
                                         or [0.5, 1.0, 2.0])),
               "variances": list(map(float, variance)),
               "stride": list(map(float, stride or [16., 16.])),
               "offset": offset})
    return anchor, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    helper = LayerHelper("box_coder", name=name)
    output = _mk_out(helper)
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    attrs = {"code_type": code_type, "box_normalized": box_normalized,
             "axis": axis}
    from ..framework import Variable
    if isinstance(prior_box_var, Variable):
        inputs["PriorBoxVar"] = [prior_box_var]
    elif isinstance(prior_box_var, (list, tuple)):
        attrs["variance"] = list(map(float, prior_box_var))
    helper.append_op(type="box_coder", inputs=inputs,
                     outputs={"OutputBox": [output]}, attrs=attrs)
    return output


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    output = _mk_out(helper)
    helper.append_op(type="box_clip",
                     inputs={"Input": [input], "ImInfo": [im_info]},
                     outputs={"Output": [output]})
    return output


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    helper = LayerHelper("bipartite_match", name=name)
    match_indices = _mk_out(helper, VarDesc.VarType.INT32)
    match_distance = _mk_out(helper)
    helper.append_op(
        type="bipartite_match", inputs={"DistMat": [dist_matrix]},
        outputs={"ColToRowMatchIndices": [match_indices],
                 "ColToRowMatchDist": [match_distance]},
        attrs={"match_type": match_type or "bipartite",
               "dist_threshold": dist_threshold or 0.5})
    return match_indices, match_distance


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = _mk_out(helper, input.dtype)
    out_weight = _mk_out(helper)
    helper.append_op(
        type="target_assign",
        inputs={"X": [input], "MatchIndices": [matched_indices]},
        outputs={"Out": [out], "OutWeight": [out_weight]},
        attrs={"mismatch_value": mismatch_value or 0})
    return out, out_weight


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None):
    helper = LayerHelper("multiclass_nms", name=name)
    output = _mk_out(helper)
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [output]},
        attrs={"score_threshold": score_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
               "normalized": normalized, "nms_eta": nms_eta,
               "background_label": background_label})
    return output


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     return_index=False):
    """reference layers/detection.py detection_output: decode + NMS."""
    from .nn import transpose
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    scores_t = transpose(scores, [0, 2, 1])  # [N, C, M]
    return multiclass_nms(decoded, scores_t, score_threshold, nms_top_k,
                          keep_top_k, nms_threshold, True, nms_eta,
                          background_label)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None):
    helper = LayerHelper("yolo_box", name=name)
    boxes = _mk_out(helper)
    scores = _mk_out(helper)
    helper.append_op(
        type="yolo_box", inputs={"X": [x], "ImgSize": [img_size]},
        outputs={"Boxes": [boxes], "Scores": [scores]},
        attrs={"anchors": list(map(int, anchors)), "class_num": class_num,
               "conf_thresh": conf_thresh,
               "downsample_ratio": downsample_ratio,
               "clip_bbox": clip_bbox})
    return boxes, scores


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    helper = LayerHelper("yolov3_loss", name=name)
    loss = _mk_out(helper)
    inputs = {"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]}
    if gt_score is not None:
        inputs["GTScore"] = [gt_score]
    helper.append_op(
        type="yolov3_loss", inputs=inputs, outputs={"Loss": [loss]},
        attrs={"anchors": list(map(int, anchors)),
               "anchor_mask": list(map(int, anchor_mask)),
               "class_num": class_num, "ignore_thresh": ignore_thresh,
               "downsample_ratio": downsample_ratio,
               "use_label_smooth": use_label_smooth})
    return loss


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None,
                       return_rois_num=False):
    helper = LayerHelper("generate_proposals", name=name)
    rois = _mk_out(helper)
    roi_probs = _mk_out(helper)
    rois_num = _mk_out(helper, VarDesc.VarType.INT32)
    helper.append_op(
        type="generate_proposals",
        inputs={"Scores": [scores], "BboxDeltas": [bbox_deltas],
                "ImInfo": [im_info], "Anchors": [anchors],
                "Variances": [variances]},
        outputs={"RpnRois": [rois], "RpnRoiProbs": [roi_probs],
                 "RpnRoisNum": [rois_num]},
        attrs={"pre_nms_topN": pre_nms_top_n, "post_nms_topN": post_nms_top_n,
               "nms_thresh": nms_thresh, "min_size": min_size, "eta": eta})
    if return_rois_num:
        return rois, roi_probs, rois_num
    return rois, roi_probs


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    helper = LayerHelper("distribute_fpn_proposals", name=name)
    n = max_level - min_level + 1
    outs = [_mk_out(helper) for _ in range(n)]
    restore = _mk_out(helper, VarDesc.VarType.INT32)
    helper.append_op(
        type="distribute_fpn_proposals", inputs={"FpnRois": [fpn_rois]},
        outputs={"MultiFpnRois": outs, "RestoreIndex": [restore]},
        attrs={"min_level": min_level, "max_level": max_level,
               "refer_level": refer_level, "refer_scale": refer_scale})
    return outs, restore


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    helper = LayerHelper("collect_fpn_proposals", name=name)
    output = _mk_out(helper)
    helper.append_op(
        type="collect_fpn_proposals",
        inputs={"MultiLevelRois": list(multi_rois),
                "MultiLevelScores": list(multi_scores)},
        outputs={"FpnRois": [output]},
        attrs={"post_nms_topN": post_nms_top_n})
    return output


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True,
             sample_size=None):
    """SSD's multibox loss as the TPU package builds it: the priors
    matched to the ground truths by IoU (``bipartite_match``), the
    smooth-L1 of the matched priors' encoded boxes and the softmax loss
    of every prior's label. As there, no hard-negative mining
    (``mine_hard_examples`` is not in the layer): every unmatched prior
    is a negative. → [N, M, 1]."""
    from .. import layers as nn
    from .loss import softmax_with_cross_entropy
    iou = iou_similarity(gt_box, prior_box)          # LoD [T, M]
    matched, _dist = bipartite_match(iou, match_type, neg_overlap)
    # location targets: per-prior encoded gt (target_assign gathers the
    # matched row of the [T, M, 4] encoding)
    enc_gt = box_coder(prior_box, prior_box_var or [0.1, 0.1, 0.2, 0.2],
                       gt_box)                        # [T, M, 4]
    loc_tgt, loc_w = target_assign(enc_gt, matched)   # [N, M, 4], [N, M, 1]
    lbl_tgt, _lbl_w = target_assign(gt_label, matched,
                                    mismatch_value=background_label)
    conf_loss = softmax_with_cross_entropy(
        confidence, nn.cast(lbl_tgt, "int64"))        # [N, M, 1]
    # per-prior huber on the 4 coords: 0.5*min(|d|,1)^2 + (|d| - min(|d|,1))
    d = location - nn.cast(loc_tgt, "float32")
    ad = nn.abs(d)
    c = nn.clip(ad, 0.0, 1.0)
    huber = c * c * 0.5 + (ad - c)
    loc_l = nn.reduce_sum(huber, dim=-1, keep_dim=True)  # [N, M, 1]
    loss = (conf_loss * conf_loss_weight
            + nn.elementwise_mul(loc_l, loc_w) * loc_loss_weight)
    return loss


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = _mk_out(helper, x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"box_normalized": box_normalized})
    return out


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    helper = LayerHelper("sigmoid_focal_loss")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="sigmoid_focal_loss",
                     inputs={"X": [x], "Label": [label], "FgNum": [fg_num]},
                     outputs={"Out": [out]},
                     attrs={"gamma": gamma, "alpha": alpha})
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=[0.1, 0.1, 0.2, 0.2], flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head over multiple feature maps (reference
    detection.py multi_box_head): per input, conv to loc/conf + priors;
    outputs concatenated over maps."""
    from . import nn
    from .nn import conv2d, transpose, reshape
    from .tensor import concat
    n_layer = len(inputs)
    if min_sizes is None:
        # reference ratio schedule
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_layer - 2))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes
    locs, confs, boxes_l, vars_l = [], [], [], []
    for i, feat in enumerate(inputs):
        ms = min_sizes[i]
        ms = [ms] if not isinstance(ms, (list, tuple)) else list(ms)
        mx = max_sizes[i] if max_sizes else None
        mx = ([mx] if mx is not None and
              not isinstance(mx, (list, tuple)) else mx)
        ar = aspect_ratios[i]
        ar = [ar] if not isinstance(ar, (list, tuple)) else list(ar)
        stp = steps[i] if steps else [step_w or 0.0, step_h or 0.0]
        if not isinstance(stp, (list, tuple)):
            stp = [stp, stp]
        box, var = prior_box(feat, image, ms, mx, ar, variance, flip, clip,
                             stp, offset)
        num_priors = 1 if not hasattr(box, "shape") else None
        # priors per cell = len(ms)*len(ar expanded) + len(mx)
        n_ar = 1 + sum(2 if flip and abs(a - 1.0) > 1e-6 else 1
                       for a in ar if abs(a - 1.0) > 1e-6)
        num_priors = len(ms) * n_ar + (len(mx) if mx else 0)
        loc = conv2d(feat, num_priors * 4, kernel_size, stride, pad)
        conf = conv2d(feat, num_priors * num_classes, kernel_size, stride,
                      pad)
        locs.append(reshape(transpose(loc, [0, 2, 3, 1]), [0, -1, 4]))
        confs.append(reshape(transpose(conf, [0, 2, 3, 1]),
                             [0, -1, num_classes]))
        boxes_l.append(reshape(box, [-1, 4]))
        vars_l.append(reshape(var, [-1, 4]))
    mbox_locs = concat(locs, axis=1)
    mbox_confs = concat(confs, axis=1)
    boxes = concat(boxes_l, axis=0)
    variances = concat(vars_l, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral"):
    helper = LayerHelper("detection_map", **locals())
    map_out = helper.create_variable_for_type_inference(VarDesc.VarType.FP32)
    pos_count = helper.create_variable_for_type_inference(
        VarDesc.VarType.INT32)
    true_pos = helper.create_variable_for_type_inference(VarDesc.VarType.FP32)
    false_pos = helper.create_variable_for_type_inference(
        VarDesc.VarType.FP32)
    inputs = {"DetectRes": [detect_res], "Label": [label]}
    if has_state is not None:
        inputs["HasState"] = [has_state]
    if input_states is not None:
        inputs["PosCount"] = [input_states[0]]
        inputs["TruePos"] = [input_states[1]]
        inputs["FalsePos"] = [input_states[2]]
    if out_states is not None:
        pos_count, true_pos, false_pos = out_states
    helper.append_op(
        type="detection_map", inputs=inputs,
        outputs={"MAP": [map_out], "AccumPosCount": [pos_count],
                 "AccumTruePos": [true_pos], "AccumFalsePos": [false_pos]},
        attrs={"overlap_threshold": overlap_threshold,
               "class_num": class_num, "background_label": background_label,
               "evaluate_difficult": evaluate_difficult,
               "ap_type": ap_version})
    return map_out
