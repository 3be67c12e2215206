"""Metric layers (counterpart of paddle_tpu/fluid/layers/metric_op.py;
reference: python/paddle/fluid/layers/metric_op.py). So far: accuracy and
auc."""
from __future__ import annotations

from ..core import VarDesc
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of ``input`` against ``label``: top_k, then the
    accuracy op. Returns the [1] f32 accuracy (no grad)."""
    from .nn import topk
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference(VarDesc.VarType.FP32)
    acc_out.shape = (1,)
    if correct is None:
        correct = helper.create_variable_for_type_inference(
            VarDesc.VarType.INT32)
    if total is None:
        total = helper.create_variable_for_type_inference(
            VarDesc.VarType.INT32)
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    acc_out.stop_gradient = True
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=2 ** 12 - 1, topk=1,
        slide_steps=1):
    """The streaming AUC of ``input`` ([N, 2] probabilities, column 1 the
    positive class) against ``label``: the auc op over persistable int64
    histograms ``<name>_stat_pos`` and ``<name>_stat_neg`` of
    ``num_thresholds + 1`` buckets, zeroed by the startup program. Returns
    (the AUC var, [the AUC var, StatPos, StatNeg])."""
    helper = LayerHelper("auc")
    auc_out = helper.create_variable_for_type_inference(VarDesc.VarType.FP64)
    auc_out.shape = (1,)
    stat_pos = helper.create_or_get_global_variable(
        name=helper.name + "_stat_pos", dtype=VarDesc.VarType.INT64,
        shape=[num_thresholds + 1])
    stat_neg = helper.create_or_get_global_variable(
        name=helper.name + "_stat_neg", dtype=VarDesc.VarType.INT64,
        shape=[num_thresholds + 1])
    for v in (stat_pos, stat_neg):
        v.persistable = True
        helper.set_variable_initializer(v, Constant(0.0))
    helper.append_op(type="auc",
                     inputs={"Predict": [input], "Label": [label],
                             "StatPos": [stat_pos], "StatNeg": [stat_neg]},
                     outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                              "StatNegOut": [stat_neg]},
                     attrs={"curve": curve, "num_thresholds": num_thresholds,
                            "slide_steps": slide_steps})
    auc_out.stop_gradient = True
    return auc_out, [auc_out, stat_pos, stat_neg]
