"""Metric layers (counterpart of paddle_tpu/fluid/layers/metric_op.py;
reference: python/paddle/fluid/layers/metric_op.py). So far: accuracy."""
from __future__ import annotations

from ..core import VarDesc
from ..layer_helper import LayerHelper

__all__ = ["accuracy"]


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
