"""Loss layers (counterpart of paddle_tpu/fluid/layers/loss.py; reference:
python/paddle/fluid/layers/loss.py). So far: softmax_with_cross_entropy."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["softmax_with_cross_entropy"]


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    softmax.shape = logits.shape
    lshape = list(logits.shape)
    lshape[axis] = 1
    loss.shape = tuple(lshape)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax], "Loss": [loss]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index,
                            "numeric_stable_mode": numeric_stable_mode,
                            "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss
