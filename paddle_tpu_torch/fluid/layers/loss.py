"""Loss layers (counterpart of paddle_tpu/fluid/layers/loss.py; reference:
python/paddle/fluid/layers/loss.py). So far: cross_entropy,
softmax_with_cross_entropy and square_error_cost."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "square_error_cost"]


def square_error_cost(input, label):
    """(input - label)², elementwise."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """-log(input[label]) of probabilities ``input``, [..., 1]."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = tuple(list(input.shape[:-1]) + [1])
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


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
