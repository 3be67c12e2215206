"""Loss layers (counterpart of paddle_tpu/fluid/layers/loss.py; reference:
python/paddle/fluid/layers/loss.py). So far: cross_entropy,
softmax_with_cross_entropy, square_error_cost, nce and hsigmoid."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "square_error_cost",
           "nce", "hsigmoid"]


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


# --------------------------------------------------------------------------
# sampled losses
# --------------------------------------------------------------------------
def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """reference: layers/loss.py nce — NCE over sampled negatives."""
    helper = LayerHelper("nce", **locals())
    dtype = helper.input_dtype()
    dim = input.shape[-1]
    w = helper.create_parameter(attr=param_attr,
                                shape=[num_total_classes, dim], dtype=dtype)
    b = (helper.create_parameter(attr=bias_attr,
                                 shape=[num_total_classes, 1], dtype=dtype,
                                 is_bias=True)
         if bias_attr is not False else None)
    cost = helper.create_variable_for_type_inference(dtype)
    cost.shape = (-1, 1)
    slog = helper.create_variable_for_type_inference(dtype)
    slab = helper.create_variable_for_type_inference(label.dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if b is not None:
        inputs["Bias"] = [b]
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [slog],
                 "SampleLabels": [slab]},
        attrs={"num_total_classes": num_total_classes,
               "num_neg_samples": num_neg_samples or 10, "seed": seed,
               "sampler": {"uniform": 0, "log_uniform": 1,
                           "custom_dist": 2}.get(sampler, 0),
               "is_sparse": is_sparse})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """reference: layers/loss.py hsigmoid — complete-binary-tree codes."""
    helper = LayerHelper("hierarchical_sigmoid", **locals())
    dtype = helper.input_dtype()
    dim = input.shape[-1]
    w = helper.create_parameter(attr=param_attr,
                                shape=[num_classes - 1, dim], dtype=dtype)
    b = (helper.create_parameter(attr=bias_attr, shape=[num_classes - 1, 1],
                                 dtype=dtype, is_bias=True)
         if bias_attr is not False else None)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = (-1, 1)
    pre = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if b is not None:
        inputs["Bias"] = [b]
    helper.append_op(type="hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [out], "PreOut": [pre]},
                     attrs={"num_classes": num_classes,
                            "is_sparse": is_sparse})
    return out
