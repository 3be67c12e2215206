"""Loss layers (counterpart of paddle_tpu/fluid/layers/loss.py; reference:
python/paddle/fluid/layers/loss.py): every layer of the TPU package's
loss.py."""
from __future__ import annotations

from ..core import VarDesc
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


def _loss_op(op_type, ins, attrs=None, out_slot="Out", shape=None,
             extra=(), name=None):
    """One loss op with its output (in the first input's dtype, with
    ``shape`` if given) and the ``extra`` output slots it also writes."""
    helper = LayerHelper(op_type, name=name)
    dtype = next(iter(ins.values()))[0].dtype
    out = helper.create_variable_for_type_inference(dtype)
    outs = {s: [helper.create_variable_for_type_inference(dtype)]
            for s in extra}
    if shape is not None:
        out.shape = tuple(shape)
    helper.append_op(type=op_type, inputs=ins,
                     outputs=dict({out_slot: [out]}, **outs),
                     attrs=attrs or {})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    return _loss_op("sigmoid_cross_entropy_with_logits",
                    {"X": [x], "Label": [label]},
                    {"ignore_index": ignore_index, "normalize": normalize},
                    shape=x.shape, name=name)


def rank_loss(label, left, right, name=None):
    return _loss_op("rank_loss", {"Label": [label], "Left": [left],
                                  "Right": [right]}, shape=left.shape,
                    name=name)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    return _loss_op("margin_rank_loss",
                    {"Label": [label], "X1": [left], "X2": [right]},
                    {"margin": margin}, shape=left.shape,
                    extra=("Activated",), name=name)


def huber_loss(input, label, delta):
    return _loss_op("huber_loss", {"X": [input], "Y": [label]},
                    {"delta": delta}, shape=input.shape,
                    extra=("Residual",))


def kldiv_loss(x, target, reduction="mean", name=None):
    return _loss_op("kldiv_loss", {"X": [x], "Target": [target]},
                    {"reduction": reduction}, out_slot="Loss", name=name)


def mse_loss(input, label):
    return _loss_op("mse_loss", {"X": [input], "Y": [label]}, shape=(1,))


def bpr_loss(input, label, name=None):
    return _loss_op("bpr_loss", {"X": [input], "Label": [label]},
                    out_slot="Y", shape=(input.shape[0], 1), name=name)


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    """reference: layers/loss.py center_loss — ½‖x − c‖² with the centers
    (zeros, no grad) moved by the op itself (CentersOut is Centers)."""
    from ..initializer import Constant
    helper = LayerHelper("center_loss", **locals())
    dtype = helper.input_dtype()
    centers = helper.create_parameter(
        attr=param_attr, shape=[num_classes, input.shape[-1]], dtype=dtype,
        default_initializer=Constant(0.0))
    centers.stop_gradient = True
    rate = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="fill_constant", inputs={},
                     outputs={"Out": [rate]},
                     attrs={"shape": [1], "value": float(alpha),
                            "dtype": rate.dtype})
    loss = helper.create_variable_for_type_inference(dtype)
    diff = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="center_loss",
        inputs={"X": [input], "Label": [label], "Centers": [centers],
                "CenterUpdateRate": [rate]},
        outputs={"Loss": [loss], "SampleCenterDiff": [diff],
                 "CentersOut": [centers]},
        attrs={"cluster_num": num_classes, "alpha": float(alpha),
               "need_update": update_center})
    return loss


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """(each LoD pair's Levenshtein distance f32 [N, 1], N int64 [1]);
    ``ignored_tokens`` and the lengths are not read, as in the TPU
    package."""
    helper = LayerHelper("edit_distance")
    out = helper.create_variable_for_type_inference(VarDesc.VarType.FP32)
    seq_num = helper.create_variable_for_type_inference(
        VarDesc.VarType.INT64)
    helper.append_op(type="edit_distance",
                     inputs={"Hyps": [input], "Refs": [label]},
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized})
    return out, seq_num


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None):
    """The CTC loss [N, 1] of LoD logits [T, C] against LoD labels."""
    return _loss_op("warpctc", {"Logits": [input], "Label": [label]},
                    {"blank": blank, "norm_by_times": norm_by_times},
                    out_slot="Loss", shape=(-1, 1))


def sampled_softmax_with_cross_entropy(logits, label, num_samples, seed=0,
                                       **kw):
    return _loss_op("sampled_softmax_with_cross_entropy",
                    {"Logits": [logits], "Label": [label]},
                    {"num_samples": num_samples, "seed": seed},
                    out_slot="Loss", shape=(-1, 1))


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    return _loss_op("teacher_student_sigmoid_loss",
                    {"X": [input], "Label": [label]},
                    {"soft_max_up_bound": soft_max_up_bound,
                     "soft_max_lower_bound": soft_max_lower_bound},
                    out_slot="Y", shape=(-1, 1))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """The mean softmax cross entropy of anchor·positiveᵀ against
    ``labels`` taken as soft labels, plus l2_reg/4 of the two mean
    squared norms, as the TPU package builds it."""
    from . import ops
    from .nn import matmul, reduce_mean, reduce_sum
    reg = reduce_mean(reduce_sum(ops.square(anchor), 1)) + reduce_mean(
        reduce_sum(ops.square(positive), 1))
    l2loss = reg * l2_reg * 0.25
    sim = matmul(anchor, positive, transpose_y=True)
    ce = softmax_with_cross_entropy(sim, labels, soft_label=True)
    return reduce_mean(ce) + l2loss


__all__ += ["sigmoid_cross_entropy_with_logits", "rank_loss",
            "margin_rank_loss", "huber_loss", "kldiv_loss", "mse_loss",
            "bpr_loss", "center_loss", "edit_distance", "warpctc",
            "sampled_softmax_with_cross_entropy",
            "teacher_student_sigmoid_loss", "npair_loss"]
