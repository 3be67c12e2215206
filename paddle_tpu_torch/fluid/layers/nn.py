"""Core NN layers (counterpart of paddle_tpu/fluid/layers/nn.py; reference:
python/paddle/fluid/layers/nn.py). Op-builder functions with inline shape
inference; -1 marks unknown dims. So far: fc, embedding, layer_norm,
dropout, reshape, unsqueeze, gather, topk, mean, elementwise_add,
elementwise_sub, scale."""
from __future__ import annotations

import math

from ..core import VarDesc, convert_np_dtype_to_dtype_
from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import Constant

__all__ = ["fc", "embedding", "layer_norm", "dropout", "reshape",
           "unsqueeze", "gather", "topk", "mean", "elementwise_add",
           "elementwise_sub", "scale"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """reference: layers/nn.py fc — mul(+sum) + bias + act."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    inputs = helper.multiple_input()
    mul_results = []
    for inp, pa in zip(inputs, helper.multiple_param_attr(len(inputs))):
        shape = inp.shape
        in_features = math.prod(shape[num_flatten_dims:])
        w = helper.create_parameter(attr=pa, shape=[in_features, size],
                                    dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        tmp.shape = tuple(shape[:num_flatten_dims]) + (size,)
        helper.append_op(type="mul", inputs={"X": [inp], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        pre_bias.shape = mul_results[0].shape
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """reference: layers/nn.py embedding → lookup_table_v2 op (ids without
    a trailing 1; the v1 ``lookup_table`` form comes in a later slice)."""
    helper = LayerHelper("embedding", **locals())
    dtype = convert_np_dtype_to_dtype_(dtype)
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    ishape = list(input.shape)
    if ishape and ishape[-1] == 1:
        raise NotImplementedError(
            "embedding: ids of shape [..., 1] take the v1 lookup_table op, "
            "which is not ported yet")
    out.shape = tuple(ishape) + (size[1],)
    helper.append_op(type="lookup_table_v2",
                     inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "remote_prefetch": False,
                            "padding_idx": pad})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    norm_shape = [math.prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(attr=helper.param_attr, shape=norm_shape,
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(attr=helper.bias_attr, shape=norm_shape,
                                    dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    mean = helper.create_variable_for_type_inference(dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    mask = helper.create_variable_for_type_inference(
        VarDesc.VarType.UINT8, stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "fix_seed": seed is not None, "seed": seed or 0,
               "dropout_implementation": dropout_implementation})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    inputs = {"X": [x]}
    attrs = {}
    if isinstance(shape, Variable):
        inputs["Shape"] = [shape]
        attrs["shape"] = []
    elif any(isinstance(s, Variable) for s in shape):
        inputs["ShapeTensor"] = [s for s in shape if isinstance(s, Variable)]
        attrs["shape"] = [s if not isinstance(s, Variable) else -1
                          for s in shape]
    else:
        attrs["shape"] = [int(s) for s in shape]
        # static shape inference with 0/-1 rules
        tgt = list(attrs["shape"])
        for i, t in enumerate(tgt):
            if t == 0:
                tgt[i] = x.shape[i]
        if -1 in tgt and all(s >= 0 for s in x.shape):
            known = math.prod(t for t in tgt if t != -1)
            tgt[tgt.index(-1)] = math.prod(x.shape) // max(known, 1)
        out.shape = tuple(tgt)
    helper.append_op(type="reshape2", inputs=inputs,
                     outputs={"Out": [out], "XShape": [xshape]}, attrs=attrs)
    return helper.append_activation(out)


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype,
                                                       stop_gradient=True)
    shp = list(input.shape)
    for a in sorted(axes):
        shp.insert(a if a >= 0 else len(shp) + a + 1, 1)
    out.shape = tuple(shp)
    helper.append_op(type="unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": axes})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    idx_rows = index.shape[0] if index.shape else -1
    out.shape = tuple([idx_rows] + list(input.shape[1:]))
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def topk(input, k, name=None):
    """reference: layers/nn.py topk → top_k op: (values, int64 indices)
    of the k largest along the last axis; ``k`` may be a Variable."""
    helper = LayerHelper("top_k", **locals())
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference(VarDesc.VarType.INT64)
    inputs = {"X": [input]}
    attrs = {"k": k if not isinstance(k, Variable) else 1}
    if isinstance(k, Variable):
        inputs["K"] = [k]
    else:
        values.shape = tuple(list(input.shape[:-1]) + [k])
        indices.shape = values.shape
    helper.append_op(type="top_k", inputs=inputs,
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs=attrs)
    indices.stop_gradient = True
    return values, indices


def mean(x, name=None):
    helper = LayerHelper("mean", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = (1,)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape if len(x.shape) >= len(y.shape) else y.shape
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    helper.kwargs["act"] = act
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="scale", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)
