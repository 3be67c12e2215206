"""Core NN layers (counterpart of paddle_tpu/fluid/layers/nn.py; reference:
python/paddle/fluid/layers/nn.py). Op-builder functions with inline shape
inference; -1 marks unknown dims. So far: fc, embedding, conv2d, pool2d,
batch_norm, layer_norm, dropout, softmax, reshape, squeeze, unsqueeze,
flatten, gather, topk, mean, reduce_sum, reduce_mean, one_hot,
elementwise_add, _sub, _mul, _div and _min, scale, label_smooth,
log_loss, add_position_encoding, autoincreased_step_counter and the
logical_* layers."""
from __future__ import annotations

import math

from ..core import VarDesc, convert_np_dtype_to_dtype_
from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import Constant, Normal
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm",
           "layer_norm", "dropout", "softmax", "reshape", "squeeze",
           "unsqueeze", "transpose", "matmul", "flatten", "gather", "topk",
           "mean", "reduce_sum",
           "reduce_mean", "one_hot", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "elementwise_min", "scale",
           "label_smooth", "log_loss", "add_position_encoding",
           "autoincreased_step_counter", "logical_and", "logical_or",
           "logical_xor", "logical_not"]


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
    """reference: layers/nn.py embedding → the v1 lookup_table op for ids
    of shape [..., 1], lookup_table_v2 for any other."""
    helper = LayerHelper("embedding", **locals())
    dtype = convert_np_dtype_to_dtype_(dtype)
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    ishape = list(input.shape)
    if ishape and ishape[-1] == 1:
        out.shape = tuple(ishape[:-1]) + (size[1],)
        op_type = "lookup_table"
    else:
        out.shape = tuple(ishape) + (size[1],)
        op_type = "lookup_table_v2"
    helper.append_op(type=op_type,
                     inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "remote_prefetch": False,
                            "padding_idx": pad})
    return out


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def _conv_out_size(i, k, p0, p1, s, d=1):
    if i < 0:
        return -1
    return (i + p0 + p1 - (d * (k - 1) + 1)) // s + 1


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """reference: layers/nn.py conv2d — the conv2d op (Filter OIHW, by
    default Normal(0, sqrt(2 / fan_in))), the bias over the channel axis,
    the activation. ``padding`` may be "SAME" or "VALID"."""
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    ksize = _pair(filter_size)
    stride = _pair(stride)
    dilation = _pair(dilation)
    pad_algo = "EXPLICIT"
    if isinstance(padding, str):
        pad_algo = padding.upper()
        padding = [0, 0]
    padding = _pair(padding)
    ch_axis = 1 if data_format == "NCHW" else 3
    num_channels = input.shape[ch_axis]
    w_shape = [num_filters, num_channels // groups] + ksize
    default_init = Normal(
        0.0, (2.0 / (num_channels // groups * math.prod(ksize))) ** 0.5)
    w = helper.create_parameter(attr=helper.param_attr, shape=w_shape,
                                dtype=dtype, default_initializer=default_init)
    out = helper.create_variable_for_type_inference(dtype)
    if data_format == "NCHW":
        h = _conv_out_size(input.shape[2], ksize[0], padding[0], padding[0],
                           stride[0], dilation[0])
        wd = _conv_out_size(input.shape[3], ksize[1], padding[1], padding[1],
                            stride[1], dilation[1])
        out.shape = (input.shape[0], num_filters, h, wd)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups, "use_cudnn": use_cudnn,
               "padding_algorithm": pad_algo, "data_format": data_format})
    pre_act = helper.append_bias_op(out, dim_start=ch_axis,
                                    dim_end=ch_axis + 1)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCHW"):
    """reference: layers/nn.py pool2d — max or avg pooling, or global."""
    helper = LayerHelper("pool2d", **locals())
    ksize = _pair(pool_size)
    stride = _pair(pool_stride)
    padding = _pair(pool_padding)
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    if global_pooling:
        out.shape = (input.shape[0], input.shape[1], 1, 1)
    elif data_format == "NCHW" and len(input.shape) == 4:
        h = _conv_out_size(input.shape[2], ksize[0], padding[0], padding[0],
                           stride[0])
        w = _conv_out_size(input.shape[3], ksize[1], padding[1], padding[1],
                           stride[1])
        out.shape = (input.shape[0], input.shape[1], h, w)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": ksize,
               "global_pooling": global_pooling, "strides": stride,
               "paddings": padding, "use_cudnn": use_cudnn,
               "ceil_mode": ceil_mode, "exclusive": exclusive,
               "data_format": data_format, "padding_algorithm": "EXPLICIT"})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    """reference: layers/nn.py batch_norm. The parameters in the TPU
    package's order (scale, bias, moving mean, moving variance), so they
    get the same names; the op writes the moving statistics (MeanOut,
    VarianceOut) into the vars it reads them from."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(attr=helper.param_attr, shape=[c],
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[c],
                                   dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, initializer=Constant(0.0),
                       trainable=False), shape=[c], dtype=dtype)
    mean.stop_gradient = True
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, initializer=Constant(1.0),
                       trainable=False), shape=[c], dtype=dtype)
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = (input if in_place
           else helper.create_variable_for_type_inference(dtype))
    out.shape = input.shape
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


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


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
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


def squeeze(input, axes, name=None):
    """reference: layers/nn.py squeeze → the squeeze2 op."""
    helper = LayerHelper("squeeze", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype,
                                                       stop_gradient=True)
    nd = max(len(input.shape), 1)
    out.shape = tuple(s for i, s in enumerate(input.shape)
                      if not (i in [a % nd for a in axes] and s == 1))
    helper.append_op(type="squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": axes})
    return out


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


def transpose(x, perm, name=None):
    """reference: layers/nn.py transpose → the transpose2 op."""
    helper = LayerHelper("transpose", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    if x.shape:
        out.shape = tuple(x.shape[p] for p in perm)
    helper.append_op(type="transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    """reference: layers/nn.py matmul."""
    helper = LayerHelper("matmul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    xs, ys = list(x.shape), list(y.shape)
    if len(xs) >= 2 and len(ys) >= 2:
        if transpose_x:
            xs[-1], xs[-2] = xs[-2], xs[-1]
        if transpose_y:
            ys[-1], ys[-2] = ys[-2], ys[-1]
        batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
        out.shape = tuple(batch + [xs[-2], ys[-1]])
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def flatten(x, axis=1, name=None):
    """reference: layers/nn.py flatten → the flatten2 op."""
    helper = LayerHelper("flatten", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    out.shape = (math.prod(x.shape[:axis]), math.prod(x.shape[axis:]))
    helper.append_op(type="flatten2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": axis})
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


def _reduce(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        dims = []
        reduce_all = True
        out.shape = (1,)
    else:
        dims = [dim] if isinstance(dim, int) else list(dim)
        reduce_all = len(dims) == len(input.shape)
        nd = [d % len(input.shape) for d in dims]
        if keep_dim:
            out.shape = tuple(1 if i in nd else s
                              for i, s in enumerate(input.shape))
        else:
            out.shape = tuple(s for i, s in enumerate(input.shape)
                              if i not in nd) or (1,)
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"dim": dims or [0], "keep_dim": keep_dim,
                            "reduce_all": reduce_all})
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def one_hot(input, depth, allow_out_of_range=False):
    """f32 one-hot rows of ids [..., 1] (the trailing 1 dropped); ``depth``
    may be a Variable."""
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference(VarDesc.VarType.FP32)
    shp = list(input.shape)
    if shp and shp[-1] == 1:
        shp = shp[:-1]
    out.shape = tuple(shp + [depth if not isinstance(depth, Variable)
                             else -1])
    inputs = {"X": [input]}
    attrs = {"allow_out_of_range": allow_out_of_range}
    if isinstance(depth, Variable):
        inputs["depth_tensor"] = [depth]
        attrs["depth"] = 1
    else:
        attrs["depth"] = depth
    helper.append_op(type="one_hot", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
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


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


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


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", **locals())
    out = helper.create_variable_for_type_inference(label.dtype)
    out.shape = label.shape
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]}, attrs={"epsilon": float(epsilon)})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    """The log_loss op: -l·log(p + ε) - (1 - l)·log(1 - p + ε), per row."""
    helper = LayerHelper("log_loss", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="log_loss",
                     inputs={"Predicted": [input], "Labels": [label]},
                     outputs={"Loss": [out]}, attrs={"epsilon": epsilon})
    return out


def add_position_encoding(input, alpha, beta, name=None):
    helper = LayerHelper("add_position_encoding", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="add_position_encoding", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"alpha": float(alpha), "beta": float(beta)})
    return out


def _logical(op_type, x, y, out=None, name=None):
    helper = LayerHelper(op_type, name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(VarDesc.VarType.BOOL)
        out.shape = x.shape
    ins = {"X": [x]} if y is None else {"X": [x], "Y": [y]}
    helper.append_op(type=op_type, inputs=ins, outputs={"Out": [out]})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical("logical_and", x, y, out, name)


def logical_or(x, y, out=None, name=None):
    return _logical("logical_or", x, y, out, name)


def logical_xor(x, y, out=None, name=None):
    return _logical("logical_xor", x, y, out, name)


def logical_not(x, out=None, name=None):
    return _logical("logical_not", x, None, out, name)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """An INT64 [1] persistable counter, ``begin - 1`` after the startup
    program, that an ``increment`` op placed first in the main program
    advances by ``step`` each run (so a run reads ``begin``, then
    ``begin + step``, ...). One counter a name: a second call returns it."""
    helper = LayerHelper("global_step_counter")
    counter_name = counter_name or "@STEP_COUNTER@"
    counter = helper.create_or_get_global_variable(
        name=counter_name, dtype=VarDesc.VarType.INT64, shape=[1],
        persistable=True)
    if not getattr(counter, "_step_init", False):
        helper.set_variable_initializer(counter, Constant(float(begin - 1)))
        counter._step_init = True
        helper.main_program.global_block()._prepend_op(
            type="increment", inputs={"X": [counter]},
            outputs={"Out": [counter]}, attrs={"step": float(step)})
        counter.stop_gradient = True
    return counter
