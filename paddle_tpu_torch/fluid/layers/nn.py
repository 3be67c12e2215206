"""Core NN layers (counterpart of paddle_tpu/fluid/layers/nn.py; reference:
python/paddle/fluid/layers/nn.py). Op-builder functions with inline shape
inference; -1 marks unknown dims. So far: fc, embedding, conv2d, pool2d,
batch_norm, layer_norm, dropout, softmax, reshape, squeeze, unsqueeze,
flatten, gather, topk, mean, reduce_sum, reduce_mean, one_hot,
elementwise_add, _sub, _mul, _div, _max, _min, _pow and _mod, scale,
clip, clip_by_norm, sign, pow, label_smooth, log_loss,
add_position_encoding, autoincreased_step_counter, the logical_*
layers, the parameterized activations (brelu, leaky_relu, soft_relu,
swish, hard_swish, elu, relu6, stanh, hard_sigmoid), lod_reset,
lod_append, im2sequence, cos_sim, the layers over the rest of
tensor_ops (split, stack, unstack, unbind, slice, strided_slice,
expand, expand_as, pad, pad2d, pad_constant_like, roll, gather_nd,
scatter, scatter_nd, scatter_nd_add, index_select, index_sample,
multiplex, where, shard_index, shape, size, rank, unique,
unique_with_counts, sampling_id and the *_random_batch_size_like pair),
linear_chain_crf and crf_decoding, and the vision and loss batch at the
end of the file (conv3d, conv2d_transpose, the 3-d and adaptive pools,
the other norms, the resizes, prelu, the nn_extra_ops layers, mean_iou,
py_func, ctc_greedy_decoder, ...), and the layers over vision_ops and
the RoI ops (conv3d_transpose, resize_trilinear, affine_grid, crop,
crop_tensor, deformable_conv, deformable_roi_pooling, inplace_abn,
prroi_pool, psroi_pool, similarity_focus, roi_pool, roi_align)."""
from __future__ import annotations

import math

import numpy as np

from ..core import VarDesc, convert_np_dtype_to_dtype_
from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import Constant, Normal
from ..param_attr import ParamAttr

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
           "dropout", "softmax", "reshape", "squeeze", "unsqueeze",
           "transpose", "matmul", "flatten", "gather", "topk", "mean",
           "reduce_sum", "reduce_mean", "one_hot", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min", "elementwise_pow",
           "elementwise_mod", "elementwise_floordiv", "scale", "clip",
           "clip_by_norm", "sign", "pow",
           "label_smooth", "log_loss", "add_position_encoding",
           "autoincreased_step_counter", "logical_and", "logical_or",
           "logical_xor", "logical_not", "brelu", "leaky_relu", "soft_relu",
           "swish", "hard_swish", "elu", "relu6", "stanh", "hard_sigmoid",
           "lod_reset", "lod_append", "im2sequence", "cos_sim", "mul", "sum",
           "reduce_max", "reduce_min", "reduce_prod", "reduce_all",
           "reduce_any", "uniform_random", "gaussian_random", "expand",
           "expand_as", "gather_nd", "gaussian_random_batch_size_like",
           "index_sample", "index_select", "multiplex", "pad", "pad2d",
           "pad_constant_like", "rank", "roll", "sampling_id", "scatter",
           "scatter_nd", "scatter_nd_add", "shape", "shard_index", "size",
           "slice", "split", "stack", "strided_slice", "unbind",
           "uniform_random_batch_size_like", "unique", "unique_with_counts",
           "unstack", "where", "linear_chain_crf", "crf_decoding"]


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


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_all", input, dim, keep_dim, name)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_any", input, dim, keep_dim, name)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """reference: layers/nn.py mul — X flattened to 2-D at
    ``x_num_col_dims`` times Y flattened at ``y_num_col_dims``."""
    helper = LayerHelper("mul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = tuple(list(x.shape[:x_num_col_dims])
                      + list(y.shape[y_num_col_dims:]))
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def sum(x):
    """reference: layers/nn.py sum — the ``sum`` op over a Variable or a
    list of them."""
    from .tensor import sums
    return sums(x if isinstance(x, (list, tuple)) else [x])


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    """reference: layers/nn.py uniform_random; no grad flows out."""
    helper = LayerHelper("uniform_random")
    dtype = convert_np_dtype_to_dtype_(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    if not any(isinstance(s, Variable) for s in shape):
        out.shape = tuple(int(s) for s in shape)
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape
                                      if not isinstance(s, Variable)],
                            "min": float(min), "max": float(max),
                            "seed": seed, "dtype": dtype})
    out.stop_gradient = True
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    """reference: layers/nn.py gaussian_random; no grad flows out."""
    helper = LayerHelper("gaussian_random")
    dtype = convert_np_dtype_to_dtype_(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = tuple(int(s) for s in shape)
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "mean": float(mean), "std": float(std),
                            "seed": seed, "dtype": dtype})
    out.stop_gradient = True
    return out


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


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mod", x, y, axis, act, name)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_floordiv", x, y, axis, act, name)


def clip(x, min, max, name=None):
    """x clipped to [min, max], elementwise."""
    helper = LayerHelper("clip", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    """x scaled down to L2 norm ``max_norm`` where its norm exceeds it."""
    helper = LayerHelper("clip_by_norm", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def _act_layer(op_type, x, attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs or {})
    return out


def sign(x):
    return _act_layer("sign", x)


def pow(x, factor=1.0, name=None):
    return _act_layer("pow", x, {"factor": factor}, name)


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


# --------------------------------------------------------------------------
# parameterized activations (the TPU package's layers/nn.py:1390-1432)
# --------------------------------------------------------------------------
def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _act_layer("brelu", x, {"t_min": t_min, "t_max": t_max}, name)


def leaky_relu(x, alpha=0.02, name=None):
    return _act_layer("leaky_relu", x, {"alpha": alpha}, name)


def soft_relu(x, threshold=40.0, name=None):
    return _act_layer("soft_relu", x, {"threshold": threshold}, name)


def swish(x, beta=1.0, name=None):
    return _act_layer("swish", x, {"beta": beta}, name)


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return _act_layer("hard_swish", x,
                      {"threshold": threshold, "scale": scale,
                       "offset": offset}, name)


def elu(x, alpha=1.0, name=None):
    return _act_layer("elu", x, {"alpha": alpha}, name)


def relu6(x, threshold=6.0, name=None):
    return _act_layer("relu6", x, {"threshold": threshold}, name)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _act_layer("stanh", x, {"scale_a": scale_a, "scale_b": scale_b},
                      name)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _act_layer("hard_sigmoid", x, {"slope": slope, "offset": offset},
                      name)


# --------------------------------------------------------------------------
# LoD layers (the TPU package's layers/nn.py:1053-1075, :1434, :1642)
# --------------------------------------------------------------------------
def lod_reset(x, y=None, target_lod=None):
    """reference: layers/nn.py lod_reset — data unchanged, LoD replaced."""
    if y is None and target_lod is None:
        raise ValueError("lod_reset: either y or target_lod should be set")
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    if y is not None:
        inputs["Y"] = [y]
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"target_lod": list(target_lod or [])})
    return out


def lod_append(x, level):
    helper = LayerHelper("lod_append")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="lod_append", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"level": list(level)})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    """reference: layers/nn.py im2sequence — image patches to a LoD
    sequence."""
    pads = [padding] * 4 if isinstance(padding, int) else list(padding)
    if len(pads) == 2:
        pads = pads * 2
    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="im2sequence", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"kernels": _pair(filter_size),
                            "strides": _pair(stride), "paddings": pads})
    return out


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim", **locals())
    out = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype)
    ynorm = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xnorm],
                              "YNorm": [ynorm]})
    return out


# --------------------------------------------------------------------------
# the layers over the rest of tensor_ops, and the linear-chain CRF pair
# --------------------------------------------------------------------------
def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    if not any(isinstance(t, Variable) for t in expand_times):
        out.shape = tuple(s * t if s > 0 else -1
                          for s, t in zip(x.shape, expand_times))
    helper.append_op(type="expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": [t if not isinstance(t, Variable)
                                             else -1 for t in expand_times]})
    return out


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = target_tensor.shape
    helper.append_op(type="expand_as",
                     inputs={"X": [x], "target_tensor": [target_tensor]},
                     outputs={"Out": [out]})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = tuple(list(index.shape[:-1])
                      + list(input.shape[index.shape[-1]:]))
    helper.append_op(type="gather_nd", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random_batch_size_like", **locals())
    out = helper.create_variable_for_type_inference(
        convert_np_dtype_to_dtype_(dtype))
    helper.append_op(type="gaussian_random_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "mean": float(mean),
                            "std": float(std), "seed": seed,
                            "dtype": convert_np_dtype_to_dtype_(dtype),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def index_sample(x, index):
    helper = LayerHelper("index_sample")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = index.shape
    helper.append_op(type="index_sample",
                     inputs={"X": [x], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def index_select(input, index, dim=0):
    helper = LayerHelper("index_select")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="index_select",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]}, attrs={"dim": dim})
    return out


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    out.shape = inputs[0].shape
    helper.append_op(type="multiplex",
                     inputs={"X": list(inputs), "Ids": [index]},
                     outputs={"Out": [out]})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = tuple(s + paddings[2 * i] + paddings[2 * i + 1]
                      if s >= 0 else -1
                      for i, s in enumerate(x.shape))
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pad2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": float(pad_value),
                            "data_format": data_format})
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    helper = LayerHelper("pad_constant_like", **locals())
    out = helper.create_variable_for_type_inference(y.dtype)
    out.shape = x.shape
    helper.append_op(type="pad_constant_like",
                     inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
                     attrs={"pad_value": float(pad_value)})
    return out


def rank(input):
    from .tensor import assign
    return assign(np.asarray([len(input.shape)], np.int32))


def roll(input, shifts, dims=None):
    helper = LayerHelper("roll")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="roll", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"shifts": shifts if isinstance(shifts, list)
                            else [shifts],
                            "dims": dims if isinstance(dims, list)
                            else ([dims] if dims is not None else [])})
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id", **locals())
    out = helper.create_variable_for_type_inference(VarDesc.VarType.INT64)
    out.shape = tuple(x.shape[:-1])  # one drawn id per distribution row
    helper.append_op(type="sampling_id", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"min": min, "max": max, "seed": seed})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def scatter_nd(index, updates, shape, name=None):
    from .tensor import fill_constant
    zero = fill_constant(shape, updates.dtype, 0.0)
    return scatter_nd_add(zero, index, updates, name)


def scatter_nd_add(ref, index, updates, name=None):
    helper = LayerHelper("scatter_nd_add", **locals())
    out = helper.create_variable_for_type_inference(ref.dtype)
    out.shape = ref.shape
    helper.append_op(type="scatter_nd_add",
                     inputs={"X": [ref], "Index": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(VarDesc.VarType.INT32)
    out.shape = (len(input.shape),)
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    out.stop_gradient = True
    return out


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    helper = LayerHelper("shard_index")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="shard_index", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"index_num": index_num, "nshards": nshards,
                            "shard_id": shard_id,
                            "ignore_value": ignore_value})
    return out


def size(input):
    helper = LayerHelper("size")
    out = helper.create_variable_for_type_inference(VarDesc.VarType.INT64)
    helper.append_op(type="size", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    shp = list(input.shape)
    ok = all(not isinstance(s, Variable) for s in list(starts) + list(ends))
    if ok:
        for ax, s, e in zip(axes, starts, ends):
            if shp[ax] < 0:
                continue
            d = shp[ax]
            s2 = max(s + d, 0) if s < 0 else min(s, d)
            e2 = max(e + d, 0) if e < 0 else min(e, d)
            shp[ax] = max(e2 - s2, 0)
        out.shape = tuple(shp)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends), "decrease_axis": [],
                            "infer_flags": [1] * len(axes)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", **locals())
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        sections = []
        sizes = ([input.shape[dim] // n] * n if input.shape[dim] > 0
                 else [-1] * n)
    else:
        sections = list(num_or_sections)
        n = len(sections)
        sizes = sections
    outs = []
    for i in range(n):
        o = helper.create_variable_for_type_inference(input.dtype)
        shp = list(input.shape)
        shp[dim] = sizes[i] if not isinstance(sizes[i], Variable) else -1
        o.shape = tuple(shp)
        outs.append(o)
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": dim, "num": 0 if sections else n,
                            "sections": [s if not isinstance(s, Variable)
                                         else -1 for s in sections]})
    return outs


def stack(x, axis=0):
    helper = LayerHelper("stack")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    shp = list(x[0].shape)
    shp.insert(axis if axis >= 0 else len(shp) + axis + 1, len(x))
    out.shape = tuple(shp)
    helper.append_op(type="stack", inputs={"X": list(x)},
                     outputs={"Y": [out]}, attrs={"axis": axis})
    return out


def strided_slice(input, axes, starts, ends, strides):
    helper = LayerHelper("strided_slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="strided_slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends), "strides": list(strides),
                            "decrease_axis": [],
                            "infer_flags": [1] * len(axes)})
    return out


def unbind(input, axis=0):
    helper = LayerHelper("unbind")
    num = input.shape[axis]
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(num)]
    helper.append_op(type="unbind", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs={"axis": axis})
    return outs


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like", **locals())
    out = helper.create_variable_for_type_inference(
        convert_np_dtype_to_dtype_(dtype))
    helper.append_op(type="uniform_random_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "min": float(min),
                            "max": float(max), "seed": seed,
                            "dtype": convert_np_dtype_to_dtype_(dtype),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def unique(x, dtype="int32"):
    helper = LayerHelper("unique")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(
        convert_np_dtype_to_dtype_(dtype))
    helper.append_op(type="unique", inputs={"X": [x]},
                     outputs={"Out": [out], "Index": [index]},
                     attrs={"dtype": convert_np_dtype_to_dtype_(dtype)})
    return out, index


def unique_with_counts(x, dtype="int32"):
    helper = LayerHelper("unique_with_counts")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(
        convert_np_dtype_to_dtype_(dtype))
    count = helper.create_variable_for_type_inference(
        convert_np_dtype_to_dtype_(dtype))
    helper.append_op(type="unique_with_counts", inputs={"X": [x]},
                     outputs={"Out": [out], "Index": [index],
                              "Count": [count]},
                     attrs={"dtype": convert_np_dtype_to_dtype_(dtype)})
    return out, index, count


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    if num is None:
        num = x.shape[axis]
    outs = []
    for _ in range(num):
        o = helper.create_variable_for_type_inference(x.dtype)
        shp = list(x.shape)
        shp.pop(axis if axis >= 0 else len(shp) + axis)
        o.shape = tuple(shp)
        outs.append(o)
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def where(condition):
    helper = LayerHelper("where_index")
    out = helper.create_variable_for_type_inference(VarDesc.VarType.INT64)
    helper.append_op(type="where_index", inputs={"Condition": [condition]},
                     outputs={"Out": [out]})
    return out


def linear_chain_crf(input, label, param_attr=None, length=None):
    """reference: layers/nn.py linear_chain_crf — CRF NLL; Transition rows
    [start; end; tags x tags]."""
    helper = LayerHelper("linear_chain_crf", **locals())
    dtype = helper.input_dtype()
    num_tags = input.shape[-1]
    transition = helper.create_parameter(attr=param_attr,
                                         shape=[num_tags + 2, num_tags],
                                         dtype=dtype)
    ll = helper.create_variable_for_type_inference(dtype)
    alpha = helper.create_variable_for_type_inference(dtype)
    e_exps = helper.create_variable_for_type_inference(dtype)
    t_exps = helper.create_variable_for_type_inference(dtype)
    ll.shape = (-1, 1)
    helper.append_op(
        type="linear_chain_crf",
        inputs={"Emission": [input], "Transition": [transition],
                "Label": [label]},
        outputs={"LogLikelihood": [ll], "Alpha": [alpha],
                 "EmissionExps": [e_exps], "TransitionExps": [t_exps]})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    from ..core import VarDesc
    helper = LayerHelper("crf_decoding", **locals())
    transition = helper.get_parameter(param_attr.name)
    path = helper.create_variable_for_type_inference(
        VarDesc.VarType.INT64)
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path]})
    return path


# --------------------------------------------------------------------------
# the vision and loss batch: the layers over nn_ops' convolutions, pools,
# norms and resizes, math_ops' prelu, nn_extra_ops, loss_extra_ops'
# grid_sampler, spectral_norm, random_crop and ctc_align, and py_func.
# As in the TPU package, conv3d, conv2d_transpose, pool3d and pad2d give
# their output no static shape: a layer that reads one (a norm's channel
# count, a bias's size) needs a ``reshape`` to it first.
# --------------------------------------------------------------------------
def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCDHW"):
    """reference: layers/nn.py conv3d — the conv3d op (Filter OIDHW), the
    bias over dim 1, the activation."""
    helper = LayerHelper("conv3d", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    ksize = _pair(filter_size, 3)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_filters, input.shape[1] // groups] + ksize, dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv3d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": _pair(stride, 3), "paddings": _pair(padding, 3),
               "dilations": _pair(dilation, 3), "groups": groups,
               "use_cudnn": use_cudnn, "padding_algorithm": "EXPLICIT",
               "data_format": data_format})
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCHW"):
    """reference: layers/nn.py conv2d_transpose — the transposed conv
    (Filter [in_c, num_filters/g, kh, kw]); without ``filter_size`` the
    kernel is what makes ``output_size``."""
    helper = LayerHelper("conv2d_transpose", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    stride = _pair(stride)
    dilation = _pair(dilation)
    padding = _pair(padding)
    if filter_size is None:
        if output_size is None:
            raise ValueError("conv2d_transpose needs output_size or "
                             "filter_size")
        output_size = _pair(output_size)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i]
             + 2 * padding[i] - 1) // dilation[i] + 1 for i in (0, 1)]
    else:
        filter_size = _pair(filter_size)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[input.shape[1], num_filters // groups] + filter_size,
        dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups, "use_cudnn": use_cudnn,
               "output_size": list(_pair(output_size)) if output_size
               else [],
               "padding_algorithm": "EXPLICIT", "data_format": data_format})
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCDHW"):
    helper = LayerHelper("pool3d", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(
        type="pool3d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size, 3),
               "global_pooling": global_pooling,
               "strides": _pair(pool_stride, 3),
               "paddings": _pair(pool_padding, 3), "use_cudnn": use_cudnn,
               "ceil_mode": ceil_mode, "exclusive": exclusive,
               "data_format": data_format, "padding_algorithm": "EXPLICIT"})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """pool2d with ``adaptive``: bins that divide the input."""
    helper = LayerHelper("adaptive_pool2d", **locals())
    ksize = _pair(pool_size)
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    out.shape = (input.shape[0], input.shape[1], ksize[0], ksize[1])
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": ksize, "adaptive": True,
               "strides": [1, 1], "paddings": [0, 0],
               "global_pooling": False, "data_format": "NCHW",
               "padding_algorithm": "EXPLICIT"})
    return out


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """pool3d with ``adaptive``, or with ``require_index``
    max_pool3d_with_index and its Mask."""
    helper = LayerHelper("adaptive_pool3d", **locals())
    ksize = _pair(pool_size, 3)
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    out.shape = (input.shape[0], input.shape[1]) + tuple(ksize)
    if require_index:
        if pool_type != "max":
            raise ValueError("require_index needs pool_type='max'")
        mask = helper.create_variable_for_type_inference(
            VarDesc.VarType.INT32)
        mask.shape = out.shape
        helper.append_op(
            type="max_pool3d_with_index", inputs={"X": [input]},
            outputs={"Out": [out], "Mask": [mask]},
            attrs={"ksize": ksize, "adaptive": True,
                   "strides": [1, 1, 1], "paddings": [0, 0, 0]})
        return out, mask
    helper.append_op(
        type="pool3d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": ksize, "adaptive": True,
               "strides": [1, 1, 1], "paddings": [0, 0, 0],
               "global_pooling": False, "data_format": "NCDHW",
               "padding_algorithm": "EXPLICIT"})
    return out


def _norm_outputs(helper, dtype, input, names):
    outs = {n: [helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)] for n in names}
    y = helper.create_variable_for_type_inference(dtype)
    y.shape = input.shape
    return y, outs


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    """reference: layers/nn.py instance_norm — a scale (ones) and a bias
    over dim 1."""
    helper = LayerHelper("instance_norm", **locals())
    dtype = helper.input_dtype()
    c = input.shape[1]
    scale = helper.create_parameter(attr=helper.param_attr, shape=[c],
                                    dtype=dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[c],
                                   dtype=dtype, is_bias=True)
    out, outs = _norm_outputs(helper, dtype, input,
                              ("SavedMean", "SavedVariance"))
    helper.append_op(type="instance_norm",
                     inputs={"X": [input], "Scale": [scale], "Bias": [bias]},
                     outputs=dict(outs, Y=[out]), attrs={"epsilon": epsilon})
    return out


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    """reference: layers/nn.py group_norm — ``param_attr`` / ``bias_attr``
    False leave the scale / bias out."""
    helper = LayerHelper("group_norm", **locals())
    dtype = helper.input_dtype()
    c = input.shape[1]
    inputs = {"X": [input]}
    if param_attr is not False:
        inputs["Scale"] = [helper.create_parameter(
            attr=helper.param_attr, shape=[c], dtype=dtype,
            default_initializer=Constant(1.0))]
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[c], dtype=dtype, is_bias=True)]
    out, outs = _norm_outputs(helper, dtype, input, ("Mean", "Variance"))
    helper.append_op(type="group_norm", inputs=inputs,
                     outputs=dict(outs, Y=[out]),
                     attrs={"epsilon": epsilon, "groups": groups,
                            "data_layout": data_layout})
    return helper.append_activation(out)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True):
    """reference: layers/nn.py data_norm — BatchSize and BatchSquareSum
    start at 1e4, BatchSum at 0."""
    helper = LayerHelper("data_norm", **locals())
    dtype = helper.input_dtype()
    c = input.shape[-1]
    stats = {slot: helper.create_parameter(
        attr=ParamAttr(initializer=Constant(v)), shape=[c], dtype=dtype)
        for slot, v in (("BatchSize", 1e4), ("BatchSum", 0.0),
                        ("BatchSquareSum", 1e4))}
    out, outs = _norm_outputs(helper, dtype, input, ("Means", "Scales"))
    helper.append_op(type="data_norm",
                     inputs=dict({k: [v] for k, v in stats.items()},
                                 X=[input]),
                     outputs=dict(outs, Y=[out]), attrs={"epsilon": epsilon})
    return helper.append_activation(out)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None,
        data_format="NCHW"):
    helper = LayerHelper("lrn", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta,
                            "data_format": data_format})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """x / √(Σ x² + ε) along ``axis`` (the norm op)."""
    helper = LayerHelper("l2_normalize", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="norm", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": 1 if axis is None else axis,
                            "epsilon": epsilon})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1, data_format="NCHW"):
    """reference: layers/nn.py image_resize — bilinear_interp,
    nearest_interp or trilinear_interp to ``out_shape`` (a list, or a
    Variable read on the host at run time) or by ``scale``. As in the TPU
    package, ``resample`` has no BICUBIC (a KeyError there and here),
    and TRILINEAR takes the 2-d sizes (out_h, out_w)."""
    helper = LayerHelper("image_resize", **locals())
    op_type = {"BILINEAR": "bilinear_interp", "NEAREST": "nearest_interp",
               "TRILINEAR": "trilinear_interp"}[resample.upper()]
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"align_corners": align_corners, "align_mode": align_mode,
             "interp_method": op_type.split("_")[0],
             "data_layout": data_format}
    inputs = {"X": [input]}
    if out_shape is not None:
        if isinstance(out_shape, Variable):
            inputs["OutSize"] = [out_shape]
            attrs.update({"out_h": -1, "out_w": -1, "scale": 0.0})
        else:
            attrs.update({"out_h": int(out_shape[0]),
                          "out_w": int(out_shape[1]), "scale": 0.0})
            out.shape = (input.shape[0], input.shape[1],
                         int(out_shape[0]), int(out_shape[1]))
    else:
        attrs.update({"out_h": -1, "out_w": -1, "scale": float(scale)})
    helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


interpolate = image_resize


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1,
                    data_format="NCHW"):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        actual_shape, align_corners, align_mode, data_format)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True, data_format="NCHW"):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        actual_shape, align_corners, 1, data_format)


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     actual_shape=None, align_corners=True, align_mode=1,
                     data_format="NCDHW"):
    helper = LayerHelper("resize_trilinear", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"align_corners": align_corners, "align_mode": align_mode,
             "interp_method": "trilinear", "data_layout": data_format}
    inputs = {"X": [input]}
    if out_shape is not None:
        if isinstance(out_shape, Variable):
            inputs["OutSize"] = [out_shape]
            attrs.update({"out_d": -1, "out_h": -1, "out_w": -1,
                          "scale": 0.0})
        else:
            attrs.update({"out_d": int(out_shape[0]),
                          "out_h": int(out_shape[1]),
                          "out_w": int(out_shape[2]), "scale": 0.0})
            out.shape = (input.shape[0], input.shape[1]) + tuple(
                int(s) for s in out_shape)
    else:
        attrs.update({"out_d": -1, "out_h": -1, "out_w": -1,
                      "scale": float(scale)})
    helper.append_op(type="trilinear_interp", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize so that the short side is ``out_short_len``, keeping the
    aspect (the long side rounded)."""
    hw = list(input.shape[2:4])
    short = hw.index(min(hw))
    out_shape = list(hw)
    out_shape[short] = out_short_len
    out_shape[1 - short] = int(round(hw[1 - short] * out_short_len
                                     / hw[short]))
    return image_resize(input, out_shape=out_shape, resample=resample)


def _one_op(op_type, ins, attrs=None, out_slot="Out", shape=None,
            dtype=None, name=None):
    """One op of ``op_type`` with one new output, in the dtype of the
    first input (or ``dtype``) and with ``shape`` if given."""
    helper = LayerHelper(op_type, name=name)
    first_in = next(iter(ins.values()))[0]
    out = helper.create_variable_for_type_inference(dtype or first_in.dtype)
    if shape is not None:
        out.shape = tuple(shape)
    helper.append_op(type=op_type, inputs=ins, outputs={out_slot: [out]},
                     attrs=attrs or {})
    return out


def pixel_shuffle(x, upscale_factor):
    return _one_op("pixel_shuffle", {"X": [x]},
                   {"upscale_factor": upscale_factor})


def space_to_depth(x, blocksize, name=None):
    return _one_op("space_to_depth", {"X": [x]}, {"blocksize": blocksize},
                   name=name)


def shuffle_channel(x, group, name=None):
    return _one_op("shuffle_channel", {"X": [x]}, {"group": group},
                   shape=x.shape, name=name)


def maxout(x, groups, name=None, axis=1):
    return _one_op("maxout", {"X": [x]}, {"groups": groups, "axis": axis},
                   name=name)


def fsp_matrix(x, y):
    return _one_op("fsp", {"X": [x], "Y": [y]})


def continuous_value_model(input, cvm, use_cvm=True):
    return _one_op("cvm", {"X": [input], "CVM": [cvm]}, {"use_cvm": use_cvm},
                   out_slot="Y")


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _one_op("temporal_shift", {"X": [x]},
                   {"seg_num": seg_num, "shift_ratio": shift_ratio},
                   shape=x.shape, name=name)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return _one_op("unfold", {"X": [x]},
                   {"kernel_sizes": _pair(kernel_sizes),
                    "strides": _pair(strides),
                    "paddings": _pair(paddings, 4)
                    if isinstance(paddings, int) else list(paddings),
                    "dilations": _pair(dilations)}, out_slot="Y", name=name)


def grid_sampler(x, grid, name=None):
    return _one_op("grid_sampler", {"X": [x], "Grid": [grid]},
                   out_slot="Output", shape=x.shape, name=name)


def random_crop(x, shape, seed=None):
    return _one_op("random_crop", {"X": [x]},
                   {"shape": list(shape), "seed": int(seed) if seed else 0})


def prelu(x, mode, param_attr=None, name=None):
    """x where x > 0, else α·x: α one scalar (``all``), one a channel
    (``channel``) or one an element (``element``), 0.25 at first."""
    helper = LayerHelper("prelu", **locals())
    alpha_shape = {"channel": [x.shape[1]],
                   "element": list(x.shape[1:])}.get(mode, [1])
    alpha = helper.create_parameter(attr=helper.param_attr,
                                    shape=alpha_shape, dtype=x.dtype,
                                    default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None,
                   act=None):
    helper = LayerHelper("affine_channel", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="affine_channel",
                     inputs={"X": [x], "Scale": [scale], "Bias": [bias]},
                     outputs={"Out": [out]},
                     attrs={"data_layout": data_layout})
    return helper.append_activation(out)


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None,
                            bias_attr=None):
    """out[:, k] = xᵀ·W[k]·y (+ a [1, size] bias)."""
    helper = LayerHelper("bilinear_tensor_product", **locals())
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, x.shape[1], y.shape[1]],
                                dtype=x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = (x.shape[0], size)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if helper.bias_attr:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[1, size], dtype=x.dtype,
            is_bias=True)]
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", **locals())
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[future_context_size + 1, input.shape[-1]], dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="row_conv", inputs={"X": [input], "Filter": [w]},
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """weight / σ with U and V, Normal(0, 1) vectors that take no grad."""
    helper = LayerHelper("spectral_norm", **locals())
    dtype = weight.dtype
    h = weight.shape[dim]
    w_dims = math.prod(d for i, d in enumerate(weight.shape) if i != dim)
    u, v = (helper.create_parameter(attr=None, shape=[n], dtype=dtype,
                                    default_initializer=Normal(0.0, 1.0))
            for n in (h, w_dims))
    u.stop_gradient = v.stop_gradient = True
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = weight.shape
    helper.append_op(type="spectral_norm",
                     inputs={"Weight": [weight], "U": [u], "V": [v]},
                     outputs={"Out": [out]},
                     attrs={"dim": dim, "power_iters": power_iters,
                            "eps": eps})
    return out


def mean_iou(input, label, num_classes):
    """(mean IoU f32 [1], wrong int32 [k], correct int32 [k])."""
    helper = LayerHelper("mean_iou")
    iou = helper.create_variable_for_type_inference(VarDesc.VarType.FP32)
    wrong, correct = (helper.create_variable_for_type_inference(
        VarDesc.VarType.INT32) for _ in range(2))
    helper.append_op(type="mean_iou",
                     inputs={"Predictions": [input], "Labels": [label]},
                     outputs={"OutMeanIou": [iou], "OutWrong": [wrong],
                              "OutCorrect": [correct]},
                     attrs={"num_classes": num_classes})
    return iou, wrong, correct


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_variable_for_type_inference(x.dtype)
    loss = helper.create_variable_for_type_inference(x.dtype)
    loss.shape = (x.shape[0], 1)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": [diff], "Out": [loss]},
                     attrs={"sigma": sigma if sigma is not None else 1.0})
    return loss


def dice_loss(input, label, epsilon=1e-5):
    """1 − 2·|X∩Y| / (|X| + |Y| + ε) a sample, over the one-hot label,
    averaged."""
    label = one_hot(label, depth=input.shape[-1])
    dims = list(range(1, len(input.shape)))
    inse = reduce_sum(input * label, dim=dims)
    denom = reduce_sum(input, dim=dims) + reduce_sum(label, dim=dims)
    return mean(1 - inse * 2 / (denom + epsilon))


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """An op that calls ``func`` on x's values as numpy arrays on the host
    and writes its results to ``out`` (Variables made by the caller).
    ``backward_func`` is recorded but never called: the op has no grad,
    as in the TPU package."""
    from .py_func_registry import register_callable
    helper = LayerHelper("py_func")
    fid = register_callable(func)
    bid = register_callable(backward_func) if backward_func else -1
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    helper.append_op(type="py_func", inputs={"X": list(xs)},
                     outputs={"Out": list(outs)},
                     attrs={"forward_callable_id": fid,
                            "backward_callable_id": bid})
    return out


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    """Greedy CTC decode: each step's top class (topk), then ctc_align
    merges repeats and drops blanks (reference: layers/nn.py
    ctc_greedy_decoder). LoD mode (no ``input_length``): LoD [T, C] in,
    LoD [Tout, 1] ids out. Padding mode: [N, T, C] and its lengths [N, 1]
    in, (padded ids [N, T], their lengths [N, 1]) out."""
    helper = LayerHelper("ctc_greedy_decoder", **locals())
    _, idx = topk(input, k=1)
    ctc_out = helper.create_variable_for_type_inference(
        VarDesc.VarType.INT64)
    if input_length is None:
        helper.append_op(type="ctc_align", inputs={"Input": [idx]},
                         outputs={"Output": [ctc_out]},
                         attrs={"merge_repeated": True, "blank": blank})
        ctc_out.shape = (-1, 1)
        return ctc_out
    ctc_out_len = helper.create_variable_for_type_inference(
        VarDesc.VarType.INT64)
    helper.append_op(type="ctc_align",
                     inputs={"Input": [squeeze(idx, [2])],
                             "InputLength": [input_length]},
                     outputs={"Output": [ctc_out],
                              "OutputLength": [ctc_out_len]},
                     attrs={"merge_repeated": True, "blank": blank,
                            "padding_value": padding_value})
    ctc_out.shape = tuple(input.shape[:-1])
    ctc_out_len.shape = (-1, 1)
    return ctc_out, ctc_out_len


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_lod=None):
    helper = LayerHelper("roi_pool", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    argmax = helper.create_variable_for_type_inference(VarDesc.VarType.INT32)
    out.shape = (-1, input.shape[1], pooled_height, pooled_width)
    helper.append_op(type="roi_pool",
                     inputs={"X": [input], "ROIs": [rois]},
                     outputs={"Out": [out], "Argmax": [argmax]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, name=None,
              rois_lod=None):
    helper = LayerHelper("roi_align", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = (-1, input.shape[1], pooled_height, pooled_width)
    helper.append_op(type="roi_align",
                     inputs={"X": [input], "ROIs": [rois]},
                     outputs={"Out": [out]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale,
                            "sampling_ratio": sampling_ratio})
    return out


def crop(x, shape=None, offsets=None, name=None):
    return crop_tensor(x, shape, offsets, name)


def crop_tensor(x, shape=None, offsets=None, name=None):
    helper = LayerHelper("crop_tensor", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    attrs = {}
    if isinstance(shape, (list, tuple)):
        attrs["shape"] = [int(s) for s in shape]
        out.shape = tuple(attrs["shape"])
    if isinstance(offsets, (list, tuple)):
        attrs["offsets"] = [int(o) for o in offsets]
    elif offsets is None:
        attrs["offsets"] = [0] * len(x.shape)
    helper.append_op(type="crop_tensor", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def similarity_focus(input, axis, indexes, name=None):
    helper = LayerHelper("similarity_focus", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="similarity_focus", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"axis": axis, "indexes": list(indexes)})
    return out


def inplace_abn(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
                param_attr=None, bias_attr=None, data_layout="NCHW",
                name=None, moving_mean_name=None, moving_variance_name=None,
                do_model_average_for_mean_and_var=True,
                use_global_stats=False, act_alpha=1.0):
    """batch_norm fused with an in-place activation (reference
    inplace_abn_op.cc; memory aliasing is XLA's concern on TPU)."""
    helper = LayerHelper("inplace_abn", **locals())
    dtype = helper.input_dtype()
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale_p = helper.create_parameter(attr=helper.param_attr, shape=[c],
                                      dtype=dtype,
                                      default_initializer=Constant(1.0))
    bias_p = helper.create_parameter(attr=helper.bias_attr, shape=[c],
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
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(
        type="inplace_abn",
        inputs={"X": [input], "Scale": [scale_p], "Bias": [bias_p],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats,
               "activation": act or "identity", "alpha": act_alpha})
    return out


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCDHW"):
    helper = LayerHelper("conv3d_transpose", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    stride = _pair(stride, 3)
    dilation = _pair(dilation, 3)
    padding = _pair(padding, 3)
    in_c = input.shape[1]
    if filter_size is None:
        assert output_size is not None
        output_size = _pair(output_size, 3)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i]
             + 2 * padding[i] - 1) // dilation[i] + 1 for i in (0, 1, 2)]
    else:
        filter_size = _pair(filter_size, 3)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[in_c, num_filters // groups] + list(filter_size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = (input.shape[0], num_filters) + tuple(
        output_size if output_size else (
            (input.shape[2 + i] - 1) * stride[i] - 2 * padding[i]
            + dilation[i] * (filter_size[i] - 1) + 1 for i in (0, 1, 2)))
    helper.append_op(
        type="conv3d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups, "use_cudnn": use_cudnn,
               "output_size": list(_pair(output_size, 3)) if output_size
               else [],
               "padding_algorithm": "EXPLICIT", "data_format": data_format})
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def affine_grid(theta, out_shape, name=None):
    helper = LayerHelper("affine_grid", **locals())
    out = helper.create_variable_for_type_inference(theta.dtype)
    inputs = {"Theta": [theta]}
    attrs = {"align_corners": True}
    if isinstance(out_shape, Variable):
        inputs["OutputShape"] = [out_shape]
    else:
        attrs["output_shape"] = [int(s) for s in out_shape]
        out.shape = (out_shape[0], out_shape[2], out_shape[3], 2)
    helper.append_op(type="affine_grid", inputs=inputs,
                     outputs={"Output": [out]}, attrs=attrs)
    return out


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, name=None):
    helper = LayerHelper("psroi_pool", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = (-1, output_channels, pooled_height, pooled_width)
    helper.append_op(type="psroi_pool",
                     inputs={"X": [input], "ROIs": [rois]},
                     outputs={"Out": [out]},
                     attrs={"output_channels": output_channels,
                            "spatial_scale": spatial_scale,
                            "pooled_height": pooled_height,
                            "pooled_width": pooled_width})
    return out


def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,
               pooled_width=1, batch_roi_nums=None, name=None):
    helper = LayerHelper("prroi_pool", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if batch_roi_nums is not None:
        inputs["BatchRoINums"] = [batch_roi_nums]
    out.shape = (-1, input.shape[1], pooled_height, pooled_width)
    helper.append_op(type="prroi_pool", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"spatial_scale": spatial_scale,
                            "pooled_height": pooled_height,
                            "pooled_width": pooled_width})
    return out


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=None,
                    deformable_groups=None, im2col_step=None,
                    param_attr=None, bias_attr=None, modulated=True,
                    name=None):
    helper = LayerHelper("deformable_conv", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    deformable_groups = deformable_groups or 1
    filter_size = _pair(filter_size)
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=[num_filters, input.shape[1] // groups] + list(filter_size),
        dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    out.shape = (input.shape[0], num_filters) + tuple(
        (input.shape[2 + i] + 2 * pd[i] - (dl[i] * (filter_size[i] - 1) + 1))
        // st[i] + 1 for i in (0, 1))
    attrs = {"strides": _pair(stride), "paddings": _pair(padding),
             "dilations": _pair(dilation), "groups": groups,
             "deformable_groups": deformable_groups,
             "im2col_step": im2col_step or 64}
    if modulated and mask is None:
        raise ValueError(
            "deformable_conv: mask is required when modulated=True "
            "(pass modulated=False for the v1 op)")
    if modulated:
        helper.append_op(
            type="deformable_conv",
            inputs={"Input": [input], "Offset": [offset], "Mask": [mask],
                    "Filter": [w]},
            outputs={"Output": [out]}, attrs=attrs)
    else:
        helper.append_op(
            type="deformable_conv_v1",
            inputs={"Input": [input], "Offset": [offset], "Filter": [w]},
            outputs={"Output": [out]}, attrs=attrs)
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=[1, 1],
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1, position_sensitive=False,
                           name=None):
    helper = LayerHelper("deformable_roi_pooling", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    top_count = helper.create_variable_for_type_inference(input.dtype)
    part_size = part_size or [pooled_height, pooled_width]
    output_dim = (input.shape[1] // (group_size[0] * group_size[1])
                  if position_sensitive else input.shape[1])
    helper.append_op(
        type="deformable_psroi_pooling",
        inputs={"Input": [input], "ROIs": [rois], "Trans": [trans]},
        outputs={"Output": [out], "TopCount": [top_count]},
        attrs={"no_trans": no_trans, "spatial_scale": spatial_scale,
               "output_dim": output_dim, "group_size": list(group_size),
               "pooled_height": pooled_height, "pooled_width": pooled_width,
               "part_size": list(part_size),
               "sample_per_part": sample_per_part, "trans_std": trans_std})
    return out


__all__ += [
    "conv3d", "conv2d_transpose", "pool3d", "adaptive_pool2d",
    "adaptive_pool3d", "instance_norm", "group_norm", "data_norm", "lrn",
    "l2_normalize", "image_resize", "interpolate", "resize_bilinear",
    "resize_nearest", "resize_trilinear", "image_resize_short",
    "pixel_shuffle", "space_to_depth", "shuffle_channel", "maxout",
    "fsp_matrix", "continuous_value_model", "temporal_shift", "unfold",
    "grid_sampler", "random_crop", "prelu", "affine_channel",
    "bilinear_tensor_product", "row_conv", "spectral_norm", "mean_iou",
    "smooth_l1", "dice_loss", "py_func", "ctc_greedy_decoder",
    "conv3d_transpose", "affine_grid", "crop", "crop_tensor",
    "deformable_conv", "deformable_roi_pooling", "inplace_abn",
    "prroi_pool", "psroi_pool", "similarity_focus", "roi_pool",
    "roi_align"]
