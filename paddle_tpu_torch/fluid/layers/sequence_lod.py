"""Sequence layers over LoD tensors (counterpart of
paddle_tpu/fluid/layers/sequence_lod.py; reference:
python/paddle/fluid/layers/sequence_lod.py): the packed rows are the
tensor, the LoD host-side metadata the executor carries next to it
(ops/sequence_ops.py)."""
from __future__ import annotations

from ..core import VarDesc
from ..layer_helper import LayerHelper

__all__ = [
    "sequence_conv", "sequence_softmax", "sequence_pool", "sequence_concat",
    "sequence_first_step", "sequence_last_step", "sequence_slice",
    "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_reshape", "sequence_scatter",
    "sequence_enumerate", "sequence_mask", "sequence_reverse",
]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    from ..core import convert_np_dtype_to_dtype_
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(
        convert_np_dtype_to_dtype_(dtype))
    inputs = {"X": [x]}
    attrs = {"out_dtype": convert_np_dtype_to_dtype_(dtype)}
    if maxlen is not None and not isinstance(maxlen, (int,)):
        inputs["MaxLenTensor"] = [maxlen]
        attrs["maxlen"] = -1
    else:
        attrs["maxlen"] = maxlen if maxlen is not None else -1
    helper.append_op(type="sequence_mask", inputs=inputs,
                     outputs={"Y": [out]}, attrs=attrs)
    return out


def _simple(op_type, x, out_slot="Out", extra_inputs=None, **attrs):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    # sequence ops keep the feature dims; the row count is LoD-dynamic.
    # Without this, downstream builders (concat width -> fc weight
    # shapes) silently see () and create wrong parameters.
    if x.shape:
        out.shape = (-1,) + tuple(x.shape[1:])
    inputs = {"X": [x]}
    if extra_inputs:
        inputs.update(extra_inputs)
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={out_slot: [out]}, attrs=attrs)
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None):
    """reference: layers/sequence_lod.py sequence_conv."""
    helper = LayerHelper("sequence_conv", **locals())
    dtype = helper.input_dtype()
    in_dim = input.shape[-1]
    filter_shape = [filter_size * in_dim, num_filters]
    filter_param = helper.create_parameter(attr=param_attr,
                                           shape=filter_shape, dtype=dtype)
    if padding_start is None:
        padding_start = -int(filter_size // 2)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    pre_bias.shape = tuple(input.shape[:-1]) + (num_filters,)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [pre_bias]},
        attrs={"contextStride": filter_stride, "contextStart": padding_start,
               "contextLength": filter_size})
    pre_act = helper.append_bias_op(pre_bias)
    return helper.append_activation(pre_act)


def sequence_softmax(input, use_cudnn=False, name=None):
    return _simple("sequence_softmax", input)


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0):
    helper = LayerHelper("sequence_pool")
    pool_out = helper.create_variable_for_type_inference(input.dtype)
    pool_out.shape = tuple(input.shape)
    max_index = helper.create_variable_for_type_inference(
        VarDesc.VarType.INT32)
    helper.append_op(type="sequence_pool",
                     inputs={"X": [input]},
                     outputs={"Out": [pool_out], "MaxIndex": [max_index]},
                     attrs={"pooltype": pool_type.upper(),
                            "is_test": is_test, "pad_value": pad_value})
    return pool_out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sequence_concat", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    return out


def sequence_slice(input, offset, length, name=None):
    return _simple("sequence_slice", input,
                   extra_inputs={"Offset": [offset], "Length": [length]})


def sequence_expand(x, y, ref_level=-1, name=None):
    return _simple("sequence_expand", x, extra_inputs={"Y": [y]},
                   ref_level=ref_level)


def sequence_expand_as(x, y, name=None):
    return _simple("sequence_expand_as", x, extra_inputs={"Y": [y]})


def sequence_pad(x, pad_value, maxlen=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference(
        VarDesc.VarType.INT64)
    helper.append_op(type="sequence_pad",
                     inputs={"X": [x], "PadValue": [pad_value]},
                     outputs={"Out": [out], "Length": [length]},
                     attrs={"padded_length": maxlen if maxlen else -1})
    return out, length


def sequence_unpad(x, length, name=None):
    return _simple("sequence_unpad", x,
                   extra_inputs={"Length": [length]})


def sequence_reshape(input, new_dim):
    return _simple("sequence_reshape", input, new_dim=new_dim)


def sequence_scatter(input, index, updates, name=None):
    return _simple("sequence_scatter", input,
                   extra_inputs={"Ids": [index], "Updates": [updates]})


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    return _simple("sequence_enumerate", input, win_size=win_size,
                   pad_value=pad_value)


def sequence_reverse(x, name=None):
    return _simple("sequence_reverse", x, out_slot="Y")
