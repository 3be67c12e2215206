"""Tensor layers (counterpart of paddle_tpu/fluid/layers/tensor.py;
reference: python/paddle/fluid/layers/tensor.py). So far: assign, cast,
concat, create_global_var, create_parameter, fill_constant, ones, zeros,
sums, tensor_array_to_tensor, isfinite, argmax, argmin, argsort,
create_tensor, diag, eye, fill_constant_batch_size_like, has_inf,
has_nan, linspace, ones_like, range, reverse, zeros_like, and
``math_op``, the helper of the Variable operators."""
from __future__ import annotations

import numpy as np

from ..core import VarDesc, convert_np_dtype_to_dtype_
from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["assign", "cast", "concat", "create_global_var", "create_parameter",
           "fill_constant", "ones", "zeros", "sums", "tensor_array_to_tensor",
           "isfinite", "argmax", "argmin", "argsort", "create_tensor", "diag",
           "eye", "fill_constant_batch_size_like", "has_inf", "has_nan",
           "linspace", "ones_like", "reverse", "zeros_like", "range"]


def _dtype(d):
    return d if isinstance(d, int) else convert_np_dtype_to_dtype_(d)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter of ``shape`` and ``dtype``, initialized by the startup
    program."""
    from ..param_attr import ParamAttr
    helper = LayerHelper("create_parameter", **locals())
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(attr, shape, _dtype(dtype), is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global var of ``shape`` that the startup program fills with
    ``value``."""
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(dtype=_dtype(dtype), shape=shape,
                                        persistable=persistable,
                                        stop_gradient=True)
    helper.set_variable_initializer(var, Constant(value=float(value)))
    return var


def assign(input, output=None):
    """``output`` (a new var if None) = ``input``: a Variable gives the
    ``assign`` op, a numpy array, list or number the ``assign_value`` op
    with its values in the attrs."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype)
            output.shape = input.shape
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    elif isinstance(input, (np.ndarray, list, tuple, float, int)):
        arr = np.asarray(input)
        dtype = convert_np_dtype_to_dtype_(arr.dtype)
        if output is None:
            output = helper.create_variable_for_type_inference(dtype=dtype)
            output.shape = arr.shape
        if arr.dtype in (np.float32, np.float64):
            values = {"fp32_values": [float(v) for v in arr.flatten()]}
        elif arr.dtype == np.bool_:
            values = {"bool_values": [bool(v) for v in arr.flatten()]}
        elif arr.dtype == np.int64:
            values = {"int64_values": [int(v) for v in arr.flatten()]}
        else:
            values = {"int32_values": [int(v) for v in arr.flatten()]}
        helper.append_op(type="assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(arr.shape), "dtype": dtype,
                                **values})
    else:
        raise TypeError(f"cannot assign {type(input)}")
    return output


def math_op(op_type, x, y):
    """``op_type`` of ``x`` and ``y`` (a Variable, or a Python number that
    becomes a fill_constant [1] of x's dtype): the Variable operators'
    helper."""
    helper = LayerHelper(op_type)
    if not isinstance(y, Variable):
        yv = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type="fill_constant", outputs={"Out": [yv]},
                         attrs={"shape": [1], "dtype": x.dtype,
                                "value": float(y)})
        yv.shape = (1,)
        y = yv
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape if len(x.shape) >= len(y.shape) else y.shape
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def cast(x, dtype):
    """``x`` converted to ``dtype`` (a VarType, a numpy or dtype name)."""
    dtype = convert_np_dtype_to_dtype_(dtype)
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = x.shape
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    """A tensor of ``shape`` filled with ``value``; the shape may hold
    Variables (read on the host when the op runs)."""
    helper = LayerHelper("fill_constant")
    attrs = {"value": float(value), "dtype": _dtype(dtype)}
    inputs = {}
    if isinstance(shape, Variable):
        inputs["ShapeTensor"] = [shape]
        attrs["shape"] = []
        known = None
    elif isinstance(shape, (list, tuple)) and any(
            isinstance(s, Variable) for s in shape):
        inputs["ShapeTensorList"] = [s for s in shape
                                     if isinstance(s, Variable)]
        attrs["shape"] = [s if not isinstance(s, Variable) else -1
                          for s in shape]
        known = None
    else:
        attrs["shape"] = [int(s) for s in shape]
        known = tuple(int(s) for s in shape)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=attrs["dtype"])
    out.stop_gradient = True
    if known is not None:
        out.shape = known
    helper.append_op(type="fill_constant", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def concat(input, axis=0, name=None):
    """The Variables of ``input`` joined along ``axis`` (an int, or a
    Variable read on the host when the op runs)."""
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    inputs = {"X": list(input)}
    attrs = {}
    if isinstance(axis, Variable):
        inputs["AxisTensor"] = [axis]
        attrs["axis"] = 0
    else:
        attrs["axis"] = axis
    shapes = [list(v.shape) for v in input]
    if all(shapes):
        shp = list(shapes[0])
        ax = 0 if isinstance(axis, Variable) else axis
        shp[ax] = sum(s[ax] for s in shapes) \
            if all(s[ax] >= 0 for s in shapes) else -1
        out.shape = tuple(shp)
    helper.append_op(type="concat", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def sums(input, out=None):
    """The elementwise sum of the list ``input`` (one ``sum`` op)."""
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
        out.shape = input[0].shape
    helper.append_op(type="sum", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={})
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """The entries of the tensor array ``input`` joined along ``axis`` (or
    stacked), and each entry's size along it (int32)."""
    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference(VarDesc.VarType.INT32)
    helper.append_op(type="tensor_array_to_tensor", inputs={"X": [input]},
                     outputs={"Out": [out], "OutIndex": [idx]},
                     attrs={"axis": axis, "use_stack": use_stack})
    return out, idx


def isfinite(x):
    """One bool: every element of ``x`` finite (reference:
    layers/tensor.py isfinite)."""
    helper = LayerHelper("isfinite")
    out = helper.create_variable_for_type_inference(VarDesc.VarType.BOOL)
    out.shape = (1,)
    helper.append_op(type="isfinite", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


# --------------------------------------------------------------------------
# argmax .. range: the layers over the rest of tensor_ops
# --------------------------------------------------------------------------
def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference(VarDesc.VarType.INT64)
    shp = list(x.shape)
    if shp:
        shp.pop(axis if axis >= 0 else len(shp) + axis)
    out.shape = tuple(shp)
    helper.append_op(type="arg_max", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    out.stop_gradient = True
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference(VarDesc.VarType.INT64)
    helper.append_op(type="arg_min", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    out.stop_gradient = True
    return out


def argsort(input, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference(VarDesc.VarType.INT64)
    out.shape = ids.shape = input.shape
    helper.append_op(type="argsort", inputs={"X": [input]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis, "descending": descending})
    return out, ids


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=_dtype(dtype),
                                  persistable=persistable)


def diag(diagonal):
    helper = LayerHelper("diag")
    out = helper.create_variable_for_type_inference(diagonal.dtype)
    helper.append_op(type="diag", inputs={"Diagonal": [diagonal]},
                     outputs={"Out": [out]})
    out.stop_gradient = True
    return out


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    helper = LayerHelper("eye")
    dtype = _dtype(dtype)
    num_columns = num_columns if num_columns is not None else num_rows
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = (num_rows, num_columns)
    helper.append_op(type="eye", outputs={"Out": [out]},
                     attrs={"num_rows": num_rows, "num_columns": num_columns,
                            "dtype": dtype})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  force_cpu=False):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=_dtype(dtype))
    out.shape = tuple(shape)
    out.stop_gradient = True
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": _dtype(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def has_inf(x):
    """True iff ``x`` contains an Inf (reference: isinf over AnyVisitor
    — a NaN-only tensor reports False; NOT the same as ``not
    isfinite``, which the old port conflated both helpers into)."""
    helper = LayerHelper("isinf")
    out = helper.create_variable_for_type_inference(VarDesc.VarType.BOOL)
    out.shape = (1,)
    helper.append_op(type="isinf", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def has_nan(x):
    """True iff ``x`` contains a NaN (an Inf-only tensor reports
    False)."""
    helper = LayerHelper("isnan")
    out = helper.create_variable_for_type_inference(VarDesc.VarType.BOOL)
    out.shape = (1,)
    helper.append_op(type="isnan", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def linspace(start, stop, num, dtype):
    helper = LayerHelper("linspace")
    dtype = _dtype(dtype)

    def _ensure(v, dt):
        if isinstance(v, Variable):
            return v
        return fill_constant([1], dt, v)
    start = _ensure(start, dtype)
    stop = _ensure(stop, dtype)
    num = _ensure(num, VarDesc.VarType.INT32)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="linspace",
                     inputs={"Start": [start], "Stop": [stop], "Num": [num]},
                     outputs={"Out": [out]})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"value": 1.0, "dtype": -1})
    return out


def reverse(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="reverse", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"value": 0.0, "dtype": -1})
    return out


def range(start, end, step, dtype):
    helper = LayerHelper("range")
    dtype = _dtype(dtype)

    def _ensure(v):
        if isinstance(v, Variable):
            return v
        return fill_constant([1], dtype, v)
    start, end, step = _ensure(start), _ensure(end), _ensure(step)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="range",
                     inputs={"Start": [start], "End": [end], "Step": [step]},
                     outputs={"Out": [out]})
    out.stop_gradient = True
    return out
