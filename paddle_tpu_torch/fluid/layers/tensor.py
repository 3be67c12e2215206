"""Tensor layers (counterpart of paddle_tpu/fluid/layers/tensor.py;
reference: python/paddle/fluid/layers/tensor.py). So far: cast."""
from __future__ import annotations

from ..core import convert_np_dtype_to_dtype_
from ..layer_helper import LayerHelper

__all__ = ["cast"]


def cast(x, dtype):
    """``x`` converted to ``dtype`` (a VarType, a numpy or dtype name)."""
    dtype = convert_np_dtype_to_dtype_(dtype)
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = x.shape
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out

