"""Activation-style layer wrappers (counterpart of
paddle_tpu/fluid/layers/ops.py; reference: python/paddle/fluid/layers/ops.py
via layer_function_generator.py). So far: relu, sigmoid, square, exp,
ceil, floor and cos."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["relu", "sigmoid", "square", "exp", "ceil", "floor", "cos"]


def _make_act(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs={})
        return out
    layer.__name__ = op_type
    return layer


relu = _make_act("relu")
sigmoid = _make_act("sigmoid")
square = _make_act("square")
exp = _make_act("exp")
ceil = _make_act("ceil")
floor = _make_act("floor")
cos = _make_act("cos")
