"""Activation-style layer wrappers (counterpart of
paddle_tpu/fluid/layers/ops.py; reference: python/paddle/fluid/layers/ops.py
via layer_function_generator.py): the TPU package's generated activations,
relu and cumsum."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["relu", "sigmoid", "square", "exp", "ceil", "floor", "cos",
           "sqrt", "rsqrt", "abs", "reciprocal", "logsigmoid", "tanh",
           "atan", "tanh_shrink", "softshrink", "acos", "asin", "sin",
           "sinh", "cosh", "round", "softplus", "softsign", "erf",
           "hard_shrink", "thresholded_relu", "log", "log1p", "selu",
           "gelu", "cumsum"]


def _make_act(op_type, extra_attrs=()):
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape
        attrs = {k: kwargs[k] for k in extra_attrs if k in kwargs}
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
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
sqrt = _make_act("sqrt")
rsqrt = _make_act("rsqrt")
abs = _make_act("abs")
reciprocal = _make_act("reciprocal")
logsigmoid = _make_act("logsigmoid")
tanh = _make_act("tanh")
atan = _make_act("atan")
tanh_shrink = _make_act("tanh_shrink")
softshrink = _make_act("softshrink", ("lambda",))
acos = _make_act("acos")
asin = _make_act("asin")
sin = _make_act("sin")
sinh = _make_act("sinh")
cosh = _make_act("cosh")
round = _make_act("round")
softplus = _make_act("softplus")
softsign = _make_act("softsign")
erf = _make_act("erf")
hard_shrink = _make_act("hard_shrink", ("threshold",))
thresholded_relu = _make_act("thresholded_relu", ("threshold",))
log = _make_act("log")
log1p = _make_act("log1p")
selu = _make_act("selu", ("scale", "alpha"))
gelu = _make_act("gelu", ("approximate",))


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    """The running sum of ``x`` along ``axis`` (the cumsum op)."""
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="cumsum", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis, "exclusive": exclusive,
                            "reverse": reverse})
    return out
