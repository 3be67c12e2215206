"""Dense math op kernels (counterpart of paddle_tpu/ops/math_ops.py; so
far: elementwise_add, elementwise_sub, elementwise_mul, elementwise_div,
elementwise_max, elementwise_min, elementwise_pow, elementwise_mod, mul,
matmul, scale, increment, clip, clip_by_norm, squared_l2_norm, l1_norm,
relu, sigmoid, gelu, square, ceil, floor, cos, exp, sqrt, rsqrt, abs,
reciprocal, sign, pow, the other activations of the TPU package's table
(tanh, logsigmoid, tanh_shrink, round, sin, acos, asin, atan, sinh, cosh,
log, log1p, softplus, softsign, erf, leaky_relu, elu, selu, relu6, brelu,
soft_relu, hard_sigmoid, hard_swish, swish, stanh, softshrink, hard_shrink,
thresholded_relu), cos_sim, mean, sum, the reduce_* family, isfinite,
isnan, isinf, the
comparisons less_than, less_equal, greater_than, greater_equal, equal and
not_equal, and logical_and, logical_or, logical_xor and logical_not).

Semantics follow the reference op contracts:
  * elementwise_* broadcast: Y aligns to X at ``axis`` (default -1 =
    trailing alignment), trailing size-1 dims of Y trimmed
    (reference: operators/elementwise/elementwise_op_function.h).
  * mul: flatten X and Y by their num_col_dims into 2-D (reference:
    operators/mul_op.cc).
  * reduce_*: dim list + keep_dim + reduce_all; a 0-d result becomes [1]
    (reference: operators/reduce_ops/).
  * a Python scalar that meets a tensor is first rounded to the tensor's
    dtype on the host (``scalar_as``): the TPU package's
    ``jnp.asarray(v, x.dtype)`` or JAX's weak typing, which make bf16
    arithmetic round its scalars to bf16, where torch would apply them in
    f32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import register_op, first, out, seq


def scalar_as(v, dtype: torch.dtype):
    """The Python number ``v`` rounded to ``dtype``, as a Python number:
    a host-side cast, no device copy, so an op that uses it stays
    capture-safe."""
    return torch.tensor(v, dtype=dtype).item()


# --------------------------------------------------------------------------
# elementwise binary family
# --------------------------------------------------------------------------
def _align_y(x, y, axis):
    """Paddle elementwise broadcast: reshape Y so it aligns to X at axis.
    Shapes that already broadcast numpy-style (the axis=-1 rightmost
    alignment) pass through unchanged."""
    if x.shape == y.shape:
        return y
    if int(axis) == -1:
        try:
            np.broadcast_shapes(tuple(x.shape), tuple(y.shape))
            return y
        except ValueError:
            pass
    axis = int(axis)
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1:
        yshape.pop()
    if axis == -1:
        axis = x.dim() - len(yshape)
    new_shape = [1] * axis + yshape + [1] * (x.dim() - axis - len(yshape))
    return y.reshape(new_shape)


def _register_elementwise(name, fn):
    @register_op(name, inputs=("X", "Y"), attr_defaults={"axis": -1})
    def _kernel(ins, attrs, _fn=fn):
        x, y = first(ins, "X"), first(ins, "Y")
        return out(Out=_fn(x, _align_y(x, y, attrs.get("axis", -1))))
    return _kernel


_register_elementwise("elementwise_add", lambda x, y: x + y)
_register_elementwise("elementwise_sub", lambda x, y: x - y)
_register_elementwise("elementwise_mul", lambda x, y: x * y)
_register_elementwise("elementwise_div", lambda x, y: x / y)
_register_elementwise("elementwise_max", torch.maximum)
_register_elementwise("elementwise_min", torch.minimum)
_register_elementwise("elementwise_pow", lambda x, y: x ** y)
# Python's sign convention (the divisor's), as jnp's ``%``: torch.remainder
# follows it, torch.fmod does not (an int32 step mod k in GradientMerge)
_register_elementwise("elementwise_mod", torch.remainder)


def _register_cmp(name, fn):
    @register_op(name, inputs=("X", "Y"), no_grad=True,
                 attr_defaults={"axis": -1})
    def _kernel(ins, attrs, _fn=fn):
        x, y = first(ins, "X"), first(ins, "Y")
        return out(Out=_fn(x, _align_y(x, y, attrs.get("axis", -1))))
    return _kernel


_register_cmp("less_than", torch.lt)
_register_cmp("less_equal", torch.le)
_register_cmp("greater_than", torch.gt)
_register_cmp("greater_equal", torch.ge)
_register_cmp("equal", torch.eq)
_register_cmp("not_equal", torch.ne)
_register_cmp("logical_and", torch.logical_and)
_register_cmp("logical_or", torch.logical_or)
_register_cmp("logical_xor", torch.logical_xor)


@register_op("logical_not", inputs=("X",), no_grad=True)
def _logical_not(ins, attrs):
    return out(Out=torch.logical_not(first(ins, "X")))


# --------------------------------------------------------------------------
# mul
# --------------------------------------------------------------------------
def bf16_matmul_enabled(a: torch.Tensor) -> bool:
    """ONE gate for every FLAGS_use_bf16_matmul consumer (mul here, fused
    attention): bf16 operands pay off only on the GPU's tensor cores."""
    from ..fluid import core as _core
    return (_core.globals_["FLAGS_use_bf16_matmul"]
            and a.dtype == torch.float32 and a.is_cuda)


def _mm(a, b):
    """Matmul honoring FLAGS_use_bf16_matmul (bf16 operands, f32 out).
    In full f32 otherwise: the executor keeps TF32 off for matmuls."""
    if bf16_matmul_enabled(a):
        return torch.matmul(a.to(torch.bfloat16),
                            b.to(torch.bfloat16)).to(torch.float32)
    return torch.matmul(a, b)


@register_op("mul", inputs=("X", "Y"),
             attr_defaults={"x_num_col_dims": 1, "y_num_col_dims": 1})
def _mul(ins, attrs):
    x, y = first(ins, "X"), first(ins, "Y")
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape((math.prod(xs[:xn]), -1))
    y2 = y.reshape((math.prod(ys[:yn]), -1))
    return out(Out=_mm(x2, y2).reshape(xs[:xn] + ys[yn:]))


@register_op("matmul", inputs=("X", "Y"),
             attr_defaults={"transpose_X": False, "transpose_Y": False,
                            "alpha": 1.0})
def _matmul(ins, attrs):
    """Batched product with optional transposes of the last two dims and
    a scale (reference: operators/matmul_op.cc); a 1-D operand is a row
    (X) or a column (Y), squeezed again after, vec·vec giving [1]."""
    x, y = first(ins, "X"), first(ins, "Y")
    alpha = attrs.get("alpha", 1.0)
    squeeze_front = squeeze_back = False
    if x.dim() == 1:
        x = x[None, :]
        squeeze_front = True
    if y.dim() == 1:
        y = y[:, None]
        squeeze_back = True
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    o = _mm(x, y)
    if squeeze_front:
        o = o.squeeze(-2)
    if squeeze_back:
        o = o.squeeze(-1)
    if squeeze_front and squeeze_back:
        o = o.reshape((1,))
    if alpha != 1.0:
        o = o * scalar_as(alpha, o.dtype)
    return out(Out=o)


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


@register_op("relu", inputs=("X",))
def _relu(ins, attrs):
    """max(x, 0) as the TPU package's ``jnp.maximum(x, 0)``: at x = 0 the
    grad is split evenly between the two sides (½), as JAX's is."""
    x = first(ins, "X")
    return out(Out=torch.maximum(x, torch.zeros((), dtype=x.dtype,
                                                device=x.device)))


@register_op("sigmoid", inputs=("X",))
def _sigmoid(ins, attrs):
    return out(Out=torch.sigmoid(first(ins, "X")))


@register_op("gelu", inputs=("X",), attr_defaults={"approximate": False})
def _gelu(ins, attrs):
    """Exact erf form by default; the tanh form when ``approximate``
    (same formula as the TPU package's kernel)."""
    x = first(ins, "X")
    if attrs.get("approximate", False):
        # the TPU kernel's sqrt(2/pi) is a numpy f64 scalar, which JAX does
        # not weak-type: the tanh's argument, and so the result, promote a
        # bf16 x to f32 there, and so they do here
        inner = x + scalar_as(0.044715, x.dtype) * x ** 3
        wide = torch.promote_types(x.dtype, torch.float32)
        return out(Out=(0.5 * x).to(wide) * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * inner.to(wide))))
    return out(Out=0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0))))


@register_op("square", inputs=("X",))
def _square(ins, attrs):
    return out(Out=torch.square(first(ins, "X")))


def _register_unary(name, fn, **kw):
    @register_op(name, inputs=("X",), **kw)
    def _kernel(ins, attrs, _fn=fn):
        return out(Out=_fn(first(ins, "X")))
    return _kernel


# the LR schedules' arithmetic; ceil and floor have no grad, as in the
# TPU package
_register_unary("ceil", torch.ceil, no_grad=True)
_register_unary("floor", torch.floor, no_grad=True)
_register_unary("cos", torch.cos)
_register_unary("exp", torch.exp)
# the clips' and the norms' arithmetic; sign has no grad, as in the TPU
# package
_register_unary("sqrt", torch.sqrt)
_register_unary("rsqrt", torch.rsqrt)
_register_unary("abs", torch.abs)
_register_unary("reciprocal", lambda x: 1.0 / x)
_register_unary("sign", torch.sign, no_grad=True)


# the TPU package's _register_act table (activation_op.cc
# REGISTER_ACTIVATION_OP): each attr is rounded to X's dtype where it meets
# X; the clips are max/min pairs, as jnp.clip is, so a tie splits its grad
def _register_act(name, fn, defaults=None, **kw):
    defaults = dict(defaults or {})

    @register_op(name, inputs=("X",), attr_defaults=defaults, **kw)
    def _kernel(ins, attrs, _fn=fn):
        x = first(ins, "X")

        def a(k):
            return scalar_as(attrs.get(k, defaults[k]), x.dtype)
        return out(Out=_fn(x, a))
    return _kernel


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _between(x, lo, hi):
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


_register_act("tanh", lambda x, a: torch.tanh(x))
_register_act("logsigmoid", lambda x, a: torch.nn.functional.logsigmoid(x))
_register_act("tanh_shrink", lambda x, a: x - torch.tanh(x))
_register_act("round", lambda x, a: torch.round(x), no_grad=True)
_register_act("sin", lambda x, a: torch.sin(x))
_register_act("acos", lambda x, a: torch.acos(x))
_register_act("asin", lambda x, a: torch.asin(x))
_register_act("atan", lambda x, a: torch.atan(x))
_register_act("sinh", lambda x, a: torch.sinh(x))
_register_act("cosh", lambda x, a: torch.cosh(x))
_register_act("log", lambda x, a: torch.log(x))
_register_act("log1p", lambda x, a: torch.log1p(x))
_register_act("softplus", lambda x, a: torch.logaddexp(x, _zero(x)))
_register_act("softsign", lambda x, a: x / (1 + torch.abs(x)))
_register_act("erf", lambda x, a: torch.erf(x))
_register_act("leaky_relu",
              lambda x, a: torch.where(x >= 0, x, x * a("alpha")),
              {"alpha": 0.02})
_register_act("elu", lambda x, a: torch.where(
    x > 0, x, a("alpha") * (torch.exp(x) - 1)), {"alpha": 1.0})
_register_act("selu", lambda x, a: a("scale") * torch.where(
    x > 0, x, a("alpha") * (torch.exp(x) - 1)),
    {"scale": 1.0507009873554805, "alpha": 1.6732632423543772})
_register_act("relu6", lambda x, a: _between(x, 0.0, a("threshold")),
              {"threshold": 6.0})
_register_act("brelu", lambda x, a: _between(x, a("t_min"), a("t_max")),
              {"t_min": 0.0, "t_max": 24.0})
_register_act("soft_relu", lambda x, a: torch.log1p(torch.exp(
    _between(x, -a("threshold"), a("threshold")))), {"threshold": 40.0})
_register_act("hard_sigmoid", lambda x, a: _between(
    a("slope") * x + a("offset"), 0.0, 1.0), {"slope": 0.2, "offset": 0.5})
_register_act("hard_swish", lambda x, a: x * _between(
    x + a("offset"), 0.0, a("threshold")) / a("scale"),
    {"threshold": 6.0, "scale": 6.0, "offset": 3.0})
_register_act("swish", lambda x, a: x * torch.sigmoid(a("beta") * x),
              {"beta": 1.0})
_register_act("stanh", lambda x, a: a("scale_b") * torch.tanh(
    a("scale_a") * x), {"scale_a": 0.67, "scale_b": 1.7159})
_register_act("softshrink", lambda x, a: torch.where(
    x > a("lambda"), x - a("lambda"), torch.where(
        x < -a("lambda"), x + a("lambda"), _zero(x))), {"lambda": 0.5})
_register_act("hard_shrink", lambda x, a: torch.where(
    torch.abs(x) > a("threshold"), x, _zero(x)), {"threshold": 0.5})
_register_act("thresholded_relu", lambda x, a: torch.where(
    x > a("threshold"), x, _zero(x)), {"threshold": 1.0})


@register_op("pow", inputs=("X",), attr_defaults={"factor": 1.0})
def _pow(ins, attrs):
    return out(Out=first(ins, "X") ** attrs.get("factor", 1.0))


# --------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------
@register_op("mean", inputs=("X",))
def _mean(ins, attrs):
    return out(Out=torch.mean(first(ins, "X")).reshape((1,)))


@register_op("sum", inputs=("X",))
def _sum(ins, attrs):
    """Elementwise sum of the X list (the grad fan-in of append_backward)."""
    xs = seq(ins, "X")
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return out(Out=acc)


def _reduce_axes(x, attrs):
    """The reduced axes, or None for all of them."""
    if attrs.get("reduce_all", False):
        return None
    dims = attrs.get("dim", [0])
    if isinstance(dims, int):
        dims = [dims]
    if not dims:
        return None
    return tuple(int(d) % x.dim() for d in dims)


def _prod(x, dim, keepdim):
    """torch.prod over several axes (it takes one at a time)."""
    if dim is None:
        o = torch.prod(x)
        return o.reshape((1,) * x.dim()) if keepdim else o
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, d, keepdim=True)
    return x if keepdim else x.squeeze(dim)


def _over(fn):
    """``fn(x, dim=axes, keepdim=)`` with None for every axis."""
    def reduce(x, dim, keepdim):
        if dim is None:
            o = fn(x)
            return o.reshape((1,) * x.dim()) if keepdim else o
        return fn(x, dim=dim, keepdim=keepdim)
    return reduce


def _register_reduce(name, fn):
    @register_op(name, inputs=("X",),
                 attr_defaults={"dim": [0], "keep_dim": False,
                                "reduce_all": False})
    def _kernel(ins, attrs, _fn=fn):
        x = first(ins, "X")
        o = _fn(x, _reduce_axes(x, attrs), attrs.get("keep_dim", False))
        if o.dim() == 0:
            o = o.reshape((1,))
        return out(Out=o)
    return _kernel


_register_reduce("reduce_sum", _over(torch.sum))
_register_reduce("reduce_mean", _over(torch.mean))
_register_reduce("reduce_max", _over(torch.amax))
_register_reduce("reduce_min", _over(torch.amin))
_register_reduce("reduce_prod", _prod)
_register_reduce("reduce_all", _over(torch.all))
_register_reduce("reduce_any", _over(torch.any))


@register_op("isfinite", inputs=("X",), no_grad=True)
def _isfinite(ins, attrs):
    """[1] bool: every element of X finite."""
    return out(Out=torch.all(torch.isfinite(first(ins, "X"))).reshape((1,)))


@register_op("isnan", inputs=("X",), no_grad=True)
def _isnan(ins, attrs):
    """[1] bool: some element of X is a NaN (an Inf is not)."""
    return out(Out=torch.any(torch.isnan(first(ins, "X"))).reshape((1,)))


@register_op("isinf", inputs=("X",), no_grad=True)
def _isinf(ins, attrs):
    """[1] bool: some element of X is an Inf (a NaN is not)."""
    return out(Out=torch.any(torch.isinf(first(ins, "X"))).reshape((1,)))


# --------------------------------------------------------------------------
# scale
# --------------------------------------------------------------------------
@register_op("scale", inputs=("X", "ScaleTensor"),
             attr_defaults={"scale": 1.0, "bias": 0.0,
                            "bias_after_scale": True})
def _scale(ins, attrs):
    x = first(ins, "X")
    s = first(ins, "ScaleTensor")
    # the scalars in X's dtype, as the TPU kernel's jnp.asarray(., x.dtype):
    # rounded on the host, so the op makes no host-to-device copy
    s = scalar_as(attrs.get("scale", 1.0), x.dtype) if s is None \
        else s.to(x.dtype)
    b = scalar_as(attrs.get("bias", 0.0), x.dtype)
    if attrs.get("bias_after_scale", True):
        return out(Out=x * s + b)
    return out(Out=(x + b) * s)


@register_op("clip", inputs=("X",), attr_defaults={"min": 0.0, "max": 0.0})
def _clip(ins, attrs):
    """min(max(x, min), max), as jnp.clip: at a bound the grad is split
    between the two sides, as JAX's is."""
    x = first(ins, "X")
    lo, hi = (torch.full((), attrs.get(k), dtype=x.dtype, device=x.device)
              for k in ("min", "max"))
    return out(Out=torch.minimum(torch.maximum(x, lo), hi))


@register_op("clip_by_norm", inputs=("X",), attr_defaults={"max_norm": 1.0})
def _clip_by_norm(ins, attrs):
    """x · (max_norm / ‖x‖) where ‖x‖ exceeds max_norm, else x; the norm
    stays on the device."""
    x = first(ins, "X")
    mn = attrs.get("max_norm", 1.0)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return out(Out=torch.where(norm > mn, x * (mn / norm), x))


@register_op("squared_l2_norm", inputs=("X",))
def _squared_l2_norm(ins, attrs):
    return out(Out=torch.sum(torch.square(first(ins, "X"))).reshape((1,)))


@register_op("l1_norm", inputs=("X",))
def _l1_norm(ins, attrs):
    return out(Out=torch.sum(torch.abs(first(ins, "X"))).reshape((1,)))


@register_op("increment", inputs=("X",), attr_defaults={"step": 1.0})
def _increment(ins, attrs):
    """X + step, the step in X's dtype (the LR schedules' step counter is
    an int64 [1] that this op advances once a run)."""
    x = first(ins, "X")
    return out(Out=x + scalar_as(attrs.get("step", 1.0), x.dtype))


@register_op("cos_sim", inputs=("X", "Y"))
def _cos_sim(ins, attrs):
    """Cosine similarity of X's and Y's rows over the last dim (a
    one-row Y broadcasts), with the two norms."""
    x, y = first(ins, "X"), first(ins, "Y")
    xn = torch.sqrt(torch.sum(torch.square(x), -1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), -1, keepdim=True))
    xy = torch.sum(x * y, -1, keepdim=True)
    return out(Out=xy / (xn * yn), XNorm=xn, YNorm=yn)
