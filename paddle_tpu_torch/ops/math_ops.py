"""Dense math op kernels (counterpart of paddle_tpu/ops/math_ops.py; so
far: elementwise_add, elementwise_sub, elementwise_mul, elementwise_div,
mul, scale, relu, gelu, square, mean, sum, isfinite).

Semantics follow the reference op contracts:
  * elementwise_* broadcast: Y aligns to X at ``axis`` (default -1 =
    trailing alignment), trailing size-1 dims of Y trimmed
    (reference: operators/elementwise/elementwise_op_function.h).
  * mul: flatten X and Y by their num_col_dims into 2-D (reference:
    operators/mul_op.cc).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import register_op, first, out, seq


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


@register_op("gelu", inputs=("X",), attr_defaults={"approximate": False})
def _gelu(ins, attrs):
    """Exact erf form by default; the tanh form when ``approximate``
    (same formula as the TPU package's kernel)."""
    x = first(ins, "X")
    if attrs.get("approximate", False):
        return out(Out=0.5 * x * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (x + 0.044715 * x ** 3))))
    return out(Out=0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0))))


@register_op("square", inputs=("X",))
def _square(ins, attrs):
    return out(Out=torch.square(first(ins, "X")))


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


@register_op("isfinite", inputs=("X",), no_grad=True)
def _isfinite(ins, attrs):
    """[1] bool: every element of X finite."""
    return out(Out=torch.all(torch.isfinite(first(ins, "X"))).reshape((1,)))


# --------------------------------------------------------------------------
# scale
# --------------------------------------------------------------------------
@register_op("scale", inputs=("X", "ScaleTensor"),
             attr_defaults={"scale": 1.0, "bias": 0.0,
                            "bias_after_scale": True})
def _scale(ins, attrs):
    x = first(ins, "X")
    s = first(ins, "ScaleTensor")
    # scalars are cast to X's dtype, as the TPU kernel's jnp.asarray(.,
    # x.dtype) does; python scalars keep the op free of host→device copies
    cast = float if x.is_floating_point() else int
    s = cast(attrs.get("scale", 1.0)) if s is None else s.to(x.dtype)
    b = cast(attrs.get("bias", 0.0))
    if attrs.get("bias_after_scale", True):
        return out(Out=x * s + b)
    return out(Out=(x + b) * s)
