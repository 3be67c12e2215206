"""Tensor creation / manipulation op kernels (counterpart of
paddle_tpu/ops/tensor_ops.py; so far: fill_constant, assign_value,
uniform_random, gaussian_random, truncated_gaussian_random, reshape2,
unsqueeze2, gather).

Random ops draw from the key that ``attrs["_rng"]()`` returns (the
executor derives it on the device from the program's random_seed, the
step and the op index) through the counter-based draws of ops/rng.py — no
generator state is read or advanced.

Ops that take a shape from a tensor (``ShapeTensor``, ``ShapeTensorList``,
reshape2's ``Shape``) read its values on the host: they declare those
slots as ``host_inputs``, and a block that connects one runs interpreted.
"""
from __future__ import annotations

import math

import torch

from . import rng
from .registry import register_op, first, seq, out

_SHAPE_TENSORS = ("ShapeTensor", "ShapeTensorList")


def _dtype(attrs):
    from ..fluid.core import dtype_to_torch
    return dtype_to_torch(attrs.get("dtype", 5))


def _shape_from(ins, attrs, key="shape"):
    """Resolve shape from ShapeTensor/ShapeTensorList inputs or attr."""
    st = first(ins, "ShapeTensor")
    if st is not None:
        return [int(x) for x in st.tolist()]
    stl = seq(ins, "ShapeTensorList")
    if stl:
        return [int(s.reshape(()).item()) for s in stl]
    return [int(s) for s in attrs.get(key, [])]


# --------------------------------------------------------------------------
# creation
# --------------------------------------------------------------------------
@register_op("fill_constant",
             inputs=("ShapeTensor", "ShapeTensorList", "ValueTensor"),
             no_grad=True, needs_device=True, host_inputs=_SHAPE_TENSORS,
             attr_defaults={"value": 0.0, "shape": [], "dtype": 5,
                            "str_value": ""})
def _fill_constant(ins, attrs):
    shape = _shape_from(ins, attrs)
    dt = _dtype(attrs)
    vt = first(ins, "ValueTensor")
    if vt is not None:
        return out(Out=vt.to(dt).reshape(()).expand(shape).clone())
    sv = attrs.get("str_value", "")
    val = float(sv) if sv not in ("", None) else attrs.get("value", 0.0)
    return out(Out=torch.full(shape, val, dtype=dt, device=attrs["_device"]))


@register_op("assign_value", no_grad=True, needs_device=True,
             attr_defaults={"shape": [], "dtype": 5, "fp32_values": [],
                            "int32_values": [], "int64_values": [],
                            "bool_values": []})
def _assign_value(ins, attrs):
    vals = (attrs.get("fp32_values") or attrs.get("int32_values")
            or attrs.get("int64_values") or attrs.get("bool_values") or [])
    return out(Out=torch.tensor(vals, dtype=_dtype(attrs),
                                device=attrs["_device"]).reshape(
        [int(s) for s in attrs["shape"]]))


# --------------------------------------------------------------------------
# random
# --------------------------------------------------------------------------
@register_op("uniform_random", needs_rng=True,
             no_grad=True, inputs=("ShapeTensor", "ShapeTensorList"),
             host_inputs=_SHAPE_TENSORS,
             attr_defaults={"shape": [], "min": -1.0, "max": 1.0, "seed": 0,
                            "dtype": 5})
def _uniform_random(ins, attrs):
    shape = _shape_from(ins, attrs)
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = rng.uniform(attrs["_rng"](), shape)
    return out(Out=(lo + (hi - lo) * u).to(_dtype(attrs)))


@register_op("gaussian_random", needs_rng=True,
             no_grad=True, inputs=("ShapeTensor", "ShapeTensorList"),
             host_inputs=_SHAPE_TENSORS,
             attr_defaults={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
                            "dtype": 5})
def _gaussian_random(ins, attrs):
    shape = _shape_from(ins, attrs)
    z = rng.normal(attrs["_rng"](), shape)
    return out(Out=(attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z)
               .to(_dtype(attrs)))


def _normal_cdf(x):
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


@register_op("truncated_gaussian_random", needs_rng=True,
             no_grad=True,
             attr_defaults={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
                            "dtype": 5})
def _truncated_gaussian_random(ins, attrs):
    """Standard normal truncated to [-2, 2] by inverse-CDF sampling (the
    method jax.random.truncated_normal uses), then mean + std·t."""
    shape = [int(s) for s in attrs["shape"]]
    lo, hi = _normal_cdf(-2.0), _normal_cdf(2.0)
    u = (2.0 * lo - 1.0) + (2.0 * (hi - lo)) * rng.uniform(attrs["_rng"](),
                                                           shape)
    t = torch.clamp(math.sqrt(2.0) * torch.erfinv(u), -2.0, 2.0)
    return out(Out=(attrs.get("mean", 0.0)
                    + attrs.get("std", 1.0) * t).to(_dtype(attrs)))


# --------------------------------------------------------------------------
# shape manipulation
# --------------------------------------------------------------------------
def _infer_reshape(x_shape, target):
    target = list(target)
    for i, t in enumerate(target):
        if t == 0:
            target[i] = x_shape[i]
    if -1 in target:
        known = math.prod(t for t in target if t != -1)
        target[target.index(-1)] = math.prod(x_shape) // max(known, 1)
    return target


def _xshape(x):
    """XShape output: a zero-size tensor whose dims record X's shape."""
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op("reshape2", inputs=("X", "Shape", "ShapeTensor"),
             host_inputs=("Shape",) + _SHAPE_TENSORS,
             attr_defaults={"shape": []})
def _reshape2(ins, attrs):
    x = first(ins, "X")
    sh = first(ins, "Shape")
    target = ([int(v) for v in sh.tolist()] if sh is not None
              else _shape_from(ins, attrs))
    return out(Out=x.reshape(_infer_reshape(tuple(x.shape), target)),
               XShape=_xshape(x))


@register_op("unsqueeze2", inputs=("X",), attr_defaults={"axes": []})
def _unsqueeze2(ins, attrs):
    x = first(ins, "X")
    o = x
    for a in sorted(attrs["axes"]):
        o = o.unsqueeze(a)
    return out(Out=o, XShape=_xshape(x))


# --------------------------------------------------------------------------
# indexing
# --------------------------------------------------------------------------
@register_op("gather", inputs=("X", "Index"), diff_inputs=("X",))
def _gather(ins, attrs):
    x, idx = first(ins, "X"), first(ins, "Index")
    return out(Out=x.index_select(0, idx.reshape(-1).long()))
