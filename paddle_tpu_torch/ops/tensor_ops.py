"""Tensor creation / manipulation op kernels (counterpart of
paddle_tpu/ops/tensor_ops.py; so far: fill_constant, assign,
assign_value, is_empty, cast, uniform_random, gaussian_random,
truncated_gaussian_random, reshape2, transpose2, squeeze, squeeze2,
unsqueeze2, flatten, flatten2, concat, gather and its grad, top_k,
one_hot, one_hot_v2, label_smooth).

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
from .math_ops import scalar_as
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


def assign_value_tensor(attrs, device) -> torch.Tensor:
    """assign_value's constant, made from its attrs on ``device`` (a copy
    from the host)."""
    vals = (attrs.get("fp32_values") or attrs.get("int32_values")
            or attrs.get("int64_values") or attrs.get("bool_values") or [])
    return torch.tensor(vals, dtype=_dtype(attrs), device=device).reshape(
        [int(s) for s in attrs["shape"]])


@register_op("assign_value", no_grad=True, needs_device=True,
             attr_defaults={"shape": [], "dtype": 5, "fp32_values": [],
                            "int32_values": [], "int64_values": [],
                            "bool_values": []})
def _assign_value(ins, attrs):
    """The constant of the attrs. A compiled plan binds it once, as
    ``attrs["_const"]`` on the device, and the op copies it (a
    device-to-device copy, which a CUDA graph captures; the copy from the
    host cannot be captured). The interpreter makes it at every call."""
    c = attrs.get("_const")
    if c is not None:
        return out(Out=c.clone())
    return out(Out=assign_value_tensor(attrs, attrs["_device"]))


@register_op("cast", inputs=("X",),
             attr_defaults={"in_dtype": 5, "out_dtype": 5})
def _cast(ins, attrs):
    """X in ``out_dtype``, on X's device: one conversion kernel and no host
    tensor, so a CUDA graph captures it. Its grad (the generic one) is the
    cast back to X's dtype."""
    return out(Out=first(ins, "X").to(_dtype({"dtype": attrs["out_dtype"]})))


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


@register_op("assign", inputs=("X",))
def _assign(ins, attrs):
    return out(Out=first(ins, "X"))


@register_op("is_empty", inputs=("X",), no_grad=True)
def _is_empty(ins, attrs):
    """[1] bool: X has no element (made on the device: no host copy)."""
    x = first(ins, "X")
    return out(Out=torch.full((1,), x.numel() == 0, dtype=torch.bool,
                              device=x.device))


@register_op("transpose2", inputs=("X",), attr_defaults={"axis": []})
def _transpose2(ins, attrs):
    x = first(ins, "X")
    return out(Out=x.permute(*[int(a) for a in attrs["axis"]]),
               XShape=_xshape(x))


def _squeezed(x, axes):
    """X without the size-1 dims among ``axes`` (every size-1 dim when
    ``axes`` is empty); an axis whose dim is not 1 stays."""
    axes = [a % x.dim() for a in axes] if axes else range(x.dim())
    keep = [s for i, s in enumerate(x.shape) if not (i in axes and s == 1)]
    return x.reshape(keep)


@register_op("squeeze", inputs=("X",), attr_defaults={"axes": []})
def _squeeze(ins, attrs):
    return out(Out=_squeezed(first(ins, "X"), attrs.get("axes", [])))


@register_op("squeeze2", inputs=("X",), attr_defaults={"axes": []})
def _squeeze2(ins, attrs):
    x = first(ins, "X")
    return out(Out=_squeezed(x, attrs.get("axes", [])), XShape=_xshape(x))


@register_op("unsqueeze2", inputs=("X",), attr_defaults={"axes": []})
def _unsqueeze2(ins, attrs):
    x = first(ins, "X")
    o = x
    for a in sorted(attrs["axes"]):
        o = o.unsqueeze(a)
    return out(Out=o, XShape=_xshape(x))


def _flatten_2d(x, axis):
    return x.reshape((math.prod(x.shape[:axis]), -1))


@register_op("flatten", inputs=("X",), attr_defaults={"axis": 1})
def _flatten(ins, attrs):
    """[prod(shape[:axis]), prod(shape[axis:])]."""
    return out(Out=_flatten_2d(first(ins, "X"), attrs.get("axis", 1)))


@register_op("flatten2", inputs=("X",), attr_defaults={"axis": 1})
def _flatten2(ins, attrs):
    """flatten, and XShape (X's shape after a 0) as reshape2 gives it."""
    x = first(ins, "X")
    return out(Out=_flatten_2d(x, attrs.get("axis", 1)), XShape=_xshape(x))


# --------------------------------------------------------------------------
# indexing
# --------------------------------------------------------------------------
class _GatherRows(torch.autograd.Function):
    """``x.index_select(0, idx)`` whose backward sums the rows of repeated
    indices in a fixed order (``scatter_rows_add``), where
    ``index_select``'s own backward adds with atomics on the card. The
    gather's grad op is a registered kernel; this backward is what
    autograd runs when it differentiates a gather itself (a remat span)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_rows_add(ctx.n_rows, idx, g), None


@register_op("concat", inputs=("X", "AxisTensor"),
             host_inputs=("AxisTensor",), attr_defaults={"axis": 0})
def _concat(ins, attrs):
    """The X tensors joined along ``axis``; ``AxisTensor``, a tensor,
    overrides the attr and is read on the host."""
    at = first(ins, "AxisTensor")
    ax = int(at.reshape(()).item()) if at is not None \
        else int(attrs.get("axis", 0))
    return out(Out=torch.cat(list(ins.get("X") or []), dim=ax))


@register_op("gather", inputs=("X", "Index"), diff_inputs=("X",))
def _gather(ins, attrs):
    x, idx = first(ins, "X"), first(ins, "Index")
    return out(Out=_GatherRows.apply(x, idx.reshape(-1).long()))


@register_op("top_k", inputs=("X", "K"), diff_inputs=("X",),
             host_inputs=("K",), attr_defaults={"k": 1})
def _top_k(ins, attrs):
    """The k largest along the last axis, descending, with their int64
    indices (the var's dtype). ``K``, a tensor, overrides the attr and is
    read on the host."""
    x, kt = first(ins, "X"), first(ins, "K")
    k = int(kt.reshape(()).item()) if kt is not None else attrs.get("k", 1)
    vals, idx = torch.topk(x, k, dim=-1, largest=True, sorted=True)
    return out(Out=vals, Indices=idx)


def _one_hot(x, ins, attrs):
    """[..., depth] rows of ``dtype`` with a 1 at each id (an id outside
    [0, depth) gives a row of zeros, as jax.nn.one_hot); ``depth_tensor``
    overrides the attr and is read on the host."""
    dt = first(ins, "depth_tensor")
    depth = int(dt.reshape(()).item()) if dt is not None else attrs["depth"]
    classes = torch.arange(depth, dtype=x.dtype, device=x.device)
    return out(Out=(x.unsqueeze(-1) == classes).to(_dtype(attrs)))


@register_op("one_hot", inputs=("X", "depth_tensor"), no_grad=True,
             host_inputs=("depth_tensor",),
             attr_defaults={"depth": 1, "dtype": 5,
                            "allow_out_of_range": False})
def _one_hot_v1(ins, attrs):
    """one_hot of ids whose trailing dim of 1 is dropped."""
    x = first(ins, "X")
    return _one_hot(x.squeeze(-1) if x.shape[-1] == 1 else x, ins, attrs)


@register_op("one_hot_v2", inputs=("X", "depth_tensor"), no_grad=True,
             host_inputs=("depth_tensor",),
             attr_defaults={"depth": 1, "dtype": 5,
                            "allow_out_of_range": False})
def _one_hot_v2(ins, attrs):
    return _one_hot(first(ins, "X"), ins, attrs)


@register_op("label_smooth", inputs=("X", "PriorDist"), diff_inputs=("X",),
             attr_defaults={"epsilon": 0.0})
def _label_smooth(ins, attrs):
    """(1 - ε)·X + ε/K, or + ε·PriorDist; the scalars in X's dtype (the
    TPU kernel's Python floats are weak-typed)."""
    x = first(ins, "X")
    eps = attrs.get("epsilon", 0.0)
    prior = first(ins, "PriorDist")
    k = x.shape[-1]
    keep = scalar_as(1 - eps, x.dtype) * x
    if prior is None:
        return out(Out=keep + scalar_as(eps / k, x.dtype))
    return out(Out=keep + scalar_as(eps, x.dtype) * prior.reshape(
        (1,) * (x.dim() - 1) + (k,)))


def scatter_rows_add(n_rows: int, idx: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """[n_rows, ...] zeros with row ``idx[i]`` += ``g[i]``, duplicates
    summed in an order that does not change from run to run, so a step
    that repeats indices is bitwise reproducible. On the card
    ``index_put_(accumulate=True)``: it sorts the indices (a stable radix
    sort) and adds each run of equal indices in that order, where
    ``index_add_``, what autograd gives ``index_select``, adds with
    atomics in an order that changes from run to run. On the CPU the
    other way round: ``index_add_`` adds in index order, and
    ``index_put_(accumulate=True)`` splits the rows over threads."""
    z = torch.zeros((n_rows,) + tuple(g.shape[1:]), dtype=g.dtype,
                    device=g.device)
    if g.is_cuda:
        return z.index_put_((idx,), g, accumulate=True)
    return z.index_add_(0, idx, g)


@register_op("gather_grad", no_grad=True)
def _gather_grad(ins, attrs):
    """X@GRAD of gather: Out@GRAD's rows summed into X's rows by Index
    (the masked positions of the BERT step repeat), in a fixed order."""
    x, idx = first(ins, "X"), first(ins, "Index")
    g = first(ins, "Out@GRAD").to(x.dtype)
    return out(**{"X@GRAD": scatter_rows_add(x.shape[0],
                                             idx.reshape(-1).long(), g)})
