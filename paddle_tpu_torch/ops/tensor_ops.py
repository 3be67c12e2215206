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

import numpy as np
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
    gather op's grad op is a registered kernel; this backward is what
    autograd runs for the ops that gather through ``take_rows`` and for
    a gather inside a remat span."""

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


# --------------------------------------------------------------------------
# creation (the rest of the TPU package's tensor_ops.py)
# --------------------------------------------------------------------------
def _like_shape(x, attrs):
    """``shape`` with dim ``output_dim_idx`` taken from dim
    ``input_dim_idx`` of ``x`` (the ``*_batch_size_like`` ops)."""
    shape = [int(s) for s in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = \
        x.shape[attrs.get("input_dim_idx", 0)]
    return shape


def _consts(values, dtype, device):
    """A 1-D tensor of Python ints made on ``device`` by fill kernels (no
    copy from the host, so a CUDA graph captures it)."""
    if not values:
        return torch.empty((0,), dtype=dtype, device=device)
    return torch.stack([torch.full((), int(v), dtype=dtype, device=device)
                        for v in values])


@register_op("fill_any_like", inputs=("X",), no_grad=True,
             attr_defaults={"value": 0.0, "dtype": -1})
def _fill_any_like(ins, attrs):
    x = first(ins, "X")
    dt = attrs.get("dtype", -1)
    dt = x.dtype if dt in (-1, None) else _dtype({"dtype": dt})
    return out(Out=torch.full(tuple(x.shape), attrs.get("value", 0.0),
                              dtype=dt, device=x.device))


@register_op("fill_zeros_like", inputs=("X",), no_grad=True)
def _fill_zeros_like(ins, attrs):
    return out(Out=torch.zeros_like(first(ins, "X")))


@register_op("fill_constant_batch_size_like", inputs=("Input",),
             no_grad=True,
             attr_defaults={"shape": [], "value": 0.0, "dtype": 5,
                            "input_dim_idx": 0, "output_dim_idx": 0})
def _fill_constant_bsl(ins, attrs):
    """A ``shape`` of ``value`` whose dim ``output_dim_idx`` is Input's
    dim ``input_dim_idx`` (the batch size)."""
    x = first(ins, "Input")
    return out(Out=torch.full(_like_shape(x, attrs), attrs.get("value", 0.0),
                              dtype=_dtype(attrs), device=x.device))


@register_op("eye", no_grad=True, needs_device=True,
             attr_defaults={"num_rows": 1, "num_columns": -1, "dtype": 5})
def _eye(ins, attrs):
    n = attrs["num_rows"]
    m = attrs.get("num_columns", -1)
    m = n if m in (-1, None) else m
    return out(Out=torch.eye(n, m, dtype=_dtype(attrs),
                             device=attrs["_device"]))


@register_op("diag", inputs=("Diagonal",), no_grad=True)
def _diag(ins, attrs):
    """A 1-D Diagonal's square matrix, or a matrix's diagonal."""
    return out(Out=torch.diag(first(ins, "Diagonal")))


@register_op("diag_embed", inputs=("Input",),
             attr_defaults={"offset": 0, "dim1": -2, "dim2": -1})
def _diag_embed(ins, attrs):
    """Input's last dim on the ``offset`` diagonal of the (dim1, dim2)
    planes of a new tensor, zeros elsewhere."""
    return out(Out=torch.diag_embed(first(ins, "Input"),
                                    int(attrs.get("offset", 0)),
                                    int(attrs.get("dim1", -2)),
                                    int(attrs.get("dim2", -1))))


def _host_scalar(t):
    return t.reshape(()).item()


@register_op("range", inputs=("Start", "End", "Step"), no_grad=True,
             stateful=True)
def _range(ins, attrs):
    """[Start, End) by Step, in Start's dtype: its length depends on the
    values, so it runs on the host's reading of them (an island)."""
    s = first(ins, "Start")
    o = np.arange(float(_host_scalar(s)), float(_host_scalar(first(
        ins, "End"))), float(_host_scalar(first(ins, "Step"))))
    return out(Out=torch.from_numpy(o).to(device=s.device, dtype=s.dtype))


@register_op("linspace", inputs=("Start", "Stop", "Num"), no_grad=True,
             stateful=True)
def _linspace(ins, attrs):
    """Num points from Start to Stop, both ends included, in Start's
    dtype (Num read on the host: an island)."""
    s = first(ins, "Start")
    n = int(_host_scalar(first(ins, "Num")))
    return out(Out=torch.linspace(float(_host_scalar(s)),
                                  float(_host_scalar(first(ins, "Stop"))),
                                  n, dtype=s.dtype, device=s.device))


@register_op("shape", inputs=("Input",), no_grad=True)
def _shape(ins, attrs):
    x = first(ins, "Input")
    return out(Out=_consts(list(x.shape), torch.int32, x.device))


@register_op("size", inputs=("Input",), no_grad=True)
def _size(ins, attrs):
    """[1]: Input's element count (int64, the layer's var dtype)."""
    x = first(ins, "Input")
    return out(Out=torch.full((1,), x.numel(), dtype=torch.int64,
                              device=x.device))


@register_op("seed", no_grad=True, needs_device=True,
             attr_defaults={"seed": 0})
def _seed(ins, attrs):
    return out(Out=torch.full((1,), int(attrs.get("seed", 0)),
                              dtype=torch.int32, device=attrs["_device"]))


# --------------------------------------------------------------------------
# random (the rest)
# --------------------------------------------------------------------------
@register_op("uniform_random_batch_size_like", needs_rng=True,
             no_grad=True, inputs=("Input",),
             attr_defaults={"shape": [], "min": -1.0, "max": 1.0, "seed": 0,
                            "dtype": 5, "input_dim_idx": 0,
                            "output_dim_idx": 0})
def _uniform_random_bsl(ins, attrs):
    shape = _like_shape(first(ins, "Input"), attrs)
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = rng.uniform(attrs["_rng"](), shape)
    return out(Out=(lo + (hi - lo) * u).to(_dtype(attrs)))


@register_op("gaussian_random_batch_size_like", needs_rng=True,
             no_grad=True, inputs=("Input",),
             attr_defaults={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
                            "dtype": 5, "input_dim_idx": 0,
                            "output_dim_idx": 0})
def _gaussian_random_bsl(ins, attrs):
    shape = _like_shape(first(ins, "Input"), attrs)
    z = rng.normal(attrs["_rng"](), shape)
    return out(Out=(attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z)
               .to(_dtype(attrs)))


@register_op("randint", needs_rng=True, no_grad=True,
             inputs=("ShapeTensor", "ShapeTensorList"),
             host_inputs=_SHAPE_TENSORS,
             attr_defaults={"shape": [], "low": 0, "high": 0, "seed": 0,
                            "dtype": 3})
def _randint(ins, attrs):
    shape = _shape_from(ins, attrs)
    r = rng.randint(attrs["_rng"](), shape, attrs.get("low", 0),
                    attrs.get("high", 1))
    return out(Out=r.to(_dtype({"dtype": attrs.get("dtype", 3)})))


@register_op("randperm", needs_rng=True, no_grad=True,
             attr_defaults={"n": 1, "seed": 0, "dtype": 3})
def _randperm(ins, attrs):
    """A permutation of 0..n-1: the indices that sort n random draws
    (stably, so equal draws keep index order)."""
    bits = rng.bits24(attrs["_rng"](), (int(attrs["n"]),))
    return out(Out=torch.argsort(bits, stable=True).to(
        _dtype({"dtype": attrs.get("dtype", 3)})))


@register_op("sampling_id", needs_rng=True, no_grad=True, inputs=("X",),
             attr_defaults={"min": 0.0, "max": 1.0, "seed": 0, "dtype": 5})
def _sampling_id(ins, attrs):
    """One class index per row by inverse CDF over its probabilities:
    r ~ U[min, max), index = #{cumsum(p) < r}, clipped to the last class
    (reference sampling_id_op.h; a nonzero ``seed`` pins the draw)."""
    x = first(ins, "X")
    lo, hi = attrs.get("min", 0.0), attrs.get("max", 1.0)
    r = (lo + (hi - lo) * rng.uniform(attrs["_rng"](), (x.shape[0],))).to(
        x.dtype)
    idx = (torch.cumsum(x, dim=1) < r[:, None]).sum(1)
    idx = torch.clamp(idx, 0, x.shape[1] - 1)
    dt = attrs.get("dtype", 5)
    return out(Out=idx.to(torch.int32 if dt == 5 else _dtype({"dtype": dt})))


# --------------------------------------------------------------------------
# shape manipulation (the rest)
# --------------------------------------------------------------------------
@register_op("reshape", inputs=("X", "Shape", "ShapeTensor"),
             host_inputs=("Shape",) + _SHAPE_TENSORS,
             attr_defaults={"shape": []})
def _reshape(ins, attrs):
    """reshape2 without XShape (the v1 op)."""
    return out(Out=_reshape2(ins, attrs)["Out"][0])


@register_op("transpose", inputs=("X",), attr_defaults={"axis": []})
def _transpose(ins, attrs):
    return out(Out=first(ins, "X").permute(*[int(a) for a in attrs["axis"]]))


@register_op("unsqueeze", inputs=("X",), attr_defaults={"axes": []})
def _unsqueeze(ins, attrs):
    o = first(ins, "X")
    for a in sorted(attrs["axes"]):
        o = o.unsqueeze(a)
    return out(Out=o)


@register_op("flatten_contiguous_range", inputs=("X",),
             attr_defaults={"start_axis": 1, "stop_axis": 1})
def _flatten_range(ins, attrs):
    """Dims start_axis..stop_axis joined into one, and XShape."""
    x = first(ins, "X")
    nd = max(x.dim(), 1)
    s, e = attrs.get("start_axis", 1) % nd, attrs.get("stop_axis", 1) % nd
    shape = tuple(x.shape[:s]) + (math.prod(x.shape[s:e + 1]),) \
        + tuple(x.shape[e + 1:])
    return out(Out=x.reshape(shape), XShape=_xshape(x))


def _axis_of(ins, attrs):
    at = first(ins, "AxisTensor")
    return int(_host_scalar(at)) if at is not None \
        else int(attrs.get("axis", 0))


@register_op("split", inputs=("X", "AxisTensor", "SectionsTensorList"),
             host_inputs=("AxisTensor", "SectionsTensorList"),
             attr_defaults={"axis": 0, "num": 0, "sections": []})
def _split(ins, attrs):
    """X cut along ``axis`` into ``num`` equal parts or by ``sections``
    (one -1 takes the rest); ``AxisTensor`` overrides the attr and is
    read on the host."""
    x = first(ins, "X")
    ax = _axis_of(ins, attrs)
    sections = list(attrs.get("sections") or [])
    stl = seq(ins, "SectionsTensorList")
    if stl:
        sections = [int(_host_scalar(s)) for s in stl]
    if sections:
        if -1 in sections:
            known = sum(s for s in sections if s != -1)
            sections[sections.index(-1)] = x.shape[ax] - known
        parts = torch.split(x, sections, dim=ax)
    else:
        parts = torch.tensor_split(x, attrs.get("num", 0), dim=ax)
    return out(Out=list(parts))


@register_op("stack", inputs=("X",), attr_defaults={"axis": 0})
def _stack(ins, attrs):
    return out(Y=torch.stack(list(seq(ins, "X")), dim=attrs.get("axis", 0)))


@register_op("unstack", inputs=("X",), attr_defaults={"axis": 0, "num": 0})
def _unstack(ins, attrs):
    x = first(ins, "X")
    return out(Y=list(torch.unbind(x, attrs.get("axis", 0) % x.dim())))


@register_op("unbind", inputs=("X",), attr_defaults={"axis": 0})
def _unbind(ins, attrs):
    x = first(ins, "X")
    return out(Out=list(torch.unbind(x, attrs.get("axis", 0) % x.dim())))


@register_op("expand", inputs=("X", "ExpandTimes"),
             host_inputs=("ExpandTimes",),
             attr_defaults={"expand_times": []})
def _expand(ins, attrs):
    """X tiled ``expand_times`` times along each dim (``ExpandTimes``, a
    tensor read on the host, overrides the attr)."""
    x, et = first(ins, "X"), first(ins, "ExpandTimes")
    times = ([int(v) for v in et.tolist()] if et is not None
             else [int(t) for t in attrs["expand_times"]])
    return out(Out=x.tile(times))


@register_op("expand_as", inputs=("X", "target_tensor"))
def _expand_as(ins, attrs):
    x, t = first(ins, "X"), first(ins, "target_tensor")
    return out(Out=x.tile([ts // xs for ts, xs in zip(t.shape, x.shape)]))


@register_op("tile", inputs=("X",), attr_defaults={"repeat_times": []})
def _tile(ins, attrs):
    return out(Out=first(ins, "X").tile([int(r) for r in
                                         attrs["repeat_times"]]))


@register_op("slice", inputs=("Input", "StartsTensor", "EndsTensor"),
             host_inputs=("StartsTensor", "EndsTensor"),
             attr_defaults={"axes": [], "starts": [], "ends": [],
                            "decrease_axis": [], "infer_flags": []})
def _slice(ins, attrs):
    """Input[starts:ends] along ``axes`` (negative bounds count from the
    end, bounds clamped to the dim); ``StartsTensor`` / ``EndsTensor``
    override the attrs and are read on the host."""
    x = first(ins, "Input")
    st, et = first(ins, "StartsTensor"), first(ins, "EndsTensor")
    starts = ([int(v) for v in st.tolist()] if st is not None
              else [int(s) for s in attrs["starts"]])
    ends = ([int(v) for v in et.tolist()] if et is not None
            else [int(e) for e in attrs["ends"]])
    idx = [slice(None)] * x.dim()
    for ax, s, e in zip(attrs["axes"], starts, ends):
        dim = x.shape[ax]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[ax] = slice(s, max(e, s))
    o = x[tuple(idx)]
    dec = attrs.get("decrease_axis") or []
    if dec:
        keep = [s for i, s in enumerate(o.shape)
                if not (i in dec and s == 1)]
        o = o.reshape(keep or [1])
    return out(Out=o)


@register_op("strided_slice", inputs=("Input",),
             attr_defaults={"axes": [], "starts": [], "ends": [],
                            "strides": [], "decrease_axis": [],
                            "infer_flags": []})
def _strided_slice(ins, attrs):
    """Input[start:end:stride] along ``axes``, Python's slice rules (a
    negative stride walks backwards: the dim flipped, then a forward
    slice)."""
    o = first(ins, "Input")
    for ax, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                            attrs["strides"]):
        dim = o.shape[ax]
        start, stop, step = slice(s, e, st).indices(dim)
        n = len(range(start, stop, step))
        if step < 0:
            o = o.flip(ax)
            start, step = dim - 1 - start, -step
        idx = [slice(None)] * o.dim()
        idx[ax] = slice(start, start + n * step, step) if n else slice(0, 0)
        o = o[tuple(idx)]
    dec = attrs.get("decrease_axis") or []
    if dec:
        o = o.reshape([s for i, s in enumerate(o.shape) if i not in dec])
    return out(Out=o)


@register_op("reverse", inputs=("X",), attr_defaults={"axis": []})
def _reverse(ins, attrs):
    x = first(ins, "X")
    return out(Out=x.flip([a % x.dim() for a in attrs["axis"]]))


@register_op("flip", inputs=("X",), attr_defaults={"axis": []})
def _flip(ins, attrs):
    x = first(ins, "X")
    return out(Out=x.flip([a % x.dim() for a in attrs["axis"]]))


@register_op("roll", inputs=("X",), attr_defaults={"shifts": [], "dims": []})
def _roll(ins, attrs):
    """X rolled by ``shifts`` along ``dims``; with no dims, the flattened
    X rolled by the first shift."""
    x = first(ins, "X")
    dims = attrs.get("dims") or attrs.get("axis") or []
    if not dims:
        return out(Out=torch.roll(x.reshape(-1), int(attrs["shifts"][0]))
                   .reshape(x.shape))
    return out(Out=torch.roll(x, [int(s) for s in attrs["shifts"]],
                              [int(d) for d in dims]))


def _torch_pads(pairs):
    """F.pad's flat list (last dim first) from per-dim (before, after)."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [int(lo), int(hi)]
    return flat


@register_op("pad", inputs=("X",),
             attr_defaults={"paddings": [], "pad_value": 0.0})
def _pad(ins, attrs):
    x = first(ins, "X")
    p = attrs["paddings"]
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    return out(Out=torch.nn.functional.pad(
        x, _torch_pads(pairs), value=attrs.get("pad_value", 0.0)))


@register_op("pad2d", inputs=("X",),
             attr_defaults={"paddings": [0, 0, 0, 0], "mode": "constant",
                            "pad_value": 0.0, "data_format": "NCHW"})
def _pad2d(ins, attrs):
    """H and W padded by (top, bottom, left, right): a constant, the
    reflection without the edge, or the edge repeated."""
    x = first(ins, "X")
    p = [int(v) for v in attrs["paddings"]]
    mode = {"constant": "constant", "reflect": "reflect",
            "edge": "replicate"}[attrs.get("mode", "constant")]
    nhwc = attrs.get("data_format", "NCHW") != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    kw = {"value": attrs.get("pad_value", 0.0)} if mode == "constant" else {}
    o = torch.nn.functional.pad(x, [p[2], p[3], p[0], p[1]], mode=mode, **kw)
    return out(Out=o.permute(0, 2, 3, 1) if nhwc else o)


@register_op("pad_constant_like", inputs=("X", "Y"), diff_inputs=("Y",))
def _pad_constant_like(ins, attrs):
    """Y padded at the end of each dim to X's shape."""
    x, y = first(ins, "X"), first(ins, "Y")
    pairs = [(0, xs - ys) for xs, ys in zip(x.shape, y.shape)]
    return out(Out=torch.nn.functional.pad(
        y, _torch_pads(pairs), value=attrs.get("pad_value", 0.0)))


@register_op("meshgrid", inputs=("X",))
def _meshgrid(ins, attrs):
    return out(Out=[g.contiguous() for g in
                    torch.meshgrid(*seq(ins, "X"), indexing="ij")])


@register_op("tril_triu", inputs=("X",),
             attr_defaults={"diagonal": 0, "lower": True})
def _tril_triu(ins, attrs):
    x, d = first(ins, "X"), int(attrs.get("diagonal", 0))
    return out(Out=torch.tril(x, d) if attrs.get("lower", True)
               else torch.triu(x, d))


# --------------------------------------------------------------------------
# gather and scatter
# --------------------------------------------------------------------------
def _linear_index(idx, dims):
    """Row numbers of index tuples (``idx``'s last axis) into a tensor's
    leading ``dims``: an int64 tensor of ``idx.shape[:-1]``."""
    idx = idx.long()
    flat = torch.zeros(idx.shape[:-1], dtype=torch.int64, device=idx.device)
    for i, d in enumerate(dims):
        flat = flat * int(d) + idx[..., i]
    return flat


def take_rows(x, idx):
    """The rows ``idx`` (an integer tensor of any shape) of ``x``, shaped
    ``idx.shape + x.shape[1:]``, by ``_GatherRows``: the grad sums
    repeated rows in a fixed order. Every row gather of the ops (the
    embedding, the sequence ops, the losses) goes through it."""
    o = _GatherRows.apply(x, idx.reshape(-1).long())
    return o.reshape(tuple(idx.shape) + tuple(x.shape[1:]))


@register_op("gather_nd", inputs=("X", "Index"), diff_inputs=("X",))
def _gather_nd(ins, attrs):
    """X at the index tuples of Index's last axis: Index [..., k] picks
    X[i0..ik-1], a row of X's trailing dims."""
    x, idx = first(ins, "X"), first(ins, "Index")
    k = idx.shape[-1]
    rows = x.reshape((math.prod(x.shape[:k]),) + tuple(x.shape[k:]))
    return out(Out=take_rows(rows, _linear_index(idx, x.shape[:k])))


def _last_of_each(ids):
    """The positions of ``ids`` that hold the last occurrence of their
    value (what wins an overwriting scatter: XLA's CPU backend applies
    the updates in order), and those values."""
    srt, perm = torch.sort(ids, stable=True)
    last = torch.ones_like(srt, dtype=torch.bool)
    last[:-1] = srt[1:] != srt[:-1]
    return perm[last], srt[last]


@register_op("scatter", inputs=("X", "Ids", "Updates"),
             diff_inputs=("X", "Updates"), attr_defaults={"overwrite": True})
def _scatter(ins, attrs):
    """X with rows Ids replaced by Updates' rows. ``overwrite``: of
    repeated ids the last update wins; else the rows of Ids are zeroed
    and every update added, repeats in a fixed order
    (``scatter_rows_add``), so reruns are bitwise alike."""
    x, ids, upd = first(ins, "X"), first(ins, "Ids"), first(ins, "Updates")
    ids = ids.reshape(-1).long()
    if attrs.get("overwrite", True):
        pos, rows = _last_of_each(ids)
        return out(Out=x.index_copy(0, rows, take_rows(upd, pos)))
    return out(Out=x.index_fill(0, ids, 0)
               + scatter_rows_add(x.shape[0], ids, upd.to(x.dtype)))


@register_op("scatter_nd_add", inputs=("X", "Index", "Updates"),
             diff_inputs=("X", "Updates"))
def _scatter_nd_add(ins, attrs):
    """X plus Updates added at Index's tuples (its last axis), repeats
    summed in a fixed order (``scatter_rows_add``)."""
    x, idx, upd = first(ins, "X"), first(ins, "Index"), first(ins, "Updates")
    k = idx.shape[-1]
    lead = math.prod(x.shape[:k])
    rows = upd.reshape((-1,) + tuple(x.shape[k:])).to(x.dtype)
    add = scatter_rows_add(lead, _linear_index(idx, x.shape[:k]).reshape(-1),
                           rows)
    return out(Out=x + add.reshape(x.shape))


@register_op("index_select", inputs=("X", "Index"), diff_inputs=("X",),
             attr_defaults={"dim": 0})
def _index_select(ins, attrs):
    """X's slices along ``dim`` at Index (of any shape, whose dims take
    ``dim``'s place)."""
    x, idx = first(ins, "X"), first(ins, "Index")
    dim = attrs.get("dim", 0) % x.dim()
    o = take_rows(x.movedim(dim, 0), idx.long())
    ki, rest = idx.dim(), x.dim() - 1
    perm = [ki + j for j in range(dim)] + list(range(ki)) \
        + [ki + j for j in range(dim, rest)]
    return out(Out=o.permute(perm))


@register_op("index_sample", inputs=("X", "Index"), diff_inputs=("X",))
def _index_sample(ins, attrs):
    """Out[i, j] = X[i, Index[i, j]]."""
    x, idx = first(ins, "X"), first(ins, "Index")
    n, m = x.shape
    base = torch.arange(n, dtype=torch.int64, device=x.device)[:, None] * m
    return out(Out=take_rows(x.reshape(-1), base + idx.long()))


@register_op("where", inputs=("Condition", "X", "Y"), diff_inputs=("X", "Y"))
def _where(ins, attrs):
    return out(Out=torch.where(first(ins, "Condition"), first(ins, "X"),
                               first(ins, "Y")))


@register_op("where_index", inputs=("Condition",), no_grad=True,
             stateful=True)
def _where_index(ins, attrs):
    """[n, rank] int64 coordinates of Condition's true elements, in
    row-major order: the size depends on the data (an island)."""
    return out(Out=torch.nonzero(first(ins, "Condition")))


@register_op("multiplex", inputs=("X", "Ids"), diff_inputs=("X",))
def _multiplex(ins, attrs):
    """Row i of X[Ids[i]]."""
    xs = torch.stack(list(seq(ins, "X")), dim=0)       # [k, n, ...]
    k, n = xs.shape[0], xs.shape[1]
    ids = first(ins, "Ids").reshape(-1).long()
    flat = ids * n + torch.arange(n, dtype=torch.int64, device=xs.device)
    return out(Out=take_rows(xs.reshape((k * n,) + tuple(xs.shape[2:])),
                             flat))


@register_op("shard_index", inputs=("X",), no_grad=True,
             attr_defaults={"index_num": 0, "nshards": 1, "shard_id": 0,
                            "ignore_value": -1})
def _shard_index(ins, attrs):
    x = first(ins, "X")
    size = (attrs["index_num"] + attrs["nshards"] - 1) // attrs["nshards"]
    lo = attrs["shard_id"] * size
    mine = torch.div(x, size, rounding_mode="floor") == attrs["shard_id"]
    return out(Out=torch.where(mine, x - lo, torch.full(
        (), attrs.get("ignore_value", -1), dtype=x.dtype, device=x.device)))


@register_op("cross", inputs=("X", "Y"), attr_defaults={"dim": -1})
def _cross(ins, attrs):
    return out(Out=torch.linalg.cross(first(ins, "X"), first(ins, "Y"),
                                      dim=attrs.get("dim", -1)))


# --------------------------------------------------------------------------
# sorting and selection
# --------------------------------------------------------------------------
@register_op("arg_max", inputs=("X",), no_grad=True,
             attr_defaults={"axis": -1, "keepdims": False, "dtype": 3})
def _arg_max(ins, attrs):
    """The first index of the largest value along ``axis``."""
    dt = attrs.get("dtype", 3)
    return out(Out=torch.argmax(first(ins, "X"), dim=attrs.get("axis", -1))
               .to(_dtype({"dtype": dt if dt > 0 else 3})))


@register_op("arg_min", inputs=("X",), no_grad=True,
             attr_defaults={"axis": -1, "keepdims": False, "dtype": 3})
def _arg_min(ins, attrs):
    """The first index of the smallest value along ``axis`` (int64, the
    layer's var dtype)."""
    return out(Out=torch.argmin(first(ins, "X"), dim=attrs.get("axis", -1)))


def _stable_order(x, dim, descending):
    """The indices that sort ``x`` along ``dim``, equal values in index
    order (``jnp.argsort`` is stable; descending sorts -x, as the TPU
    kernel does)."""
    return torch.argsort(-x if descending else x, dim=dim, stable=True)


@register_op("argsort", inputs=("X",), no_grad=True,
             attr_defaults={"axis": -1, "descending": False})
def _argsort(ins, attrs):
    x = first(ins, "X")
    ax = attrs.get("axis", -1)
    idx = _stable_order(x, ax, attrs.get("descending", False))
    return out(Out=torch.gather(x, ax, idx), Indices=idx)


@register_op("top_k_v2", inputs=("X", "K"), diff_inputs=("X",),
             host_inputs=("K",),
             attr_defaults={"k": 1, "axis": -1, "largest": True,
                            "sorted": True})
def _top_k_v2(ins, attrs):
    """The k largest (or smallest) along ``axis``, sorted, ties to the
    lower index (``lax.top_k``'s order; ``torch.topk`` promises none on
    the card): a stable sort's first k."""
    x, kt = first(ins, "X"), first(ins, "K")
    k = int(_host_scalar(kt)) if kt is not None else attrs.get("k", 1)
    ax = attrs.get("axis", -1) % x.dim()
    idx = _stable_order(x, ax, attrs.get("largest", True)).narrow(ax, 0, k)
    return out(Out=torch.gather(x, ax, idx), Indices=idx)


def _first_occurrence_unique(x):
    """(values in first-occurrence order, each element's index into
    them, each value's count) of a flattened ``x``, on the host."""
    a = x.detach().cpu().numpy().reshape(-1)
    vals, first_idx, inv, counts = np.unique(
        a, return_index=True, return_inverse=True, return_counts=True)
    order = np.argsort(first_idx)
    remap = np.empty_like(order)
    remap[order] = np.arange(len(order))
    return vals[order], remap[inv.reshape(-1)], counts[order]


@register_op("unique", inputs=("X",), no_grad=True, stateful=True,
             attr_defaults={"dtype": 2})
def _unique(ins, attrs):
    """X's distinct values in the order they first occur (as the TPU
    kernel keeps them) and each element's index into them: the size
    depends on the data (an island)."""
    x = first(ins, "X")
    vals, index, _ = _first_occurrence_unique(x)
    dt = _dtype({"dtype": attrs.get("dtype", 2)})
    return out(Out=torch.from_numpy(vals).to(x.device),
               Index=torch.from_numpy(index).to(device=x.device, dtype=dt))


@register_op("unique_with_counts", inputs=("X",), no_grad=True,
             stateful=True, attr_defaults={"dtype": 2})
def _unique_with_counts(ins, attrs):
    x = first(ins, "X")
    vals, index, counts = _first_occurrence_unique(x)
    dt = _dtype({"dtype": attrs.get("dtype", 2)})
    return out(Out=torch.from_numpy(vals).to(x.device),
               Index=torch.from_numpy(index).to(device=x.device, dtype=dt),
               Count=torch.from_numpy(counts).to(device=x.device, dtype=dt))
