"""Sequence (LoD) operators (counterpart of paddle_tpu/ops/sequence_ops.py;
reference: paddle/fluid/operators/sequence_ops/*.cc,
framework/lod_tensor.h:104): variable-length sequence math over packed
rows.

The packed buffer ``[total_rows, ...]`` is the tensor; the LoD offsets are
host-side metadata that the executor hands a kernel in ``attrs["_lod"]``
(``{slot: [levels|None]}``, ``levels`` a tuple of offset tuples, the
finest last) and that stay fixed for a compiled plan, whose key holds the
feeds' LoDs. Every index, segment id and mask derived from them is made
on the host and copied to the device once (``_const``): a compiled plan
binds a cache into the op's attrs (``_lodc``), filled at the plan's first
run, which is eager, so a CUDA graph's capture reads device constants and
never copies from pageable host memory. A kernel declares its outputs' LoD
by returning ``{"_lod": {slot: [levels|None]}}``.

Sums run in an order that does not change from run to run, so a compiled
step is bitwise the interpreter's on the card: pooling pads the sequences
to [n, max_len] and reduces over the padded axis; gathers index rows
(``tensor_ops.take_rows``), whose grad on the card is the sorted
``index_put_(accumulate=True)`` and on the CPU ``index_add_`` in index
order (tensor_ops.scatter_rows_add), never an atomic ``index_add_``.

Ops whose output size depends on tensor values (``sequence_slice``,
``sequence_erase``) are stateful, as in the TPU package, and
``sequence_unpad`` and ``lod_reset`` read their ``Length`` / ``Y`` values
on the host when no LoD carries them: each runs in the interpreter, an
island of a segmented block.
"""
from __future__ import annotations

import numpy as np
import torch

from .math_ops import scalar_as
from .registry import register_grad_maker, register_op, first, out, seq
from .tensor_ops import scatter_rows_add, take_rows

_INT32_MAX = 2 ** 31 - 1  # jax.ops.segment_min's identity for an empty one


# --------------------------------------------------------------------------
# helpers (host-side numpy on the offsets)
# --------------------------------------------------------------------------
def _lod_of(attrs, slot, idx=0):
    lods = attrs.get("_lod") or {}
    vals = lods.get(slot)
    if not vals or idx >= len(vals) or vals[idx] is None:
        return None
    return vals[idx]


def _offs(levels):
    """Finest-level offsets as an int64 numpy array."""
    return np.asarray(levels[-1], np.int64)


def _require_lod(attrs, slot, op_name):
    lv = _lod_of(attrs, slot)
    if lv is None:
        raise ValueError(f"{op_name}: input '{slot}' must carry LoD")
    return lv


def _lens(offs):
    return offs[1:] - offs[:-1]


def _seg_ids(offs):
    return np.repeat(np.arange(len(offs) - 1), _lens(offs))


def _offsets_from_lens(lens):
    return tuple(int(x) for x in np.concatenate([[0], np.cumsum(lens)]))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _const(attrs, tag, make, device, dtype=None) -> torch.Tensor:
    """``make()`` (a numpy array derived from the LoD) as a tensor on
    ``device``: from the op's ``_lodc`` cache when the plan bound one
    (made at the plan's first, eager, run), else made now."""
    cache = attrs.get("_lodc")
    key = (tag, str(device))
    if cache is not None:
        t = cache.get(key)
        if t is not None:
            return t
    t = torch.from_numpy(np.ascontiguousarray(make()))
    if dtype is not None:
        t = t.to(dtype)
    t = t.to(device)
    if cache is not None:
        cache[key] = t
    return t


def _once(make):
    """``part(k)``: item k of ``make()``, made at the first call only."""
    box = []

    def part(k):
        if not box:
            box.append(make())
        return box[0][k]
    return part


def _bcast(m, ndim):
    """A [n] or [n, k] mask or vector shaped to broadcast over trailing
    feature dims up to ``ndim``."""
    return m.reshape(tuple(m.shape) + (1,) * (ndim - m.dim()))


def _padded(offs):
    """([n, max_len] row index, [n, max_len] validity) of the sequences
    padded to the longest: a padded slot points at row 0."""
    lens = _lens(offs)
    maxlen = int(lens.max()) if len(lens) else 0
    pos = np.arange(maxlen)[None, :]
    valid = pos < lens[:, None]
    idx = np.where(valid, pos + offs[:-1, None], 0)
    return idx.astype(np.int64), valid


# --------------------------------------------------------------------------
# sequence_pool / first / last (reference: sequence_ops/sequence_pool_op.cc)
# --------------------------------------------------------------------------
@register_op("sequence_pool", needs_lod=True, diff_inputs=["X"],
             attr_defaults={"pooltype": "AVERAGE", "pad_value": 0.0})
def _sequence_pool(ins, attrs):
    """One row per sequence: SUM, AVERAGE, SQRT (the sum over sqrt of the
    length) and MAX reduce the sequences padded to the longest; FIRST and
    LAST gather a row. MAX also gives ``MaxIndex``, the smallest row
    index holding each feature's max. An empty sequence gives
    ``pad_value``."""
    x = first(ins, "X")
    levels = _require_lod(attrs, "X", "sequence_pool")
    offs = _offs(levels)
    n = len(offs) - 1
    lens = _lens(offs)
    dev = x.device
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    feat = tuple(x.shape[1:])
    max_index = None
    if ptype in ("SUM", "AVERAGE", "SQRT", "MAX"):
        pad = _padded(offs)
        if pad[0].shape[1] == 0:
            o = torch.zeros((n,) + feat, dtype=x.dtype, device=dev)
            if ptype == "MAX":
                max_index = torch.full((n,) + feat, _INT32_MAX,
                                       dtype=torch.int32, device=dev)
        else:
            idx = _const(attrs, "pool_idx", lambda: pad[0], dev)
            valid = _bcast(_const(attrs, "pool_valid", lambda: pad[1], dev),
                           x.dim() + 1)
            g = take_rows(x, idx)
            if ptype == "MAX":
                o = torch.where(valid, g, torch.full(
                    (), float("-inf"), dtype=x.dtype, device=dev)).amax(1)
                big = torch.where((g == o[:, None]) & valid,
                                  _bcast(idx, x.dim() + 1), x.shape[0])
                max_index = big.amin(1).to(torch.int32)
                if np.any(lens == 0):
                    max_index = torch.where(
                        _bcast(_const(attrs, "pool_empty", lambda: lens == 0,
                                      dev), x.dim()),
                        _INT32_MAX, max_index)
            else:
                o = torch.where(valid, g, torch.zeros(
                    (), dtype=x.dtype, device=dev)).sum(1)
                if ptype != "SUM":
                    ln = _bcast(_const(attrs, "pool_lens",
                                       lambda: np.maximum(lens, 1), dev,
                                       x.dtype), x.dim())
                    o = o / (ln if ptype == "AVERAGE" else torch.sqrt(ln))
    elif ptype in ("FIRST", "LAST"):
        pick = offs[:-1] if ptype == "FIRST" else offs[1:] - 1
        idx = _const(attrs, "pool_pick",
                     lambda: np.where(lens > 0, pick, 0), dev)
        o = take_rows(x, idx)
    else:
        raise ValueError(f"sequence_pool: unknown pooltype {ptype}")
    if np.any(lens == 0):
        empty = _bcast(_const(attrs, "pool_empty", lambda: lens == 0, dev),
                       x.dim())
        o = torch.where(empty, torch.full((), scalar_as(
            attrs.get("pad_value", 0.0), x.dtype), dtype=x.dtype,
            device=dev), o)
    res = out(Out=o)
    if max_index is not None:
        res["MaxIndex"] = [max_index]
    # one row per sequence: the upper levels' LoD
    res["_lod"] = {"Out": [tuple(levels[:-1]) or None]}
    return res


# --------------------------------------------------------------------------
# sequence_softmax (reference: sequence_ops/sequence_softmax_op.cc)
# --------------------------------------------------------------------------
@register_op("sequence_softmax", needs_lod=True, diff_inputs=["X"])
def _sequence_softmax(ins, attrs):
    """A softmax over each sequence of a [T] or [T, 1] tensor: over the
    sequences padded to the longest (the padding at the dtype's lowest
    value, so an empty sequence's row stays finite), gathered back."""
    x = first(ins, "X")
    levels = _require_lod(attrs, "X", "sequence_softmax")
    offs = _offs(levels)
    dev = x.device
    flat = x.reshape(x.shape[0])
    pad = _padded(offs)
    maxlen = pad[0].shape[1]
    if maxlen == 0:
        return {"Out": [x], "_lod": {"Out": [levels]}}
    idx = _const(attrs, "sm_idx", lambda: pad[0], dev)
    valid = _const(attrs, "sm_valid", lambda: pad[1], dev)
    g = torch.where(valid, take_rows(flat, idx), torch.full(
        (), torch.finfo(x.dtype).min, dtype=x.dtype, device=dev))
    y = torch.softmax(g, dim=1).reshape(-1)

    def back():
        segs = _seg_ids(offs)
        return segs * maxlen + (np.arange(len(segs)) - offs[:-1][segs])
    y = take_rows(y, _const(attrs, "sm_back", back, dev))
    return {"Out": [y.reshape(x.shape)], "_lod": {"Out": [levels]}}


# --------------------------------------------------------------------------
# sequence_expand / sequence_expand_as
# (reference: sequence_ops/sequence_expand_op.cc, sequence_expand_as_op.cc)
# --------------------------------------------------------------------------
@register_op("sequence_expand", needs_lod=True, diff_inputs=["X"],
             attr_defaults={"ref_level": -1})
def _sequence_expand(ins, attrs):
    x = first(ins, "X")
    y_levels = _require_lod(attrs, "Y", "sequence_expand")
    ref_level = attrs.get("ref_level", -1)
    if ref_level < 0:
        ref_level += len(y_levels)
    rep = _lens(np.asarray(y_levels[ref_level], np.int64))
    x_levels = _lod_of(attrs, "X")
    x_offs = (np.arange(x.shape[0] + 1, dtype=np.int64) if x_levels is None
              else _offs(x_levels))  # no LoD: each row a sequence
    nseq = len(x_offs) - 1
    if len(rep) != nseq:
        raise ValueError(
            f"sequence_expand: X has {nseq} sequences but Y ref_level has "
            f"{len(rep)}")
    parts, new_lens = [], []
    for i in range(nseq):
        rows = np.arange(x_offs[i], x_offs[i + 1])
        for _ in range(int(rep[i])):
            parts.append(rows)
            new_lens.append(len(rows))
    idx = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    o = take_rows(x, _const(attrs, "expand", lambda: idx, x.device))
    new_lod = (_offsets_from_lens(np.asarray(new_lens, np.int64)),)
    return {"Out": [o], "_lod": {"Out": [new_lod]}}


@register_op("sequence_expand_as", needs_lod=True, diff_inputs=["X"])
def _sequence_expand_as(ins, attrs):
    x = first(ins, "X")
    y_levels = _require_lod(attrs, "Y", "sequence_expand_as")
    rep = _lens(_offs(y_levels))
    if len(rep) != x.shape[0]:
        raise ValueError("sequence_expand_as: Y must have one sequence per "
                         "row of X")
    o = take_rows(x, _const(attrs, "expand_as",
                        lambda: np.repeat(np.arange(x.shape[0]), rep),
                        x.device))
    return {"Out": [o],
            "_lod": {"Out": [(tuple(int(v) for v in _offs(y_levels)),)]}}


# --------------------------------------------------------------------------
# sequence_concat (reference: sequence_ops/sequence_concat_op.cc)
# --------------------------------------------------------------------------
@register_op("sequence_concat", needs_lod=True, diff_inputs=["X"])
def _sequence_concat(ins, attrs):
    """Sequence i of the output is sequence i of each input in turn."""
    xs = seq(ins, "X")
    lods = (attrs.get("_lod") or {}).get("X") or [None] * len(xs)
    all_offs = []
    for i, lv in enumerate(lods):
        if lv is None:
            raise ValueError(f"sequence_concat: input {i} must carry LoD")
        all_offs.append(_offs(lv))
    nseq = len(all_offs[0]) - 1
    starts = np.concatenate([[0], np.cumsum([x.shape[0] for x in xs])])[:-1]
    parts, new_lens = [], []
    for s in range(nseq):
        total = 0
        for k, offs in enumerate(all_offs):
            rows = np.arange(offs[s], offs[s + 1]) + starts[k]
            parts.append(rows)
            total += len(rows)
        new_lens.append(total)
    idx = np.concatenate(parts).astype(np.int64)
    o = take_rows(torch.cat(list(xs), 0),
                  _const(attrs, "concat", lambda: idx, xs[0].device))
    return {"Out": [o],
            "_lod": {"Out": [(_offsets_from_lens(np.asarray(new_lens)),)]}}


# --------------------------------------------------------------------------
# sequence_conv (reference: sequence_ops/sequence_conv_op.cc: a context
# window projection; a window row outside its sequence is zero)
# --------------------------------------------------------------------------
@register_op("sequence_conv", needs_lod=True, diff_inputs=["X", "Filter"],
             attr_defaults={"contextLength": 3, "contextStart": -1,
                            "contextStride": 1})
def _sequence_conv(ins, attrs):
    """Out[t] = [X[t + start], ..., X[t + start + len - 1]] · Filter, a
    row outside t's sequence zero: one gather of the [T, len] window rows,
    masked, then one product with Filter [len · D, out_D]."""
    x = first(ins, "X")
    filt = first(ins, "Filter")
    levels = _require_lod(attrs, "X", "sequence_conv")
    offs = _offs(levels)
    clen = int(attrs.get("contextLength", 3))
    cstart = int(attrs.get("contextStart", -1))
    T, D = x.shape[0], x.shape[1]

    def window():
        segs = _seg_ids(offs)
        src = (np.arange(T) + cstart)[:, None] + np.arange(clen)[None, :]
        valid = (src >= offs[:-1][segs][:, None]) \
            & (src < offs[1:][segs][:, None])
        return np.where(valid, src, 0).astype(np.int64), valid
    part = _once(window)
    idx = _const(attrs, "conv_idx", lambda: part(0), x.device)
    mask = _const(attrs, "conv_mask", lambda: part(1), x.device)
    patches = torch.where(mask[..., None], take_rows(x, idx), torch.zeros(
        (), dtype=x.dtype, device=x.device))
    o = patches.reshape(T, clen * D) @ filt
    return {"Out": [o], "_lod": {"Out": [levels]}}


# --------------------------------------------------------------------------
# sequence_pad / sequence_unpad
# (reference: sequence_ops/sequence_pad_op.cc, sequence_unpad_op.cc)
# --------------------------------------------------------------------------
@register_op("sequence_pad", needs_lod=True, diff_inputs=["X"],
             attr_defaults={"padded_length": -1})
def _sequence_pad(ins, attrs):
    """[n, padded_length, ...] and the lengths (int64); ``Length`` carries
    X's LoD, so a later ``sequence_unpad`` reads the lengths from it on
    the host instead of from the tensor."""
    x = first(ins, "X")
    pad_value = first(ins, "PadValue")
    levels = _require_lod(attrs, "X", "sequence_pad")
    offs = _offs(levels)
    lens = _lens(offs)
    n = len(lens)
    plen = int(attrs.get("padded_length", -1))
    maxlen = int(lens.max()) if n else 0
    if plen < 0:
        plen = maxlen
    if plen < maxlen:
        raise ValueError("sequence_pad: padded_length < longest sequence")
    dev = x.device

    def index():
        pos = np.arange(plen)[None, :]
        valid = pos < lens[:, None]
        return np.where(valid, pos + offs[:-1, None], 0).astype(np.int64)
    idx = _const(attrs, "pad_idx", index, dev)
    valid = _const(attrs, "pad_valid",
                   lambda: np.arange(plen)[None, :] < lens[:, None], dev)
    o = torch.where(_bcast(valid, x.dim() + 1), take_rows(x, idx),
                    pad_value.to(x.dtype))
    length = _const(attrs, "pad_lens", lambda: lens.astype(np.int64), dev)
    return {"Out": [o], "Length": [length],
            "_lod": {"Out": [None], "Length": [levels]}}


def _unpad_lens(ins, attrs):
    """The lengths: from the LoD that sequence_pad put on Length, else
    the Length tensor's values, read on the host."""
    lv = _lod_of(attrs, "Length")
    if lv is not None:
        return _lens(_offs(lv))
    return _host(first(ins, "Length")).astype(np.int64).reshape(-1)


def _unpad_indices(lens):
    rows = [np.stack([np.full(int(L), i), np.arange(int(L))], 1)
            for i, L in enumerate(lens)]
    return (np.concatenate(rows) if rows
            else np.zeros((0, 2), np.int64)).astype(np.int64)


@register_op("sequence_unpad", needs_lod=True, diff_inputs=["X"],
             host_inputs=("Length",))
def _sequence_unpad(ins, attrs):
    x = first(ins, "X")          # [n, plen, ...]
    lens = _unpad_lens(ins, attrs)
    rc = torch.from_numpy(_unpad_indices(lens)).to(x.device)
    o = x[rc[:, 0], rc[:, 1]]
    return {"Out": [o], "_lod": {"Out": [(_offsets_from_lens(lens),)]}}


@register_grad_maker("sequence_unpad")
def _sequence_unpad_grad_maker(op, grad_map):
    return [{
        "type": "sequence_unpad_grad",
        "inputs": {"X": op.input("X"), "Length": op.input("Length"),
                   "Out@GRAD": [grad_map[op.output("Out")[0]]]},
        "outputs": {"X@GRAD": [grad_map[op.input("X")[0]]]},
        "attrs": {},
    }]


@register_op("sequence_unpad_grad", no_grad=True, needs_lod=True,
             host_inputs=("Length",))
def _sequence_unpad_grad(ins, attrs):
    x = first(ins, "X")
    g = first(ins, "Out@GRAD")
    rc = torch.from_numpy(_unpad_indices(_unpad_lens(ins, attrs))).to(
        x.device)
    gx = torch.zeros_like(x).index_put((rc[:, 0], rc[:, 1]), g.to(x.dtype))
    return {"X@GRAD": [gx]}


# --------------------------------------------------------------------------
# sequence_reshape / sequence_reverse / sequence_slice / sequence_scatter
# --------------------------------------------------------------------------
@register_op("sequence_reshape", needs_lod=True, diff_inputs=["X"],
             attr_defaults={"new_dim": 1})
def _sequence_reshape(ins, attrs):
    x = first(ins, "X")
    offs = _offs(_require_lod(attrs, "X", "sequence_reshape"))
    new_dim = int(attrs["new_dim"])
    D = x.shape[1]
    if np.any((offs * D) % new_dim):
        raise ValueError("sequence_reshape: sequence byte length not "
                         "divisible by new_dim")
    new_offs = offs * D // new_dim
    return {"Out": [x.reshape(-1, new_dim)],
            "_lod": {"Out": [(tuple(int(v) for v in new_offs),)]}}


@register_op("sequence_reverse", needs_lod=True, diff_inputs=["X"])
def _sequence_reverse(ins, attrs):
    x = first(ins, "X")
    levels = _require_lod(attrs, "X", "sequence_reverse")
    offs = _offs(levels)

    def index():
        if len(offs) < 2:
            return np.zeros(0, np.int64)
        return np.concatenate([np.arange(offs[i + 1] - 1, offs[i] - 1, -1)
                               for i in range(len(offs) - 1)]).astype(
                                   np.int64)
    o = take_rows(x, _const(attrs, "reverse", index, x.device))
    return {"Y": [o], "_lod": {"Y": [levels]}}


def _slice_indices(ins, attrs, op_name):
    """Row indices each sequence keeps by the Offset/Length values, read
    on the host: the output's extent depends on them, so the op is
    stateful (the interpreter runs it)."""
    offset = _host(first(ins, "Offset")).astype(np.int64).reshape(-1)
    length = _host(first(ins, "Length")).astype(np.int64).reshape(-1)
    offs = _offs(_require_lod(attrs, "X", op_name))
    parts, new_lens = [], []
    for i in range(len(offs) - 1):
        s = offs[i] + offset[i]
        parts.append(np.arange(s, s + length[i]))
        new_lens.append(int(length[i]))
    idx = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return idx.astype(np.int64), np.asarray(new_lens)


@register_op("sequence_slice", needs_lod=True, stateful=True,
             diff_inputs=["X"])
def _sequence_slice(ins, attrs):
    x = first(ins, "X")
    idx, new_lens = _slice_indices(ins, attrs, "sequence_slice")
    o = take_rows(x, torch.from_numpy(idx).to(x.device))
    return {"Out": [o],
            "_lod": {"Out": [(_offsets_from_lens(new_lens),)]}}


@register_grad_maker("sequence_slice")
def _sequence_slice_grad_maker(op, grad_map):
    return [{
        "type": "sequence_slice_grad",
        "inputs": {"X": op.input("X"), "Offset": op.input("Offset"),
                   "Length": op.input("Length"),
                   "Out@GRAD": [grad_map[op.output("Out")[0]]]},
        "outputs": {"X@GRAD": [grad_map[op.input("X")[0]]]},
        "attrs": {},
    }]


@register_op("sequence_slice_grad", no_grad=True, needs_lod=True,
             stateful=True)
def _sequence_slice_grad(ins, attrs):
    x = first(ins, "X")
    g = first(ins, "Out@GRAD")
    idx, _ = _slice_indices(ins, attrs, "sequence_slice_grad")
    gx = torch.zeros_like(x).index_put(
        (torch.from_numpy(idx).to(x.device),), g.to(x.dtype))
    return {"X@GRAD": [gx]}


@register_op("sequence_scatter", needs_lod=True,
             diff_inputs=["X", "Updates"])
def _sequence_scatter(ins, attrs):
    """Out = X with Updates added at (sequence i of Ids, Ids' value) —
    duplicates summed in a fixed order (scatter_rows_add) over the
    flattened X."""
    x = first(ins, "X")          # [n, d]
    ids = first(ins, "Ids")      # packed [total, 1] int
    upd = first(ins, "Updates")  # packed [total, 1]
    offs = _offs(_require_lod(attrs, "Ids", "sequence_scatter"))
    rows = _const(attrs, "scatter_rows", lambda: _seg_ids(offs), x.device)
    flat = rows * x.shape[1] + ids.reshape(-1).long()
    add = scatter_rows_add(x.numel(), flat, upd.reshape(-1).to(x.dtype))
    return out(Out=x + add.reshape(x.shape))


# --------------------------------------------------------------------------
# sequence_enumerate / sequence_erase
# --------------------------------------------------------------------------
@register_op("sequence_enumerate", needs_lod=True, no_grad=True,
             attr_defaults={"win_size": 1, "pad_value": 0})
def _sequence_enumerate(ins, attrs):
    """[T, win]: row t holds ids t..t + win - 1 of its sequence, past the
    sequence's end ``pad_value``."""
    x = first(ins, "X")
    levels = _require_lod(attrs, "X", "sequence_enumerate")
    offs = _offs(levels)
    win = int(attrs.get("win_size", 1))
    T = x.shape[0]

    def window():
        segs = _seg_ids(offs)
        src = np.arange(T)[:, None] + np.arange(win)[None, :]
        valid = src < offs[1:][segs][:, None]
        return np.where(valid, src, 0).astype(np.int64), valid
    part = _once(window)
    idx = _const(attrs, "enum_idx", lambda: part(0), x.device)
    mask = _const(attrs, "enum_mask", lambda: part(1), x.device)
    vals = take_rows(x.reshape(-1), idx)
    o = torch.where(mask, vals, torch.full(
        (), attrs.get("pad_value", 0), dtype=vals.dtype, device=x.device))
    return {"Out": [o], "_lod": {"Out": [levels]}}


@register_op("sequence_erase", needs_lod=True, no_grad=True, stateful=True,
             attr_defaults={"tokens": []})
def _sequence_erase(ins, attrs):
    """The ids not in ``tokens``, read on the host: the output's size
    depends on the values."""
    x = first(ins, "X")
    xh = _host(x)
    offs = _offs(_require_lod(attrs, "X", "sequence_erase"))
    tokens = list(attrs.get("tokens", []))
    keep = ~np.isin(xh.reshape(-1), tokens)
    new_lens = [int(keep[offs[i]:offs[i + 1]].sum())
                for i in range(len(offs) - 1)]
    o = torch.from_numpy(np.ascontiguousarray(
        xh.reshape(-1)[keep].reshape(-1, *xh.shape[1:]))).to(x.device)
    return {"Out": [o],
            "_lod": {"Out": [(_offsets_from_lens(np.asarray(new_lens)),)]}}


# --------------------------------------------------------------------------
# lod_reset / lod_append (reference: lod_reset_op.cc, lod_append_op.cc)
# --------------------------------------------------------------------------
@register_op("lod_reset", needs_lod=True, diff_inputs=["X"],
             host_inputs=("Y",), attr_defaults={"target_lod": []})
def _lod_reset(ins, attrs):
    """X as it is under a new LoD: Y's LoD, else Y's values as offsets
    (read on the host), else ``target_lod``."""
    x = first(ins, "X")
    y = first(ins, "Y")
    if y is not None:
        y_levels = _lod_of(attrs, "Y")
        new = y_levels if y_levels is not None else (
            tuple(int(v) for v in _host(y).reshape(-1)),)
    else:
        new = (tuple(int(v) for v in attrs.get("target_lod") or []),)
    return {"Out": [x], "_lod": {"Out": [new]}}


@register_op("lod_append", needs_lod=True, diff_inputs=["X"],
             attr_defaults={"level": []})
def _lod_append(ins, attrs):
    x = first(ins, "X")
    cur = _lod_of(attrs, "X") or ()
    lvl = tuple(int(v) for v in attrs.get("level", []))
    return {"Out": [x], "_lod": {"Out": [tuple(cur) + (lvl,)]}}


# --------------------------------------------------------------------------
# im2sequence (reference: im2sequence_op.cc: image patches to a sequence)
# --------------------------------------------------------------------------
@register_op("im2sequence", needs_lod=True, diff_inputs=["X"],
             attr_defaults={"kernels": [1, 1], "strides": [1, 1],
                            "paddings": [0, 0, 0, 0]})
def _im2sequence(ins, attrs):
    """Each image's [kh, kw] patches, one row each ([C·kh·kw], the channel
    major), one sequence an image."""
    x = first(ins, "X")  # NCHW
    kh, kw = attrs["kernels"]
    sh, sw = attrs.get("strides", [1, 1])
    pu, pl, pd, pr = attrs.get("paddings", [0, 0, 0, 0])
    xp = torch.nn.functional.pad(x, (pl, pr, pu, pd))
    patches = torch.nn.functional.unfold(xp, (kh, kw), stride=(sh, sw))
    N, CKK, L = patches.shape
    o = patches.transpose(1, 2).reshape(N * L, CKK)
    lod = (_offsets_from_lens(np.full(N, L)),)
    return {"Out": [o], "_lod": {"Out": [lod]}}


# --------------------------------------------------------------------------
# sequence_mask (the TPU package's nn_extra_ops.py:147)
# --------------------------------------------------------------------------
def _sequence_mask_host_reads(op):
    """The slots sequence_mask reads on the host: MaxLenTensor, and X when
    no static ``maxlen`` gives the width."""
    if op.inputs.get("MaxLenTensor"):
        return ("MaxLenTensor",)
    maxlen = op.attrs.get("maxlen", -1)
    return ("X",) if maxlen is None or maxlen < 0 else ()


@register_op("sequence_mask", inputs=("X", "MaxLenTensor"), no_grad=True,
             host_inputs=_sequence_mask_host_reads,
             attr_defaults={"maxlen": -1, "out_dtype": 3})
def _sequence_mask(ins, attrs):
    """Y[..., j] = j < X[...], over j < maxlen: the attr, MaxLenTensor's
    value, or, when neither is set, X's largest value. A width that
    depends on values (MaxLenTensor's, or X's) is read on the host: the
    op then runs in the interpreter; with a static ``maxlen`` it
    compiles."""
    from ..fluid.core import dtype_to_torch
    x = first(ins, "X")
    mt = first(ins, "MaxLenTensor")
    maxlen = attrs.get("maxlen", -1)
    if mt is not None:
        maxlen = int(_host(mt).reshape(()))
    if maxlen is None or maxlen < 0:
        maxlen = int(_host(x).max())
    rng = torch.arange(maxlen, device=x.device)
    mask = rng[None, :] < x.reshape(-1, 1)
    mask = mask.reshape(tuple(x.shape) + (maxlen,))
    return out(Y=mask.to(dtype_to_torch(attrs.get("out_dtype", 3))))
