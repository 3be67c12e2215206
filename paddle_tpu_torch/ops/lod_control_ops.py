"""The DynamicRNN-era LoD control ops (counterpart of
paddle_tpu/ops/lod_control_ops.py; reference: operators/lod_rank_table_op.cc,
max_sequence_len_op.cc, lod_tensor_to_array_op.cc,
shrink_rnn_memory_op.cc, reorder_lod_tensor_by_rank_op.cc,
controlflow/split_lod_tensor_op.cc, merge_lod_tensor_op.cc,
recurrent_op.cc, conditional_block_infer).

The rank table sorts the sequences by length, so that each time step of a
``DynamicRNN`` runs on the prefix of the batch still alive. Every op here is
``stateful``, as in the TPU package: it runs in the interpreter (a whole
interpreted block, or an island of a segmented one) and gets its Operator
as ``attrs["_op"]`` and the scope as ``attrs["_scope"]``. The rank table and
the tensor array are host containers held by the scope; the tensors these
ops make are returned as outputs (so a segmented step carries them on to
its compiled segments), each with the LoD it declares.

The rank table and ``max_sequence_len`` come from a LoD, which is host
metadata: no device read. Row gathers go through ``tensor_ops.take_rows``,
whose grad sums in a fixed order; their indices are made on the host from
the LoD or the rank table.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import first, register_op
from .tensor_ops import take_rows


def _var(attrs, slot):
    op, scope = attrs["_op"], attrs["_scope"]
    return scope.find_var(op.input(slot)[0])


def _table(attrs):
    return _var(attrs, "RankTable").get_lod_rank_table()


def _x_lod(attrs):
    """The LoD of input X as a list of offset lists ([] for none)."""
    val = _var(attrs, "X").value()
    return val.lod() if hasattr(val, "lod") else []


def _rows(x, rows):
    return take_rows(x, torch.tensor(rows, dtype=torch.int64).to(x.device))


def _offsets(lens):
    return tuple(int(v) for v in np.concatenate([[0], np.cumsum(lens)]))


def _host_int(t) -> int:
    return int(t.reshape(-1)[0].item())


@register_op("lod_rank_table", stateful=True, no_grad=True,
             attr_defaults={"level": 0})
def _lod_rank_table(ins, attrs):
    """Out: the rank table of X's LoD level ``level`` (a row without LoD
    is a sequence of length 1), sorted by length, longest first, ties in
    sequence order (a stable sort, reference lod_rank_table.cc)."""
    from ..fluid.core import LoDRankTable
    level = int(attrs.get("level", 0))
    lod = _x_lod(attrs)
    if lod and len(lod) > level:
        offs = lod[level]
        lens = [(i, int(offs[i + 1] - offs[i])) for i in range(len(offs) - 1)]
    else:
        lens = [(i, 1) for i in range(_var(attrs, "X").value().array.shape[0])]
    lens.sort(key=lambda t: -t[1])
    op, scope = attrs["_op"], attrs["_scope"]
    scope.var(op.output("Out")[0]).set_value(LoDRankTable(lens, level))
    return {}


@register_op("max_sequence_len", stateful=True, no_grad=True,
             needs_device=True)
def _max_sequence_len(ins, attrs):
    """Out [1] int64: the rank table's longest length, made on the device
    from the host value."""
    items = _table(attrs).items
    return {"Out": [torch.full((1,), items[0][1] if items else 0,
                               dtype=torch.int64, device=attrs["_device"])],
            "_lod": {"Out": [None]}}


@register_op("lod_tensor_to_array", stateful=True, no_grad=True)
def _lod_tensor_to_array(ins, attrs):
    """Out, a tensor array: entry t holds row t of every sequence still
    alive at step t, in rank order. Splitting at a LoD level that is not
    the innermost raises (each step would be a ragged sub-sequence)."""
    from ..fluid.core import LoDTensor
    x = first(ins, "X")
    lod = _x_lod(attrs)
    table = _table(attrs)
    level = table.level
    if lod and level != len(lod) - 1:
        raise NotImplementedError(
            "lod_tensor_to_array: splitting at a non-innermost LoD level "
            f"(level={level} of {len(lod)}) — each step would itself be a "
            "ragged sub-sequence; flatten the inner level first")
    offs = (np.asarray(lod[level], np.int64) if lod
            else np.arange(x.shape[0] + 1, dtype=np.int64))
    op, scope = attrs["_op"], attrs["_scope"]
    arr = scope.var(op.output("Out")[0]).get_lod_tensor_array()
    arr.clear()
    max_len = table.items[0][1] if table.items else 0
    for t in range(max_len):
        arr.append(LoDTensor(_rows(x, [int(offs[i] + t)
                                       for i, n in table.items if t < n])))
    return {}


@register_op("shrink_rnn_memory", stateful=True, attr_defaults={})
def _shrink_rnn_memory(ins, attrs):
    """At step I the first K rows of X, K the sequences longer than I (rows
    are in rank order, so those alive are a prefix; reference
    shrink_rnn_memory_op.cc). I is read on the host."""
    x = first(ins, "X")
    i = _host_int(first(ins, "I"))
    k = sum(1 for _, n in _table(attrs).items if n > i)
    return {"Out": [x[:k]], "_lod": {"Out": [None]}}


@register_op("reorder_lod_tensor_by_rank", stateful=True)
def _reorder_lod_tensor_by_rank(ins, attrs):
    """X's sequences (rows, without LoD) in the rank table's order, the
    LoD following them (reference reorder_lod_tensor_by_rank_op.cc)."""
    x = first(ins, "X")
    lod = _x_lod(attrs)
    items = _table(attrs).items
    if lod:
        offs = np.asarray(lod[0], np.int64)
        rows = [r for i, _ in items for r in range(int(offs[i]),
                                                   int(offs[i + 1]))]
        new = (_offsets([int(offs[i + 1] - offs[i]) for i, _ in items]),)
    else:
        rows, new = [i for i, _ in items], None
    return {"Out": [_rows(x, rows)], "_lod": {"Out": [new]}}


def _mask(ins):
    return first(ins, "Mask").detach().reshape(-1).bool().cpu().numpy()


@register_op("split_lod_tensor", stateful=True, no_grad=True,
             attr_defaults={"level": 0})
def _split_lod_tensor(ins, attrs):
    """The rows of X where Mask (read on the host) holds go to OutTrue, the
    others to OutFalse (reference controlflow/split_lod_tensor_op.cc;
    IfElse's input)."""
    x, m = first(ins, "X"), _mask(ins)
    return {"OutTrue": [_rows(x, np.where(m)[0].tolist())],
            "OutFalse": [_rows(x, np.where(~m)[0].tolist())],
            "_lod": {"OutTrue": [None], "OutFalse": [None]}}


def _merge(ins, attrs):
    """Out: row r from InTrue where Mask holds, else from InFalse, each in
    its order: one row gather of the two joined."""
    m = _mask(ins)
    t, f = first(ins, "InTrue"), first(ins, "InFalse")
    src = t if t.numel() else f
    both = torch.cat([t.reshape((-1,) + tuple(src.shape[1:])).to(src.dtype),
                      f.reshape((-1,) + tuple(src.shape[1:])).to(src.dtype)])
    idx = np.empty(len(m), np.int64)
    idx[m] = np.arange(int(m.sum()))
    idx[~m] = int(m.sum()) + np.arange(int((~m).sum()))
    return {"Out": [_rows(both, idx.tolist())], "_lod": {"Out": [None]}}


@register_op("merge_lod_tensor", stateful=True, no_grad=True,
             attr_defaults={"level": 0})
def _merge_lod_tensor(ins, attrs):
    return _merge(ins, attrs)


@register_op("merge_lod_tensor_infer", stateful=True, no_grad=True,
             attr_defaults={"level": 0})
def _merge_lod_tensor_infer(ins, attrs):
    return _merge(ins, attrs)


@register_op("conditional_block_infer", stateful=True, no_grad=True,
             attr_defaults={"is_scalar_condition": False})
def _conditional_block_infer(ins, attrs):
    from .framework_ops import _conditional_block
    return _conditional_block(ins, attrs)


@register_op("recurrent", stateful=True, no_grad=True,
             attr_defaults={"has_states": True, "ex_states": [],
                            "states": [], "reverse": False,
                            "is_train": True})
def _recurrent(ins, attrs):
    """The StaticRNN step block's runner (reference recurrent_op.cc): each
    time step runs ``sub_block`` in a fresh step scope where each sequence
    input (same name, time-major [T, ...]) holds its row t and each
    ex-state the previous step's state (the initial states matched by
    position); the step outputs are stacked into [T, ...] outputs."""
    from ..fluid.core import LoDTensor
    op, scope = attrs["_op"], attrs["_scope"]
    xs = op.input("inputs")
    ex_states = list(attrs.get("ex_states", []))
    states = list(attrs.get("states", []))
    outs = op.output("outputs")
    seqs = {n: scope.find_var(n).value().array for n in xs}
    T = seqs[xs[0]].shape[0]
    prev = {ex: scope.find_var(init).value().array
            for ex, init in zip(ex_states, op.input("initial_states"))}
    collected = {o: [] for o in outs}
    rev = attrs.get("reverse", False)
    for t in (range(T - 1, -1, -1) if rev else range(T)):
        step = scope.new_scope()
        for n, x in seqs.items():
            step.var(n).set_value(LoDTensor(x[t]))
        for ex in ex_states:
            step.var(ex).set_value(LoDTensor(prev[ex]))
        attrs["_run_block"](attrs["sub_block"], step)
        for ex, st in zip(ex_states, states):
            prev[ex] = step.find_var(st).value().array
        for o in outs:
            v = step.find_var(o)
            if v is not None and v.is_initialized():
                collected[o].append(v.value().array)
    stacked = [torch.stack(v[::-1] if rev else v) if v else None
               for v in collected.values()]
    return {"outputs": stacked, "_lod": {"outputs": [None] * len(outs)}}
