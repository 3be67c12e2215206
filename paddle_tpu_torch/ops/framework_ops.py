"""Framework op kernels (counterpart of paddle_tpu/ops/framework_ops.py).
So far: feed, fetch, print, assert, the control flow (while,
conditional_block, select_input, select_output), the tensor-array ops
(write_to_array, read_from_array, lod_array_length,
tensor_array_to_tensor, array_to_lod_tensor), rnn_memory_helper and
py_func.

A stateful op runs only in the interpreter (as a whole interpreted block,
or as an island of a segmented one), which passes it its Operator as
``attrs["_op"]``, the scope as ``attrs["_scope"]`` and, to run a
sub-block, ``attrs["_run_block"](block, scope, iteration=None)``: the
TPU package's kernels read the same through their ``_ctx``. A sub-block
runs over the same scope, op by op, its random ops keyed by (program
seed, step, the block's index, the op's index) and, inside a ``while``,
the iteration (fluid/executor.py). These kernels are the interpreter's
semantics, the oracle of the executor's compiled lowering: a conditional
runs only its taken branch, a ``while`` reads its condition on the host
before each iteration.

``feed`` and ``fetch`` are the ops a saved inference program records its
interface with (reference: operators/feed_op.cc, fetch_op.cc): ``feed``
copies column ``col`` of the feed list var into its Out, ``fetch`` puts
its X into column ``col`` of the fetch list var. ``Executor.run`` takes
feeds and fetches by name and runs a block without them (as the TPU
package's compiled path does), so these kernels run only when a caller
interprets such a block op by op over a scope that holds the lists."""
from __future__ import annotations

import numpy as np
import torch

from .registry import first, out, register_op, seq

_MAX_WHILE_ITERS = 10_000_000


def host_bool(t: torch.Tensor) -> bool:
    """The first element of a condition tensor, read on the host."""
    return bool(t.reshape(-1)[0].item())


def _host_int(t: torch.Tensor) -> int:
    return int(t.reshape(-1)[0].item())


@register_op("feed", stateful=True, no_grad=True, attr_defaults={"col": 0})
def _feed(ins, attrs):
    from ..fluid.core import LoDTensor
    op, scope = attrs["_op"], attrs["_scope"]
    val = scope.find_var(op.input("X")[0]).value()[attrs.get("col", 0)]
    scope.var(op.output("Out")[0]).set_value(
        val if isinstance(val, LoDTensor) else LoDTensor(torch.as_tensor(val)))
    return {}


@register_op("fetch", stateful=True, no_grad=True, attr_defaults={"col": 0})
def _fetch(ins, attrs):
    op, scope = attrs["_op"], attrs["_scope"]
    src = scope.find_var(op.input("X")[0]).value()
    fetch_var = scope.var(op.output("Out")[0])
    lst = fetch_var.value()
    if not isinstance(lst, list):
        lst = []
        fetch_var.set_value(lst)
    col = attrs.get("col", 0)
    while len(lst) <= col:
        lst.append(None)
    lst[col] = src
    return {}


@register_op("print", inputs=("In",), stateful=True, no_grad=True,
             attr_defaults={"first_n": -1, "message": "", "summarize": 20,
                            "print_tensor_name": True,
                            "print_tensor_type": True,
                            "print_tensor_shape": True,
                            "print_tensor_lod": True, "print_phase": "BOTH"})
def _print(ins, attrs):
    """Prints the message, the var's name and shape and its first
    ``summarize`` values (a host read, as the TPU kernel's), and passes
    the tensor on as Out."""
    x = first(ins, "In")
    op = attrs.get("_op")
    name = op.input("In")[0] if op is not None else "In"
    data = x.detach().reshape(-1)[:attrs.get("summarize", 20)].cpu()
    if data.dtype == torch.bfloat16:  # numpy has no bf16
        data = data.float()
    print(f"{attrs.get('message', '')} Variable: {name} shape: "
          f"{list(x.shape)} data: {data.numpy()}")
    return out(Out=x)


@register_op("assert", stateful=True, no_grad=True,
             attr_defaults={"summarize": -1})
def _assert(ins, attrs):
    """Raises AssertionError with the Data tensors when any element of
    Cond is false (a host read)."""
    if not bool(first(ins, "Cond").all().item()):
        data = [x.detach().cpu().numpy() for x in seq(ins, "Data")
                if x is not None]
        raise AssertionError(f"Assert failed; data={data}")
    return {}


@register_op("py_func", stateful=True, no_grad=True, needs_device=True,
             attr_defaults={"forward_callable_id": 0,
                            "backward_callable_id": -1,
                            "backward_skip_vars": []})
def _py_func(ins, attrs):
    """The Python callable ``forward_callable_id`` on the X tensors as
    numpy arrays, on the host (an island); its results become the Out
    tensors on the executor's device, a float64 result as float32, as
    the TPU package's jnp.asarray gives it. The op has no grad in the
    TPU package, so ``backward_callable_id`` is never called."""
    from ..fluid.layers.py_func_registry import get_callable
    res = get_callable(attrs["forward_callable_id"])(
        *[x.detach().cpu().numpy() for x in seq(ins, "X")])
    if not isinstance(res, (list, tuple)):
        res = [res]
    outs = []
    for r in res:
        a = np.asarray(r)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        outs.append(torch.from_numpy(np.ascontiguousarray(a))
                    .to(attrs["_device"]))
    return out(Out=outs)


# --------------------------------------------------------------------------
# control flow (reference: controlflow/while_op.cc,
# conditional_block_op.cc, select_input_op.cc, select_output_op.cc)
# --------------------------------------------------------------------------
@register_op("while", stateful=True, no_grad=True,
             attr_defaults={"is_test": False})
def _while(ins, attrs):
    """Runs ``sub_block`` over the scope while Condition holds, reading
    the condition on the host before each iteration."""
    op, scope = attrs["_op"], attrs["_scope"]
    cond = op.input("Condition")[0]
    it = 0
    while host_bool(scope.find_var(cond).value().array):
        attrs["_run_block"](attrs["sub_block"], scope, it)
        it += 1
        if it > _MAX_WHILE_ITERS:
            raise RuntimeError("while op exceeded max iterations")
    return {}


@register_op("conditional_block", stateful=True, no_grad=True,
             attr_defaults={"is_scalar_condition": False})
def _conditional_block(ins, attrs):
    """Runs ``sub_block`` over the scope when the scalar Cond holds (or,
    without ``is_scalar_condition``, when every Input is initialized)."""
    op, scope = attrs["_op"], attrs["_scope"]
    if attrs.get("is_scalar_condition", False):
        run = host_bool(first(ins, "Cond"))
    else:
        run = all(v is not None for v in seq(ins, "Input"))
    if run:
        attrs["_run_block"](attrs["sub_block"], scope)
    return {}


@register_op("select_input", stateful=True, no_grad=True)
def _select_input(ins, attrs):
    """Out = X[Mask]: the branch output a ``cond`` took."""
    return out(Out=seq(ins, "X")[_host_int(first(ins, "Mask"))])


@register_op("select_output", stateful=True, no_grad=True)
def _select_output(ins, attrs):
    """Out[Mask] = X; the other outputs stay as they are."""
    n = len(attrs["_op"].output("Out"))
    m = _host_int(first(ins, "Mask"))
    return {"Out": [first(ins, "X") if i == m else None for i in range(n)]}


# --------------------------------------------------------------------------
# tensor arrays (reference: controlflow/tensor_array_read_write_op.cc,
# lod_array_length_op.cc, tensor_array_to_tensor_op.cc,
# array_to_lod_tensor_op.cc)
# --------------------------------------------------------------------------
def _array(attrs, slot):
    op, scope = attrs["_op"], attrs["_scope"]
    names = op.input(slot) if slot in op.inputs else op.output(slot)
    return scope.var(names[0]).get_lod_tensor_array()


@register_op("write_to_array", stateful=True, no_grad=True)
def _write_to_array(ins, attrs):
    """Entry I of the array Out becomes a copy of X (the array grows with
    empty entries up to I): a copy, so that a later in-place write of X's
    storage (a graph's buffer) does not reach the array."""
    from ..fluid.core import LoDTensor
    i = _host_int(first(ins, "I"))
    arr = _array(attrs, "Out")
    while len(arr) <= i:
        arr.append(LoDTensor())
    arr[i] = LoDTensor(first(ins, "X").clone())
    return {}


@register_op("read_from_array", stateful=True, no_grad=True)
def _read_from_array(ins, attrs):
    return out(Out=_array(attrs, "X")[_host_int(first(ins, "I"))].array)


@register_op("lod_array_length", stateful=True, no_grad=True,
             needs_device=True)
def _lod_array_length(ins, attrs):
    return out(Out=torch.full((1,), len(_array(attrs, "X")),
                              dtype=torch.int64, device=attrs["_device"]))


@register_op("tensor_array_to_tensor", stateful=True, no_grad=True,
             needs_device=True, attr_defaults={"axis": 0, "use_stack": False})
def _tensor_array_to_tensor(ins, attrs):
    """The entries stacked (``use_stack``) or joined along ``axis``, and
    OutIndex: each entry's size along ``axis`` (int32)."""
    xs = [t.array for t in _array(attrs, "X")]
    ax = attrs.get("axis", 0)
    o = torch.stack(xs, ax) if attrs.get("use_stack", False) \
        else torch.cat(xs, ax)
    idx = torch.tensor([x.shape[ax] for x in xs], dtype=torch.int32)
    return out(Out=o, OutIndex=idx.to(attrs["_device"]))


@register_op("array_to_lod_tensor", stateful=True, no_grad=True)
def _array_to_lod_tensor(ins, attrs):
    """The entries joined along axis 0. With a RankTable (a DynamicRNN's
    outputs, lod_tensor_to_array's inverse: row r of entry t is step t of
    the rank-r sequence) the sequences are put back together in their
    original order, with their LoD: one row gather of the joined entries,
    whose index is made on the host from the rank table."""
    from .tensor_ops import take_rows
    arr = _array(attrs, "X")
    if not attrs["_op"].input("RankTable"):
        return out(Out=torch.cat([t.array for t in arr], 0))
    if not arr:
        raise ValueError("array_to_lod_tensor: empty array")
    op, scope = attrs["_op"], attrs["_scope"]
    items = scope.find_var(op.input("RankTable")[0]).get_lod_rank_table().items
    start, at = [], 0  # where each entry's rows begin in the joined tensor
    for t in arr:
        start.append(at)
        at += t.array.shape[0]
    rows, lens = [], [0] * len(items)
    for r, (i, n) in sorted(enumerate(items), key=lambda e: e[1][0]):
        rows.extend(start[t] + r for t in range(n))
        lens[i] = n
    lod = tuple(int(v) for v in np.concatenate([[0], np.cumsum(lens)]))
    joined = torch.cat([t.array for t in arr], 0)
    idx = torch.tensor(rows, dtype=torch.int64).to(joined.device)
    return {"Out": [take_rows(joined, idx)], "_lod": {"Out": [(lod,)]}}


@register_op("rnn_memory_helper", inputs=("X",))
def _rnn_memory_helper(ins, attrs):
    """Out = X (reference rnn_memory_helper_op.cc: a recurrence's memory
    passed on)."""
    return out(Out=first(ins, "X"))
