"""Framework op kernels (counterpart of paddle_tpu/ops/framework_ops.py).
So far: feed, fetch and print.

A stateful op runs only in the interpreter (as a whole interpreted block,
or as an island of a segmented one), which passes it its Operator as
``attrs["_op"]`` and the scope as ``attrs["_scope"]``: the TPU package's
kernels read the same through their ``_ctx``.

``feed`` and ``fetch`` are the ops a saved inference program records its
interface with (reference: operators/feed_op.cc, fetch_op.cc): ``feed``
copies column ``col`` of the feed list var into its Out, ``fetch`` puts
its X into column ``col`` of the fetch list var. ``Executor.run`` takes
feeds and fetches by name and runs a block without them (as the TPU
package's compiled path does), so these kernels run only when a caller
interprets such a block op by op over a scope that holds the lists."""
from __future__ import annotations

import torch

from .registry import first, out, register_op


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
