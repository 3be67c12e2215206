"""Framework op kernels (counterpart of paddle_tpu/ops/framework_ops.py).
So far: print.

A stateful op runs only in the interpreter (as a whole interpreted block,
or as an island of a segmented one), which passes it its Operator as
``attrs["_op"]``: the TPU package's kernels read the same through their
``_ctx``."""
from __future__ import annotations

import torch

from .registry import first, out, register_op


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
