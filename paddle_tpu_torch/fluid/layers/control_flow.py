"""Control-flow layers (counterpart of paddle_tpu/fluid/layers/
control_flow.py; reference: python/paddle/fluid/layers/control_flow.py).
So far: Print."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["Print"]


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """The print op: prints ``input`` when the op runs (a host read, so a
    compiled block runs it as an island) and returns it as a new Variable
    of the same shape."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"first_n": first_n, "message": message or "",
                            "summarize": summarize,
                            "print_tensor_name": print_tensor_name,
                            "print_tensor_type": print_tensor_type,
                            "print_tensor_shape": print_tensor_shape,
                            "print_tensor_lod": print_tensor_lod,
                            "print_phase": print_phase.upper()})
    return out
