"""Program debugging helpers (counterpart of paddle_tpu/fluid/debugger.py;
reference: python/paddle/fluid/debugger.py pprint_program_codes).

``pprint_program_codes`` renders a Program as readable pseudo-code, the
same text as the TPU package's for the same program. The graphviz
drawing (``draw_block_graphviz``, over net_drawer) is not ported; the
``graph_viz_pass`` of ir.py writes a block as dot."""
from __future__ import annotations

__all__ = ["pprint_program_codes", "pprint_block_codes", "repr_program"]


def _fmt_attr(v):
    if hasattr(v, "idx"):  # a sub-block
        return f"block[{v.idx}]"
    r = repr(v)
    return r if len(r) <= 40 else r[:37] + "..."


def pprint_block_codes(block, show_backward=False) -> str:
    lines = [f"# block {block.idx} (parent {block.parent_idx})"]
    for v in block.vars.values():
        flag = " persistable" if v.persistable else ""
        lines.append(f"var {v.name}: shape={list(v.shape)}{flag}")
    for op in block.ops:
        if not show_backward and op.type.endswith("_grad"):
            continue
        outs = ", ".join(f"{s}={ns}" for s, ns in op.outputs.items())
        ins = ", ".join(f"{s}={ns}" for s, ns in op.inputs.items())
        attrs = ", ".join(f"{k}={_fmt_attr(v)}"
                          for k, v in sorted(op.attrs.items())
                          if not k.startswith("_") and k != "op_role_var")
        lines.append(f"{outs} = {op.type}({ins})  # {attrs}")
    return "\n".join(lines)


def pprint_program_codes(program, show_backward=False) -> str:
    text = "\n\n".join(pprint_block_codes(b, show_backward)
                       for b in program.blocks)
    print(text)
    return text


repr_program = pprint_program_codes
