"""Autodiff: append_backward (counterpart of paddle_tpu/fluid/backward.py;
reference: python/paddle/fluid/backward.py:1193).

Walks forward ops in reverse emitting ``<op>_grad`` op descs with the
reference slot convention (inputs = fwd inputs + fwd outputs + Out@GRAD
slots; outputs = X@GRAD slots; empty slots use the @EMPTY@ sentinel), sums
fan-in gradients (reference _addup_repetitive_outputs_: duplicate writes
are renamed ``<grad>@RENAME@<k>`` and a ``sum`` op joins them), and prunes
ops not on the loss→parameter path.

Grad semantics come from each op's registered grad maker, or mechanically
from the forward kernel by torch autograd (ops/registry.py
run_generic_grad). The emitted grad op records its forward-input slot
names in the ``_fwd_in`` attr so the executor can rebuild the forward
call, and a grad op of a random op records the forward op's index in
``_fwd_idx`` so the re-run forward draws what the forward drew.
``calc_gradient`` comes in a later slice.
"""
from __future__ import annotations

from typing import Dict, List, Set

from .framework import Block, Operator, Parameter, Variable, grad_var_name
from ..ops.registry import OPS, resolve_base_info

__all__ = ["append_backward", "calc_gradient", "gradients"]

EMPTY_VAR = "@EMPTY@"

# op_role values (reference: framework/op_proto_maker.h OpRole)
OP_ROLE_FORWARD = 0
OP_ROLE_BACKWARD = 1
OP_ROLE_OPTIMIZE = 2
OP_ROLE_LOSS = 256


def _op_no_grad(op_type: str) -> bool:
    """True for unknown ops and for ops that neither differentiate nor
    have a grad maker; a ``*_grad`` type answers as its base op."""
    info = resolve_base_info(op_type)
    return info is None or (info.no_grad and info.grad_maker is None)


def _find_loss_op(block: Block, loss: Variable) -> int:
    for i in range(len(block.ops) - 1, -1, -1):
        if loss.name in block.ops[i].output_arg_names:
            return i
    raise ValueError(f"loss var {loss.name} not produced in block")


def _vars_requiring_grad(block: Block, ops: List[Operator],
                         no_grad_set: Set[str]) -> Set[str]:
    """Forward propagation of requires-grad from trainable params/inputs."""
    req: Set[str] = set()
    for v in block.vars.values():
        if isinstance(v, Parameter) and v.trainable \
                and v.name not in no_grad_set:
            req.add(v.name)
        elif not v.stop_gradient and v.name not in no_grad_set:
            # any var with stop_gradient=False is a grad leaf/carrier
            # (reference backward.py semantics)
            req.add(v.name)
    for op in ops:
        if _op_no_grad(op.type):
            continue
        if any(n in req for n in op.input_arg_names):
            for n in op.output_arg_names:
                v = block.vars.get(n)
                if (v is None or not v.stop_gradient) \
                        and n not in no_grad_set:
                    req.add(n)
    return req


def _ops_on_path(ops: List[Operator], loss_name: str) -> Set[int]:
    """Indices of the ops the loss depends on."""
    needed = {loss_name}
    keep = set()
    for i in range(len(ops) - 1, -1, -1):
        op = ops[i]
        if any(n in needed for n in op.output_arg_names):
            keep.add(i)
            needed.update(op.input_arg_names)
    return keep


def _default_grad_op_descs(op: Operator, grad_map: Dict[str, str],
                           req: Set[str], no_grad_set: Set[str]):
    """The generic ``<op>_grad`` desc for a forward op, or None when no
    output grad flows in or no input needs a grad."""
    info = OPS.get(op.type) if OPS.has(op.type) else None
    inputs: Dict[str, List[str]] = {s: list(ns) for s, ns in op.inputs.items()}
    for slot, names in op.outputs.items():
        inputs.setdefault(slot, list(names))
    has_any_ograd = False
    for slot, names in op.outputs.items():
        gnames = [grad_map.get(n, EMPTY_VAR) for n in names]
        has_any_ograd |= any(g != EMPTY_VAR for g in gnames)
        inputs[slot + "@GRAD"] = gnames
    if not has_any_ograd:
        return None
    outputs: Dict[str, List[str]] = {}
    allowed = set(info.diff_input_slots) if (info and info.diff_input_slots) \
        else None
    for slot, names in op.inputs.items():
        if allowed is not None and slot not in allowed:
            continue
        gnames = [grad_var_name(n) if n in req and n not in no_grad_set
                  else EMPTY_VAR for n in names]
        if any(g != EMPTY_VAR for g in gnames):
            outputs[slot + "@GRAD"] = gnames
    if not outputs:
        return None
    attrs = dict(op.attrs)
    attrs["_fwd_in"] = list(op.inputs.keys())
    return [{"type": op.type + "_grad", "inputs": inputs,
             "outputs": outputs, "attrs": attrs}]


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """reference backward.py:1193 — returns [(param, grad_var), ...].
    ``callbacks`` and ``checkpoints`` are accepted and ignored, as in the
    TPU package (its backward.py:150-152): recompute goes through
    ``RecomputeOptimizer``, whose checkpoints the optimizer records."""
    program = loss.block.program
    block = loss.block
    no_grad = set()
    if no_grad_set:
        no_grad.update(v.name if isinstance(v, Variable) else v
                       for v in no_grad_set)
    for v in block.vars.values():
        if v.stop_gradient and not isinstance(v, Parameter):
            no_grad.add(v.name)

    loss_idx = _find_loss_op(block, loss)
    fwd_ops = block.ops[:loss_idx + 1]
    req = _vars_requiring_grad(block, fwd_ops, no_grad)
    req.add(loss.name)
    path = _ops_on_path(fwd_ops, loss.name)

    block.ops[loss_idx].attrs.setdefault("op_role", OP_ROLE_LOSS)

    # seed: d loss / d loss = 1
    grad_map: Dict[str, str] = {loss.name: grad_var_name(loss.name)}
    block.append_op(
        type="fill_constant", inputs={},
        outputs={"Out": [grad_var_name(loss.name)]},
        attrs={"shape": [1], "value": 1.0, "dtype": loss.dtype,
               "op_role": OP_ROLE_BACKWARD})
    gv = block.create_var(name=grad_var_name(loss.name), dtype=loss.dtype,
                          shape=(1,), persistable=False)
    gv.stop_gradient = False

    # reverse sweep
    pending_descs = []
    for i in range(loss_idx, -1, -1):
        if i not in path:
            continue
        op = fwd_ops[i]
        if _op_no_grad(op.type):
            continue
        if not any(n in req and n not in no_grad for n in op.input_arg_names):
            continue
        info = OPS.get(op.type) if OPS.has(op.type) else None
        if info is not None and info.grad_maker is not None:
            # a branch no loss grad flows into reaches no maker
            if not any(n in grad_map for n in op.output_arg_names):
                continue
            descs = info.grad_maker(op, {**{n: grad_map.get(n, EMPTY_VAR)
                                            for n in op.output_arg_names},
                                         **{n: grad_var_name(n)
                                            for n in op.input_arg_names
                                            if n in req and n not in no_grad}})
            if descs is None:
                continue
        else:
            descs = _default_grad_op_descs(op, grad_map, req, no_grad)
            if descs is None:
                continue
            if info is not None and info.needs_rng:
                # the re-run forward must draw what the forward drew
                for d in descs:
                    d["attrs"].setdefault("_fwd_idx", i)
        for d in descs:
            pending_descs.append(d)
            # record primal→grad now: grad ops of earlier forward ops
            # (emitted later in this sweep) consume these names
            for slot, names in d["outputs"].items():
                if not slot.endswith("@GRAD"):
                    continue
                fwd_names = d["inputs"].get(slot[:-5], [])
                for pn, gn in zip(fwd_names, names):
                    if gn != EMPTY_VAR:
                        grad_map.setdefault(pn, gn)
        # a maker's descs need not mirror the primal slots (dropout_grad
        # has no "X" input): any desc output named grad_var_name(input) IS
        # that input's grad
        produced = {n2 for d in descs
                    for ns in d["outputs"].values() for n2 in ns}
        for pn in op.input_arg_names:
            gn = grad_var_name(pn)
            if gn in produced:
                grad_map.setdefault(pn, gn)

    # gradient fan-in: rename duplicate writes, insert sum ops
    write_counts: Dict[str, int] = {}
    for d in pending_descs:
        for names in d["outputs"].values():
            for n in names:
                if n != EMPTY_VAR:
                    write_counts[n] = write_counts.get(n, 0) + 1
    renamed: Dict[str, List[str]] = {}
    for d in pending_descs:
        for names in d["outputs"].values():
            for k, n in enumerate(names):
                if n == EMPTY_VAR or write_counts.get(n, 0) <= 1:
                    continue
                parts = renamed.setdefault(n, [])
                parts.append(f"{n}@RENAME@{len(parts)}")
                names[k] = parts[-1]

    final_ops: List[dict] = []
    summed: Set[str] = set()
    for d in pending_descs:
        final_ops.append(d)
        # after the op that writes the last part, insert the sum
        written = [n for ns in d["outputs"].values() for n in ns]
        for name, parts in renamed.items():
            if name not in summed and parts and parts[-1] in written:
                final_ops.append({"type": "sum", "inputs": {"X": list(parts)},
                                  "outputs": {"Out": [name]}, "attrs": {}})
                summed.add(name)

    # materialize ops + grad vars
    for d in final_ops:
        attrs = dict(d.get("attrs") or {})
        attrs.setdefault("op_role", OP_ROLE_BACKWARD)
        block.append_op(type=d["type"], inputs=d["inputs"],
                        outputs=d["outputs"], attrs=attrs)
        for names in d["outputs"].values():
            for n in names:
                if n == EMPTY_VAR or n in block.vars:
                    continue
                pv = block.vars.get(n.split("@GRAD")[0])
                block.create_var(
                    name=n, dtype=pv.dtype if pv else loss.dtype,
                    shape=pv.shape if pv else (), persistable=False)

    if parameter_list is not None:
        params = [program.global_block().var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [v for v in program.global_block().all_parameters()
                  if v.trainable]
    result = []
    for p in params:
        gname = grad_var_name(p.name)
        if gname in block.vars:
            result.append((p, block.vars[gname]))
    program._appending_grad_times += 1
    return result


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """reference backward.py:1599: the grads of ``targets`` with respect to
    ``inputs`` (None for an input no target depends on). The cotangent of
    every target element is 1: the sweep runs from the sum of each
    target's ``reduce_sum``; ``target_gradients`` are not supported, as in
    the TPU package."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    assert target_gradients is None, "target_gradients: pending"
    from .layers import nn as _nn
    loss = None
    for t in targets:
        m = _nn.reduce_sum(t)
        loss = m if loss is None else _nn.elementwise_add(loss, m)
    # the inputs (often data vars, which stop gradients) join the sweep's
    # requires-grad set for its length, or no grad op would reach them
    restore = [(iv, iv.stop_gradient) for iv in inputs]
    for iv in inputs:
        iv.stop_gradient = False
    try:
        append_backward(loss, no_grad_set=no_grad_set)
    finally:
        for iv, sg in restore:
            iv.stop_gradient = sg
    block = targets[0].block
    return [block.vars.get(grad_var_name(iv.name)) for iv in inputs]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
