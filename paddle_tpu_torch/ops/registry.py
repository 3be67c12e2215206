"""Operator registry (reference: paddle/fluid/framework/op_info.h:124,
op_registry.h:223).

Every op has ONE kernel ``kernel(ins, attrs) -> outs`` over torch
tensors, which the executor applies op by op. Device placement follows
the input tensors; ops that create tensors from nothing take the device
from ``attrs["_device"]`` and their random key from ``attrs["_rng"]()``.

What the executor's compiled step needs to know of an op (counterpart of
the TPU package's registry.py:48-71): ``stateful`` (side effects beyond
its outputs: the block runs interpreted) and ``host_inputs`` (input slots
whose VALUES the kernel reads on the host, such as a shape tensor: a
block that connects one of them runs interpreted, since a CUDA graph
cannot replay a host read; ``host_inputs`` may instead be a function of
the op that gives the slots it reads, for a kernel that reads a slot's
values only under some attrs).

Gradients (counterpart of the TPU package's registry.py:201-321): by
default an op's grad is derived mechanically from its forward kernel.
The ``<op>_grad`` op that ``fluid.backward`` emits follows the reference
slot convention — inputs = forward inputs + forward outputs +
``<out_slot>@GRAD``; outputs = ``<in_slot>@GRAD`` — and
``run_generic_grad`` re-runs the forward kernel under torch autograd and
differentiates it with respect to the differentiable leaves of
``diff_input_slots``. Ops whose grad semantics differ (dropout's Mask)
register a grad maker that emits their own grad ops.

Kernel calling convention:
    ins:   dict slot_name -> list of tensors (or None for absent
           dispensable slots).
    attrs: dict of python attr values. The executor injects:
           ``_rng``    (a callable returning the op's random key, an
                       int64 [1] tensor on its device, derived on first
                       call: ops/rng.py) if the op declared needs_rng,
           ``_device`` (torch.device) if the op declared needs_device.
    returns: dict slot_name -> list of tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class OpInfo:
    __slots__ = ("type", "kernel", "infer_shape", "grad_maker", "no_grad",
                 "needs_rng", "needs_device", "stateful", "diff_input_slots",
                 "attr_defaults", "input_slots", "output_slots",
                 "host_inputs", "needs_lod")

    def __init__(self, type_: str):
        self.type = type_
        self.kernel: Optional[Callable] = None
        self.infer_shape: Optional[Callable] = None
        # custom: (op, grad_map) -> [op-desc dicts]
        self.grad_maker: Optional[Callable] = None
        self.no_grad = False
        self.needs_rng = False
        self.needs_device = False
        self.stateful = False
        self.diff_input_slots: Optional[Sequence[str]] = None
        self.attr_defaults: Dict[str, Any] = {}
        self.input_slots: Optional[Sequence[str]] = None
        self.output_slots: Optional[Sequence[str]] = None
        self.host_inputs: Sequence[str] = ()
        self.needs_lod = False


class OpInfoMap:
    def __init__(self):
        self._map: Dict[str, OpInfo] = {}

    def get(self, type_: str) -> OpInfo:
        info = self._map.get(type_)
        if info is None:
            raise KeyError(f"operator '{type_}' is not registered")
        return info

    def has(self, type_: str) -> bool:
        return type_ in self._map

    def get_or_create(self, type_: str) -> OpInfo:
        if type_ not in self._map:
            self._map[type_] = OpInfo(type_)
        return self._map[type_]

    def all_op_types(self):
        return sorted(self._map.keys())


OPS = OpInfoMap()


def resolve_base_info(op_type: str) -> Optional[OpInfo]:
    """Registry info for an op type, resolving ``*_grad`` names to their
    base op; None for unknown types."""
    t = op_type
    if OPS.has(t):
        return OPS.get(t)
    while t.endswith("_grad"):
        t = t[:-5]
        if OPS.has(t):
            return OPS.get(t)
    return None


def register_op(type_: str, *, no_grad: bool = False, needs_rng: bool = False,
                needs_device: bool = False, stateful: bool = False,
                needs_lod: bool = False,
                diff_inputs: Optional[Sequence[str]] = None,
                infer_shape: Optional[Callable] = None,
                attr_defaults: Optional[Dict[str, Any]] = None,
                inputs: Optional[Sequence[str]] = None,
                outputs: Optional[Sequence[str]] = None,
                host_inputs=None):
    """Decorator registering a forward kernel under op name ``type_``.

    ``needs_lod``: the kernel reads LoD (variable-length sequence)
    metadata: the executor passes ``attrs["_lod"] = {slot: [levels|None]}``
    (``levels`` a tuple of offset tuples, the finest last), host-side and
    fixed for a plan, whose key holds the feeds' LoDs. A kernel may return
    ``{"_lod": {out_slot: [levels|None]}}`` to set its outputs' LoD;
    otherwise the executor shares the first LoD-bearing input's LoD with
    each output of the same leading length (the reference's ShareLoD)."""
    def deco(fn: Callable):
        info = OPS.get_or_create(type_)
        info.kernel = fn
        info.no_grad = no_grad
        info.needs_rng = needs_rng
        info.needs_device = needs_device
        info.stateful = stateful
        info.needs_lod = needs_lod
        info.diff_input_slots = diff_inputs
        info.infer_shape = infer_shape
        info.attr_defaults = dict(attr_defaults or {})
        info.input_slots = inputs
        info.output_slots = outputs
        info.host_inputs = (host_inputs if callable(host_inputs)
                            else tuple(host_inputs or ()))
        return fn
    return deco


def register_grad_maker(type_: str):
    """Decorator registering a custom grad maker for op ``type_``. The maker
    receives the forward Operator and a dict mapping each forward-output var
    name to its grad var name, and returns a list of op-desc dicts:
    ``{"type":..., "inputs": {...}, "outputs": {...}, "attrs": {...}}``."""
    def deco(fn: Callable):
        OPS.get_or_create(type_).grad_maker = fn
        return fn
    return deco


# --------------------------------------------------------------------------
# kernel helpers
# --------------------------------------------------------------------------
def first(ins: Dict[str, List], slot: str):
    """Single (non-duplicable) input."""
    v = ins.get(slot)
    if not v:
        return None
    return v[0]


def seq(ins: Dict[str, List], slot: str) -> List:
    return ins.get(slot) or []


def out(**kwargs) -> Dict[str, List]:
    """out(Out=x, Mask=[m]) — single values are wrapped into lists."""
    res = {}
    for k, v in kwargs.items():
        if v is None:
            continue
        res[k] = v if isinstance(v, list) else [v]
    return res


# --------------------------------------------------------------------------
# generic autograd-based grad execution
# --------------------------------------------------------------------------
def _is_diff_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def run_generic_grad(fwd_type: str, ins: Dict[str, List], attrs: Dict,
                     wanted_grad_slots: Sequence[str],
                     fwd_input_slots: Sequence[str]) -> Dict[str, List]:
    """Execute ``<fwd_type>_grad`` by torch autograd over the forward
    kernel.

    ``ins`` holds forward inputs/outputs by their original slot names plus
    output grads under ``<slot>@GRAD``. ``fwd_input_slots`` names the slots
    that were genuine forward inputs (recorded by the default grad maker in
    the grad op's ``_fwd_in`` attr — slot names like "Y" are inputs for some
    ops and outputs for others, so this must be explicit). Returns
    ``<slot>@GRAD`` lists for the requested input slots."""
    info = OPS.get(fwd_type)
    return _vjp_through(info.kernel, info.diff_input_slots, ins, attrs,
                        wanted_grad_slots, fwd_input_slots)


def _vjp_through(kernel, diff_input_slots, ins: Dict[str, List],
                 attrs: Dict, wanted_grad_slots: Sequence[str],
                 fwd_input_slots: Sequence[str]) -> Dict[str, List]:
    """Re-run ``kernel(ins, attrs)`` under autograd with the differentiable
    leaves of ``fwd_input_slots`` detached and requiring grad, and pull
    the cotangents of ``<slot>@GRAD`` back to them. A leaf that no
    cotangent reaches gets zeros (what ``jax.vjp`` gives), so every grad
    var the program names is written. The forward is computed again: a
    cost of this path, which a saved-residual grad would avoid."""
    fwd_in_slots = [s for s in fwd_input_slots if s in ins]
    allowed = set(diff_input_slots) if diff_input_slots else None
    merged: Dict[str, List] = {}
    leaves: List[torch.Tensor] = []
    is_leaf: Dict[str, List[bool]] = {}
    for s in fwd_in_slots:
        vals, sel = [], []
        for v in ins[s] or []:
            d = _is_diff_leaf(v) and (allowed is None or s in allowed)
            if d:
                v = v.detach().requires_grad_()
                leaves.append(v)
            vals.append(v)
            sel.append(d)
        merged[s] = vals
        is_leaf[s] = sel
    outputs, cotangents = [], []
    with torch.enable_grad():
        outs = kernel(merged, attrs)
    for oslot, ovals in outs.items():
        if oslot.startswith("_"):
            continue
        gvals = ins.get(oslot + GRAD_SUFFIX) or []
        for i, ov in enumerate(ovals):
            g = gvals[i] if i < len(gvals) else None
            if g is None or ov is None or not ov.requires_grad:
                continue  # no incoming grad: a zero cotangent adds nothing
            g = g.to(ov.dtype)
            if g.shape != ov.shape:
                g = g.broadcast_to(ov.shape)
            outputs.append(ov)
            cotangents.append(g)
    grads = (torch.autograd.grad(outputs, leaves, cotangents,
                                 allow_unused=True)
             if outputs and leaves else [None] * len(leaves))
    it = iter(zip(leaves, grads))
    result: Dict[str, List] = {}
    for s in fwd_in_slots:
        gl = []
        for d in is_leaf[s]:
            if not d:
                gl.append(None)
                continue
            leaf, g = next(it)
            gl.append(torch.zeros_like(leaf) if g is None else g)
        if s + GRAD_SUFFIX in wanted_grad_slots:
            result[s + GRAD_SUFFIX] = gl
    return result
