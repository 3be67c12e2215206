"""Operator registry (reference: paddle/fluid/framework/op_info.h:124,
op_registry.h:223).

Every op has ONE kernel ``kernel(ins, attrs) -> outs`` over torch
tensors, which the executor applies op by op. Device placement follows
the input tensors; ops that create tensors from nothing take the device
from ``attrs["_device"]`` and their random stream from ``attrs["_rng"]()``.

Kernel calling convention:
    ins:   dict slot_name -> list of tensors (or None for absent
           dispensable slots).
    attrs: dict of python attr values. The executor injects:
           ``_rng``    (a callable returning the op's torch.Generator on
                       its device, built on first call) if the op
                       declared needs_rng,
           ``_device`` (torch.device) if the op declared needs_device.
    returns: dict slot_name -> list of tensors.

The generic-grad machinery of the TPU package (registry.py:201-321)
comes with the training slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence


class OpInfo:
    __slots__ = ("type", "kernel", "infer_shape", "no_grad", "needs_rng",
                 "needs_device", "diff_input_slots", "attr_defaults",
                 "input_slots", "output_slots")

    def __init__(self, type_: str):
        self.type = type_
        self.kernel: Optional[Callable] = None
        self.infer_shape: Optional[Callable] = None
        self.no_grad = False
        self.needs_rng = False
        self.needs_device = False
        self.diff_input_slots: Optional[Sequence[str]] = None
        self.attr_defaults: Dict[str, Any] = {}
        self.input_slots: Optional[Sequence[str]] = None
        self.output_slots: Optional[Sequence[str]] = None


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


def register_op(type_: str, *, no_grad: bool = False, needs_rng: bool = False,
                needs_device: bool = False,
                diff_inputs: Optional[Sequence[str]] = None,
                infer_shape: Optional[Callable] = None,
                attr_defaults: Optional[Dict[str, Any]] = None,
                inputs: Optional[Sequence[str]] = None,
                outputs: Optional[Sequence[str]] = None):
    """Decorator registering a forward kernel under op name ``type_``."""
    def deco(fn: Callable):
        info = OPS.get_or_create(type_)
        info.kernel = fn
        info.no_grad = no_grad
        info.needs_rng = needs_rng
        info.needs_device = needs_device
        info.diff_input_slots = diff_inputs
        info.infer_shape = infer_shape
        info.attr_defaults = dict(attr_defaults or {})
        info.input_slots = inputs
        info.output_slots = outputs
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
