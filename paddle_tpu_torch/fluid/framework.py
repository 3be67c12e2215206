"""Graph-builder front end: Program / Block / Operator / Variable.

Counterpart of paddle_tpu/fluid/framework.py (reference:
python/paddle/fluid/framework.py — Program:3843, Block:2386, Operator:1817,
Variable:830). The Python objects are the source of truth and the Program
lives in memory; serialization to the wire-compatible ProgramDesc comes in
a later slice. An Operator is pure metadata; the Executor runs it.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, Optional, Sequence

import torch

from . import core, unique_name
from .core import VarDesc, convert_np_dtype_to_dtype_
from ..ops.registry import OPS, grad_var_name

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter",
    "default_main_program", "default_startup_program", "program_guard",
    "cpu_places", "cuda_places", "grad_var_name",
]


def cpu_places(device_count: Optional[int] = None):
    if device_count is None:
        device_count = int(os.environ.get("CPU_NUM", 1))
    return [core.CPUPlace()] * device_count


def cuda_places(device_ids: Optional[Sequence[int]] = None):
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [core.CUDAPlace(i) for i in device_ids]


# --------------------------------------------------------------------------
# Variable
# --------------------------------------------------------------------------
class Variable:
    """Symbolic graph variable (reference framework.py:830). Holds static
    metadata; runtime values live in a Scope keyed by name."""

    def __init__(self, block: "Block", type=VarDesc.VarType.LOD_TENSOR,
                 name: Optional[str] = None, shape=None, dtype=None,
                 lod_level: Optional[int] = None, capacity=None,
                 persistable: Optional[bool] = None, error_clip=None,
                 stop_gradient: bool = False, is_data: bool = False,
                 need_check_feed: bool = False,
                 belong_to_optimizer: bool = False, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.type = type
        self.shape = tuple(shape) if shape is not None else ()
        if dtype is not None and not isinstance(dtype, int):
            dtype = convert_np_dtype_to_dtype_(dtype)
        self.dtype = dtype if dtype is not None else VarDesc.VarType.FP32
        self.lod_level = lod_level if lod_level is not None else 0
        self.persistable = bool(persistable) if persistable is not None \
            else False
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.need_check_feed = need_check_feed
        self.belong_to_optimizer = belong_to_optimizer
        self.error_clip = error_clip
        self.op: Optional["Operator"] = None  # producing op (set by append_op)

    @property
    def desc(self):
        return self

    def to_string(self, throw_on_error=False, with_details=False):
        return (f"var {self.name} : {_type_name(self.type)}"
                f".shape{list(self.shape)}.dtype({_dtype_name(self.dtype)})"
                f".stop_gradient({self.stop_gradient})")

    __repr__ = __str__ = lambda self: self.to_string()


def _type_name(t):
    for k in dir(VarDesc.VarType):
        if not k.startswith("_") and getattr(VarDesc.VarType, k) == t:
            return k
    return str(t)


def _dtype_name(d):
    try:
        return str(core.dtype_to_torch(d)).replace("torch.", "")
    except KeyError:
        return str(d)


class Parameter(Variable):
    """Trainable persistable variable (reference framework.py:5055)."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        super().__init__(block, shape=shape, dtype=dtype,
                         stop_gradient=kwargs.pop("stop_gradient", False),
                         **{k: v for k, v in kwargs.items() if k in (
                             "name", "type", "lod_level", "persistable",
                             "error_clip", "need_check_feed")})
        self.trainable = kwargs.get("trainable", True)
        self.optimize_attr = kwargs.get("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.get("regularizer", None)
        self.do_model_average = kwargs.get("do_model_average", None)
        self.is_distributed = kwargs.get("is_distributed", False)
        self.gradient_clip_attr = kwargs.get("gradient_clip_attr", None)


# --------------------------------------------------------------------------
# Operator
# --------------------------------------------------------------------------
class Operator:
    """One op instance: type + named var-name slots + attrs (reference
    framework.py:1817)."""

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, Any]] = None,
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = _normalize_slots(inputs)
        self.outputs: Dict[str, List[str]] = _normalize_slots(outputs)
        self.attrs: Dict[str, Any] = dict(attrs or {})
        if OPS.has(type):
            for k, v in OPS.get(type).attr_defaults.items():
                self.attrs.setdefault(k, v)

    def input(self, slot: str) -> List[str]:
        return list(self.inputs.get(slot, []))

    def output(self, slot: str) -> List[str]:
        return list(self.outputs.get(slot, []))

    @property
    def input_names(self):
        return list(self.inputs.keys())

    @property
    def output_names(self):
        return list(self.outputs.keys())

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name):
        return self.attrs.get(name)

    def has_attr(self, name):
        return name in self.attrs

    def _set_attr(self, name, val):
        self.attrs[name] = val

    def to_string(self, throw_on_error=False):
        attrs = {k: v for k, v in self.attrs.items() if not k.startswith("_")}
        return f"{self.outputs} = {self.type}(inputs={self.inputs}, " \
               f"attrs={attrs})"

    __repr__ = __str__ = lambda self: self.to_string()


def _normalize_slots(slots) -> Dict[str, List[str]]:
    res: Dict[str, List[str]] = {}
    if not slots:
        return res
    for slot, args in slots.items():
        if args is None:
            res[slot] = []
            continue
        if not isinstance(args, (list, tuple)):
            args = [args]
        res[slot] = [a if isinstance(a, str) else getattr(a, "name", None)
                     or str(a) for a in args]
    return res


# --------------------------------------------------------------------------
# Block
# --------------------------------------------------------------------------
class Block:
    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.forward_block_idx = -1
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    # -- vars -------------------------------------------------------------
    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs) -> Parameter:
        global_block = self.program.global_block()
        param = Parameter(global_block, **kwargs)
        global_block.vars[param.name] = param
        return param

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise ValueError(f"var {name} not in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def _var_recursive(self, name: str) -> Variable:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        raise ValueError(f"var {name} not found from block {self.idx}")

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        try:
            return self._var_recursive(name)
        except ValueError:
            return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops --------------------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None,
                  **kwargs) -> Operator:
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        self.program._version += 1
        for names in op.outputs.values():
            for n in names:
                v = self.vars.get(n)
                if v is not None:
                    v.op = op
        info = OPS._map.get(type)
        if info is not None and info.infer_shape is not None:
            info.infer_shape(op, self)
        return op

    def _insert_op(self, index: int, type: str, inputs=None, outputs=None,
                   attrs=None, **kwargs) -> Operator:
        """An op placed at ``index`` of the block (the AMP pass splices its
        casts before their consumers)."""
        op = Operator(self, type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(index, op)
        self.program._version += 1
        for names in op.outputs.values():
            for n in names:
                v = self.vars.get(n)
                if v is not None:
                    v.op = op
        return op

    def to_string(self, throw_on_error=False, with_details=False):
        lines = [f"block idx={self.idx} parent={self.parent_idx}"]
        for v in self.vars.values():
            lines.append("    " + v.to_string())
        for op in self.ops:
            lines.append("    " + op.to_string())
        return "\n".join(lines)

    __repr__ = __str__ = lambda self: self.to_string()


# --------------------------------------------------------------------------
# Program
# --------------------------------------------------------------------------
class Program:
    """A multi-block program (reference framework.py:3843); block 0 is
    global."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0, -1)]
        self.current_block_idx = 0
        self._seed = 0
        self._version = 0  # bumped on mutation
        self._is_start_up_program = False
        self._appending_grad_times = 0  # append_backward calls so far

    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = int(seed)

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def to_string(self, throw_on_error=False, with_details=False):
        return "\n".join(b.to_string() for b in self.blocks)

    __repr__ = __str__ = lambda self: self.to_string()


# --------------------------------------------------------------------------
# default programs + guards
# --------------------------------------------------------------------------
_main_program_ = Program()
_startup_program_ = Program()
_startup_program_._is_start_up_program = True


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(program: Program) -> Program:
    global _main_program_
    old = _main_program_
    _main_program_ = program
    return old


def switch_startup_program(program: Program) -> Program:
    global _startup_program_
    old = _startup_program_
    _startup_program_ = program
    return old


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
