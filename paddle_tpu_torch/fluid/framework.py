"""Graph-builder front end: Program / Block / Operator / Variable.

Counterpart of paddle_tpu/fluid/framework.py (reference:
python/paddle/fluid/framework.py — Program:3843, Block:2386, Operator:1817,
Variable:830). The Python objects are the source of truth and serialize
to the wire-compatible ProgramDesc (``proto/framework.proto``, through the
plain-Python codec ``proto/framework_pb2.py``), so a program the TPU
package saves parses here and the other way round, byte for byte. An
Operator is pure metadata; the Executor runs it. A Variable's arithmetic
and comparison operators append ops, as the reference's do
(framework.py:206-222 of the TPU package). ``Program.clone(for_test=)``
and ``Program._prune`` give the test-mode copy and the backward slice that
``io.save_inference_model`` writes (the TPU package's framework.py:650,
:701).
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import core, unique_name
from .core import VarDesc, convert_np_dtype_to_dtype_
from .proto import framework_pb2
from ..ops.registry import OPS, grad_var_name

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter",
    "default_main_program", "default_startup_program", "program_guard",
    "cpu_places", "cuda_places", "grad_var_name", "name_scope",
    "device_guard", "in_dygraph_mode",
]


def cpu_places(device_count: Optional[int] = None):
    if device_count is None:
        device_count = int(os.environ.get("CPU_NUM", 1))
    return [core.CPUPlace()] * device_count


def cuda_places(device_ids: Optional[Sequence[int]] = None):
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [core.CUDAPlace(i) for i in device_ids]


def in_dygraph_mode() -> bool:
    """False: the port has no dygraph mode yet (ROADMAP A7)."""
    return False


@contextlib.contextmanager
def name_scope(prefix: Optional[str] = None):
    """The reference's op-name grouping (framework.py:105 of the TPU
    package): cosmetic, names nothing here."""
    yield


@contextlib.contextmanager
def device_guard(device: Optional[str] = None):
    """The reference's per-op placement (framework.py:110 of the TPU
    package): one device runs the whole block here, so it places
    nothing."""
    yield


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

    def _to_proto(self) -> framework_pb2.VarDesc:
        vd = framework_pb2.VarDesc()
        vd.name = self.name
        vd.type.type = self.type
        vd.persistable = self.persistable
        vd.need_check_feed = self.need_check_feed
        if self.type == VarDesc.VarType.LOD_TENSOR:
            vd.type.lod_tensor.tensor.data_type = self.dtype
            vd.type.lod_tensor.tensor.dims.extend(self.shape)
            vd.type.lod_tensor.lod_level = self.lod_level
        elif self.type == VarDesc.VarType.SELECTED_ROWS:
            vd.type.selected_rows.data_type = self.dtype
            vd.type.selected_rows.dims.extend(self.shape)
        elif self.type == VarDesc.VarType.LOD_TENSOR_ARRAY:
            vd.type.tensor_array.tensor.data_type = self.dtype
            vd.type.tensor_array.tensor.dims.extend(self.shape)
            vd.type.tensor_array.lod_level = self.lod_level
        return vd

    # operator sugar, so that ``a + b`` builds an op in a static graph; a
    # Python number becomes a fill_constant [1] of the Variable's dtype
    def _binary(self, other, op_type, reverse=False):
        from .layers.tensor import fill_constant, math_op
        if reverse:
            o = fill_constant([1], self.dtype, float(other))
            return math_op(op_type, o, self)
        return math_op(op_type, self, other)

    __add__ = lambda self, o: self._binary(o, "elementwise_add")
    __radd__ = __add__
    __sub__ = lambda self, o: self._binary(o, "elementwise_sub")
    __rsub__ = lambda self, o: self._binary(o, "elementwise_sub", True)
    __mul__ = lambda self, o: self._binary(o, "elementwise_mul")
    __rmul__ = __mul__
    __truediv__ = lambda self, o: self._binary(o, "elementwise_div")
    __rtruediv__ = lambda self, o: self._binary(o, "elementwise_div", True)
    __pow__ = lambda self, o: self._binary(o, "elementwise_pow")
    __rpow__ = lambda self, o: self._binary(o, "elementwise_pow", True)
    __neg__ = lambda self: self._binary(-1.0, "elementwise_mul")
    __lt__ = lambda self, o: self._binary(o, "less_than")
    __le__ = lambda self, o: self._binary(o, "less_equal")
    __gt__ = lambda self, o: self._binary(o, "greater_than")
    __ge__ = lambda self, o: self._binary(o, "greater_equal")


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

    def _rename_input(self, old, new):
        for ns in self.inputs.values():
            for i, n in enumerate(ns):
                if n == old:
                    ns[i] = new

    def _rename_output(self, old, new):
        for ns in self.outputs.values():
            for i, n in enumerate(ns):
                if n == old:
                    ns[i] = new

    def to_string(self, throw_on_error=False):
        attrs = {k: v for k, v in self.attrs.items() if not k.startswith("_")}
        return f"{self.outputs} = {self.type}(inputs={self.inputs}, " \
               f"attrs={attrs})"

    __repr__ = __str__ = lambda self: self.to_string()

    def _to_proto(self) -> framework_pb2.OpDesc:
        od = framework_pb2.OpDesc()
        od.type = self.type
        for slot, names in self.inputs.items():
            v = od.inputs.add()
            v.parameter = slot
            v.arguments.extend(names)
        for slot, names in self.outputs.items():
            v = od.outputs.add()
            v.parameter = slot
            v.arguments.extend(names)
        for name, val in sorted(self.attrs.items()):
            if name.startswith("_"):
                continue  # runtime-internal attrs do not serialize
            a = od.attrs.add()
            a.name = name
            _attr_to_proto(a, val)
        return od


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


def _attr_to_proto(a: framework_pb2.OpDesc.Attr, val):
    """One attr's typed value (the TPU package's framework.py:374): an int
    outside int32 is a LONG, a list takes its first element's type, an
    empty list is INTS."""
    AT = framework_pb2
    if isinstance(val, bool):
        a.type = AT.BOOLEAN
        a.b = val
    elif isinstance(val, (int, np.integer)):
        iv = int(val)
        if -(2**31) <= iv < 2**31:
            a.type = AT.INT
            a.i = iv
        else:
            a.type = AT.LONG
            a.l = iv
    elif isinstance(val, (float, np.floating)):
        a.type = AT.FLOAT
        a.f = float(val)
    elif isinstance(val, str):
        a.type = AT.STRING
        a.s = val
    elif isinstance(val, Block):
        a.type = AT.BLOCK
        a.block_idx = val.idx
    elif isinstance(val, (list, tuple)):
        if len(val) == 0:
            a.type = AT.INTS
        elif isinstance(val[0], bool):
            a.type = AT.BOOLEANS
            a.bools.extend(bool(x) for x in val)
        elif isinstance(val[0], (int, np.integer)):
            if all(-(2**31) <= int(x) < 2**31 for x in val):
                a.type = AT.INTS
                a.ints.extend(int(x) for x in val)
            else:
                a.type = AT.LONGS
                a.longs.extend(int(x) for x in val)
        elif isinstance(val[0], (float, np.floating)):
            a.type = AT.FLOATS
            a.floats.extend(float(x) for x in val)
        elif isinstance(val[0], str):
            a.type = AT.STRINGS
            a.strings.extend(val)
        elif isinstance(val[0], Block):
            a.type = AT.BLOCKS
            a.blocks_idx.extend(b.idx for b in val)
        else:
            raise TypeError(f"unsupported list attr {val!r}")
    else:
        raise TypeError(f"unsupported attr {val!r}")


def _attr_from_proto(a: framework_pb2.OpDesc.Attr, program: "Program"):
    """The inverse of ``_attr_to_proto`` (the TPU package's
    framework.py:424); BLOCK and BLOCKS resolve to ``program``'s blocks."""
    AT = framework_pb2
    t = a.type
    if t == AT.INT:
        return a.i
    if t == AT.FLOAT:
        return a.f
    if t == AT.STRING:
        return a.s
    if t == AT.INTS:
        return list(a.ints)
    if t == AT.FLOATS:
        return list(a.floats)
    if t == AT.STRINGS:
        return list(a.strings)
    if t == AT.BOOLEAN:
        return a.b
    if t == AT.BOOLEANS:
        return list(a.bools)
    if t == AT.BLOCK:
        return program.block(a.block_idx)
    if t == AT.BLOCKS:
        return [program.block(i) for i in a.blocks_idx]
    if t == AT.LONG:
        return a.l
    if t == AT.LONGS:
        return list(a.longs)
    raise TypeError(f"unknown attr type {t}")


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

    def has_var_recursive(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def _rename_var(self, old: str, new: str):
        v = self.vars.pop(old)
        v.name = new
        self.vars[new] = v
        for op in self.ops:
            op._rename_input(old, new)
            op._rename_output(old, new)
        return v

    def _remove_var(self, name: str):
        self.vars.pop(name, None)

    def _remove_op(self, index: int, end: Optional[int] = None):
        del self.ops[index:(index + 1) if end is None else end]
        self.program._version += 1

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

    def _prepend_op(self, type: str, inputs=None, outputs=None, attrs=None,
                    **kwargs) -> Operator:
        """An op placed first in the block (the LR schedules' step
        counter)."""
        return self._insert_op(0, type, inputs, outputs, attrs)

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

    def _to_proto(self) -> framework_pb2.BlockDesc:
        bd = framework_pb2.BlockDesc()
        bd.idx = self.idx
        bd.parent_idx = self.parent_idx
        bd.forward_block_idx = self.forward_block_idx
        for v in self.vars.values():
            bd.vars.append(v._to_proto())
        for op in self.ops:
            bd.ops.append(op._to_proto())
        return bd


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

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        """A new block, child of the current one (or of ``parent_idx``),
        which becomes the current block: the control-flow layers build
        their sub-blocks in it (the TPU package's framework.py:622)."""
        b = Block(self, len(self.blocks), self.current_block_idx
                  if parent_idx is None else parent_idx)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._version += 1
        return b

    def _rollback(self):
        """The current block's parent becomes the current block again."""
        self.current_block_idx = self.current_block().parent_idx

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

    # -- clone / prune (the TPU package's framework.py:650-726) ------------
    def clone(self, for_test: bool = False) -> "Program":
        """A copy with its own blocks, vars and ops. ``for_test`` sets
        ``is_test`` on every op whose registered attrs have it (dropout,
        batch_norm). The AMP dynamic loss-scaling state rides along: a
        clone that keeps the scaled-loss and unscale ops must keep the
        scale update too."""
        p = Program()
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            nb.forward_block_idx = b.forward_block_idx
            p.blocks.append(nb)
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                if isinstance(v, Parameter):
                    nv = Parameter(nb, shape=v.shape, dtype=v.dtype,
                                   name=v.name, trainable=v.trainable,
                                   optimize_attr=v.optimize_attr,
                                   regularizer=v.regularizer)
                    nv.lod_level = v.lod_level
                else:
                    nv = Variable(nb, type=v.type, name=v.name,
                                  shape=v.shape, dtype=v.dtype,
                                  lod_level=v.lod_level,
                                  persistable=v.persistable,
                                  stop_gradient=v.stop_gradient,
                                  is_data=v.is_data,
                                  need_check_feed=v.need_check_feed)
                nb.vars[name] = nv
            for op in b.ops:
                attrs = dict(op.attrs)
                for k, val in attrs.items():
                    if isinstance(val, Block):
                        attrs[k] = p.blocks[val.idx]
                    elif isinstance(val, list) and val \
                            and isinstance(val[0], Block):
                        attrs[k] = [p.blocks[x.idx] for x in val]
                if for_test and "is_test" in _op_attr_names(op.type):
                    attrs["is_test"] = True
                nb.ops.append(Operator(
                    nb, op.type,
                    inputs={k: list(v) for k, v in op.inputs.items()},
                    outputs={k: list(v) for k, v in op.outputs.items()},
                    attrs=attrs))
        p.current_block_idx = self.current_block_idx
        p._seed = self._seed
        amp = getattr(self, "_amp_dynamic", None)
        if amp is not None:
            p._amp_dynamic = dict(amp)
        return p

    def _prune(self, targets) -> "Program":
        """A clone of the global block's backward slice to ``targets``
        (Variables or names): the ops whose outputs the targets need, in
        order; the vars they do not reference dropped, persistables
        kept."""
        if not isinstance(targets, (list, tuple)):
            targets = [targets]
        p = self.clone()
        block = p.global_block()
        needed = {t.name if isinstance(t, Variable) else str(t)
                  for t in targets}
        keep = []
        for op in reversed(block.ops):
            if any(n in needed for n in op.output_arg_names):
                keep.append(op)
                needed.update(op.input_arg_names)
        block.ops = list(reversed(keep))
        referenced = set(needed)
        for op in block.ops:
            referenced.update(op.output_arg_names)
        block.vars = {n: v for n, v in block.vars.items()
                      if n in referenced or v.persistable}
        p._version += 1
        return p

    def _inference_optimize(self, prune_read_op=True) -> "Program":
        return self.clone(for_test=True)

    # -- serialization (the TPU package's framework.py:729-800) ------------
    def desc_proto(self) -> framework_pb2.ProgramDesc:
        pd = framework_pb2.ProgramDesc()
        for b in self.blocks:
            pd.blocks.append(b._to_proto())
        pd.version.version = 0
        return pd

    @property
    def desc(self):
        return self.desc_proto()

    def serialize_to_string(self) -> bytes:
        return self.desc_proto().SerializeToString()

    @staticmethod
    def parse_from_string(binary: bytes) -> "Program":
        pd = framework_pb2.ProgramDesc()
        pd.ParseFromString(binary)
        return Program._from_proto(pd)

    @staticmethod
    def _from_proto(pd: framework_pb2.ProgramDesc) -> "Program":
        """A Program of plain Variables (a parsed program has no
        Parameter objects: its weights are persistable vars)."""
        p = Program()
        p.blocks = []
        for bd in pd.blocks:
            b = Block(p, bd.idx, bd.parent_idx)
            b.forward_block_idx = bd.forward_block_idx
            p.blocks.append(b)
        for bd, b in zip(pd.blocks, p.blocks):
            for vd in bd.vars:
                vt = vd.type.type
                shape, dtype, lod_level = (), VarDesc.VarType.FP32, 0
                if vt == VarDesc.VarType.LOD_TENSOR:
                    shape = tuple(vd.type.lod_tensor.tensor.dims)
                    dtype = vd.type.lod_tensor.tensor.data_type
                    lod_level = vd.type.lod_tensor.lod_level
                elif vt == VarDesc.VarType.SELECTED_ROWS:
                    shape = tuple(vd.type.selected_rows.dims)
                    dtype = vd.type.selected_rows.data_type
                elif vt == VarDesc.VarType.LOD_TENSOR_ARRAY:
                    shape = tuple(vd.type.tensor_array.tensor.dims)
                    dtype = vd.type.tensor_array.tensor.data_type
                    lod_level = vd.type.tensor_array.lod_level
                b.vars[vd.name] = Variable(
                    b, type=vt, name=vd.name, shape=shape, dtype=dtype,
                    lod_level=lod_level, persistable=vd.persistable,
                    need_check_feed=vd.need_check_feed)
            for od in bd.ops:
                b.ops.append(Operator(
                    b, od.type,
                    inputs={v.parameter: list(v.arguments)
                            for v in od.inputs},
                    outputs={v.parameter: list(v.arguments)
                             for v in od.outputs},
                    attrs={a.name: _attr_from_proto(a, p)
                           for a in od.attrs}))
        p.current_block_idx = 0
        return p

    def to_string(self, throw_on_error=False, with_details=False):
        return "\n".join(b.to_string() for b in self.blocks)

    __repr__ = __str__ = lambda self: self.to_string()


def _op_attr_names(op_type: str):
    if OPS.has(op_type):
        return OPS.get(op_type).attr_defaults.keys()
    return ()


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
