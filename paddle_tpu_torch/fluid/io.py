"""Model save and load (counterpart of paddle_tpu/fluid/io.py:1-436;
reference: python/paddle/fluid/io.py, framework/tensor_util.cc:386
TensorToStream, lod_tensor.cc:220 SerializeToStream).

Wire-compatible with the reference's tensor stream, so parameters and
inference models move between the two packages and the reference in both
directions, byte for byte. Per LoDTensor:
  u32 version (0)
  u64 lod_level; per level: u64 byte size, then the size_t offsets
  u32 tensor version (0)
  i32 TensorDesc size; TensorDesc{data_type, dims} proto bytes
  the raw buffer (C order)
bf16 goes through torch's int16 view, so it needs no ``ml_dtypes``.

A loaded tensor lies on the executor's device (the host when no executor
is given): the executor reads its state from the scope where it lies.

``save_inference_model`` writes ``main_program.clone(for_test=True)
._prune(targets)`` with feed and fetch ops, checked by
``analysis.verify_program`` at level "error", and the pruned program's
persistables; ``load_inference_model`` reads them back. ``save`` and
``load`` are the 2.0-style pickles of the TPU package. The parameter-
server slab files and the checkpoint plane (the TPU package's
io.py:438-785) are not ported yet.
"""
from __future__ import annotations

import os
import pickle
import struct
from typing import List

import numpy as np
import torch

from . import core
from .core import LoDTensor, VarDesc, global_scope
from .framework import Operator, Parameter, Program, Variable, \
    default_main_program
from .proto import framework_pb2

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "save_inference_model",
    "load_inference_model", "save", "load",
]


# --------------------------------------------------------------------------
# the LoDTensor stream
# --------------------------------------------------------------------------
def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _serialize_lod_tensor(t: LoDTensor, as_fp16: bool = False) -> bytes:
    arr = t.array
    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))
    if as_fp16:
        arr = arr.to(torch.float16)
    parts = [struct.pack("<I", 0)]
    lod = t.lod()
    parts.append(struct.pack("<Q", len(lod)))
    for level in lod:
        parts.append(struct.pack("<Q", len(level) * 8))
        parts.append(np.asarray(level, np.uint64).tobytes())
    parts.append(struct.pack("<I", 0))
    desc = framework_pb2.VarType.TensorDesc()
    desc.data_type = core.convert_np_dtype_to_dtype_(arr.dtype)
    desc.dims.extend(arr.shape)
    db = desc.SerializeToString()
    parts.append(struct.pack("<i", len(db)))
    parts.append(db)
    parts.append(_host_bytes(arr))
    return b"".join(parts)


def _deserialize_lod_tensor(data: bytes, offset: int = 0,
                            device=None) -> LoDTensor:
    t, _ = _deserialize_one(data, offset, device)
    return t


def _deserialize_one(data: bytes, off: int, device=None):
    (ver,) = struct.unpack_from("<I", data, off)
    off += 4
    if ver != 0:
        raise ValueError(f"unsupported tensor version {ver}")
    (lod_level,) = struct.unpack_from("<Q", data, off)
    off += 8
    lod = []
    for _ in range(lod_level):
        (nbytes,) = struct.unpack_from("<Q", data, off)
        off += 8
        level = np.frombuffer(data, np.uint64, nbytes // 8, off).tolist()
        off += nbytes
        lod.append([int(x) for x in level])
    (tver,) = struct.unpack_from("<I", data, off)
    off += 4
    if tver != 0:
        raise ValueError(f"unsupported tensor version {tver}")
    (dsize,) = struct.unpack_from("<i", data, off)
    off += 4
    desc = framework_pb2.VarType.TensorDesc()
    desc.ParseFromString(data[off:off + dsize])
    off += dsize
    dtype = core.dtype_to_torch(desc.data_type)
    dims = [int(d) for d in desc.dims]
    count = int(np.prod(dims)) if dims else 1
    nbytes = count * torch.empty((), dtype=dtype).element_size()
    if off + nbytes > len(data):
        raise ValueError("truncated tensor buffer")
    if nbytes:
        arr = torch.frombuffer(bytearray(data[off:off + nbytes]),
                               dtype=dtype).reshape(dims)
    else:
        arr = torch.empty(dims, dtype=dtype)
    off += nbytes
    if device is not None:
        arr = arr.to(device)
    return LoDTensor(arr, lod), off


def _deserialize_lod_tensor_stream(data: bytes, n: int,
                                   device=None) -> List[LoDTensor]:
    res, off = [], 0
    for _ in range(n):
        t, off = _deserialize_one(data, off, device)
        res.append(t)
    return res


# --------------------------------------------------------------------------
# save / load (reference: python/paddle/fluid/io.py)
# --------------------------------------------------------------------------
def _is_persistable(var: Variable) -> bool:
    return (var.persistable and var.type not in (
        VarDesc.VarType.FEED_MINIBATCH, VarDesc.VarType.FETCH_LIST,
        VarDesc.VarType.READER, VarDesc.VarType.RAW))


def _is_parameter(var) -> bool:
    return isinstance(var, Parameter)


def _device_of(executor):
    return None if executor is None else executor.device


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """One file a var under ``dirname``, or every var in one stream in
    ``filename``, from the current scope (``scope_guard``)."""
    if main_program is None:
        main_program = default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = global_scope()
    os.makedirs(dirname or ".", exist_ok=True)
    if filename is None:
        for v in vars:
            sv = scope.find_var(v.name)
            if sv is None or not sv.is_initialized():
                continue
            with open(os.path.join(dirname, v.name), "wb") as f:
                f.write(_serialize_lod_tensor(sv.get_tensor()))
    else:
        with open(os.path.join(dirname, filename), "wb") as f:
            for v in vars:
                f.write(_serialize_lod_tensor(
                    scope.find_var(v.name).get_tensor()))


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """The inverse of ``save_vars``, into the current scope, on the
    executor's device. Every missing file is named in one error."""
    if main_program is None:
        main_program = default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = global_scope()
    device = _device_of(executor)
    if filename is None:
        missing = [os.path.join(dirname, v.name) for v in vars
                   if not os.path.exists(os.path.join(dirname, v.name))]
        if missing:
            raise RuntimeError(
                f"{len(missing)} checkpoint file(s) missing under "
                f"{dirname}: " + ", ".join(sorted(missing)))
        for v in vars:
            with open(os.path.join(dirname, v.name), "rb") as f:
                scope.var(v.name).set_value(
                    _deserialize_lod_tensor(f.read(), device=device))
    else:
        with open(os.path.join(dirname, filename), "rb") as f:
            data = f.read()
        for v, t in zip(vars, _deserialize_lod_tensor_stream(
                data, len(vars), device)):
            scope.var(v.name).set_value(t)


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    """Write the program that computes ``target_vars`` from
    ``feeded_var_names`` (the test-mode clone's backward slice, with feed
    and fetch ops recording its interface) to ``__model__`` (or
    ``model_filename``) and its persistables beside it. Returns the
    target names."""
    if main_program is None:
        main_program = default_main_program()
    os.makedirs(dirname, exist_ok=True)
    target_names = [v.name if isinstance(v, Variable) else v
                    for v in target_vars]
    pruned = main_program.clone(for_test=True)._prune(target_names)
    # the feed/fetch holder vars and ops (reference io.py prepend_feed_ops
    # and append_fetch_ops, executor.cc:195-306)
    block = pruned.global_block()
    if not block.has_var("feed"):
        block.create_var(name="feed", type=VarDesc.VarType.FEED_MINIBATCH,
                         persistable=True)
    if not block.has_var("fetch"):
        block.create_var(name="fetch", type=VarDesc.VarType.FETCH_LIST,
                         persistable=True)
    block.ops[:0] = [Operator(block, type="feed", inputs={"X": ["feed"]},
                              outputs={"Out": [name]}, attrs={"col": i})
                     for i, name in enumerate(feeded_var_names)]
    for i, name in enumerate(target_names):
        block.append_op(type="fetch", inputs={"X": [name]},
                        outputs={"Out": ["fetch"]}, attrs={"col": i})
    # vars no op references (the optimizer's slots the prune orphaned)
    # neither serialize nor save; every block is scanned, so a persistable
    # read only in a sub-block stays
    used = {"feed", "fetch"}
    for blk in pruned.blocks:
        for op in blk.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
    for name in [n for n in block.vars if n not in used]:
        del block.vars[name]
    from . import analysis
    analysis.enforce(
        analysis.verify_program(
            pruned, feed_names=tuple(feeded_var_names),
            fetch_names=tuple(target_names), where="save"),
        level="error", where="save")
    with open(os.path.join(dirname, model_filename or "__model__"),
              "wb") as f:
        f.write(pruned.serialize_to_string())
    if not program_only:
        save_persistables(executor, dirname, pruned, params_filename)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """→ (program, feed names, fetch Variables): the saved program with
    its feed and fetch ops taken out, its persistables loaded into the
    current scope on the executor's device."""
    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        program = Program.parse_from_string(f.read())
    load_persistables(executor, dirname, program, params_filename)
    block = program.global_block()
    feed_names = [op.output("Out")[0] for op in block.ops
                  if op.type == "feed"]
    fetch_names = [op.input("X")[0] for op in block.ops
                   if op.type == "fetch"]
    if not fetch_names and block.ops:
        # a program without fetch ops: the last op's outputs are targets
        fetch_names = block.ops[-1].output_arg_names
    fetch_targets = [block.var(n) for n in fetch_names if block.has_var(n)]
    block.ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    return program, feed_names, fetch_targets


def save(program: Program, model_path: str):
    """2.0-style save: pickles of name → ndarray (``.pdparams`` the
    parameters, ``.pdopt`` the other persistables) and the program
    (``.pdmodel``), as the TPU package writes them. bf16 arrays pickle as
    float32 where ``ml_dtypes`` is missing."""
    scope = global_scope()
    params, opt_vars = {}, {}
    for v in program.list_vars():
        if not _is_persistable(v):
            continue
        sv = scope.find_var(v.name)
        if sv is None or not sv.is_initialized():
            continue
        arr = sv.get_tensor().numpy()
        (params if _is_parameter(v) else opt_vars)[v.name] = arr
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    with open(model_path + ".pdparams", "wb") as f:
        pickle.dump(params, f)
    with open(model_path + ".pdopt", "wb") as f:
        pickle.dump(opt_vars, f)
    with open(model_path + ".pdmodel", "wb") as f:
        f.write(program.serialize_to_string())


def load(program: Program, model_path: str, executor=None, var_list=None):
    """The inverse of ``save``, into the current scope, on the executor's
    device (the host when none is given)."""
    device = _device_of(executor)
    loaded = {}
    for suffix in (".pdparams", ".pdopt"):
        path = model_path + suffix
        if os.path.exists(path):
            with open(path, "rb") as f:
                loaded.update(pickle.load(f))
    scope = global_scope()
    for name, arr in loaded.items():
        arr = np.array(arr, copy=True)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        scope.var(name).set_value(
            LoDTensor(t if device is None else t.to(device)))
