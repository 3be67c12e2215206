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
``load`` are the 2.0-style pickles of the TPU package.

The checkpoint plane (the TPU package's io.py:432-650 and :719-785):
``save_checkpoint`` writes ``<root>/ckpt-<global_step>/``, one tensor
stream file a persistable and ``MANIFEST.json`` (format version, global
step, the scope's step counter, each file's CRC32 and size, the
DataLoader's state, ``extra``), through a temporary directory: every file
is fsynced, then the manifest and the directory, then the directory is
renamed into place, so a kill mid-save leaves only a ``.tmp-*`` directory
that is never selected. The files and the manifest are byte for byte the
TPU package's for the same values. ``validate_checkpoint`` reports every
problem in one ``CheckpointError``; ``latest_checkpoint`` and
``load_checkpoint`` pick the newest checkpoint that validates;
``load_checkpoint`` restores the persistables and the step counter (an
int64 [1] tensor on the executor's device, as ``Executor.run`` keeps it)
and refuses a program whose persistables the checkpoint does not cover;
``rollback_to_latest`` is the numeric fault plane's restore. The
parameter server's slab tables (``LazyEmbeddingTable``) and the handoff
manifests wait for the PS plane (ROADMAP A9).
"""
from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import struct
import zlib
from typing import Any, Dict, List, Optional

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
    "save_checkpoint", "load_checkpoint", "latest_checkpoint",
    "validate_checkpoint", "rollback_to_latest",
]

_LOG = logging.getLogger("paddle_tpu_torch.io")


# --------------------------------------------------------------------------
# the LoDTensor stream
# --------------------------------------------------------------------------
def _serialize_parts(t: LoDTensor, as_fp16: bool = False) -> List[bytes]:
    """The tensor stream of ``t`` in pieces: the header, then the raw
    buffer (a view of the host copy, not joined: a checkpoint writes and
    checksums the pieces as they are)."""
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
    host = arr.detach().contiguous().cpu()
    if host.dtype == torch.bfloat16:
        host = host.view(torch.int16)
    parts.append(host.numpy().reshape(-1).view(np.uint8).data)
    return parts


def _serialize_lod_tensor(t: LoDTensor, as_fp16: bool = False) -> bytes:
    return b"".join(_serialize_parts(t, as_fp16))


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
            raise core.CheckpointError(
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


# --------------------------------------------------------------------------
# atomic checkpoints with bit-exact resume (the TPU package's io.py:432-650,
# :719-785; docs/FAULT_TOLERANCE.md)
# --------------------------------------------------------------------------
CKPT_PREFIX = "ckpt-"
CKPT_MANIFEST = "MANIFEST.json"
CKPT_FORMAT_VERSION = 1
RNG_COUNTER_VAR = "@RNG_COUNTER@"


def _fsync_path(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _scope_rng_counter(scope) -> int:
    """The scope's step counter (one host read of the device tensor)."""
    v = scope.find_var(RNG_COUNTER_VAR)
    if v is None or not v.is_initialized():
        return 0
    return int(v.value().array.reshape(-1)[0].item())


def save_checkpoint(executor, dirname, main_program=None, scope=None,
                    global_step: int = 0, dataloader_state=None,
                    extra=None, max_to_keep: int = 3) -> str:
    """Write one atomic checkpoint to ``<dirname>/ckpt-<global_step>``:
    every initialized persistable of ``main_program`` (parameters and the
    optimizer's slots: Adam's moments and beta powers, Momentum's
    velocities, the learning rate), the scope's step counter (what makes
    resumed dropout masks bit-identical), and ``dataloader_state`` (e.g.
    ``DataLoader.state_dict()``) and ``extra`` in the manifest. Keeps the
    newest ``max_to_keep`` checkpoints. The values are read on the current
    stream after it waits for the executor's, which writes the state.
    → the checkpoint's directory."""
    if main_program is None:
        main_program = default_main_program()
    if scope is None:
        scope = global_scope()
    stream = getattr(executor, "_stream", None)
    if stream is not None:
        torch.cuda.current_stream(executor.device).wait_stream(stream)
    step = int(global_step)
    os.makedirs(dirname, exist_ok=True)
    tmp = os.path.join(dirname, f".tmp-{CKPT_PREFIX}{step}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    files: Dict[str, Dict[str, int]] = {}
    for v in main_program.list_vars():
        if not _is_persistable(v):
            continue
        sv = scope.find_var(v.name)
        if sv is None or not sv.is_initialized():
            continue
        val = sv.value()
        if not isinstance(val, LoDTensor):
            _LOG.warning("checkpoint: skipping non-dense persistable "
                         "'%s' (%s)", v.name, type(val).__name__)
            continue
        crc, size = 0, 0
        with open(os.path.join(tmp, v.name), "wb") as f:
            for part in _serialize_parts(val):
                f.write(part)
                crc = zlib.crc32(part, crc)
                size += len(part)
            f.flush()
            os.fsync(f.fileno())
        files[v.name] = {"crc32": crc & 0xFFFFFFFF, "size": size}
    manifest = {
        "format_version": CKPT_FORMAT_VERSION,
        "global_step": step,
        "rng_counter": _scope_rng_counter(scope),
        "files": files,
        "dataloader": dataloader_state,
        "extra": extra,
    }
    mpath = os.path.join(tmp, CKPT_MANIFEST)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)
    final = os.path.join(dirname, f"{CKPT_PREFIX}{step}")
    aside = None
    if os.path.exists(final):
        # a checkpoint of the same step: moved aside first, so that a kill
        # before the rename below leaves the old copy (an aside directory
        # is never a resume candidate, and is pruned)
        aside = f"{final}.old-{os.getpid()}"
        if os.path.exists(aside):
            shutil.rmtree(aside)
        os.rename(final, aside)
    os.rename(tmp, final)
    _fsync_path(dirname)
    if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)
    _prune_checkpoints(dirname, max_to_keep)
    return final


def _checkpoint_steps(dirname) -> List[int]:
    steps = []
    try:
        entries = os.listdir(dirname)
    except OSError:
        return steps
    for name in entries:
        if not name.startswith(CKPT_PREFIX):
            continue
        try:
            steps.append(int(name[len(CKPT_PREFIX):]))
        except ValueError:
            continue
    return sorted(steps)


def _prune_checkpoints(dirname, max_to_keep: int):
    if not max_to_keep or max_to_keep <= 0:
        return
    steps = _checkpoint_steps(dirname)
    for step in steps[:-max_to_keep]:
        shutil.rmtree(os.path.join(dirname, f"{CKPT_PREFIX}{step}"),
                      ignore_errors=True)
    # the temporary and aside directories of killed saves
    for name in os.listdir(dirname):
        if name.startswith(".tmp-" + CKPT_PREFIX) or \
                (name.startswith(CKPT_PREFIX) and ".old-" in name):
            shutil.rmtree(os.path.join(dirname, name), ignore_errors=True)


def validate_checkpoint(ckpt_dir) -> Dict[str, Any]:
    """Validate one checkpoint directory against its manifest. → the
    manifest; raises ``core.CheckpointError`` naming EVERY problem (no
    manifest, missing files, sizes and CRCs that disagree): a truncated or
    bit-flipped checkpoint is rejected whole."""
    mpath = os.path.join(ckpt_dir, CKPT_MANIFEST)
    if not os.path.exists(mpath):
        raise core.CheckpointError(
            f"checkpoint {ckpt_dir}: no {CKPT_MANIFEST} — incomplete "
            f"save (killed mid-write) or not a checkpoint directory")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        raise core.CheckpointError(
            f"checkpoint {ckpt_dir}: unreadable manifest: {e}") from e
    problems = []
    for name, meta in sorted(manifest.get("files", {}).items()):
        path = os.path.join(ckpt_dir, name)
        if not os.path.exists(path):
            problems.append(f"missing file '{name}'")
            continue
        size = os.path.getsize(path)
        if size != int(meta["size"]):
            problems.append(
                f"'{name}' truncated ({size} bytes, manifest says "
                f"{meta['size']})")
            continue
        crc = 0
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                crc = zlib.crc32(chunk, crc)
        if (crc & 0xFFFFFFFF) != int(meta["crc32"]):
            problems.append(f"'{name}' CRC mismatch (corrupted)")
    if problems:
        raise core.CheckpointError(
            f"checkpoint {ckpt_dir} failed validation "
            f"({len(problems)} problem(s)): " + "; ".join(problems))
    return manifest


def _latest_valid(dirname):
    """(directory, manifest) of the newest checkpoint under ``dirname``
    that validates, or (None, None); an invalid newer one is logged and
    passed over."""
    for step in reversed(_checkpoint_steps(dirname)):
        cand = os.path.join(dirname, f"{CKPT_PREFIX}{step}")
        try:
            return cand, validate_checkpoint(cand)
        except core.CheckpointError as e:
            _LOG.warning("skipping invalid checkpoint %s: %s", cand, e)
    return None, None


def latest_checkpoint(dirname) -> Optional[str]:
    return _latest_valid(dirname)[0]


def rollback_to_latest(executor, dirname, main_program=None, scope=None
                       ) -> Optional[Dict[str, Any]]:
    """The numeric fault plane's restore (executor.HealthMonitor): load
    the newest valid checkpoint under ``dirname`` (persistables and the
    step counter, so the replay of the faulted steps is bit-exact). → its
    manifest, or None when nothing under ``dirname`` validates (the caller
    raises ``core.NumericFaultError`` rather than train on)."""
    if not dirname or not os.path.isdir(dirname):
        return None
    try:
        return load_checkpoint(executor, dirname,
                               main_program=main_program, scope=scope)
    except core.CheckpointError:
        return None


def load_checkpoint(executor, path, main_program=None, scope=None
                    ) -> Dict[str, Any]:
    """Restore a checkpoint of ``save_checkpoint``. ``path`` is one
    ``ckpt-<n>`` directory or a root holding several (the newest valid one
    is taken). Every var of the manifest goes into ``scope`` on the
    executor's device (the host without an executor), and the step
    counter becomes an int64 [1] tensor there, as ``Executor.run`` keeps
    it; the executor's host count of the scope's steps follows. The next
    step draws the keys an unbroken run would, so dropout masks and losses
    are bit-identical. A graph captured over the scope copies the new
    values into its own tensors before its next replay. → the manifest
    (global_step, the DataLoader's state, extra).

    With ``main_program``, every initialized persistable of the program
    must be in the manifest, or ``CheckpointError`` is raised before the
    scope is touched: a var the checkpoint does not cover would keep its
    startup value after the "resume" (a net rebuilt without
    ``fluid.unique_name.guard()`` names its params ``fc_1.*`` where the
    checkpoint holds ``fc_0.*``)."""
    if scope is None:
        scope = global_scope()
    if os.path.exists(os.path.join(path, CKPT_MANIFEST)):
        ckpt_dir, manifest = path, validate_checkpoint(path)
    else:
        ckpt_dir, manifest = _latest_valid(path)
        if ckpt_dir is None:
            raise core.CheckpointError(
                f"no valid checkpoint found under {path}")
    if main_program is not None:
        have = set(manifest.get("files", {}))
        missing = []
        for v in main_program.list_vars():
            if not _is_persistable(v) or v.name in have:
                continue
            sv = scope.find_var(v.name)
            if sv is None or not sv.is_initialized() \
                    or not isinstance(sv.value(), LoDTensor):
                continue  # save_checkpoint skips these too
            missing.append(v.name)
        if missing:
            raise core.CheckpointError(
                f"checkpoint {ckpt_dir} does not cover program "
                f"persistables {sorted(missing)} — resuming would leave "
                f"them at their startup init (was the net rebuilt "
                f"without fluid.unique_name.guard()?)")
    device = _device_of(executor)
    for name in manifest.get("files", {}):
        with open(os.path.join(ckpt_dir, name), "rb") as f:
            scope.var(name).set_value(
                _deserialize_lod_tensor(f.read(), device=device))
    counter = int(manifest.get("rng_counter", 0))
    scope.var(RNG_COUNTER_VAR).set_value(LoDTensor(torch.tensor(
        [counter], dtype=torch.int64,
        device=device if device is not None else "cpu")))
    from .executor import Executor
    Executor._rng_counters[scope] = counter
    return manifest
