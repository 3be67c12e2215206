"""Runtime core: dtypes, places, tensors, scopes and flags.

Counterpart of ``paddle_tpu/fluid/core.py`` with ``torch.Tensor`` buffers
in place of ``jax.Array``. A place names a ``torch.device`` explicitly;
nothing here falls back from the GPU to the CPU on its own.

Contents (this slice):
  * VarDesc.VarType enum (wire values of framework.proto VarType).
  * Places: CPUPlace, CUDAPlace; TPUPlace is an alias of the default
    accelerator, i.e. CUDAPlace.
  * LoDTensor over torch.Tensor, LoDTensorArray (the tensor arrays of
    the control-flow layers), Variable, hierarchical Scope.
  * the typed errors: EOFException (a drained non-iterable DataLoader),
    CheckpointError (a checkpoint that fails validation) and
    NumericFaultError (the numeric fault plane), and the TPU package's
    others (core.py:43-149) for the planes still to port, so that a
    script's ``except`` clauses resolve.
  * CUDAPinnedPlace (host memory) and SelectedRows (a row set of a dense
    tensor).
  * the FLAGS_ registry, limited to the flags the port reads, with
    ``set_flags``.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

try:  # numpy's bfloat16 (ml_dtypes, which jax also uses; not jax itself)
    from ml_dtypes import bfloat16 as _np_bfloat16
except ImportError:  # absent: bf16 comes back to the host as float32
    _np_bfloat16 = None

# the numpy dtype a fetched bf16 tensor comes back as
BF16_HOST_DTYPE = np.dtype(_np_bfloat16 if _np_bfloat16 is not None
                           else np.float32)

__all__ = [
    "VarDesc", "Place", "CPUPlace", "CUDAPlace", "TPUPlace", "LoDTensor",
    "LoDTensorArray",
    "Variable", "Scope", "globals_", "get_flag", "set_flag",
    "set_flags",
    "convert_np_dtype_to_dtype_", "dtype_to_np", "dtype_to_torch",
    "is_float_dtype", "global_scope", "BF16_HOST_DTYPE",
    "EOFException", "CheckpointError", "NumericFaultError",
    "CUDAPinnedPlace", "SelectedRows", "is_compiled_with_cuda",
    "WorkerDeadError", "RpcProtocolError", "SpillCorruptionError",
    "StaleClusterViewError", "DeadlineExceededError", "OverloadedError",
    "CircuitOpenError",
]


class EOFException(Exception):
    """Raised by non-iterable DataLoader/PyReader ``next()`` when the
    underlying generator is drained (the TPU package's core.py:43;
    reference: the C++ reader's EnforceNotMet-EOF that ``exe.run``
    surfaces in the py_reader loop; the user catches it, calls
    ``reader.reset()`` and starts the next epoch)."""


class CheckpointError(RuntimeError):
    """A checkpoint directory failed validation (missing manifest,
    missing files, size/CRC mismatches) or load_vars found missing
    files (the TPU package's core.py:66). The message aggregates EVERY
    bad file, not just the first."""


class NumericFaultError(FloatingPointError):
    """The numeric fault plane (FLAGS_check_nan_inf with
    FLAGS_nan_inf_action; the TPU package's core.py:97) could not contain
    a NaN/Inf: a tripped step under ``rollback`` with no checkpoint plane
    configured, no intact checkpoint to restore or the rollback budget
    spent, or a ``raise`` whose interpreter re-run reproduced no
    non-finite op output."""


# The typed errors of the planes still to port (the TPU package's
# core.py:43-149: the PS plane and serving, ROADMAP A9). Nothing in the
# port raises them yet.
class WorkerDeadError(RuntimeError):
    """A collective released because a participant was declared dead."""


class RpcProtocolError(ConnectionError):
    """The RPC wire framing is invalid; never retried."""


class SpillCorruptionError(CheckpointError):
    """A spill-log segment of an embedding table failed validation."""


class StaleClusterViewError(RuntimeError):
    """A PS data RPC reached a server that no longer owns the shard;
    ``view_dict`` carries the server's current view (or None)."""

    def __init__(self, msg: str, view=None):
        super().__init__(msg)
        self.view_dict = view


class DeadlineExceededError(TimeoutError):
    """A request's deadline expired before its work finished;
    ``queue_wait_s`` is the time it waited admitted when that was in the
    queue."""

    def __init__(self, msg: str, queue_wait_s: float = None):
        super().__init__(msg)
        self.queue_wait_s = queue_wait_s


class OverloadedError(RuntimeError):
    """Serving's admission shed the request; ``retry_after_s`` is the
    server's drain-time estimate."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class CircuitOpenError(ConnectionError):
    """An endpoint's circuit breaker is open: calls fail fast."""


# --------------------------------------------------------------------------
# dtypes (values of framework.proto VarType.Type)
# --------------------------------------------------------------------------
class _VarTypeEnum:
    BOOL = 0
    INT16 = 1
    INT32 = 2
    INT64 = 3
    FP16 = 4
    FP32 = 5
    FP64 = 6
    SIZE_T = 19
    UINT8 = 20
    INT8 = 21
    BF16 = 22

    LOD_TENSOR = 7
    SELECTED_ROWS = 8
    FEED_MINIBATCH = 9
    FETCH_LIST = 10
    STEP_SCOPES = 11
    LOD_RANK_TABLE = 12
    LOD_TENSOR_ARRAY = 13
    PLACE_LIST = 14
    READER = 15
    RAW = 17
    TUPLE = 18


class VarDesc:
    VarType = _VarTypeEnum


_DTYPE_TO_NP = {
    _VarTypeEnum.BOOL: np.bool_,
    _VarTypeEnum.INT16: np.int16,
    _VarTypeEnum.INT32: np.int32,
    _VarTypeEnum.INT64: np.int64,
    _VarTypeEnum.FP16: np.float16,
    _VarTypeEnum.FP32: np.float32,
    _VarTypeEnum.FP64: np.float64,
    _VarTypeEnum.UINT8: np.uint8,
    _VarTypeEnum.INT8: np.int8,
}

_NP_TO_DTYPE = {np.dtype(v): k for k, v in _DTYPE_TO_NP.items()}

_STR_TO_DTYPE = {
    "bool": _VarTypeEnum.BOOL,
    "int16": _VarTypeEnum.INT16,
    "int32": _VarTypeEnum.INT32,
    "int64": _VarTypeEnum.INT64,
    "float16": _VarTypeEnum.FP16,
    "bfloat16": _VarTypeEnum.BF16,
    "float32": _VarTypeEnum.FP32,
    "float64": _VarTypeEnum.FP64,
    "uint8": _VarTypeEnum.UINT8,
    "int8": _VarTypeEnum.INT8,
}

_DTYPE_TO_TORCH = {
    _VarTypeEnum.BOOL: torch.bool,
    _VarTypeEnum.INT16: torch.int16,
    _VarTypeEnum.INT32: torch.int32,
    _VarTypeEnum.INT64: torch.int64,
    _VarTypeEnum.FP16: torch.float16,
    _VarTypeEnum.FP32: torch.float32,
    _VarTypeEnum.FP64: torch.float64,
    _VarTypeEnum.UINT8: torch.uint8,
    _VarTypeEnum.INT8: torch.int8,
    _VarTypeEnum.BF16: torch.bfloat16,
}
_TORCH_TO_DTYPE = {v: k for k, v in _DTYPE_TO_TORCH.items()}


def convert_np_dtype_to_dtype_(np_dtype) -> int:
    if isinstance(np_dtype, int):
        return np_dtype
    if isinstance(np_dtype, str):
        return _STR_TO_DTYPE[np_dtype]
    if isinstance(np_dtype, torch.dtype):
        return _TORCH_TO_DTYPE[np_dtype]
    d = np.dtype(np_dtype) if not isinstance(np_dtype, np.dtype) else np_dtype
    if d in _NP_TO_DTYPE:
        return _NP_TO_DTYPE[d]
    if str(d) == "bfloat16":
        return _VarTypeEnum.BF16
    raise ValueError(f"unsupported numpy dtype {np_dtype}")


def dtype_to_np(dtype: int):
    """Host dtype. bf16 has no numpy type here; its host form is float32."""
    if dtype == _VarTypeEnum.BF16:
        return np.float32
    return _DTYPE_TO_NP[dtype]


def dtype_to_torch(dtype: int) -> torch.dtype:
    """Device dtype. Unlike the TPU package, INT64 and FP64 keep their
    width: CUDA has 64-bit integer indexing, and ids index embeddings
    as ``long``."""
    return _DTYPE_TO_TORCH[dtype]


def is_float_dtype(dtype: int) -> bool:
    return dtype in (_VarTypeEnum.FP16, _VarTypeEnum.BF16, _VarTypeEnum.FP32,
                     _VarTypeEnum.FP64)


# --------------------------------------------------------------------------
# Places
# --------------------------------------------------------------------------
class Place:
    """Base place. ``torch_device()`` names the device explicitly."""

    def __eq__(self, other):
        return type(self) is type(other) and getattr(self, "_device_id", 0) \
            == getattr(other, "_device_id", 0)

    def __hash__(self):
        return hash((type(self).__name__, getattr(self, "_device_id", 0)))

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    def __repr__(self):
        return "CPUPlace"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """One GPU by ordinal. Resolving it on a host without CUDA raises;
    it never stands in for the CPU."""

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def __repr__(self):
        return f"CUDAPlace({self._device_id})"

    def get_device_id(self):
        return self._device_id

    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r}: CUDA is not available on this host. Pass "
                "fluid.CPUPlace() to run on the CPU.")
        return torch.device("cuda", self._device_id)


# Programs written against the TPU package say TPUPlace for "the
# accelerator"; in this package the accelerator is the GPU.
TPUPlace = CUDAPlace


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory (reference place.h CUDAPinnedPlace): a
    host place, as in the TPU package (core.py:300)."""

    def __repr__(self):
        return "CUDAPinnedPlace"


def is_compiled_with_cuda() -> bool:
    """True when this torch build sees a CUDA device."""
    return torch.cuda.is_available()


# --------------------------------------------------------------------------
# Tensors
# --------------------------------------------------------------------------
def _to_device_tensor(data, place: Place) -> torch.Tensor:
    dev = place.torch_device()
    if isinstance(data, torch.Tensor):
        return data.to(dev)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(data))).to(dev)


class LoDKey(tuple):
    """A LoD as a tuple of offset tuples whose hash is computed once: the
    executor's plan keys hold a batch's LoDs, which can run to thousands
    of offsets, and are looked up several times a step."""

    def __hash__(self):
        h = self.__dict__.get("_h")
        if h is None:
            h = self.__dict__["_h"] = tuple.__hash__(self)
        return h


class LoDTensor:
    """Dense tensor + level-of-detail offsets (reference
    framework/lod_tensor.h:104). The buffer is a torch.Tensor on the
    tensor's place; LoD is host-side metadata. ``lod_key()`` is the LoD
    as a ``LoDKey`` of int tuples (None for none), made once: what the
    executor keys its plans by."""

    __slots__ = ("_array", "_lod", "_key")

    def __init__(self, array=None, lod: Optional[List[List[int]]] = None):
        self._array = array
        self._lod = [list(l) for l in lod] if lod else []
        # a LoD given as tuples is its own key
        self._key = LoDKey(lod) if lod and isinstance(lod, tuple) else None

    def set(self, np_array, place: Optional[Place] = None):
        self._array = _to_device_tensor(np_array, place or CPUPlace())

    def set_lod(self, lod):
        self._lod = [list(l) for l in lod]
        self._key = lod if isinstance(lod, LoDKey) and lod else None

    def lod(self):
        return [list(l) for l in self._lod]

    def lod_key(self) -> Optional[tuple]:
        if self._key is None and self._lod:
            self._key = LoDKey(tuple(map(int, l)) for l in self._lod)
        return self._key

    def set_recursive_sequence_lengths(self, seq_lens):
        """LoD from lengths: [[2, 3]] -> offsets [[0, 2, 5]]."""
        lod = []
        for lens in seq_lens:
            offs = [0]
            for ln in lens:
                offs.append(offs[-1] + int(ln))
            lod.append(offs)
        self._lod = lod
        self._key = None

    def recursive_sequence_lengths(self):
        return [[offs[i + 1] - offs[i] for i in range(len(offs) - 1)]
                for offs in self._lod]

    def shape(self):
        return list(self._array.shape) if self._array is not None else []

    def _dtype(self):
        return self._array.dtype if self._array is not None else None

    def numpy(self) -> np.ndarray:
        """The tensor on the host. bf16 comes back as ``ml_dtypes.bfloat16``
        bit for bit, as in the TPU package, or as float32 (exact) where
        ml_dtypes is not installed (``BF16_HOST_DTYPE`` says which)."""
        a = self._array.detach()
        if a.dtype == torch.bfloat16:
            if _np_bfloat16 is None:
                return a.float().cpu().numpy()
            return a.view(torch.int16).cpu().numpy().view(_np_bfloat16)
        return a.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    @property
    def array(self):
        return self._array

    def __len__(self):
        return int(self._array.shape[0]) if self._array is not None else 0

    def __repr__(self):
        return f"LoDTensor(shape={self.shape()}, lod={self._lod})"


class SelectedRows:
    """A row set of a [height, ...] dense tensor: the value tensor's i-th
    row is logical row ``rows[i]`` (reference: framework/selected_rows.h:32;
    the TPU package's core.py:447). The port's embedding grads are dense;
    this is the container the sparse path (ROADMAP A9) fills."""

    __slots__ = ("_rows", "_height", "_value")

    def __init__(self, rows=None, height: int = 0):
        self._rows = list(rows) if rows is not None else []
        self._height = int(height)
        self._value = LoDTensor()

    def rows(self):
        return self._rows

    def set_rows(self, rows):
        self._rows = [int(r) for r in rows]

    def height(self):
        return self._height

    def set_height(self, h):
        self._height = int(h)

    def get_tensor(self) -> LoDTensor:
        return self._value

    def sync_index(self):
        pass

    def to_dense(self) -> torch.Tensor:
        """The dense [height, ...] tensor; repeated rows add up."""
        val = self._value.array
        dense = torch.zeros((self._height,) + tuple(val.shape[1:]),
                            dtype=val.dtype, device=val.device)
        idx = torch.as_tensor(self._rows, dtype=torch.long, device=val.device)
        return dense.index_add_(0, idx, val)

    def __repr__(self):
        return f"SelectedRows(height={self._height}, nrows={len(self._rows)})"


class LoDTensorArray(list):
    """A list of LoDTensors (reference: framework/lod_tensor_array.h), the
    value of a LOD_TENSOR_ARRAY variable: the tensor-array ops write, read
    and join its entries on the host, through the interpreter."""


class LoDRankTable:
    """The sequences of one LoD level sorted by length, longest first, ties
    in sequence order (reference: framework/lod_rank_table.h): ``items``
    are (sequence index, length) pairs, ``level`` the LoD level they come
    from. Made on the host from a LoD, which is host metadata: no device
    read."""

    __slots__ = ("items", "level")

    def __init__(self, items=None, level=0):
        self.items = list(items or [])
        self.level = level

    def __repr__(self):
        return f"LoDRankTable({self.items})"


# --------------------------------------------------------------------------
# Variable / Scope (reference: framework/variable.h:26, scope.h:46)
# --------------------------------------------------------------------------
class Variable:
    """Any-container runtime variable."""

    __slots__ = ("_holder",)

    def __init__(self):
        self._holder = None

    def get_tensor(self) -> LoDTensor:
        if self._holder is None:
            self._holder = LoDTensor()
        if not isinstance(self._holder, LoDTensor):
            raise TypeError(f"variable holds {type(self._holder).__name__}")
        return self._holder

    def get_selected_rows(self) -> SelectedRows:
        """The variable's row set, made empty at first use."""
        if self._holder is None:
            self._holder = SelectedRows()
        if not isinstance(self._holder, SelectedRows):
            raise TypeError(f"variable holds {type(self._holder).__name__}")
        return self._holder

    def get_lod_tensor_array(self) -> LoDTensorArray:
        """The variable's tensor array, made empty at first use."""
        if self._holder is None:
            self._holder = LoDTensorArray()
        if not isinstance(self._holder, LoDTensorArray):
            raise TypeError(f"variable holds {type(self._holder).__name__}")
        return self._holder

    def get_lod_rank_table(self) -> LoDRankTable:
        """The variable's rank table, made empty at first use."""
        if self._holder is None:
            self._holder = LoDRankTable()
        if not isinstance(self._holder, LoDRankTable):
            raise TypeError(f"variable holds {type(self._holder).__name__}")
        return self._holder

    def set_value(self, v):
        self._holder = v

    def value(self):
        return self._holder

    def is_initialized(self):
        h = self._holder
        if h is None:
            return False
        if isinstance(h, LoDTensor):
            return h.array is not None
        return True


class Scope:
    """Hierarchical name → Variable map with child scopes."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Variable] = {}
        self._parent = parent
        self._kids: List[Scope] = []
        self._lock = threading.Lock()

    def var(self, name: str) -> Variable:
        with self._lock:
            v = self._vars.get(name)
            if v is None:
                v = Variable()
                self._vars[name] = v
            return v

    def find_var(self, name: str) -> Optional[Variable]:
        s: Optional[Scope] = self
        while s is not None:
            v = s._vars.get(name)
            if v is not None:
                return v
            s = s._parent
        return None

    def erase(self, name: str):
        self._vars.pop(name, None)

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def __contains__(self, name):
        return self.find_var(name) is not None


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def _switch_scope(scope: Scope) -> Scope:
    global _global_scope
    old = _global_scope
    _global_scope = scope
    return old


# --------------------------------------------------------------------------
# FLAGS — env-backed global config (reference: platform/flags.cc); only
# the flags this package reads
# --------------------------------------------------------------------------
class _GlobalFlags:
    _DEFAULTS: Dict[str, Any] = {
        "FLAGS_seed": 0,
        # f32 mul/matmul and attention take bf16 operands with f32
        # accumulation (the TPU package's MXU mode; on the GPU it runs
        # through bf16 tensor cores)
        "FLAGS_use_bf16_matmul": False,
        # Executor.run: "compiled" plans each block once and, on the GPU,
        # replays it as one CUDA graph; "interpreted" runs op by op over
        # the scope (the oracle). Counterpart of the TPU package's flag
        # (core.py:1542).
        "FLAGS_executor_mode": "compiled",
        # a block that fails the all-or-nothing compiled check (a
        # stateful or host-reading op such as auc or print among pure
        # ops) runs as compiled segments around interpreted islands
        # (executor.py ``_SegmentedBlock``, ir.py
        # ``analyze_block_segments``); off, such a block runs interpreted
        # whole. Counterpart of the TPU package's core.py:1549-1553.
        "FLAGS_executor_segmentation": True,
        # below this many compilable ops a block is not segmented: it runs
        # interpreted
        "FLAGS_executor_seg_min_ops": 8,
        # Executor.run reuses the device copy of a feed when the SAME
        # ndarray object is fed again with the same content (CRC32), and
        # skips its host-to-device copy (the TPU package's flag,
        # core.py:1608)
        "FLAGS_feed_device_cache": True,
        # the Program verifier at a program version's first compile
        # (analysis.maybe_verify): "" off, "warn" logs each diagnostic,
        # "error" also raises ProgramVerifyError on an error-severity one
        # (the TPU package's core.py:1541)
        "FLAGS_program_verify": "",
        # the multiprocess DataLoader: how long the consumer waits for a
        # batch before it checks that the worker process is alive, and
        # how long it waits for the worker to exit at the iterator's end
        # before it is killed (the TPU package's core.py:1619-1622)
        "FLAGS_dataloader_worker_timeout": 5.0,
        "FLAGS_dataloader_join_timeout": 5.0,
        # the numeric fault plane (the TPU package's core.py:1398-1417):
        # FLAGS_check_nan_inf reduces one health scalar a step (every
        # element of the param grads and the float fetches finite) and
        # FLAGS_nan_inf_action says what a non-finite step does:
        #   raise    - re-run the step through the interpreter, name the
        #              first op whose output is not finite and raise
        #              FloatingPointError
        #   skip     - select the params and optimizer slots back to
        #              their pre-step values on the device; no host sync
        #   rollback - skip, then restore a checkpoint after
        #              FLAGS_nan_inf_tolerance bad steps in a row, at most
        #              FLAGS_nan_inf_max_rollbacks times
        #              (executor.HealthMonitor; io.rollback_to_latest)
        "FLAGS_check_nan_inf": False,
        "FLAGS_nan_inf_action": "raise",
        "FLAGS_nan_inf_tolerance": 3,
        "FLAGS_nan_inf_max_rollbacks": 2,
    }

    def __init__(self):
        self._values: Dict[str, Any] = {}
        for k, dv in self._DEFAULTS.items():
            env = os.environ.get(k)
            self._values[k] = self._parse(env, dv) if env is not None else dv

    @staticmethod
    def _parse(s: str, like: Any):
        if isinstance(like, bool):
            return s.lower() in ("1", "true", "yes")
        if isinstance(like, int):
            return int(s)
        if isinstance(like, float):
            return float(s)
        return s

    def __getitem__(self, key):
        return self._values[key]

    def __setitem__(self, key, value):
        if key not in self._values:
            raise KeyError(f"unknown flag {key}")
        self._values[key] = value

    def __contains__(self, key):
        return key in self._values

    def keys(self):
        return self._values.keys()


globals_ = _GlobalFlags()


def get_flag(name: str):
    return globals_[name]


def set_flag(name: str, value):
    globals_[name] = value


def set_flags(d: Dict[str, Any]):
    for k, v in d.items():
        globals_[k] = v

