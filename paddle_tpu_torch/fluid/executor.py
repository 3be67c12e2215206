"""Executor (counterpart of paddle_tpu/fluid/executor.py; reference:
python/paddle/fluid/executor.py:457).

Two paths, chosen by ``FLAGS_executor_mode`` as in the TPU package:

  * compiled (default): a compilable block (every op pure, no host read
    of a tensor value, no ``while``) runs through a cache of
    ``_CompiledBlock``s keyed like the TPU package's (program id and
    version, feeds, fetches, scope), plus each feed's shape and dtype and
    the seed. A block is planned once: its state is classified (read
    before written and held by the scope), each op's kernel, attrs and
    random key are bound, and each intermediate is dropped after its last
    reader. A run writes back only the mutated state and the written
    persistables. On the GPU the first run of a key executes the plan
    eagerly on the executor's side stream (the warm-up: cuBLAS handles
    and workspaces, the kernel libraries, autograd), the second captures
    it into one CUDA graph and every later run copies its feeds into the
    graph's input buffers and replays it: one launch per ``run``. The
    graph updates the state in place, into the scope's own tensors (the
    counterpart of buffer donation). On the CPU the plan runs eagerly.
  * segmented (``FLAGS_executor_segmentation``, on by default; the TPU
    package's ``_SegmentedBlock``, executor.py:1139-1466): a block that
    is not compilable because of stateful or host-reading ops (``auc``,
    ``print``) runs as its maximal compiled segments around those ops,
    the *islands* (ir.py ``analyze_block_segments``). On the GPU the
    first run of a key is eager, the second captures each compiled
    segment into a CUDA graph of its own (replayed at once: a capture
    does not execute) and runs the islands eagerly between them, and
    every later run replays the graphs in capture order with the islands
    between them, all on the executor's stream. A segment's outputs that
    later segments or islands read stay alive as the graph's outputs;
    an island's outputs and the feeds are copied into the static input
    buffers of the segments that read them. A block with fewer than
    ``FLAGS_executor_seg_min_ops`` compilable ops runs interpreted, as
    such a block did before segments; any other failure to plan, capture
    or replay raises.
  * interpreted: the oracle (the TPU package's ``_run_interpreted_step``):
    the ops of the global block run in order over the scope, one kernel
    call each; every intermediate and grad stays in the scope.

LoD (the TPU package's executor.py:282-335): a LoDTensor's offsets are
host-side metadata. The interpreter hands the ops that declare
``needs_lod`` their inputs' LoD (``attrs["_lod"]``; a grad op through its
forward op) and writes each output with the LoD its kernel declares, or
else the first LoD-bearing input's when the output's leading length
equals that LoD's total (the reference's ShareLoD). A compiled or
segmented plan's key holds its feeds' LoDs, and its first run, which is
eager, finds every LoD of the plan and binds it, with a cache of the
device constants the kernels derive from it, into the ops' attrs: the
capture and the replays do no LoD work and copy nothing from the host. A
segmented block's compiled segment keys its plans by the LoD of its
inputs; an island takes LoDTensors with their LoD and what it writes
carries its LoD on. A fetch returns its LoD (``return_numpy=False``). A
ragged epoch gives a new key nearly every batch, whose run is eager; the
newest ``Executor._LOD_PLANS_KEPT`` such plans that never captured stay
cached, the older ones are dropped, so neither the cache nor the card's
memory grows with each batch, and a LoD that comes back captures on its
second run.

The Dataset path (the TPU package's executor.py:2315-2445):
``train_from_dataset`` and ``infer_from_dataset`` run a block once per
batch of a ``fluid.dataset`` Dataset (the native data feed parses the
slot files on the host), windows of dense batches as one run of
``n_steps``, with ``print_period``, a ``FetchHandler`` and the checkpoint
plane.

Control flow (the TPU package's executor.py:258-278, :730-826): a
``conditional_block`` whose sub-block is compilable runs inside the
compiled step, both branches over copies of the env, a write to a var the
env holds merged with ``torch.where`` on the scalar condition (so a
conditional write to a persistable the scope holds reads it as state),
and ``select_input`` picks on the device: no host read, so a step with a
``Switch`` LR schedule stays one CUDA graph. A random op inside a
conditional would draw in the untaken branch too: its block is not
compiled whole, and runs segmented with the conditional as an island (the
interpreter, which runs the taken branch alone). A ``while`` cannot be in
a graph (its trip count depends on data): its block runs segmented, the
loop a segment of its own whose body (when compilable) is a plan of its
own; the condition is read on the host before each iteration, and on the
GPU the body's first iteration is captured into a CUDA graph that every
iteration replays, the loop-carried values copied into its static
buffers. A body with a stateful op (the tensor arrays) runs in the
interpreter, as an island. In a block with other islands, conditionals
are islands too. A random op of a sub-block is keyed by (program seed,
step, its block's index and its index) folded with the iteration of each
enclosing ``while`` (``_SubKeys``), alike in the interpreter and the
compiled plans, so a dropout in a loop body draws a new mask each
iteration.

Windows (``Executor.run(..., n_steps=k)``, the TPU package's contract,
executor.py:2026): a feed whose rank is its var's rank + 1, on a var whose
first dim is -1, with leading dim k, is k distinct batches, one slice a
step; the other feeds feed every step. The compiled path runs k steps of
the one-step plan (on the GPU: k replays of its graph, the stacks
uploaded once, each slice copied into the graph's feed buffers) and
returns every fetch stacked [k, ...] with one copy to the host; the step
counter advances once a step, so a window draws what k single runs draw.
The interpreter runs windowed feeds step by step with the same stacked
contract; with the same feeds and ``n_steps`` > 1 it returns the final
step's fetches, as the TPU package's interpreted branch does, and so
does a segmented block, which runs ``n_steps`` steps as a host loop (its
islands act every step).

The numeric fault plane (``FLAGS_check_nan_inf``, ``FLAGS_nan_inf_action``;
the TPU package's executor.py:508-700) runs on both paths. A guarded
compiled step ends in an epilogue on the device: one health scalar (every
param grad and float fetch finite), a select of the state the step
overwrites back to its pre-step value where the step is not healthy, and
the AMP dynamic loss-scale update from the same scalar; under a graph all
of it is captured. ``skip`` never reads the scalar on the host;
``raise`` reads it after the fetches and re-runs a tripped step through
the interpreter, whose per-op check names the op; ``rollback`` reads it
too and feeds each step's verdict to the ``HealthMonitor``, which after
``FLAGS_nan_inf_tolerance`` tripped steps in a row restores the newest
intact checkpoint (``io.rollback_to_latest``), at most
``FLAGS_nan_inf_max_rollbacks`` times. The interpreter runs the same
classification and the same arithmetic.

The checkpoint plane (the TPU package's executor.py:1650-1765):
``set_auto_checkpoint`` saves every ``every_n_steps`` steps of the scope's
step counter at the end of a ``run`` (``io.save_checkpoint``; never from a
run whose guard tripped), ``resume_from`` restores the newest valid
checkpoint and the DataLoader's position. The executor keeps a host count
of each scope's steps (``_rng_counters``, the reference's), advanced by
the steps a run takes, so a boundary is found without reading the
device's counter; each save checks the two against each other.

A program of ``RecomputeOptimizer`` runs its compiled step through the
remat schedule of ``fluid/recompute_lowering.py``; the interpreter does
not remat (same numerics, more memory).

A ``<op>_grad`` op that no kernel is registered for runs through the
generic grad (``ops.registry.run_generic_grad``), which re-runs the
forward kernel under autograd, on both paths.

Randomness (counterpart of ``jax.random.fold_in(fold_in(key(seed),
step), idx)``): the scope holds a step counter, an int64 tensor on the
device; every run derives its keys from it on the device and adds one to
it, so a replayed graph draws new bits each step without host work. Each
op that declares ``needs_rng`` gets ``attrs["_rng"]``, a callable that
returns its key (ops/rng.py), derived from (program seed, step, op index)
at the first op of the run that draws. An op with a nonzero ``seed`` attr
(or ``fix_seed``) is keyed from that attr alone. The grad op of a random
op gets its forward op's key (``_fwd_idx``): the re-run forward draws
what the forward drew — for attention, the same dropout seed, so the
backward kernels regenerate the forward's mask. Both paths derive keys
alike, so they draw the same bits.
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings
import weakref
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import analysis, core
from .compiler import CompiledProgram
from .core import CUDAPlace, LoDTensor, Place, Scope, global_scope
from .framework import Program, Variable, default_main_program
from .ir import op_island_reason, op_reads_host_values
from ..ops import rng
from ..ops.framework_ops import host_bool
from ..ops.registry import (GRAD_SUFFIX, OPS, resolve_base_info,
                            run_generic_grad)
from ..ops.tensor_ops import assign_value_tensor

__all__ = ["Executor", "FetchHandler", "HealthMonitor", "global_scope",
           "scope_guard"]

_RNG_COUNTER = "@RNG_COUNTER@"
_EMPTY = "@EMPTY@"  # append_backward's name for "no var in this slot"
_MODES = ("compiled", "interpreted")
# a capture refuses unsafe CUDA calls (an allocation, a synchronize) from
# its own thread only: the DataLoader's prefetch thread pins and uploads
# the next window while a step's graph is captured, which in the default
# "global" mode invalidates the capture
_CAPTURE_MODE = "thread_local"
_GUARD_ACTIONS = ("raise", "skip", "rollback")
_INTERPRET = object()  # _run_compiled: the block is too small to segment


@contextlib.contextmanager
def scope_guard(scope: Scope):
    old = core._switch_scope(scope)
    try:
        yield
    finally:
        core._switch_scope(old)


class FetchHandler:
    """Periodic fetches while ``train_from_dataset`` runs (reference:
    executor.py FetchHandler and the trainer's FetchHandlerMonitor
    thread): ``handler`` gets {name: numpy array or None} snapshots of
    ``var_dict``'s vars in the scope every ``period_secs``; override it."""

    def __init__(self, var_dict=None, period_secs=60):
        if var_dict is None or not isinstance(var_dict, dict):
            raise TypeError("var_dict must be a {name: Variable} dict")
        self.var_dict = var_dict
        self.period_secs = period_secs

    def handler(self, res_dict):
        for key in res_dict:
            if isinstance(res_dict[key], np.ndarray):
                print(f"{key}[0]: {res_dict[key][0]} ")

    @staticmethod
    def help():
        print("""
class FetchHandlerExample(FetchHandler):
    def handler(self, res_dict):
        print(res_dict["var1"])  # numpy snapshot (None if not yet set)
handler = FetchHandlerExample(var_dict={"var1": var1}, period_secs=60)
""")


class _FetchHandlerMonitor:
    """A daemon thread sampling the scope's vars for a FetchHandler
    (reference: trainer_factory.py FetchHandlerMonitor). A sample copies
    each var to the host as the scope holds it at that moment, without
    waiting for the step in flight: monitoring, not a checkpoint."""

    def __init__(self, scope: Scope, handler: FetchHandler):
        import threading
        self._scope = scope
        self._handler = handler
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _sample(self):
        res = {}
        for name, var in self._handler.var_dict.items():
            v = self._scope.find_var(getattr(var, "name", var))
            val = v.value() if v is not None and v.is_initialized() \
                else None
            res[name] = val.numpy() if isinstance(val, LoDTensor) else None
        return res

    def _loop(self):
        while not self._stop_evt.wait(self._handler.period_secs):
            self._handler.handler(self._sample())

    def start(self):
        self._thread.start()

    def stop(self):
        # the loop ends and is joined before the final sample, so the
        # handler is never called from two threads at once
        self._stop_evt.set()
        self._thread.join()
        self._handler.handler(self._sample())


def _to_fetch_names(fetch_list) -> List[str]:
    names = []
    if fetch_list is None:
        return names
    if not isinstance(fetch_list, (list, tuple)):
        fetch_list = [fetch_list]
    for f in fetch_list:
        if isinstance(f, Variable):
            names.append(f.name)
        elif isinstance(f, str):
            names.append(f)
        elif isinstance(f, (list, tuple)):
            names.extend(_to_fetch_names(f))
        else:
            raise TypeError(f"bad fetch entry {f!r}")
    return names


def _window_feed_names(program, feed, n_steps: int) -> Tuple[str, ...]:
    """Feeds carrying a leading window dimension (reference
    executor.py:185): the value's rank is the var's rank + 1, the var's
    first dim is -1 (the ``fluid.data`` shape: a var of concrete shape may
    take feeds of any rank through rank-polymorphic kernels) and the
    leading dim equals ``n_steps``. A window-ranked feed whose leading dim
    disagrees with ``n_steps`` > 1 raises ValueError, and a windowed feed
    with LoD raises NotImplementedError: one LoD cannot describe a stack
    of batches."""
    names = []
    block = program.global_block()
    for name, data in feed.items():
        arr = data.array if isinstance(data, LoDTensor) else data
        shp = getattr(arr, "shape", None)
        if not shp:
            continue
        v = block._find_var_recursive(name)
        vshape = getattr(v, "shape", None) if v is not None else None
        if vshape is None or len(shp) != len(vshape) + 1 \
                or vshape[0] != -1:
            continue
        if shp[0] != n_steps:
            if n_steps == 1:
                continue
            raise ValueError(
                f"feed '{name}' has shape {tuple(shp)}: its rank says it "
                f"carries a leading window dimension (var rank "
                f"{len(vshape)}), but the window length {shp[0]} does not "
                f"match n_steps={n_steps}")
        if isinstance(data, LoDTensor) and data.lod():
            raise NotImplementedError(
                f"windowed feed '{name}' carries LoD: one LoD cannot "
                "describe a stack of batches; feed dense windows or run "
                "per step (n_steps=1)")
        names.append(name)
    return tuple(names)


def _without_feed_fetch(program: Program) -> Program:
    """``program``, or, when its global block holds ``feed`` or ``fetch``
    ops, a clone without them, made once for each program version and
    kept on the program (so the compiled cache sees one program)."""
    if not any(op.type in ("feed", "fetch")
               for op in program.global_block().ops):
        return program
    cache = program.__dict__.setdefault("_io_free", {})
    got = cache.get(program._version)
    if got is None:
        got = program.clone()
        got.global_block().ops = [op for op in got.global_block().ops
                                  if op.type not in ("feed", "fetch")]
        cache.clear()
        cache[program._version] = got
    return got


def _initialized(scope: Scope, name: str) -> bool:
    v = scope.find_var(name)
    return v is not None and v.is_initialized()


def _scope_tensor(scope: Scope, name: str) -> Optional[torch.Tensor]:
    v = scope.find_var(name)
    if v is None or not v.is_initialized() \
            or not isinstance(v.value(), LoDTensor):
        return None
    return v.value().array


# --------------------------------------------------------------------------
# LoD (the TPU package's executor.py:282-335): variable-length sequence
# offsets ride next to the tensors as host-side nested tuples. A compiled
# plan's key holds its feeds' LoDs, so within a plan every LoD is fixed:
# its first run finds them (``_Lods``), binds them into the attrs of the
# ops that read them, and the later runs, the capture and the replays
# compute no LoD at all (reference: framework/lod_tensor.h:104,
# operator.cc:967, which re-infer LoD every step).
# --------------------------------------------------------------------------
def _normalize_lod(lod):
    if not lod:
        return None
    return core.LoDKey(tuple(map(int, lvl)) for lvl in lod)


def _op_needs_lod(op) -> bool:
    if OPS.has(op.type):
        return OPS.get(op.type).needs_lod
    if op.type.endswith("_grad") and OPS.has(op.type[:-5]):
        return OPS.get(op.type[:-5]).needs_lod
    return False


def _collect_in_lods(op, lookup):
    return {slot: [lookup(n) for n in names]
            for slot, names in op.inputs.items()}


def _propagate_lods(op, outs, in_lods, set_lod, get_len):
    """Apply kernel-declared output LoDs; else share the first lod-bearing
    input's LoD with outputs of matching leading length (reference ShareLoD
    default)."""
    explicit = None
    if isinstance(outs, dict):
        explicit = outs.pop("_lod", None)
    if explicit:
        for slot, levels_list in explicit.items():
            names = op.outputs.get(slot) or []
            for n, lv in zip(names, levels_list):
                set_lod(n, _normalize_lod(lv))
        return
    src = None
    for slot, lods in in_lods.items():
        for lv in lods:
            if lv:
                src = lv
                break
        if src:
            break
    if not src:
        return
    total = src[-1][-1]
    for slot, names in op.outputs.items():
        for n in names:
            if get_len(n) == total:
                set_lod(n, src)


def _tensor_lod(val) -> Optional[tuple]:
    """The normalized LoD of a scope value (None for no LoD)."""
    return val.lod_key() if isinstance(val, LoDTensor) else None


class _Lods:
    """The LoD of a plan's names (name → levels or None): seeded from its
    feeds and state, grown by its first run, in which each bound op finds
    its inputs' LoDs here and records its outputs' (``_Step.run``); fixed
    (``frozen``) after that run."""

    __slots__ = ("env", "frozen")

    def __init__(self, init):
        self.env: Dict[str, Optional[tuple]] = dict(init)
        self.frozen = False


# --------------------------------------------------------------------------
# planning (reference executor.py:231-337)
# --------------------------------------------------------------------------
_op_reads_host_values = op_reads_host_values


def _op_is_stateful(op) -> bool:
    return op_island_reason(op) in ("stateful", "unregistered")


def _op_needs_rng(op_type: str) -> bool:
    info = resolve_base_info(op_type)
    return info.needs_rng if info is not None else False


# control flow that the compiled step lowers itself (the TPU package's
# executor.py:249): a conditional's branches run inside the step, their
# writes selected on the device, and select_input picks on the device; a
# while is a loop of its body's own plan, driven from the host by the
# segmented step
_LOWERED_CONTROL = frozenset({"while", "conditional_block", "select_input"})


def _ops_compilable(ops, in_cond: bool = False) -> bool:
    """True if every op has a pure kernel that reads no tensor value on
    the host, or is lowered control flow whose sub-blocks are compilable
    (the TPU package's executor.py:258). ``in_cond``: inside a
    conditional's sub-block, whose lowering runs both branches: a random
    op there would draw in the untaken branch too, so it makes the block
    not compilable, and the conditional runs in the interpreter, which
    runs the taken branch alone."""
    for op in ops:
        if op.type in _LOWERED_CONTROL:
            sub = op.attrs.get("sub_block")
            if sub is not None and not _ops_compilable(
                    sub.ops, in_cond or op.type == "conditional_block"):
                return False
        elif op_island_reason(op) or (in_cond and _op_needs_rng(op.type)):
            return False
    return True


def _has_while(ops) -> bool:
    """A ``while`` among ``ops`` or in their sub-blocks."""
    for op in ops:
        sub = op.attrs.get("sub_block")
        if op.type == "while" or (sub is not None and _has_while(sub.ops)):
            return True
    return False


def _whole_compilable(ops) -> bool:
    """The block runs as one planned step (one CUDA graph on the card):
    compilable, and without a ``while``, whose trip count depends on data,
    which a graph cannot hold: a ``while`` sends its block to the
    segmented step, which drives the loop from the host."""
    return _ops_compilable(ops) and not _has_while(ops)


def _compiled_loop(op) -> bool:
    """A ``while`` whose body runs as its own compiled plan: the body is
    compilable and holds no ``while`` itself. Any other ``while`` runs in
    the interpreter."""
    sub = op.attrs.get("sub_block")
    return op.type == "while" and sub is not None \
        and _ops_compilable(sub.ops) and not _has_while(sub.ops)


def _classify_block_state(ops, block, feed_names, scope):
    """Names read before any write that are initialized tensors in the
    scope become *state*; everything written lands in *written*. Raises
    KeyError for a data var missing from the feed (a value left in the
    scope by an earlier run does not count: it would silently compute on
    the previous batch) and RuntimeError for an uninitialized persistable
    (startup program not run) or any other var read before anything
    writes it."""
    written: set = set()
    state_names: List[str] = []
    block_vars = block.vars
    for op in ops:
        if op.type == "conditional_block":
            # a conditional write to a var the scope holds keeps its old
            # value when the branch is not taken: the lowering selects
            # between the two, so the old value is read
            state_names.extend(
                n for n in op.output_arg_names
                if n not in written and n not in feed_names
                and n not in state_names and _scope_tensor(scope, n)
                is not None)
        for name in op.input_arg_names:
            if name in written or name in feed_names or name in state_names \
                    or name == _EMPTY:
                continue
            bv = block_vars.get(name)
            if bv is not None and (bv.is_data or bv.need_check_feed):
                raise KeyError(
                    f"feed variable '{name}' is required by the program "
                    f"but was not provided in feed=")
            if _scope_tensor(scope, name) is not None:
                state_names.append(name)
            elif bv is not None and bv.persistable:
                raise RuntimeError(
                    f"persistable variable '{name}' (read by op "
                    f"'{op.type}') is not initialized in the scope — "
                    f"run the startup program first")
            else:
                raise RuntimeError(f"var '{name}' is read by op '{op.type}' "
                                   "before anything writes it")
        written.update(op.output_arg_names)
    return state_names, written


def _resolve(op, idx: int):
    """(info, grad_of, rng_idx) of block op ``idx``: a registered kernel,
    or the generic grad of the forward op ``grad_of``, whose key is the
    forward op's (``_fwd_idx``)."""
    otype = op.type
    if OPS.has(otype):
        return OPS.get(otype), None, idx
    if otype.endswith("_grad") and OPS.has(otype[:-5]):
        return OPS.get(otype[:-5]), otype[:-5], \
            int(op.attrs.get("_fwd_idx", idx))
    raise NotImplementedError(f"op '{otype}' is not implemented in "
                              "paddle_tpu_torch yet")


def _fixed_seed(attrs) -> bool:
    return bool(attrs.get("fix_seed", False) or attrs.get("seed", 0))


def _rng_indices(ops) -> List[int]:
    """The op indices a run derives keys for: each random op's, a grad
    op's forward op's in its place."""
    return sorted({_resolve(op, i)[2] for i, op in enumerate(ops)
                   if _op_needs_rng(op.type) and not _fixed_seed(op.attrs)})


class _StepKeys:
    """The random keys of one run: the step key from (program seed, the
    scope's step counter) and from it every random op's key at once, on
    the device, derived when the first op draws — a run that draws
    nothing launches nothing for them. The keys of the global block's
    ops; ``_SubKeys`` derives a sub-block's from the same counter."""

    __slots__ = ("seed", "slot", "hidx", "counter", "keys")
    its = ()  # no enclosing while

    def __init__(self, seed: int, idxs: Sequence[int], device):
        self.seed = seed
        self.slot = {k: j for j, k in enumerate(idxs)}
        self.hidx = rng.hashed_indices(idxs, device)
        self.counter = None
        self.keys = None

    @property
    def root(self) -> "_StepKeys":
        return self

    def begin(self, counter: torch.Tensor):
        self.counter, self.keys = counter, None

    def end(self):
        self.counter = self.keys = None

    def key(self, idx: int) -> torch.Tensor:
        if self.keys is None:
            self.keys = rng.op_keys(rng.step_key(self.seed, self.counter),
                                    self.hidx)
        j = self.slot[idx]
        return self.keys[j:j + 1]


def _sub_index(block_idx: int, idx: int) -> int:
    """The index a sub-block's op is keyed by: its block's index above
    bit 20, its index in the block below."""
    return (block_idx << 20) | idx


class _SubKeys:
    """The random keys of a sub-block's ops: from (program seed, the
    scope's step counter, the block's index, the op's index), each folded
    with the iteration of every enclosing ``while`` (``its``: int64 [1]
    tensors on the device, which a captured loop body updates in place),
    so a dropout in a loop body draws a new mask each iteration. Derived
    on the device at the first draw after ``reset``, each time anew (a
    captured body recomputes them at every replay); the interpreter and
    the compiled plans derive them alike."""

    __slots__ = ("root", "its", "slot", "hidx", "keys")

    def __init__(self, parent, block, device, its=None):
        self.root = parent.root
        self.its = parent.its if its is None else tuple(its)
        idxs = _rng_indices(block.ops)
        self.slot = {k: j for j, k in enumerate(idxs)}
        self.hidx = rng.hashed_indices(
            [_sub_index(block.idx, i) for i in idxs], device) \
            if idxs else None
        self.keys = None

    def reset(self):
        self.keys = None

    def key(self, idx: int) -> torch.Tensor:
        if self.keys is None:
            root = self.root
            k = rng.op_keys(rng.step_key(root.seed, root.counter), self.hidx)
            for t in self.its:
                k = rng.fold(k, t)
            self.keys = k
        j = self.slot[idx]
        return self.keys[j:j + 1]


def _kernel_attrs(op, info, ridx: int, device, keys: _StepKeys):
    """The attrs a kernel gets: the op's, plus ``_device`` and ``_rng``
    where the op declared it needs them."""
    attrs = op.attrs
    if info.needs_rng or info.needs_device:
        attrs = dict(attrs)
        attrs["_device"] = device
        if info.needs_rng:
            if _fixed_seed(attrs):
                seed = int(attrs.get("seed", 0))
                attrs["_rng"] = lambda: rng.fixed_key(seed, device)
            else:
                attrs["_rng"] = lambda: keys.key(ridx)
    return attrs


def _step_counter(scope: Scope, device) -> torch.Tensor:
    """The scope's step counter, an int64 [1] tensor on ``device``, made
    at the scope's first run."""
    v = scope.find_var(_RNG_COUNTER) or scope.var(_RNG_COUNTER)
    t = v.value().array if v.is_initialized() else None
    if t is None or t.device != device:
        t = torch.zeros(1, dtype=torch.int64, device=device) if t is None \
            else t.to(device)
        v.set_value(LoDTensor(t))
    return t


def _launch_counts() -> Dict[str, int]:
    from ..ops.cuda import dropout, flash_attention
    return {**flash_attention.launch_counts(), **dropout.launch_counts()}


# --------------------------------------------------------------------------
# the numeric fault plane (reference executor.py:382-430, 1880-2010)
# --------------------------------------------------------------------------
def _guard_flags() -> Tuple[bool, str]:
    """(FLAGS_check_nan_inf, FLAGS_nan_inf_action); an unknown action
    with the check on raises ValueError rather than guard nothing."""
    check = bool(core.globals_["FLAGS_check_nan_inf"])
    action = str(core.globals_["FLAGS_nan_inf_action"])
    if check and action not in _GUARD_ACTIONS:
        raise ValueError(f"FLAGS_nan_inf_action={action!r} is not one of "
                         f"{sorted(_GUARD_ACTIONS)}")
    return check, action


def _block_reads_amp_scale(ops, amp) -> bool:
    """True when an op of the block reads the AMP loss scale: the scaled
    loss and the unscale survived into this program. A program without
    them must not run the scale update."""
    return any(amp["scale"] in op.input_arg_names for op in ops)


def _amp_scale_update(healthy, scale, good, bad, cfg):
    """The dynamic loss-scale transition (reference:
    operators/amp/update_loss_scaling_op.h), from the step's health
    scalar, on the device:

      healthy: good += 1, bad = 0; good == incr_every_n_steps:
               scale *= incr_ratio, good = 0
      tripped: bad += 1, good = 0; bad == decr_every_n_nan_or_inf:
               scale = max(scale * decr_ratio, 1), bad = 0

    ``scale`` is f32 [1], the counters int32 [1]. Both paths run this
    same arithmetic, so their scales agree bit for bit."""
    good_i = good + 1
    bad_i = bad + 1
    incr_hit = good_i >= int(cfg["incr_every_n_steps"])
    decr_hit = bad_i >= int(cfg["decr_every_n_nan_or_inf"])
    scale_good = torch.where(incr_hit, scale * float(cfg["incr_ratio"]),
                             scale)
    scale_bad = torch.where(decr_hit, torch.clamp_min(
        scale * float(cfg["decr_ratio"]), 1.0), scale)
    zero = torch.zeros_like(good)
    new_scale = torch.where(healthy, scale_good, scale_bad)
    new_good = torch.where(healthy, torch.where(incr_hit, zero, good_i),
                           zero)
    new_bad = torch.where(healthy, zero, torch.where(decr_hit, zero, bad_i))
    return new_scale, new_good, new_bad


def _check_op_outputs_finite(op, idx: int, outs) -> None:
    """The ``raise`` action's per-op check (interpreter): one host read
    of the stacked finite flags of the op's float outputs; on a trip a
    FloatingPointError names the op's index and type, the output slot,
    var, dtype and shape, the NaN and Inf counts and the first offending
    flat indices."""
    flat = []
    for slot, vals in (outs or {}).items():
        names = op.outputs.get(slot) or []
        for k, v in enumerate(vals or []):
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                flat.append((slot, names[k] if k < len(names) else f"[{k}]",
                             v))
    if not flat:
        return
    ok = torch.stack([torch.isfinite(v).all() for _, _, v in flat]).tolist()
    if all(ok):
        return
    problems = []
    for good, (slot, name, v) in zip(ok, flat):
        if good:
            continue
        flat_v = v.detach().reshape(-1)
        bad = torch.nonzero(~torch.isfinite(flat_v))[:8].reshape(-1)
        problems.append(
            f"output {slot} (var '{name}', dtype "
            f"{str(v.dtype).replace('torch.', '')}, shape "
            f"{tuple(v.shape)}): {int(torch.isnan(flat_v).sum())} NaN / "
            f"{int(torch.isinf(flat_v).sum())} Inf, first offending flat "
            f"indices {bad.tolist()}")
    raise FloatingPointError(f"NaN/Inf in output of op #{idx} '{op.type}': "
                             + "; ".join(problems))


# --------------------------------------------------------------------------
class _Step:
    """One op of a plan, bound: its kernel (or the forward op whose
    generic grad it is), attrs, input and output names, the names it
    reads and writes, and the names to drop from the env after it."""

    __slots__ = ("kernel", "grad_of", "attrs", "ins", "outs", "frees",
                 "wanted", "fwd_in", "reads", "writes", "op", "lods",
                 "base_attrs")

    def __init__(self, op, info, grad_of, attrs, lods=None):
        self.kernel = info.kernel
        self.grad_of = grad_of
        self.attrs = self.base_attrs = attrs
        self.ins = tuple((s, tuple(n)) for s, n in op.inputs.items())
        self.outs = tuple((s, tuple(n)) for s, n in op.outputs.items())
        self.frees = ()
        self.wanted = list(op.outputs)
        self.fwd_in = attrs.get("_fwd_in", list(op.inputs))
        self.reads = tuple(op.input_arg_names)
        self.writes = tuple(op.output_arg_names)
        self.op = op
        self.lods = lods  # the plan's _Lods; None in a loop body

    def run(self, env: Dict[str, torch.Tensor]):
        lods = self.lods
        tracing = lods is not None and not lods.frozen
        if tracing:
            in_lods = _collect_in_lods(self.op, lods.env.get)
            if _op_needs_lod(self.op):
                # bound for the plan's life: the LoD, and a cache for the
                # device constants the kernel derives from it, filled now,
                # before any capture
                self.attrs = dict(self.base_attrs, _lod=in_lods, _lodc={})
        ins = {s: [env.get(n) for n in names] for s, names in self.ins}
        if self.grad_of is None:
            outs = self.kernel(ins, self.attrs)
        else:
            outs = run_generic_grad(self.grad_of, ins, self.attrs,
                                    wanted_grad_slots=self.wanted,
                                    fwd_input_slots=self.fwd_in)
        outs = outs or {}
        for slot, names in self.outs:
            for n, v in zip(names, outs.get(slot) or []):
                if v is not None and n != _EMPTY:
                    env[n] = v
        if tracing:
            _propagate_lods(self.op, outs, in_lods, lods.env.__setitem__,
                            lambda n: env[n].shape[0] if n in env
                            and env[n].dim() else None)


class _CondStep:
    """A ``conditional_block`` lowered (the TPU package's
    executor.py:781-811): its sub-block's bound ops run unconditionally
    over a copy of the env; a write to a var the env already holds merges
    as ``torch.where(cond, new, old)`` on the scalar condition, on the
    device (no host read, so a CUDA graph holds it), and a fresh var flows
    through for ``select_input`` to pick. A write that changes a var's
    shape cannot be selected and raises NotImplementedError. The taken
    branch's values are the interpreter's, bit for bit."""

    __slots__ = ("steps", "keys", "cond", "written", "reads", "writes",
                 "frees")

    def __init__(self, op, steps, keys):
        self.steps = tuple(steps)
        self.keys = keys
        cond = op.inputs.get("Cond") or []
        self.cond = cond[0] if cond else None
        self.written = tuple(dict.fromkeys(
            n for st in steps for n in st.writes if n != _EMPTY))
        self.reads = tuple(_effective_reads(op))
        self.writes = tuple(op.output_arg_names)
        self.frees = ()

    def run(self, env: Dict[str, torch.Tensor]):
        branch = dict(env)
        self.keys.reset()
        exec_units(self.steps, branch)
        mask = env[self.cond].reshape(()) != 0 \
            if self.cond in env else None
        for n in self.written:
            v, old = branch.get(n), env.get(n)
            if v is None or v is old:
                continue
            if old is None or mask is None:
                env[n] = v
            elif old.shape == v.shape:
                env[n] = torch.where(mask, v, old)
            else:
                raise NotImplementedError(
                    f"conditional_block branch changes the shape of outer "
                    f"var '{n}' ({tuple(old.shape)} -> {tuple(v.shape)}); "
                    "conditional shape-changing writes cannot be compiled "
                    "— produce a new variable instead")


class _SelectStep:
    """``select_input`` lowered: Out = X[1] where Mask holds, else X[0],
    selected on the device; a branch output that is missing passes the
    other through. Branch outputs of different shapes raise
    NotImplementedError."""

    __slots__ = ("mask", "xs", "out", "reads", "writes", "frees")

    def __init__(self, op):
        self.mask = op.inputs["Mask"][0]
        self.xs = tuple(op.inputs["X"])
        self.out = op.outputs["Out"][0]
        self.reads = tuple(op.input_arg_names)
        self.writes = tuple(op.output_arg_names)
        self.frees = ()

    def run(self, env: Dict[str, torch.Tensor]):
        xf, xt = env.get(self.xs[0]), env.get(self.xs[1])
        if xf is None or xt is None:
            picked = xt if xf is None else xf
        elif xt.shape == xf.shape:
            picked = torch.where(env[self.mask].reshape(()) != 0, xt, xf)
        else:
            raise NotImplementedError(
                f"cond branches produce different shapes "
                f"({tuple(xt.shape)} vs {tuple(xf.shape)}) for the same "
                "output — a compiled step needs matching branch shapes; "
                "pad or restructure the branches")
        env[self.out] = picked


def set_liveness(units, keep) -> None:
    """Give each unit of an execution order (a ``_Step``, or a remat unit
    with ``reads``, ``writes`` and ``run``) the names to drop from the env
    after it: every name that is not in ``keep`` leaves after the last
    unit that reads or writes it."""
    last: Dict[str, int] = {}
    for i, u in enumerate(units):
        for n in u.reads + u.writes:
            last[n] = i
    frees: List[List[str]] = [[] for _ in units]
    for n, i in last.items():
        if n not in keep and n != _EMPTY:
            frees[i].append(n)
    for u, f in zip(units, frees):
        u.frees = tuple(f)


def exec_units(units, env: Dict[str, torch.Tensor]) -> None:
    """Run an execution order over ``env``, dropping each unit's frees
    after it."""
    for u in units:
        u.run(env)
        for n in u.frees:
            env.pop(n, None)


# --------------------------------------------------------------------------
# the compiled step (reference executor.py:432)
# --------------------------------------------------------------------------
class _CompiledBlock:
    """One planned step for (program, feeds, fetches, scope): state
    classified once, ops bound once, intermediates dropped after their
    last reader; on the GPU a warm-up run, then one CUDA graph replayed
    per run.

    ``mut_state``: state the step overwrites (written back: in place
    under a graph), ``ro_state``: state it only reads,
    ``extra_writeback``: persistables it writes without reading first.
    ``stats`` counts eager runs, captures, replays (the run after a
    capture included) and the seconds spent capturing; ``last_exec`` says
    which the last run was; ``graph_launches`` holds each kernel's
    launches recorded in the graph, i.e. launched by each replay.
    ``last_health`` is the last run's health on the device (a bool
    scalar, [n_steps] for a window; None when the guard is off).
    ``_remat_plan`` is the recompute plan, or None."""

    kind = "compiled"

    def __init__(self, program: Program, feed_names, fetch_names,
                 scope: Scope, seed: int, device, stream=None, pool=None,
                 feed_lods=None):
        self._init_common(program, feed_names, fetch_names, scope, seed,
                          device, stream, pool, feed_lods)
        ropt = getattr(program, "_recompute_opt", None)
        if ropt:
            from .recompute_lowering import build_plan
            self._remat_plan = build_plan(self, ropt["checkpoints"])
        self._units = self._build_plan()
        self._graph = None
        self._static_feeds: Dict[str, torch.Tensor] = {}
        self._static_fetch: List[torch.Tensor] = []
        self._static_health: Optional[torch.Tensor] = None

    def _init_common(self, program: Program, feed_names, fetch_names,
                     scope: Scope, seed: int, device, stream, pool,
                     feed_lods=None):
        """The setup a compiled and a segmented block share: the names,
        the ops, the state and the guard (classified before anything
        runs), the LoDs it starts from (its feeds', and its state's as the
        scope holds them: ``_init_lods``), the step keys and the run
        records. ``fetch_lods`` and ``out_lods`` (the written-back
        state's) are the plan's LoDs, known after its first run."""
        self._scope_ref = weakref.ref(scope)
        self.program = program
        self.feed_names = tuple(feed_names)
        self.fetch_names = tuple(fetch_names)
        self.device = device
        self.ops = list(program.global_block().ops)
        self._classify_state(program, scope)
        self._init_guard(program, scope)
        self._init_lods: Dict[str, tuple] = dict(feed_lods or {})
        for n in self.mut_state + self.ro_state:
            lv = _tensor_lod(scope.find_var(n).value())
            if lv:
                self._init_lods.setdefault(n, lv)
        self.fetch_lods: List[Optional[tuple]] = [
            self._init_lods.get(n) for n in self.fetch_names]
        self.out_lods: Dict[str, Optional[tuple]] = {}
        self._remat_plan = None
        self._keys = _StepKeys(seed, _rng_indices(self.ops), device)
        self.last_health: Optional[torch.Tensor] = None
        self._stream, self._pool = stream, pool
        self._captured: Dict[str, torch.Tensor] = {}
        self._extra_targets: Dict[str, torch.Tensor] = {}
        self.graph_launches: Dict[str, int] = {}
        self.stats = {"eager": 0, "captures": 0, "replays": 0,
                      "capture_s": 0.0}
        self.last_exec: Optional[str] = None
        self._warned: set = set()

    def _classify_state(self, program: Program, scope: Scope):
        """The block's state, from the scope, before anything runs:
        ``written``, ``mut_state``, ``ro_state`` (a fetched var that no op
        writes is read from the scope as it is) and ``extra_writeback``.
        Raises as ``_classify_block_state``, and KeyError for a fetch that
        is neither produced nor in the scope."""
        block = program.global_block()
        state_names, written = _classify_block_state(
            self.ops, block, set(self.feed_names), scope)
        for n in self.fetch_names:
            if n in written or n in self.feed_names or n in state_names:
                continue
            if _scope_tensor(scope, n) is None:
                raise KeyError(f"fetch var '{n}' is not produced by the "
                               "program")
            state_names.append(n)
        self.written = written
        self.mut_state = tuple(n for n in state_names if n in written)
        self.ro_state = tuple(n for n in state_names if n not in written)
        persistable = {v.name for v in block.vars.values() if v.persistable}
        self.extra_writeback = tuple(sorted(
            n for n in written if n in persistable
            and n not in self.mut_state and n not in self.feed_names))

    def _bind(self, op, idx: int, keys=None, lods=None):
        """Op ``idx`` of its block bound to its kernel, attrs and key
        (``keys``: its block's, the global block's by default) and to the
        plan's ``lods`` (``_Lods``; a loop body's carry none). A
        conditional binds its sub-block's ops into a ``_CondStep``,
        ``select_input`` is a ``_SelectStep``, and ``assign_value`` gets
        its constant made now, on the device, for the op to copy."""
        keys = self._keys if keys is None else keys
        if op.type == "conditional_block":
            sub = op.attrs["sub_block"]
            skeys = _SubKeys(keys, sub, self.device)
            return _CondStep(op, [self._bind(sop, j, skeys, lods)
                                  for j, sop in enumerate(sub.ops)], skeys)
        if op.type == "select_input":
            return _SelectStep(op)
        info, grad_of, ridx = _resolve(op, idx)
        attrs = _kernel_attrs(op, info, ridx, self.device, keys)
        if op.type == "assign_value":
            attrs = dict(attrs, _const=assign_value_tensor(op.attrs,
                                                           self.device))
        return _Step(op, info, grad_of, attrs, lods)

    def _build_plan(self) -> list:
        """Each op bound, in execution order (the program's, or the remat
        schedule), with liveness: a name that is neither fetched, written
        back nor read by the guard's health leaves the env after the last
        unit that reads or writes it. Under remat a segment's interior
        lives only inside its forward and its span."""
        self._lods = _Lods(self._init_lods)
        steps = [self._bind(op, i, lods=self._lods)
                 for i, op in enumerate(self.ops)]
        if self._remat_plan is not None:
            from .recompute_lowering import schedule
            units = schedule(self._remat_plan,
                             {id(op): st for op, st in zip(self.ops, steps)})
        else:
            units = steps
        set_liveness(units, set(self.fetch_names) | set(self.mut_state)
                     | set(self.extra_writeback) | set(self._health_names))
        return units

    # ------------------------------------------------ numeric fault guard
    def _init_guard(self, program: Program, scope: Scope):
        """The guard's configuration, fixed at build (the cache key holds
        the flags, so flipping one builds a new block; reference
        executor.py:508):

          _guard_check  FLAGS_check_nan_inf
          _guard_action raise | skip | rollback
          _amp          program._amp_dynamic (the loss-scale var names and
                        hyperparameters) or None
          _guard_active either: the step keeps its pre-step state
                        reachable and selects it back on a bad step
                        (under AMP an overflowed step is dropped, its
                        scale update applied; under raise the select keeps
                        the state for the interpreter's re-run)

        When active, the initialized extra-writeback persistables join
        ``mut_state``, so the discard covers every persistable the step
        writes, and the AMP vars join it, so the epilogue's updates are
        written back. The health reduces over the param grads (a grad
        that is finite into a finite update keeps the params finite),
        else over every grad, else over the written state; the fetches
        are added in the epilogue."""
        self._guard_check, self._guard_action = _guard_flags()
        self._amp = getattr(program, "_amp_dynamic", None)
        if self._amp is not None and not _block_reads_amp_scale(
                self.ops, self._amp):
            self._amp = None
        self._guard_active = self._amp is not None or self._guard_check
        self._select_names: Tuple[str, ...] = ()
        self._health_names: Tuple[str, ...] = ()
        if not self._guard_active:
            return
        promoted = tuple(n for n in self.extra_writeback
                         if _scope_tensor(scope, n) is not None)
        self.mut_state += promoted
        self.extra_writeback = tuple(n for n in self.extra_writeback
                                     if n not in promoted)
        amp_names = ()
        if self._amp is not None:
            amp_names = tuple(self._amp[k] for k in ("scale", "good", "bad"))
            for n in amp_names:
                self.ro_state = tuple(x for x in self.ro_state if x != n)
                if n not in self.mut_state:
                    if _scope_tensor(scope, n) is None:
                        raise RuntimeError(
                            f"AMP dynamic loss scaling var '{n}' is not "
                            "initialized in the scope: run the startup "
                            "program first")
                    self.mut_state += (n,)
        # the discard covers the state the step overwrites; the AMP vars
        # are the epilogue's own (a dropped step still updates the scale)
        self._select_names = tuple(n for n in self.mut_state
                                   if n in self.written
                                   and n not in amp_names)
        grads = {n for n in self.written if n.endswith(GRAD_SUFFIX)}
        self._health_names = tuple(
            n + GRAD_SUFFIX for n in self._select_names
            if n + GRAD_SUFFIX in grads) or tuple(sorted(grads))

    def _guard_epilogue(self, orig, new, fetches, env) -> torch.Tensor:
        """The guard's tail of one step, on the device: the health scalar
        over the health names (else the written state) and the float
        fetches, then ``_apply_discard`` over ``new``. Returns the
        health."""
        from .ir import fused_health
        vals = [env[n] for n in self._health_names if n in env]
        if not vals:
            vals = [new[n] for n in self._select_names if n in new]
        health = fused_health(vals + list(fetches), self.device)
        self._apply_discard(new, orig, health)
        return health

    def _apply_discard(self, store, orig, health):
        """Where the step is not healthy, each selected state var goes back
        to its pre-step value (``torch.where`` on the device; a var whose
        shape changed cannot be selected and is warned of once); then the
        AMP scale update. Under ``raise`` a tripped step keeps its
        pre-step scale and counters, so the interpreter's re-run sees the
        scale that overflowed."""
        for n in self._select_names:
            nv, ov = store.get(n), orig.get(n)
            if nv is None or ov is None or nv is ov:
                continue
            if nv.shape == ov.shape:
                store[n] = torch.where(health, nv, ov)
            elif n not in self._warned:
                self._warned.add(n)
                warnings.warn(
                    f"numeric fault guard: state var '{n}' changes shape "
                    f"during the step ({tuple(ov.shape)} -> "
                    f"{tuple(nv.shape)}) and cannot be covered by the "
                    "bad-step discard: on a tripped step it keeps its "
                    "post-step value", stacklevel=3)
        if self._amp is not None:
            a = self._amp
            olds = (store[a["scale"]], store[a["good"]], store[a["bad"]])
            news = _amp_scale_update(health, *olds, a)
            if self._guard_check and self._guard_action == "raise":
                news = tuple(torch.where(health, nv, ov)
                             for nv, ov in zip(news, olds))
            store[a["scale"]], store[a["good"]], store[a["bad"]] = news

    # ---------------------------------------------------------- one step
    def _step(self, feeds, state, counter):
        """The plan once over a local env → (fetches, {name: new value}
        of the state and persistables to write back, the health scalar or
        None). Adds one to the step counter. ``state`` holds the pre-step
        tensors: no op writes a state tensor in place, so the guard's
        select reads them intact."""
        env = dict(state)
        env.update(feeds)
        self._keys.begin(counter)
        try:
            exec_units(self._units, env)
        finally:
            self._keys.end()
        counter.add_(1)
        if not self._lods.frozen:
            self._freeze_lods(self._lods)
        fetches = []
        for n in self.fetch_names:
            if n not in env:
                raise KeyError(f"fetch var '{n}' not produced by program")
            fetches.append(env[n])
        new = {n: env[n] for n in self.mut_state}
        new.update((n, env[n]) for n in self.extra_writeback if n in env)
        health = (self._guard_epilogue(state, new, fetches, env)
                  if self._guard_active else None)
        return fetches, new, health

    def _freeze_lods(self, lods: _Lods):
        """After the plan's first run: its fetches' and written-back
        state's LoDs, and no LoD work in any later run."""
        lods.frozen = True
        self.fetch_lods = [lods.env.get(n) for n in self.fetch_names]
        self.out_lods = {n: lods.env.get(n)
                         for n in self.mut_state + self.extra_writeback}

    def _wrap(self, name: str, t: torch.Tensor) -> LoDTensor:
        """``t`` as the scope's value of ``name``, with the LoD the plan
        gives it."""
        return LoDTensor(t, self.out_lods[name] if name in self.out_lods
                         else self._init_lods.get(name))

    def _fetched(self, fetched, return_numpy):
        """The fetches as numpy arrays, or as LoDTensors with their LoD."""
        if return_numpy:
            return [LoDTensor(t).numpy() for t in fetched]
        return [LoDTensor(t, lv) for t, lv in zip(fetched, self.fetch_lods)]

    def _check_no_lod_fetch(self):
        """A window cannot stack a fetch with LoD (the TPU package's
        executor.py:1081)."""
        if any(lv is not None for lv in self.fetch_lods):
            raise NotImplementedError(
                "n_steps > 1 cannot stack LoD-carrying fetches — fetch "
                "dense vars or run per-step (n_steps=1)")

    def _read_state(self, scope: Scope) -> Dict[str, torch.Tensor]:
        state = {}
        for n in self.mut_state + self.ro_state:
            t = _scope_tensor(scope, n)
            if t is None:
                raise RuntimeError(f"state variable '{n}' is no longer "
                                   "initialized in the scope")
            state[n] = t
        return state

    # -------------------------------------------------------------- runs
    def run(self, scope: Scope, feeds: Dict[str, torch.Tensor],
            return_numpy: bool = True):
        """One step. ``feeds``: name → tensor in the var's dtype, on the
        host or the device. Returns the fetches as numpy arrays, or as
        LoDTensors the caller owns. The step's health, when the guard is
        on, stays on the device in ``last_health``."""
        if self._stream is None:  # the CPU: no graph
            fetched, health = self._run_eager(scope, feeds)
        else:
            cur = torch.cuda.current_stream(self.device)
            # the side stream waits for the current one: for the feeds,
            # and for the last run's fetches to be read before a replay
            # overwrites them
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                fetched, health = self._run_on_stream(scope, feeds)
                if not return_numpy:
                    # a later replay overwrites graph outputs and updates
                    # the state in place
                    fetched = [t.clone() for t in fetched]
                if health is not None:
                    health = health.clone()
            cur.wait_stream(self._stream)
            for t in fetched + ([] if health is None else [health]):
                t.record_stream(cur)
        self.last_health = health
        return self._fetched(fetched, return_numpy)

    def run_window(self, scope: Scope, feeds: Dict[str, torch.Tensor],
                   window_names: Sequence[str], n_steps: int,
                   return_numpy: bool = True):
        """``n_steps`` steps as one window (reference executor.py:979):
        the feeds named in ``window_names`` are [n_steps, ...] stacks of
        distinct batches, slice i feeding step i; the others feed every
        step. The stacks go to the device once; on the GPU each step is a
        run of the one-step plan as ``run`` makes it (after a key's warm-up
        and capture, a graph replay, its feed buffers filled from the
        slices on the device), whose fetches are copied into row i of
        stacked device buffers; the host reads them once, at the end.
        Returns the fetches stacked [n_steps, ...]; each step's health
        (each step selects against its own pre-step state, so a bad step
        is discarded alone) goes to ``last_health`` as [n_steps]."""
        self._check_no_lod_fetch()
        feeds = {n: t.to(self.device) for n, t in feeds.items()}
        stacked: List[torch.Tensor] = []
        healths = (torch.empty(n_steps, dtype=torch.bool, device=self.device)
                   if self._guard_active else None)

        def step(i):
            f = {n: t[i] if n in window_names else t
                 for n, t in feeds.items()}
            fetched, health = (self._run_eager(scope, f)
                               if self._stream is None
                               else self._run_on_stream(scope, f))
            self._check_no_lod_fetch()  # the LoDs of a plan's first run
            if not stacked:
                stacked.extend(torch.empty((n_steps,) + tuple(t.shape),
                                           dtype=t.dtype, device=t.device)
                               for t in fetched)
            for buf, t in zip(stacked, fetched):
                buf[i].copy_(t)
            if healths is not None:
                healths[i].copy_(health)

        if self._stream is None:
            for i in range(n_steps):
                step(i)
        else:
            cur = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                for i in range(n_steps):
                    step(i)
            cur.wait_stream(self._stream)
            for t in stacked + ([] if healths is None else [healths]):
                t.record_stream(cur)
        self.last_health = healths
        if return_numpy:
            return [LoDTensor(t).numpy() for t in stacked]
        return [LoDTensor(t) for t in stacked]

    def _run_on_stream(self, scope, feeds):
        """One step on the executor's stream, which the caller entered: a
        key's first run is the eager warm-up, its second the capture, and
        every later one a replay."""
        if self._graph is None and not self.stats["eager"]:
            return self._run_eager(scope, feeds)
        return self._run_graph(scope, feeds)

    def _run_eager(self, scope, feeds):
        dev_feeds = {n: t.to(self.device) for n, t in feeds.items()}
        for n, t in dev_feeds.items():
            scope.var(n).set_value(self._wrap(n, t))
        fetches, new, health = self._step(dev_feeds, self._read_state(scope),
                                          _step_counter(scope, self.device))
        for n, v in new.items():
            scope.var(n).set_value(self._wrap(n, v))
        self.stats["eager"] += 1
        self.last_exec = "eager"
        return fetches, health

    def _run_graph(self, scope, feeds):
        if self._graph is not None and not self._refresh_state(scope):
            self._drop_graph()  # a state var changed shape, dtype or device
        if self._graph is None:
            self._capture(scope, feeds)
            self.last_exec = "capture"
        else:
            for n, buf in self._static_feeds.items():
                buf.copy_(feeds[n])
            self.last_exec = "replay"
        self._graph.replay()
        self.stats["replays"] += 1
        return self._static_fetch, self._static_health

    def _capture(self, scope, feeds):
        """Record the plan into a CUDA graph on the executor's stream and
        pool. The graph reads the scope's state tensors and the static
        feed buffers in place, and ends by copying the new state into the
        scope's tensors. A capture that fails raises."""
        self._static_feeds = {
            n: torch.empty(t.shape, dtype=t.dtype, device=self.device)
            for n, t in feeds.items()}
        for n, buf in self._static_feeds.items():
            buf.copy_(feeds[n])
            scope.var(n).set_value(self._wrap(n, buf))
        state = self._read_state(scope)
        counter = _step_counter(scope, self.device)
        targets = dict(state)
        for n in self.extra_writeback:
            t = _scope_tensor(scope, n)
            if t is not None:
                targets[n] = t
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode=_CAPTURE_MODE):
            fetches, new, health = self._step(self._static_feeds, state,
                                              counter)
            # the guard's select reads the pre-step state: every select
            # is recorded before the first copy into the state
            for n, v in new.items():
                t = targets.get(n)
                if t is not None and v is not t:
                    t.copy_(v)
            del new
        self.stats["capture_s"] += time.perf_counter() - t0
        self.stats["captures"] += 1
        after = _launch_counts()
        self.graph_launches = {k: after[k] - before[k] for k in after}
        self._graph = graph
        self._static_fetch = fetches
        self._static_health = health
        self._captured = dict(state)
        self._captured[_RNG_COUNTER] = counter
        self._extra_targets = {n: targets[n] for n in self.extra_writeback
                               if n in targets}

    def _refresh_state(self, scope) -> bool:
        """Before a replay: each state var the graph reads must still be
        the tensor it captured. A replaced one of the same shape, dtype
        and device is copied in, and the scope holds the captured tensor
        again; any other change needs a new capture (False). Never
        replays over stale storage."""
        for n, t in self._captured.items():
            v = scope.find_var(n)
            cur = _scope_tensor(scope, n)
            if cur is t:
                continue
            if cur is None:
                raise RuntimeError(f"state variable '{n}' is no longer "
                                   "initialized in the scope")
            if cur.shape != t.shape or cur.dtype != t.dtype \
                    or cur.device != t.device:
                return False
            t.copy_(cur)
            v.set_value(self._wrap(n, t))
        for n, t in self._extra_targets.items():
            if _scope_tensor(scope, n) is not t:
                scope.var(n).set_value(self._wrap(n, t))
        return True

    def _drop_graph(self):
        self._graph = None
        self._static_fetch, self._static_feeds = [], {}
        self._static_health = None
        self._captured, self._extra_targets = {}, {}


# --------------------------------------------------------------------------
# the segmented step (reference executor.py:1104-1466)
# --------------------------------------------------------------------------
class _NotSegmentable(Exception):
    """Raised when a block has too few compilable ops to gain from
    segments (``FLAGS_executor_seg_min_ops``): it runs interpreted."""


def _sub_block_ops(op):
    """The ops of ``op``'s sub-blocks, nested ones included."""
    stack = [op.attrs.get("sub_block")]
    while stack:
        b = stack.pop()
        if b is None:
            continue
        for sop in b.ops:
            yield sop
            stack.append(sop.attrs.get("sub_block"))


def _effective_reads(op) -> List[str]:
    """Names an op may read, through its sub-blocks too (an island's
    control flow runs its sub-block's ops over the scope)."""
    names = list(op.input_arg_names)
    for sop in _sub_block_ops(op):
        names.extend(sop.input_arg_names)
    return names


def _effective_writes(op) -> List[str]:
    names = list(op.output_arg_names)
    for sop in _sub_block_ops(op):
        names.extend(sop.output_arg_names)
    return names


class _SegmentedBlock(_CompiledBlock):
    """One planned step of a block that holds stateful or host-reading
    ops: its maximal compiled segments (each a list of bound ops, one
    CUDA graph on the GPU) around the islands, which the interpreter runs
    op by op over the scope (the module docstring has the GPU schedule).

    A step threads one ``env`` (name → tensor) through the segments in
    program order: a compiled segment reads its ``in_names`` from it and
    adds the ``out_names`` that a later segment, an island, the fetches or
    the write-back need; an island gets the env values its ops read put
    into the scope and its writes pulled back. Random keys come from the
    ops' indices in the block, the step counter advances once a step,
    after the last segment, so the segments draw what the whole compiled
    step would.

    State that a compiled segment writes lands in the scope's tensors: in
    place at the end of its graph on the GPU. Under the numeric fault
    guard the new state stays in the env until the step's epilogue: the
    health is each compiled segment's flag over its float outputs, each
    island's over the float values it wrote, and the fetches', ANDed on
    the device; the select puts a tripped step's state back across the
    islands, the AMP scale update follows, as in ``_CompiledBlock``. On
    the GPU the epilogue runs eagerly after the last segment.

    ``stats`` counts eager runs, graph captures, graph replays (a
    capture's own included) and island dispatches; ``graph_launches``
    holds each kernel's launches over the step's graphs."""

    kind = "segmented"

    def __init__(self, program: Program, feed_names, fetch_names,
                 scope: Scope, seed: int, device, stream=None, pool=None,
                 feed_lods=None):
        from .ir import analyze_block_segments
        self.segments = _split_loops(analyze_block_segments(
            program.global_block().ops))
        # a compiled loop's body counts: it runs as a plan of its own
        n_compiled = sum(
            len(s.ops) if s.kind == "compiled"
            else len(s.ops[0].attrs["sub_block"].ops) if s.kind == "loop"
            else 0 for s in self.segments)
        if n_compiled < int(core.globals_["FLAGS_executor_seg_min_ops"]):
            raise _NotSegmentable(f"only {n_compiled} compilable ops (< "
                                  "FLAGS_executor_seg_min_ops)")
        self._init_common(program, feed_names, fetch_names, scope, seed,
                          device, stream, pool, feed_lods)
        self.stats["islands"] = 0
        # compiled loops: iterations run, body replays and captures, and
        # the last run's iterations by segment start
        self.loop_stats = {"iterations": 0, "body_replays": 0,
                           "body_captures": 0}
        self._fell_back = False
        self.last_iterations: Dict[int, int] = {}
        self._plan_segments()
        # the graphs, by (segment start, its inputs' LoD): (graph, static
        # inputs, outputs, health flag); the state tensors they read and
        # write; the keys a graph derived, alive for the later graphs that
        # read them
        self._rt: Dict[tuple, tuple] = {}
        self._targets: Dict[str, torch.Tensor] = {}
        self._held_keys: List[torch.Tensor] = []

    def _plan_segments(self):
        """Each segment's dataflow: the names it reads from outside
        itself, the names it writes that someone later needs (a later
        segment or island, the fetches, the state write-back), and for a
        compiled one its ops bound with global indices and liveness."""
        reads_of, writes_of = [], []
        for seg in self.segments:
            reads: List[str] = []
            written: set = set()
            op_io = []
            for op in seg.ops:
                r, w = _effective_reads(op), _effective_writes(op)
                op_io.append((op, r, w))
                reads.extend(n for n in r if n not in written
                             and n not in reads and n != _EMPTY)
                written.update(w)
            written.discard(_EMPTY)
            reads_of.append(reads)
            writes_of.append(written)
            seg.op_io = tuple(op_io) if seg.kind == "island" else ()
        state_out = set(self.mut_state) | set(self.extra_writeback)
        need_at_end = set(self.fetch_names) | state_out
        for i, seg in enumerate(self.segments):
            later: set = set()
            for r in reads_of[i + 1:]:
                later.update(r)
            seg.in_names = tuple(reads_of[i])
            seg.out_names = tuple(sorted(
                n for n in writes_of[i] if n in later or n in need_at_end))
            seg.state_writes = tuple(n for n in seg.out_names
                                     if n in state_out)
            seg.guard_names = ()
            seg.loop = None
            seg.plans = {}  # a compiled one's: its inputs' LoD → _SegPlan
            if seg.kind == "loop":
                seg.loop = self._plan_loop(seg.ops[0])

    def _seg_plan(self, seg, lod_env) -> "_SegPlan":
        """A compiled segment's ops bound for the LoD its inputs carry in
        this run (the TPU package's per-segment LoD key,
        executor.py:1280-1336), made at the first run that meets it."""
        lkey = tuple((n, lod_env[n]) for n in seg.in_names
                     if lod_env.get(n))
        plan = seg.plans.get(lkey)
        if plan is None:
            lods = _Lods(dict(lkey))
            steps = [self._bind(op, seg.start + j, lods=lods)
                     for j, op in enumerate(seg.ops)]
            set_liveness(steps, set(seg.out_names))
            plan = seg.plans[lkey] = _SegPlan(tuple(steps), lods,
                                              (seg.start, lkey))
        return plan

    def _plan_loop(self, op) -> "_LoopPlan":
        """A compiled ``while``: its body bound as a plan of its own, keyed
        by the body's block and the loop's iteration tensor."""
        body = op.attrs["sub_block"]
        it = torch.zeros(1, dtype=torch.int64, device=self.device)
        keys = _SubKeys(self._keys, body, self.device, (it,))
        units = [self._bind(sop, j, keys) for j, sop in enumerate(body.ops)]
        reads: List[str] = []
        written: set = set()
        for u in units:
            reads.extend(n for n in u.reads if n not in written
                         and n not in reads and n != _EMPTY)
            written.update(u.writes)
        cond = op.input("Condition")[0]
        outs = set(op.output("Out")) | {cond}
        set_liveness(units, outs | set(reads))
        return _LoopPlan(cond, units, keys, it,
                         carried=tuple(n for n in reads if n in written),
                         readonly=tuple(n for n in reads
                                        if n not in written),
                         outs=tuple(sorted(n for n in outs
                                           if n in written)))

    # ---------------------------------------------------------- segments
    def _seg_compute(self, seg, plan, env):
        """A compiled segment's ops (``plan``'s) over its inputs in ``env``
        → (its outputs, its health flag under the guard or None). The
        plan's first run records its outputs' LoDs."""
        local = {n: env[n] for n in seg.in_names if n in env}
        exec_units(plan.units, local)
        if not plan.lods.frozen:
            plan.lods.frozen = True
            plan.out_lods = {n: plan.lods.env.get(n) for n in seg.out_names}
        outs = {n: local[n] for n in seg.out_names if n in local}
        if not self._guard_active:
            return outs, None
        from .ir import fused_health
        if not seg.guard_names:
            seg.guard_names = tuple(n for n, v in outs.items()
                                    if v.is_floating_point())
        return outs, fused_health(list(outs.values()), self.device)

    def _capture_segment(self, seg, plan, env, stable, rt):
        """Capture a compiled segment into a CUDA graph on the executor's
        stream and pool, then replay it (a capture does not execute). An
        input that is not ``stable`` (a feed, an island's output) gets a
        static buffer; the others (state, earlier graphs' outputs) are
        read where they are. Unguarded, the state it writes is copied
        into the scope's tensors at the graph's end."""
        inputs, static_in = {}, {}
        for n in seg.in_names:
            if n not in env:
                continue
            if n in stable:
                inputs[n] = env[n]
            else:
                static_in[n] = inputs[n] = env[n].clone()
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        in_place = []
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode=_CAPTURE_MODE):
            outs, flag = self._seg_compute(seg, plan, inputs)
            if not self._guard_active:
                for n in seg.state_writes:
                    t, v = self._targets.get(n), outs.get(n)
                    if t is None or v is None or v is t:
                        continue
                    if v.shape == t.shape and v.dtype == t.dtype:
                        t.copy_(v)
                        in_place.append(n)
        self.stats["capture_s"] += time.perf_counter() - t0
        self.stats["captures"] += 1
        after = _launch_counts()
        for k in after:
            self.graph_launches[k] = (self.graph_launches.get(k, 0)
                                      + after[k] - before[k])
        for n in in_place:
            outs[n] = self._targets[n]
        if self._keys.keys is not None:
            self._held_keys.append(self._keys.keys)
        rt[plan.key] = (graph, static_in, outs, flag)
        graph.replay()
        self.stats["replays"] += 1
        return outs, flag

    def _replay_segment(self, plan, env):
        graph, static_in, outs, flag = self._rt[plan.key]
        for n, buf in static_in.items():
            buf.copy_(env[n])
        graph.replay()
        self.stats["replays"] += 1
        return outs, flag

    def _island(self, seg, env, lod_env, scope) -> List[str]:
        """An island op by op through the interpreter: the env values each
        op reads go into the scope (no copy) with their LoD, its writes
        come back into the env and their LoD into ``lod_env``. → the names
        written."""
        written: List[str] = []
        for off, (op, reads, writes) in enumerate(seg.op_io):
            for n in reads:
                if n in env:
                    scope.var(n).set_value(LoDTensor(env[n], lod_env.get(n)))
            names = _interpret_op(op, seg.start + off, scope, self._keys,
                                  self.device)
            if op.attrs.get("sub_block") is not None:
                # control flow writes through its sub-block, over the
                # scope: what now differs from the env came from it
                names = [n for n in dict.fromkeys(writes)
                         if _scope_tensor(scope, n) is not None
                         and _scope_tensor(scope, n) is not env.get(n)]
            for n in names:
                env[n] = _scope_tensor(scope, n)
                lv = _tensor_lod(scope.find_var(n).value())
                if lv:
                    lod_env[n] = lv
                written.append(n)
        self.stats["islands"] += 1
        return written

    # ------------------------------------------------------------- loops
    def _run_loop(self, seg, env, mode):
        """A compiled ``while`` (the TPU package's ``lax.while_loop``,
        executor.py:730-767): the condition is read on the host before
        each iteration. Eager (the CPU, the GPU's warm-up), the body's
        plan runs over a local env; on the GPU its first iteration is
        captured into a CUDA graph of its own and every iteration replays
        it (``_LoopPlan``). → (the loop's outputs, the health flag under
        the guard or None)."""
        lp = seg.loop
        if mode == "eager":
            outs, n = self._loop_eager(seg, lp, env)
        else:
            outs, n = self._loop_graph(seg, lp, env)
        self.last_iterations[seg.start] = n
        self.loop_stats["iterations"] += n
        if not self._guard_active:
            return outs, None
        from .ir import fused_health
        return outs, fused_health(list(outs.values()), self.device)

    def _loop_eager(self, seg, lp, env):
        local = {n: env[n] for n in seg.in_names if n in env}
        lp.it.zero_()
        n = 0
        while host_bool(local[lp.cond]):
            lp.keys.reset()
            exec_units(lp.units, local)
            lp.it.add_(1)
            n += 1
            if n > _MAX_LOOP_ITERS:
                raise RuntimeError("while op exceeded max iterations")
        return {k: local[k] for k in seg.out_names if k in local}, n

    def _loop_graph(self, seg, lp, env):
        if lp.graph is not None and any(
                env.get(k) is not t for k, t in lp.inplace.items()):
            lp.drop()  # a state var it reads in place was replaced
        if lp.bufs is None:
            # the carried values, and the inputs that are not the scope's
            # state, get static buffers: copied in before the loop
            lp.inplace = {k: env[k] for k in lp.readonly
                          if env[k] is self._targets.get(k)}
            lp.bufs = {k: torch.empty_like(env[k])
                       for k in lp.carried + lp.readonly
                       if k not in lp.inplace}
        for k, b in lp.bufs.items():
            if env[k] is not b:
                b.copy_(env[k])
        lp.it.zero_()
        cond = env[lp.cond]
        n = 0
        while host_bool(cond):
            if lp.graph is None:
                self._capture_body(lp)
            lp.graph.replay()
            self.loop_stats["body_replays"] += 1
            n += 1
            if n > _MAX_LOOP_ITERS:
                raise RuntimeError("while op exceeded max iterations")
            cond = lp.current(lp.cond)
        if not n:
            return {k: env[k] for k in seg.out_names if k in env}, 0
        return {k: lp.current(k) for k in seg.out_names
                if lp.current(k) is not None}, n

    def _capture_body(self, lp):
        """Record one iteration of the body into a CUDA graph on the
        executor's stream and pool (a capture does not execute: the
        caller replays it). It reads the static buffers and the state in
        place and ends by copying the new carried values into their
        buffers and adding one to the iteration tensor."""
        local = dict(lp.inplace)
        local.update(lp.bufs)
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                              capture_error_mode=_CAPTURE_MODE):
            lp.gouts = self._body_pass(lp, local)
        self.stats["capture_s"] += time.perf_counter() - t0
        self.loop_stats["body_captures"] += 1
        after = _launch_counts()
        lp.launches = {k: after[k] - before[k] for k in after}
        lp.graph = graph

    @staticmethod
    def _body_pass(lp, local):
        """One iteration of the body over ``local`` (what a capture
        records) → the values of the loop's outputs that are not carried
        in a buffer."""
        lp.keys.reset()
        exec_units(lp.units, local)
        for k in lp.carried:
            v, b = local[k], lp.bufs[k]
            if v is b:
                continue
            if v.shape != b.shape or v.dtype != b.dtype:
                raise NotImplementedError(
                    f"while body changes the shape or dtype of loop-carried "
                    f"var '{k}' ({tuple(b.shape)} {b.dtype} -> "
                    f"{tuple(v.shape)} {v.dtype}): a compiled loop needs "
                    "fixed shapes")
            b.copy_(v)
        lp.it.add_(1)
        return {k: local[k] for k in lp.outs
                if k in local and k not in lp.carried}

    # -------------------------------------------------------------- step
    def _seg_step(self, scope, feeds, mode):
        """One step through the segments: ``mode`` "eager" (the CPU, and
        the GPU's warm-up), "capture" or "replay" → (fetches, health or
        None). A compiled segment whose inputs carry a LoD that no graph
        of this block was captured for (an island wrote it, from values)
        runs eagerly, and so does every compiled segment after it in the
        step; the block's graphs are then dropped and the next run
        captures anew (``_fell_back``)."""
        from .ir import fused_health
        dev_feeds = {n: t.to(self.device) for n, t in feeds.items()}
        counter = _step_counter(scope, self.device)
        if mode == "replay":
            state = {n: self._targets[n]
                     for n in self.mut_state + self.ro_state}
        else:
            state = self._read_state(scope)
        rt: Dict[tuple, tuple] = {} if mode == "capture" else self._rt
        lod_env: Dict[str, tuple] = dict(self._init_lods)
        fell_back = False
        if mode == "capture":
            self._targets = dict(state)
            for n in self.extra_writeback:
                t = _scope_tensor(scope, n)
                if t is not None:
                    self._targets[n] = t
            self.graph_launches, self._held_keys = {}, []
        env = dict(state)
        env.update(dev_feeds)
        orig = ({n: env[n] for n in self._select_names if n in env}
                if self._guard_active else None)
        stable = set(state)
        flags: List[torch.Tensor] = []
        self._keys.begin(counter)
        try:
            for seg in self.segments:
                if seg.kind == "island":
                    had_keys = self._keys.keys is not None
                    written = self._island(seg, env, lod_env, scope)
                    if mode == "capture":
                        stable.difference_update(written)
                        if not had_keys:
                            # keys drawn eagerly here: a later graph
                            # derives its own
                            self._keys.keys = None
                    flag = (fused_health([env[n] for n in written],
                                         self.device)
                            if self._guard_active else None)
                elif seg.kind == "loop":
                    outs, flag = self._run_loop(seg, env, mode)
                    env.update(outs)
                    if mode == "capture":
                        # a loop's outputs are its buffers only when it
                        # iterated: later graphs copy them in
                        stable.difference_update(outs)
                else:
                    plan = self._seg_plan(seg, lod_env)
                    fell_back = fell_back or (
                        mode == "capture" and not plan.ran) or (
                        mode == "replay" and plan.key not in rt)
                    if mode == "eager" or fell_back:
                        outs, flag = self._seg_compute(seg, plan, env)
                        plan.ran = True
                    elif mode == "capture":
                        outs, flag = self._capture_segment(seg, plan, env,
                                                           stable, rt)
                        stable.update(outs)
                    else:
                        outs, flag = self._replay_segment(plan, env)
                    env.update(outs)
                    lod_env.update((n, lv) for n, lv in plan.out_lods.items()
                                   if lv)
                if flag is not None:
                    flags.append(flag)
        except BaseException:
            if orig is not None:
                # a guarded step promises its pre-step state on any failure
                for n, t in orig.items():
                    scope.var(n).set_value(self._wrap(n, t))
            raise
        finally:
            self._keys.end()
        counter.add_(1)
        if mode == "capture":
            self._rt = rt
            self._captured = dict(self._targets)
            self._captured[_RNG_COUNTER] = counter
        fetches = [env[n] for n in self.fetch_names]
        self.fetch_lods = [lod_env.get(n) for n in self.fetch_names]
        health = None
        if self._guard_active:
            health = torch.stack([fused_health(fetches, self.device)]
                                 + flags).all()
        new = {n: env[n] for n in self.mut_state + self.extra_writeback
               if n in env}
        if self._guard_active:
            self._apply_discard(new, orig, health)
        self.out_lods = {n: lod_env.get(n) for n in new}
        for n, v in new.items():
            t = self._targets.get(n) if mode != "eager" else None
            if t is not None and v is not t and v.shape == t.shape \
                    and v.dtype == t.dtype:
                t.copy_(v)
                v = t
            if _scope_tensor(scope, n) is not v or self.out_lods[n]:
                scope.var(n).set_value(self._wrap(n, v))
        self._fell_back = fell_back and mode != "eager"
        if self._fell_back:
            self._drop_graph()
        return fetches, health

    def _run_on_stream(self, scope, feeds):
        if not self._rt and not self.stats["eager"]:
            return self._run_eager(scope, feeds)
        return self._run_graph(scope, feeds)

    def _run_eager(self, scope, feeds):
        fetched, health = self._seg_step(scope, feeds, "eager")
        self.stats["eager"] += 1
        self.last_exec = "eager"
        return fetched, health

    def _run_graph(self, scope, feeds):
        if self._rt and not self._refresh_state(scope):
            self._drop_graph()  # a state var changed shape, dtype or device
        mode = "replay" if self._rt else "capture"
        fetched, health = self._seg_step(scope, feeds, mode)
        if self._fell_back:
            mode = "eager"
            self.stats["eager"] += 1
        self.last_exec = mode
        return fetched, health

    def _drop_graph(self):
        self._rt, self._held_keys = {}, []
        self._targets, self._captured, self._extra_targets = {}, {}, {}
        for seg in self.segments:
            if seg.loop is not None:
                seg.loop.drop()


_MAX_LOOP_ITERS = 10_000_000


class _SegPlan:
    """A compiled segment's ops bound for one LoD of its inputs: ``units``,
    their ``lods`` (``_Lods``), ``key`` (segment start,
    the LoD), ``ran`` (an eager run made its LoD constants, so it may be
    captured) and ``out_lods``, its outputs' LoDs after its first run."""

    __slots__ = ("units", "lods", "key", "ran", "out_lods")

    def __init__(self, units, lods, key):
        self.units, self.lods, self.key = units, lods, key
        self.ran = False
        self.out_lods: Dict[str, Optional[tuple]] = {}


class _LoopPlan:
    """A compiled ``while`` of a segmented block: ``cond`` (the condition
    var), the body's bound ``units`` with their ``keys``, ``it`` (the
    iteration, an int64 [1] tensor the random keys fold in), ``carried``
    (names the body reads and writes: the next iteration reads the new
    value), ``readonly`` (names it only reads) and ``outs`` (the outer
    names it writes). On the GPU: ``graph``, one iteration captured;
    ``bufs``, the static buffers of the carried values and of the inputs
    that are not state; ``inplace``, the state it reads where it lies;
    ``gouts``, the graph's values of the outputs without a buffer;
    ``launches``, each kernel's launches in one iteration."""

    __slots__ = ("cond", "units", "keys", "it", "carried", "readonly",
                 "outs", "graph", "bufs", "inplace", "gouts", "launches")

    def __init__(self, cond, units, keys, it, carried, readonly, outs):
        self.cond, self.units, self.keys, self.it = cond, units, keys, it
        self.carried, self.readonly, self.outs = carried, readonly, outs
        self.launches: Dict[str, int] = {}
        self.drop()

    def drop(self):
        self.graph = self.bufs = None
        self.inplace: Dict[str, torch.Tensor] = {}
        self.gouts: Dict[str, torch.Tensor] = {}

    def current(self, name) -> Optional[torch.Tensor]:
        """``name``'s value after the last replay."""
        if name in self.carried:
            return self.bufs[name]
        return self.gouts.get(name)


def _split_loops(segments):
    """Each ``while`` of an island whose body compiles
    (``_compiled_loop``) becomes a segment of its own, kind "loop"; the
    rest of the island stays islands, in order."""
    from .ir import BlockSegment
    out = []
    for seg in segments:
        if seg.kind != "island" or not any(_compiled_loop(op)
                                           for op in seg.ops):
            out.append(seg)
            continue
        cur = None
        for j, (op, reason) in enumerate(zip(seg.ops, seg.island_reasons)):
            kind = "loop" if _compiled_loop(op) else "island"
            if kind == "loop" or cur is None or cur.kind != "island":
                cur = BlockSegment(kind, seg.start + j)
                out.append(cur)
            cur.ops.append(op)
            cur.island_reasons.append(reason)
    return out


# --------------------------------------------------------------------------
class HealthMonitor:
    """The rollback policy of the numeric fault plane
    (``FLAGS_nan_inf_action=rollback``; the TPU package's
    executor.py:1468-1561). It takes each step's health verdict; after
    ``tolerance`` tripped steps in a row it restores the newest intact
    checkpoint under ``ckpt_dir`` (parameters, optimizer slots, the step
    counter and, given a ``dataloader``, its position: the replay of the
    faulted steps matches a run that never saw the fault, bit for bit).
    At most ``max_rollbacks`` restores; the trip past them, or one with
    no intact checkpoint, raises ``core.NumericFaultError``. Until the
    tolerance is reached the guard's select discards each tripped step,
    so the state never holds a NaN between verdicts."""

    def __init__(self, executor, ckpt_dir, program=None, scope=None,
                 tolerance: Optional[int] = None,
                 max_rollbacks: Optional[int] = None, dataloader=None,
                 on_rollback=None):
        self.executor = executor
        self.ckpt_dir = ckpt_dir
        self.program = program
        self.scope = scope
        self.dataloader = dataloader
        self.on_rollback = on_rollback
        self.tolerance = max(1, int(
            core.globals_["FLAGS_nan_inf_tolerance"]
            if tolerance is None else tolerance))
        self.max_rollbacks = int(
            core.globals_["FLAGS_nan_inf_max_rollbacks"]
            if max_rollbacks is None else max_rollbacks)
        self.trips = 0
        self.consecutive_bad = 0
        self.rollbacks = 0
        self.last_trip_step: Optional[int] = None
        self.last_rollback_step: Optional[int] = None
        self.last_manifest: Optional[Dict[str, Any]] = None

    def observe(self, healthy: bool, step: int) -> str:
        """One step's verdict. → "ok" | "tripped" | "rolled_back"; raises
        ``core.NumericFaultError`` when the rollback budget is spent."""
        if healthy:
            self.consecutive_bad = 0
            return "ok"
        self.trips += 1
        self.consecutive_bad += 1
        self.last_trip_step = int(step)
        if self.consecutive_bad < self.tolerance:
            return "tripped"
        return self._rollback(step)

    def _rollback(self, step: int) -> str:
        from . import io as _io
        if self.rollbacks >= self.max_rollbacks:
            raise core.NumericFaultError(
                f"numeric fault at step {step}: "
                f"{self.consecutive_bad} consecutive non-finite steps "
                f"and the rollback budget "
                f"(FLAGS_nan_inf_max_rollbacks={self.max_rollbacks}) is "
                f"spent — the fault is persistent, not transient")
        scope = self.scope if self.scope is not None else global_scope()
        manifest = _io.rollback_to_latest(self.executor, self.ckpt_dir,
                                          main_program=self.program,
                                          scope=scope)
        if manifest is None:
            raise core.NumericFaultError(
                f"numeric fault at step {step}: "
                f"FLAGS_nan_inf_action=rollback but no intact checkpoint "
                f"under {self.ckpt_dir!r} to roll back to")
        if self.dataloader is not None and manifest.get("dataloader"):
            self.dataloader.load_state_dict(manifest["dataloader"])
        self.rollbacks += 1
        self.consecutive_bad = 0
        self.last_rollback_step = int(step)
        self.last_manifest = manifest
        cfg = self.executor._auto_ckpt
        if cfg is not None:
            cfg["last_step"] = int(manifest["global_step"])
        if self.on_rollback is not None:
            self.on_rollback(manifest)
        return "rolled_back"


# --------------------------------------------------------------------------
class Executor:
    """fluid.Executor (reference executor.py:457) on one device.

    ``place`` defaults to ``CUDAPlace(0)``. On a host without CUDA that
    raises: the CPU is used only when the caller passes ``CPUPlace()``.
    ``_last_run_mode`` says how the last run executed ("compiled",
    "segmented" or "interpreted"), ``_last_block`` which
    ``_CompiledBlock`` (or ``_SegmentedBlock``) ran it,
    ``_last_health`` the last guarded run's health on the device (a bool
    scalar, or [n_steps] for a compiled window).

    ``_rng_counters`` (shared by every executor, as in the reference)
    holds each scope's step count on the host: the startup run counts
    one, a run of ``n_steps`` counts ``n_steps``. It equals the scope's
    counter on the device, which each step advances, without reading
    it."""

    _rng_counters = weakref.WeakKeyDictionary()  # scope -> its steps
    _LOD_PLANS_KEPT = 4  # feed-LoD plans that never captured, kept cached

    def __init__(self, place: Optional[Place] = None):
        self.place = CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        if self.device.type == "cuda":
            # f32 mul/matmul run in full f32, as in the TPU package: no
            # TF32 rounding of the operands
            torch.backends.cuda.matmul.allow_tf32 = False
        self._compiled_cache: Dict[tuple, _CompiledBlock] = {}
        # the cache keys that hold a feed LoD, oldest first
        self._lod_plan_keys: Dict[tuple, None] = {}
        # keys of blocks too small to segment → their scope (a weakref)
        self._unsegmentable: Dict[tuple, weakref.ref] = {}
        # program → (its _version, whether its global block compiles)
        self._compilable = weakref.WeakKeyDictionary()
        self._last_run_mode: Optional[str] = None
        self._last_block: Optional[_CompiledBlock] = None
        self._last_health: Optional[torch.Tensor] = None
        # one side stream for every warm-up, capture and replay, and one
        # memory pool shared by this executor's graphs: they replay one
        # at a time, and each run copies its fetches out
        self._stream = None
        self._pool = None
        # FLAGS_feed_device_cache: name → (identity, CRC32, the ndarray,
        # its device tensor, [misses in a row]) or "uncacheable"
        self._feed_cache: Dict[str, object] = {}
        self.feed_stats = {"uploads": 0, "cache_hits": 0}
        # periodic atomic checkpoints (set_auto_checkpoint, resume_from)
        self._auto_ckpt: Optional[Dict[str, Any]] = None
        # the guard's host counters (advanced only where the verdicts are
        # read: raise, rollback and the interpreter) and the rollback
        # policy
        self._health_stats = {"steps_checked": 0, "trips": 0}
        self._health_monitor: Optional[HealthMonitor] = None
        # a step of this run tripped (raise or rollback): no checkpoint is
        # taken from inside a fault window, whose counter would name the
        # discarded step and break the replay's bit-exactness
        self._last_step_tripped = False

    def close(self):
        """Drop the compiled blocks with their CUDA graphs, the graphs'
        memory pool and the cached feeds: once nothing else holds them,
        ``torch.cuda.empty_cache()`` can return their memory."""
        self._compiled_cache.clear()
        self._lod_plan_keys.clear()
        self._unsegmentable.clear()
        self._last_block = None
        self._feed_cache.clear()
        self._stream = self._pool = None

    def graph_stats(self) -> Dict[str, float]:
        """Eager runs, captures, replays, capture seconds and (segmented
        blocks) island dispatches summed over the cached blocks."""
        tot = {"blocks": len(self._compiled_cache), "eager": 0,
               "captures": 0, "replays": 0, "islands": 0, "capture_s": 0.0}
        for cb in self._compiled_cache.values():
            for k, v in cb.stats.items():
                tot[k] += v
        return tot

    # ------------------------------------------------------------------
    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, feed_var_name="feed", fetch_var_name="fetch",
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_program_cache: bool = False, use_prune: bool = False,
            n_steps: int = 1):
        """Run ``program``'s global block. ``feed``: name → array;
        ``fetch_list``: Variables or names. Returns numpy arrays, or
        LoDTensors on the executor's device when ``return_numpy`` is
        False. ``feed_var_name``, ``fetch_var_name`` and
        ``use_program_cache`` are accepted for the reference signature and
        change nothing here: compiled blocks are always cached. The block's
        ``feed`` and ``fetch`` ops, which a saved inference program
        carries, do not run: feeds and fetches go by name (the TPU
        package's compiled path drops them too).

        ``use_prune`` runs the backward slice of the block to the fetches
        (``Program._prune``; the TPU package's executor.py:2070-2083),
        made once for each (program version, fetch list) and kept on the
        program. Pruning a training program to its loss drops the
        optimizer ops, as in the reference.

        ``n_steps`` > 1 runs that many steps as one window (the module
        docstring): windowed feeds ([n_steps, ...] stacks) give one slice
        to each step, the others feed every step; the compiled path and
        windowed feeds return every fetch stacked [n_steps, ...], the
        segmented path and the interpreter with the same feeds the final
        step's fetches. A feed
        with an int attribute ``k`` (the TPU package's WindowBatch) is k
        stacked batches: it sets ``n_steps``, or raises if ``n_steps``
        says otherwise; a window the DataLoader uploaded on its own stream
        (its ``ready`` event) is waited for on the current stream first.

        A run ends with the periodic checkpoint of ``set_auto_checkpoint``
        when the scope's steps crossed a boundary.

        A ``CompiledProgram`` runs through its ``_run`` (the TPU
        package's executor.py:2059), which applies its BuildStrategy's
        passes and calls back here with its program."""
        program = default_main_program() if program is None else program
        if isinstance(program, CompiledProgram):
            return program._run(self, feed, fetch_list, scope, return_numpy,
                                n_steps=n_steps)
        scope = global_scope() if scope is None else scope
        feed = {} if feed is None else feed
        fetch_names = _to_fetch_names(fetch_list)
        user_program = program
        self._host_steps(scope)
        self._last_step_tripped = False
        ready = getattr(feed, "ready", None)
        if ready is not None and self.device.type == "cuda":
            self._await_upload(feed, ready)
        if use_prune and fetch_names:
            pkey = (program._version, tuple(fetch_names))
            cache = program.__dict__.setdefault("_prune_cache", {})
            pruned = cache.get(pkey)
            if pruned is None:
                pruned = cache[pkey] = program._prune(list(fetch_names))
            program = pruned
        program = _without_feed_fetch(program)
        seed = int(program.random_seed or core.globals_["FLAGS_seed"])
        mode = core.globals_["FLAGS_executor_mode"]
        if mode not in _MODES:
            raise ValueError(f"FLAGS_executor_mode={mode!r}: expected one "
                             f"of {_MODES}")
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError(f"n_steps={n_steps}: expected >= 1")
        window_names: Tuple[str, ...] = ()
        wk = getattr(feed, "k", None)
        if isinstance(wk, int) and not isinstance(wk, bool) and wk > 0:
            if n_steps == 1:
                n_steps = wk
            elif n_steps != wk:
                raise ValueError(f"feed is a window of {wk} stacked batches "
                                 f"but n_steps={n_steps} was requested")
            window_names = tuple(feed)
        elif feed and n_steps > 1:
            window_names = _window_feed_names(program, feed, n_steps)
        compiled = mode == "compiled" and self._is_compilable(program)
        segmented = mode == "compiled" and not compiled \
            and bool(core.globals_["FLAGS_executor_segmentation"])
        check, action = _guard_flags()
        if (window_names and not compiled) or (
                compiled and n_steps > 1 and check and action == "raise"):
            # raise localizes a tripped step from exactly its pre-step
            # state: a window runs step by step (the reference's rule)
            return self._run_window_fallback(program, feed, fetch_list,
                                             scope, return_numpy, n_steps,
                                             window_names)
        fetched = _INTERPRET
        if compiled or segmented:
            fetched = self._run_compiled(program, scope, feed, fetch_names,
                                         return_numpy, seed, n_steps,
                                         window_names, segmented)
            if fetched is not _INTERPRET:
                self._last_run_mode = "segmented" if segmented \
                    else "compiled"
        if fetched is _INTERPRET:
            fetched = self._run_interpreted(program, scope, feed,
                                            fetch_names, return_numpy, seed,
                                            n_steps)
            self._last_run_mode = "interpreted"
        # after the state's write-back: the checkpoint holds this run's
        # last step
        self._maybe_auto_checkpoint(user_program, scope)
        return fetched

    def _await_upload(self, feed, ready):
        """A window the DataLoader copied to the device on its own stream:
        the current stream (which the executor's side stream waits for)
        waits for the event recorded after the copies, and each tensor is
        marked in use by it, so the allocator keeps its memory until this
        run's work is done."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ready)
        for t in feed.values():
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(cur)

    # ------------------------------------------- fault-tolerant training
    @staticmethod
    def _host_steps(scope: Scope) -> int:
        """The scope's step count on the host; at a scope's first run it
        is read once from the device counter (0 when there is none)."""
        n = Executor._rng_counters.get(scope)
        if n is None:
            v = scope.find_var(_RNG_COUNTER)
            n = (int(v.value().array.reshape(-1)[0].item())
                 if v is not None and v.is_initialized() else 0)
            Executor._rng_counters[scope] = n
        return n

    @staticmethod
    def _count_steps(scope: Scope, n: int) -> int:
        """Add the ``n`` steps a run took to the scope's host count. → the
        new count."""
        n += Executor._host_steps(scope)
        Executor._rng_counters[scope] = n
        return n

    def set_auto_checkpoint(self, dirname, every_n_steps: int,
                            program=None, scope: Optional[Scope] = None,
                            max_to_keep: int = 3, dataloader=None):
        """Periodic atomic checkpoints (the TPU package's
        executor.py:1650): a ``run`` after which the scope's step count
        has crossed a multiple of ``every_n_steps`` saves every
        persistable and the step counter to ``dirname/ckpt-<step>``
        (``io.save_checkpoint``: a temporary directory, fsync, rename).
        ``program`` and ``scope``, when given, restrict the runs that
        save: pass the training program, so that startup and evaluation
        runs do not. ``dataloader``: its ``state_dict()`` goes into the
        manifest, so a resume continues the input stream where the
        checkpoint left it. ``every_n_steps <= 0`` turns saving off."""
        if not dirname or every_n_steps <= 0:
            self._auto_ckpt = None
            return
        self._auto_ckpt = {
            "dir": dirname, "every": int(every_n_steps),
            "program": program, "scope": scope,
            "max_to_keep": int(max_to_keep), "dataloader": dataloader,
            "last_step": 0,
        }

    def resume_from(self, path, program=None, scope: Optional[Scope] = None,
                    dataloader=None) -> Optional[Dict[str, Any]]:
        """Restore the newest valid checkpoint under ``path`` (or that
        checkpoint directory; the TPU package's executor.py:1673): the
        persistables, the step counter and, with ``dataloader``, the
        input position; a killed and resumed run then gives the losses
        of an unbroken one, bit for bit. → the manifest, or None when
        ``path`` holds no checkpoint yet (a fresh start)."""
        from . import io as _io
        if scope is None:
            scope = global_scope()
        if isinstance(path, str) and not os.path.isdir(path):
            return None
        try:
            manifest = _io.load_checkpoint(self, path,
                                           main_program=program,
                                           scope=scope)
        except core.CheckpointError:
            if _io.latest_checkpoint(path) is None and \
                    not os.path.exists(os.path.join(path,
                                                    _io.CKPT_MANIFEST)):
                # nothing to restore: a fresh start, said aloud when
                # checkpoints exist and none validates
                if _io._checkpoint_steps(path):
                    warnings.warn(
                        f"resume_from({path!r}): checkpoints exist but "
                        f"none validated — starting FRESH from step 0",
                        stacklevel=2)
                return None
            raise
        if dataloader is not None and manifest.get("dataloader"):
            dataloader.load_state_dict(manifest["dataloader"])
        if self._auto_ckpt is not None:
            self._auto_ckpt["last_step"] = int(manifest["global_step"])
        return manifest

    def _maybe_auto_checkpoint(self, program, scope: Scope):
        """The end of a ``run``: save when the scope's step count crossed
        a boundary since the last save (the TPU package's
        executor.py:1712). The save reads the device's counter anyway; it
        must equal the host count."""
        cfg = self._auto_ckpt
        if cfg is None or self._last_step_tripped:
            return
        if cfg["program"] is not None and program is not cfg["program"]:
            return
        if cfg["scope"] is not None and scope is not cfg["scope"]:
            return
        step = Executor._rng_counters.get(scope)
        every = cfg["every"]
        if step is None or step // every <= cfg["last_step"] // every:
            return
        from . import io as _io
        on_device = _io._scope_rng_counter(scope)
        if on_device != step:
            raise RuntimeError(
                f"the scope's step counter is {on_device} on the device "
                f"but {step} on the host: a run advanced one without the "
                "other")
        dl = cfg["dataloader"]
        _io.save_checkpoint(self, cfg["dir"],
                            main_program=cfg["program"] or program,
                            scope=scope, global_step=step,
                            dataloader_state=(dl.state_dict()
                                              if dl is not None else None),
                            max_to_keep=cfg["max_to_keep"])
        cfg["last_step"] = step

    def set_health_monitor(self, ckpt_dir, program=None, scope=None,
                           tolerance=None, max_rollbacks=None,
                           dataloader=None, on_rollback=None
                           ) -> HealthMonitor:
        """The ``FLAGS_nan_inf_action=rollback`` monitor, configured
        explicitly (the TPU package's executor.py:1741). Without it the
        monitor is made from the ``set_auto_checkpoint`` configuration at
        the first tripped step."""
        self._health_monitor = HealthMonitor(
            self, ckpt_dir, program=program, scope=scope,
            tolerance=tolerance, max_rollbacks=max_rollbacks,
            dataloader=dataloader, on_rollback=on_rollback)
        return self._health_monitor

    def _ensure_health_monitor(self, program, scope) -> HealthMonitor:
        if self._health_monitor is not None:
            return self._health_monitor
        cfg = self._auto_ckpt
        if cfg is None or not cfg.get("dir"):
            raise core.NumericFaultError(
                "FLAGS_nan_inf_action=rollback tripped but no checkpoint "
                "plane is configured — call set_auto_checkpoint(), or "
                "wire set_health_monitor() explicitly")
        self._health_monitor = HealthMonitor(
            self, cfg["dir"], program=cfg["program"] or program,
            scope=cfg["scope"] or scope, dataloader=cfg.get("dataloader"))
        return self._health_monitor

    def health_stats(self) -> Dict[str, int]:
        """The guard's host counters: steps checked and steps tripped.
        Only the actions that read the verdicts (raise, rollback, and
        every interpreted step) advance them; ``skip`` leaves its
        verdicts on the device (``_last_health``)."""
        return dict(self._health_stats)

    def _run_window_fallback(self, program, feed, fetch_list, scope,
                             return_numpy, n_steps, window_names):
        """A window step by step (reference executor.py:2499): windowed
        feeds on the interpreter, and any compiled window under the
        guard's raise action. One ``run`` a step on slice i of every
        windowed feed, the others as they are; the fetches stacked
        [n_steps, ...]."""
        def piece(name, v, i):
            if name not in window_names:
                return v
            return (v.array if isinstance(v, LoDTensor) else v)[i]
        per_step = [self.run(program, feed={n: piece(n, v, i)
                                            for n, v in feed.items()},
                             fetch_list=fetch_list, scope=scope,
                             return_numpy=return_numpy)
                    for i in range(n_steps)]
        if not per_step[0]:
            return per_step[-1]
        if return_numpy:
            return [np.stack([s[j] for s in per_step])
                    for j in range(len(per_step[0]))]
        return [LoDTensor(torch.stack([s[j].array for s in per_step]))
                for j in range(len(per_step[0]))]

    def _is_compilable(self, program: Program) -> bool:
        """``_whole_compilable`` of the global block, once per program
        version."""
        got = self._compilable.get(program)
        if got is None or got[0] != program._version:
            got = (program._version,
                   _whole_compilable(program.global_block().ops))
            self._compilable[program] = got
        return got[1]

    # ------------------------------------------------------------------
    def _feed_tensor(self, block, name: str, data) -> torch.Tensor:
        """The feed as a tensor in its var's dtype, where it lies."""
        if isinstance(data, LoDTensor):
            data = data.array
        t = data if isinstance(data, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(data)))
        var = block._find_var_recursive(name)
        return t.to(dtype=core.dtype_to_torch(var.dtype)) if var is not None \
            else t

    # the feed cache's limits (the TPU package's): arrays up to 4 MiB are
    # fingerprinted, and a name fed a new array 8 times in a row is not
    # looked at again
    _FEED_CACHE_MAX_BYTES = 4 << 20
    _FEED_CACHE_MISS_LIMIT = 8

    def _feed_value(self, block, name: str, data) -> torch.Tensor:
        """The feed as a tensor in its var's dtype: its device copy from
        the feed cache (``FLAGS_feed_device_cache``), or, for what the
        cache does not take, the tensor where it lies."""
        if core.globals_["FLAGS_feed_device_cache"]:
            t = self._feed_device_cached(block, name, data)
            if t is not None:
                return t
        return self._feed_tensor(block, name, data)

    def _feed_device_cached(self, block, name: str,
                            data) -> Optional[torch.Tensor]:
        """The reference's feed cache (executor.py:2583): when the SAME
        ndarray object (same buffer address, shape and dtype) is fed again
        and its CRC32 matches the one taken at upload, the device tensor
        of that upload is reused and no host-to-device copy is made; a
        mutated array is uploaded again. The entry pins the array, so its
        id cannot be recycled by another. None for what the cache does
        not take (not an ndarray, above the size limit, or a name whose
        arrays keep changing)."""
        if not isinstance(data, np.ndarray) \
                or data.nbytes > self._FEED_CACHE_MAX_BYTES:
            return None
        entry = self._feed_cache.get(name)
        if entry == "uncacheable":
            return None
        var = block._find_var_recursive(name)
        ident = (id(data), data.__array_interface__["data"][0], data.shape,
                 data.dtype.str, None if var is None else var.dtype)
        fp = zlib.crc32(np.ascontiguousarray(data).reshape(-1)
                        .view(np.uint8))
        if entry is not None and entry[0] == ident and entry[1] == fp:
            entry[4][0] = 0
            self.feed_stats["cache_hits"] += 1
            return entry[3]
        misses = [0]
        if entry is not None and entry[0] != ident:
            misses = entry[4]
            misses[0] += 1
            if misses[0] >= self._FEED_CACHE_MISS_LIMIT:
                self._feed_cache[name] = "uncacheable"
                return None
        t = self._feed_tensor(block, name, data).to(self.device)
        if t.device.type == "cpu":
            t = t.clone()  # a host tensor shares the ndarray's memory
        self._feed_cache[name] = (ident, fp, data, t, misses)
        self.feed_stats["uploads"] += 1
        return t

    def _run_compiled(self, program, scope, feed, fetch_names, return_numpy,
                      seed, n_steps=1, window_names=(), segmented=False):
        """A compiled (or ``segmented``) run through the cache of planned
        blocks; ``_INTERPRET`` when the block is too small to segment."""
        block = program.global_block()
        feed_lods = {}
        for n, d in feed.items():
            lv = _tensor_lod(d)
            if lv:
                feed_lods[n] = lv
        feeds = {n: self._feed_value(block, n, d) for n, d in feed.items()}
        names = tuple(sorted(feeds))
        # a windowed feed's step shape is a slice's
        key = (id(program), program._version, names, tuple(fetch_names),
               id(scope),
               tuple((n, tuple(feeds[n].shape[n in window_names:]),
                      feeds[n].dtype) for n in names),
               seed, core.globals_["FLAGS_use_bf16_matmul"],
               # the guard is built into the block: flipping a flag
               # builds a new one
               (core.globals_["FLAGS_check_nan_inf"],
                core.globals_["FLAGS_nan_inf_action"]),
               segmented and core.globals_["FLAGS_executor_seg_min_ops"],
               # the plan is fixed for its feeds' LoDs
               tuple(sorted(feed_lods.items())))
        cb = self._compiled_cache.get(key)
        # an id() of a dead scope can be reused by a new one: validate
        if cb is None or cb._scope_ref() is not scope:
            small = self._unsegmentable.get(key)
            if small is not None and small() is scope:
                return _INTERPRET
            if self.device.type == "cuda" and self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            # the verifier's choke point: once a program version, at its
            # first compile (FLAGS_program_verify)
            analysis.maybe_verify(program, "executor", feed_names=names,
                                  fetch_names=tuple(fetch_names),
                                  scope=scope)
            if segmented:
                cb = self._build_segmented(program, names, fetch_names,
                                           scope, seed, feed_lods)
                if cb is None:
                    self._unsegmentable[key] = weakref.ref(scope)
                    return _INTERPRET
                # the plan the segmented build made, against the program
                analysis.maybe_verify(program, "executor-plan",
                                      feed_names=names,
                                      fetch_names=tuple(fetch_names),
                                      segment_plan=cb.segments, scope=scope)
            else:
                cb = _CompiledBlock(program, names, fetch_names, scope, seed,
                                    self.device, self._stream, self._pool,
                                    feed_lods)
            self._compiled_cache[key] = cb
            if feed_lods:
                self._evict_lod_plans(key)
        self._last_block = cb
        if segmented:
            # a host loop: the islands act every step
            for _ in range(n_steps):
                fetched = cb.run(scope, feeds, return_numpy)
                self._count_steps(scope, 1)
                if cb._guard_active:
                    self._last_health = cb.last_health
                    self._act_on_health(cb, program, scope, feeds, seed)
            return fetched
        if n_steps > 1 or window_names:
            fetched = cb.run_window(scope, feeds, window_names, n_steps,
                                    return_numpy)
        else:
            fetched = cb.run(scope, feeds, return_numpy)
        self._count_steps(scope, n_steps)
        if cb._guard_active:
            self._last_health = cb.last_health
            self._act_on_health(cb, program, scope, feeds, seed)
        return fetched

    def _evict_lod_plans(self, new_key):
        """A ragged epoch gives a new LoD, so a new plan, nearly every
        batch; such a plan's first run is eager and it never captures. Of
        the plans keyed by a feed LoD that have not captured, the
        ``_LOD_PLANS_KEPT`` newest stay cached (a batch whose LoD comes
        back soon captures on its second run); older ones are dropped
        with what they hold on the device (their LoD constants), so the
        cache and the card's memory do not grow with each batch."""
        self._lod_plan_keys[new_key] = None
        eager = [k for k in self._lod_plan_keys
                 if k in self._compiled_cache
                 and not self._compiled_cache[k].stats["captures"]]
        for k in eager[:-self._LOD_PLANS_KEPT]:
            del self._compiled_cache[k]
        for k in list(self._lod_plan_keys):
            if k not in self._compiled_cache:
                del self._lod_plan_keys[k]

    def _build_segmented(self, program, feed_names, fetch_names, scope,
                         seed, feed_lods=None) -> Optional[_SegmentedBlock]:
        """The segment plan of a block that is not compilable whole (the
        TPU package's executor.py:1606), or None when it has too few
        compilable ops: it then runs interpreted. Any other failure to
        plan raises (the TPU package warns and interprets instead): a run
        does not leave the path it was asked for."""
        try:
            return _SegmentedBlock(program, feed_names, fetch_names, scope,
                                   seed, self.device, self._stream,
                                   self._pool, feed_lods)
        except _NotSegmentable:
            return None

    def _act_on_health(self, cb, program, scope, feeds, seed):
        """After a guarded compiled run (one step, or a window's [n_steps]
        verdicts): ``skip`` and AMP alone leave the health on the device;
        ``raise`` and ``rollback`` read it (after the fetches, so the
        stream has drained) and act on a tripped step, whose state the
        select has already put back (the TPU package's
        executor.py:1808-1864)."""
        if not cb._guard_check or cb._guard_action == "skip":
            return
        flags = [bool(f) for f in cb.last_health.reshape(-1).tolist()]
        n_bad = flags.count(False)
        self._health_stats["steps_checked"] += len(flags)
        self._health_stats["trips"] += n_bad
        self._last_step_tripped = self._last_step_tripped or bool(n_bad)
        step0 = self._host_steps(scope) - len(flags)
        if cb._guard_action == "rollback":
            self._observe_health(program, scope, flags, step0)
        elif n_bad:
            self._localize_and_raise(program, scope, feeds, seed,
                                     step0 + flags.index(False))

    def _observe_health(self, program, scope, flags, step0: int):
        """``rollback``: each step's verdict to the monitor, in order,
        until one rolls back (the verdicts past a restore describe
        discarded steps). The monitor is made at the first trip."""
        mon = self._health_monitor
        for i, ok in enumerate(flags):
            if ok:
                if mon is not None:
                    mon.observe(True, step0 + i)
                continue
            if mon is None:
                mon = self._ensure_health_monitor(program, scope)
            if mon.observe(False, step0 + i) == "rolled_back":
                break

    def _localize_and_raise(self, program, scope, feeds, seed, step):
        """``raise``: the step tripped and its select kept the pre-step
        state and scale. Re-run it through the interpreter with the same
        feeds and random keys, checking every op's outputs; the first
        non-finite one raises FloatingPointError naming it."""
        block = program.global_block()
        for n, t in feeds.items():
            scope.var(n).set_value(LoDTensor(t.to(self.device)))
        counter = _step_counter(scope, self.device)
        counter.sub_(1)
        keys = _StepKeys(seed, _rng_indices(block.ops), self.device)
        keys.begin(counter)
        try:
            for idx, op in enumerate(block.ops):
                self._run_op(op, idx, scope, keys, check=True)
        except FloatingPointError as e:
            raise FloatingPointError(
                f"numeric fault at global step {step}: {e}") from e
        finally:
            keys.end()
            counter.add_(1)
        raise core.NumericFaultError(
            f"health guard tripped at global step {step} but the "
            "interpreter re-run reproduced no non-finite op output: the "
            "fault did not replay")

    # ------------------------------------------------------ dataset path
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None, window_size=1,
                           checkpoint_dir=None,
                           checkpoint_every_n_steps=0, resume_from=None):
        """One pass over a Dataset (reference: executor.py:1438
        train_from_dataset, whose C++ MultiTrainer threads each run the
        block; the TPU package's executor.py:2315): the native data feed
        parses and batches the slot files on the host, and each batch, a
        dict of LoDTensors, is one ``run`` of the block on the executor's
        device. ``window_size=k`` stacks k consecutive batches into one
        window run (``run(n_steps=k)``) when every value is dense and the
        shapes agree; batches that carry LoD, as every int slot does, run
        step by step. ``print_period`` prints the fetches every that many
        steps as the TPU package does; ``fetch_handler`` samples vars from
        a thread (``FetchHandler``). ``checkpoint_dir`` with
        ``checkpoint_every_n_steps`` saves periodic atomic checkpoints of
        this program (``set_auto_checkpoint``); ``resume_from`` restores
        the newest valid one first (``resume_from``), so a killed run
        relaunched on the same dataset continues bit for bit. ``thread``
        and ``debug`` are accepted for the reference signature. → the last
        step's fetches."""
        if program is None:
            program = default_main_program()
        if checkpoint_dir and checkpoint_every_n_steps > 0:
            self.set_auto_checkpoint(checkpoint_dir,
                                     checkpoint_every_n_steps,
                                     program=program, scope=scope)
        if resume_from:
            self.resume_from(resume_from, program=program, scope=scope)
        return self._run_from_dataset(program, dataset, scope, fetch_list,
                                      fetch_info, print_period,
                                      fetch_handler, window_size)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None, window_size=1):
        """``train_from_dataset`` without checkpoints (reference:
        executor.py infer_from_dataset): the program decides what a run
        updates."""
        return self._run_from_dataset(program, dataset, scope, fetch_list,
                                      fetch_info, print_period,
                                      fetch_handler, window_size)

    @staticmethod
    def _stack_dataset_window(feeds: List[Dict[str, Any]]):
        """[{name: LoDTensor}] × k → a WindowBatch of [k, ...] stacks when
        every value is LoD-free and the shapes agree across the window;
        None otherwise (the batches then run one by one)."""
        from .reader import _stack_window
        try:
            return _stack_window(feeds, len(feeds), len(feeds))
        except (ValueError, KeyError):
            return None

    def _run_from_dataset(self, program, dataset, scope, fetch_list,
                          fetch_info, print_period, fetch_handler=None,
                          window_size=1):
        if dataset is None:
            raise ValueError("dataset must be provided")
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = global_scope()
        dataset._ensure_handle()
        if dataset.get_memory_data_size() == 0:
            dataset._load()
        fetch_names = _to_fetch_names(fetch_list)
        monitor = None
        if fetch_handler is not None:
            monitor = _FetchHandlerMonitor(scope, fetch_handler)
            monitor.start()
        step = 0
        last = []

        def report(vals, count=1):
            # once a print_period: when a boundary falls in [step, step +
            # count), labelled by the first step; a window reports its
            # final step's values
            if not (fetch_names and print_period):
                return
            off = step % print_period
            if off != 0 and off + count <= print_period:
                return
            infos = fetch_info or fetch_names
            msg = ", ".join(
                f"{i}={np.asarray(v).reshape(-1)[-1]:.6f}"
                for i, v in zip(infos, vals))
            print(f"[train_from_dataset] step {step}: {msg}")

        pending: List[Dict[str, Any]] = []

        def flush():
            nonlocal step, last
            if not pending:
                return
            stacked = (self._stack_dataset_window(pending)
                       if len(pending) > 1 else None)
            if stacked is not None:
                last = self.run(program, feed=stacked,
                                fetch_list=fetch_list, scope=scope,
                                n_steps=len(pending))
                report(last, count=len(pending))
                step += len(pending)
            else:
                for f in pending:
                    last = self.run(program, feed=f, fetch_list=fetch_list,
                                    scope=scope)
                    report(last)
                    step += 1
            pending.clear()

        try:
            for feed in dataset._iter_batches():
                pending.append(feed)
                if len(pending) >= max(1, window_size):
                    flush()
            flush()
        finally:
            if monitor is not None:
                monitor.stop()
        return last

    # ------------------------------------------------------- interpreter
    def _run_interpreted(self, program, scope, feed, fetch_names,
                         return_numpy, seed, n_steps=1):
        """``n_steps`` steps on the same feeds; the final step's fetches
        (reference executor.py:2273-2290). Under the guard each step ends
        in the compiled epilogue's counterpart (``_interp_guard``)."""
        block = program.global_block()
        for name, data in feed.items():
            scope.var(name).set_value(LoDTensor(
                self._feed_value(block, name, data).to(self.device),
                data.lod() if isinstance(data, LoDTensor) else None))
        self._check_inputs(block, scope, set(feed))
        guard = self._interp_guard_cfg(program, set(feed), scope)
        check_ops = guard is not None and guard["check"] \
            and guard["action"] == "raise"
        keys = _StepKeys(seed, _rng_indices(block.ops), self.device)
        for _ in range(n_steps):
            counter = _step_counter(scope, self.device)
            snap = {}
            if guard is not None and guard["select"]:
                for n in guard["select_names"]:
                    t = _scope_tensor(scope, n)
                    if t is not None:
                        snap[n] = t
            keys.begin(counter)
            try:
                for idx, op in enumerate(block.ops):
                    self._run_op(op, idx, scope, keys, check=check_ops)
            finally:
                counter.add_(1)
                keys.end()
                step = self._count_steps(scope, 1) - 1
            if guard is not None:
                self._interp_guard(guard, program, scope, snap, fetch_names,
                                   step)
        fetched = []
        for n in fetch_names:
            v = scope.find_var(n)
            if v is None or not v.is_initialized():
                raise KeyError(f"fetch var '{n}' not found in scope")
            t = v.value()
            fetched.append(t.numpy() if return_numpy else t)
        return fetched

    def _interp_guard_cfg(self, program, feed_names, scope):
        """The interpreter's guard plan (reference executor.py:1880),
        classified as ``_CompiledBlock._init_guard`` classifies, so both
        paths reduce the health over the same vars and select the same
        state. None when the guard is off and the program has no dynamic
        loss scale. Cached on the program per (version, feeds, flags)."""
        check, action = _guard_flags()
        amp = getattr(program, "_amp_dynamic", None)
        if not check and amp is None:
            return None
        ckey = (program._version, tuple(sorted(feed_names)), check, action)
        cache = program.__dict__.setdefault("_interp_guard_cache", {})
        hit = cache.get(ckey)
        if hit is not None and hit[0]() is scope:
            return hit[1]
        ops = program.global_block().ops
        if amp is not None and not _block_reads_amp_scale(ops, amp):
            amp = None
        cfg = None
        if check or amp is not None:
            written: set = set()
            rbw: List[str] = []
            for op in ops:
                for n in op.input_arg_names:
                    if n not in written and n not in feed_names \
                            and n not in rbw \
                            and _scope_tensor(scope, n) is not None:
                        rbw.append(n)
                written.update(op.output_arg_names)
            persistable = {v.name for v in program.global_block()
                           .vars.values() if v.persistable}
            amp_names = (set() if amp is None else
                         {amp["scale"], amp["good"], amp["bad"]})
            sel = [n for n in rbw if n in written and n not in amp_names]
            sel += [n for n in sorted(written)
                    if n in persistable and n not in sel
                    and n not in feed_names and n not in amp_names
                    and _scope_tensor(scope, n) is not None]
            cfg = {"check": check, "action": action, "amp": amp,
                   "select_names": tuple(sel),
                   "health_names": tuple(
                       n + GRAD_SUFFIX for n in sel
                       if n + GRAD_SUFFIX in written) or tuple(
                       n for n in sorted(written)
                       if n.endswith(GRAD_SUFFIX)),
                   "select": amp is not None or (
                       check and action in ("skip", "rollback"))}
        cache[ckey] = (weakref.ref(scope), cfg)
        return cfg

    def _interp_guard(self, guard, program, scope, snap, fetch_names,
                      step):
        """The compiled epilogue's counterpart after an interpreted step:
        the same health, the same scale arithmetic; on a tripped step the
        selected state goes back to ``snap``, its pre-step tensors (the
        interpreter replaces scope values, never writes them in place)."""
        from .ir import fused_health
        vals = [t for t in (_scope_tensor(scope, n)
                            for n in guard["health_names"]) if t is not None]
        if not vals:
            vals = [t for t in (_scope_tensor(scope, n)
                                for n in guard["select_names"])
                    if t is not None]
        vals += [t for t in (_scope_tensor(scope, n) for n in fetch_names)
                 if t is not None]
        health = fused_health(vals, self.device)
        healthy = bool(health)
        a = guard["amp"]
        if a is not None and not (guard["check"]
                                  and guard["action"] == "raise"
                                  and not healthy):
            news = _amp_scale_update(health, *(_scope_tensor(scope, a[k])
                                               for k in ("scale", "good",
                                                         "bad")), a)
            for k, v in zip(("scale", "good", "bad"), news):
                scope.var(a[k]).set_value(LoDTensor(v))
        self._last_health = health
        self._health_stats["steps_checked"] += 1
        if guard["check"] and guard["action"] in ("raise", "rollback"):
            self._last_step_tripped = self._last_step_tripped \
                or not healthy
        if not healthy:
            self._health_stats["trips"] += 1
            for n, t in snap.items():
                scope.var(n).set_value(LoDTensor(t))
        if guard["check"] and guard["action"] == "rollback":
            self._observe_health(program, scope, [healthy], step)

    @staticmethod
    def _check_inputs(block, scope: Scope, fed):
        """Every var an op reads is fed in this run (data vars: a value
        left in the scope by an earlier run does not count), initialized
        in the scope, or written by an earlier op — else a KeyError naming
        the missing feed, or a RuntimeError naming the uninitialized
        persistable (startup program not run)."""
        produced = set(fed)
        for op in block.ops:
            for n in op.input_arg_names:
                if n in produced or n == _EMPTY:
                    continue
                var = block._find_var_recursive(n)
                if var is not None and var.is_data:
                    raise KeyError(f"feed var '{n}' (read by op "
                                   f"'{op.type}') is missing from feed")
                if _initialized(scope, n):
                    continue
                if var is not None and var.persistable:
                    raise RuntimeError(
                        f"persistable var '{n}' is not initialized in the "
                        "scope: run the startup program first")
                raise RuntimeError(f"var '{n}' is read by op '{op.type}' "
                                   "before anything writes it")
            produced.update(op.output_arg_names)

    def _run_op(self, op, idx: int, scope: Scope, keys: _StepKeys,
                check: bool = False):
        """One op over the scope; ``check``: the raise action's per-op
        finite check, before the outputs are written."""
        _interpret_op(op, idx, scope, keys, self.device, check)


def _interpret_op(op, idx: int, scope: Scope, keys: _StepKeys, device,
                  check: bool = False) -> List[str]:
    """Op ``idx`` of the block over the scope (the interpreter's step, and
    an island's): its inputs read from the scope, its outputs written
    there; a stateful op gets its Operator as ``attrs["_op"]`` and the
    scope as ``attrs["_scope"]``.
    ``check``: the raise action's per-op finite check, before the outputs
    are written. → the names written."""
    info, grad_of, ridx = _resolve(op, idx)
    attrs = _kernel_attrs(op, info, ridx, device, keys)
    if info.stateful:
        def run_block(block, sc, it=None):
            _interpret_block(block, sc, keys, device, check, it)
        attrs = dict(attrs, _op=op, _scope=scope, _run_block=run_block)
    ins: Dict[str, list] = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            v = scope.find_var(n)
            val = v.value() if v is not None else None
            # a tensor array is read by its op from the scope
            vals.append(val.array if isinstance(val, LoDTensor) else None)
        ins[slot] = vals

    def scope_lod(n):
        v = scope.find_var(n)
        if v is not None and v.is_initialized():
            return _tensor_lod(v.value())
        return None
    in_lods = _collect_in_lods(op, scope_lod)
    if _op_needs_lod(op):
        attrs = dict(attrs, _lod=in_lods)
    if grad_of is None:
        outs = info.kernel(ins, attrs)
    else:
        outs = run_generic_grad(
            grad_of, ins, attrs, wanted_grad_slots=list(op.outputs),
            fwd_input_slots=attrs.get("_fwd_in", list(op.inputs)))
    outs = outs or {}
    if check:
        _check_op_outputs_finite(op, idx, outs)
    written = []
    for slot, names in op.outputs.items():
        for n, val in zip(names, outs.get(slot) or []):
            if val is not None and n != _EMPTY:
                scope.var(n).set_value(LoDTensor(val))
                written.append(n)

    def set_scope_lod(n, lv):
        v = scope.find_var(n)
        if v is not None and v.is_initialized() \
                and isinstance(v.value(), LoDTensor):
            v.value().set_lod(lv or [])

    def scope_len(n):
        v = scope.find_var(n)
        if v is not None and v.is_initialized() \
                and isinstance(v.value(), LoDTensor) \
                and v.value().array.dim():
            return v.value().array.shape[0]
        return None
    _propagate_lods(op, outs, in_lods, set_scope_lod, scope_len)
    return written


def _interpret_block(block, scope: Scope, keys, device, check: bool = False,
                     it: Optional[int] = None) -> None:
    """A sub-block op by op over the scope (the TPU package's
    ``_run_block_eager``), its random ops keyed by ``_SubKeys``: ``keys``
    are the enclosing block's, ``it`` the iteration of the ``while`` that
    runs it."""
    its = keys.its
    if it is not None:
        its = its + (torch.full((1,), int(it), dtype=torch.int64,
                                device=device),)
    sub = _SubKeys(keys, block, device, its)
    for idx, op in enumerate(block.ops):
        _interpret_op(op, idx, scope, sub, device, check)
