"""Executor (counterpart of paddle_tpu/fluid/executor.py; reference:
python/paddle/fluid/executor.py:457).

Two paths, chosen by ``FLAGS_executor_mode`` as in the TPU package:

  * compiled (default): a compilable block (every op pure, no host read
    of a tensor value, no control flow) runs through a cache of
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
    ``FLAGS_executor_seg_min_ops`` compilable ops, or fed LoD (segments
    take dense feeds), runs interpreted, as such a block did before
    segments; any other failure to plan, capture or replay raises.
  * interpreted: the oracle (the TPU package's ``_run_interpreted_step``):
    the ops of the global block run in order over the scope, one kernel
    call each; every intermediate and grad stays in the scope.

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

from . import core
from .core import CUDAPlace, LoDTensor, Place, Scope, global_scope
from .framework import Program, Variable, default_main_program
from .ir import op_island_reason, op_reads_host_values
from ..ops import rng
from ..ops.registry import (GRAD_SUFFIX, OPS, resolve_base_info,
                            run_generic_grad)

__all__ = ["Executor", "HealthMonitor", "global_scope", "scope_guard"]

_RNG_COUNTER = "@RNG_COUNTER@"
_EMPTY = "@EMPTY@"  # append_backward's name for "no var in this slot"
_MODES = ("compiled", "interpreted")
_GUARD_ACTIONS = ("raise", "skip", "rollback")
_INTERPRET = object()  # _run_compiled: the block is too small to segment


@contextlib.contextmanager
def scope_guard(scope: Scope):
    old = core._switch_scope(scope)
    try:
        yield
    finally:
        core._switch_scope(old)


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
# planning (reference executor.py:231-337)
# --------------------------------------------------------------------------
_op_reads_host_values = op_reads_host_values


def _op_is_stateful(op) -> bool:
    return op_island_reason(op) in ("stateful", "unregistered")


def _op_needs_rng(op_type: str) -> bool:
    info = resolve_base_info(op_type)
    return info.needs_rng if info is not None else False


def _ops_compilable(ops) -> bool:
    """True if every op has a pure kernel that reads no tensor value on
    the host; control flow is not compilable yet."""
    return not any(op_island_reason(op) for op in ops)


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
    nothing launches nothing for them."""

    __slots__ = ("seed", "slot", "hidx", "counter", "keys")

    def __init__(self, seed: int, idxs: Sequence[int], device):
        self.seed = seed
        self.slot = {k: j for j, k in enumerate(idxs)}
        self.hidx = rng.hashed_indices(idxs, device)
        self.counter = None
        self.keys = None

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
                 "wanted", "fwd_in", "reads", "writes")

    def __init__(self, op, info, grad_of, attrs):
        self.kernel = info.kernel
        self.grad_of = grad_of
        self.attrs = attrs
        self.ins = tuple((s, tuple(n)) for s, n in op.inputs.items())
        self.outs = tuple((s, tuple(n)) for s, n in op.outputs.items())
        self.frees = ()
        self.wanted = list(op.outputs)
        self.fwd_in = attrs.get("_fwd_in", list(op.inputs))
        self.reads = tuple(op.input_arg_names)
        self.writes = tuple(op.output_arg_names)

    def run(self, env: Dict[str, torch.Tensor]):
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
                 scope: Scope, seed: int, device, stream=None, pool=None):
        self._init_common(program, feed_names, fetch_names, scope, seed,
                          device, stream, pool)
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
                     scope: Scope, seed: int, device, stream, pool):
        """The setup a compiled and a segmented block share: the names,
        the ops, the state and the guard (classified before anything
        runs), the step keys and the run records."""
        self._scope_ref = weakref.ref(scope)
        self.program = program
        self.feed_names = tuple(feed_names)
        self.fetch_names = tuple(fetch_names)
        self.device = device
        self.ops = list(program.global_block().ops)
        self._classify_state(program, scope)
        self._init_guard(program, scope)
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

    def _bind(self, op, idx: int) -> _Step:
        """Op ``idx`` of the block bound to its kernel, attrs and key."""
        info, grad_of, ridx = _resolve(op, idx)
        return _Step(op, info, grad_of, _kernel_attrs(
            op, info, ridx, self.device, self._keys))

    def _build_plan(self) -> list:
        """Each op bound, in execution order (the program's, or the remat
        schedule), with liveness: a name that is neither fetched, written
        back nor read by the guard's health leaves the env after the last
        unit that reads or writes it. Under remat a segment's interior
        lives only inside its forward and its span."""
        steps = [self._bind(op, i) for i, op in enumerate(self.ops)]
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
        if return_numpy:
            return [LoDTensor(t).numpy() for t in fetched]
        return [LoDTensor(t) for t in fetched]

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
            scope.var(n).set_value(LoDTensor(t))
        fetches, new, health = self._step(dev_feeds, self._read_state(scope),
                                          _step_counter(scope, self.device))
        for n, v in new.items():
            scope.var(n).set_value(LoDTensor(v))
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
            scope.var(n).set_value(LoDTensor(buf))
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
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
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
            v.set_value(LoDTensor(t))
        for n, t in self._extra_targets.items():
            if _scope_tensor(scope, n) is not t:
                scope.var(n).set_value(LoDTensor(t))
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
                 scope: Scope, seed: int, device, stream=None, pool=None):
        from .ir import analyze_block_segments
        self.segments = analyze_block_segments(program.global_block().ops)
        n_compiled = sum(len(s.ops) for s in self.segments
                         if s.kind == "compiled")
        if n_compiled < int(core.globals_["FLAGS_executor_seg_min_ops"]):
            raise _NotSegmentable(f"only {n_compiled} compilable ops (< "
                                  "FLAGS_executor_seg_min_ops)")
        self._init_common(program, feed_names, fetch_names, scope, seed,
                          device, stream, pool)
        self.stats["islands"] = 0
        self._plan_segments()
        # the graphs, by segment start: (graph, static inputs, outputs,
        # health flag); the state tensors they read and write; the keys
        # a graph derived, alive for the later graphs that read them
        self._rt: Dict[int, tuple] = {}
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
            seg.units = ()
            if seg.kind == "compiled":
                steps = [self._bind(op, seg.start + j)
                         for j, op in enumerate(seg.ops)]
                set_liveness(steps, set(seg.out_names))
                seg.units = tuple(steps)

    # ---------------------------------------------------------- segments
    def _seg_compute(self, seg, env):
        """A compiled segment's ops over its inputs in ``env`` → (its
        outputs, its health flag under the guard or None)."""
        local = {n: env[n] for n in seg.in_names if n in env}
        exec_units(seg.units, local)
        outs = {n: local[n] for n in seg.out_names if n in local}
        if not self._guard_active:
            return outs, None
        from .ir import fused_health
        if not seg.guard_names:
            seg.guard_names = tuple(n for n, v in outs.items()
                                    if v.is_floating_point())
        return outs, fused_health(list(outs.values()), self.device)

    def _capture_segment(self, seg, env, stable, rt):
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
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            outs, flag = self._seg_compute(seg, inputs)
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
        rt[seg.start] = (graph, static_in, outs, flag)
        graph.replay()
        self.stats["replays"] += 1
        return outs, flag

    def _replay_segment(self, seg, env):
        graph, static_in, outs, flag = self._rt[seg.start]
        for n, buf in static_in.items():
            buf.copy_(env[n])
        graph.replay()
        self.stats["replays"] += 1
        return outs, flag

    def _island(self, seg, env, scope) -> List[str]:
        """An island op by op through the interpreter: the env values each
        op reads go into the scope (no copy), its writes come back into
        the env. → the names written."""
        written: List[str] = []
        for off, (op, reads, _writes) in enumerate(seg.op_io):
            for n in reads:
                if n in env:
                    scope.var(n).set_value(LoDTensor(env[n]))
            for n in _interpret_op(op, seg.start + off, scope, self._keys,
                                   self.device):
                env[n] = _scope_tensor(scope, n)
                written.append(n)
        self.stats["islands"] += 1
        return written

    # -------------------------------------------------------------- step
    def _seg_step(self, scope, feeds, mode):
        """One step through the segments: ``mode`` "eager" (the CPU, and
        the GPU's warm-up), "capture" or "replay" → (fetches, health or
        None)."""
        from .ir import fused_health
        dev_feeds = {n: t.to(self.device) for n, t in feeds.items()}
        counter = _step_counter(scope, self.device)
        if mode == "replay":
            state = {n: self._targets[n]
                     for n in self.mut_state + self.ro_state}
        else:
            state = self._read_state(scope)
        rt: Dict[int, tuple] = {}
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
                    written = self._island(seg, env, scope)
                    if mode == "capture":
                        stable.difference_update(written)
                        if not had_keys:
                            # keys drawn eagerly here: a later graph
                            # derives its own
                            self._keys.keys = None
                    flag = (fused_health([env[n] for n in written],
                                         self.device)
                            if self._guard_active else None)
                elif mode == "eager":
                    outs, flag = self._seg_compute(seg, env)
                    env.update(outs)
                elif mode == "capture":
                    outs, flag = self._capture_segment(seg, env, stable, rt)
                    env.update(outs)
                    stable.update(outs)
                else:
                    outs, flag = self._replay_segment(seg, env)
                    env.update(outs)
                if flag is not None:
                    flags.append(flag)
        except BaseException:
            if orig is not None:
                # a guarded step promises its pre-step state on any failure
                for n, t in orig.items():
                    scope.var(n).set_value(LoDTensor(t))
            raise
        finally:
            self._keys.end()
        counter.add_(1)
        if mode == "capture":
            self._rt = rt
            self._captured = dict(self._targets)
            self._captured[_RNG_COUNTER] = counter
        fetches = [env[n] for n in self.fetch_names]
        health = None
        if self._guard_active:
            health = torch.stack([fused_health(fetches, self.device)]
                                 + flags).all()
        new = {n: env[n] for n in self.mut_state + self.extra_writeback
               if n in env}
        if self._guard_active:
            self._apply_discard(new, orig, health)
        for n, v in new.items():
            t = self._targets.get(n) if mode != "eager" else None
            if t is not None and v is not t and v.shape == t.shape \
                    and v.dtype == t.dtype:
                t.copy_(v)
                v = t
            if _scope_tensor(scope, n) is not v:
                scope.var(n).set_value(LoDTensor(v))
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
        self.last_exec = mode
        return fetched, health

    def _drop_graph(self):
        self._rt, self._held_keys = {}, []
        self._targets, self._captured, self._extra_targets = {}, {}, {}


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

    def __init__(self, place: Optional[Place] = None):
        self.place = CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        if self.device.type == "cuda":
            # f32 mul/matmul run in full f32, as in the TPU package: no
            # TF32 rounding of the operands
            torch.backends.cuda.matmul.allow_tf32 = False
        self._compiled_cache: Dict[tuple, _CompiledBlock] = {}
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
        when the scope's steps crossed a boundary."""
        program = default_main_program() if program is None else program
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
        # a block that does not compile whole and is fed LoD runs
        # interpreted, as it did before segments: they take dense feeds
        segmented = mode == "compiled" and not compiled \
            and bool(core.globals_["FLAGS_executor_segmentation"]) \
            and not any(isinstance(d, LoDTensor) and d.lod()
                        for d in feed.values())
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
        """``_ops_compilable`` of the global block, once per program
        version."""
        got = self._compilable.get(program)
        if got is None or got[0] != program._version:
            got = (program._version,
                   _ops_compilable(program.global_block().ops))
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
        for n, d in feed.items():
            if isinstance(d, LoDTensor) and d.lod():
                raise NotImplementedError(
                    f"feed '{n}' carries LoD: the compiled step of "
                    "paddle_tpu_torch takes dense feeds only (run with "
                    "FLAGS_executor_mode=interpreted)")
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
               segmented and core.globals_["FLAGS_executor_seg_min_ops"])
        cb = self._compiled_cache.get(key)
        # an id() of a dead scope can be reused by a new one: validate
        if cb is None or cb._scope_ref() is not scope:
            small = self._unsegmentable.get(key)
            if small is not None and small() is scope:
                return _INTERPRET
            if self.device.type == "cuda" and self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            if segmented:
                cb = self._build_segmented(program, names, fetch_names,
                                           scope, seed)
                if cb is None:
                    self._unsegmentable[key] = weakref.ref(scope)
                    return _INTERPRET
            else:
                cb = _CompiledBlock(program, names, fetch_names, scope, seed,
                                    self.device, self._stream, self._pool)
            self._compiled_cache[key] = cb
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

    def _build_segmented(self, program, feed_names, fetch_names, scope,
                         seed) -> Optional[_SegmentedBlock]:
        """The segment plan of a block that is not compilable whole (the
        TPU package's executor.py:1606), or None when it has too few
        compilable ops: it then runs interpreted. Any other failure to
        plan raises (the TPU package warns and interprets instead): a run
        does not leave the path it was asked for."""
        try:
            return _SegmentedBlock(program, feed_names, fetch_names, scope,
                                   seed, self.device, self._stream,
                                   self._pool)
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

    # ------------------------------------------------------- interpreter
    def _run_interpreted(self, program, scope, feed, fetch_names,
                         return_numpy, seed, n_steps=1):
        """``n_steps`` steps on the same feeds; the final step's fetches
        (reference executor.py:2273-2290). Under the guard each step ends
        in the compiled epilogue's counterpart (``_interp_guard``)."""
        block = program.global_block()
        for name, data in feed.items():
            scope.var(name).set_value(LoDTensor(
                self._feed_value(block, name, data).to(self.device)))
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
        attrs = dict(attrs, _op=op, _scope=scope)
    ins: Dict[str, list] = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            v = scope.find_var(n)
            vals.append(v.value().array if v is not None
                        and v.is_initialized() else None)
        ins[slot] = vals
    if grad_of is None:
        outs = info.kernel(ins, attrs)
    else:
        outs = run_generic_grad(
            grad_of, ins, attrs, wanted_grad_slots=list(op.outputs),
            fwd_input_slots=attrs.get("_fwd_in", list(op.inputs)))
    if check:
        _check_op_outputs_finite(op, idx, outs)
    written = []
    for slot, names in op.outputs.items():
        for n, val in zip(names, (outs or {}).get(slot) or []):
            if val is not None and n != _EMPTY:
                scope.var(n).set_value(LoDTensor(val))
                written.append(n)
    return written
