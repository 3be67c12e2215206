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
  * interpreted: the oracle (the TPU package's ``_run_interpreted_step``):
    the ops of the global block run in order over the scope, one kernel
    call each; every intermediate and grad stays in the scope. A block
    that is not compilable runs here too (the TPU package's segmented
    path comes in a later slice).

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
step's fetches, as the TPU package's interpreted branch does.

The numeric fault plane (``FLAGS_check_nan_inf``, ``FLAGS_nan_inf_action``;
the TPU package's executor.py:508-700) runs on both paths. A guarded
compiled step ends in an epilogue on the device: one health scalar (every
param grad and float fetch finite), a select of the state the step
overwrites back to its pre-step value where the step is not healthy, and
the AMP dynamic loss-scale update from the same scalar; under a graph all
of it is captured. ``skip`` never reads the scalar on the host;
``raise`` reads it after the fetches and re-runs a tripped step through
the interpreter, whose per-op check names the op; ``rollback`` has no
checkpoint plane yet and raises ``core.NumericFaultError``. The
interpreter runs the same classification and the same arithmetic.

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
import time
import warnings
import weakref
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import core
from .core import CUDAPlace, LoDTensor, Place, Scope, global_scope
from .framework import Program, Variable, default_main_program
from ..ops import rng
from ..ops.registry import (GRAD_SUFFIX, OPS, resolve_base_info,
                            run_generic_grad)

__all__ = ["Executor", "global_scope", "scope_guard"]

_RNG_COUNTER = "@RNG_COUNTER@"
_EMPTY = "@EMPTY@"  # append_backward's name for "no var in this slot"
_MODES = ("compiled", "interpreted")
# control flow, which the TPU package's compiled step lowers to lax
# primitives; not lowered here yet
_CONTROL = frozenset({"while", "conditional_block", "conditional_block_infer",
                      "select_input"})
_GUARD_ACTIONS = ("raise", "skip", "rollback")


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
def _op_reads_host_values(op) -> bool:
    """An op whose kernel reads the VALUES of a connected ``host_inputs``
    slot (registry) cannot be replayed by a CUDA graph."""
    info = resolve_base_info(op.type)
    return info is not None and any(op.inputs.get(s)
                                     for s in info.host_inputs)


def _op_is_stateful(op) -> bool:
    info = resolve_base_info(op.type)
    if info is None:
        return True  # unknown op: the interpreter raises with context
    return info.stateful


def _op_needs_rng(op_type: str) -> bool:
    info = resolve_base_info(op_type)
    return info.needs_rng if info is not None else False


def _ops_compilable(ops) -> bool:
    """True if every op has a pure kernel that reads no tensor value on
    the host; control flow is not compilable yet."""
    return not any(op.type in _CONTROL or _op_is_stateful(op)
                   or _op_reads_host_values(op) for op in ops)


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


def _no_checkpoint_plane(step: int) -> core.NumericFaultError:
    return core.NumericFaultError(
        f"FLAGS_nan_inf_action=rollback tripped at global step {step} but "
        "no checkpoint plane is configured: paddle_tpu_torch has no "
        "checkpoint save/load yet (use skip, or raise to localize)")


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
        self._scope_ref = weakref.ref(scope)
        self.program = program
        self.feed_names = tuple(feed_names)
        self.fetch_names = tuple(fetch_names)
        self.device = device
        block = program.global_block()
        self.ops = list(block.ops)
        state_names, written = _classify_block_state(
            self.ops, block, set(self.feed_names), scope)
        for n in self.fetch_names:
            if n in written or n in self.feed_names or n in state_names:
                continue
            if _scope_tensor(scope, n) is None:
                raise KeyError(f"fetch var '{n}' is not produced by the "
                               "program")
            state_names.append(n)  # fetched from the scope as it is
        self.written = written
        self.mut_state = tuple(n for n in state_names if n in written)
        self.ro_state = tuple(n for n in state_names if n not in written)
        persistable = {v.name for v in block.vars.values() if v.persistable}
        self.extra_writeback = tuple(sorted(
            n for n in written if n in persistable
            and n not in self.mut_state and n not in self.feed_names))
        self._init_guard(program, scope)
        self._remat_plan = None
        ropt = getattr(program, "_recompute_opt", None)
        if ropt:
            from .recompute_lowering import build_plan
            self._remat_plan = build_plan(self, ropt["checkpoints"])
        self._keys = _StepKeys(seed, _rng_indices(self.ops), device)
        self._units = self._build_plan()
        self.last_health: Optional[torch.Tensor] = None
        self._stream, self._pool = stream, pool
        self._graph = None
        self._static_feeds: Dict[str, torch.Tensor] = {}
        self._static_fetch: List[torch.Tensor] = []
        self._captured: Dict[str, torch.Tensor] = {}
        self._extra_targets: Dict[str, torch.Tensor] = {}
        self.graph_launches: Dict[str, int] = {}
        self.stats = {"eager": 0, "captures": 0, "replays": 0,
                      "capture_s": 0.0}
        self.last_exec: Optional[str] = None
        self._static_health: Optional[torch.Tensor] = None
        self._warned: set = set()

    def _build_plan(self) -> list:
        """Each op bound, in execution order (the program's, or the remat
        schedule), with liveness: a name that is neither fetched, written
        back nor read by the guard's health leaves the env after the last
        unit that reads or writes it. Under remat a segment's interior
        lives only inside its forward and its span."""
        steps = []
        for i, op in enumerate(self.ops):
            info, grad_of, ridx = _resolve(op, i)
            steps.append(_Step(op, info, grad_of, _kernel_attrs(
                op, info, ridx, self.device, self._keys)))
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
class Executor:
    """fluid.Executor (reference executor.py:457) on one device.

    ``place`` defaults to ``CUDAPlace(0)``. On a host without CUDA that
    raises: the CPU is used only when the caller passes ``CPUPlace()``.
    ``_last_run_mode`` says how the last run executed ("compiled" or
    "interpreted"), ``_last_block`` which ``_CompiledBlock`` ran it,
    ``_last_health`` the last guarded run's health on the device (a bool
    scalar, or [n_steps] for a compiled window)."""

    def __init__(self, place: Optional[Place] = None):
        self.place = CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        if self.device.type == "cuda":
            # f32 mul/matmul run in full f32, as in the TPU package: no
            # TF32 rounding of the operands
            torch.backends.cuda.matmul.allow_tf32 = False
        self._compiled_cache: Dict[tuple, _CompiledBlock] = {}
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

    def close(self):
        """Drop the compiled blocks with their CUDA graphs, the graphs'
        memory pool and the cached feeds: once nothing else holds them,
        ``torch.cuda.empty_cache()`` can return their memory."""
        self._compiled_cache.clear()
        self._last_block = None
        self._feed_cache.clear()
        self._stream = self._pool = None

    def graph_stats(self) -> Dict[str, float]:
        """Eager runs, captures, replays and capture seconds summed over
        the cached compiled blocks."""
        tot = {"blocks": len(self._compiled_cache), "eager": 0,
               "captures": 0, "replays": 0, "capture_s": 0.0}
        for cb in self._compiled_cache.values():
            for k, v in cb.stats.items():
                tot[k] += v
        return tot

    # ------------------------------------------------------------------
    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, feed_var_name="feed", fetch_var_name="fetch",
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_program_cache: bool = False, n_steps: int = 1):
        """Run ``program``'s global block. ``feed``: name → array;
        ``fetch_list``: Variables or names. Returns numpy arrays, or
        LoDTensors on the executor's device when ``return_numpy`` is
        False. ``feed_var_name``, ``fetch_var_name`` and
        ``use_program_cache`` are accepted for the reference signature and
        change nothing here: compiled blocks are always cached.

        ``n_steps`` > 1 runs that many steps as one window (the module
        docstring): windowed feeds ([n_steps, ...] stacks) give one slice
        to each step, the others feed every step; the compiled path and
        windowed feeds return every fetch stacked [n_steps, ...], the
        interpreter with the same feeds the final step's fetches. A feed
        with an int attribute ``k`` (the TPU package's WindowBatch) is k
        stacked batches: it sets ``n_steps``, or raises if ``n_steps``
        says otherwise."""
        program = default_main_program() if program is None else program
        scope = global_scope() if scope is None else scope
        feed = {} if feed is None else feed
        fetch_names = _to_fetch_names(fetch_list)
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
        check, action = _guard_flags()
        if (window_names and not compiled) or (
                compiled and n_steps > 1 and check and action == "raise"):
            # raise localizes a tripped step from exactly its pre-step
            # state: a window runs step by step (the reference's rule)
            return self._run_window_fallback(program, feed, fetch_list,
                                             scope, return_numpy, n_steps,
                                             window_names)
        if compiled:
            fetched = self._run_compiled(program, scope, feed, fetch_names,
                                         return_numpy, seed, n_steps,
                                         window_names)
            self._last_run_mode = "compiled"
            return fetched
        fetched = self._run_interpreted(program, scope, feed, fetch_names,
                                        return_numpy, seed, n_steps)
        self._last_run_mode = "interpreted"
        return fetched

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
                      seed, n_steps=1, window_names=()):
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
                core.globals_["FLAGS_nan_inf_action"]))
        cb = self._compiled_cache.get(key)
        # an id() of a dead scope can be reused by a new one: validate
        if cb is None or cb._scope_ref() is not scope:
            if self.device.type == "cuda" and self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            cb = _CompiledBlock(program, names, fetch_names, scope, seed,
                                self.device, self._stream, self._pool)
            self._compiled_cache[key] = cb
        self._last_block = cb
        if n_steps > 1 or window_names:
            fetched = cb.run_window(scope, feeds, window_names, n_steps,
                                    return_numpy)
        else:
            fetched = cb.run(scope, feeds, return_numpy)
        if cb._guard_active:
            self._last_health = cb.last_health
            self._act_on_health(cb, program, scope, feeds, seed)
        return fetched

    def _act_on_health(self, cb, program, scope, feeds, seed):
        """After a guarded compiled run: ``skip`` and AMP alone leave the
        health on the device; ``raise`` and ``rollback`` read it (after
        the fetches, so the stream has drained) and act on a tripped
        step, whose state the select has already put back."""
        if not cb._guard_check or cb._guard_action == "skip":
            return
        flags = cb.last_health.reshape(-1).tolist()
        if all(flags):
            return
        counter = _step_counter(scope, self.device)
        step = int(counter.item()) - len(flags) + flags.index(False)
        if cb._guard_action == "rollback":
            raise _no_checkpoint_plane(step)
        self._localize_and_raise(program, scope, feeds, seed, step)

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
            if guard is not None:
                self._interp_guard(guard, scope, snap, fetch_names,
                                   int(counter.item()) - 1)
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

    def _interp_guard(self, guard, scope, snap, fetch_names, step):
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
        if not healthy:
            for n, t in snap.items():
                scope.var(n).set_value(LoDTensor(t))
            if guard["check"] and guard["action"] == "rollback":
                raise _no_checkpoint_plane(step)

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
        info, grad_of, ridx = _resolve(op, idx)
        attrs = _kernel_attrs(op, info, ridx, self.device, keys)
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
        for slot, names in op.outputs.items():
            for n, val in zip(names, (outs or {}).get(slot) or []):
                if val is not None and n != _EMPTY:
                    scope.var(n).set_value(LoDTensor(val))
