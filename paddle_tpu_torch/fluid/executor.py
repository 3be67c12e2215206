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
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import core
from .core import CUDAPlace, LoDTensor, Place, Scope, global_scope
from .framework import Program, Variable, default_main_program
from ..ops import rng
from ..ops.registry import OPS, resolve_base_info, run_generic_grad

__all__ = ["Executor", "global_scope", "scope_guard"]

_RNG_COUNTER = "@RNG_COUNTER@"
_EMPTY = "@EMPTY@"  # append_backward's name for "no var in this slot"
_MODES = ("compiled", "interpreted")
# control flow, which the TPU package's compiled step lowers to lax
# primitives; not lowered here yet
_CONTROL = frozenset({"while", "conditional_block", "conditional_block_infer",
                      "select_input"})


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


class _Step:
    """One op of a plan, bound: its kernel (or the forward op whose
    generic grad it is), attrs, input and output names, and the names to
    drop from the env after it."""

    __slots__ = ("kernel", "grad_of", "attrs", "ins", "outs", "frees",
                 "wanted", "fwd_in")

    def __init__(self, op, info, grad_of, attrs, frees):
        self.kernel = info.kernel
        self.grad_of = grad_of
        self.attrs = attrs
        self.ins = tuple((s, tuple(n)) for s, n in op.inputs.items())
        self.outs = tuple((s, tuple(n)) for s, n in op.outputs.items())
        self.frees = tuple(frees)
        self.wanted = list(op.outputs)
        self.fwd_in = attrs.get("_fwd_in", list(op.inputs))


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
    launches recorded in the graph, i.e. launched by each replay."""

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
        self._keys = _StepKeys(seed, _rng_indices(self.ops), device)
        self._plan = self._build_plan()
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

    def _build_plan(self) -> List[_Step]:
        """Each op bound, with liveness: a name that is neither fetched
        nor written back leaves the env after the last op that reads or
        writes it."""
        keep = set(self.fetch_names) | set(self.mut_state) \
            | set(self.extra_writeback)
        last: Dict[str, int] = {}
        for i, op in enumerate(self.ops):
            for n in op.input_arg_names + op.output_arg_names:
                last[n] = i
        frees: List[List[str]] = [[] for _ in self.ops]
        for n, i in last.items():
            if n not in keep and n != _EMPTY:
                frees[i].append(n)
        plan = []
        for i, op in enumerate(self.ops):
            info, grad_of, ridx = _resolve(op, i)
            plan.append(_Step(op, info, grad_of, _kernel_attrs(
                op, info, ridx, self.device, self._keys), frees[i]))
        return plan

    # ---------------------------------------------------------- one step
    def _exec_ops(self, env: Dict[str, torch.Tensor]):
        for st in self._plan:
            ins = {s: [env.get(n) for n in names] for s, names in st.ins}
            if st.grad_of is None:
                outs = st.kernel(ins, st.attrs)
            else:
                outs = run_generic_grad(st.grad_of, ins, st.attrs,
                                        wanted_grad_slots=st.wanted,
                                        fwd_input_slots=st.fwd_in)
            outs = outs or {}
            for slot, names in st.outs:
                for n, v in zip(names, outs.get(slot) or []):
                    if v is not None and n != _EMPTY:
                        env[n] = v
            for n in st.frees:
                env.pop(n, None)

    def _step(self, feeds, state, counter):
        """The plan once over a local env → (fetches, {name: new value}
        of the state and persistables to write back). Adds one to the
        step counter."""
        env = dict(state)
        env.update(feeds)
        self._keys.begin(counter)
        try:
            self._exec_ops(env)
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
        return fetches, new

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
        LoDTensors the caller owns."""
        if self._stream is None:  # the CPU: no graph
            fetched = self._run_eager(scope, feeds)
        else:
            cur = torch.cuda.current_stream(self.device)
            # the side stream waits for the current one: for the feeds,
            # and for the last run's fetches to be read before a replay
            # overwrites them
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                if self._graph is None and not self.stats["eager"]:
                    fetched = self._run_eager(scope, feeds)
                else:
                    fetched = self._run_graph(scope, feeds)
                if not return_numpy:
                    # a later replay overwrites graph outputs and updates
                    # the state in place
                    fetched = [t.clone() for t in fetched]
            cur.wait_stream(self._stream)
            for t in fetched:
                t.record_stream(cur)
        if return_numpy:
            return [LoDTensor(t).numpy() for t in fetched]
        return [LoDTensor(t) for t in fetched]

    def _run_eager(self, scope, feeds):
        dev_feeds = {n: t.to(self.device) for n, t in feeds.items()}
        for n, t in dev_feeds.items():
            scope.var(n).set_value(LoDTensor(t))
        fetches, new = self._step(dev_feeds, self._read_state(scope),
                                  _step_counter(scope, self.device))
        for n, v in new.items():
            scope.var(n).set_value(LoDTensor(v))
        self.stats["eager"] += 1
        self.last_exec = "eager"
        return fetches

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
        return self._static_fetch

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
            fetches, new = self._step(self._static_feeds, state, counter)
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
        self._captured, self._extra_targets = {}, {}


# --------------------------------------------------------------------------
class Executor:
    """fluid.Executor (reference executor.py:457) on one device.

    ``place`` defaults to ``CUDAPlace(0)``. On a host without CUDA that
    raises: the CPU is used only when the caller passes ``CPUPlace()``.
    ``_last_run_mode`` says how the last run executed ("compiled" or
    "interpreted"), ``_last_block`` which ``_CompiledBlock`` ran it."""

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
        # one side stream for every warm-up, capture and replay, and one
        # memory pool shared by this executor's graphs: they replay one
        # at a time, and each run copies its fetches out
        self._stream = None
        self._pool = None

    def close(self):
        self._compiled_cache.clear()
        self._last_block = None

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
            use_program_cache: bool = False):
        """Run ``program``'s global block once. ``feed``: name → array;
        ``fetch_list``: Variables or names. Returns numpy arrays, or
        LoDTensors on the executor's device when ``return_numpy`` is
        False. ``feed_var_name``, ``fetch_var_name`` and
        ``use_program_cache`` are accepted for the reference signature and
        change nothing here: compiled blocks are always cached."""
        program = default_main_program() if program is None else program
        scope = global_scope() if scope is None else scope
        feed = feed or {}
        fetch_names = _to_fetch_names(fetch_list)
        seed = int(program.random_seed or core.globals_["FLAGS_seed"])
        mode = core.globals_["FLAGS_executor_mode"]
        if mode not in _MODES:
            raise ValueError(f"FLAGS_executor_mode={mode!r}: expected one "
                             f"of {_MODES}")
        if mode == "compiled" and self._is_compilable(program):
            fetched = self._run_compiled(program, scope, feed, fetch_names,
                                         return_numpy, seed)
            self._last_run_mode = "compiled"
            return fetched
        fetched = self._run_interpreted(program, scope, feed, fetch_names,
                                        return_numpy, seed)
        self._last_run_mode = "interpreted"
        return fetched

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

    def _to_device(self, block, name: str, data) -> torch.Tensor:
        return self._feed_tensor(block, name, data).to(self.device)

    def _run_compiled(self, program, scope, feed, fetch_names, return_numpy,
                      seed):
        block = program.global_block()
        for n, d in feed.items():
            if isinstance(d, LoDTensor) and d.lod():
                raise NotImplementedError(
                    f"feed '{n}' carries LoD: the compiled step of "
                    "paddle_tpu_torch takes dense feeds only (run with "
                    "FLAGS_executor_mode=interpreted)")
        feeds = {n: self._feed_tensor(block, n, d) for n, d in feed.items()}
        names = tuple(sorted(feeds))
        key = (id(program), program._version, names, tuple(fetch_names),
               id(scope),
               tuple((n, tuple(feeds[n].shape), feeds[n].dtype)
                     for n in names),
               seed, core.globals_["FLAGS_use_bf16_matmul"])
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
        return cb.run(scope, feeds, return_numpy)

    # ------------------------------------------------------- interpreter
    def _run_interpreted(self, program, scope, feed, fetch_names,
                         return_numpy, seed):
        block = program.global_block()
        for name, data in feed.items():
            scope.var(name).set_value(
                LoDTensor(self._to_device(block, name, data)))
        self._check_inputs(block, scope, set(feed))
        keys = _StepKeys(seed, _rng_indices(block.ops), self.device)
        keys.begin(_step_counter(scope, self.device))
        for idx, op in enumerate(block.ops):
            self._run_op(op, idx, scope, keys)
        keys.counter.add_(1)
        keys.end()
        fetched = []
        for n in fetch_names:
            v = scope.find_var(n)
            if v is None or not v.is_initialized():
                raise KeyError(f"fetch var '{n}' not found in scope")
            t = v.value()
            fetched.append(t.numpy() if return_numpy else t)
        return fetched

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

    def _run_op(self, op, idx: int, scope: Scope, keys: _StepKeys):
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
        for slot, names in op.outputs.items():
            for n, val in zip(names, (outs or {}).get(slot) or []):
                if val is not None and n != _EMPTY:
                    scope.var(n).set_value(LoDTensor(val))
