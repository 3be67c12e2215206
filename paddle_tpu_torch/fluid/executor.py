"""Executor (counterpart of paddle_tpu/fluid/executor.py; reference:
python/paddle/fluid/executor.py:457).

This package has the interpreter path only (the TPU package's
``_run_block_eager`` / ``_run_op_eager_impl``, executor.py:2625-2704): the
ops of the global block run in order over the scope, one kernel call each,
with feeds and fetches as plain dicts and lists. A ``<op>_grad`` op that
no kernel is registered for runs through the generic grad
(``ops.registry.run_generic_grad``), which re-runs the forward kernel under
autograd. Every intermediate and every grad stays in the scope until the
next run overwrites it. The compiled step, segmentation, step windows and
NaN guards come in later slices.

Randomness: each run advances a per-scope step counter, and each op that
declares ``needs_rng`` gets ``attrs["_rng"]``, a callable that returns a
``torch.Generator`` on the executor's device seeded from (program seed,
step, op index) — the counterpart of
``jax.random.fold_in(fold_in(key(seed), step), idx)``. The generator is
built on the first call only, so an op that draws nothing (attention at
dropout 0) costs no generator. An op with a nonzero ``seed`` attr (or
``fix_seed``) is seeded from that attr alone. The grad op of a random op
gets the generator of its forward op's index (``_fwd_idx``): the re-run
forward draws what the forward drew — for attention, the same dropout
seed, so the backward kernels regenerate the forward's mask.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from . import core
from .core import CUDAPlace, LoDTensor, Place, Scope, global_scope
from .framework import Program, Variable, default_main_program
from ..ops.registry import OPS, run_generic_grad

__all__ = ["Executor", "global_scope", "scope_guard"]

_RNG_COUNTER = "@RNG_COUNTER@"
_EMPTY = "@EMPTY@"  # append_backward's name for "no var in this slot"
_M64 = (1 << 64) - 1


@contextlib.contextmanager
def scope_guard(scope: Scope):
    old = core._switch_scope(scope)
    try:
        yield
    finally:
        core._switch_scope(old)


def _mix64(*vals: int) -> int:
    """splitmix64 over the values: one 63-bit generator seed per
    (program seed, step, op index)."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = (h ^ (int(v) & _M64)) * 0xBF58476D1CE4E5B9 & _M64
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & _M64
        h ^= h >> 31
    return h >> 1


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


class Executor:
    """fluid.Executor (reference executor.py:457) on one device.

    ``place`` defaults to ``CUDAPlace(0)``. On a host without CUDA that
    raises: the CPU is used only when the caller passes ``CPUPlace()``."""

    def __init__(self, place: Optional[Place] = None):
        self.place = CUDAPlace(0) if place is None else place
        self.device = self.place.torch_device()
        if self.device.type == "cuda":
            # f32 mul/matmul run in full f32, as in the TPU package: no
            # TF32 rounding of the operands
            torch.backends.cuda.matmul.allow_tf32 = False

    def close(self):
        pass

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
        change nothing here."""
        program = default_main_program() if program is None else program
        scope = global_scope() if scope is None else scope
        block = program.global_block()
        for name, data in (feed or {}).items():
            scope.var(name).set_value(
                LoDTensor(self._to_device(block, name, data)))
        fetch_names = _to_fetch_names(fetch_list)
        self._check_inputs(block, scope, set(feed or ()))
        step = self._advance_step(scope)
        seed = int(program.random_seed or core.globals_["FLAGS_seed"])
        for idx, op in enumerate(block.ops):
            self._run_op(op, scope, seed, step, idx)
        fetched = []
        for n in fetch_names:
            v = scope.find_var(n)
            if v is None or not v.is_initialized():
                raise KeyError(f"fetch var '{n}' not found in scope")
            t = v.value()
            fetched.append(t.numpy() if return_numpy else t)
        return fetched

    # ------------------------------------------------------------------
    def _to_device(self, block, name: str, data) -> torch.Tensor:
        if isinstance(data, LoDTensor):
            data = data.array
        t = data if isinstance(data, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(data)))
        var = block._find_var_recursive(name)
        want = core.dtype_to_torch(var.dtype) if var is not None else t.dtype
        return t.to(device=self.device, dtype=want)

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

    @staticmethod
    def _advance_step(scope: Scope) -> int:
        v = scope.var(_RNG_COUNTER)
        step = v.value() or 0
        v.set_value(step + 1)
        return step

    def _generator(self, attrs, seed: int, step: int, idx: int):
        g = torch.Generator(device=self.device)
        if attrs.get("fix_seed", False) or attrs.get("seed", 0):
            g.manual_seed(int(attrs.get("seed", 0)))
        else:
            g.manual_seed(_mix64(seed, step, idx))
        return g

    def _lazy_generator(self, attrs, seed: int, step: int, idx: int):
        gen = []

        def rng():
            if not gen:
                gen.append(self._generator(attrs, seed, step, idx))
            return gen[0]
        return rng

    def _run_op(self, op, scope: Scope, seed: int, step: int, idx: int):
        otype = op.type
        attrs = op.attrs
        grad_of = None  # the forward op type whose generic grad this is
        if OPS.has(otype):
            info, rng_idx = OPS.get(otype), idx
        elif otype.endswith("_grad") and OPS.has(otype[:-5]):
            grad_of = otype[:-5]
            info = OPS.get(grad_of)
            rng_idx = int(attrs.get("_fwd_idx", idx))
        else:
            raise NotImplementedError(f"op '{otype}' is not implemented "
                                      "in paddle_tpu_torch yet")
        if info.needs_rng or info.needs_device:
            attrs = dict(attrs)
            attrs["_device"] = self.device
            if info.needs_rng:
                attrs["_rng"] = self._lazy_generator(attrs, seed, step,
                                                     rng_idx)
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
