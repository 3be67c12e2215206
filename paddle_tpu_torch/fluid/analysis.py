"""The Program verifier (counterpart of paddle_tpu/fluid/analysis.py:56-
614 and :798-916).

Dataflow analysis over ``framework.Program`` blocks that emits structured
``Diagnostic``s, by rule (the TPU package's ids):
  * ``def-before-use`` (error): an op reads a non-persistable var that is
    neither fed, data, state already in the scope, nor written by an
    earlier op;
  * ``missing-var-desc`` (error): an op references a var no block
    declares — a program serialized like that does not load;
  * ``undeclared-sub-block-read`` (warn): a sub-block reads an outer
    non-persistable var its parent op does not list in its inputs;
  * ``dtype-mismatch`` (warn): an elementwise, sum, concat or product op
    mixes input dtypes, or a cast's out_dtype is not its output's;
  * ``shape-mismatch`` (warn): ``mul`` or ``matmul`` contraction dims
    that disagree;
  * ``dead-op`` and ``dead-var`` (warn, with a known fetch list): an op
    whose outputs nothing reads, fetches or persists; a var no op uses;
  * ``donation-safety`` (error, with a segment plan): a plan that covers
    another op count than the program, or that donates a buffer a later
    op needs.
The ``dist-*`` and ``retrace-*`` rules need the PS plane and the mesh
(ROADMAP A8): ``verify_program`` emits none of them. ``enforce`` logs
each diagnostic and raises ``ProgramVerifyError`` at level "error" when
an error-severity one is present. ``maybe_verify`` is the executor's
choke point: behind ``FLAGS_program_verify`` ("" | "warn" | "error") it
verifies a program version once, at its first compile.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple)

from . import core

_LOG = logging.getLogger("paddle_tpu_torch.analysis")

__all__ = ["Diagnostic", "ProgramVerifyError", "verify_program", "enforce",
           "maybe_verify", "rule_ids", "RULE_SEVERITY"]


@dataclass(frozen=True)
class Diagnostic:
    """One structured finding. ``op_idx`` indexes ``block``'s op list
    (feed and fetch ops included); None for program-level findings."""

    rule: str
    severity: str                  # "error" | "warn"
    message: str
    block: int = 0
    op_idx: Optional[int] = None
    var: Optional[str] = None
    fix_hint: str = ""

    def format(self) -> str:
        loc = f"block {self.block}"
        if self.op_idx is not None:
            loc += f" op#{self.op_idx}"
        if self.var:
            loc += f" var '{self.var}'"
        s = f"[{self.severity}] {self.rule} @ {loc}: {self.message}"
        if self.fix_hint:
            s += f" (fix: {self.fix_hint})"
        return s


class ProgramVerifyError(RuntimeError):
    """Raised by level="error" enforcement when error-severity
    diagnostics are present; ``.diagnostics`` holds them all."""

    def __init__(self, diagnostics: Sequence[Diagnostic], where: str):
        self.diagnostics = list(diagnostics)
        errs = [d for d in self.diagnostics if d.severity == "error"]
        lines = "\n  ".join(d.format() for d in errs[:16])
        more = f"\n  ... and {len(errs) - 16} more" if len(errs) > 16 else ""
        super().__init__(
            f"program verification failed at '{where}' with "
            f"{len(errs)} error(s):\n  {lines}{more}")


# rule id -> default severity (the TPU package's stable ids)
RULE_SEVERITY = {
    "def-before-use": "error",
    "missing-var-desc": "error",
    "undeclared-sub-block-read": "warn",
    "dtype-mismatch": "warn",
    "shape-mismatch": "warn",
    "dead-op": "warn",
    "dead-var": "warn",
    "donation-safety": "error",
    "dist-local-sparse-grad": "error",
    "dist-barrier-pairing": "error",
    "dist-ps-round-tail": "warn",
    "retrace-partition-spec": "warn",
    "retrace-feed-shape": "warn",
}


def rule_ids() -> List[str]:
    return sorted(RULE_SEVERITY)


class _Ctx:
    def __init__(self, program, feed_names, fetch_names=None,
                 segment_plan=None, scope=None):
        self.program = program
        # a read-before-write var already initialized in the scope is
        # state, not a def-before-use fault (the executor's rule)
        self.scope = scope
        self.feed_names: Set[str] = set(feed_names or ())
        # None: the fetch list is unknown, and the dead-code rules skip
        # (an output nothing reads may be a later run's fetch target)
        self.fetch_known = fetch_names is not None
        self.fetch_names: Set[str] = set(fetch_names or ())
        self.segment_plan = segment_plan
        self.diags: List[Diagnostic] = []

    def emit(self, rule: str, message: str, *, block: int = 0,
             op_idx: Optional[int] = None, var: Optional[str] = None,
             fix_hint: str = "") -> None:
        self.diags.append(Diagnostic(
            rule=rule, severity=RULE_SEVERITY[rule], message=message,
            block=block, op_idx=op_idx, var=var, fix_hint=fix_hint))


def _sub_blocks(op) -> List[Any]:
    """Block-valued attrs of ``op`` (sub_block, optimize_blocks, ...)."""
    from .framework import Block
    subs: List[Any] = []
    for val in op.attrs.values():
        if isinstance(val, Block):
            subs.append(val)
        elif isinstance(val, (list, tuple)) and val \
                and isinstance(val[0], Block):
            subs.extend(val)
    return subs


def _is_loop_op(op_type: str) -> bool:
    # a loop body's write is visible at the top of the next iteration
    return op_type.startswith("while") or op_type.startswith("recurrent")


def _all_writes(block) -> Set[str]:
    written: Set[str] = set()
    stack = [block]
    while stack:
        b = stack.pop()
        for op in b.ops:
            written.update(op.output_arg_names)
            stack.extend(_sub_blocks(op))
    return written


def _reads_with_subs(op) -> Set[str]:
    names = set(op.input_arg_names)
    stack = list(_sub_blocks(op))
    while stack:
        b = stack.pop()
        for sop in b.ops:
            names.update(sop.input_arg_names)
            stack.extend(_sub_blocks(sop))
    return names


def _is_sentinel(name: str) -> bool:
    """Slot placeholders that never get a VarDesc: the backward's
    @EMPTY@ and the @DEPENDENCY control-dependency markers."""
    return name == "@EMPTY@" or name.startswith("@DEPENDENCY")


def _resolvable(block, name: str):
    """The VarDesc of ``name`` visible from ``block``, else any block's:
    the rule is about descs existing, not the exact block chain."""
    v = block._find_var_recursive(name)
    if v is not None:
        return v
    for b in block.program.blocks:
        if name in b.vars:
            return b.vars[name]
    return None


def _is_given(v) -> bool:
    return bool(getattr(v, "persistable", False)
                or getattr(v, "is_data", False)
                or getattr(v, "need_check_feed", False))


def _check_dataflow(ctx: _Ctx) -> None:
    defined: Set[str] = set(ctx.feed_names) | {"feed", "fetch"}
    _walk_block(ctx, ctx.program.global_block(), defined, in_loop=False,
                visited=set())


def _walk_block(ctx: _Ctx, block, defined: Set[str], in_loop: bool,
                visited: Set[int]) -> None:
    if id(block) in visited:
        return
    visited.add(id(block))
    local = set(defined)
    if in_loop:
        local |= _all_writes(block)
    reported: Set[str] = set()
    for idx, op in enumerate(block.ops):
        if op.type == "feed":
            local.update(op.output_arg_names)
            continue
        if op.type == "fetch":
            continue
        for name in op.input_arg_names:
            if _is_sentinel(name):
                continue
            v = _resolvable(block, name)
            if v is None:
                if name not in reported:
                    reported.add(name)
                    ctx.emit(
                        "missing-var-desc",
                        f"op '{op.type}' references '{name}' but no "
                        "VarDesc for it is reachable from this block: a "
                        "program serialized like this does not load",
                        block=block.idx, op_idx=idx, var=name,
                        fix_hint="declare the var in a visible block or "
                                 "stop dropping it from the saved program")
                continue
            if name in local or name in reported:
                continue
            if _is_given(v):
                local.add(name)
                continue
            if ctx.scope is not None:
                sv = ctx.scope.find_var(name)
                if sv is not None and sv.is_initialized():
                    local.add(name)
                    continue
            reported.add(name)
            ctx.emit(
                "def-before-use",
                f"op '{op.type}' reads non-persistable '{name}' before "
                "any producer wrote it (and it is not a feed/data var)",
                block=block.idx, op_idx=idx, var=name,
                fix_hint="feed it, mark it persistable state, or reorder "
                         "the producing op before this one")
        subs = _sub_blocks(op)
        if subs:
            declared = set(op.input_arg_names)
            sub_loop = in_loop or _is_loop_op(op.type)
            for sb in subs:
                _check_external_reads(ctx, op, block, sb, declared, sub_loop)
                _walk_block(ctx, sb, local, sub_loop, visited)
            for sb in subs:
                local |= _all_writes(sb)
        local.update(op.output_arg_names)


def _check_external_reads(ctx: _Ctx, op, block, sub, declared: Set[str],
                          sub_loop: bool) -> None:
    """A sub-block op that reads a non-persistable var of an outer block
    should find it in the parent op's input slots: prune and save reason
    about the parent op's declared interface."""
    produced: Set[str] = set()
    if sub_loop:
        produced |= _all_writes(sub)
    for sop in sub.ops:
        for name in sop.input_arg_names:
            if name in produced or name in declared or _is_sentinel(name) \
                    or name in sub.vars:
                continue
            v = _resolvable(sub, name)
            if v is None or _is_given(v):
                continue
            declared.add(name)        # once per parent op
            ctx.emit(
                "undeclared-sub-block-read",
                f"sub-block op '{sop.type}' reads outer var '{name}' "
                f"that parent op '{op.type}' does not declare in its "
                "input slots",
                block=sub.idx, var=name,
                fix_hint="add the var to the parent op's input slots so "
                         "prune/save interface analysis sees the read")
        produced.update(sop.output_arg_names)



# --------------------------------------------------------------------------
# rule: dtype / shape propagation
# --------------------------------------------------------------------------
_SAME_DTYPE_OPS = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_pow", "elementwise_min",
    "elementwise_max", "sum", "concat", "mul", "matmul", "matmul_v2",
})


def _np_dtype_name(dtype) -> Optional[str]:
    try:
        import numpy as np
        return np.dtype(core.dtype_to_np(dtype)).name
    except Exception:
        return None


def _static_dims(shape) -> Optional[Tuple[int, ...]]:
    if shape is None:
        return None
    t = tuple(int(d) for d in shape)
    return t if t else None


def _check_dtype_shape(ctx: _Ctx) -> None:
    for block in ctx.program.blocks:
        for idx, op in enumerate(block.ops):
            if op.type in _SAME_DTYPE_OPS:
                _check_same_dtype(ctx, block, idx, op)
            if op.type == "cast":
                _check_cast(ctx, block, idx, op)
            if op.type == "mul":
                _check_mul_shape(ctx, block, idx, op)
            elif op.type in ("matmul", "matmul_v2"):
                _check_matmul_shape(ctx, block, idx, op)


def _check_same_dtype(ctx: _Ctx, block, idx, op) -> None:
    seen: Dict[str, str] = {}
    for slot in ("X", "Y"):
        for name in op.input(slot):
            v = _resolvable(block, name)
            dt = _np_dtype_name(getattr(v, "dtype", None)) if v else None
            if dt is not None:
                seen[name] = dt
    kinds = set(seen.values())
    if len(kinds) > 1:
        detail = ", ".join(f"{n}:{d}" for n, d in sorted(seen.items()))
        ctx.emit(
            "dtype-mismatch",
            f"op '{op.type}' mixes input dtypes ({detail}) — the kernel "
            "will silently promote what the reference validates at AddOp "
            "time",
            block=block.idx, op_idx=idx, var=next(iter(seen)),
            fix_hint="insert an explicit cast op")


def _check_cast(ctx: _Ctx, block, idx, op) -> None:
    outs = op.output("Out")
    if not outs:
        return
    v = _resolvable(block, outs[0])
    want = op.attr("out_dtype")
    if v is None or want is None or v.dtype is None:
        return
    a, b = _np_dtype_name(v.dtype), _np_dtype_name(want)
    if a and b and a != b:
        ctx.emit(
            "dtype-mismatch",
            f"cast declares out_dtype={b} but output var '{outs[0]}' is "
            f"declared {a}",
            block=block.idx, op_idx=idx, var=outs[0],
            fix_hint="align the var desc dtype with the cast attr")


def _flat_dim(shape: Tuple[int, ...], start: int, stop: int) -> int:
    """Product of dims [start:stop); -1 (unknown) poisons to -1."""
    prod = 1
    for d in shape[start:stop]:
        if d <= 0:
            return -1
        prod *= d
    return prod


def _check_mul_shape(ctx: _Ctx, block, idx, op) -> None:
    xs, ys = op.input("X"), op.input("Y")
    if not xs or not ys:
        return
    xv, yv = _resolvable(block, xs[0]), _resolvable(block, ys[0])
    xsh = _static_dims(getattr(xv, "shape", None)) if xv else None
    ysh = _static_dims(getattr(yv, "shape", None)) if yv else None
    if not xsh or not ysh:
        return
    xn = int(op.attr("x_num_col_dims") or 1)
    yn = int(op.attr("y_num_col_dims") or 1)
    inner_x = _flat_dim(xsh, xn, len(xsh))
    inner_y = _flat_dim(ysh, 0, yn)
    if inner_x > 0 and inner_y > 0 and inner_x != inner_y:
        ctx.emit(
            "shape-mismatch",
            f"mul inner dims disagree: {xs[0]}{list(xsh)} flattened at "
            f"x_num_col_dims={xn} gives K={inner_x}, {ys[0]}{list(ysh)} "
            f"gives K={inner_y}",
            block=block.idx, op_idx=idx, var=xs[0],
            fix_hint="fix the weight shape or the num_col_dims attrs")


def _check_matmul_shape(ctx: _Ctx, block, idx, op) -> None:
    xs, ys = op.input("X"), op.input("Y")
    if not xs or not ys:
        return
    xv, yv = _resolvable(block, xs[0]), _resolvable(block, ys[0])
    xsh = _static_dims(getattr(xv, "shape", None)) if xv else None
    ysh = _static_dims(getattr(yv, "shape", None)) if yv else None
    if not xsh or not ysh or len(xsh) < 2 or len(ysh) < 2:
        return
    tx = bool(op.attr("transpose_X") or op.attr("trans_x"))
    ty = bool(op.attr("transpose_Y") or op.attr("trans_y"))
    kx = xsh[-2] if tx else xsh[-1]
    ky = ysh[-1] if ty else ysh[-2]
    if kx > 0 and ky > 0 and kx != ky:
        ctx.emit(
            "shape-mismatch",
            f"matmul contraction dims disagree: {xs[0]}{list(xsh)} "
            f"(transpose_X={tx}) K={kx} vs {ys[0]}{list(ysh)} "
            f"(transpose_Y={ty}) K={ky}",
            block=block.idx, op_idx=idx, var=xs[0],
            fix_hint="fix the operand shapes or transpose attrs")


# --------------------------------------------------------------------------
# rule: dead ops / dead vars
# --------------------------------------------------------------------------
def _op_has_side_effects(op) -> bool:
    from .ir import op_island_reason
    # island ops (stateful kernels, host-input readers, control flow,
    # unregistered types) and the distributed data-plane ops act beyond
    # their declared outputs — never dead
    return op_island_reason(op) is not None


def _check_dead(ctx: _Ctx) -> None:
    if not ctx.fetch_known:
        # consumer-less outputs may be fetch targets of a later run — the
        # fetch list is not part of the program (ir.Graph.is_internal)
        return
    block = ctx.program.global_block()
    indexed = [(i, op) for i, op in enumerate(block.ops)
               if op.type not in ("feed", "fetch")]
    live_names = set(ctx.fetch_names)
    keep = {}
    persistable = {n for n, v in block.vars.items()
                   if getattr(v, "persistable", False)}
    for i, op in indexed:
        if _op_has_side_effects(op) \
                or any(n in persistable for n in op.output_arg_names):
            keep[i] = True
    for i, op in reversed(indexed):
        if keep.get(i) or (set(op.output_arg_names) & live_names):
            keep[i] = True
            live_names.update(_reads_with_subs(op))
    for i, op in indexed:
        if not keep.get(i):
            outs = op.output_arg_names
            if op.type.endswith("_grad") or (
                    outs and all(o.endswith("@GRAD") or o == "@EMPTY@"
                                 for o in outs)):
                # mechanically generated backward ops compute grads for
                # EVERY differentiable input, and append_backward seeds
                # a fill for every loss grad; unconsumed leaf grads and
                # seeds over severed grad paths are the backward's
                # contract, not dead code anyone wrote
                continue
            ctx.emit(
                "dead-op",
                f"op '{op.type}' outputs "
                f"{sorted(op.output_arg_names)[:4]} are never read, "
                "fetched, or persisted",
                block=0, op_idx=i,
                var=(op.output_arg_names[0] if op.output_arg_names
                     else None),
                fix_hint="remove the op or fetch its output")

    referenced: Set[str] = set()
    for b in ctx.program.blocks:
        for op in b.ops:
            referenced.update(op.input_arg_names)
            referenced.update(op.output_arg_names)
    for name, v in block.vars.items():
        if name in referenced or name in ("feed", "fetch"):
            continue
        if getattr(v, "persistable", False) or getattr(v, "is_data", False):
            continue
        if name in ctx.feed_names or name in ctx.fetch_names:
            continue
        ctx.emit(
            "dead-var",
            f"var '{name}' is referenced by no op in any block",
            block=0, var=name,
            fix_hint="drop it (ir.Graph.drop_orphan_vars) or wire it up")


# --------------------------------------------------------------------------
# rule: donation safety (cross-checked against a segment plan)
# --------------------------------------------------------------------------
def _plan_entry(seg) -> Dict[str, Any]:
    if isinstance(seg, dict):
        return {"kind": seg.get("kind"), "start": int(seg.get("start", 0)),
                "stop": int(seg.get("stop", 0)),
                "n_ops": int(seg.get("stop", 0)) - int(seg.get("start", 0)),
                "out_names": tuple(seg.get("out_names", ()) or ()),
                "donated_names": tuple(seg.get("donated_names", ()) or ())}
    return {"kind": seg.kind, "start": seg.start, "stop": seg.stop,
            "n_ops": len(seg.ops),
            "out_names": tuple(getattr(seg, "out_names", ()) or ()),
            "donated_names": tuple(getattr(seg, "donated_names", ()) or ())}


def _check_donation(ctx: _Ctx) -> None:
    """A buffer a compiled segment donates is gone once the segment runs:
    a later consumer must read the segment's output, so the name must be
    on its out list. Cross-checks the plan the segmented executor built
    (or an ``ir.analyze_block_segments`` summary with out/donated names)
    against the CURRENT program: a plan that covers another op count is
    stale. The port's segments donate nothing (a CUDA graph's buffers
    live in the executor's pool), so on its own plans only the coverage
    check can fire."""
    if ctx.segment_plan is None:
        return
    block = ctx.program.global_block()
    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    segs = [_plan_entry(s) for s in ctx.segment_plan]
    covered = sum(s["n_ops"] for s in segs)
    if covered != len(ops):
        ctx.emit(
            "donation-safety",
            f"segment plan covers {covered} ops but the program has "
            f"{len(ops)} — the program changed since the plan was built, "
            "so donation/liveness decisions are stale",
            fix_hint="rebuild the segment plan (bump program version and "
                     "let the executor recompile) before running")
        return
    guard_select = (core.globals_["FLAGS_check_nan_inf"]
                    and core.globals_["FLAGS_nan_inf_action"]
                    in ("skip", "rollback"))
    persistable = {n for n, v in block.vars.items()
                   if getattr(v, "persistable", False)}
    for seg in segs:
        if seg["kind"] != "compiled" or not seg["donated_names"]:
            continue
        if guard_select:
            ctx.emit(
                "donation-safety",
                f"segment [{seg['start']}:{seg['stop']}) donates "
                f"{list(seg['donated_names'])[:4]} while the numeric "
                "fault guard's select action needs the pre-step buffers "
                "alive until the end-of-step discard",
                fix_hint="build the plan with per-segment donation "
                         "disabled under skip/rollback actions")
            continue
        out = set(seg["out_names"])
        later_reads: Set[str] = set()
        for op in ops[seg["stop"]:]:
            later_reads |= _reads_with_subs(op)
        for n in seg["donated_names"]:
            needed = (n in later_reads or n in ctx.fetch_names
                      or n in persistable)
            if needed and n not in out:
                ctx.emit(
                    "donation-safety",
                    f"'{n}' is donated (buffer deleted) by segment "
                    f"[{seg['start']}:{seg['stop']}) but a later "
                    "op/island, the fetch list, or the persistable "
                    "writeback still needs it and it is not among the "
                    "segment's outputs",
                    var=n,
                    fix_hint="return the updated value from the segment "
                             "(out_names) or stop donating the buffer")


_CHECKS: List[Callable[[_Ctx], None]] = [
    _check_dataflow,
    _check_dtype_shape,
    _check_dead,
    _check_donation,
]


def verify_program(program, *, feed_names: Iterable[str] = (),
                   fetch_names: Optional[Iterable[str]] = None,
                   segment_plan: Optional[Sequence[Any]] = None,
                   rules: Optional[Iterable[str]] = None,
                   where: str = "api", scope=None) -> List[Diagnostic]:
    """The diagnostics of every ported rule over ``program`` (pure: no
    logging and no raising; ``enforce`` and ``maybe_verify`` apply the
    policy). ``fetch_names=None``: the fetch list is unknown, and the
    dead-code rules skip. ``segment_plan`` (a segmented block's
    ``segments``, or dicts with kind/start/stop/out_names/donated_names)
    turns on the donation-safety cross-check. ``rules`` filters to a
    subset of ``rule_ids()``; ``where`` names the caller, as in the TPU
    package."""
    ctx = _Ctx(program, feed_names, fetch_names, segment_plan, scope=scope)
    for check in _CHECKS:
        check(ctx)
    diags = ctx.diags
    if rules is not None:
        wanted = set(rules)
        diags = [d for d in diags if d.rule in wanted]
    return diags


def enforce(diags: Sequence[Diagnostic], level: str,
            where: str = "api") -> List[Diagnostic]:
    """Log every diagnostic as a warning and raise ``ProgramVerifyError``
    at level="error" when an error-severity diagnostic exists."""
    if level not in ("warn", "error"):
        raise ValueError(
            f"verify level must be 'warn' or 'error', got {level!r}")
    for d in diags:
        _LOG.warning("program-verify[%s]: %s", where, d.format())
    if level == "error" and any(d.severity == "error" for d in diags):
        raise ProgramVerifyError(diags, where)
    return list(diags)


def maybe_verify(program, where: str, *, feed_names: Iterable[str] = (),
                 fetch_names: Optional[Iterable[str]] = None,
                 segment_plan: Optional[Sequence[Any]] = None,
                 level: Optional[str] = None, scope=None
                 ) -> Optional[List[Diagnostic]]:
    """The executor's choke point (the TPU package's :877): verify
    ``program`` once per (program version, ``where``) when
    ``FLAGS_program_verify`` (or ``level``) is "warn" or "error"; "" does
    nothing. A failure at "error" is not cached, so a retry verifies and
    raises again. → the diagnostics, or None when nothing ran."""
    if level is None:
        level = str(core.globals_["FLAGS_program_verify"] or "")
    if not level:
        return None
    if level not in ("warn", "error"):
        raise ValueError(
            f"FLAGS_program_verify must be ''|'warn'|'error', "
            f"got {level!r}")
    cache = program.__dict__.setdefault("_verify_versions", {})
    key = (program._version, where)
    if key in cache:
        return None
    diags = verify_program(program, feed_names=feed_names,
                           fetch_names=fetch_names,
                           segment_plan=segment_plan, where=where,
                           scope=scope)
    enforce(diags, level, where)   # raises before caching on error
    cache[key] = len(diags)
    return diags
