"""The Program verifier, the part ``io.save_inference_model`` enforces
(counterpart of paddle_tpu/fluid/analysis.py:56-330 and :808-890).

Dataflow analysis over ``framework.Program`` blocks that emits structured
``Diagnostic``s. Ported so far, the dataflow rules (``_check_dataflow``,
the TPU package's :218):
  * ``def-before-use`` (error): an op reads a non-persistable var that is
    neither fed, data, state already in the scope, nor written by an
    earlier op;
  * ``missing-var-desc`` (error): an op references a var no block
    declares — a program serialized like that does not load;
  * ``undeclared-sub-block-read`` (warn): a sub-block reads an outer
    non-persistable var its parent op does not list in its inputs.
The other rule ids of ``RULE_SEVERITY`` (dtype and shape propagation,
dead code, donation safety, the distributed and retrace rules) are not
ported: ``verify_program`` emits none of them. ``enforce`` logs each
diagnostic and raises ``ProgramVerifyError`` at level "error" when an
error-severity one is present.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional, Sequence, Set

_LOG = logging.getLogger("paddle_tpu_torch.analysis")

__all__ = ["Diagnostic", "ProgramVerifyError", "verify_program", "enforce",
           "RULE_SEVERITY"]


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


class _Ctx:
    def __init__(self, program, feed_names, scope=None):
        self.program = program
        # a read-before-write var already initialized in the scope is
        # state, not a def-before-use fault (the executor's rule)
        self.scope = scope
        self.feed_names: Set[str] = set(feed_names or ())
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


_CHECKS: List[Callable[[_Ctx], None]] = [_check_dataflow]


def verify_program(program, *, feed_names: Iterable[str] = (),
                   fetch_names: Optional[Iterable[str]] = None,
                   rules: Optional[Iterable[str]] = None,
                   where: str = "api", scope=None) -> List[Diagnostic]:
    """The diagnostics of every ported rule over ``program`` (pure: no
    logging and no raising; ``enforce`` applies the policy).
    ``fetch_names`` and ``where`` are the TPU package's signature; no
    ported rule reads them. ``rules`` filters to a subset of
    ``RULE_SEVERITY``'s ids."""
    ctx = _Ctx(program, feed_names, scope=scope)
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
