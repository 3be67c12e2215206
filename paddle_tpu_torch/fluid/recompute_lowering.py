"""Lower RecomputeOptimizer checkpoints onto remat segments on torch
autograd (counterpart of paddle_tpu/fluid/recompute_lowering.py).

The reference rewrites the backward program to re-run forward subgraphs
between user-chosen checkpoint variables, so activations inside a segment
are never stored (reference: python/paddle/fluid/optimizer.py
RecomputeOptimizer:3850, backward.py _append_backward_ops_with_
checkpoints_). Here the lowering happens in the compiled step's execution
order (``schedule``; the TPU package's ``exec_plan``):

  * a segment's forward runs under ``torch.no_grad()`` in an env of its
    own, and only its boundary values (``seg.outs``) leave it, so its
    interior is freed at the segment's end;
  * at the segment's backward span, the segment's ops run again under
    ``torch.enable_grad()`` from its inputs (those whose grad the span's
    ops wrote require grad), and ``torch.autograd.grad`` pulls the
    boundary grads back to them; the span's own grad ops do not run.

Lowering preconditions (else the step runs without remat, with a warning:
same numerics, more memory):
  * checkpoints are produced in the main block, no control flow inside
    a segment, and no op inside a segment draws random bits
  * every external input of a segment (params, earlier activations)
    receives its gradient ONLY from that segment's backward span, and
    the spans are contiguous per segment in reverse order — shared
    params across segments would fan-in through rename/sum ops the span
    classifier cannot split

The interpreter does not remat.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import torch

from ..ops.registry import grad_var_name
from .executor import _op_needs_rng, exec_units, set_liveness

__all__ = ["build_plan", "schedule", "SegmentForward", "Span"]


class Segment:
    def __init__(self):
        self.ops = []
        self.ins: List[str] = []     # external reads, in first-use order
        self.outs: List[str] = []    # written AND read outside


class RematPlan:
    def __init__(self):
        self.pre_ops = []            # ops before the first segment
        self.segments: List[Segment] = []
        self.rest_head = []          # loss head + its bwd (after last seg)
        self.spans: List[List] = []  # per segment: replaced bwd ops
        self.between: List[List] = []  # rest ops between spans (reverse)
        self.span_order: List[int] = []  # segment index per span, in order
        self.tail_ops = []           # pre-segment bwd + optimizer ops


def _fallback(reason):
    warnings.warn(
        f"RecomputeOptimizer checkpoints not lowerable onto "
        f"remat segments ({reason}); executing without "
        f"rematerialization (same numerics, more memory)", stacklevel=3)
    return None


def build_plan(cb, ckpt_names) -> Optional[RematPlan]:
    ops = cb.ops
    producer = {}
    for i, op in enumerate(ops):
        for n in op.output_arg_names:
            producer.setdefault(n, i)
    missing = [c for c in ckpt_names if c not in producer]
    if missing:
        return _fallback(f"checkpoint vars {missing} not produced")
    cks = sorted(set(ckpt_names), key=lambda c: producer[c])
    # find where the forward ends: the loss-grad seed fill_constant is
    # the first op whose outputs are all @GRAD names
    fwd_end = len(ops)
    for i, op in enumerate(ops):
        outs = op.output_arg_names
        if outs and all("@GRAD" in n for n in outs):
            fwd_end = i
            break
    bounds = [producer[c] + 1 for c in cks]
    if bounds[-1] > fwd_end:
        return _fallback("a checkpoint is produced by a backward op")

    plan = RematPlan()
    # segments live BETWEEN checkpoints: the region up to the first
    # checkpoint stays un-remat'ed (its inputs are the feeds; storing
    # them is free), matching the reference's use of checkpoints as
    # segment boundaries
    plan.pre_ops = ops[:bounds[0]]
    seg_ranges = [(bounds[i], bounds[i + 1])
                  for i in range(len(bounds) - 1)]
    if bounds[-1] < fwd_end:
        seg_ranges.append((bounds[-1], fwd_end))
    if not seg_ranges:
        return _fallback("need at least one segment after a checkpoint")
    rest = ops[fwd_end:]

    def _op_uses_rng(op):
        """rng-REGISTERED is not rng-USING: an attention/dropout op with
        rate 0 (or is_test) draws nothing, so remat replay is exact."""
        if not _op_needs_rng(op.type):
            return False
        if op.attrs.get("is_test"):
            return False
        rate_keys = [k for k in op.attrs
                     if k in ("dropout_rate", "dropout_prob")]
        if rate_keys:
            return max(float(op.attrs[k] or 0.0) for k in rate_keys) > 0.0
        return True  # unconditional generator (uniform_random, ...)

    # writeback names that must survive even if no forward op reads
    # them: mutable state + persistable outputs (batch_norm running
    # stats, counters) — a segment-local write would otherwise be
    # silently dropped and the old value written back every step
    writeback = set(cb.mut_state) | set(cb.extra_writeback)
    fwd_reads: Dict[int, set] = {}
    for i, op in enumerate(ops[:fwd_end]):
        fwd_reads[i] = set(op.input_arg_names)
    for lo, hi in seg_ranges:
        seg = Segment()
        seg.ops = ops[lo:hi]
        if not seg.ops:
            return _fallback("empty checkpoint segment")
        for op in seg.ops:
            if op.attrs.get("sub_block") is not None:
                return _fallback("control flow inside a segment")
            if _op_uses_rng(op):
                # the reference falls back here; this package keys every
                # op by its block index and could replay the draw, which
                # it does not do while the TPU package cannot
                return _fallback(
                    f"rng op '{op.type}' inside a segment")
        written = set()
        for op in seg.ops:
            for n in op.input_arg_names:
                if n not in written and n not in seg.ins:
                    seg.ins.append(n)
            written.update(op.output_arg_names)
        # outputs = the segment BOUNDARY: vars consumed by other FORWARD
        # ops, fetched, or state/persistable writebacks. Backward reads
        # of internals don't count — the segment's grad ops are replaced
        # by the vjp, which recomputes those values (that IS the
        # rematerialization); a non-replaced rest op reading an internal
        # is checked at the end.
        outside = set(cb.fetch_names) | writeback
        for i in range(fwd_end):
            if lo <= i < hi:
                continue
            outside |= fwd_reads[i]
        seg.outs = [n for n in written if n in outside]
        if not seg.outs:
            return _fallback("segment writes nothing consumed outside")
        plan.segments.append(seg)

    # ---- classify the backward spans ------------------------------------
    def grad_names_of(names):
        g = set()
        for v in names:
            g.add(grad_var_name(v))
        return g

    span_sets = []
    for seg in plan.segments:
        written = set()
        for op in seg.ops:
            written.update(op.output_arg_names)
        # a segment's span produces grads of its INTERNALS and INPUTS;
        # its outputs' grads come from the CONSUMER segment's span (or
        # the loss head), so they are not owned here
        owned = (written - set(seg.outs)) | set(seg.ins)
        span_sets.append(grad_names_of(owned))

    grad_owner: Dict[str, int] = {}
    for k, gset in enumerate(span_sets):
        for g in gset:
            if g in grad_owner and grad_owner[g] != k:
                return _fallback(
                    f"grad name '{g}' claimed by two segments")
            grad_owner[g] = k

    def owner_of(op):
        hits = set()
        for n in op.output_arg_names:
            # fan-in renames look like '<primal>@GRAD@RENAME@...' —
            # normalize to the base grad name for the dict lookup
            base = n
            i = n.find("@GRAD")
            if i >= 0:
                base = n[:i + 5]
            k = grad_owner.get(base)
            if k is not None:
                hits.add(k)
        return hits

    idxs: Dict[int, List[int]] = {k: [] for k in range(len(plan.segments))}
    for i, op in enumerate(rest):
        hits = owner_of(op)
        if len(hits) > 1:
            return _fallback(
                f"grad op '{op.type}' mixes segments {sorted(hits)} "
                f"(shared params across segments)")
        if hits:
            idxs[hits.pop()].append(i)
    live = [k for k in idxs if idxs[k]]
    if not live:
        return _fallback("no segment gradient ops found")
    # spans must be contiguous and in reverse segment order
    ordered = sorted(live, key=lambda k: idxs[k][0])
    if ordered != sorted(live, reverse=True):
        return _fallback("backward spans not in reverse segment order")
    marks = []
    for k in ordered:
        lo, hi = min(idxs[k]), max(idxs[k])
        if any(i not in idxs[k] for i in range(lo, hi + 1)):
            return _fallback(f"segment {k} backward span not contiguous")
        marks.append((k, lo, hi))
    # a segment input's grad must come ONLY from its own span: every
    # grad-of-input write outside the span falls back (fan-in)
    plan.rest_head = rest[:marks[0][1]]
    plan.spans = [None] * len(plan.segments)
    plan.between = []
    cur = None
    for j, (k, lo, hi) in enumerate(marks):
        plan.spans[k] = rest[lo:hi + 1]
        nxt_lo = marks[j + 1][1] if j + 1 < len(marks) else None
        seg_after = rest[hi + 1:nxt_lo] if nxt_lo is not None \
            else rest[hi + 1:]
        plan.between.append(seg_after)
    plan.span_order = [k for k, _, _ in marks]
    plan.tail_ops = plan.between.pop() if plan.between else []
    # every rest op that SURVIVES (not in a replaced span) must not read
    # a segment internal — those values are never materialized in env
    internals = set()
    for seg in plan.segments:
        w = set()
        for op in seg.ops:
            w.update(op.output_arg_names)
        internals |= (w - set(seg.outs))
    replaced = {id(op) for span in plan.spans if span for op in span}
    for op in rest:
        if id(op) in replaced:
            continue
        bad = internals & set(op.input_arg_names)
        if bad:
            return _fallback(
                f"op '{op.type}' outside the replaced spans reads "
                f"segment internals {sorted(bad)[:3]}")
    return plan


class SegmentForward:
    """A segment's forward in the execution order: its ops, over an env
    of their own, under ``torch.no_grad()``; only ``seg.outs`` reach the
    step's env."""

    def __init__(self, seg: Segment, steps):
        self.seg, self.steps = seg, steps
        self.reads = tuple(seg.ins)
        self.writes = tuple(seg.outs)
        self.frees = ()

    def _local_env(self, env):
        return {n: env[n] for n in self.seg.ins if n in env}

    def run(self, env):
        e = self._local_env(env)
        with torch.no_grad():
            exec_units(self.steps, e)
        for n in self.seg.outs:
            env[n] = e[n]


class Span(SegmentForward):
    """A segment's backward span: the segment's forward again under
    ``torch.enable_grad()``, its inputs in ``want`` (those whose grad the
    replaced span wrote) as leaves that require grad, then
    ``torch.autograd.grad`` of the boundary values with their grads from
    the step's env as cotangents. Reference rules: an integer boundary
    value takes no cotangent, and a boundary value with no grad in the
    env takes zeros (it adds nothing); a leaf no cotangent reaches gets
    zeros."""

    def __init__(self, seg: Segment, steps, want: List[str]):
        super().__init__(seg, steps)
        self.want = tuple(want)
        # the boundary values themselves are recomputed, not read
        self.reads = tuple(seg.ins) + tuple(
            grad_var_name(n) for n in seg.outs)
        self.writes = tuple(grad_var_name(n) for n in want)

    def run(self, env):
        e = self._local_env(env)
        leaves = {}
        for n in self.want:
            v = e.get(n)
            if v is not None and v.is_floating_point():
                leaves[n] = e[n] = v.detach().requires_grad_()
        with torch.enable_grad():
            exec_units(self.steps, e)
        outs, cots = [], []
        for n in self.seg.outs:
            o, g = e[n], env.get(grad_var_name(n))
            if g is None or not o.is_floating_point() or not o.requires_grad:
                continue
            g = g.to(o.dtype)
            outs.append(o)
            cots.append(g if g.shape == o.shape else g.broadcast_to(o.shape))
        names = list(leaves)
        grads = (torch.autograd.grad(outs, [leaves[n] for n in names], cots,
                                     allow_unused=True)
                 if outs and names else [None] * len(names))
        for n, g in zip(names, grads):
            env[grad_var_name(n)] = torch.zeros_like(leaves[n]) \
                if g is None else g


def schedule(plan: RematPlan, steps_of) -> list:
    """The remat step's execution order (the TPU package's ``exec_plan``),
    as units for the executor's liveness plan: the ops before the first
    segment, each segment's forward, the loss head, then each span with
    the ops that follow it, then the tail. ``steps_of`` maps ``id(op)`` to
    the op's bound step. Inside a segment, names that are not boundary
    values leave the segment's env after their last use."""
    def steps(ops):
        return [steps_of[id(op)] for op in ops]

    fwd, spans = [], []
    for k, seg in enumerate(plan.segments):
        seg_steps = steps(seg.ops)
        set_liveness(seg_steps, set(seg.outs))
        fwd.append(SegmentForward(seg, seg_steps))
        written = {n for op in plan.spans[k] or []
                   for n in op.output_arg_names}
        spans.append(Span(seg, seg_steps, [
            n for n in seg.ins if grad_var_name(n) in written]))
    units = steps(plan.pre_ops) + fwd + steps(plan.rest_head)
    for j, k in enumerate(plan.span_order):
        units.append(spans[k])
        if j < len(plan.between):
            units += steps(plan.between[j])
    return units + steps(plan.tail_ops)
