"""Program-level helpers of the executor (counterpart of
paddle_tpu/fluid/ir.py). So far: ``fused_health``, the numeric fault
plane's one health scalar a step, and the segment analysis of a block
(ir.py:1308-1390): ``op_island_reason``, ``BlockSegment``,
``analyze_block_segments`` and ``segment_summary``. The analysis as a
graph pass (``BlockSegmentationPass``) waits for the pass framework."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..ops.registry import resolve_base_info

__all__ = ["fused_health", "op_island_reason", "BlockSegment",
           "analyze_block_segments", "segment_summary"]

# control flow, which the TPU package's compiled step lowers to lax
# primitives; not lowered here yet
CONTROL_FLOW = frozenset({"while", "conditional_block",
                          "conditional_block_infer", "select_input"})


def fused_health(values, device=None) -> torch.Tensor:
    """ONE boolean scalar on the device: True iff every element of every
    floating-point tensor in ``values`` is finite (the TPU package's
    ir.py:1272). Each tensor contributes ``isfinite().all()`` and the
    flags are ANDed on the device: no host sync. Non-float tensors (int
    counters, bool masks) and None are skipped; an empty list is healthy
    (a True made on ``device``)."""
    flags = [torch.isfinite(v).all() for v in values
             if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool, device=device)
    return flags[0] if len(flags) == 1 else torch.stack(flags).all()


def op_reads_host_values(op) -> bool:
    """An op whose kernel reads the VALUES of a connected ``host_inputs``
    slot (registry) cannot be replayed by a CUDA graph."""
    info = resolve_base_info(op.type)
    return info is not None and any(op.inputs.get(s)
                                    for s in info.host_inputs)


def op_island_reason(op) -> Optional[str]:
    """None when ``op`` can run in a compiled segment (a CUDA graph on the
    card); otherwise why not: 'unregistered' (no kernel: the interpreter
    raises with context), 'stateful' (side effects beyond its outputs),
    'host_inputs' (a connected slot whose values the kernel reads on the
    host) or 'control_flow'."""
    info = resolve_base_info(op.type)
    if info is None:
        return "unregistered"
    if info.stateful:
        return "stateful"
    if op_reads_host_values(op):
        return "host_inputs"
    if op.type in CONTROL_FLOW or op.attrs.get("sub_block") is not None:
        return "control_flow"
    return None


class BlockSegment:
    """One maximal run of a block's op list: ``kind`` is 'compiled' (pure
    ops, run as one planned step: one CUDA graph on the card) or 'island'
    (run op by op by the interpreter). ``start`` is the index of its first
    op in the block: the executor keys each random op by its index in the
    block, so a segmented run draws what the whole compiled step draws.
    The executor fills the plan's slots when it builds a step."""

    __slots__ = ("kind", "start", "ops", "island_reasons",
                 # filled by the executor's segment plan
                 "in_names", "out_names", "state_writes", "units", "op_io",
                 "guard_names")

    def __init__(self, kind: str, start: int):
        self.kind = kind
        self.start = start
        self.ops: List[Any] = []
        self.island_reasons: List[Optional[str]] = []

    @property
    def stop(self) -> int:
        return self.start + len(self.ops)

    def __repr__(self):
        kinds = ",".join(o.type for o in self.ops[:4])
        more = "..." if len(self.ops) > 4 else ""
        return (f"<BlockSegment {self.kind} [{self.start}:{self.stop}) "
                f"{kinds}{more}>")


def analyze_block_segments(ops) -> List[BlockSegment]:
    """Partition ``ops`` into maximal compiled and island segments.
    Adjacent ops of the same kind merge, so the kinds alternate; the
    segments cover every op once, in order."""
    segments: List[BlockSegment] = []
    for idx, op in enumerate(ops):
        reason = op_island_reason(op)
        kind = "island" if reason is not None else "compiled"
        if not segments or segments[-1].kind != kind:
            segments.append(BlockSegment(kind, idx))
        segments[-1].ops.append(op)
        if kind == "island":
            segments[-1].island_reasons.append(reason)
    return segments


def segment_summary(segments) -> List[Dict[str, Any]]:
    """A JSON-able view of a partition."""
    return [{"kind": s.kind, "start": s.start, "stop": s.stop,
             "n_ops": len(s.ops), "op_types": [o.type for o in s.ops],
             "island_reasons": list(s.island_reasons),
             "guard_names": list(getattr(s, "guard_names", ()) or ())}
            for s in segments]
