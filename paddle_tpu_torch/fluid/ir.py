"""Program-level helpers of the executor (counterpart of
paddle_tpu/fluid/ir.py). So far: ``fused_health``, the numeric fault
plane's one health scalar a step."""
from __future__ import annotations

import torch

__all__ = ["fused_health"]


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
