"""Gradient clipping (counterpart of paddle_tpu/fluid/clip.py; reference:
python/paddle/fluid/clip.py). So far only ``append_gradient_clip_ops``
with nothing set: the (param, grad) pairs pass through. The clip classes
(by value, by norm, by global norm) come in a later slice; a parameter
that carries one raises rather than training unclipped."""
from __future__ import annotations

__all__ = ["append_gradient_clip_ops"]


def append_gradient_clip_ops(param_grads):
    for p, g in param_grads:
        if g is not None and getattr(p, "gradient_clip_attr", None) \
                is not None:
            raise NotImplementedError(
                f"gradient clipping (set on '{p.name}') comes in a later "
                "slice of paddle_tpu_torch")
    return list(param_grads)
