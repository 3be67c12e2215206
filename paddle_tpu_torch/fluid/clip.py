"""Gradient clipping (counterpart of paddle_tpu/fluid/clip.py; reference:
python/paddle/fluid/clip.py — GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm, set_gradient_clip, append_gradient_clip_ops).

Each clip appends ops after the grads, so a clipped step stays one
compiled step: by value a ``clip`` op a grad, by norm a ``clip_by_norm``
op a grad, by global norm one ``squared_l2_norm`` a grad, then ``sum``,
``sqrt``, ``fill_constant``, ``elementwise_max`` and ``elementwise_div``
for the scale clip_norm / max(‖g‖, clip_norm), and one
``elementwise_mul`` a grad. The global norm never leaves the device.

``set_gradient_clip`` keeps the TPU package's contract: it sets the
process-wide clip whatever ``param_list`` says, and marks the listed
parameters; ``append_gradient_clip_ops`` applies a global-norm clip to
every grad, any other clip per parameter (the parameter's own first).
"""
from __future__ import annotations

from . import layers
from .layer_helper import LayerHelper

__all__ = ["set_gradient_clip", "ErrorClipByValue", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm"]


class BaseGradientClipAttr:
    def _process(self, param, grad):
        raise NotImplementedError


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max


class GradientClipByValue(BaseGradientClipAttr):
    """Each grad element clipped to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _process(self, param, grad):
        return param, layers.clip(grad, self.min, self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    """Each grad scaled to L2 norm ``clip_norm`` where its norm exceeds
    it."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, param, grad):
        return param, layers.clip_by_norm(grad, self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every grad scaled by clip_norm / max(global norm, clip_norm), the
    global norm over all the grads together."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_group(self, params_grads):
        sq_sums = []
        for p, g in params_grads:
            if g is None:
                continue
            helper = LayerHelper("global_norm")
            sq = helper.create_variable_for_type_inference(g.dtype)
            sq.shape = (1,)
            helper.append_op(type="squared_l2_norm", inputs={"X": [g]},
                             outputs={"Out": [sq]}, attrs={"op_role": 1})
            sq_sums.append(sq)
        global_sq = layers.sums(sq_sums)
        global_norm = layers.sqrt(global_sq)
        clip_var = layers.fill_constant([1], "float32", self.clip_norm)
        scale = layers.elementwise_div(
            clip_var, layers.elementwise_max(global_norm, clip_var))
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            out.append((p, layers.elementwise_mul(g, scale)))
        return out


_gradient_clip_attr = None


def set_gradient_clip(clip, param_list=None, program=None):
    """Set the clip ``minimize`` applies when its optimizer has none; the
    parameters of ``param_list`` (not names) carry it too."""
    global _gradient_clip_attr
    _gradient_clip_attr = clip
    if param_list is not None:
        for p in param_list:
            if not isinstance(p, str):
                p.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    """The (param, grad) pairs after the clip ops: the global clip's group
    when it is a global-norm clip, else each parameter's own clip or the
    global one; a pair without a clip or a grad passes through."""
    if isinstance(_gradient_clip_attr, GradientClipByGlobalNorm):
        return _gradient_clip_attr._process_group(param_grads)
    res = []
    for p, g in param_grads:
        clip = getattr(p, "gradient_clip_attr", None) or _gradient_clip_attr
        if g is None or clip is None:
            res.append((p, g))
        else:
            res.append(clip._process(p, g))
    return res
