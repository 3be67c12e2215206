"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py;
reference: paddle/fluid/operators/optimizers/sgd_op.cc, momentum_op.cc,
adam_op.cc; so far: sgd, momentum and adam).

Each op returns ParamOut / MomentOut tensors that the executor writes back
under the same var names as Param / Moment (the optimizer wires each
output slot to its input's var), so the scope holds the updated state for
the next step. The old tensors are dropped, not overwritten in place.

All are no_grad (nothing differentiates through an optimizer step).
"""
from __future__ import annotations

import torch

from .registry import register_op, first, out


@register_op("sgd", no_grad=True)
def _sgd(ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    lr = first(ins, "LearningRate")
    return out(ParamOut=p - lr.reshape(()).to(p.dtype) * g.to(p.dtype))


@register_op("momentum", no_grad=True,
             attr_defaults={"mu": 0.9, "use_nesterov": False,
                            "regularization_method": "",
                            "regularization_coeff": 0.0})
def _momentum(ins, attrs):
    """v ← mu·v + g; p ← p − lr·v, or p − lr·(g + mu·v) with Nesterov."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    v = first(ins, "Velocity")
    lr = first(ins, "LearningRate").reshape(()).to(p.dtype)
    mu = attrs.get("mu", 0.9)
    if attrs.get("regularization_method", "") == "l2_decay":
        g = g + attrs.get("regularization_coeff", 0.0) * p
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return out(ParamOut=p_new, VelocityOut=v_new)


@register_op("adam", no_grad=True,
             attr_defaults={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                            "lazy_mode": False,
                            "min_row_size_to_use_multithread": 1000})
def _adam(ins, attrs):
    """The reference's Adam: the pow accumulators start at beta and the
    epsilon is scaled by sqrt(1 - beta2^t)."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    m, v = first(ins, "Moment1"), first(ins, "Moment2")
    lr = first(ins, "LearningRate").reshape(()).to(p.dtype)
    b1p_in, b2p_in = first(ins, "Beta1Pow"), first(ins, "Beta2Pow")
    b1p = b1p_in.reshape(()).to(p.dtype)
    b2p = b2p_in.reshape(()).to(p.dtype)
    b1t, b2t = first(ins, "Beta1Tensor"), first(ins, "Beta2Tensor")
    b1 = b1t.reshape(()).to(p.dtype) if b1t is not None \
        else attrs.get("beta1", 0.9)
    b2 = b2t.reshape(()).to(p.dtype) if b2t is not None \
        else attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps * torch.sqrt(1 - b2p))
    return out(ParamOut=p_new, Moment1Out=m_new, Moment2Out=v_new,
               Beta1PowOut=(b1p * b1).reshape(b1p_in.shape).to(b1p_in.dtype),
               Beta2PowOut=(b2p * b2).reshape(b2p_in.shape).to(b2p_in.dtype))
