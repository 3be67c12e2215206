"""Optimizer update ops (counterpart of paddle_tpu/ops/optimizer_ops.py;
reference: paddle/fluid/operators/optimizers/ — sgd_op.cc, momentum_op.cc,
adam_op.cc, adamax_op.cc, adagrad_op.cc, adadelta_op.cc, rmsprop_op.cc,
decayed_adagrad_op.cc, ftrl_op.cc, lamb_op.cc, lars_momentum_op.cc,
dpsgd_op.cc, proximal_gd_op.cc, proximal_adagrad_op.cc, and
average_accumulates_op.cc).

Each op returns ParamOut / MomentOut tensors that the executor writes back
under the same var names as Param / Moment (the optimizer wires each
output slot to its input's var), so the scope holds the updated state for
the next step. The old tensors are dropped, not overwritten in place.

All are no_grad (nothing differentiates through an optimizer step). Each
formula is the TPU kernel's, operation for operation. Every norm (LAMB's
trust ratio, LARS's local LR, DPSGD's clip) is a ``torch.sum`` of squares
that stays on the device: no host read, so a step stays one CUDA graph.
``dpsgd`` draws its Gaussian noise from the op's key through
``rng.normal`` (capture-safe), where the TPU kernel draws
``jax.random.normal``: the two packages agree at ``sigma = 0`` and by
distribution otherwise.
"""
from __future__ import annotations

import torch

from . import rng
from .registry import register_op, first, out


def _lr(ins, p):
    """The op's LearningRate as a 0-d tensor in the parameter's dtype."""
    return first(ins, "LearningRate").reshape(()).to(p.dtype)


def _norm(x):
    """‖x‖₂ as a 0-d tensor on x's device."""
    return torch.sqrt(torch.sum(torch.square(x)))


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


@register_op("adamax", no_grad=True,
             attr_defaults={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
def _adamax(ins, attrs):
    """Adam with the infinity norm; the beta-1 power is advanced by the
    optimizer's ``scale`` op, not here."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    m, inf = first(ins, "Moment"), first(ins, "InfNorm")
    lr = _lr(ins, p)
    b1p = first(ins, "Beta1Pow").reshape(()).to(p.dtype)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    p_new = p - (lr / (1 - b1p)) * (m_new / (inf_new + eps))
    return out(ParamOut=p_new, MomentOut=m_new, InfNormOut=inf_new)


@register_op("adagrad", no_grad=True, attr_defaults={"epsilon": 1e-6})
def _adagrad(ins, attrs):
    p, g, m = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    lr = _lr(ins, p)
    eps = attrs.get("epsilon", 1e-6)
    m_new = m + torch.square(g)
    return out(ParamOut=p - lr * g / (torch.sqrt(m_new) + eps),
               MomentOut=m_new)


@register_op("decayed_adagrad", no_grad=True,
             attr_defaults={"decay": 0.95, "epsilon": 1e-6})
def _decayed_adagrad(ins, attrs):
    p, g, m = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    lr = _lr(ins, p)
    d, eps = attrs.get("decay", 0.95), attrs.get("epsilon", 1e-6)
    m_new = d * m + (1 - d) * torch.square(g)
    return out(ParamOut=p - lr * g / (torch.sqrt(m_new) + eps),
               MomentOut=m_new)


@register_op("adadelta", no_grad=True,
             attr_defaults={"rho": 0.95, "epsilon": 1e-6})
def _adadelta(ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    ag, au = first(ins, "AvgSquaredGrad"), first(ins, "AvgSquaredUpdate")
    rho, eps = attrs.get("rho", 0.95), attrs.get("epsilon", 1e-6)
    ag_new = rho * ag + (1 - rho) * torch.square(g)
    upd = -torch.sqrt((au + eps) / (ag_new + eps)) * g
    au_new = rho * au + (1 - rho) * torch.square(upd)
    return out(ParamOut=p + upd, AvgSquaredGradOut=ag_new,
               AvgSquaredUpdateOut=au_new)


@register_op("rmsprop", no_grad=True,
             attr_defaults={"decay": 0.9, "momentum": 0.0, "epsilon": 1e-10,
                            "centered": False})
def _rmsprop(ins, attrs):
    """Centered: the mean grad's square comes off the mean square; not
    centered, MeanGrad passes through."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    ms, mom = first(ins, "MeanSquare"), first(ins, "Moment")
    mg = first(ins, "MeanGrad")
    lr = _lr(ins, p)
    rho = attrs.get("decay", 0.9)
    mu = attrs.get("momentum", 0.0)
    eps = attrs.get("epsilon", 1e-10)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg_new = rho * mg + (1 - rho) * g
        denom = ms_new - torch.square(mg_new) + eps
    else:
        mg_new = mg
        denom = ms_new + eps
    mom_new = mu * mom + lr * g / torch.sqrt(denom)
    res = out(ParamOut=p - mom_new, MeanSquareOut=ms_new, MomentOut=mom_new)
    if mg is not None:
        res.update(out(MeanGradOut=mg_new))
    return res


@register_op("ftrl", no_grad=True,
             attr_defaults={"l1": 0.0, "l2": 0.0, "lr_power": -0.5})
def _ftrl(ins, attrs):
    """FTRL-proximal; an element whose denominator is 0 (a fresh
    accumulator and a zero grad) keeps its parameter."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    sq, lin = first(ins, "SquaredAccumulator"), first(ins, "LinearAccumulator")
    lr = _lr(ins, p)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lp = attrs.get("lr_power", -0.5)
    new_sq = sq + torch.square(g)
    if lp == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
    else:
        sigma = (new_sq ** (-lp) - sq ** (-lp)) / lr
    new_lin = lin + g - sigma * p
    if lp == -0.5:
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        denom = new_sq ** (-lp) / lr + 2 * l2
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    pos = denom > 0
    p_new = torch.where(pos, pre / torch.where(pos, denom, 1.0), p)
    return out(ParamOut=p_new, SquaredAccumOut=new_sq,
               LinearAccumOut=new_lin)


@register_op("lamb", no_grad=True,
             attr_defaults={"weight_decay": 0.01, "beta1": 0.9,
                            "beta2": 0.999, "epsilon": 1e-6})
def _lamb(ins, attrs):
    """LAMB (You et al. 2019): Adam's bias-corrected step plus weight
    decay, scaled by the trust ratio ‖p‖ / ‖r‖ (1 where either norm is
    0)."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    m, v = first(ins, "Moment1"), first(ins, "Moment2")
    lr = _lr(ins, p)
    b1p_in, b2p_in = first(ins, "Beta1Pow"), first(ins, "Beta2Pow")
    b1p = b1p_in.reshape(()).to(p.dtype)
    b2p = b2p_in.reshape(()).to(p.dtype)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * torch.square(g)
    m_hat = m_new / (1 - b1p)
    v_hat = v_new / (1 - b2p)
    r = m_hat / (torch.sqrt(v_hat) + eps) + wd * p
    p_norm, r_norm = _norm(p), _norm(r)
    ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
    return out(ParamOut=p - lr * ratio * r, Moment1Out=m_new,
               Moment2Out=v_new,
               Beta1PowOut=(b1p * b1).reshape(b1p_in.shape).to(b1p_in.dtype),
               Beta2PowOut=(b2p * b2).reshape(b2p_in.shape).to(b2p_in.dtype))


@register_op("lars_momentum", no_grad=True,
             attr_defaults={"mu": 0.9, "lars_coeff": 0.001,
                            "lars_weight_decay": 0.0005, "epsilon": 0.0})
def _lars_momentum(ins, attrs):
    """Momentum under the layer-wise LR lr·coeff·‖p‖ / (‖g‖ + wd·‖p‖),
    which falls back to lr where either norm is 0."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    v = first(ins, "Velocity")
    lr = _lr(ins, p)
    mu = attrs.get("mu", 0.9)
    lars_coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    p_norm, g_norm = _norm(p), _norm(g)
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * lars_coeff * p_norm / (g_norm + wd * p_norm), lr)
    v_new = mu * v + local_lr * (g + wd * p)
    return out(ParamOut=p - v_new, VelocityOut=v_new)


@register_op("dpsgd", no_grad=True, needs_rng=True,
             attr_defaults={"clip": 10.0, "batch_size": 16.0, "sigma": 1.0})
def _dpsgd(ins, attrs):
    """Differentially private SGD: the grad clipped to norm ``clip``, plus
    Gaussian noise of std sigma·clip, over ``batch_size``."""
    p, g = first(ins, "Param"), first(ins, "Grad")
    lr = _lr(ins, p)
    clip = attrs.get("clip", 10.0)
    sigma = attrs.get("sigma", 1.0)
    bs = attrs.get("batch_size", 16.0)
    scale = torch.clamp(clip / torch.clamp(_norm(g), min=1e-10), max=1.0)
    noise = sigma * clip * rng.normal(attrs["_rng"](), g.shape).to(g.dtype)
    return out(ParamOut=p - lr * (g * scale + noise) / bs)


def _proximal(prox, eff_lr, l1, l2):
    """sign(prox) · max(|prox| − lr·l1, 0) / (1 + lr·l2)."""
    return torch.sign(prox) * torch.clamp(
        torch.abs(prox) - eff_lr * l1, min=0) / (1 + eff_lr * l2)


@register_op("proximal_gd", no_grad=True,
             attr_defaults={"l1": 0.0, "l2": 0.0})
def _proximal_gd(ins, attrs):
    p, g = first(ins, "Param"), first(ins, "Grad")
    lr = _lr(ins, p)
    return out(ParamOut=_proximal(p - lr * g, lr, attrs.get("l1", 0.0),
                                  attrs.get("l2", 0.0)))


@register_op("proximal_adagrad", no_grad=True,
             attr_defaults={"l1": 0.0, "l2": 0.0})
def _proximal_adagrad(ins, attrs):
    p, g, m = first(ins, "Param"), first(ins, "Grad"), first(ins, "Moment")
    lr = _lr(ins, p)
    m_new = m + torch.square(g)
    eff_lr = lr / torch.sqrt(m_new)
    return out(ParamOut=_proximal(p - eff_lr * g, eff_lr,
                                  attrs.get("l1", 0.0), attrs.get("l2", 0.0)),
               MomentOut=m_new)


@register_op("average_accumulates", no_grad=True,
             attr_defaults={"average_window": 0.0, "max_average_window": 0,
                            "min_average_window": 10000})
def _average_accumulates(ins, attrs):
    """The TPU kernel's accumulate: the parameter into sum 1, one more
    accumulate and update; sums 2 and 3 and the old count pass through."""
    s1 = first(ins, "in_sum_1") + first(ins, "param")
    return out(out_sum_1=s1, out_sum_2=first(ins, "in_sum_2"),
               out_sum_3=first(ins, "in_sum_3"),
               out_num_accumulates=first(ins, "in_num_accumulates") + 1,
               out_old_num_accumulates=first(ins, "in_old_num_accumulates"),
               out_num_updates=first(ins, "in_num_updates") + 1)
