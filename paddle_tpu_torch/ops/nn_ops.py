"""NN op kernels (counterpart of paddle_tpu/ops/nn_ops.py; so far:
lookup_table_v2, layer_norm, softmax, cross_entropy,
softmax_with_cross_entropy, accuracy and dropout with its
dropout_grad)."""
from __future__ import annotations

import torch

from .cuda import dropout as cuda_dropout
from .registry import register_grad_maker, register_op, first, out


# --------------------------------------------------------------------------
# embedding
# --------------------------------------------------------------------------
def _lookup(w, ids, padding_idx):
    o = w[ids.long()]
    if padding_idx is not None and padding_idx >= 0:
        o = torch.where((ids == padding_idx)[..., None],
                        torch.zeros((), dtype=o.dtype, device=o.device), o)
    return o


@register_op("lookup_table_v2", inputs=("W", "Ids"), diff_inputs=("W",),
             attr_defaults={"padding_idx": -1, "is_sparse": False,
                            "is_distributed": False, "remote_prefetch": False})
def _lookup_table_v2(ins, attrs):
    w, ids = first(ins, "W"), first(ins, "Ids")
    pad = attrs.get("padding_idx", -1)
    return out(Out=_lookup(w, ids, pad if pad >= 0 else None))


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------
@register_op("layer_norm", inputs=("X", "Scale", "Bias"),
             diff_inputs=("X", "Scale", "Bias"),
             attr_defaults={"epsilon": 1e-5, "begin_norm_axis": 1})
def _layer_norm(ins, attrs):
    """Statistics in f32 with the biased variance; Mean and Variance have
    shape ``x.shape[:begin_norm_axis]``."""
    x = first(ins, "X")
    scale, bias = first(ins, "Scale"), first(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(bna, x.dim()))
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, axes, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), axes, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    norm_shape = (1,) * bna + tuple(x.shape[bna:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    flat = tuple(x.shape[:bna])
    return out(Y=y, Mean=mean.reshape(flat).to(x.dtype),
               Variance=var.reshape(flat).to(x.dtype))


# --------------------------------------------------------------------------
# softmax & losses
# --------------------------------------------------------------------------
@register_op("softmax", inputs=("X",), attr_defaults={"axis": -1})
def _softmax(ins, attrs):
    return out(Out=torch.softmax(first(ins, "X"), dim=attrs.get("axis", -1)))


@register_op("cross_entropy", inputs=("X", "Label"), diff_inputs=("X",),
             attr_defaults={"soft_label": False, "ignore_index": -100})
def _cross_entropy(ins, attrs):
    """-log(x[label] + 1e-20) over probabilities x (the TPU package's
    kernel); an ignored label gives 0."""
    x, label = first(ins, "X"), first(ins, "Label")
    eps = 1e-20
    if attrs.get("soft_label", False):
        return out(Y=-torch.sum(label * torch.log(x + eps), dim=-1,
                                keepdim=True))
    lbl = label
    if lbl.dim() == x.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    lbl = lbl.long()[..., None]
    ign = attrs.get("ignore_index", -100)
    # an ignored label may lie outside the classes: gather at 0, then
    # zero the loss
    picked = torch.gather(x, -1, torch.where(lbl == ign, 0, lbl))
    loss = -torch.log(picked + eps)
    return out(Y=torch.where(lbl == ign, torch.zeros((), dtype=loss.dtype,
                                                     device=loss.device),
                             loss))



@register_op("softmax_with_cross_entropy", inputs=("Logits", "Label"),
             diff_inputs=("Logits",),
             attr_defaults={"soft_label": False, "ignore_index": -100,
                            "numeric_stable_mode": True, "axis": -1})
def _softmax_with_cross_entropy(ins, attrs):
    logits, label = first(ins, "Logits"), first(ins, "Label")
    axis = attrs.get("axis", -1) % logits.dim()
    logp = torch.log_softmax(logits, dim=axis)
    softmax = torch.exp(logp)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        lbl = lbl.unsqueeze(axis).long()
        ign = attrs.get("ignore_index", -100)
        # an ignored label may lie outside the classes: gather at 0, then
        # zero the loss
        picked = torch.gather(logp, axis,
                              torch.where(lbl == ign, 0, lbl))
        loss = torch.where(lbl == ign,
                           torch.zeros((), dtype=logp.dtype,
                                       device=logp.device), -picked)
    return out(Softmax=softmax, Loss=loss)


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------
@register_op("accuracy", inputs=("Out", "Indices", "Label"), no_grad=True)
def _accuracy(ins, attrs):
    """Top-k accuracy from top_k's Indices: a row counts when any of its k
    indices is its label. Total is a device fill, not a host copy, so a
    CUDA graph can capture the op."""
    idx, label = first(ins, "Indices"), first(ins, "Label")
    correct = torch.any(idx == label.reshape(-1, 1).to(idx.dtype), dim=1)
    num_correct = torch.sum(correct.to(torch.float32))
    total = idx.shape[0]
    return out(Accuracy=(num_correct / total).reshape((1,)),
               Correct=num_correct.to(torch.int32).reshape((1,)),
               Total=torch.full((1,), total, dtype=torch.int32,
                                device=idx.device))


# --------------------------------------------------------------------------
# dropout — the Mask output contract is kept, so the grad is a mask multiply
# --------------------------------------------------------------------------
@register_op("dropout", inputs=("X", "Seed"), needs_rng=True,
             attr_defaults={"dropout_prob": 0.5, "is_test": False,
                            "dropout_implementation": "downgrade_in_infer",
                            "fix_seed": False, "seed": 0})
def _dropout(ins, attrs):
    """Keeps each element with probability 1 - dropout_prob, a
    counter-based draw from the op's key (ops/rng.py; the TPU package
    draws from jax.random: the same distribution, other bits), in one
    kernel on the card (ops/cuda/dropout.py)."""
    x = first(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False):
        o = x if impl == "upscale_in_train" else x * (1.0 - p)
        return out(Out=o, Mask=torch.ones_like(x, dtype=torch.uint8))
    o, mask = cuda_dropout.dropout(x, attrs["_rng"](), p,
                                   impl == "upscale_in_train")
    return out(Out=o, Mask=mask)


@register_op("dropout_grad", no_grad=True)
def _dropout_grad(ins, attrs):
    g = first(ins, "Out@GRAD")
    mask = first(ins, "Mask")
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    gx = g * mask.to(g.dtype)
    if impl == "upscale_in_train" and p < 1.0:
        gx = gx / (1.0 - p)
    return out(**{"X@GRAD": gx})


@register_grad_maker("dropout")
def _dropout_grad_maker(op, grad_map):
    return [{
        "type": "dropout_grad",
        "inputs": {"Out@GRAD": [grad_map[op.output("Out")[0]]],
                   "Mask": op.output("Mask")},
        "outputs": {"X@GRAD": [grad_map[op.input("X")[0]]]},
        "attrs": {k: v for k, v in op.attrs.items() if not k.startswith("_")},
    }]
