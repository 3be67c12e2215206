"""The fused ops that the inference passes emit and that serialized
inference programs carry (counterpart of paddle_tpu/ops/fused_ops.py; so
far: fc, fused_embedding_eltwise_layernorm, fused_fc_elementwise_layernorm
and conv2d_fusion).

Each is a composition of the port's own kernels with the reference's slot
and attr contract (reference: operators/fc_op.cc,
fused/fused_embedding_eltwise_layernorm_op.cc,
fused/fused_fc_elementwise_layernorm_op.cc, fused/conv2d_fusion_op.cc),
in the same arithmetic as the ops a pass fuses, so a fused program
computes what its unfused form computes:
  * ``fc`` is a product and then an add (not ``addmm``), in full f32
    whatever FLAGS_use_bf16_matmul says, as the TPU package's fc; at that
    flag's default it is ``mul`` + ``elementwise_add`` bit for bit;
  * the layer norms are ``layer_norm``'s kernel over the last axis;
  * ``conv2d_fusion`` is ``conv2d``'s kernel (cuDNN with the pinned
    flags, the bias added after), then the residual and the activation.
"""
from __future__ import annotations

import math

import torch

from .registry import register_op, first, seq, out


def _act(name, x, alpha=0.0):
    if name in (None, "", "identity", "linear"):
        return x
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if name == "relu":
        return torch.maximum(x, zero)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "tanh":
        return torch.tanh(x)
    if name == "gelu":
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    if name == "leaky_relu":
        return torch.where(x > 0, x, alpha * x)
    if name == "relu6":
        return torch.clamp(x, 0, 6)
    if name == "swish":
        return x * torch.sigmoid(x)
    raise NotImplementedError(f"activation '{name}' in a fused op")


def _norm_last(x, scale, bias, eps):
    """``layer_norm``'s kernel over the last axis."""
    from .nn_ops import _layer_norm
    return _layer_norm({"X": [x], "Scale": [scale], "Bias": [bias]},
                       {"epsilon": eps, "begin_norm_axis": x.dim() - 1}
                       )["Y"][0]


@register_op("fc", inputs=("Input", "W", "Bias"),
             diff_inputs=("Input", "W", "Bias"),
             attr_defaults={"in_num_col_dims": 1, "activation_type": "",
                            "use_mkldnn": False})
def _fc(ins, attrs):
    """Input flattened to 2-D at ``in_num_col_dims``, times W, plus Bias,
    then ``activation_type`` (the TPU package's fused_ops.py:48-58)."""
    x, w = first(ins, "Input"), first(ins, "W")
    nd = int(attrs.get("in_num_col_dims", 1))
    lead = tuple(x.shape[:nd])
    o = torch.matmul(x.reshape((math.prod(lead), -1)), w)
    b = first(ins, "Bias")
    if b is not None:
        o = o + b.reshape(1, -1)
    o = _act(attrs.get("activation_type", ""), o)
    return out(Out=o.reshape(lead + (w.shape[1],)))


@register_op("fused_embedding_eltwise_layernorm",
             inputs=("Ids", "Embs", "Bias", "Scale"),
             diff_inputs=("Embs", "Bias", "Scale"),
             attr_defaults={"epsilon": 1e-5})
def _fused_embedding_eltwise_layernorm(ins, attrs):
    """The sum of k lookups, in order, then a layer norm over the last
    axis. Ids [N, T] or [N, T, 1] (the TPU package's fused_ops.py:120)."""
    acc = None
    for ids, emb in zip(seq(ins, "Ids"), seq(ins, "Embs")):
        idv = ids[..., 0] if ids.dim() == 3 else ids.reshape(ids.shape[0], -1)
        v = emb[idv.long()]
        acc = v if acc is None else acc + v
    return out(Out=_norm_last(acc, first(ins, "Scale"), first(ins, "Bias"),
                              attrs.get("epsilon", 1e-5)))


@register_op("fused_fc_elementwise_layernorm",
             inputs=("X", "W", "Bias0", "Y", "Scale", "Bias1"),
             diff_inputs=("X", "W", "Bias0", "Y", "Scale", "Bias1"),
             attr_defaults={"epsilon": 1e-5, "begin_norm_axis": 1,
                            "activation_type": "", "x_num_col_dims": 1})
def _fused_fc_elementwise_layernorm(ins, attrs):
    """fc(X, W, Bias0) + Y, then a layer norm over the last axis (the
    TPU package's fused_ops.py:161)."""
    o = _fc({"Input": ins["X"], "W": ins["W"], "Bias": ins.get("Bias0")},
            {"in_num_col_dims": attrs.get("x_num_col_dims", 1)})["Out"][0]
    o = o + first(ins, "Y")
    return out(Out=_norm_last(o, first(ins, "Scale"), first(ins, "Bias1"),
                              attrs.get("epsilon", 1e-5)))


@register_op("conv2d_fusion",
             inputs=("Input", "Filter", "Bias", "ResidualData"),
             diff_inputs=("Input", "Filter", "Bias"),
             attr_defaults={"strides": [1, 1], "paddings": [0, 0],
                            "dilations": [1, 1], "groups": 1,
                            "activation": "relu",
                            "padding_algorithm": "EXPLICIT",
                            "data_format": "NCHW", "use_cudnn": True})
def _conv2d_fusion(ins, attrs):
    """conv2d with its bias, plus ResidualData, then ``activation`` (the
    TPU package's fused_ops.py:390)."""
    from .nn_ops import _conv2d
    o = _conv2d(ins, attrs)["Output"][0]
    res = first(ins, "ResidualData")
    if res is not None:
        o = o + res
    return out(Output=_act(attrs.get("activation", "relu"), o))
