"""The fused ops that the inference passes emit and that serialized
inference programs carry (counterpart of paddle_tpu/ops/fused_ops.py; so
far: fc, fused_embedding_eltwise_layernorm, fused_fc_elementwise_layernorm,
conv2d_fusion, the training-side fusions BuildStrategy's passes emit,
fused_elemwise_activation and fused_batch_norm_act, skip_layernorm, and
the LoD fusions fusion_seqconv_eltadd_relu, fusion_seqpool_concat and
fusion_seqexpand_concat_fc, and the recurrences fc_gru_fuse_pass and
fc_lstm_fuse_pass emit, fusion_gru and fusion_lstm).

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
    flags, the bias added after), then the residual and the activation;
  * ``fused_elemwise_activation`` is the binary op's arithmetic and then
    the unary one's (``relu`` as ``torch.maximum(x, 0)``, ``scale`` as a
    product by the attr rounded to the dtype), and
    ``fused_batch_norm_act`` is ``batch_norm``'s kernel and then the
    activation. Their grads are the generic grad over torch autograd;
  * ``skip_layernorm`` is ``layer_norm``'s kernel over X + Y; the LoD
    fusions are the sequence ops' kernels (sequence_ops.py: the padded
    pooling, the context-window gather) and then the add, the product or
    the activation;
  * ``fusion_gru`` and ``fusion_lstm`` are ``mul``'s product X·WeightX
    (their ``XX`` output, the mul's output in the unfused program) and
    then ``dynamic_gru``'s or ``dynamic_lstm``'s kernel over it.
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


# --------------------------------------------------------------------------
# fused elementwise + activation (reference fused_elemwise_activation_op;
# the TPU package's fused_ops.py:68) and batch_norm + activation (:98)
# --------------------------------------------------------------------------
_BINARY = {"elementwise_add": torch.add, "elementwise_sub": torch.sub,
           "elementwise_mul": torch.mul}


@register_op("fused_elemwise_activation", inputs=("X", "Y"),
             diff_inputs=("X", "Y"),
             attr_defaults={"functor_list": [], "axis": -1, "scale": 0.0,
                            "save_intermediate_out": False})
def _fused_elemwise_activation(ins, attrs):
    """``functor_list`` [binary, unary] computes binary(x, unary(y));
    [unary, binary] computes unary(binary(x, y)). IntermediateOut is the
    inner result. Y of lower rank aligns to X at ``axis``."""
    from .math_ops import scalar_as
    x, y = first(ins, "X"), first(ins, "Y")
    fl = list(attrs.get("functor_list") or [])
    if len(fl) != 2:
        raise ValueError("fused_elemwise_activation: functor_list must "
                         f"hold [binary, unary] (either order), got {fl}")

    def unary(name, v):
        if name.startswith("scale"):
            return v * scalar_as(attrs.get("scale", 1.0), v.dtype)
        return _act(name, v)
    axis = attrs.get("axis", -1)
    yb = y
    if y.dim() < x.dim():
        ax = axis if axis >= 0 else x.dim() - y.dim()
        shape = [1] * x.dim()
        for i, n in enumerate(y.shape):
            shape[ax + i] = n
        yb = y.reshape(shape)
    if fl[0] in _BINARY:
        inter = unary(fl[1], yb)
        o = _BINARY[fl[0]](x, inter)
    else:
        inter = _BINARY[fl[1]](x, yb)
        o = unary(fl[0], inter)
    return out(Out=o, IntermediateOut=inter)


@register_op("fused_batch_norm_act",
             inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             diff_inputs=("X", "Scale", "Bias"), stateful=True,
             attr_defaults={"momentum": 0.9, "epsilon": 1e-5,
                            "act_type": "relu", "is_test": False,
                            "data_layout": "NCHW",
                            "use_global_stats": False})
def _fused_batch_norm_act(ins, attrs):
    """``batch_norm``'s kernel, then ``act_type`` on Y. Registered
    stateful, as in the TPU package: a block that holds it runs as
    compiled segments around it (or interpreted)."""
    from .nn_ops import _batch_norm
    r = _batch_norm(ins, attrs)
    r["Y"] = [_act(attrs.get("act_type", "relu"), r["Y"][0])]
    return r


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


# --------------------------------------------------------------------------
# skip_layernorm (the TPU package's fused_ops.py:185) and the LoD fusions
# of the seq* passes (:276, :292, :364)
# --------------------------------------------------------------------------
@register_op("skip_layernorm", inputs=("X", "Y", "Scale", "Bias"),
             diff_inputs=("X", "Y", "Scale", "Bias"),
             attr_defaults={"epsilon": 1e-5, "begin_norm_axis": -1})
def _skip_layernorm(ins, attrs):
    """Out = layer_norm(X + Y) from ``begin_norm_axis`` (-1: the last
    axis), statistics in f32."""
    from .nn_ops import _layer_norm
    o = first(ins, "X") + first(ins, "Y")
    bna = int(attrs.get("begin_norm_axis", -1))
    if bna < 0:
        bna = o.dim() - 1
    return out(Out=_layer_norm(
        {"X": [o], "Scale": ins.get("Scale", [None]),
         "Bias": ins.get("Bias", [None])},
        {"epsilon": attrs.get("epsilon", 1e-5),
         "begin_norm_axis": bna})["Y"][0])


@register_op("fusion_seqconv_eltadd_relu", needs_lod=True,
             inputs=("X", "Filter", "Bias"),
             diff_inputs=("X", "Filter", "Bias"),
             attr_defaults={"contextLength": 3, "contextStart": -1,
                            "contextStride": 1})
def _fusion_seqconv_eltadd_relu(ins, attrs):
    """relu(sequence_conv(X, Filter) + Bias); ColMat is a [T, 1] zero
    (the reference's im2col scratch)."""
    from .sequence_ops import _sequence_conv
    r = _sequence_conv(ins, attrs)
    o = _act("relu", r["Out"][0] + first(ins, "Bias").reshape(1, -1))
    return {"Out": [o], "ColMat": [o.new_zeros((o.shape[0], 1))],
            "_lod": r["_lod"]}


def _lod_part(attrs, slot, i, rows):
    """Input ``i`` of ``slot``'s LoD levels (a tensor without one is one
    sequence of ``rows`` rows) and a ``_lodc`` cache of its own."""
    lods = (attrs.get("_lod") or {}).get(slot) or []
    lv = lods[i] if i < len(lods) and lods[i] is not None else ((0, rows),)
    sub = dict(attrs, _lod={slot: [lv]})
    cache = attrs.get("_lodc")
    if cache is not None:
        sub["_lodc"] = cache.setdefault((slot, i), {})
    return lv, sub


@register_op("fusion_seqpool_concat", needs_lod=True, inputs=("X",),
             attr_defaults={"pooltype": "SUM", "axis": 1})
def _fusion_seqpool_concat(ins, attrs):
    """Each X pooled per sequence (SUM or AVERAGE, ``sequence_pool``'s
    kernel: an empty sequence pools to 0), concatenated along
    ``axis``."""
    from .sequence_ops import _sequence_pool
    pools = []
    for i, x in enumerate(seq(ins, "X")):
        _, sub = _lod_part(attrs, "X", i, x.shape[0])
        sub["pooltype"] = attrs.get("pooltype", "SUM")
        sub["pad_value"] = 0.0
        pools.append(_sequence_pool({"X": [x]}, sub)["Out"][0])
    return out(Out=torch.cat(pools, dim=int(attrs.get("axis", 1))))


@register_op("fusion_seqexpand_concat_fc", needs_lod=True,
             inputs=("X", "FCWeight", "FCBias"),
             diff_inputs=("FCWeight", "FCBias"),
             attr_defaults={"fc_activation": "identity"})
def _fusion_seqexpand_concat_fc(ins, attrs):
    """X[0] [T, D0] carries the LoD; each other X [N, Di] has one row a
    sequence, repeated over its sequence's rows; all concatenated on the
    feature axis, then one fc and ``fc_activation``. FCOut is Out."""
    import numpy as np
    from .sequence_ops import _const
    from .tensor_ops import take_rows
    xs = seq(ins, "X")
    lv, _ = _lod_part(attrs, "X", 0, xs[0].shape[0])
    offs = np.asarray(lv[-1], np.int64)
    row_of = _const(attrs, "seqexpand_rows",
                    lambda: np.repeat(np.arange(len(offs) - 1),
                                      offs[1:] - offs[:-1]), xs[0].device)
    cat = torch.cat([xs[0]] + [take_rows(x, row_of) for x in xs[1:]], dim=1)
    o = torch.matmul(cat, first(ins, "FCWeight"))
    b = first(ins, "FCBias")
    if b is not None:
        o = o + b.reshape(1, -1)
    o = _act(attrs.get("fc_activation", "identity"), o)
    res = {"Out": [o], "FCOut": [o]}
    lods = (attrs.get("_lod") or {}).get("X") or []
    if lods and lods[0] is not None:
        res["_lod"] = {"Out": [lods[0]]}
    return res


# --------------------------------------------------------------------------
# the fused recurrences (reference: fused/fusion_gru_op.cc,
# fusion_lstm_op.cc): the input projection folded in
# --------------------------------------------------------------------------
def _projected(ins, attrs):
    """(XX = X·WeightX by mul's kernel, the recurrence's ins and attrs
    over it: Input XX with X's LoD, Weight WeightH)."""
    from .math_ops import _mul
    xx = _mul({"X": ins["X"], "Y": ins["WeightX"]}, {})["Out"][0]
    rins = dict(ins, Input=[xx], Weight=ins.get("WeightH"))
    lod = dict(attrs.get("_lod") or {})
    lod["Input"] = lod.get("X")
    return xx, rins, dict(attrs, _lod=lod), (lod.get("X") or [None])[0]


@register_op("fusion_gru", needs_lod=True,
             inputs=("X", "WeightX", "WeightH", "Bias", "H0"),
             diff_inputs=("X", "WeightX", "WeightH", "Bias", "H0"),
             attr_defaults={"is_reverse": False, "origin_mode": False,
                            "use_seq": True, "activation": "tanh",
                            "gate_activation": "sigmoid"})
def _fusion_gru(ins, attrs):
    from .rnn_ops import _dynamic_gru
    xx, rins, rattrs, lod = _projected(ins, attrs)
    h = _dynamic_gru(rins, rattrs)["Hidden"][0]
    return {"Hidden": [h], "XX": [xx], "_lod": {"Hidden": [lod],
                                                "XX": [lod]}}


@register_op("fusion_lstm", needs_lod=True,
             inputs=("X", "WeightX", "WeightH", "Bias", "H0", "C0"),
             diff_inputs=("X", "WeightX", "WeightH", "Bias", "H0", "C0"),
             attr_defaults={"use_peepholes": False, "is_reverse": False,
                            "gate_activation": "sigmoid",
                            "cell_activation": "tanh",
                            "candidate_activation": "tanh"})
def _fusion_lstm(ins, attrs):
    from .rnn_ops import _dyn_lstm_common
    xx, rins, rattrs, lod = _projected(ins, attrs)
    h, c = _dyn_lstm_common(rins, rattrs)
    return {"Hidden": [h], "Cell": [c], "XX": [xx],
            "_lod": {"Hidden": [lod], "Cell": [lod], "XX": [lod]}}
