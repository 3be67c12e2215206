"""fluid.contrib.layers' op builders (counterpart of
paddle_tpu/fluid/contrib/layers/nn.py; reference: contrib/layers/nn.py):
the search, text-match, CTR and ads ops. As in the TPU package, a builder
that takes ``act`` hands it to no LayerHelper, so no activation is
appended (var_conv_2d, match_matrix_tensor, tree_conv, batch_fc), and
``multiclass_nms2(return_index=True)`` raises."""
from __future__ import annotations

from ...layer_helper import LayerHelper
from ...core import VarDesc

__all__ = [
    "fused_elemwise_activation", "var_conv_2d", "match_matrix_tensor",
    "sequence_topk_avg_pooling", "tree_conv", "fused_embedding_seq_pool",
    "multiclass_nms2", "shuffle_batch", "partial_concat", "partial_sum",
    "rank_attention", "batch_fc",
]


def _op(op_type, ins, attrs=None, out_slots=("Out",), dtype=None):
    helper = LayerHelper(op_type)
    if dtype is None:
        dtype = next((v.dtype for vals in ins.values() for v in vals
                      if v is not None and hasattr(v, "dtype")),
                     VarDesc.VarType.FP32)
    outs = {s: [helper.create_variable_for_type_inference(dtype)]
            for s in out_slots}
    helper.append_op(type=op_type, inputs=ins, outputs=outs,
                     attrs=attrs or {})
    vals = [outs[s][0] for s in out_slots]
    return vals[0] if len(vals) == 1 else tuple(vals)


def fused_elemwise_activation(x, y, functor_list, axis=-1, scale=0.0,
                              save_intermediate_out=True):
    """reference contrib/layers/nn.py:41."""
    return _op("fused_elemwise_activation", {"X": [x], "Y": [y]},
               {"functor_list": list(functor_list), "axis": axis,
                "scale": scale,
                "save_intermediate_out": save_intermediate_out},
               out_slots=("Out",))


def var_conv_2d(input, row, col, input_channel, output_channel,
                filter_size, stride=1, param_attr=None, act=None,
                dtype="float32", name=None):
    """reference contrib/layers/nn.py:105 — conv over variable-sized 2D
    feature maps described by ROW/COLUMN LoD."""
    helper = LayerHelper("var_conv_2d", name=name)
    fs = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size, filter_size]
    st = stride if isinstance(stride, (list, tuple)) else [stride, stride]
    w = helper.create_parameter(
        attr=helper.param_attr if param_attr is None else param_attr,
        shape=[output_channel, input_channel * fs[0] * fs[1]],
        dtype=dtype)
    out = _op("var_conv_2d",
              {"X": [input], "ROW": [row], "COLUMN": [col], "W": [w]},
              {"InputChannel": input_channel,
               "OutputChannel": output_channel,
               "StrideH": st[0], "StrideW": st[1],
               "KernelH": fs[0], "KernelW": fs[1]})
    return helper.append_activation(out) if act else out


def match_matrix_tensor(x, y, channel_num, act=None, param_attr=None,
                        dtype="float32", name=None):
    """reference contrib/layers/nn.py:222."""
    helper = LayerHelper("match_matrix_tensor", name=name)
    w = helper.create_parameter(
        attr=helper.param_attr if param_attr is None else param_attr,
        shape=[int(x.shape[-1]), channel_num, int(y.shape[-1])],
        dtype=dtype)
    out, tmp = _op("match_matrix_tensor",
                   {"X": [x], "Y": [y], "W": [w]},
                   {"dim_t": channel_num},
                   out_slots=("Out", "Tmp"))
    return (helper.append_activation(out) if act else out), tmp


def sequence_topk_avg_pooling(input, row, col, topks, channel_num):
    """reference contrib/layers/nn.py:309."""
    return _op("sequence_topk_avg_pooling",
               {"X": [input], "ROW": [row], "COLUMN": [col]},
               {"topks": list(topks), "channel_num": channel_num},
               out_slots=("Out",))


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    """reference contrib/layers/nn.py:377."""
    helper = LayerHelper("tree_conv", name=name)
    dtype = nodes_vector.dtype
    w = helper.create_parameter(
        attr=helper.param_attr if param_attr is None else param_attr,
        shape=[int(nodes_vector.shape[-1]), 3, output_size, num_filters],
        dtype=dtype)
    out = _op("tree_conv",
              {"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
               "Filter": [w]},
              {"max_depth": max_depth}, out_slots=("Out",))
    return helper.append_activation(out) if act else out


def fused_embedding_seq_pool(input, size, is_sparse=False,
                             padding_idx=None, combiner="sum",
                             param_attr=None, dtype="float32"):
    """reference contrib/layers/nn.py:447."""
    helper = LayerHelper("fused_embedding_seq_pool")
    w = helper.create_parameter(
        attr=helper.param_attr if param_attr is None else param_attr,
        shape=list(size), dtype=dtype)
    return _op("fused_embedding_seq_pool", {"W": [w], "Ids": [input]},
               {"combiner": combiner, "is_sparse": is_sparse,
                "padding_idx": -1 if padding_idx is None else padding_idx})


def multiclass_nms2(bboxes, scores, score_threshold, nms_top_k,
                    keep_top_k, nms_threshold=0.3, normalized=True,
                    nms_eta=1.0, background_label=0,
                    return_index=False, name=None):
    """reference contrib/layers/nn.py:514."""
    if return_index:
        raise NotImplementedError(
            "multiclass_nms2(return_index=True): the kernel does not "
            "emit the Index output yet — use the Out tensor")
    helper = LayerHelper("multiclass_nms2", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    index = helper.create_variable_for_type_inference(
        VarDesc.VarType.INT32)
    helper.append_op(
        type="multiclass_nms2",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out], "Index": [index]},
        attrs={"score_threshold": score_threshold,
               "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
               "nms_threshold": nms_threshold, "normalized": normalized,
               "nms_eta": nms_eta, "background_label": background_label})
    return (out, index) if return_index else out


def shuffle_batch(x, seed=None):
    """reference contrib/layers/nn.py shuffle_batch."""
    ins = {"X": [x]}
    attrs = {}
    if isinstance(seed, int):
        attrs["startup_seed"] = seed
    return _op("shuffle_batch", ins, attrs,
               out_slots=("Out",))


def partial_concat(input, start_index=0, length=-1):
    """reference contrib/layers/nn.py partial_concat."""
    return _op("partial_concat", {"X": list(input)},
               {"start_index": start_index, "length": length})


def partial_sum(input, start_index=0, length=-1):
    return _op("partial_sum", {"X": list(input)},
               {"start_index": start_index, "length": length})


def rank_attention(input, rank_offset, rank_param_shape, rank_param_attr,
                   max_rank=3):
    """reference contrib/layers/nn.py rank_attention (ads ranking)."""
    helper = LayerHelper("rank_attention")
    w = helper.create_parameter(attr=rank_param_attr,
                                shape=list(rank_param_shape),
                                dtype=input.dtype)
    return _op("rank_attention",
               {"X": [input], "RankOffset": [rank_offset],
                "RankParam": [w]},
               {"MaxRank": max_rank}, out_slots=("Out",))


def batch_fc(input, param_size, param_attr, bias_size, bias_attr,
             act=None):
    """reference contrib/layers/nn.py batch_fc (per-batch-slot fc)."""
    helper = LayerHelper("batch_fc")
    w = helper.create_parameter(attr=param_attr, shape=list(param_size),
                                dtype=input.dtype)
    b = helper.create_parameter(attr=bias_attr, shape=list(bias_size),
                                dtype=input.dtype)
    out = _op("batch_fc", {"Input": [input], "W": [w], "Bias": [b]})
    return helper.append_activation(out) if act else out
