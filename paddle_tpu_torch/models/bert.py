"""BERT-base / transformer encoder built on the fluid layers API
(counterpart of paddle_tpu/models/bert.py; this slice: the encoder
forward — embedding, encoder layers and the padding attention bias).

Attention goes through the ``fused_attention_qkv`` op, which runs the
hand-written CUDA flash-attention kernel on the GPU
(ops/cuda/flash_attention.py). ``build_bert_pretrain_program`` comes with
the training slice."""
from __future__ import annotations

from ..fluid import layers
from ..fluid.layer_helper import LayerHelper
from ..fluid.param_attr import ParamAttr
from ..fluid.initializer import TruncatedNormal

__all__ = ["bert_base_config", "bert_embedding", "fused_multihead_attention",
           "multi_head_attention", "positionwise_ffn", "encoder_layer",
           "encoder", "padding_attn_bias"]


def bert_base_config():
    return dict(vocab_size=30522, hidden=768, layers=12, heads=12,
                ffn=3072, max_len=512, type_vocab=2)


def fused_multihead_attention(q, k, v, n_head, dropout_rate=0.0,
                              attn_bias=None, causal=False):
    """One fused attention op. q/k/v: [B, S, H]; attn_bias: optional
    additive mask broadcastable to [B, H, Sq, Sk]."""
    helper = LayerHelper("multihead_matmul")
    out = helper.create_variable_for_type_inference(q.dtype)
    out.shape = q.shape
    ins = {"Q": [q], "K": [k], "V": [v]}
    if attn_bias is not None:
        ins["Bias"] = [attn_bias]
    helper.append_op(type="fused_attention_qkv",
                     inputs=ins,
                     outputs={"Out": [out]},
                     attrs={"num_heads": n_head,
                            "dropout_rate": dropout_rate,
                            "causal": causal})
    return out


def multi_head_attention(queries, keys, values, d_model, n_head,
                         dropout_rate=0.0, param_initializer=None,
                         attn_bias=None, causal=False):
    keys = queries if keys is None else keys
    values = keys if values is None else values
    q = layers.fc(queries, d_model, num_flatten_dims=2,
                  param_attr=ParamAttr(initializer=param_initializer))
    k = layers.fc(keys, d_model, num_flatten_dims=2,
                  param_attr=ParamAttr(initializer=param_initializer))
    v = layers.fc(values, d_model, num_flatten_dims=2,
                  param_attr=ParamAttr(initializer=param_initializer))
    ctx = fused_multihead_attention(q, k, v, n_head, dropout_rate,
                                    attn_bias=attn_bias, causal=causal)
    return layers.fc(ctx, d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(initializer=param_initializer))


def positionwise_ffn(x, d_inner, d_model, dropout_rate=0.0,
                     param_initializer=None):
    if dropout_rate:
        raise NotImplementedError("positionwise_ffn: the dropout op comes "
                                  "with the training slice")
    h = layers.fc(x, d_inner, num_flatten_dims=2, act="gelu",
                  param_attr=ParamAttr(initializer=param_initializer))
    return layers.fc(h, d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(initializer=param_initializer))


def _add_norm(x, y, dropout_rate=0.0):
    if dropout_rate:
        raise NotImplementedError("_add_norm: the dropout op comes with the "
                                  "training slice")
    return layers.layer_norm(layers.elementwise_add(x, y),
                             begin_norm_axis=len(x.shape) - 1)


def encoder_layer(x, d_model, n_head, d_inner, dropout_rate=0.0,
                  param_initializer=None, attn_bias=None):
    attn = multi_head_attention(x, None, None, d_model, n_head,
                                dropout_rate, param_initializer,
                                attn_bias=attn_bias)
    x = _add_norm(x, attn, dropout_rate)
    ffn = positionwise_ffn(x, d_inner, d_model, dropout_rate,
                           param_initializer)
    return _add_norm(x, ffn, dropout_rate)


def encoder(x, n_layer, d_model, n_head, d_inner, dropout_rate=0.0,
            param_initializer=None, attn_bias=None,
            collect_layer_outs=None):
    """``collect_layer_outs``: a list that receives each layer's output
    var."""
    for _ in range(n_layer):
        x = encoder_layer(x, d_model, n_head, d_inner, dropout_rate,
                          param_initializer, attn_bias=attn_bias)
        if collect_layer_outs is not None:
            collect_layer_outs.append(x)
    return x


def padding_attn_bias(input_mask):
    """[B, S] 1/0 keep-mask → additive bias [B, 1, 1, S] for the fused
    attention ops (pads get -1e9)."""
    neg = layers.scale(input_mask, scale=-1.0, bias=1.0)
    bias = layers.scale(neg, scale=-1e9)
    return layers.unsqueeze(layers.unsqueeze(bias, [1]), [1])


def bert_embedding(src_ids, pos_ids, sent_ids, cfg, dropout_rate=0.0):
    if dropout_rate:
        raise NotImplementedError("bert_embedding: the dropout op comes "
                                  "with the training slice")
    init = TruncatedNormal(scale=0.02)
    emb = layers.embedding(src_ids, [cfg["vocab_size"], cfg["hidden"]],
                           param_attr=ParamAttr(name="word_embedding",
                                                initializer=init))
    pos = layers.embedding(pos_ids, [cfg["max_len"], cfg["hidden"]],
                           param_attr=ParamAttr(name="pos_embedding",
                                                initializer=init))
    sent = layers.embedding(sent_ids, [cfg["type_vocab"], cfg["hidden"]],
                            param_attr=ParamAttr(name="sent_embedding",
                                                 initializer=init))
    x = layers.elementwise_add(layers.elementwise_add(emb, pos), sent)
    return layers.layer_norm(x, begin_norm_axis=len(x.shape) - 1)
