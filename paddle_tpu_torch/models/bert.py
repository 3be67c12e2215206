"""BERT-base / transformer encoder built on the fluid layers API
(counterpart of paddle_tpu/models/bert.py): the encoder, the padding
attention bias, and ``build_bert_pretrain_program``, the masked-LM
pretraining step with Adam.

Attention goes through the ``fused_attention_qkv`` op, which runs the
hand-written CUDA flash-attention kernels on the GPU — the forward, and
in the grad the dK/dV and dQ kernels (ops/cuda/flash_attention.py)."""
from __future__ import annotations

from .. import fluid
from ..fluid import layers
from ..fluid.layer_helper import LayerHelper
from ..fluid.param_attr import ParamAttr
from ..fluid.initializer import TruncatedNormal

__all__ = ["bert_base_config", "bert_embedding", "fused_multihead_attention",
           "multi_head_attention", "positionwise_ffn", "encoder_layer",
           "encoder", "padding_attn_bias", "build_bert_pretrain_program"]


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
    h = layers.fc(x, d_inner, num_flatten_dims=2, act="gelu",
                  param_attr=ParamAttr(initializer=param_initializer))
    if dropout_rate:
        h = layers.dropout(h, dropout_rate,
                           dropout_implementation="upscale_in_train")
    return layers.fc(h, d_model, num_flatten_dims=2,
                     param_attr=ParamAttr(initializer=param_initializer))


def _add_norm(x, y, dropout_rate=0.0):
    if dropout_rate:
        y = layers.dropout(y, dropout_rate,
                           dropout_implementation="upscale_in_train")
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
    x = layers.layer_norm(x, begin_norm_axis=len(x.shape) - 1)
    if dropout_rate:
        x = layers.dropout(x, dropout_rate,
                           dropout_implementation="upscale_in_train")
    return x


def build_bert_pretrain_program(cfg=None, seq_len=128, dropout=0.0,
                                lr=1e-4, mlm_frac=0.15, use_amp=False,
                                use_input_mask=False, recompute=False):
    """Masked-LM pretraining step program: the encoder, the masked
    positions gathered from its output, an fc to the vocabulary, softmax
    cross-entropy, its mean, and Adam. Feeds: src_ids, pos_ids, sent_ids
    [B,S] int64; mask_pos [M,1] int64 (flattened positions), mask_label
    [M,1] int64; plus input_mask [B,S] float32 when use_input_mask (pads
    excluded from attention). ``dropout`` is the hidden and attention
    dropout (BERT pretrains at 0.1). Returns (main, startup, feed vars,
    [loss]). ``mlm_frac`` is the caller's business (it sizes M) and is
    accepted for the TPU package's signature. use_amp: bf16 activations
    through contrib.mixed_precision (f32 master weights, f32 norm and
    softmax). recompute: per-encoder-layer RecomputeOptimizer checkpoints
    (each layer's activations recomputed in its backward instead of
    stored)."""
    cfg = cfg or bert_base_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data("src_ids", shape=[seq_len], dtype="int64")
        pos = fluid.data("pos_ids", shape=[seq_len], dtype="int64")
        sent = fluid.data("sent_ids", shape=[seq_len], dtype="int64")
        mask_pos = fluid.data("mask_pos", shape=[1], dtype="int64",
                              append_batch_size=True)
        mask_label = fluid.data("mask_label", shape=[1], dtype="int64")
        attn_bias = None
        extra_feeds = []
        if use_input_mask:
            input_mask = fluid.data("input_mask", shape=[seq_len],
                                    dtype="float32")
            attn_bias = padding_attn_bias(input_mask)
            extra_feeds = [input_mask]
        x = bert_embedding(src, pos, sent, cfg, dropout)
        layer_outs = [] if recompute else None
        enc = encoder(x, cfg["layers"], cfg["hidden"], cfg["heads"],
                      cfg["ffn"], dropout, attn_bias=attn_bias,
                      collect_layer_outs=layer_outs)
        flat = layers.reshape(enc, [-1, cfg["hidden"]])
        picked = layers.gather(flat, mask_pos)
        logits = layers.fc(picked, cfg["vocab_size"])
        loss = layers.mean(
            layers.softmax_with_cross_entropy(logits, mask_label))
        opt = fluid.optimizer.Adam(lr)
        if use_amp:
            from ..fluid.contrib import mixed_precision
            opt = mixed_precision.decorate(opt)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(layer_outs[:-1])
        opt.minimize(loss)
    return main, startup, \
        [src, pos, sent, mask_pos, mask_label] + extra_feeds, [loss]
