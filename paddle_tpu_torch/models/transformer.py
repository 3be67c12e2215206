"""Transformer for machine translation, the WMT configs (counterpart of
paddle_tpu/models/transformer.py; Vaswani et al. 2017, base and big).

Fixed [B, S] batches with the padding as an additive attention bias. The
training program takes label-smoothed cross-entropy over the target
vocabulary, masked to the real target tokens, and Adam, with Noam decay
when ``lr`` is None. The greedy-decode program runs the encoder and the
decoder over a fixed window of ``max_out_len`` target ids and returns
the logits at every position: the caller's host loop takes the argmax at
the current position and feeds the grown prefix again (each run a replay
of one compiled program)."""
from __future__ import annotations

from .. import fluid
from ..fluid import layers
from ..fluid.initializer import Xavier
from ..fluid.param_attr import ParamAttr
from .bert import (multi_head_attention, positionwise_ffn, _add_norm,
                   padding_attn_bias)

__all__ = ["transformer_base_config", "transformer_big_config",
           "encoder_stack", "decoder_stack", "build_wmt_train_program",
           "build_greedy_decode_program"]


def transformer_base_config():
    return dict(src_vocab=37000, trg_vocab=37000, d_model=512, d_inner=2048,
                heads=8, enc_layers=6, dec_layers=6, max_len=256,
                dropout=0.1, label_smooth=0.1)


def transformer_big_config():
    cfg = transformer_base_config()
    cfg.update(d_model=1024, d_inner=4096, heads=16, dropout=0.3)
    return cfg


def _embed(ids, vocab, d_model, name):
    """Token embedding × sqrt(d_model), plus the sinusoidal positions."""
    emb = layers.embedding(
        ids, [vocab, d_model],
        param_attr=ParamAttr(name=name, initializer=Xavier()))
    emb = layers.scale(emb, scale=float(d_model) ** 0.5)
    return layers.add_position_encoding(emb, alpha=1.0, beta=1.0)


def _pad_bias(pad_mask, n_head):
    """[B, S] 1/0 keep-mask → additive bias [B, 1, 1, S]."""
    return padding_attn_bias(pad_mask)


def encoder_stack(src_emb, cfg, src_bias=None):
    x = src_emb
    for _ in range(cfg["enc_layers"]):
        attn = multi_head_attention(x, None, None, cfg["d_model"],
                                    cfg["heads"], cfg["dropout"],
                                    attn_bias=src_bias)
        x = _add_norm(x, attn, cfg["dropout"])
        ffn = positionwise_ffn(x, cfg["d_inner"], cfg["d_model"],
                               cfg["dropout"])
        x = _add_norm(x, ffn, cfg["dropout"])
    return x


def decoder_stack(trg_emb, enc_out, cfg, trg_bias=None, src_bias=None):
    """Causal self-attention (with the target's padding bias), then
    attention over the encoder's output, then the FFN, each with its
    residual and layer norm."""
    x = trg_emb
    for _ in range(cfg["dec_layers"]):
        self_attn = multi_head_attention(x, None, None, cfg["d_model"],
                                         cfg["heads"], cfg["dropout"],
                                         attn_bias=trg_bias, causal=True)
        x = _add_norm(x, self_attn, cfg["dropout"])
        cross = multi_head_attention(x, enc_out, enc_out, cfg["d_model"],
                                     cfg["heads"], cfg["dropout"],
                                     attn_bias=src_bias)
        x = _add_norm(x, cross, cfg["dropout"])
        ffn = positionwise_ffn(x, cfg["d_inner"], cfg["d_model"],
                               cfg["dropout"])
        x = _add_norm(x, ffn, cfg["dropout"])
    return x


def _logits(dec_out, cfg):
    return layers.fc(dec_out, cfg["trg_vocab"], num_flatten_dims=2,
                     param_attr=ParamAttr(name="trg_proj",
                                          initializer=Xavier()))


def build_wmt_train_program(cfg=None, src_len=32, trg_len=32, lr=1e-3,
                            warmup_steps=4000):
    """The training program. Feeds: src_ids, trg_ids [B, S] int64;
    src_mask, trg_mask [B, S] f32 1/0 keep-masks; labels [B, S, 1] int64.
    The loss is the label-smoothed cross-entropy summed over the target
    tokens the mask keeps, over their count; Adam(β₁ 0.9, β₂ 0.997, ε
    1e-9) at ``lr``, or at Noam decay (d_model, ``warmup_steps``) when
    ``lr`` is None. Returns (main, startup, feed names, loss)."""
    cfg = cfg or transformer_base_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data("src_ids", shape=[src_len], dtype="int64")
        smask = fluid.data("src_mask", shape=[src_len], dtype="float32")
        trg = fluid.data("trg_ids", shape=[trg_len], dtype="int64")
        tmask = fluid.data("trg_mask", shape=[trg_len], dtype="float32")
        label = fluid.data("labels", shape=[trg_len, 1], dtype="int64")
        src_bias = _pad_bias(smask, cfg["heads"])
        trg_bias = _pad_bias(tmask, cfg["heads"])
        enc = encoder_stack(_embed(src, cfg["src_vocab"], cfg["d_model"],
                                   "src_embedding"), cfg, src_bias)
        dec = decoder_stack(_embed(trg, cfg["trg_vocab"], cfg["d_model"],
                                   "trg_embedding"), enc, cfg,
                            trg_bias, src_bias)
        logits = _logits(dec, cfg)
        probs = layers.softmax(logits)
        one_hot = layers.one_hot(label, cfg["trg_vocab"])
        smooth = layers.label_smooth(one_hot, epsilon=cfg["label_smooth"])
        ce = layers.cross_entropy(probs, smooth, soft_label=True)
        # padding positions do not count
        ce = layers.elementwise_mul(layers.squeeze(ce, [2]), tmask)
        denom = layers.reduce_sum(tmask)
        loss = layers.elementwise_div(layers.reduce_sum(ce), denom)
        sched = layers.noam_decay(cfg["d_model"], warmup_steps) \
            if lr is None else lr
        fluid.optimizer.Adam(learning_rate=sched, beta1=0.9,
                             beta2=0.997, epsilon=1e-9).minimize(loss)
    feeds = ["src_ids", "src_mask", "trg_ids", "trg_mask", "labels"]
    return main, startup, feeds, loss


def build_greedy_decode_program(cfg=None, src_len=32, max_out_len=32):
    """The decode program: the encoder over src_ids [B, src_len] (with
    src_mask), the decoder over trg_ids [B, max_out_len] (causal, no
    target padding bias). Returns (program, startup, feed names, logits
    [B, max_out_len, trg_vocab]); position p's logits depend on trg_ids
    up to p only."""
    cfg = cfg or transformer_base_config()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = fluid.data("src_ids", shape=[src_len], dtype="int64")
        smask = fluid.data("src_mask", shape=[src_len], dtype="float32")
        trg = fluid.data("trg_ids", shape=[max_out_len], dtype="int64")
        src_bias = _pad_bias(smask, cfg["heads"])
        enc = encoder_stack(_embed(src, cfg["src_vocab"], cfg["d_model"],
                                   "src_embedding"), cfg, src_bias)
        dec = decoder_stack(_embed(trg, cfg["trg_vocab"], cfg["d_model"],
                                   "trg_embedding"), enc, cfg,
                            None, src_bias)
        logits = _logits(dec, cfg)
    return main, startup, ["src_ids", "src_mask", "trg_ids"], logits
