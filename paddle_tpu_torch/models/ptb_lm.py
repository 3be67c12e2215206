"""PTB LSTM language model (counterpart of paddle_tpu/models/ptb_lm.py;
reference: tests/unittests/test_imperative_ptb_rnn.py / the book's RNN LM
— embedding → stacked LSTM → projection, trained with per-position cross
entropy).

Fixed [B, T] windows (truncated BPTT): the lstm op's loop over T steps
is static, so the whole step is one CUDA graph on the card."""
from __future__ import annotations

from .. import fluid
from ..fluid import layers
from ..fluid.param_attr import ParamAttr

__all__ = ["build_ptb_lm_program"]


def build_ptb_lm_program(vocab_size=1000, hidden_size=64, num_layers=1,
                         num_steps=20, init_scale=0.1, lr=1.0,
                         max_grad_norm=5.0):
    """Returns (main, startup, feed_names, loss, last_hidden, last_cell)."""
    from ..fluid.initializer import UniformInitializer
    main, startup = fluid.Program(), fluid.Program()
    u = lambda: UniformInitializer(-init_scale, init_scale)
    with fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[num_steps], dtype="int64")
        y = fluid.data("y", shape=[num_steps, 1], dtype="int64")
        emb = layers.embedding(
            x, [vocab_size, hidden_size],
            param_attr=ParamAttr(name="embedding_para",
                                 initializer=u()))
        # stacked LSTM over the whole window (lstm op → lax.scan)
        init_h = layers.fill_constant_batch_size_like(
            emb, [-1, num_layers, hidden_size], "float32", 0.0)
        init_c = layers.fill_constant_batch_size_like(
            emb, [-1, num_layers, hidden_size], "float32", 0.0)
        init_h = layers.transpose(init_h, [1, 0, 2])
        init_c = layers.transpose(init_c, [1, 0, 2])
        rnn_out, last_h, last_c = layers.lstm(
            emb, init_h, init_c, num_steps, hidden_size, num_layers)
        logits = layers.fc(rnn_out, vocab_size, num_flatten_dims=2,
                           param_attr=ParamAttr(name="softmax_w",
                                                initializer=u()),
                           bias_attr=ParamAttr(name="softmax_b",
                                               initializer=u()))
        probs = layers.softmax(logits)
        ce = layers.cross_entropy(probs, y)        # [B, T, 1]
        loss = layers.reduce_mean(layers.reduce_sum(ce, dim=1))
        clip = fluid.clip.GradientClipByGlobalNorm(max_grad_norm)
        fluid.optimizer.SGD(lr, grad_clip=clip).minimize(loss)
    return main, startup, ["x", "y"], loss, last_h, last_c
