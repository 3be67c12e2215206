"""word2vec — skip-gram with negative sampling / hierarchical sigmoid
(counterpart of paddle_tpu/models/word2vec.py; reference:
python/paddle/fluid/tests/book/test_word2vec.py — the N-gram neural LM
variant — and the NCE/hsigmoid ops it exercises, operators/nce_op.cc,
hierarchical_sigmoid_op.cc)."""
from __future__ import annotations

from .. import fluid
from ..fluid import layers
from ..fluid.param_attr import ParamAttr

__all__ = ["build_ngram_lm_program", "build_skipgram_program"]


def build_ngram_lm_program(dict_size=2048, emb_dim=32, hid_dim=256,
                           window=4, lr=1e-3):
    """The book's N-gram LM: concat of N-1 word embeddings → fc → softmax
    over the vocab (reference test_word2vec.py). Returns
    (main, startup, feed_names, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        words = [fluid.data(f"word_{i}", shape=[1], dtype="int64")
                 for i in range(window)]
        target = fluid.data("target", shape=[1], dtype="int64")
        embs = [layers.embedding(
            w, [dict_size, emb_dim], is_sparse=True,
            param_attr=ParamAttr(name="shared_w")) for w in words]
        concat = layers.concat(embs, axis=1)
        hidden = layers.fc(concat, hid_dim, act="sigmoid")
        predict = layers.fc(hidden, dict_size, act="softmax")
        loss = layers.mean(layers.cross_entropy(predict, target))
        fluid.optimizer.SGD(lr).minimize(loss)
    return main, startup, [w.name for w in words] + ["target"], loss


def build_skipgram_program(dict_size=2048, emb_dim=32, neg_num=5,
                           lr=1e-3, loss_type="nce"):
    """Skip-gram: center word predicts a context word; loss via NCE
    (sampled) or hierarchical sigmoid. Returns
    (main, startup, feed_names, loss)."""
    if loss_type not in ("nce", "hsigmoid"):
        raise ValueError("loss_type must be 'nce' or 'hsigmoid'")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        center = fluid.data("center", shape=[1], dtype="int64")
        context = fluid.data("context", shape=[1], dtype="int64")
        emb = layers.embedding(center, [dict_size, emb_dim],
                               is_sparse=True,
                               param_attr=ParamAttr(name="emb"))
        emb = layers.squeeze(emb, [1]) if len(emb.shape) == 3 else emb
        if loss_type == "nce":
            cost = layers.nce(input=emb, label=context,
                              num_total_classes=dict_size,
                              num_neg_samples=neg_num)
        else:
            cost = layers.hsigmoid(input=emb, label=context,
                                   num_classes=dict_size)
        loss = layers.mean(cost)
        fluid.optimizer.Adagrad(lr).minimize(loss)
    return main, startup, ["center", "context"], loss
