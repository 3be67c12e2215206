"""Wide & Deep CTR model (counterpart of paddle_tpu/models/wide_deep.py;
reference CTR workload: tests/unittests/dist_fleet_ctr.py).

The wide part is a per-slot 1-d embedding summed with a linear map of the
dense features; the deep part concatenates per-slot embeddings with the
dense features into an MLP. The training program keeps the streaming AUC
op, which is stateful: the executor runs the block as compiled segments
(the forward; the backward and the optimizer) around the ``auc`` island.
Parameter names and the synthetic data's numpy draws are the TPU
package's, so both packages train the same model on the same batches.
"""
from __future__ import annotations

import numpy as np

from .. import fluid
from ..fluid import layers

__all__ = ["wide_deep_net", "build_wide_deep_program", "ctr_reader"]


def wide_deep_net(dense, sparse_slots, sparse_dim=int(1e4), embedding_dim=16,
                  hidden=(400, 400, 400), is_sparse=False,
                  is_distributed=False):
    """Wide: per-slot hashed linear embeddings summed with the dense
    projection. Deep: per-slot dense embeddings + MLP. Returns the click
    probability [N, 1]."""
    wide_embs = []
    for i, slot in enumerate(sparse_slots):
        w = layers.embedding(
            slot, size=[sparse_dim, 1], is_sparse=is_sparse,
            is_distributed=is_distributed, param_attr="wide_emb_%d" % i)
        wide_embs.append(layers.reshape(w, [-1, 1]))
    wide = layers.fc(dense, 1, param_attr="wide_dense_w",
                     bias_attr="wide_dense_b")
    for e in wide_embs:
        wide = layers.elementwise_add(wide, e)

    deep_embs = []
    for i, slot in enumerate(sparse_slots):
        e = layers.embedding(
            slot, size=[sparse_dim, embedding_dim], is_sparse=is_sparse,
            is_distributed=is_distributed, param_attr="deep_emb_%d" % i)
        deep_embs.append(layers.reshape(e, [-1, embedding_dim]))
    deep = layers.concat([dense] + deep_embs, axis=1)
    for j, h in enumerate(hidden):
        deep = layers.fc(deep, h, act="relu",
                         param_attr="deep_fc_w_%d" % j,
                         bias_attr="deep_fc_b_%d" % j)
    deep = layers.fc(deep, 1, param_attr="deep_out_w",
                     bias_attr="deep_out_b")

    return layers.sigmoid(layers.elementwise_add(wide, deep))


def build_wide_deep_program(num_dense=13, num_slots=26, sparse_dim=int(1e4),
                            embedding_dim=16, hidden=(400, 400, 400),
                            lr=1e-3, is_sparse=False, is_distributed=False,
                            optimizer=None, with_auc=True):
    """Returns (main, startup, feed_names, loss, auc_var): mean log loss
    of the click probability, Adam(``lr``) unless ``optimizer`` is given,
    and with ``with_auc`` the streaming AUC of [1 - p, p] against the
    label (auc_var None without it: the block then compiles whole)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        dense = fluid.data("dense", shape=[num_dense], dtype="float32")
        slots = [fluid.data("slot_%d" % i, shape=[1], dtype="int64")
                 for i in range(num_slots)]
        label = fluid.data("label", shape=[1], dtype="int64")
        prob = wide_deep_net(dense, slots, sparse_dim, embedding_dim,
                             hidden, is_sparse, is_distributed)
        labelf = layers.cast(label, "float32")
        loss = layers.mean(layers.log_loss(prob, labelf))
        auc = None
        if with_auc:
            auc, _ = layers.auc(layers.concat([1.0 - prob, prob], axis=1),
                                label)
        opt = optimizer or fluid.optimizer.Adam(lr)
        opt.minimize(loss)
    feeds = ["dense"] + ["slot_%d" % i for i in range(num_slots)] + ["label"]
    return main, startup, feeds, loss, auc


def ctr_reader(batch, num_dense=13, num_slots=26, sparse_dim=int(1e4),
               seed=0):
    """Synthetic CTR batches with learnable structure: the label
    correlates with a few slots' ids and the dense part. Returns a
    function that makes the next feed dict."""
    rng = np.random.RandomState(seed)
    w_dense = rng.randn(num_dense) * 3.0
    # informative slots draw from a small id range so that their "hot" id
    # is frequent enough to learn
    n_info = min(4, num_slots)
    info_range = min(8, sparse_dim)
    hot = rng.randint(0, info_range, size=n_info)

    def next_batch():
        dense = rng.rand(batch, num_dense).astype("float32")
        slots = [rng.randint(0, info_range if i < n_info else sparse_dim,
                             (batch, 1)).astype("int64")
                 for i in range(num_slots)]
        logit = (dense - 0.5) @ w_dense
        for i, s in enumerate(slots[:n_info]):
            logit = logit + 2.0 * ((s[:, 0] == hot[i]) - 1.0 / info_range)
        p = 1.0 / (1.0 + np.exp(-logit))
        label = (rng.rand(batch) < p).astype("int64").reshape(-1, 1)
        feed = {"dense": dense, "label": label}
        for i, s in enumerate(slots):
            feed["slot_%d" % i] = s
        return feed
    return next_batch
