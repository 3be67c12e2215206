"""recognize_digits — the book's first model, MLP and LeNet-style conv
variants (counterpart of paddle_tpu/models/mnist.py; reference:
python/paddle/fluid/tests/book/test_recognize_digits.py)."""
from __future__ import annotations

from .. import fluid
from ..fluid import layers

__all__ = ["mlp", "convnet", "build_mnist_program"]


def mlp(img):
    h1 = layers.fc(img, 128, act="relu")
    h2 = layers.fc(h1, 64, act="relu")
    return layers.fc(h2, 10, act="softmax")


def convnet(img):
    """LeNet-ish conv-pool x2 + fc (reference conv_net)."""
    x = layers.conv2d(img, num_filters=20, filter_size=5, act="relu")
    x = layers.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")
    x = layers.batch_norm(x)
    x = layers.conv2d(x, num_filters=50, filter_size=5, act="relu")
    x = layers.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")
    return layers.fc(x, 10, act="softmax")


def build_mnist_program(net="mlp", lr=0.01):
    """Returns (main, startup, feed_names, loss, acc): the MLP over
    img [B, 784] f32 (``net="mlp"``) or the conv net over img
    [B, 1, 28, 28] (``net="conv"``), cross-entropy against label [B, 1]
    int64, its mean, top-1 accuracy and Adam."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        if net == "mlp":
            img = fluid.data("img", shape=[784], dtype="float32")
            pred = mlp(img)
        elif net == "conv":
            img = fluid.data("img", shape=[1, 28, 28], dtype="float32")
            pred = convnet(img)
        else:
            raise ValueError("net must be 'mlp' or 'conv'")
        label = fluid.data("label", shape=[1], dtype="int64")
        loss = layers.mean(layers.cross_entropy(pred, label))
        acc = layers.accuracy(pred, label)
        fluid.optimizer.Adam(lr).minimize(loss)
    return main, startup, ["img", "label"], loss, acc
