"""recognize_digits — the book's first model (counterpart of
paddle_tpu/models/mnist.py; reference: python/paddle/fluid/tests/book/
test_recognize_digits.py). So far the MLP: the LeNet-style conv net needs
conv2d, pool2d and batch_norm, which a later slice ports."""
from __future__ import annotations

from .. import fluid
from ..fluid import layers

__all__ = ["mlp", "build_mnist_program"]


def mlp(img):
    h1 = layers.fc(img, 128, act="relu")
    h2 = layers.fc(h1, 64, act="relu")
    return layers.fc(h2, 10, act="softmax")


def build_mnist_program(net="mlp", lr=0.01):
    """Returns (main, startup, feed_names, loss, acc): the MLP over
    img [B, 784] f32, cross-entropy against label [B, 1] int64, its mean,
    top-1 accuracy and Adam."""
    if net == "conv":
        raise NotImplementedError(
            "build_mnist_program(net='conv'): the conv net needs conv2d, "
            "pool2d and batch_norm, which come in a later slice of "
            "paddle_tpu_torch (ROADMAP A9)")
    if net != "mlp":
        raise ValueError("net must be 'mlp' or 'conv'")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("img", shape=[784], dtype="float32")
        pred = mlp(img)
        label = fluid.data("label", shape=[1], dtype="int64")
        loss = layers.mean(layers.cross_entropy(pred, label))
        acc = layers.accuracy(pred, label)
        fluid.optimizer.Adam(lr).minimize(loss)
    return main, startup, ["img", "label"], loss, acc
