"""SE-ResNeXt on the fluid layers API (counterpart of
paddle_tpu/models/se_resnext.py; reference: tests/unittests/
test_imperative_se_resnext.py / dist_se_resnext.py — ResNeXt bottlenecks
with cardinality-grouped 3x3 convs plus squeeze-and-excitation channel
gating).

The grouped convolutions are cuDNN's (conv2d's ``groups``); the
classifier's dropout at 0.5 is the port's dropout kernel on the card."""
from __future__ import annotations

from .. import fluid
from ..fluid import layers
from ..fluid.param_attr import ParamAttr

__all__ = ["se_resnext50", "build_se_resnext_train_program"]

_DEPTH_CFG = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def _conv_bn(x, num_filters, filter_size, stride=1, groups=1, act=None):
    conv = layers.conv2d(x, num_filters, filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _squeeze_excitation(x, num_channels, reduction_ratio=16):
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, num_channels // reduction_ratio, act="relu")
    excite = layers.fc(squeeze, num_channels, act="sigmoid")
    excite = layers.unsqueeze(layers.unsqueeze(excite, [2]), [3])
    return layers.elementwise_mul(x, excite, axis=0)


def _bottleneck(x, num_filters, stride, cardinality=32,
                reduction_ratio=16):
    conv0 = _conv_bn(x, num_filters, 1, act="relu")
    conv1 = _conv_bn(conv0, num_filters, 3, stride=stride,
                     groups=cardinality, act="relu")
    conv2 = _conv_bn(conv1, num_filters * 2, 1)
    se = _squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    in_c = x.shape[1]
    if in_c != num_filters * 2 or stride != 1:
        short = _conv_bn(x, num_filters * 2, 1, stride=stride)
    else:
        short = x
    return layers.relu(layers.elementwise_add(short, se))


def se_resnext50(x, class_dim=1000, depth=50, cardinality=32):
    if depth not in _DEPTH_CFG:
        raise ValueError(f"depth must be one of {sorted(_DEPTH_CFG)}")
    blocks = _DEPTH_CFG[depth]
    x = _conv_bn(x, 64, 7, stride=2, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    num_filters = [128, 256, 512, 1024]
    for stage, n in enumerate(blocks):
        for i in range(n):
            x = _bottleneck(x, num_filters[stage],
                            stride=2 if i == 0 and stage != 0 else 1,
                            cardinality=cardinality)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.5)
    return layers.fc(drop, class_dim, act="softmax",
                     param_attr=ParamAttr(name="fc_out_w"))


def build_se_resnext_train_program(class_dim=1000, image_size=224,
                                   depth=50, lr=0.1, momentum=0.9):
    """Returns (main, startup, feed_names, loss, acc)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("image", shape=[3, image_size, image_size],
                         dtype="float32")
        label = fluid.data("label", shape=[1], dtype="int64")
        pred = se_resnext50(img, class_dim, depth)
        loss = layers.mean(layers.cross_entropy(pred, label))
        acc = layers.accuracy(pred, label)
        fluid.optimizer.Momentum(lr, momentum=momentum,
                                 use_nesterov=True).minimize(loss)
    return main, startup, ["image", "label"], loss, acc
