"""ResNet on the fluid layers API (counterpart of paddle_tpu/models/
resnet.py: conv2d/batch_norm/pool2d stacks; BASELINE.md names ResNet-50
ImageNet as a headline configuration).

NCHW throughout, as cuDNN takes it; under FLAGS_use_bf16_matmul the
convolutions and the classifier's product take bf16 operands."""
from __future__ import annotations

from .. import fluid
from ..fluid import layers

__all__ = ["resnet50", "build_resnet_train_program"]

_DEPTH_CFG = {
    18: ([2, 2, 2, 2], "basic"),
    34: ([3, 4, 6, 3], "basic"),
    50: ([3, 4, 6, 3], "bottleneck"),
    101: ([3, 4, 23, 3], "bottleneck"),
    152: ([3, 8, 36, 3], "bottleneck"),
}


def _conv_bn(x, num_filters, filter_size, stride=1, act=None, name=None):
    conv = layers.conv2d(x, num_filters, filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, bias_attr=False,
                         name=name)
    return layers.batch_norm(conv, act=act)


def _shortcut(x, num_filters, stride):
    in_c = x.shape[1]
    if in_c != num_filters or stride != 1:
        return _conv_bn(x, num_filters, 1, stride)
    return x


def _bottleneck(x, num_filters, stride):
    conv0 = _conv_bn(x, num_filters, 1, act="relu")
    conv1 = _conv_bn(conv0, num_filters, 3, stride=stride, act="relu")
    conv2 = _conv_bn(conv1, num_filters * 4, 1)
    short = _shortcut(x, num_filters * 4, stride)
    return layers.elementwise_add(short, conv2, act="relu")


def _basic(x, num_filters, stride):
    conv0 = _conv_bn(x, num_filters, 3, stride=stride, act="relu")
    conv1 = _conv_bn(conv0, num_filters, 3)
    short = _shortcut(x, num_filters, stride)
    return layers.elementwise_add(short, conv1, act="relu")


def resnet(x, class_dim=1000, depth=50):
    blocks, kind = _DEPTH_CFG[depth]
    num_filters = [64, 128, 256, 512]
    y = _conv_bn(x, 64, 7, stride=2, act="relu")
    y = layers.pool2d(y, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    fn = _bottleneck if kind == "bottleneck" else _basic
    for stage, n in enumerate(blocks):
        for i in range(n):
            y = fn(y, num_filters[stage],
                   stride=2 if i == 0 and stage > 0 else 1)
    y = layers.pool2d(y, pool_type="avg", global_pooling=True)
    y = layers.flatten(y, axis=1)
    return layers.fc(y, class_dim, act="softmax")


def resnet50(x, class_dim=1000):
    return resnet(x, class_dim, 50)


def build_resnet_train_program(depth=50, class_dim=1000, image_size=224,
                               lr=0.1, momentum=0.9):
    """Returns (main, startup, feeds, fetches) for a ResNet train step:
    image [B, 3, image_size, image_size] f32 and label [B, 1] int64 in,
    [mean cross-entropy, top-1 accuracy] out, Momentum(lr, momentum)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.data("image", shape=[3, image_size, image_size],
                         dtype="float32")
        label = fluid.data("label", shape=[1], dtype="int64")
        pred = resnet(img, class_dim, depth)
        loss = layers.mean(layers.cross_entropy(pred, label))
        acc = layers.accuracy(pred, label)
        opt = fluid.optimizer.Momentum(lr, momentum=momentum)
        opt.minimize(loss)
    return main, startup, [img, label], [loss, acc]
