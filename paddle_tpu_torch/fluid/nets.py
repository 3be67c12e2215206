"""fluid.nets: composites over fluid.layers (counterpart of
paddle_tpu/fluid/nets.py; reference: python/paddle/fluid/nets.py). So
far: simple_img_conv_pool, img_conv_group, sequence_conv_pool and
glu."""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    """conv2d + pool2d (reference nets.py simple_img_conv_pool)."""
    conv_out = layers.conv2d(input, num_filters=num_filters,
                             filter_size=filter_size, stride=conv_stride,
                             padding=conv_padding, dilation=conv_dilation,
                             groups=conv_groups, param_attr=param_attr,
                             bias_attr=bias_attr, act=act)
    return layers.pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """A VGG-style group of conv2d (+ batch_norm + dropout) layers ending
    in one pool2d (reference nets.py img_conv_group)."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _expand(v):
        return [v] * len(conv_num_filter) if not isinstance(
            v, (list, tuple)) else list(v)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i, nf in enumerate(conv_num_filter):
        local_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(tmp, num_filters=nf,
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i]:
                tmp = layers.dropout(tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    """sequence_conv + sequence_pool over a LoD input (reference nets.py
    sequence_conv_pool: the text conv nets)."""
    conv_out = layers.sequence_conv(input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act,
                                    bias_attr=bias_attr)
    return layers.sequence_pool(conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: ``input`` split in two along ``dim``, a ·
    sigmoid(b) (reference nets.py glu)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))
