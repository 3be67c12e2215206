"""The one-card part of paddle_tpu/ops/ps_quant_misc_ops.py: the legacy
reader ops, ``cudnn_lstm`` and the two engine stubs. Its parameter
server, DGC and INT8 ops are ROADMAP A7 (c), A8 and A9.

The reader ops (reference: reader/create_py_reader_op.cc, read_op.cc)
are host ops over a queue object held in a scope var: ``create_py_reader``
binds the queue of its ``blocking_queue`` var into its reader var, the
double-buffer and custom readers pass their underlying reader on, and
``read`` pops one batch (a sequence of arrays or LoDTensors) into its
Out vars on the executor's device, raising StopIteration when the queue
is done (its ``pop`` gives None). ``fluid.layers.py_reader`` appends none
of them (as in the TPU package): its reader is a ``PyReader`` over data
vars."""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op
from .rnn_ops import _lstm


@register_op("create_py_reader", stateful=True, no_grad=True,
             attr_defaults={"shape_concat": [], "lod_levels": [],
                            "ranks": [], "dtypes": []})
def _create_py_reader(ins, attrs):
    op, scope = attrs["_op"], attrs["_scope"]
    queue = scope.find_var(op.input("blocking_queue")[0]).value()
    scope.var(op.output("Out")[0]).set_value(queue)
    return {}


def _pass_reader(ins, attrs):
    op, scope = attrs["_op"], attrs["_scope"]
    src = scope.find_var(op.input("UnderlyingReader")[0]).value()
    scope.var(op.output("Out")[0]).set_value(src)
    return {}


register_op("create_double_buffer_reader", stateful=True, no_grad=True,
            attr_defaults={"place": ""})(_pass_reader)
register_op("create_custom_reader", stateful=True, no_grad=True,
            attr_defaults={})(_pass_reader)


@register_op("read", stateful=True, no_grad=True, needs_device=True,
             attr_defaults={"throw_eof_exp": True})
def _read(ins, attrs):
    from ..fluid.core import LoDTensor
    op, scope = attrs["_op"], attrs["_scope"]
    batch = scope.find_var(op.input("Reader")[0]).value().pop()
    if batch is None:
        raise StopIteration("read op: reader exhausted")
    dev = attrs["_device"]
    for name, arr in zip(op.output("Out"), batch):
        if isinstance(arr, LoDTensor):
            t = LoDTensor(arr.array.to(dev), arr.lod())
        else:
            t = LoDTensor(torch.from_numpy(
                np.ascontiguousarray(np.asarray(arr))).to(dev))
        scope.var(name).set_value(t)
    return {}


# the ``lstm`` op's kernel under the reference's cuDNN name: the same flat
# weight layout and the same dropout draw
register_op("cudnn_lstm", needs_rng=True,
            diff_inputs=["Input", "W", "InitH", "InitC"],
            attr_defaults={"max_len": 0, "hidden_size": 0, "num_layers": 1,
                           "is_bidirec": False, "dropout_prob": 0.0,
                           "input_size": 0, "is_test": False,
                           "seed": 0})(_lstm)


def _engine_stub(name, what):
    @register_op(name, stateful=True, no_grad=True)
    def _stub(ins, attrs):
        raise NotImplementedError(
            f"{name}: {what} The port runs a whole program on the card "
            "itself (a CUDA graph a compiled segment), and offloads no "
            "engine subgraph.")
    return _stub


_engine_stub("tensorrt_engine", "TensorRT subgraph offload op.")
_engine_stub("lite_engine", "Paddle-Lite subgraph offload op.")
