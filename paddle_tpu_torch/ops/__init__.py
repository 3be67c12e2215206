"""Operator kernel library — importing this package registers the ops.

Counterpart of paddle_tpu/ops; this slice holds the ops of the BERT
encoder forward and its startup program."""
from .registry import OPS, register_op  # noqa: F401

from . import math_ops       # noqa: F401
from . import tensor_ops     # noqa: F401
from . import nn_ops         # noqa: F401
from . import attention_ops  # noqa: F401
