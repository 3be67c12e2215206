"""Operator kernel library — importing this package registers the ops.

Counterpart of paddle_tpu/ops; so far the ops of the BERT-base
pretraining step (the encoder forward, the masked-LM loss, dropout, the
optimizer updates and the startup program), the conv nets' ops and the
Transformer's (position encoding, one-hot, label smoothing, reductions,
the LR schedule's step counter) and Wide&Deep's (lookup_table, concat,
sigmoid, log_loss, and the stateful auc and print), and the ops that
saved and rewritten inference programs carry (feed, fetch, assign,
transpose2, matmul, and the fused fc, fused_embedding_eltwise_layernorm,
fused_fc_elementwise_layernorm and conv2d_fusion), the LoD sequence ops,
sequence_mask, cos_sim and the activations of the book's models, the
rest of tensor_ops' shape, gather/scatter, sorting and random ops, the
fused lstm and lstm_unit, nce, hierarchical_sigmoid and the linear-chain
CRF with its Viterbi decode, the LoD recurrences (dynamic_lstm,
dynamic_lstmp, dynamic_gru, gru_unit and the fused fusion_gru and
fusion_lstm), the beam searches' ops and the DynamicRNN-era LoD control
ops, and the detection batch: the detection and detection-training ops,
detection_map and the second vision batch (RoI pooling, deformable and
transposed 3d convolutions, the bicubic and trilinear resizes, ...),
and the rest of the one-card op library: the save and load ops, hash,
the legacy reader ops, the metric and misc batch and the CTR fusions."""
from .registry import OPS, register_op  # noqa: F401

from . import math_ops       # noqa: F401
from . import tensor_ops     # noqa: F401
from . import nn_ops         # noqa: F401
from . import nn_extra_ops   # noqa: F401
from . import attention_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import framework_ops  # noqa: F401
from . import fused_ops      # noqa: F401
from . import sequence_ops   # noqa: F401
from . import rnn_ops         # noqa: F401
from . import loss_extra_ops  # noqa: F401
from . import lod_control_ops  # noqa: F401
from . import detection_ops   # noqa: F401
from . import detection_train_ops  # noqa: F401
from . import metrics_misc_ops  # noqa: F401
from . import vision_ops      # noqa: F401
from . import misc_ops        # noqa: F401
from . import ps_quant_misc_ops  # noqa: F401
