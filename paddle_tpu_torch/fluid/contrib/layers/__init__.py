"""fluid.contrib.layers (counterpart of paddle_tpu/fluid/contrib/layers/):
the op builders of nn.py and metric_op.py's ctr_metric_bundle. The
dygraph cells of rnn_impl.py (BasicGRUUnit, BasicLSTMUnit, basic_gru,
basic_lstm) come with the port's dygraph (ROADMAP A7 (d))."""
from . import nn  # noqa: F401
from . import metric_op  # noqa: F401
from .nn import (fused_elemwise_activation, var_conv_2d,  # noqa: F401
                 match_matrix_tensor, sequence_topk_avg_pooling, tree_conv,
                 fused_embedding_seq_pool, multiclass_nms2, shuffle_batch,
                 partial_concat, partial_sum, rank_attention, batch_fc)
from .metric_op import ctr_metric_bundle  # noqa: F401

__all__ = [
    "fused_elemwise_activation", "var_conv_2d", "match_matrix_tensor",
    "sequence_topk_avg_pooling", "tree_conv", "fused_embedding_seq_pool",
    "multiclass_nms2", "shuffle_batch", "partial_concat", "partial_sum",
    "rank_attention", "batch_fc", "ctr_metric_bundle",
]
