"""The port's op registry against the TPU package's (ROADMAP A7's aim:
tests/test_registry_coverage.py's contract held by the port's registry).

The port registers every op type of ``paddle_tpu.ops`` except those in
``REMAINDER``, the ops ROADMAP A still lists as unported, grouped by the
TPU package's module. The set may only shrink: an op type the port
registers must leave it, and an op the port drops is caught.
"""
import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops.registry import OPS as JOPS
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch.ops.registry import OPS as TOPS

REMAINDER = frozenset({
    # paddle_tpu/fluid/dygraph/dygraph_to_static/program_translator.py
    "run_program_dy",
    # paddle_tpu/ops/collective_ops.py
    "allreduce", "broadcast", "c_allgather", "c_allreduce_max",
    "c_allreduce_min", "c_allreduce_prod", "c_allreduce_sum", "c_broadcast",
    "c_comm_init", "c_comm_init_all", "c_gen_nccl_id", "c_reducescatter",
    "c_sync_calc_stream", "c_sync_comm_stream", "gen_nccl_id", "nccl",
    # paddle_tpu/ops/distributed_ops.py
    "checkpoint_notify", "distributed_lookup_table",
    "distributed_lookup_table_grad", "fetch_barrier", "geo_sgd_send",
    "lazy_table_init", "listen_and_serv", "merge_ids", "ps_round",
    "pslib_pull_sparse", "pslib_push_sparse", "recv", "send", "send_barrier",
    "split_ids",
    # paddle_tpu/ops/framework_ops.py
    "delete_var", "fake_init", "get_tensor_from_selected_rows", "load",
    "load_combine", "merge_selected_rows", "save", "save_combine",
    # paddle_tpu/ops/fused_ops.py
    "attention_lstm", "conv2d_inception_fusion", "fused_embedding_fc_lstm",
    "fused_embedding_seq_pool", "fusion_group", "fusion_repeated_fc_relu",
    "fusion_seqpool_cvm_concat", "fusion_squared_mat_sub",
    "fusion_transpose_flatten_concat",
    # paddle_tpu/ops/metrics_misc_ops.py
    "batch_fc", "chunk_eval", "coalesce_tensor", "fill",
    "fill_zeros_like2", "filter_by_instag", "get_places",
    "match_matrix_tensor", "modified_huber_loss", "partial_concat",
    "partial_sum", "positive_negative_pair", "precision_recall",
    "pyramid_hash", "rank_attention", "sample_logits",
    "sequence_topk_avg_pooling", "shuffle_batch", "tdm_child", "tdm_sampler",
    "tree_conv", "var_conv_2d",
    # paddle_tpu/ops/misc_ops.py
    "hash",
    # paddle_tpu/ops/ps_quant_misc_ops.py
    "create_custom_reader", "create_double_buffer_reader", "create_py_reader",
    "cudnn_lstm", "dequantize", "dequantize_abs_max", "dequantize_log", "dgc",
    "dgc_clip_by_norm", "dgc_momentum", "fake_channel_wise_dequantize_max_abs",
    "fl_listen_and_serv", "lite_engine", "lookup_sparse_table",
    "lookup_table_dequant", "moving_average_abs_max_scale", "prefetch",
    "pull_box_sparse", "pull_sparse", "pull_sparse_v2", "push_box_sparse",
    "push_dense", "push_sparse", "push_sparse_v2", "quantize", "read",
    "recv_save", "ref_by_trainer_id", "requantize", "run_program",
    "split_byref", "split_selected_rows", "tensorrt_engine",
    # paddle_tpu/ops/quant_ops.py
    "fake_channel_wise_quantize_abs_max", "fake_dequantize_max_abs",
    "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_quantize_moving_average_abs_max", "fake_quantize_range_abs_max",
})

# grad op types the port registers under their own name where the TPU
# package runs the generic grad
PORT_ONLY = frozenset({"gather_grad"})


def test_port_registers_every_op_but_the_remainder():
    missing = set(JOPS.all_op_types()) - set(TOPS.all_op_types())
    assert missing <= REMAINDER, sorted(missing - REMAINDER)


def test_remainder_only_shrinks():
    ported = REMAINDER & set(TOPS.all_op_types())
    assert not ported, \
        f"registered now, take out of REMAINDER: {sorted(ported)}"
    assert REMAINDER <= set(JOPS.all_op_types()), \
        sorted(REMAINDER - set(JOPS.all_op_types()))


def test_port_registers_nothing_the_tpu_package_lacks():
    extra = set(TOPS.all_op_types()) - set(JOPS.all_op_types())
    assert extra == PORT_ONLY, sorted(extra)
