"""The five computing fused ops, ``fluid.contrib.layers``,
``layers/distributions.py`` and phase 24's programs of chip_smoke.py in
paddle_tpu_torch against the TPU package, on the CPU:

- fused_embedding_seq_pool (a ragged LoD with an empty sequence and
  repeated ids), fusion_repeated_fc_relu, fusion_seqpool_cvm_concat
  (negative show and click sums, SUM and AVERAGE, with and without
  ``use_cvm``), fusion_squared_mat_sub and fusion_transpose_flatten_concat
  against the TPU package's kernels with their generic grads, at rtol
  1e-4, atol 1e-5 (products and sums in another order);
- every public name of ``fluid.contrib.layers`` (but the four dygraph
  cells of rnn_impl.py) and of ``layers.distributions``, with the TPU
  package's parameters and defaults; each contrib builder appends the
  TPU package's ops with its attrs;
- the distributions' log_prob, entropy and KL (``distributions_program``)
  within 1e-5 relative of the TPU package's, their draws by their
  moments in each package (neither draws the other's numbers);
- phase 24's (b) and (c) built by chip_smoke.py's functions in both
  packages at a small size: step 1's loss, metrics and every parameter
  grad at rtol 1e-4, atol 1e-5, and the update after it; (b)'s eval
  clone's chunk_eval exactly;
- phase 24's op battery (``_lay_battery``, its three samplers aside)
  against the TPU package's kernels, compiled by XLA as its compiled step
  runs them, the host ops exactly.
"""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu.fluid.contrib.layers as jcontrib
import paddle_tpu.fluid.layers.distributions as jdist
from paddle_tpu import fluid as jfluid
from paddle_tpu_torch import fluid as tfluid
import paddle_tpu_torch.fluid.contrib.layers as tcontrib
import paddle_tpu_torch.fluid.layers.distributions as tdist
from tests.test_torch_rnn_layers import cs
from tests.test_torch_vision_models import _Pair, _both, _grad_names, _types
from tests.test_torch_models_a7 import _persistables
from tests.test_torch_vision_ops import run_both

RTOL, ATOL = 1e-4, 1e-5
RNN_IMPL = {"BasicGRUUnit", "BasicLSTMUnit", "basic_gru", "basic_lstm",
            "rnn_impl"}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _lod(*lens):
    return (tuple(int(v) for v in np.concatenate([[0], np.cumsum(lens)])),)


# ------------------------------------------------------------ fused ops
def test_fused_embedding_seq_pool_over_a_ragged_lod():
    ids = np.array([[3], [3], [7], [1], [3], [0], [7], [7]], np.int64)
    run_both("fused_embedding_seq_pool", {"W": [_x(10, 4)], "Ids": [ids]},
             {"padding_idx": 3}, lod={"Ids": [_lod(3, 0, 1, 4)]},
             diff=["W"], tol=(RTOL, ATOL))


def test_fusion_repeated_fc_relu():
    ins = {"X": [_x(5, 6)], "W": [_x(6, 7, seed=1), _x(7, 3, seed=2)],
           "Bias": [_x(7, seed=3), _x(3, seed=4)]}
    out = run_both("fusion_repeated_fc_relu", ins, tol=(RTOL, ATOL))
    assert len(out["ReluOut"]) == 1


@pytest.mark.parametrize("pooltype,use_cvm", [("SUM", True),
                                              ("AVERAGE", True),
                                              ("SUM", False)])
def test_fusion_seqpool_cvm_concat(pooltype, use_cvm):
    a, b = _x(9, 5), _x(9, 4, seed=1)
    a[:4, 0] = -3.0       # a negative show sum: log(max(s, 0) + 1)
    ins = {"X": [a, b], "CVM": [_x(3, 2, seed=2)]}
    run_both("fusion_seqpool_cvm_concat", ins,
             {"pooltype": pooltype, "use_cvm": use_cvm},
             lod={"X": [_lod(4, 0, 5), _lod(2, 3, 4)]}, diff=["X"],
             tol=(RTOL, ATOL))


def test_fusion_squared_mat_sub():
    run_both("fusion_squared_mat_sub", {"X": [_x(4, 5)],
                                        "Y": [_x(5, 3, seed=1)]},
             {"scalar": 0.5}, tol=(RTOL, ATOL))


def test_fusion_transpose_flatten_concat():
    run_both("fusion_transpose_flatten_concat",
             {"X": [_x(2, 3, 4, 5), _x(2, 3, 2, 5, seed=1)]},
             {"trans_axis": [0, 2, 3, 1], "flatten_axis": 1,
              "concat_axis": 1}, tol=(RTOL, ATOL))


# ---------------------------------------------------------------- names
def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


@pytest.mark.parametrize("jmod,tmod,left", [(jcontrib, tcontrib, RNN_IMPL),
                                            (jdist, tdist, set())],
                         ids=["contrib.layers", "distributions"])
def test_every_name_with_the_tpu_packages_signature(jmod, tmod, left):
    assert _public(jmod) - _public(tmod) == left
    for name in sorted(_public(jmod) - left):
        j, t = getattr(jmod, name), getattr(tmod, name)
        if inspect.ismodule(j) or not callable(j):
            continue
        fn = (lambda c: c.__init__) if inspect.isclass(j) else (lambda c: c)
        assert inspect.signature(fn(t)) == inspect.signature(fn(j)), name
        if inspect.isclass(j):
            assert _public(j) <= _public(t), name
    assert tfluid.layers.distributions is tdist
    assert tfluid.contrib.layers is tcontrib


def _contrib_ops(fluid):
    """Every builder of ``fluid.contrib.layers`` in one program (shapes
    only): its (type, inputs, outputs, attrs) a op."""
    cl, L = fluid.contrib.layers, fluid.layers
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), \
            fluid.unique_name.guard():
        x = fluid.data("x", shape=[6], dtype="float32")
        seq = fluid.data("seq", shape=[4], dtype="float32", lod_level=1)
        ids = fluid.data("ids", shape=[1], dtype="int64", lod_level=1)
        row = fluid.data("row", shape=[1], dtype="float32", lod_level=1)
        col = fluid.data("col", shape=[1], dtype="float32", lod_level=1)
        cl.fused_elemwise_activation(x, x, ["elementwise_add", "relu"])
        cl.var_conv_2d(seq, row, col, 1, 2, 3)
        cl.match_matrix_tensor(seq, seq, 2)
        cl.sequence_topk_avg_pooling(seq, row, col, [1, 3], 1)
        cl.tree_conv(fluid.data("nodes", shape=[5, 4], dtype="float32"),
                     fluid.data("edges", shape=[5, 2], dtype="int32"), 3, 2)
        cl.fused_embedding_seq_pool(ids, [20, 4])
        cl.multiclass_nms2(fluid.data("bb", shape=[8, 4], dtype="float32"),
                           fluid.data("sc", shape=[3, 8], dtype="float32"),
                           0.1, 5, 3)
        cl.shuffle_batch(x, seed=7)
        cl.partial_concat([x, x], 1, 2)
        cl.partial_sum([x, x], 0, 3)
        cl.rank_attention(x, fluid.data("ro", shape=[7], dtype="int32"),
                          [54, 2], fluid.ParamAttr(name="rank_w"))
        cl.batch_fc(fluid.data("bx", shape=[3, 4, 5], dtype="float32",
                               append_batch_size=False), [3, 5, 2],
                    fluid.ParamAttr(name="bfc_w"), [3, 1, 2],
                    fluid.ParamAttr(name="bfc_b"))
        p = L.sigmoid(L.reduce_sum(x, dim=1, keep_dim=True))
        cl.ctr_metric_bundle(p, L.reduce_mean(x, dim=1, keep_dim=True))
    return [(op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: v for k, v in op.attrs.items() if not k.startswith("op_")})
            for op in main.global_block().ops]


def test_contrib_builders_append_the_tpu_packages_ops(monkeypatch):
    # both packages name temporaries from a process-wide counter that
    # ``unique_name.guard`` does not reset: each from zero
    from paddle_tpu.fluid import unique_name as jnames
    from paddle_tpu_torch.fluid import unique_name as tnames
    ops = []
    for fluid, names in ((tfluid, tnames), (jfluid, jnames)):
        monkeypatch.setattr(names, "dygraph_parameter_name_generator",
                            names.UniqueNameGenerator())
        ops.append(_contrib_ops(fluid))
    assert ops[0] == ops[1]


# -------------------------------------------------------- distributions
def test_distributions_against_the_tpu_package():
    j, t = _both(cs.distributions_program, draws=2 ** 14)
    feed = cs.distributions_feed(np.random.RandomState(0))
    got = {}
    for pkg, (fluid, (main, startup, outs)) in (("jax", (jfluid, j)),
                                                ("torch", (tfluid, t))):
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            got[pkg] = dict(zip(outs, exe.run(main, feed=feed,
                                              fetch_list=list(outs.values()))))
    for name in got["jax"]:
        a, b = (np.asarray(got[p][name], np.float64) for p in ("torch",
                                                               "jax"))
        if name.endswith("_sample"):   # each package's draws by moments
            mean, var = ((1.5, 4.0) if name.startswith("normal")
                         else (1.0, 16 / 12))
            for s in (a, b):
                assert abs(s.mean() - mean) < 5 * np.sqrt(var / s.size)
            continue
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)


# ----------------------------------------------------- phase 24's (b), (c)
SRL = dict(word_dict_len=300, label_dict_len=9, emb=8, hidden=16)
CTR = dict(dense=13, slots=4, sparse_dim=50, emb=4, hidden=(16, 16, 8),
           bfc=4)


def _srl_feed(rng):
    lens = [5, 1, 7, 3]
    offs = [int(v) for v in np.concatenate([[0], np.cumsum(lens)])]
    n = offs[-1]
    word = rng.randint(0, SRL["word_dict_len"], (n, 1)).astype(np.int64)
    target = rng.randint(0, SRL["label_dict_len"], (n, 1)).astype(np.int64)
    return {"word": (word, offs), "target": (target, offs)}


def test_srl_with_chunk_eval_against_the_tpu_package():
    """Phase 24 (b) at a small size: step 1's loss and grads, the update,
    then the eval clone: decoded tags and chunk_eval's six outputs
    exactly."""
    j, t = _both(cs.srl_chunk_program, **SRL)
    assert _types(t[2]) == _types(j[2]) and _types(t[2])[-1] == "chunk_eval"
    pair = _Pair([t[1]], _persistables(j[0]))
    feed = _srl_feed(np.random.RandomState(3))
    g = _grad_names(t[0])
    jo, to = pair.run(j[0], t[0], feed, [j[3]] + g, [t[3]] + g)
    for k, (a, b) in enumerate(zip(to, jo)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"fetch {k}")
    pair.same_state(t[0])
    jo, to = pair.run(j[2], t[2], feed, [j[4]] + list(j[5]),
                      [t[4]] + list(t[5]), mode="segmented")
    for k, (a, b) in enumerate(zip(to, jo)):
        np.testing.assert_array_equal(a, b, err_msg=f"eval fetch {k}")


def _ctr_feed(fluid):
    feed = cs.ctr_feed(fluid, 32, CTR["dense"], CTR["slots"],
                       CTR["sparse_dim"])
    return {k: ((np.asarray(v.numpy() if hasattr(v, "numpy") else v.array),
                 v.lod()[0]) if k.startswith("slot_") else v)
            for k, v in feed.items()}


def test_ctr_over_contrib_layers_against_the_tpu_package():
    """Phase 24 (c) at a small size: step 1's loss, auc, the bundle's
    sums and every parameter grad, then the update and the metrics'
    state; the port segmented around auc, bitwise its interpreter."""
    j, t = _both(cs.ctr_contrib_program, **CTR)
    assert _types(t[0]) == _types(j[0])
    pair = _Pair([t[1]], _persistables(j[0]))
    feed = _ctr_feed(tfluid)
    g = _grad_names(t[0])
    jo, to = pair.run(j[0], t[0], feed, [j[3], j[4]] + j[5] + g,
                      [t[3], t[4]] + t[5] + g, mode="segmented")
    for k, (a, b) in enumerate(zip(to, jo)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"fetch {k}")
    pair.same_state(t[0])


# --------------------------------------------------------- the battery
_RANDOM = ("shuffle_batch", "sample_logits", "tdm_sampler")
BATTERY = [c for c in cs._lay_battery() if c[0] not in _RANDOM]


@pytest.mark.parametrize("case", BATTERY, ids=[c[0] for c in BATTERY])
def test_chip_smoke_battery_against_the_tpu_package(case):
    """Each case of phase 24's battery (d) against the TPU package's
    kernel: outputs and generic grads at rtol 1e-4, atol 1e-5 (the card
    holds the same cases against the CPU port), integers exactly."""
    from paddle_tpu_torch.ops.registry import OPS
    op_type, ins, attrs, lod, diff = case
    if OPS.get(op_type).needs_device:   # the executor's, for the port
        attrs = dict(attrs, _device=torch.device("cpu"))
    run_both(op_type, ins, attrs, lod=lod, grad=bool(diff), diff=diff,
             tol=(RTOL, ATOL), jit=True)


# ------------------------------------------------------------ phase 24
def test_chip_smoke_phase_24_rehearsed(monkeypatch):
    """phase_layers_rest on the CPU at small sizes (BERT of 2 layers of
    hidden 64 at batch 4, the SRL tagger at 300 words, the CTR net at 26
    slots of 100 ids and batch 32, 2^14 draws): every comparison it makes
    on the card, each run's kind as a card run's, no kernel to count."""
    import paddle_tpu_torch.models.bert as tbert
    zeros = cs.NO_KERNELS
    monkeypatch.setattr(tfluid, "CUDAPlace", lambda i=0: tfluid.CPUPlace())
    base = tbert.bert_base_config
    monkeypatch.setattr(tbert, "bert_base_config", lambda: dict(
        base(), layers=2, hidden=64, heads=4, ffn=128, vocab_size=512))
    for name, value in (
            ("LANE_STEP_WANT", (0, 0, 0, 2, 0, 4) + (0,) * 6),
            ("LAY_BERT_BATCH", 4), ("MD_SRL_BATCH", 4), ("WD_BATCH", 32),
            ("MD_SRL", dict(SRL, label_dict_len=59)), ("VS_CARD", "cpu"),
            ("LAY_EVAL_RUNS", 1), ("LAY_DRAWS", 2 ** 14)):
        monkeypatch.setattr(cs, name, value)
    for fn, defaults in (
            (cs.ctr_contrib_program, (13, 26, 100, 16, (8, 8, 8), 4, 1e-3)),
            (cs.ctr_feed, (13, 26, 100, cs.SEED)),
            (cs.distributions_program, (2 ** 14, cs.SEED)),
            (cs._lay_bert_batches, (4, cs.SEED + 24))):
        monkeypatch.setattr(fn, "__defaults__", defaults)
    monkeypatch.setattr(cs, "_launch_counts", lambda: zeros)
    monkeypatch.setattr(cs, "_device_kernel_counts",
                        lambda fn, **k: (fn(), zeros)[1])
    monkeypatch.setattr(cs, "_check_trace", lambda *a: None)
    monkeypatch.setattr(cs, "_card_line", lambda: "CPU")
    clone = cs._clone_scope
    monkeypatch.setattr(cs, "_clone_scope",
                        lambda scope, names, dev: clone(scope, names, "cpu"))
    runs = {}

    def kind(exe, mode, what):
        assert exe._last_run_mode == mode, (what, exe._last_run_mode)
        if mode == "interpreted":
            return mode
        # the block is held, so that a later block cannot take its id
        seen = runs.setdefault(id(exe._last_block), [exe._last_block, 0])
        seen[1] += 1
        return ("eager", "capture", "replay")[min(seen[1], 3) - 1]
    monkeypatch.setattr(cs, "_gate_run", lambda exe, delta, want, what:
                        kind(exe, "compiled", what))
    monkeypatch.setattr(cs, "_rnn_gate", lambda exe, before, mode, what,
                        book: kind(exe, mode, what))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    lines = []
    monkeypatch.setattr(cs, "_log", lambda *a: lines.append(" ".join(
        str(x) for x in a)))
    out = cs.phase_layers_rest()
    text = "\n".join(lines)
    assert "FAIL" not in text
    for want in ("through py_reader / double_buffer / read_file: 10 steps",
                 "bitwise the feed= run's", "persistables bitwise equal",
                 "through save, load, layers.load, delete_var and fake_init",
                 "(b) SRL tagger batch 4 sentences", "chunk_eval (IOB, 29",
                 "(c) CTR over fluid.contrib.layers batch 32",
                 "islands [('bilinear_interp', 'host_inputs'), ('crop', "
                 "'host_inputs')]", "(d) 29 op types",
                 "(f) distributions", "phase 24 in"):
        assert want in text, want
    assert out["battery"] == 47 and out["wrapper"] == zeros
