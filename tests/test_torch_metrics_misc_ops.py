"""metrics_misc_ops' 22 op types in paddle_tpu_torch against the TPU
package's kernels, on the CPU (ops/metrics_misc_ops.py; detection_map is
in tests/test_torch_detection_ops.py):

- the host ops exactly: chunk_eval over the four schemes, excluded types,
  the LoD and SeqLength layouts; precision_recall and
  positive_negative_pair with their state; filter_by_instag (and its
  no-match rows); tree_conv's edge walk; pyramid_hash's n-grams with its
  white and black lists connected (neither kernel reads them);
  tdm_child, get_places and coalesce_tensor;
- the compute ops at rtol 1e-5, atol 1e-6, the products at rtol 1e-4,
  atol 1e-5, with the generic grads of their differentiable inputs under
  a seeded output grad (tests/test_torch_vision_ops.py's ``run_both``);
- match_matrix_tensor, var_conv_2d and sequence_topk_avg_pooling over
  ragged LoDs holding a length-0 and a length-1 sequence (a pair without
  rows, where the TPU kernel of sequence_topk_avg_pooling raises, gives
  the port's no rows);
- the samplers by property, as neither package can draw the other's
  numbers: shuffle_batch's Out is a permutation of X's rows that
  ShuffleIdx gives back; sample_logits' samples lie in [0, K), the true
  labels first, and its ``use_customized_samples`` path, fed the same
  samples, matches within tolerance with its grads; tdm_sampler's
  negatives lie in their layer's span (as the TPU kernel's, they may hit
  the path node);
- every registration with the TPU package's flags, slots and defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops.registry import OPS as JOPS
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad
from tests.test_torch_vision_ops import _attrs, run_both

TOL = (1e-5, 1e-6)
MM_TOL = (1e-4, 1e-5)

NEW_OPS = (
    "chunk_eval", "precision_recall", "positive_negative_pair",
    "modified_huber_loss", "partial_concat", "partial_sum", "batch_fc",
    "shuffle_batch", "fill", "fill_zeros_like2", "get_places",
    "coalesce_tensor", "sample_logits", "filter_by_instag", "tdm_child",
    "tdm_sampler", "rank_attention", "tree_conv", "match_matrix_tensor",
    "var_conv_2d", "pyramid_hash", "sequence_topk_avg_pooling")


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


def _kernels(op_type, ins, attrs=None, lod=None, key=0):
    """Both kernels' outputs (numpy), the port's on the CPU with the
    executor's ``_device`` and a fixed ``_rng``."""
    attrs = dict(attrs or {})
    if lod is not None:
        attrs["_lod"] = lod
    ta = dict(_attrs(TOPS, op_type, attrs), _device=torch.device("cpu"),
              _rng=lambda: torch.tensor([key], dtype=torch.int64))
    ja = dict(_attrs(JOPS, op_type, attrs), _rng=jax.random.key(key))
    t = TOPS.get(op_type).kernel(
        {s: [torch.from_numpy(np.asarray(a)) for a in v]
         for s, v in ins.items()}, ta)
    j = JOPS.get(op_type).kernel(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}, ja)
    as_np = lambda d: {k: [np.asarray(v.detach() if isinstance(
        v, torch.Tensor) else v) for v in vs]
        for k, vs in d.items() if not k.startswith("_")}
    return as_np(t), as_np(j), t, j


def _same(t, j, slots=None):
    for slot in slots or j:
        for a, b in zip(t[slot], j[slot]):
            assert a.shape == b.shape, slot
            assert a.dtype == b.dtype, (slot, a.dtype, b.dtype)
            assert np.array_equal(a, b), slot


@pytest.mark.parametrize("op_type", NEW_OPS)
def test_registered_with_the_reference_flags(op_type):
    ti, ji = TOPS.get(op_type), JOPS.get(op_type)
    for flag in ("no_grad", "stateful", "needs_rng", "needs_lod"):
        assert getattr(ti, flag) == getattr(ji, flag), flag
    assert list(ti.diff_input_slots or []) == list(ji.diff_input_slots or [])
    assert tuple(ti.input_slots or ()) == tuple(ji.input_slots or ())
    assert tuple(ti.host_inputs) == tuple(ji.host_inputs)
    assert ti.attr_defaults == ji.attr_defaults


# ------------------------------------------------------------ host ops
CHUNK_CASES = [("IOB", 3, []), ("IOE", 3, []), ("IOBES", 2, []),
               ("plain", 4, []), ("IOB", 3, [1]), ("IOBES", 2, [0])]


@pytest.mark.parametrize("scheme,types,excluded", CHUNK_CASES)
def test_chunk_eval_by_lod_and_by_seq_length(scheme, types, excluded):
    from paddle_tpu_torch.ops.metrics_misc_ops import _TAG_NUM
    r = np.random.RandomState(len(scheme) + types)
    n_tags = types * _TAG_NUM[scheme] + 1     # the last one is O
    lens = [7, 0, 1, 12, 5]
    label = r.randint(0, n_tags, (sum(lens), 1)).astype(np.int64)
    infer = np.where(r.rand(sum(lens), 1) < 0.7, label,
                     r.randint(0, n_tags, (sum(lens), 1))).astype(np.int64)
    attrs = {"chunk_scheme": scheme, "num_chunk_types": types,
             "excluded_chunk_types": excluded}
    lod = {"Inference": [_lod(*lens)], "Label": [_lod(*lens)]}
    t, j, _, _ = _kernels("chunk_eval", {"Inference": [infer],
                                         "Label": [label]}, attrs, lod)
    _same(t, j)
    assert j["NumLabelChunks"][0][0] > 0
    # the padded [N, T] layout delimited by SeqLength
    T = max(lens)
    pad = lambda a: np.stack([np.pad(s[:, 0], (0, T - len(s)),
                                     constant_values=n_tags - 1)
                              for s in np.split(a, np.cumsum(lens)[:-1])])
    ins = {"Inference": [pad(infer)], "Label": [pad(label)],
           "SeqLength": [np.array(lens, np.int64)]}
    t2, j2, _, _ = _kernels("chunk_eval", ins, attrs, {})
    _same(t2, j2)
    for slot in t:
        assert np.array_equal(t[slot][0], t2[slot][0]), slot
    t3, j3, _, _ = _kernels("chunk_eval", {"Inference": [infer],
                                           "Label": [label]}, attrs, {})
    _same(t3, j3)


@pytest.mark.parametrize("weights,states", [(False, False), (True, True)])
def test_precision_recall_with_its_state(weights, states):
    r = np.random.RandomState(7)
    C, n = 4, 40
    ins = {"MaxProbs": [r.rand(n, 1).astype(np.float32)],
           "Indices": [r.randint(0, C, (n, 1)).astype(np.int32)],
           "Labels": [r.randint(0, C, (n, 1)).astype(np.int32)]}
    if weights:
        ins["Weights"] = [r.rand(n, 1).astype(np.float32)]
    if states:
        ins["StatesInfo"] = [r.randint(0, 9, (C, 4)).astype(np.float32)]
    t, j, _, _ = _kernels("precision_recall", ins, {"class_number": C})
    _same(t, j)


def test_positive_negative_pair_with_ties_and_accumulators():
    r = np.random.RandomState(8)
    n = 30
    score = np.round(r.rand(n, 2), 1).astype(np.float32)   # ties
    ins = {"Score": [score], "Label": [r.randint(0, 3, (n, 1))
                                      .astype(np.float32)],
           "QueryID": [r.randint(0, 4, (n, 1)).astype(np.int64)]}
    t, j, _, _ = _kernels("positive_negative_pair", ins, {"column": 0})
    _same(t, j)
    assert j["NeutralPair"][0][0] > 0
    for slot, v in (("AccumulatePositivePair", 3.0),
                    ("AccumulateNegativePair", 1.0),
                    ("AccumulateNeutralPair", 2.0)):
        ins[slot] = [np.array([v], np.float32)]
    t, j, _, _ = _kernels("positive_negative_pair", ins, {"column": -1})
    _same(t, j)


@pytest.mark.parametrize("keep", [True, False])
def test_filter_by_instag_keeps_the_tagged_rows(keep):
    x = _x(6, 3)
    tags = np.array([[1], [4], [2], [9], [4], [7]], np.int64)
    filt = np.array([4, 7] if keep else [5], np.int64)
    ins = {"Ins": [x], "Ins_tag": [tags], "Filter_tag": [filt]}
    attrs = {"out_val_if_empty": 3}
    t, j, traw, _ = _kernels("filter_by_instag", ins, attrs,
                             {"Ins": [_lod(6)]})
    _same(t, j)
    if keep:
        g = {"Ins": [torch.from_numpy(x)], "Ins_tag": [torch.from_numpy(tags)],
             "Filter_tag": [torch.from_numpy(filt)],
             "Out@GRAD": [torch.ones(6, 3)]}
        gx = t_generic_grad("filter_by_instag", g,
                            _attrs(TOPS, "filter_by_instag", attrs),
                            ["Ins@GRAD"], ["Ins", "Ins_tag", "Filter_tag"])
        assert np.array_equal(gx["Ins@GRAD"][0].numpy(),
                              np.repeat(t["LossWeight"][0], 3, 1))


def test_tree_conv_walks_the_edges_as_the_tpu_kernel():
    r = np.random.RandomState(9)
    edges = np.array([[[0, 1], [0, 2], [1, 3], [1, 4], [0, 0]],
                      [[0, 1], [1, 2], [2, 3], [0, 0], [0, 0]]], np.int32)
    ins = {"NodesVector": [_x(2, 5, 4, seed=1)], "EdgeSet": [edges],
           "Filter": [r.normal(size=(4, 3, 2, 3)).astype(np.float32)]}
    run_both("tree_conv", ins, {"max_depth": 2}, tol=MM_TOL,
             diff=["NodesVector", "Filter"])


def test_tdm_child_and_get_places_and_fill_exactly():
    info = np.array([[0, 0, 0, 0, 0], [1, 0, 0, 2, 3], [2, 1, 1, 0, 0],
                     [0, 1, 1, 4, 0], [4, 2, 3, 0, 0]], np.int32)
    for x in (np.array([[1], [2], [3], [0]], np.int64),
              np.array([[1, 3], [2, 0]], np.int64)):
        t, j, _, _ = _kernels("tdm_child", {"X": [x], "TreeInfo": [info]},
                              {"child_nums": 2})
        _same(t, j)
    t, j, _, _ = _kernels("get_places", {}, {"device_count": 3})
    _same(t, j)
    t, _, _, _ = _kernels("get_places", {}, {})
    assert t["Out"][0].tolist() == [0]   # the port's CPU: one place
    for dtype, np_dtype in ((5, np.float32), (3, np.int64), (2, np.int32)):
        t, j, _, _ = _kernels("fill", {}, {"value": [1.5, -2.0, 3.25, 4.0],
                                           "shape": [2, 2], "dtype": dtype})
        # the TPU package's int64 is int32 (x64 off); the port's is int64
        assert t["Out"][0].dtype == np_dtype
        assert np.array_equal(t["Out"][0], j["Out"][0])
    t, j, _, _ = _kernels("fill_zeros_like2", {"X": [_x(3, 2)]})
    _same(t, j)


@pytest.mark.parametrize("set_constant", [False, True])
def test_coalesce_tensor(set_constant):
    ins = {"Input": [_x(2, 3), _x(4, seed=1), _x(1, 2, 2, seed=2)]}
    run_both("coalesce_tensor", ins, {"set_constant": set_constant,
                                      "constant": 0.5},
             grad=not set_constant)


# --------------------------------------------------------- compute ops
def test_modified_huber_loss():
    x = np.linspace(-3, 3, 24, dtype=np.float32).reshape(24, 1)
    y = (np.arange(24) % 2).reshape(24, 1).astype(np.float32)
    run_both("modified_huber_loss", {"X": [x], "Y": [y]}, diff=["X"])


@pytest.mark.parametrize("op_type", ["partial_concat", "partial_sum"])
@pytest.mark.parametrize("start,length", [(0, -1), (1, 2), (-3, 2)])
def test_partial_ops(op_type, start, length):
    ins = {"X": [_x(3, 5), _x(3, 5, seed=1), _x(3, 5, seed=2)]}
    run_both(op_type, ins, {"start_index": start, "length": length})


def test_batch_fc():
    ins = {"Input": [_x(3, 4, 5)], "W": [_x(3, 5, 6, seed=1)],
           "Bias": [_x(3, 1, 6, seed=2)]}
    run_both("batch_fc", ins, tol=MM_TOL)


def test_rank_attention():
    mr, d, ocol = 3, 4, 2
    ro = np.array([[1, 2, 0, 3, 1, 0, 0], [2, 1, 0, 2, 0, 3, 0],
                   [0, 0, 0, 0, 0, 0, 0], [3, 3, 1, 3, 2, 1, 1]], np.int32)
    ins = {"X": [_x(4, d)], "RankOffset": [ro],
           "RankParam": [_x(mr * mr * d, ocol, seed=1)]}
    run_both("rank_attention", ins, {"MaxRank": mr}, tol=MM_TOL,
             diff=["X", "RankParam"])


def test_match_matrix_tensor_over_ragged_pairs():
    xl, yl = [3, 0, 1, 4], [2, 3, 1, 0]
    ins = {"X": [_x(sum(xl), 4)], "Y": [_x(sum(yl), 5, seed=1)],
           "W": [_x(4, 2, 5, seed=2)]}
    out = run_both("match_matrix_tensor", ins, {"dim_t": 2}, tol=MM_TOL,
                   lod={"X": [_lod(*xl)], "Y": [_lod(*yl)]})
    assert out["_lod"]["Out"] == [_lod(*[2 * a * b
                                         for a, b in zip(xl, yl)])]


def test_var_conv_2d_over_ragged_images():
    rows, cols, ic = [3, 0, 1, 4, 2], [4, 2, 1, 3, 0], 2
    n = sum(ic * r * c for r, c in zip(rows, cols))
    ins = {"X": [_x(n, 1)], "ROW": [np.zeros((sum(rows), 1), np.float32)],
           "COLUMN": [np.zeros((sum(cols), 1), np.float32)],
           "W": [_x(3, ic * 9, seed=1)]}
    attrs = {"InputChannel": ic, "OutputChannel": 3, "KernelH": 3,
             "KernelW": 3, "StrideH": 1, "StrideW": 2}
    run_both("var_conv_2d", ins, attrs, tol=MM_TOL, diff=["X", "W"],
             lod={"X": [_lod(n)], "ROW": [_lod(*rows)],
                  "COLUMN": [_lod(*cols)]})


def _topk_ins(rows, cols, ch):
    n = sum(ch * r * c for r, c in zip(rows, cols))
    ins = {"X": [_x(n, 1)], "ROW": [np.zeros((sum(rows), 1), np.float32)],
           "COLUMN": [np.zeros((sum(cols), 1), np.float32)]}
    lod = {"X": [_lod(n)], "ROW": [_lod(*rows)], "COLUMN": [_lod(*cols)]}
    return ins, lod


def test_sequence_topk_avg_pooling_over_ragged_pairs():
    ins, lod = _topk_ins([2, 1, 1, 3], [3, 0, 1, 4], 2)
    run_both("sequence_topk_avg_pooling", ins,
             {"topks": [1, 2, 5], "channel_num": 2}, diff=["X"], lod=lod)


def test_sequence_topk_avg_pooling_of_a_pair_without_rows():
    """A length-0 ROW sequence: the TPU kernel's reshape(0, -1) raises;
    the port's gives that pair no rows, the others as with it left out."""
    attrs = {"topks": [1, 2], "channel_num": 2}
    ins, lod = _topk_ins([2, 0, 3], [3, 2, 4], 2)
    with pytest.raises((ZeroDivisionError, TypeError, ValueError)):
        _kernels("sequence_topk_avg_pooling", ins, attrs, lod)
    t = TOPS.get("sequence_topk_avg_pooling").kernel(
        {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()},
        dict(_attrs(TOPS, "sequence_topk_avg_pooling", attrs), _lod=lod))
    assert t["_lod"]["Out"] == [_lod(2, 0, 3)]
    x = ins["X"][0]
    a, b, _ = _kernels("sequence_topk_avg_pooling", {
        "X": [x[:12]], "ROW": [ins["ROW"][0][:2]],
        "COLUMN": [ins["COLUMN"][0][:3]]}, attrs,
        {"X": [_lod(12)], "ROW": [_lod(2)], "COLUMN": [_lod(3)]})[:3]
    assert np.array_equal(t["Out"][0][:2].numpy(), b["Out"][0])


def test_pyramid_hash_with_its_lists_connected():
    ids = np.random.RandomState(10).randint(0, 5000, (9, 1)).astype(np.int64)
    ins = {"X": [ids], "W": [_x(100, 1)],
           "WhiteList": [np.array([[1], [2]], np.int64)],
           "BlackList": [np.array([[3]], np.int64)]}
    out = run_both("pyramid_hash", ins,
                   {"num_emb": 8, "rand_len": 4, "space_len": 100,
                    "pyramid_layer": 3, "use_filter": True,
                    "white_list_len": 2, "black_list_len": 1},
                   diff=["W"], lod={"X": [_lod(4, 1, 0, 4)]})
    assert out["_lod"]["Out"] == [_lod(4, 1, 0, 4)]


# ------------------------------------------------------------ samplers
def test_shuffle_batch_is_a_permutation_its_index_gives_back():
    x = _x(16, 3)
    for seed in (0, 7):
        ins = {"X": [x], "Seed": [np.array([seed], np.int64)]}
        t, j, traw, _ = _kernels("shuffle_batch", ins, key=3)
        for o in (t, j):
            idx = o["ShuffleIdx"][0]
            assert sorted(idx.tolist()) == list(range(16))
            assert np.array_equal(o["Out"][0], x[idx])
            assert o["SeedOut"][0].tolist() == [0]
        assert not np.array_equal(t["ShuffleIdx"][0], np.arange(16))
    again, _, _, _ = _kernels("shuffle_batch", ins, key=4)
    assert np.array_equal(again["ShuffleIdx"][0], t["ShuffleIdx"][0])
    g = {"X": [torch.from_numpy(x)], "Seed": [torch.tensor([seed])],
         "Out@GRAD": [torch.arange(48.0).reshape(16, 3)]}
    attrs = dict(_attrs(TOPS, "shuffle_batch", {}),
                 _device=torch.device("cpu"),
                 _rng=lambda: torch.tensor([3], dtype=torch.int64))
    gx = t_generic_grad("shuffle_batch", g, attrs, ["X@GRAD"], ["X", "Seed"])
    back = np.empty((16, 3), np.float32)
    back[t["ShuffleIdx"][0]] = np.arange(48.0).reshape(16, 3)
    assert np.array_equal(gx["X@GRAD"][0].numpy(), back)


def test_sample_logits_draws_in_range_and_matches_on_given_samples():
    r = np.random.RandomState(11)
    n, K, nt, S = 6, 50, 2, 8
    logits = _x(n, K)
    labels = r.randint(0, K, (n, nt)).astype(np.int64)
    attrs = {"num_samples": S, "seed": 5}
    t, j, _, _ = _kernels("sample_logits", {"Logits": [logits],
                                            "Labels": [labels]}, attrs)
    for o in (t, j):
        smp = o["Samples"][0]
        assert smp.shape == (n, nt + S) and smp.dtype == np.int32
        assert np.array_equal(smp[:, :nt], labels)
        assert smp.min() >= 0 and smp.max() < K
        q = np.log((smp + 2.0) / (smp + 1.0)) / np.log(K + 1.0)
        np.testing.assert_allclose(o["Probabilities"][0], q, rtol=1e-5)
        assert o["SampledLabels"][0].tolist() == [[0, 1]] * n
    # the TPU kernel's draws fed back as customized samples
    samples = j["Samples"][0].copy()
    samples[0, nt] = labels[0, 0]          # an accidental hit
    ins = {"Logits": [logits], "Labels": [labels],
           "CustomizedSamples": [samples],
           "CustomizedProbabilities": [j["Probabilities"][0]]}
    out = run_both("sample_logits", ins,
                   {"num_samples": S, "use_customized_samples": True},
                   diff=["Logits"])
    assert out["SampledLogits"][0][0, nt].item() == np.float32(-1e20)


def test_tdm_sampler_draws_negatives_from_their_layer():
    travel = np.array([[1, 3, 9], [2, 6, 12], [0, 5, 10]], np.int32)
    layer = np.arange(1, 15, dtype=np.int32)
    offs = [0, 2, 7, 14]
    negs = [1, 3, 4]
    x = np.array([[0], [1], [2]], np.int64)
    t, j, _, _ = _kernels("tdm_sampler", {"X": [x], "Travel": [travel],
                                          "Layer": [layer]},
                          {"neg_samples_num_list": negs,
                           "layer_offset_lod": offs}, key=2)
    for o in (t, j):
        out, lab, mask = (o[s][0][..., 0] for s in ("Out", "Labels", "Mask"))
        assert out.shape == lab.shape == mask.shape == (3, 3 + sum(negs))
        col = 0
        for li, k in enumerate(negs):
            assert np.array_equal(out[:, col], travel[:, li])
            assert lab[:, col].tolist() == [1, 1, 1]
            span = set(layer[offs[li]:offs[li + 1]].tolist())
            assert set(out[:, col + 1:col + 1 + k].ravel()) <= span
            assert not lab[:, col + 1:col + 1 + k].any()
            assert np.array_equal(mask[:, col:col + 1 + k],
                                  np.repeat((travel[:, li:li + 1] != 0)
                                            .astype(np.int32), k + 1, 1))
            col += 1 + k
