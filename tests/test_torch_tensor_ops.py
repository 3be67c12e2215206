"""The rest of tensor_ops (paddle_tpu/ops/tensor_ops.py's 53 op types the
port lacked) and isinf / isnan (math_ops.py) in paddle_tpu_torch against
the TPU package's kernels, on the CPU:

- each op's outputs on numpy inputs made from a seed: integer and index
  outputs (arg_max, arg_min, argsort, top_k_v2's indices, unique*,
  where_index, shard_index, shape, size) exactly, float outputs at rtol
  1e-5, atol 1e-6 (the port's op tests' tolerance,
  tests/test_torch_sequence_ops.py);
- the generic grads of each differentiable op under a seeded output grad,
  at the same tolerance;
- ties and duplicates: argsort (ascending and descending) and top_k_v2
  (largest and smallest) over rows with ties keep the lower index first;
  scatter over repeated ids (the last update wins when overwriting, as
  XLA's CPU backend applies them in order; otherwise every update adds)
  and scatter_nd_add over repeated index tuples, bitwise alike when rerun;
- the random ops by distribution (their bits are the port's own: mean,
  spread, range, a permutation's values);
- the registration flags (no_grad, stateful, needs_rng, diff_inputs) as
  the TPU package registers them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch.ops import rng
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad

RTOL, ATOL = 1e-5, 1e-6

NEW_OPS = (
    "arg_max", "arg_min", "argsort", "cross", "diag", "diag_embed", "expand",
    "expand_as", "eye", "fill_any_like", "fill_constant_batch_size_like",
    "fill_zeros_like", "flatten_contiguous_range", "flip", "gather_nd",
    "gaussian_random_batch_size_like", "index_sample", "index_select",
    "linspace", "meshgrid", "multiplex", "pad", "pad2d", "pad_constant_like",
    "randint", "randperm", "range", "reshape", "reverse", "roll",
    "sampling_id", "scatter", "scatter_nd_add", "seed", "shape",
    "shard_index", "size", "slice", "split", "stack", "strided_slice",
    "tile", "top_k_v2", "transpose", "tril_triu", "unbind",
    "uniform_random_batch_size_like", "unique", "unique_with_counts",
    "unsqueeze", "unstack", "where", "where_index", "isinf", "isnan")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small kernels gain nothing from more,
    several test processes share the host's cores, and the bitwise
    reruns here must not see a product split differently."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _attrs(ops, op_type, attrs):
    return dict(ops.get(op_type).attr_defaults, **attrs)


def _run(op_type, ins, attrs=None, grad=True, grad_seed=7, device=None):
    """Both packages' kernels on numpy ``ins`` (slot → list of arrays):
    every output compared (integers exactly), then with ``grad`` the
    generic grads of the float inputs. → the port's outputs."""
    attrs = attrs or {}
    tattrs = _attrs(TOPS, op_type, attrs)
    if device is not None:
        tattrs["_device"] = device
    jattrs = _attrs(JOPS, op_type, attrs)
    tins = {s: [torch.from_numpy(np.asarray(a)) for a in v]
            for s, v in ins.items()}
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    tout = TOPS.get(op_type).kernel(tins, tattrs)
    jout = JOPS.get(op_type).kernel(jins, jattrs)
    assert set(tout) == set(jout)
    r = np.random.RandomState(grad_seed)
    for slot in jout:
        assert len(tout[slot]) == len(jout[slot]), slot
        for i, (tv, jv) in enumerate(zip(tout[slot], jout[slot])):
            t, j = tv.detach().numpy(), np.asarray(jv)
            assert t.shape == j.shape, (slot, i, t.shape, j.shape)
            if np.issubdtype(j.dtype, np.floating):
                np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{slot}[{i}]")
            else:
                np.testing.assert_array_equal(t, j, err_msg=f"{slot}[{i}]")
        if grad and np.issubdtype(np.asarray(jout[slot][0]).dtype,
                                  np.floating):
            gs = [r.normal(size=np.asarray(j).shape).astype(np.float32)
                  for j in jout[slot]]
            tins[slot + "@GRAD"] = [torch.from_numpy(g) for g in gs]
            jins[slot + "@GRAD"] = [jnp.asarray(g) for g in gs]
    if grad:
        slots = list(ins)
        wanted = [s + "@GRAD" for s in slots]
        tg = t_generic_grad(op_type, tins, tattrs, wanted, slots)
        jg = j_generic_grad(op_type, jins, jattrs, wanted, slots)
        assert any(v is not None for s in jg for v in jg[s])
        for slot in jg:
            for t, j in zip(tg.get(slot) or [], jg[slot]):
                assert (t is None) == (j is None), slot
                if j is not None:
                    np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                               rtol=RTOL, atol=ATOL,
                                               err_msg=slot)
    return tout


def test_every_op_registered_with_the_reference_flags():
    for t in NEW_OPS:
        ti, ji = TOPS.get(t), JOPS.get(t)
        for flag in ("no_grad", "stateful", "needs_rng"):
            assert getattr(ti, flag) == getattr(ji, flag), (t, flag)
        assert list(ti.diff_input_slots or []) == \
            list(ji.diff_input_slots or []), t


# ----------------------------------------------------------- creation
X34 = _x((3, 4))
CREATION = [
    ("fill_any_like", {"X": [X34]}, {"value": 2.5}),
    ("fill_any_like", {"X": [X34]}, {"value": 7.0, "dtype": 2}),
    ("fill_zeros_like", {"X": [X34]}, {}),
    ("fill_constant_batch_size_like", {"Input": [_x((5, 2))]},
     {"shape": [-1, 3, 4], "value": 1.5}),
    ("fill_constant_batch_size_like", {"Input": [_x((2, 6))]},
     {"shape": [4, -1], "value": -1.0, "input_dim_idx": 1,
      "output_dim_idx": 1}),
    ("diag", {"Diagonal": [_x((4,))]}, {}),
    ("diag", {"Diagonal": [X34]}, {}),
    ("shape", {"Input": [_x((2, 3, 5))]}, {}),
    ("size", {"Input": [_x((2, 3, 5))]}, {}),
    ("seed", {}, {"seed": 1234}),
    ("range", {"Start": [np.array([1.0], np.float32)],
               "End": [np.array([4.0], np.float32)],
               "Step": [np.array([0.5], np.float32)]}, {}),
    ("range", {"Start": [np.array([0], np.int32)],
               "End": [np.array([7], np.int32)],
               "Step": [np.array([2], np.int32)]}, {}),
    ("linspace", {"Start": [np.array([-1.0], np.float32)],
                  "Stop": [np.array([2.0], np.float32)],
                  "Num": [np.array([7], np.int32)]}, {}),
    ("eye", {}, {"num_rows": 3}),
    ("eye", {}, {"num_rows": 3, "num_columns": 5}),
]


@pytest.mark.parametrize("op,ins,attrs", CREATION,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CREATION)])
def test_creation(op, ins, attrs):
    _run(op, ins, attrs, grad=False, device=torch.device("cpu"))


@pytest.mark.parametrize("attrs", [{}, {"offset": 1}, {"offset": -2},
                                   {"dim1": 0, "dim2": 2}])
def test_diag_embed(attrs):
    _run("diag_embed", {"Input": [_x((2, 3))]}, attrs)


# ----------------------------------------------------------- shape
SHAPE = [
    ("reshape", {"X": [_x((2, 3, 4))]}, {"shape": [0, -1]}),
    ("reshape", {"X": [_x((2, 3, 4))]}, {"shape": [4, 6]}),
    ("transpose", {"X": [_x((2, 3, 4))]}, {"axis": [2, 0, 1]}),
    ("unsqueeze", {"X": [_x((2, 3))]}, {"axes": [0, 2]}),
    ("flatten_contiguous_range", {"X": [_x((2, 3, 4, 5))]},
     {"start_axis": 1, "stop_axis": 2}),
    ("flatten_contiguous_range", {"X": [_x((2, 3, 4))]},
     {"start_axis": 0, "stop_axis": -1}),
    ("split", {"X": [_x((4, 6))]}, {"axis": 1, "num": 3}),
    ("split", {"X": [_x((4, 6))]}, {"axis": 1, "sections": [1, -1, 2]}),
    ("split", {"X": [_x((6, 2))]}, {"axis": 0, "sections": [2, 4]}),
    ("stack", {"X": [_x((2, 3), 1), _x((2, 3), 2), _x((2, 3), 3)]},
     {"axis": 1}),
    ("unstack", {"X": [_x((2, 3, 4))]}, {"axis": 1}),
    ("unbind", {"X": [_x((2, 3, 4))]}, {"axis": -1}),
    ("expand", {"X": [_x((2, 1, 3))]}, {"expand_times": [2, 4, 1]}),
    ("expand", {"X": [_x((2, 3))], "ExpandTimes": [np.array([3, 2],
                                                            np.int32)]},
     {}),
    ("expand_as", {"X": [_x((2, 1))], "target_tensor": [_x((4, 3))]}, {}),
    ("tile", {"X": [_x((2, 3))]}, {"repeat_times": [2, 1, 2]}),
    ("slice", {"Input": [_x((4, 5, 6))]},
     {"axes": [0, 2], "starts": [1, -4], "ends": [3, 100]}),
    ("slice", {"Input": [_x((4, 5, 6))]},
     {"axes": [1], "starts": [2], "ends": [3], "decrease_axis": [1]}),
    ("slice", {"Input": [_x((4, 5))],
               "StartsTensor": [np.array([1], np.int32)],
               "EndsTensor": [np.array([-1], np.int32)]},
     {"axes": [1], "starts": [0], "ends": [0]}),
    ("strided_slice", {"Input": [_x((6, 7))]},
     {"axes": [0, 1], "starts": [1, 0], "ends": [6, 7], "strides": [2, 3]}),
    ("strided_slice", {"Input": [_x((6, 7))]},
     {"axes": [1], "starts": [5], "ends": [0], "strides": [-2]}),
    ("strided_slice", {"Input": [_x((6, 7))]},
     {"axes": [0], "starts": [-1], "ends": [-7], "strides": [-1]}),
    ("pad", {"X": [_x((2, 3))]}, {"paddings": [1, 0, 2, 3],
                                  "pad_value": 0.5}),
    ("pad2d", {"X": [_x((1, 2, 4, 5))]}, {"paddings": [1, 2, 0, 3]}),
    ("pad2d", {"X": [_x((1, 2, 4, 5))]},
     {"paddings": [1, 2, 2, 1], "mode": "reflect"}),
    ("pad2d", {"X": [_x((1, 2, 4, 5))]},
     {"paddings": [1, 2, 2, 1], "mode": "edge"}),
    ("pad2d", {"X": [_x((1, 4, 5, 2))]},
     {"paddings": [1, 0, 2, 1], "mode": "constant", "pad_value": -1.0,
      "data_format": "NHWC"}),
    ("pad_constant_like", {"X": [_x((4, 5))], "Y": [_x((2, 3))]},
     {"pad_value": 0.25}),
    ("flip", {"X": [_x((2, 3, 4))]}, {"axis": [0, -1]}),
    ("reverse", {"X": [_x((2, 3, 4))]}, {"axis": [1]}),
    ("roll", {"X": [_x((3, 4))]}, {"shifts": [1, -2], "dims": [0, 1]}),
    ("roll", {"X": [_x((3, 4))]}, {"shifts": [5], "dims": []}),
    ("meshgrid", {"X": [_x((3,), 1), _x((4,), 2)]}, {}),
    ("tril_triu", {"X": [_x((4, 5))]}, {"diagonal": 1, "lower": True}),
    ("tril_triu", {"X": [_x((4, 5))]}, {"diagonal": -1, "lower": False}),
    ("cross", {"X": [_x((4, 3), 1)], "Y": [_x((4, 3), 2)]}, {"dim": 1}),
    ("cross", {"X": [_x((3, 2), 1)], "Y": [_x((3, 2), 2)]}, {"dim": 0}),
]


@pytest.mark.parametrize("op,ins,attrs", SHAPE,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SHAPE)])
def test_shape_ops(op, ins, attrs):
    _run(op, ins, attrs)


# ----------------------------------------------------------- gather/scatter
GATHER = [
    ("gather_nd", {"X": [_x((3, 4, 5))],
                   "Index": [np.array([[0, 1], [2, 3], [0, 1]], np.int64)]},
     {}),
    ("gather_nd", {"X": [_x((3, 4))],
                   "Index": [np.array([[[2], [0]], [[2], [1]]], np.int64)]},
     {}),
    ("index_select", {"X": [_x((4, 5))],
                      "Index": [np.array([3, 0, 3, 1], np.int64)]},
     {"dim": 1}),
    ("index_select", {"X": [_x((4, 5))],
                      "Index": [np.array([2, 2, 0], np.int64)]}, {"dim": 0}),
    ("index_sample", {"X": [_x((3, 6))],
                      "Index": [np.array([[0, 5, 5], [1, 1, 2], [4, 0, 3]],
                                         np.int64)]}, {}),
    ("where", {"Condition": [_x((3, 4), 9) > 0], "X": [_x((3, 4), 1)],
               "Y": [_x((3, 4), 2)]}, {}),
    ("multiplex", {"X": [_x((4, 3), 1), _x((4, 3), 2), _x((4, 3), 3)],
                   "Ids": [np.array([[2], [0], [2], [1]], np.int32)]}, {}),
]


@pytest.mark.parametrize("op,ins,attrs", GATHER,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(GATHER)])
def test_gather_ops(op, ins, attrs):
    _run(op, ins, attrs)


@pytest.mark.parametrize("overwrite", [True, False])
def test_scatter_repeated_ids(overwrite):
    ids = np.array([3, 1, 3, 0, 1, 3], np.int64)
    ins = {"X": [_x((5, 4))], "Ids": [ids], "Updates": [_x((6, 4), 1)]}
    o = _run("scatter", ins, {"overwrite": overwrite})["Out"][0].numpy()
    upd = ins["Updates"][0]
    if overwrite:  # the last update of a repeated id wins
        np.testing.assert_array_equal(o[3], upd[5])
        np.testing.assert_array_equal(o[1], upd[4])
    else:
        np.testing.assert_allclose(o[3], upd[0] + upd[2] + upd[5],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(o[[2, 4]], ins["X"][0][[2, 4]])
    again = TOPS.get("scatter").kernel(
        {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()},
        _attrs(TOPS, "scatter", {"overwrite": overwrite}))["Out"][0]
    assert np.array_equal(again.numpy(), o)


def test_scatter_nd_add_repeated_tuples():
    idx = np.array([[1, 2], [0, 0], [1, 2], [1, 2], [2, 3]], np.int64)
    ins = {"X": [_x((3, 4, 2))], "Index": [idx], "Updates": [_x((5, 2), 1)]}
    o = _run("scatter_nd_add", ins)["Out"][0].numpy()
    upd = ins["Updates"][0]
    np.testing.assert_allclose(o[1, 2], ins["X"][0][1, 2] + upd[0] + upd[2]
                               + upd[3], rtol=RTOL, atol=ATOL)
    # a slice index (fewer index dims than X's): whole rows added
    _run("scatter_nd_add", {"X": [_x((4, 3))],
                            "Index": [np.array([[2], [2], [0]], np.int64)],
                            "Updates": [_x((3, 3), 2)]})


def test_where_index_and_shard_index():
    cond = _x((3, 4), 5) > 0.2
    _run("where_index", {"Condition": [cond]}, grad=False)
    ids = np.array([[0], [7], [13], [19], [6]], np.int64)
    for sid in range(3):
        _run("shard_index", {"X": [ids]},
             {"index_num": 20, "nshards": 3, "shard_id": sid,
              "ignore_value": -1}, grad=False)


# ----------------------------------------------------------- sorting
TIES = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0],
                 [0.0, 0.0, -1.0, 0.0, 5.0, 5.0]], np.float32)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("axis", [-1, 0])
def test_argsort_ties_keep_index_order(descending, axis):
    o = _run("argsort", {"X": [TIES]}, {"axis": axis,
                                        "descending": descending},
             grad=False)
    if axis == -1 and descending:
        assert o["Indices"][0][0].tolist() == [0, 2, 5, 3, 1, 4]


@pytest.mark.parametrize("largest", [True, False])
def test_top_k_v2_ties_take_the_lower_index(largest):
    o = _run("top_k_v2", {"X": [TIES]}, {"k": 3, "largest": largest})
    want = [[0, 2, 5], [4, 5, 0]] if largest else [[1, 4, 3], [2, 0, 1]]
    assert o["Indices"][0].tolist() == want
    _run("top_k_v2", {"X": [_x((4, 5))]}, {"k": 2, "axis": 0})
    _run("top_k_v2", {"X": [_x((3, 6))],
                      "K": [np.array([4], np.int32)]}, {})


@pytest.mark.parametrize("op", ["arg_max", "arg_min"])
def test_arg_max_min_ties_take_the_first(op):
    _run(op, {"X": [TIES]}, {"axis": 1}, grad=False)
    _run(op, {"X": [_x((3, 4, 5))]}, {"axis": 0}, grad=False)


@pytest.mark.parametrize("op", ["unique", "unique_with_counts"])
def test_unique_first_occurrence_order(op):
    x = np.array([5, 2, 5, 7, 2, 2, 9, 0], np.int64)
    o = _run(op, {"X": [x]}, {}, grad=False)
    assert o["Out"][0].tolist() == [5, 2, 7, 9, 0]


@pytest.mark.parametrize("op", ["isinf", "isnan"])
def test_isinf_isnan(op):
    for vals in ([1.0, 2.0], [np.inf, 1.0], [np.nan, 1.0],
                 [np.nan, -np.inf]):
        _run(op, {"X": [np.array(vals, np.float32)]}, grad=False)


# ----------------------------------------------------------- random
def _keyed(op_type, ins, attrs, key=12345):
    a = _attrs(TOPS, op_type, attrs)
    a["_rng"] = lambda: torch.tensor([key], dtype=torch.int64)
    a["_device"] = torch.device("cpu")
    return TOPS.get(op_type).kernel(
        {s: [torch.from_numpy(np.asarray(v)) for v in vs]
         for s, vs in ins.items()}, a)


def test_batch_size_like_randoms_by_distribution():
    x = np.zeros((300, 3), np.float32)
    u = _keyed("uniform_random_batch_size_like", {"Input": [x]},
               {"shape": [-1, 200], "min": -2.0, "max": 3.0})["Out"][0]
    assert tuple(u.shape) == (300, 200)
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    assert abs(float(u.mean()) - 0.5) < 0.03
    assert abs(float(u.var()) - 25.0 / 12) < 0.05
    g = _keyed("gaussian_random_batch_size_like", {"Input": [x]},
               {"shape": [7, -1], "mean": 1.0, "std": 2.0,
                "input_dim_idx": 0, "output_dim_idx": 1})["Out"][0]
    assert tuple(g.shape) == (7, 300)
    assert abs(float(g.mean()) - 1.0) < 0.1
    assert abs(float(g.std()) - 2.0) < 0.1


def test_randint_randperm_by_distribution():
    r = _keyed("randint", {}, {"shape": [20000], "low": -3,
                               "high": 5})["Out"][0]
    assert r.dtype == torch.int64
    counts = np.bincount(r.numpy() + 3, minlength=8)
    assert counts.min() > 2300 and counts.max() < 2700
    p = _keyed("randperm", {}, {"n": 100})["Out"][0]
    assert sorted(p.tolist()) == list(range(100))
    assert p.tolist() != list(range(100))
    q = _keyed("randperm", {}, {"n": 100}, key=777)["Out"][0]
    assert q.tolist() != p.tolist()


def test_sampling_id_by_distribution():
    probs = np.tile(np.array([[0.1, 0.2, 0.0, 0.7]], np.float32),
                    (20000, 1))
    ids = _keyed("sampling_id", {"X": [probs]}, {})["Out"][0].numpy()
    freq = np.bincount(ids, minlength=4) / len(ids)
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.0, 0.7], atol=0.015)


def test_rng_randint_is_the_draws_law():
    """rng.randint, the draw nce's negatives use too: uniform over the
    span, from the key alone."""
    key = torch.tensor([99], dtype=torch.int64)
    a = rng.randint(key, (50000,), 0, 44068)
    assert int(a.min()) >= 0 and int(a.max()) < 44068
    assert abs(float(a.double().mean()) - 44067 / 2) < 300
    assert torch.equal(a, rng.randint(key, (50000,), 0, 44068))


# ----------------------------------------------------------- layers
LAYERS = [
    ("tensor", n) for n in (
        "argmax", "argmin", "argsort", "create_tensor", "diag", "eye",
        "fill_constant_batch_size_like", "has_inf", "has_nan", "linspace",
        "ones_like", "range", "reverse", "zeros_like")] + [
    ("nn", n) for n in (
        "expand", "expand_as", "gather_nd",
        "gaussian_random_batch_size_like", "index_sample", "index_select",
        "multiplex", "pad", "pad2d", "pad_constant_like", "rank", "roll",
        "sampling_id", "scatter", "scatter_nd", "scatter_nd_add", "shape",
        "shard_index", "size", "slice", "split", "stack", "strided_slice",
        "unbind", "uniform_random_batch_size_like", "unique",
        "unique_with_counts", "unstack", "where", "linear_chain_crf",
        "crf_decoding")] + [
    ("loss", "nce"), ("loss", "hsigmoid"), ("rnn", "lstm"),
    ("rnn", "lstm_unit")]


@pytest.mark.parametrize("module,name", LAYERS,
                         ids=[f"{m}.{n}" for m, n in LAYERS])
def test_layer_signatures_are_the_references(module, name):
    import importlib
    import inspect
    from paddle_tpu_torch.fluid import layers as tlayers
    j = getattr(importlib.import_module(
        f"paddle_tpu.fluid.layers.{module}"), name)
    t = getattr(importlib.import_module(
        f"paddle_tpu_torch.fluid.layers.{module}"), name)
    assert getattr(tlayers, name) is t
    assert inspect.signature(t) == inspect.signature(j)


def _layer_program(fluid):
    """A program over the new layers, with unique (stateful) and
    where_index (stateful) in the middle, so the port runs it
    segmented."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[6], dtype="float32")
        ids = fluid.data("ids", shape=[1], dtype="int64")
        sid = fluid.data("sid", shape=[1], dtype="int64")
        a, b, c = layers.split(x, [2, -1, 1], dim=1)
        s = layers.stack([a, layers.reverse(a, 1)], axis=1)
        t = layers.reduce_sum(layers.strided_slice(
            s, axes=[2], starts=[1], ends=[-3], strides=[-1]))
        sl = layers.slice(x, axes=[1], starts=[1], ends=[5])
        e = layers.expand(c, [1, 4])
        sc = layers.scatter(sl, sid, e, overwrite=False)
        srt, idx = layers.argsort(sc, axis=1, descending=True)
        g = layers.index_sample(srt, idx)
        u, ui = layers.unique(layers.reshape(ids, [-1]))
        pad = layers.pad(g, [0, 1, 1, 0], pad_value=0.5)
        w = layers.where(layers.cast(pad > 0.0, "bool"))
        out = layers.reduce_mean(pad) + t + layers.reduce_sum(
            layers.cast(u, "float32"))
    return main, startup, out, w, ui


def test_layer_program_compiled_segmented_and_the_tpu_package():
    import paddle_tpu.fluid as jfluid
    from paddle_tpu_torch import fluid as tfluid
    from paddle_tpu_torch.fluid import core as tcore
    rng = np.random.RandomState(3)
    feed = {"x": rng.normal(size=(4, 6)).astype(np.float32),
            "ids": np.array([[3], [1], [3], [7]], np.int64),
            "sid": np.array([[2], [0], [2], [1]], np.int64)}
    jm, _, jo, jw, jui = _layer_program(jfluid)
    jres = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed=feed, fetch_list=[jo, jw, jui])
    tm, _, to, tw, tui = _layer_program(tfluid)
    res = {}
    for mode in ("compiled", "interpreted"):
        tcore.set_flag("FLAGS_executor_mode", mode)
        try:
            exe = tfluid.Executor(tfluid.CPUPlace())
            res[mode] = exe.run(tm, feed=feed, fetch_list=[to, tw, tui])
            if mode == "compiled":
                assert exe._last_run_mode == "segmented"
        finally:
            tcore.set_flag("FLAGS_executor_mode", "compiled")
    for a, b in zip(res["compiled"], res["interpreted"]):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(res["compiled"][0], np.asarray(jres[0]),
                               rtol=RTOL, atol=ATOL)
    for k in (1, 2):
        np.testing.assert_array_equal(res["compiled"][k], np.asarray(jres[k]))
