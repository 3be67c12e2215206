"""The recurrent ops of paddle_tpu_torch against the TPU package's kernels,
on the CPU (ops/rnn_ops.py, ops/fused_ops.py, ops/math_ops.py):

- the LoD recurrences dynamic_lstm, dynamic_lstmp, dynamic_gru and their
  reference names lstmp and gru, with and without peepholes, initial
  states, ``is_reverse`` and ``origin_mode``, over ragged LoDs that hold
  an empty sequence: the outputs, the LoDs the kernels declare and the
  generic grads under seeded output grads, at rtol 1e-5, atol 1e-6;
- gru_unit's three outputs and grads, gather_tree, fusion_gru and
  fusion_lstm (their XX output the mul's product), rnn_memory_helper,
  cumsum and elementwise_floordiv (dynamic_decode's ops), and top_k's
  ties, which fall to the lower index as ``lax.top_k``'s do;
- the host ops beam_search (its ties and the finished branches, ids and
  LoDs bitwise) and beam_search_decode over the same tensor arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.fluid import core as jcore
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad

RTOL, ATOL = 1e-5, 1e-6
LOD = ((0, 3, 3, 7, 9),)            # 4 sequences, the second empty
H = 4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small kernels gain nothing from more,
    several test processes share the host's cores, and the CPU's BLAS
    may split a product differently from call to call when its threads
    are contended, which the bitwise checks here would see."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _norm(lod):
    if not lod:
        return None
    return tuple(tuple(int(v) for v in lvl) for lvl in lod)


def _run(op_type, ins, attrs, lods=None, grad=True, grad_seed=7,
         exact=False):
    """Both packages' kernels on numpy ``ins`` with ``lods`` (slot →
    [levels or None]): outputs (``exact``: bitwise), declared output LoDs
    and, with ``grad``, the generic grads compared. → the port's
    outputs."""
    lods = lods or {}
    tattrs = dict(TOPS.get(op_type).attr_defaults, **attrs, _lod=lods)
    jattrs = dict(JOPS.get(op_type).attr_defaults, **attrs, _lod=lods)
    tins = {s: [None if a is None else torch.from_numpy(np.asarray(a))
                for a in v] for s, v in ins.items()}
    jins = {s: [None if a is None else jnp.asarray(a) for a in v]
            for s, v in ins.items()}
    tout = TOPS.get(op_type).kernel(tins, tattrs)
    jout = JOPS.get(op_type).kernel(jins, jattrs)
    tl, jl = tout.pop("_lod", None), jout.pop("_lod", None)
    assert (tl is None) == (jl is None)
    if jl:
        assert set(tl) == set(jl)
        for slot in jl:
            assert [_norm(x) for x in tl[slot]] == \
                [_norm(x) for x in jl[slot]], slot
    assert set(tout) == set(jout)
    r = np.random.RandomState(grad_seed)
    for slot in jout:
        t, j = tout[slot][0].detach().numpy(), np.asarray(jout[slot][0])
        assert t.shape == j.shape, (slot, t.shape, j.shape)
        if exact:
            np.testing.assert_array_equal(t, j, err_msg=slot)
        else:
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                       err_msg=slot)
        if grad and np.issubdtype(j.dtype, np.floating):
            g = r.normal(size=j.shape).astype(np.float32)
            tins[slot + "@GRAD"] = [torch.from_numpy(g)]
            jins[slot + "@GRAD"] = [jnp.asarray(g)]
    if grad:
        slots = list(ins)
        wanted = [s + "@GRAD" for s in slots]
        tg = t_generic_grad(op_type, tins, tattrs, wanted, slots)
        jg = j_generic_grad(op_type, jins, jattrs, wanted, slots)
        checked = 0
        for slot in jg:
            for t, j in zip(tg.get(slot) or [], jg[slot]):
                assert (t is None) == (j is None), slot
                if j is not None:
                    np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                               rtol=RTOL, atol=ATOL,
                                               err_msg=slot)
                    checked += 1
        assert checked
    return tout


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale).astype(
        np.float32)


# ------------------------------------------------------ LoD recurrences
@pytest.mark.parametrize("peep", [True, False], ids=["peepholes", "plain"])
@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "h0c0"])
def test_dynamic_lstm(peep, rev, init):
    ins = {"Input": [_x((9, 4 * H))], "Weight": [_x((H, 4 * H), 1, 0.3)],
           "Bias": [_x((1, (7 if peep else 4) * H), 2, 0.3)]}
    if init:
        ins["H0"], ins["C0"] = [_x((4, H), 3)], [_x((4, H), 4)]
    _run("dynamic_lstm", ins, {"use_peepholes": peep, "is_reverse": rev},
         {"Input": [LOD]})


@pytest.mark.parametrize("op_type", ["dynamic_lstmp", "lstmp"])
@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
def test_dynamic_lstmp(op_type, rev):
    P = 3
    _run(op_type, {"Input": [_x((9, 4 * H))],
                   "Weight": [_x((P, 4 * H), 1, 0.3)],
                   "ProjWeight": [_x((H, P), 5, 0.3)],
                   "Bias": [_x((1, 7 * H), 2, 0.3)]},
         {"is_reverse": rev, "proj_activation": "tanh"}, {"Input": [LOD]})


@pytest.mark.parametrize("op_type", ["dynamic_gru", "gru"])
@pytest.mark.parametrize("origin", [False, True], ids=["new", "origin"])
@pytest.mark.parametrize("rev", [False, True], ids=["forward", "reverse"])
def test_dynamic_gru(op_type, origin, rev):
    _run(op_type, {"Input": [_x((9, 3 * H))],
                   "Weight": [_x((H, 3 * H), 1, 0.3)],
                   "Bias": [_x((1, 3 * H), 2, 0.3)],
                   "H0": [_x((4, H), 3)]},
         {"origin_mode": origin, "is_reverse": rev}, {"Input": [LOD]})


def test_dynamic_gru_activations_and_no_bias():
    _run("dynamic_gru", {"Input": [_x((9, 3 * H))],
                         "Weight": [_x((H, 3 * H), 1, 0.3)]},
         {"gate_activation": "sigmoid", "activation": "relu"},
         {"Input": [LOD]})


def test_recurrence_needs_lod():
    with pytest.raises(ValueError, match="must carry LoD"):
        TOPS.get("dynamic_gru").kernel(
            {"Input": [torch.zeros(2, 3 * H)],
             "Weight": [torch.zeros(H, 3 * H)]}, {"_lod": {}})


@pytest.mark.parametrize("origin", [False, True], ids=["new", "origin"])
def test_gru_unit(origin):
    _run("gru_unit", {"Input": [_x((3, 3 * H))],
                      "HiddenPrev": [_x((3, H), 1)],
                      "Weight": [_x((H, 3 * H), 2, 0.3)],
                      "Bias": [_x((1, 3 * H), 3, 0.3)]},
         {"origin_mode": origin})


@pytest.mark.parametrize("op_type", ["fusion_gru", "fusion_lstm"])
def test_fused_recurrences(op_type):
    D = 5
    gates = 3 if op_type == "fusion_gru" else 4
    out = _run(op_type, {"X": [_x((9, D))],
                         "WeightX": [_x((D, gates * H), 1, 0.3)],
                         "WeightH": [_x((H, gates * H), 2, 0.3)],
                         "Bias": [_x((1, gates * H), 3, 0.3)]},
               {}, {"X": [LOD]})
    mul = TOPS.get("mul").kernel({"X": [torch.from_numpy(_x((9, D)))],
                                  "Y": [torch.from_numpy(
                                      _x((D, gates * H), 1, 0.3))]}, {})
    assert torch.equal(out["XX"][0], mul["Out"][0])


def test_rnn_memory_helper():
    _run("rnn_memory_helper", {"X": [_x((3, 2))]}, {}, exact=True)


# ------------------------------------------------------ dynamic_decode's ops
@pytest.mark.parametrize("attrs", [{"axis": 1}, {"axis": 0, "reverse": True},
                                   {"axis": -1, "exclusive": True},
                                   {"flatten": True}])
def test_cumsum(attrs):
    _run("cumsum", {"X": [_x((3, 5))]}, attrs)
    _run("cumsum", {"X": [np.arange(12, dtype=np.int64).reshape(3, 4)]},
         attrs, grad=False, exact=True)


def test_elementwise_floordiv():
    x = np.array([[7, -7, 9, 0], [5, -1, 12, 3]], np.int64)
    y = np.array([2, 3, -4, 5], np.int64)
    _run("elementwise_floordiv", {"X": [x], "Y": [y]}, {}, grad=False,
         exact=True)


def test_top_k_ties_to_the_lower_index():
    x = np.array([[1, 3, 3, 2, 3], [0, 0, 0, 0, 0]], np.float32)
    out = _run("top_k", {"X": [x]}, {"k": 3}, exact=True, grad=False)
    assert out["Indices"][0].tolist() == [[1, 2, 4], [0, 1, 2]]


def test_gather_tree():
    # the reference's test_gather_tree_op.py example
    ids = np.array([[[2, 2], [6, 1]], [[3, 9], [6, 1]], [[0, 1], [9, 0]]],
                   np.int64)
    parents = np.array([[[0, 0], [1, 1]], [[1, 0], [1, 0]],
                        [[0, 0], [0, 1]]], np.int64)
    out = _run("gather_tree", {"Ids": [ids], "Parents": [parents]}, {},
               grad=False, exact=True)
    assert out["Out"][0].tolist() == [[[2, 2], [1, 6]], [[3, 3], [6, 1]],
                                      [[0, 1], [9, 0]]]


def test_gather_tree_random():
    rng = np.random.RandomState(0)
    T, B, K = 6, 3, 4
    _run("gather_tree", {"Ids": [rng.randint(0, 50, (T, B, K))],
                         "Parents": [rng.randint(0, K, (T, B, K))]}, {},
         grad=False, exact=True)


# ------------------------------------------------------ beam_search
def _beam(pre_ids, pre_scores, ids, scores, lod, **attrs):
    ins = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
           "scores": [scores]}
    if ids is not None:
        ins["ids"] = [ids]
    lods = {"pre_ids": [lod], "pre_scores": [lod], "scores": [lod]}
    return _run("beam_search", ins, attrs, lods, grad=False, exact=True)


def test_beam_search_step():
    """2 sources of 2 branches, beam 2, the reference's example."""
    out = _beam(np.array([[1], [2], [3], [4]], np.int64),
                np.array([[0.1], [0.2], [0.3], [0.4]], np.float32),
                np.array([[5, 6], [7, 8], [9, 10], [11, 12]], np.int64),
                np.array([[0.5, 0.4], [0.9, 0.1], [0.7, 0.6], [0.95, 0.2]],
                         np.float32), ((0, 2, 4), (0, 1, 2, 3, 4)),
                beam_size=2, end_id=0)
    assert out["selected_ids"][0].reshape(-1).tolist() == [5, 7, 9, 11]
    assert out["parent_idx"][0].tolist() == [0, 1, 2, 3]


def test_beam_search_ties_and_finished_branches():
    """Equal scores keep the (branch, k) order of the stable sort; a
    finished branch (pre_id == end_id) carries itself on."""
    out = _beam(np.array([[0], [3], [4]], np.int64),
                np.array([[-0.5], [-1.0], [-1.0]], np.float32),
                np.array([[5, 6], [7, 8], [9, 10]], np.int64),
                np.array([[-0.2, -0.2], [-0.5, -0.5], [-0.5, -0.7]],
                         np.float32), ((0, 3), (0, 1, 2, 3)),
                beam_size=3, end_id=0)
    assert out["selected_ids"][0].reshape(-1).tolist() == [0, 7, 8]
    assert out["parent_idx"][0].tolist() == [0, 1, 1]


def test_beam_search_without_ids():
    rng = np.random.RandomState(3)
    _beam(rng.randint(1, 9, (4, 1)).astype(np.int64),
          rng.rand(4, 1).astype(np.float32), None,
          np.round(rng.rand(4, 5), 1).astype(np.float32),
          ((0, 1, 4), (0, 1, 2, 3, 4)), beam_size=3, end_id=0)


class _Op:
    def __init__(self, inputs):
        self.inputs = inputs

    def input(self, slot):
        return self.inputs[slot]


def test_beam_search_decode():
    """Three steps of beam_search selections backtracked: the same
    hypotheses, scores and two-level LoD."""
    steps = [([1, 1], [-0.1, -0.2], ((0, 1, 2), (0, 1, 2))),
             ([4, 5, 6, 0], [-0.3, -0.4, -0.5, -0.6],
              ((0, 2, 4), (0, 2, 4))),
             ([7, 0, 8, 9], [-0.7, -0.4, -0.9, -1.0],
              ((0, 2, 4), (0, 1, 2, 3, 4)))]
    jscope, tscope = jcore.Scope(), tcore.Scope()
    for name, col in (("ids", 0), ("scores", 1)):
        jarr = jscope.var(name).get_lod_tensor_array()
        tarr = tscope.var(name).get_lod_tensor_array()
        for st in steps:
            a = np.asarray(st[col], np.int64 if col == 0 else np.float32)
            jarr.append(jcore.LoDTensor(jnp.asarray(a), st[2]))
            tarr.append(tcore.LoDTensor(torch.from_numpy(a), st[2]))
    op = _Op({"Ids": ["ids"], "Scores": ["scores"]})

    class _Ctx:
        scope = jscope
    _Ctx.op = op
    attrs = {"beam_size": 2, "end_id": 0}
    jout = JOPS.get("beam_search_decode").kernel(
        {}, dict(attrs, _ctx=_Ctx))
    tout = TOPS.get("beam_search_decode").kernel(
        {}, dict(attrs, _op=op, _scope=tscope))
    assert tout["_lod"] == jout["_lod"]
    for slot in ("SentenceIds", "SentenceScores"):
        np.testing.assert_array_equal(tout[slot][0].numpy(),
                                      np.asarray(jout[slot][0]))
    assert tout["SentenceIds"][0].tolist() == [1, 4, 7, 1, 5, 0, 1, 6, 8,
                                               1, 0]
