"""The LoD sequence ops, sequence_mask, cos_sim and the activations of
paddle_tpu_torch against the TPU package's kernels, on the CPU
(ops/sequence_ops.py, ops/math_ops.py):

- every op of paddle_tpu/ops/sequence_ops.py with ragged LoDs that hold
  an empty sequence: the forward outputs and the output LoDs the kernels
  declare, and the generic grads under seeded output grads, at rtol 1e-5,
  atol 1e-6; the two custom grad ops (sequence_unpad_grad,
  sequence_slice_grad) kernel against kernel;
- sequence_mask (the TPU package's nn_extra_ops.py:147) and cos_sim
  (math_ops.py:436, a one-row Y broadcast too);
- the 28 activations the port adds, forward and grad, each over inputs
  inside its domain and away from its kinks;
- the device constants a compiled plan binds (``_lodc``): a second call
  with the cache makes no tensor from the host.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch.ops import sequence_ops
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad

RTOL, ATOL = 1e-5, 1e-6
LOD = ((0, 3, 3, 7, 8),)          # 4 sequences, the second empty
LOD2 = ((0, 1, 3), (0, 2, 2, 5, 8))  # two levels over 8 rows


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


def _run(op_type, ins, attrs, lods, grad=True, grad_seed=7):
    """Both packages' kernels on numpy ``ins`` with ``lods`` (slot →
    [levels or None]): outputs, declared output LoDs and, with ``grad``,
    the generic grads compared. → the port's outputs."""
    tattrs = dict(TOPS.get(op_type).attr_defaults, **attrs, _lod=lods)
    jattrs = dict(JOPS.get(op_type).attr_defaults, **attrs, _lod=lods)
    tins = {s: [torch.from_numpy(np.asarray(a)) for a in v]
            for s, v in ins.items()}
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
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
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL, err_msg=slot)
        if grad and np.issubdtype(j.dtype, np.floating):
            g = r.normal(size=j.shape).astype(np.float32)
            tins[slot + "@GRAD"] = [torch.from_numpy(g)]
            jins[slot + "@GRAD"] = [jnp.asarray(g)]
    if grad:
        slots = list(ins)
        wanted = [s + "@GRAD" for s in slots]
        tg = t_generic_grad(op_type, tins, tattrs, wanted, slots)
        jg = j_generic_grad(op_type, jins, jattrs, wanted, slots)
        for slot in jg:
            for t, j in zip(tg.get(slot) or [], jg[slot]):
                assert (t is None) == (j is None), slot
                if j is not None:
                    np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                               rtol=RTOL, atol=ATOL,
                                               err_msg=slot)
    return tout


def _x(shape, seed=0):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ pooling
@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT", "MAX", "FIRST",
                                   "LAST"])
@pytest.mark.parametrize("lod", [LOD, LOD2], ids=["one_level", "two_levels"])
def test_sequence_pool(ptype, lod):
    out = _run("sequence_pool", {"X": [_x((8, 3))]},
               {"pooltype": ptype, "pad_value": 0.5}, {"X": [lod]})
    if lod is LOD:
        assert np.all(out["Out"][0].numpy()[1] == 0.5)


def test_sequence_pool_all_empty():
    for ptype in ("SUM", "MAX"):
        _run("sequence_pool", {"X": [_x((0, 3))]}, {"pooltype": ptype},
             {"X": [((0, 0, 0),)]}, grad=False)


def test_sequence_softmax():
    _run("sequence_softmax", {"X": [_x((8, 1))]}, {}, {"X": [LOD]})


# ------------------------------------------------------- gather-shaped
@pytest.mark.parametrize("x_lod", [None, ((0, 1, 3, 3, 4),)],
                         ids=["rows", "sequences"])
def test_sequence_expand(x_lod):
    _run("sequence_expand", {"X": [_x((4, 2))], "Y": [_x((8, 1))]},
         {"ref_level": -1}, {"X": [x_lod], "Y": [LOD]})


def test_sequence_expand_two_level_ref():
    _run("sequence_expand", {"X": [_x((2, 2))], "Y": [_x((8, 1))]},
         {"ref_level": 0}, {"X": [None], "Y": [LOD2]})


def test_sequence_expand_as():
    _run("sequence_expand_as", {"X": [_x((4, 2))], "Y": [_x((8, 1))]}, {},
         {"X": [None], "Y": [LOD]})


def test_sequence_concat():
    _run("sequence_concat", {"X": [_x((8, 2)), _x((5, 2), 1)]}, {},
         {"X": [LOD, ((0, 0, 2, 4, 5),)]})


@pytest.mark.parametrize("clen,cstart", [(3, -1), (4, -2), (2, 0)])
def test_sequence_conv(clen, cstart):
    _run("sequence_conv", {"X": [_x((8, 3))],
                           "Filter": [_x((clen * 3, 4), 1)]},
         {"contextLength": clen, "contextStart": cstart}, {"X": [LOD]})


@pytest.mark.parametrize("plen", [-1, 6])
def test_sequence_pad(plen):
    out = _run("sequence_pad", {"X": [_x((8, 3))],
                                "PadValue": [np.array([0.25], np.float32)]},
               {"padded_length": plen}, {"X": [LOD], "PadValue": [None]})
    assert out["Length"][0].dtype == torch.int64


def test_sequence_unpad_and_its_grad():
    x = _x((4, 5, 3))
    length = np.array([2, 0, 5, 1], np.int64)
    _run("sequence_unpad", {"X": [x], "Length": [length]}, {},
         {"X": [None], "Length": [None]})
    # the Length LoD sequence_pad leaves on it wins over its values
    _run("sequence_unpad", {"X": [x], "Length": [length]}, {},
         {"X": [None], "Length": [((0, 1, 4, 4, 9),)]})
    g = _x((8, 3), 2)
    ins = {"X": [x], "Length": [length], "Out@GRAD": [g]}
    _run("sequence_unpad_grad", ins, {},
         {"X": [None], "Length": [None], "Out@GRAD": [None]}, grad=False)


def test_sequence_reshape():
    _run("sequence_reshape", {"X": [_x((8, 4))]}, {"new_dim": 8},
         {"X": [((0, 2, 2, 6, 8),)]})
    _run("sequence_reshape", {"X": [_x((8, 4))]}, {"new_dim": 2},
         {"X": [LOD]})


def test_sequence_reverse():
    _run("sequence_reverse", {"X": [_x((8, 3))]}, {}, {"X": [LOD]})


def test_sequence_slice_and_its_grad():
    ins = {"X": [_x((8, 3))],
           "Offset": [np.array([[1], [0], [0], [0]], np.int64)],
           "Length": [np.array([[2], [0], [3], [1]], np.int64)]}
    lods = {"X": [LOD], "Offset": [None], "Length": [None]}
    _run("sequence_slice", ins, {}, lods)
    ins["Out@GRAD"] = [_x((6, 3), 3)]
    lods["Out@GRAD"] = [None]
    _run("sequence_slice_grad", ins, {}, lods, grad=False)


def test_sequence_scatter():
    ids = np.array([[1], [4], [0], [0], [5], [2]], np.int64)  # a repeat
    _run("sequence_scatter", {"X": [_x((4, 6))], "Ids": [ids],
                              "Updates": [_x((6, 1), 1)]}, {},
         {"X": [None], "Ids": [((0, 2, 2, 5, 6),)], "Updates": [None]})


def test_sequence_enumerate():
    x = np.random.RandomState(0).randint(1, 9, (8, 1)).astype(np.int32)
    _run("sequence_enumerate", {"X": [x]}, {"win_size": 3, "pad_value": 0},
         {"X": [LOD]}, grad=False)


def test_sequence_erase():
    x = np.array([[2], [3], [5], [1], [2], [2], [7], [5]], np.int64)
    _run("sequence_erase", {"X": [x]}, {"tokens": [2, 5]}, {"X": [LOD]},
         grad=False)


# ------------------------------------------------------------ LoD only
@pytest.mark.parametrize("how", ["target_lod", "y_lod", "y_values"])
def test_lod_reset(how):
    x = _x((8, 2))
    if how == "target_lod":
        _run("lod_reset", {"X": [x]}, {"target_lod": [0, 4, 8]},
             {"X": [LOD]})
    elif how == "y_lod":
        _run("lod_reset", {"X": [x], "Y": [_x((8, 1))]}, {},
             {"X": [None], "Y": [LOD]})
    else:
        _run("lod_reset", {"X": [x],
                           "Y": [np.array([0, 5, 8], np.int32)]}, {},
             {"X": [LOD], "Y": [None]})


def test_lod_append():
    _run("lod_append", {"X": [_x((8, 2))]}, {"level": [0, 2, 3, 5, 8]},
         {"X": [((0, 1, 4),)]})


def test_im2sequence():
    _run("im2sequence", {"X": [_x((2, 3, 5, 5))]},
         {"kernels": [2, 2], "strides": [1, 2], "paddings": [1, 0, 0, 1]},
         {"X": [None]})


# ----------------------------------------------------- mask and cos_sim
@pytest.mark.parametrize("maxlen", [-1, 6])
def test_sequence_mask(maxlen):
    x = np.array([3, 0, 5], np.int64)
    _run("sequence_mask", {"X": [x]}, {"maxlen": maxlen, "out_dtype": 5},
         {"X": [None]}, grad=False)


@pytest.mark.parametrize("y_rows", [4, 1])
def test_cos_sim(y_rows):
    _run("cos_sim", {"X": [_x((4, 5))], "Y": [_x((y_rows, 5), 1)]}, {},
         {"X": [None], "Y": [None]})


# --------------------------------------------------------- activations
def _uniform(lo, hi):
    return np.random.RandomState(4).uniform(lo, hi, (6, 5)).astype(
        np.float32)


def _away(x, kinks, gap=0.05):
    """``x`` with every value within ``gap`` of a kink moved off it."""
    for k in kinks:
        near = np.abs(x - k) < gap
        x[near] = k + np.where(x[near] >= k, gap, -gap) * 2
    return x


ACTS = {
    "tanh": ({}, (-3, 3), ()), "logsigmoid": ({}, (-6, 6), ()),
    "tanh_shrink": ({}, (-3, 3), ()), "sin": ({}, (-3, 3), ()),
    "acos": ({}, (-0.9, 0.9), ()), "asin": ({}, (-0.9, 0.9), ()),
    "atan": ({}, (-3, 3), ()), "sinh": ({}, (-3, 3), ()),
    "cosh": ({}, (-3, 3), ()), "log": ({}, (0.1, 4), ()),
    "log1p": ({}, (-0.5, 4), ()), "softplus": ({}, (-8, 8), ()),
    "softsign": ({}, (-3, 3), (0.0,)), "erf": ({}, (-2, 2), ()),
    "leaky_relu": ({"alpha": 0.1}, (-3, 3), (0.0,)),
    "elu": ({"alpha": 0.7}, (-3, 3), (0.0,)),
    "selu": ({}, (-3, 3), (0.0,)),
    "relu6": ({"threshold": 2.0}, (-1, 3), (0.0, 2.0)),
    "brelu": ({"t_min": -1.0, "t_max": 1.5}, (-2, 2), (-1.0, 1.5)),
    "soft_relu": ({"threshold": 2.0}, (-3, 3), (-2.0, 2.0)),
    "hard_sigmoid": ({"slope": 0.3, "offset": 0.4}, (-3, 3),
                     (-0.4 / 0.3, 0.6 / 0.3)),
    "hard_swish": ({}, (-5, 5), (-3.0, 3.0)),
    "swish": ({"beta": 1.5}, (-3, 3), ()),
    "stanh": ({"scale_a": 0.5, "scale_b": 1.2}, (-3, 3), ()),
    "softshrink": ({"lambda": 0.4}, (-2, 2), (-0.4, 0.4)),
    "hard_shrink": ({"threshold": 0.6}, (-2, 2), (-0.6, 0.6)),
    "thresholded_relu": ({"threshold": 0.3}, (-2, 2), (0.3,)),
}


@pytest.mark.parametrize("name", sorted(ACTS))
def test_activation(name):
    attrs, (lo, hi), kinks = ACTS[name]
    _run(name, {"X": [_away(_uniform(lo, hi), kinks)]}, attrs,
         {"X": [None]})


def test_round_has_no_grad():
    assert TOPS.get("round").no_grad and JOPS.get("round").no_grad
    _run("round", {"X": [_uniform(-3, 3)]}, {}, {"X": [None]}, grad=False)


def test_every_tpu_sequence_op_is_registered():
    """Every op of paddle_tpu/ops/sequence_ops.py, with the registry's
    flags the executor reads."""
    import paddle_tpu.ops.sequence_ops as jseq
    names = {n for n in JOPS.all_op_types()
             if JOPS.get(n).kernel is not None
             and JOPS.get(n).kernel.__module__ == jseq.__name__}
    assert len(names) == 19
    for n in names:
        t, j = TOPS.get(n), JOPS.get(n)
        assert (t.needs_lod, t.no_grad, t.stateful) == \
            (j.needs_lod, j.no_grad, j.stateful), n
        assert t.attr_defaults == j.attr_defaults, n
        assert (t.grad_maker is None) == (j.grad_maker is None), n


# ---------------------------------------------------- bound constants
def test_bound_constants_are_made_once(monkeypatch):
    """With a plan's ``_lodc`` cache the first call makes the LoD's device
    constants and a second call takes them from the cache: no tensor is
    made from a host array (what a CUDA graph capture could not replay)."""
    x = torch.from_numpy(_x((8, 3)))
    f = torch.from_numpy(_x((9, 4), 1))
    attrs = {"contextLength": 3, "contextStart": -1, "_lod": {"X": [LOD]},
             "_lodc": {}}
    first = TOPS.get("sequence_conv").kernel({"X": [x], "Filter": [f]},
                                             attrs)
    assert len(attrs["_lodc"]) == 2

    def no_host(*a, **k):
        raise AssertionError("a LoD constant made from the host again")
    monkeypatch.setattr(sequence_ops.torch, "from_numpy", no_host)
    again = TOPS.get("sequence_conv").kernel({"X": [x], "Filter": [f]},
                                             attrs)
    assert torch.equal(first["Out"][0], again["Out"][0])
