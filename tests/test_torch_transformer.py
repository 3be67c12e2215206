"""The Transformer slice of paddle_tpu_torch against the TPU package, on
the CPU, from seeded numpy inputs.

- Ops: add_position_encoding, one_hot / one_hot_v2, label_smooth,
  squeeze / squeeze2, the reduce_* family, increment, elementwise_pow /
  min / max and the comparisons, each against the TPU package's registry
  kernel in f32 at 1e-5 (and bitwise in bf16 where they do arithmetic
  with Python scalars: the port rounds its scalars to X's dtype as JAX
  does); their generic grads against ``jax.vjp`` at 1e-5.
- Variable operators: ``x + 1``, ``1 - x``, ``x * c``, ``c * x``,
  ``x / c``, ``c / x``, ``x ** -0.5``, ``-x`` and the comparisons emit the
  reference's ops and compute its values.
- Programs: ``build_wmt_train_program`` (Noam decay) and
  ``build_greedy_decode_program`` emit the same ops, slots and public
  attrs as the TPU package's functions of the same names.
- Training: 4 Adam steps at d_model 32, 4 heads, 1 + 1 layers, vocab 64,
  B = 2, S = 8, ragged masks, dropout 0, Noam, from the TPU package's
  startup parameters: losses and parameters at rtol 1e-4 / atol 1e-5 (the
  golden trajectories' tolerance); the Noam LR at rtol 1e-6 over 5 single
  runs and over one ``Executor.run(n_steps=5)`` window.
- Greedy decode: at every step the port's logits on its own prefix
  against the TPU package's on the same prefix (teacher forcing).
- Compiled against interpreted, bitwise (training with dropout 0.1, and
  decode); a feed array mutated in place is fed again, not served from
  the feed cache; ``python -m paddle_tpu_torch.bench transformer --device
  cpu`` prints its JSON line.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.models import transformer as jtr
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad

TOL = 1e-5
TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-5
LR_RTOL = 1e-6
BF16 = ml_dtypes.bfloat16
B, S = 2, 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _default_flags_seed():
    """The TPU package's startup draws from ``program.random_seed or
    FLAGS_seed``; another test file may have set the flag in this worker
    (tests/test_torch_resnet.py's fixture says why). Each test runs at the
    flag's default."""
    old = jcore.globals_["FLAGS_seed"]
    jcore.globals_["FLAGS_seed"] = 0
    yield
    jcore.globals_["FLAGS_seed"] = old


def _r(seed):
    return np.random.RandomState(seed)


def _torch(a):
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _host(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _run(op_type, ins, attrs, tol=TOL, bitwise=False):
    """Both packages' kernel on numpy ``ins``; every output slot compared
    (XShape by shape), in its dtype's values."""
    jins = {s: [None if a is None else jnp.asarray(a)] for s, a in ins.items()}
    tins = {s: [None if a is None else _torch(a)] for s, a in ins.items()}
    jout = JOPS.get(op_type).kernel(
        jins, dict(JOPS.get(op_type).attr_defaults, **attrs))
    tout = TOPS.get(op_type).kernel(
        tins, dict(TOPS.get(op_type).attr_defaults, **attrs))
    assert set(jout) == set(tout), (set(jout), set(tout))
    for slot in jout:
        j, t = np.asarray(jout[slot][0]), tout[slot][0]
        assert tuple(t.shape) == j.shape, (slot, tuple(t.shape), j.shape)
        if slot == "XShape":
            continue
        if j.dtype == BF16:
            assert t.dtype == torch.bfloat16, slot
        j = j.astype(np.float64) if j.dtype != np.bool_ else j
        got = _host(t).astype(np.float64) if j.dtype != np.bool_ \
            else _host(t)
        if bitwise:
            np.testing.assert_array_equal(got, j, err_msg=slot)
        else:
            np.testing.assert_allclose(got, j, rtol=tol, atol=tol,
                                       err_msg=slot)
    return tout


def _grad_both(op_type, ins, attrs, tol=TOL):
    """Both packages' generic grad of ``op_type`` on f32 numpy ``ins``,
    with seeded output grads for every float output."""
    tattrs = dict(TOPS.get(op_type).attr_defaults, **attrs)
    jattrs = dict(JOPS.get(op_type).attr_defaults, **attrs)
    tins = {s: [None if a is None else torch.from_numpy(np.asarray(a))]
            for s, a in ins.items()}
    jins = {s: [None if a is None else jnp.asarray(a)]
            for s, a in ins.items()}
    fwd = TOPS.get(op_type).kernel(tins, tattrs)
    r = _r(99)
    for slot, vals in fwd.items():
        if vals[0].is_floating_point():
            g = r.normal(size=tuple(vals[0].shape)).astype(np.float32)
            tins[slot + "@GRAD"] = [torch.from_numpy(g)]
            jins[slot + "@GRAD"] = [jnp.asarray(g)]
    slots = list(ins)
    wanted = [s + "@GRAD" for s in slots]
    tg = t_generic_grad(op_type, tins, tattrs, wanted, slots)
    jg = j_generic_grad(op_type, jins, jattrs, wanted, slots)
    assert set(tg) == set(jg), (set(tg), set(jg))
    for slot in jg:
        for t, j in zip(tg[slot], jg[slot]):
            assert (t is None) == (j is None), slot
            if j is not None:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=tol, atol=tol, err_msg=slot)


# ----------------------------------------------------------------- ops
@pytest.mark.parametrize("dtype", [np.float32, BF16])
@pytest.mark.parametrize("shape,alpha,beta", [((2, 80, 64), 1.0, 1.0),
                                              ((3, 7, 12), 0.5, 2.0)])
def test_add_position_encoding(dtype, shape, alpha, beta):
    """bf16: bitwise (positions, divisors and scalars in bf16, as the
    reference builds them)."""
    x = _r(0).normal(size=shape).astype(dtype)
    _run("add_position_encoding", {"X": x}, {"alpha": alpha, "beta": beta},
         bitwise=dtype is BF16)


@pytest.mark.parametrize("op", ["one_hot", "one_hot_v2"])
def test_one_hot(op):
    """ids out of [0, depth) give a zero row, as jax.nn.one_hot."""
    ids = _r(1).randint(-1, 18, (3, 5, 1)).astype(np.int64)
    if op == "one_hot_v2":
        ids = ids[..., 0]
    out = _run(op, {"X": ids}, {"depth": 16}, bitwise=True)["Out"][0]
    assert out.dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.float32, BF16])
@pytest.mark.parametrize("prior", [False, True])
def test_label_smooth(dtype, prior):
    r = _r(2)
    x = np.eye(16, dtype=np.float32)[r.randint(0, 16, (3, 5))].astype(dtype)
    ins = {"X": x}
    if prior:
        p = r.uniform(size=16).astype(np.float32)
        ins["PriorDist"] = (p / p.sum()).astype(dtype)
    _run("label_smooth", ins, {"epsilon": 0.1}, bitwise=dtype is BF16)


@pytest.mark.parametrize("op", ["squeeze", "squeeze2"])
@pytest.mark.parametrize("axes", [[1], [1, -1], [], [0]])
def test_squeeze(op, axes):
    """axes whose dim is not 1 stay; no axes squeeze every 1."""
    _run(op, {"X": _r(3).normal(size=(2, 1, 3, 1)).astype(np.float32)},
         {"axes": axes})


REDUCE_ATTRS = [{"dim": [1]}, {"dim": [0, 2], "keep_dim": True},
                {"reduce_all": True}, {"dim": [-1]},
                {"dim": [], "keep_dim": True}]


@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean", "reduce_max",
                                "reduce_min", "reduce_prod"])
@pytest.mark.parametrize("attrs", REDUCE_ATTRS)
def test_reduce(op, attrs):
    _run(op, {"X": _r(4).normal(size=(3, 4, 5)).astype(np.float32)}, attrs)


@pytest.mark.parametrize("op", ["reduce_all", "reduce_any"])
@pytest.mark.parametrize("attrs", REDUCE_ATTRS)
def test_reduce_bool(op, attrs):
    _run(op, {"X": _r(5).normal(size=(3, 4, 5)) > 0.8}, attrs,
         bitwise=True)


@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean", "reduce_max",
                                "reduce_prod"])
@pytest.mark.parametrize("attrs", REDUCE_ATTRS[:3])
def test_reduce_grad(op, attrs):
    _grad_both(op, {"X": _r(6).normal(size=(3, 4, 5)).astype(np.float32)},
               attrs)


@pytest.mark.parametrize("dtype,step", [(np.int64, 1.0), (np.float32, 0.1),
                                        (BF16, 0.1)])
def test_increment(dtype, step):
    x = np.array([3], dtype=dtype)
    out = _run("increment", {"X": x}, {"step": step}, bitwise=True)
    assert out["Out"][0].dtype == _torch(x).dtype


@pytest.mark.parametrize("op", ["elementwise_pow", "elementwise_min",
                                "elementwise_max"])
@pytest.mark.parametrize("yshape,axis", [((3, 4, 5), -1), ((5,), -1),
                                         ((4,), 1), ((1,), -1)])
def test_elementwise_extra(op, yshape, axis):
    r = _r(7)
    ins = {"X": np.abs(r.normal(size=(3, 4, 5))).astype(np.float32) + 0.1,
           "Y": r.normal(size=yshape).astype(np.float32)}
    _run(op, ins, {"axis": axis})
    _grad_both(op, ins, {"axis": axis})


@pytest.mark.parametrize("op", ["less_than", "less_equal", "greater_than",
                                "greater_equal"])
def test_compare(op):
    r = _r(8)
    x = r.randint(0, 4, (3, 5)).astype(np.float32)
    _run(op, {"X": x, "Y": r.randint(0, 4, (5,)).astype(np.float32)}, {},
         bitwise=True)


@pytest.mark.parametrize("op", ["label_smooth", "add_position_encoding",
                                "squeeze2"])
def test_new_op_grads(op):
    r = _r(9)
    x = {"label_smooth": r.uniform(size=(3, 5, 16)),
         "add_position_encoding": r.normal(size=(2, 6, 8)),
         "squeeze2": r.normal(size=(2, 1, 3))}[op].astype(np.float32)
    attrs = {"label_smooth": {"epsilon": 0.1},
             "add_position_encoding": {"alpha": 0.5, "beta": 1.0},
             "squeeze2": {"axes": [1]}}[op]
    _grad_both(op, {"X": x}, attrs)


# ---------------------------------------------------- Variable operators
OPERATOR_CASES = {
    "x + 1": lambda x: x + 1,
    "1 - x": lambda x: 1 - x,
    "x * c": lambda x: x * 2.5,
    "c * x": lambda x: 2.5 * x,
    "x / c": lambda x: x / 4.0,
    "c / x": lambda x: 3.0 / x,
    "x ** -0.5": lambda x: x ** -0.5,
    "-x": lambda x: -x,
    "x - y": lambda x: x - x * 0.5,
    "x < c": lambda x: x < 1.0,
    "x >= c": lambda x: x >= 1.0,
}


def _operator_program(fluid, expr):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[4], dtype="float32")
        y = OPERATOR_CASES[expr](x)
    return main, startup, y


@pytest.mark.parametrize("expr", sorted(OPERATOR_CASES))
def test_variable_operators(expr):
    """The same op list (types, slots, public attrs) and the same values
    as the reference's operators."""
    jm, _, jy = _operator_program(jfluid, expr)
    tm, _, ty = _operator_program(tfluid, expr)
    assert _canonical(tm) == _canonical(jm)
    assert tuple(ty.shape) == tuple(jy.shape) and ty.dtype == jy.dtype
    x = np.abs(_r(10).normal(size=(3, 4))).astype(np.float32) + 0.5
    j = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed={"x": x}, fetch_list=[jy], scope=jfluid.Scope())[0]
    t = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed={"x": x}, fetch_list=[ty], scope=tfluid.Scope())[0]
    np.testing.assert_allclose(np.asarray(t, np.float64),
                               np.asarray(j, np.float64), rtol=TOL,
                               atol=TOL)


# ------------------------------------------------------------ programs
CFG = dict(src_vocab=64, trg_vocab=64, d_model=32, d_inner=64, heads=4,
           enc_layers=1, dec_layers=1, max_len=256, dropout=0.0,
           label_smooth=0.1)


def _canonical(program):
    """Ops as (type, slots, public attrs) with non-persistable, non-data
    var names replaced by their order of first appearance."""
    block = program.global_block()
    ids = {}

    def name(n):
        v = block.vars.get(n)
        if v is not None and (v.persistable or v.is_data):
            return n
        return ids.setdefault(n, f"t{len(ids)}")

    ops = [(op.type,
            {s: [name(n) for n in ns] for s, ns in op.inputs.items()},
            {s: [name(n) for n in ns] for s, ns in op.outputs.items()},
            {k: v for k, v in op.attrs.items() if not k.startswith("_")})
           for op in block.ops]
    persist = {v.name: (tuple(v.shape), v.dtype) for v in
               block.vars.values() if v.persistable or v.is_data}
    return ops, persist


def _train_program(fluid, tr, lr=None, **cfg):
    with fluid.unique_name.guard():
        return tr.build_wmt_train_program(dict(CFG, **cfg), src_len=S,
                                          trg_len=S, lr=lr)


def _decode_program(fluid, tr, max_out=6):
    with fluid.unique_name.guard():
        return tr.build_greedy_decode_program(dict(CFG), src_len=S,
                                              max_out_len=max_out)


@pytest.mark.parametrize("which", ["train_noam", "train_lr", "decode",
                                   "train_big_depth"])
def test_program_matches_reference(which):
    """The port's program functions emit the TPU package's ops, slots,
    public attrs and persistables (the Noam counter's increment first)."""
    build = {
        "train_noam": lambda f, m: _train_program(f, m)[0],
        "train_lr": lambda f, m: _train_program(f, m, lr=1e-3)[0],
        "decode": lambda f, m: _decode_program(f, m)[0],
        "train_big_depth": lambda f, m: _train_program(
            f, m, enc_layers=6, dec_layers=6, dropout=0.3)[0]}[which]
    tm, jm = build(tfluid, ttr), build(jfluid, jtr)
    assert _canonical(tm) == _canonical(jm)
    types = [op.type for op in tm.global_block().ops]
    assert (types[0] == "increment") == (which != "train_lr" and
                                         which != "decode")
    if which == "train_big_depth":
        assert types.count("fused_attention_qkv") == 18
        assert sum(t == "dropout" for t in types) == 42


def _feed(seed, bs=B, n=S, vocab=64):
    r = _r(seed)
    smask = np.ones((bs, n), np.float32)
    smask[1, n - 2:] = 0.0
    tmask = np.ones((bs, n), np.float32)
    tmask[0, n - 3:] = 0.0
    return {"src_ids": r.randint(0, vocab, (bs, n)).astype(np.int64),
            "src_mask": smask,
            "trg_ids": r.randint(0, vocab, (bs, n)).astype(np.int64),
            "trg_mask": tmask,
            "labels": r.randint(0, vocab, (bs, n, 1)).astype(np.int64)}


def _from_jax_startup(jm, js, tm, ts):
    """Both packages' scopes after the TPU package's startup parameters
    (the Noam counter starts at 0 in both)."""
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
              for v in jm.global_block().vars.values()
              if v.persistable and not v.name.startswith("@")}
    tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    texe.run(ts, scope=tscope)
    set_params_from_numpy(tscope, arrays)
    return (jexe, jscope), (texe, tscope), arrays


def _lr_var(program):
    return [op for op in program.global_block().ops
            if op.type == "adam"][0].input("LearningRate")[0]


# ------------------------------------------------------------ training
def test_four_adam_steps_match_jax():
    """4 Adam steps with Noam decay from the same parameters: the losses,
    the LR and every parameter at the golden trajectories' tolerance."""
    jm, js, _, jloss = _train_program(jfluid, jtr)
    tm, ts, _, tloss = _train_program(tfluid, ttr)
    (jexe, jscope), (texe, tscope), arrays = _from_jax_startup(jm, js, tm,
                                                               ts)
    feed = _feed(11)
    jl, tl = [], []
    for step in range(4):
        jl.append(jexe.run(jm, feed=feed, fetch_list=[jloss, _lr_var(jm)],
                           scope=jscope))
        tl.append(texe.run(tm, feed=feed, fetch_list=[tloss, _lr_var(tm)],
                           scope=tscope))
        assert texe._last_run_mode == "compiled"
    np.testing.assert_allclose([float(t[0][0]) for t in tl],
                               [float(j[0][0]) for j in jl],
                               rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
    np.testing.assert_allclose([float(t[1][0]) for t in tl],
                               [float(j[1][0]) for j in jl], rtol=LR_RTOL)
    for name in arrays:
        np.testing.assert_allclose(
            tscope.find_var(name).value().array.numpy(),
            np.asarray(jscope.find_var(name).get_tensor()),
            rtol=TRAJ_RTOL, atol=TRAJ_ATOL, err_msg=name)


@pytest.mark.parametrize("mode", ["single", "window"])
def test_noam_lr_matches_reference(mode):
    """The LR of 5 steps: 5 single runs, or one window of 5 (the counter
    advances once a step inside ``Executor.run(n_steps=5)``), against the
    reference's 5 single runs and Noam's formula."""
    jm, js, _, jloss = _train_program(jfluid, jtr)
    tm, ts, _, tloss = _train_program(tfluid, ttr)
    (jexe, jscope), (texe, tscope), _ = _from_jax_startup(jm, js, tm, ts)
    feed = _feed(12)
    want = [float(jexe.run(jm, feed=feed, fetch_list=[_lr_var(jm)],
                           scope=jscope)[0][0]) for _ in range(5)]
    if mode == "single":
        got = [float(texe.run(tm, feed=feed, fetch_list=[_lr_var(tm)],
                              scope=tscope)[0][0]) for _ in range(5)]
    else:
        out, = texe.run(tm, feed=feed, fetch_list=[_lr_var(tm)],
                        scope=tscope, n_steps=5)
        assert out.shape == (5, 1) and texe._last_run_mode == "compiled"
        got = [float(v) for v in out.ravel()]
    np.testing.assert_allclose(got, want, rtol=LR_RTOL)
    noam = [CFG["d_model"] ** -0.5 * min(t ** -0.5, t * 4000 ** -1.5)
            for t in range(1, 6)]
    np.testing.assert_allclose(got, noam, rtol=LR_RTOL)
    counter = tscope.find_var("@LR_DECAY_COUNTER@").value().array
    assert counter.dtype == torch.int64 and counter.tolist() == [5]


def test_cross_entropy_soft_label_matches_reference_on_program_shapes():
    """cross_entropy's soft-label form on the program's [B, S, V]
    probabilities and smoothed one-hot labels."""
    r = _r(13)
    logits = r.normal(size=(B, S, 64)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    label = 0.9 * np.eye(64, dtype=np.float32)[r.randint(0, 64, (B, S))] \
        + 0.1 / 64
    out = _run("cross_entropy", {"X": probs.astype(np.float32),
                                 "Label": label.astype(np.float32)},
               {"soft_label": True})
    assert tuple(out["Y"][0].shape) == (B, S, 1)
    _grad_both("cross_entropy", {"X": probs.astype(np.float32),
                                 "Label": label.astype(np.float32)},
               {"soft_label": True})


# -------------------------------------------------------------- decode
def _greedy(run, src, smask, max_out):
    """Greedy decode: ``run(feed) -> logits``, each argmax written into
    the fed target array in place. → (tokens, each step's logits)."""
    trg = np.zeros((src.shape[0], max_out), np.int64)  # BOS = 0
    steps = []
    for pos in range(max_out - 1):
        out = run({"src_ids": src, "src_mask": smask, "trg_ids": trg})
        steps.append((trg.copy(), out))
        trg[:, pos + 1] = out[:, pos].argmax(-1)
    return trg, steps


def test_greedy_decode_logits_match_reference():
    """At each decode step, the port's logits on its own prefix against
    the reference's on the same prefix (teacher forcing: a flipped argmax
    cannot make the two runs part)."""
    max_out = 6
    jm, js, _, jlog = _decode_program(jfluid, jtr, max_out)
    tm, ts, _, tlog = _decode_program(tfluid, ttr, max_out)
    (jexe, jscope), (texe, tscope), _ = _from_jax_startup(jm, js, tm, ts)
    r = _r(14)
    src = r.randint(0, 64, (B, S)).astype(np.int64)
    smask = _feed(14)["src_mask"]
    tokens, steps = _greedy(
        lambda f: texe.run(tm, feed=f, fetch_list=[tlog], scope=tscope)[0],
        src, smask, max_out)
    assert texe._last_run_mode == "compiled"
    for pos, (trg, got) in enumerate(steps):
        want = jexe.run(jm, feed={"src_ids": src, "src_mask": smask,
                                  "trg_ids": trg}, fetch_list=[jlog],
                        scope=jscope)[0]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=TOL,
                                   err_msg=f"decode step {pos}")
    assert tokens.shape == (B, max_out) and (tokens[:, 1:] != 0).any()


def test_decode_refeeds_an_array_mutated_in_place():
    """The greedy loop feeds ONE target array, written in place between
    runs: with the feed cache on, each run uploads it again (its CRC
    changed) and its logits equal those of a fresh copy."""
    tm, ts, _, tlog = _decode_program(tfluid, ttr)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    tcore.set_flag("FLAGS_feed_device_cache", True)
    src = _r(15).randint(0, 64, (B, S)).astype(np.int64)
    smask = np.ones((B, S), np.float32)
    trg = np.zeros((B, 6), np.int64)
    feed = {"src_ids": src, "src_mask": smask, "trg_ids": trg}
    first = exe.run(tm, feed=feed, fetch_list=[tlog], scope=scope)[0]
    stats = dict(exe.feed_stats)
    trg[:, 1:] = 7
    again = exe.run(tm, feed=feed, fetch_list=[tlog], scope=scope)[0]
    assert exe.feed_stats["uploads"] == stats["uploads"] + 1
    assert exe.feed_stats["cache_hits"] == stats["cache_hits"] + 2
    fresh = exe.run(tm, feed=dict(feed, trg_ids=trg.copy()),
                    fetch_list=[tlog], scope=scope)[0]
    np.testing.assert_array_equal(again, fresh)
    assert not np.array_equal(again[:, 1:], first[:, 1:])


# ------------------------------------------------- compiled vs interpreted
def _run_modes(build, feeds):
    got = {}
    try:
        for mode in ("compiled", "interpreted"):
            tcore.set_flag("FLAGS_executor_mode", mode)
            main, startup, fetches = build()
            main.random_seed = startup.random_seed = 5
            exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
            exe.run(startup, scope=scope)
            outs = [exe.run(main, feed=f, fetch_list=fetches, scope=scope)
                    for f in feeds]
            assert exe._last_run_mode == mode
            params = {v.name: scope.find_var(v.name).value().array.clone()
                      for v in main.global_block().vars.values()
                      if v.persistable}
            got[mode] = (outs, params)
    finally:
        tcore.set_flag("FLAGS_executor_mode", "compiled")
    return got


@pytest.mark.parametrize("which", ["train", "decode"])
def test_compiled_matches_interpreted_bitwise(which):
    """Training (dropout 0.1: the same masks, Noam) and decode, compiled
    against the interpreter: fetches and persistables bitwise."""
    if which == "train":
        def build():
            m, s, _, loss = _train_program(tfluid, ttr, dropout=0.1)
            return m, s, [loss, _lr_var(m)]
        feeds = [_feed(16 + i) for i in range(3)]
    else:
        def build():
            m, s, _, logits = _decode_program(tfluid, ttr)
            return m, s, [logits]
        f = _feed(19)
        feeds = [{"src_ids": f["src_ids"], "src_mask": f["src_mask"],
                  "trg_ids": f["trg_ids"][:, :6]}] * 2
    got = _run_modes(build, feeds)
    (c_out, c_par), (i_out, i_par) = got["compiled"], got["interpreted"]
    for a, b in zip(c_out, i_out):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert c_par.keys() == i_par.keys()
    for n in c_par:
        assert torch.equal(c_par[n], i_par[n]), n


# --------------------------------------------------------------- bench
def test_bench_transformer_lane_on_the_cpu():
    """``python -m paddle_tpu_torch.bench transformer --device cpu``: one
    JSON line in bench.py's form, at bench.py's CPU setting."""
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.bench", "transformer",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["metric"] == "fleet_dp_step_ms_transformer_big"
    assert res["unit"] == "ms/step" and res["devices"] == 1
    assert res["batch"] == 2 and res["seq_len"] == 16 and res["steps"] == 10
    assert res["value"] == res["step_ms"] > 0
    assert np.isfinite(res["loss"]) and res["samples_per_sec"] > 0
    assert res["executor_mode"] == "compiled"


def test_transformer_flops_count():
    """The lane's FLOP count, by hand at one encoder and one decoder
    layer."""
    from paddle_tpu_torch.bench import transformer_flops_per_step
    d, f, v, b, s = 8, 16, 10, 2, 3
    cfg = dict(d_model=d, d_inner=f, trg_vocab=v, enc_layers=1,
               dec_layers=1)
    t = b * s
    mac = (4 * d * d * t + 2 * d * f * t                    # encoder GEMMs
           + 4 * d * d * t + 4 * d * d * t + 2 * d * f * t  # decoder GEMMs
           + d * v * t)                                      # logits
    attn = 3 * 4 * b * s * s * d   # QKᵀ and PV, 2 FLOP each: 4·B·S·Sk·d
    assert transformer_flops_per_step(cfg, b, s, s) == 3 * (2 * mac + attn)


# ------------------------------------------------- chip_smoke's gates
@pytest.mark.parametrize("which", ["train", "decode", "lane"])
def test_chip_smoke_transformer_gates(which):
    """The launch tuples chip_smoke.py holds the card's transformer runs to
    follow from the programs (at any width): the bf16 step at 6 + 6 layers
    with dropout 0.3 on the fused route, a decode run on the f32 forward
    (f32 at D = 64: the f32 route), the bench lane's 2 + 2 layers at
    dropout 0."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    big = dict(enc_layers=6, dec_layers=6, dropout=0.3)
    if which == "train":
        ops = _train_program(tfluid, ttr, **big)[0].global_block().ops
        assert chip_smoke._step_want(ops, "fused") == \
            chip_smoke.WMT_STEP_WANT
    elif which == "lane":
        ops = _train_program(tfluid, ttr, enc_layers=2,
                             dec_layers=2)[0].global_block().ops
        assert chip_smoke._step_want(ops, "fused") == \
            chip_smoke.WMT_LANE_WANT
    else:
        with tfluid.unique_name.guard():
            main = ttr.build_greedy_decode_program(
                dict(CFG, enc_layers=6, dec_layers=6), src_len=S,
                max_out_len=6)[0]
        n = sum(op.type == "fused_attention_qkv"
                for op in main.global_block().ops)
        assert chip_smoke._attention_route(main) == "f32"
        assert tuple(n if k == "flash_attention_fwd_f32" else 0
                     for k in chip_smoke.KERNELS) == \
            chip_smoke.WMT_DECODE_WANT
