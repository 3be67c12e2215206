"""contrib.mixed_precision of paddle_tpu_torch against the TPU package's,
on the same programs and the same numpy inputs and parameters:

- the ops AMP uses (cast and its grad, elementwise_mul/div, isfinite)
  against the TPU package's kernels at 1e-6 (one rounding each);
- ``_insert_casts`` and ``minimize`` give the same op sequence and the
  same var dtypes for the reference's MLP (tests/test_quant_amp.py:64)
  and a small BERT (3 layers, hidden 64, 4 heads, ffn 128, S = 16, batch
  2, dropout 0); after one interpreted step every var holds the same
  runtime dtype in both packages (so the attention takes f32 Q/K/V: a
  bf16 product plus an f32 bias is f32 under both promotion rules);
- the bf16 MLP trains (tests/test_quant_amp.py:64);
- small BERT with ``use_amp=True``: 3 Adam steps against the TPU package
  from its startup parameters within 2e-2 relative (bf16 products; the
  largest difference measured on the CPU is 1.8e-3), compiled against
  interpreted bitwise;
- dynamic loss scaling with an overflow at step 2: the scale trajectory
  [8, 16, 8, 8, 16, 16], equal to the TPU package's, a NaN loss at the
  bad step only, compiled against interpreted bitwise with an empty white
  list (tests/test_quant_amp.py:144-175); raise mode replays from the
  pre-step scale (:179); the scale floors at 1 (:229); static scaling
  (:240); the split backward/apply_optimize path unscales (:287).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad
from tests.test_torch_models_a7 import _to_jax_scope

CFG = dict(vocab_size=128, hidden=64, layers=3, heads=4, ffn=128,
           max_len=16, type_vocab=2)
S, B, N_MASK = 16, 2, 5
AMP_LOSS_RTOL = 2e-2


@pytest.fixture
def mode():
    """Set FLAGS_executor_mode of both packages; restore it after."""
    saved = (tcore.globals_["FLAGS_executor_mode"],
             jcore.globals_["FLAGS_executor_mode"])

    def set_(m):
        tcore.set_flag("FLAGS_executor_mode", m)
        jcore.set_flag("FLAGS_executor_mode", m)
    yield set_
    tcore.set_flag("FLAGS_executor_mode", saved[0])
    jcore.set_flag("FLAGS_executor_mode", saved[1])


# ----------------------------------------------------------------- ops
def _torch(a):
    """numpy → torch; a bf16 (ml_dtypes) array through f32, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _kernels(op_type, ins, attrs):
    jins = {s: [jnp.asarray(a)] for s, a in ins.items()}
    tins = {s: [_torch(a)] for s, a in ins.items()}
    j = JOPS.get(op_type).kernel(jins, dict(JOPS.get(op_type).attr_defaults,
                                            **attrs))
    t = TOPS.get(op_type).kernel(tins, dict(TOPS.get(op_type).attr_defaults,
                                            **attrs))
    return np.asarray(j["Out"][0]), t["Out"][0]


@pytest.mark.parametrize("op_type,yshape", [
    ("elementwise_mul", (1,)), ("elementwise_mul", (3, 5)),
    ("elementwise_div", (1,)), ("elementwise_div", (5,))])
def test_elementwise_mul_div_match_jax(op_type, yshape):
    r = np.random.RandomState(0)
    x = r.normal(size=(3, 5)).astype(np.float32)
    y = (r.rand(*yshape) + 0.5).astype(np.float32)
    j, t = _kernels(op_type, {"X": x, "Y": y}, {"axis": -1})
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", [None, np.nan, np.inf])
def test_isfinite_matches_jax(bad):
    x = np.random.RandomState(1).normal(size=(4, 6)).astype(np.float32)
    if bad is not None:
        x[2, 3] = bad
    j, t = _kernels("isfinite", {"X": x}, {})
    assert t.dtype == torch.bool and tuple(t.shape) == j.shape == (1,)
    assert bool(t[0]) == bool(j[0]) == (bad is None)


@pytest.mark.parametrize("out_dtype", [tcore.VarDesc.VarType.BF16,
                                       tcore.VarDesc.VarType.FP32])
def test_cast_and_its_grad_match_jax(out_dtype):
    """cast f32→bf16 and back, and the generic grad (the cast back to
    X's dtype) of each against jax.vjp."""
    r = np.random.RandomState(2)
    x = r.normal(size=(4, 8)).astype(np.float32) * 3
    src = x if out_dtype == tcore.VarDesc.VarType.BF16 else \
        np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    in_dtype = 5 if out_dtype == tcore.VarDesc.VarType.BF16 else 22
    attrs = {"in_dtype": in_dtype, "out_dtype": out_dtype}
    j, t = _kernels("cast", {"X": src}, attrs)
    assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))
    g = r.normal(size=(4, 8)).astype(np.float32)
    jg_in = jnp.asarray(g).astype(j.dtype)
    tg_in = torch.from_numpy(g).to(t.dtype)
    tins = {"X": [_torch(src)], "Out": [t],
            "Out@GRAD": [tg_in]}
    jins = {"X": [jnp.asarray(src)], "Out": [jnp.asarray(j)],
            "Out@GRAD": [jg_in]}
    tg = t_generic_grad("cast", tins, attrs, ["X@GRAD"], ["X"])["X@GRAD"][0]
    jgrad = j_generic_grad("cast", jins, attrs, ["X@GRAD"],
                           ["X"])["X@GRAD"][0]
    assert str(tg.dtype).replace("torch.", "") == str(jgrad.dtype)
    np.testing.assert_array_equal(tg.float().numpy(),
                                  np.asarray(jgrad).astype(np.float32))


# ---------------------------------------------------------- programs
def _mlp(fluid, decorate_kw=None, optimizer=None, seed=None):
    """The reference's AMP MLP: fc relu 16, fc softmax 4, cross-entropy."""
    from importlib import import_module
    mp = import_module(fluid.__name__ + ".contrib.mixed_precision")
    main, startup = fluid.Program(), fluid.Program()
    if seed is not None:
        main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.data("x", shape=[8], dtype="float32")
        y = fluid.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(h, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        opt = optimizer(fluid) if optimizer else fluid.optimizer.Adam(0.05)
        if decorate_kw is not None:
            kw = dict(decorate_kw)
            white = kw.pop("white_list", None)
            if white is not None:
                lists = mp.AutoMixedPrecisionLists()
                lists.white_list = set(white)
                kw["amp_lists"] = lists
            opt = mp.decorate(opt, **kw)
        opt.minimize(loss)
    return main, startup, loss, opt


def _bert(fluid, bert):
    with fluid.unique_name.guard():
        main, startup, _, fetches = bert.build_bert_pretrain_program(
            CFG, seq_len=S, dropout=0.0, lr=1e-3, use_amp=True)
    startup.random_seed = 5
    return main, startup, fetches


def _bert_feed(step):
    r = np.random.RandomState(step)
    return {"src_ids": r.randint(0, CFG["vocab_size"], (B, S)),
            "pos_ids": np.tile(np.arange(S), (B, 1)),
            "sent_ids": r.randint(0, CFG["type_vocab"], (B, S)),
            "mask_pos": r.randint(0, B * S, (N_MASK, 1)),
            "mask_label": r.randint(0, CFG["vocab_size"], (N_MASK, 1))}


def _typed_ops(program):
    """(type, {slot: dtypes of its vars}) for inputs and outputs of each op
    of the global block, temp names left out (counters differ)."""
    block = program.global_block()

    def dts(slots):
        return {s: [block.vars[n].dtype if n in block.vars else None
                    for n in ns] for s, ns in slots.items()}
    return [(op.type, dts(op.inputs), dts(op.outputs)) for op in block.ops]


@pytest.mark.parametrize("model", ["mlp", "bert"])
def test_amp_programs_are_identical(model):
    if model == "mlp":
        jm = _mlp(jfluid, {})[0]
        tm = _mlp(tfluid, {})[0]
    else:
        jm = _bert(jfluid, jbert)[0]
        tm = _bert(tfluid, tbert)[0]
    jt, tt = _typed_ops(jm), _typed_ops(tm)
    assert [t for t, _, _ in tt] == [t for t, _, _ in jt]
    assert tt == jt
    n_cast = sum(t == "cast" for t, _, _ in tt)
    n_mul = sum(t == "mul" for t, _, _ in tt)
    assert n_cast and n_mul and n_cast <= 2 * n_mul
    # every .cast_bf16 var is bf16; the weights' copies have the same
    # names in both (temp-name counters differ between the packages' runs)
    jc = [n for n in jm.global_block().vars if ".cast_bf16" in n]
    tc = [n for n in tm.global_block().vars if ".cast_bf16" in n]
    assert len(tc) == len(jc) and all(
        tm.global_block().vars[n].dtype == tcore.VarDesc.VarType.BF16
        for n in tc)
    assert sorted(n for n in tc if ".w_" in n) == \
        sorted(n for n in jc if ".w_" in n) != []


def test_amp_runtime_dtypes_match_jax(mode):
    """One interpreted step of the small AMP BERT in both packages: every
    var written in the scope has the same dtype in both — in particular
    the attention's Q/K/V are f32 (the bias add promotes the bf16 mul
    output), so the f32 kernel instances run."""
    mode("interpreted")
    jm, js, jf = _bert(jfluid, jbert)
    tm, ts, tf = _bert(tfluid, tbert)
    tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    texe.run(ts, scope=tscope)
    # the TPU package starts from the port's startup values
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    _to_jax_scope(tscope, [v.name for v in jm.global_block().vars.values()
                           if v.persistable], jscope)
    feed = _bert_feed(0)
    jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)
    texe.run(tm, feed=feed, fetch_list=tf, scope=tscope)
    seen = 0
    # ops paired by position (temp-name counters differ between the
    # packages' runs; the op sequences are equal: test above)
    for op, jop in zip(tm.global_block().ops, jm.global_block().ops):
        assert op.type == jop.type
        for n, jn in zip(op.output_arg_names, jop.output_arg_names):
            tv, jv = tscope.find_var(n), jscope.find_var(jn)
            if tv is None or not tv.is_initialized() or jv is None:
                continue
            jdt = str(np.asarray(jv.get_tensor()).dtype)
            tdt = str(tv.value().array.dtype).replace("torch.", "")
            # the TPU package keeps integers 32-bit on the device
            if jdt in ("int32", "int64") and tdt in ("int32", "int64"):
                continue
            assert tdt == jdt, (op.type, n, jn, tdt, jdt)
            seen += 1
    assert seen > 100
    attn = [op for op in tm.global_block().ops
            if op.type == "fused_attention_qkv"]
    assert len(attn) == CFG["layers"]
    for op in attn:
        for slot in ("Q", "K", "V"):
            n = op.input(slot)[0]
            assert tscope.find_var(n).value().array.dtype == torch.float32


def test_amp_decorate_trains_bf16():
    main, startup, loss, _ = _mlp(tfluid, {})
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)
    X = rng.rand(16, 8).astype("float32")
    Y = rng.randint(0, 4, (16, 1)).astype("int64")
    losses = [float(exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(15)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_amp_bert_matches_jax_and_compiled_matches_interpreted(mode):
    jm, js, jf = _bert(jfluid, jbert)
    # one start for all: the port's startup values, put on the TPU
    # package's CPU device (``_to_jax_scope``: its step compiles once)
    tm, ts, tf = _bert(tfluid, tbert)
    tscope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(ts, scope=tscope)
    names = [v.name for v in jm.global_block().vars.values() if v.persistable]
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    _to_jax_scope(tscope, names, jscope)
    arrays = {n: tscope.find_var(n).value().numpy() for n in names
              if tscope.find_var(n) is not None}
    jl = [float(jexe.run(jm, feed=_bert_feed(i), fetch_list=jf,
                         scope=jscope)[0][0]) for i in range(3)]
    got = {}
    for m in ("compiled", "interpreted"):
        mode(m)
        tm, ts, tf = _bert(tfluid, tbert)
        tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        texe.run(ts, scope=tscope)
        set_params_from_numpy(tscope, arrays)
        losses = [texe.run(tm, feed=_bert_feed(i), fetch_list=tf,
                           scope=tscope)[0] for i in range(3)]
        assert texe._last_run_mode == m
        params = [tscope.find_var(p.name).value().array.clone()
                  for p in tm.all_parameters()]
        got[m] = (np.concatenate(losses), params)
    np.testing.assert_array_equal(got["compiled"][0], got["interpreted"][0])
    for a, b in zip(got["compiled"][1], got["interpreted"][1]):
        assert torch.equal(a, b)
    tl = got["compiled"][0]
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=AMP_LOSS_RTOL)


# ------------------------------------------------------- loss scaling
def _dyn_run(fluid, core, run_mode, inject_at=(2,), steps=6, white_list=None,
             incr_every=2, decr_every=1):
    """(losses, scales) of the reference's dynamic-scaling MLP (SGD 0.1,
    scale 8, x2 every 2 clean steps, x0.5 every bad one) with x[0, 0] = inf
    at the steps in ``inject_at``."""
    saved = core.globals_["FLAGS_executor_mode"]
    core.set_flag("FLAGS_executor_mode", run_mode)
    try:
        kw = dict(init_loss_scaling=8.0, incr_every_n_steps=incr_every,
                  decr_every_n_nan_or_inf=decr_every, incr_ratio=2.0,
                  decr_ratio=0.5, use_fp16=True)
        if white_list is not None:
            kw["white_list"] = white_list
        main, startup, loss, opt = _mlp(
            fluid, kw, optimizer=lambda f: f.optimizer.SGD(0.1), seed=3)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(0)
        X = rng.rand(16, 8).astype("float32")
        Y = rng.randint(0, 4, (16, 1)).astype("int64")
        Xbad = X.copy()
        Xbad[0, 0] = np.inf
        losses, scales = [], []
        for i in range(steps):
            (lv,) = exe.run(main, feed={"x": Xbad if i in inject_at else X,
                                        "y": Y},
                            fetch_list=[loss], scope=scope)
            losses.append(np.asarray(lv).item())
            scales.append(np.asarray(scope.find_var(
                opt._loss_scaling_var.name).get_tensor()).item())
        assert exe._last_run_mode == run_mode
        return losses, scales
    finally:
        core.set_flag("FLAGS_executor_mode", saved)


def test_amp_dynamic_scaling_halves_and_regrows_as_jax():
    losses, scales = _dyn_run(tfluid, tcore, "compiled")
    # steps:   0      1     2(bad)  3     4      5
    # scale:  8->8  8->16  16->8   8->8  8->16  16->16
    assert scales == [8.0, 16.0, 8.0, 8.0, 16.0, 16.0]
    assert np.isnan(losses[2])
    assert np.isfinite(losses[:2] + losses[3:]).all()
    _, jscales = _dyn_run(jfluid, jcore, "compiled")
    assert scales == jscales


def test_amp_dynamic_scaling_compiled_matches_interpreted_bitwise():
    lc, sc = _dyn_run(tfluid, tcore, "compiled", white_list=())
    li, si = _dyn_run(tfluid, tcore, "interpreted", white_list=())
    assert sc == si == [8.0, 16.0, 8.0, 8.0, 16.0, 16.0]
    assert np.array_equal(np.asarray(lc), np.asarray(li), equal_nan=True)


def test_amp_raise_replay_sees_pre_step_scale():
    """raise mode: the overflow comes from the scale itself (grad_w =
    scale·x overflows f32 at scale 4, not at 2); the replay must run at the
    pre-step scale, name the op, and leave the weight as it was."""
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        AutoMixedPrecisionLists, decorate)
    saved = {k: tcore.globals_[k] for k in
             ("FLAGS_check_nan_inf", "FLAGS_nan_inf_action")}
    tcore.set_flag("FLAGS_check_nan_inf", True)
    tcore.set_flag("FLAGS_nan_inf_action", "raise")
    try:
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup), \
                tfluid.unique_name.guard():
            x = tfluid.data("x", shape=[1], dtype="float32")
            h = tfluid.layers.fc(
                x, 1, bias_attr=False,
                param_attr=tfluid.ParamAttr(
                    name="amp_raise_w",
                    initializer=tfluid.initializer.Constant(0.1)))
            loss = tfluid.layers.mean(h)
            lists = AutoMixedPrecisionLists()
            lists.white_list = set()
            opt = decorate(tfluid.optimizer.SGD(1e-4), amp_lists=lists,
                           init_loss_scaling=4.0, incr_every_n_steps=1000,
                           decr_every_n_nan_or_inf=1, incr_ratio=2.0,
                           decr_ratio=0.5, use_fp16=True)
            opt.minimize(loss)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        X = np.full((1, 1), 1e38, np.float32)
        exe.run(startup, scope=scope)
        w0 = scope.find_var("amp_raise_w").value().array.clone()
        with pytest.raises(FloatingPointError) as ei:
            exe.run(main, feed={"x": X}, fetch_list=[loss], scope=scope)
        assert "op #" in str(ei.value), ei.value
        assert "did not replay" not in str(ei.value)
        scale = scope.find_var(opt._loss_scaling_var.name).value().array
        assert scale.item() == 4.0
        assert torch.equal(w0, scope.find_var("amp_raise_w").value().array)
    finally:
        for k, v in saved.items():
            tcore.set_flag(k, v)


def test_amp_scale_floors_at_one_under_persistent_overflow():
    _, scales = _dyn_run(tfluid, tcore, "compiled", inject_at=set(range(8)),
                         steps=8)
    assert scales == [4.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]


def test_amp_static_scaling_when_dynamic_disabled():
    """Static scaling by a power of two is exact in f32: the trajectory
    equals an undecorated run's bit for bit."""
    rng = np.random.RandomState(0)
    X = rng.rand(16, 8).astype("float32")
    Y = rng.randint(0, 4, (16, 1)).astype("int64")
    out = {}
    for static_amp in (False, True):
        kw = (dict(white_list=(), init_loss_scaling=1024.0,
                   use_dynamic_loss_scaling=False, use_fp16=True)
              if static_amp else None)
        main, startup, loss, _ = _mlp(
            tfluid, kw, optimizer=lambda f: f.optimizer.SGD(0.1), seed=9)
        if static_amp:
            assert "scale" in [op.type for op in main.global_block().ops]
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        out[static_amp] = [float(exe.run(main, feed={"x": X, "y": Y},
                                         fetch_list=[loss],
                                         scope=scope)[0][0])
                           for _ in range(6)]
    assert out[True] == out[False], out


def test_amp_split_backward_apply_optimize_unscales():
    from paddle_tpu_torch.fluid.contrib.mixed_precision import decorate
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 6
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.data("x", shape=[8], dtype="float32")
        y = tfluid.data("y", shape=[1], dtype="int64")
        h = tfluid.layers.fc(x, 16, act="relu")
        pred = tfluid.layers.fc(h, 4, act="softmax")
        loss = tfluid.layers.mean(tfluid.layers.cross_entropy(pred, y))
        opt = decorate(tfluid.optimizer.SGD(0.1),
                       init_loss_scaling=2.0 ** 15, use_fp16=True)
        pg = opt.backward(loss)
        opt.apply_optimize(loss, None, pg)
    assert "elementwise_div" in [op.type for op in main.global_block().ops]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    X = rng.rand(16, 8).astype("float32")
    Y = rng.randint(0, 4, (16, 1)).astype("int64")
    losses = [float(exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss],
                            scope=scope)[0][0]) for _ in range(5)]
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses
