"""The LR schedules of paddle_tpu_torch (fluid/layers/
learning_rate_scheduler.py) against the TPU package's, on the CPU.

- Every schedule's LR over 20 ``Executor.run``s against the TPU
  package's at rtol 1e-6 and atol 1e-6 · the peak LR: exponential,
  natural_exp and inverse_time decay (each also staircase),
  polynomial_decay with and without ``cycle``, piecewise_decay,
  cosine_decay, linear_lr_warmup over a float and over a schedule, and
  noam_decay. The TPU package's polynomial_decay reads -2.98e-12 where
  plain f32 gives 0.0 past its horizon (XLA on the CPU contracts 1 -
  capped / decay_steps into a fused multiply-add), so the trajectories are
  held at that tolerance and not bit for bit. ``piecewise_decay`` and the
  warm-up branch of ``linear_lr_warmup`` also equal a numpy f32
  evaluation of their formulas exactly, and ``polynomial_decay`` reads
  exactly 0.0 at and after ``decay_steps`` with ``end_learning_rate=0``.
- Both packages build the same ops for each schedule, in the same order.
- A small BERT (2 layers, hidden 64) trained with Adam under
  linear_lr_warmup over polynomial_decay: its step compiles whole (the
  Switch's conditionals in the planned step), the losses and parameters
  after 8 steps match the TPU package's within the BERT slice's
  tolerance, compiled equals interpreted bitwise (LRs, losses, every
  persistable), the step at LR 0 leaves the parameters bitwise and moves
  Adam's moments, a window of 4 equals 4 single runs bitwise, and a run
  killed at step 5 and resumed from its checkpoint replays the unbroken
  run's LRs and losses bitwise.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.models import bert as tbert
from tests.test_torch_models_a7 import _to_jax_scope

RUNS = 20
LR = 0.1


@pytest.fixture(autouse=True)
def _restore_mode():
    saved = tcore.globals_["FLAGS_executor_mode"]
    yield
    tcore.set_flag("FLAGS_executor_mode", saved)


SCHEDULES = {
    "exponential": lambda L: L.exponential_decay(LR, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(LR, 3, 0.5, True),
    "natural_exp": lambda L: L.natural_exp_decay(LR, 4, 0.3),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(LR, 4, 0.3, True),
    "inverse_time": lambda L: L.inverse_time_decay(LR, 5, 0.7),
    "inverse_time_staircase":
        lambda L: L.inverse_time_decay(LR, 5, 0.7, True),
    "polynomial": lambda L: L.polynomial_decay(LR, 12, 0.0, 1.0),
    "polynomial_power2_end": lambda L: L.polynomial_decay(LR, 7, 1e-3, 2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(LR, 6, 1e-3, 1.0, True),
    "piecewise": lambda L: L.piecewise_decay([3, 8, 15], [LR, 0.05, 0.01,
                                                         0.001]),
    "cosine": lambda L: L.cosine_decay(LR, 3, 5),
    "warmup_float": lambda L: L.linear_lr_warmup(LR, 6, 0.001, LR),
    "warmup_polynomial": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(LR, 12, 0.0, 1.0), 4, 0.0, LR),
    "noam": lambda L: L.noam_decay(64, 5),
}


def _polynomial_cycle(L, lr, decay_steps, end, power):
    """polynomial_decay(cycle=True) as the reference builds it
    (learning_rate_scheduler.py of Paddle 1.7: a Switch makes the first
    cycle's ceil 1 at step 0), from a package's layers: the TPU package's
    own cycle branch raises ImportError (it imports an ``equal`` that its
    layers/nn.py does not define), so its side runs these ops through its
    kernels and executor."""
    step = L.cast(L.autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=0, step=1), "float32")
    div_res = L.ceil(step / float(decay_steps))
    zero_var = L.fill_constant([1], "float32", 0.0)
    one_var = L.fill_constant([1], "float32", 1.0)
    with L.Switch() as switch:
        with switch.case(L.equal(step, zero_var)):
            L.assign(one_var, div_res)
    frac = 1.0 - step / (div_res * float(decay_steps))
    return (float(lr) - float(end)) * (frac ** power) + float(end)


def _lr_program(fluid, name):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if name == "polynomial_cycle" and fluid is jfluid:
            lr = _polynomial_cycle(fluid.layers, LR, 6, 1e-3, 1.0)
        else:
            lr = SCHEDULES[name](fluid.layers)
    return main, startup, lr


def _ops(program):
    return [[(op.type, {k: v for k, v in op.attrs.items()
                        if not k.startswith("_") and k != "sub_block"})
             for op in b.ops] for b in program.blocks]


def _trajectory(fluid, name, mode=None):
    if mode is not None:
        tcore.set_flag("FLAGS_executor_mode", mode)
    main, startup, lr = _lr_program(fluid, name)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    got = [float(np.asarray(exe.run(main, fetch_list=[lr],
                                    scope=scope)[0]).reshape(-1)[0])
           for _ in range(RUNS)]
    return np.asarray(got, np.float32), main, exe


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_the_tpu_package(name):
    want, jmain, _ = _trajectory(jfluid, name)
    got, tmain, exe = _trajectory(tfluid, name, "compiled")
    assert _ops(tmain) == _ops(jmain)
    assert exe._last_run_mode == "compiled"
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * LR)
    interp, _, _ = _trajectory(tfluid, name, "interpreted")
    assert np.array_equal(got, interp)


def _f32(v):
    return np.float32(v)


def test_piecewise_and_warmup_equal_their_formulas_exactly():
    pw, _, _ = _trajectory(tfluid, "piecewise", "compiled")
    want = [_f32(LR) if s < 3 else _f32(0.05) if s < 8 else _f32(0.01)
            if s < 15 else _f32(0.001) for s in range(RUNS)]
    assert np.array_equal(pw, np.asarray(want, np.float32))
    wu, _, _ = _trajectory(tfluid, "warmup_float", "compiled")
    # start + (end - start) * f32(step) / warmup, in f32 as the ops do it
    warm = [_f32(0.001) + _f32(LR - 0.001) * _f32(s) / _f32(6)
            for s in range(6)]
    assert np.array_equal(wu[:6], np.asarray(warm, np.float32))
    assert np.all(wu[6:] == _f32(LR))


def test_polynomial_cycle_equals_its_formula():
    got, _, _ = _trajectory(tfluid, "polynomial_cycle", "compiled")
    want = []
    for s in range(RUNS):
        f = _f32(s)
        div = max(np.ceil(f / _f32(6)), _f32(1))
        frac = _f32(1) - f / (div * _f32(6))
        want.append(_f32(LR - 1e-3) * frac ** _f32(1) + _f32(1e-3))
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=1e-6,
                               atol=0)
    assert got[0] == _f32(LR) and got[6] == _f32(1e-3)


def test_polynomial_decay_reads_zero_at_and_after_its_horizon():
    got, _, _ = _trajectory(tfluid, "polynomial", "compiled")
    assert np.all(got[12:] == 0.0) and np.all(got[:12] > 0.0)
    warm, _, _ = _trajectory(tfluid, "warmup_polynomial", "compiled")
    assert warm[0] == 0.0 and np.all(warm[12:] == 0.0)
    # the TPU package's endpoint is -lr * 2^-25 (ROADMAP C, carried)
    jgot, _, _ = _trajectory(jfluid, "polynomial")
    assert np.all(np.abs(jgot[12:]) <= 1e-6 * LR)


def test_noam_counter_is_shared_with_a_switch_schedule():
    """Every schedule keys off ``@LR_DECAY_COUNTER@``: a program with two
    schedules has one counter and one increment."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        tfluid.layers.noam_decay(64, 5)
        tfluid.layers.piecewise_decay([2], [1.0, 0.5])
    ops = main.global_block().ops
    assert [op.type for op in ops].count("increment") == 1
    assert ops[0].input("X") == ["@LR_DECAY_COUNTER@"]


# ------------------------------------------------ BERT under the schedule
CFG = dict(vocab_size=128, hidden=64, layers=2, heads=4, ffn=128, max_len=16,
           type_vocab=2)  # tests/test_torch_train_slice.py's
S, B, N_MASK = 16, 4, 10
PEAK, DECAY, WARMUP = 1e-3, 8, 3


def _sched_bert(fluid, bert, dropout=0.0):
    """The masked-LM pretraining step of build_bert_pretrain_program with
    BERT's schedule: linear warm-up over a linear decay, Adam reading the
    scheduled LR, built inside the program guard as a script would."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.data("src_ids", shape=[S], dtype="int64")
        pos = fluid.data("pos_ids", shape=[S], dtype="int64")
        sent = fluid.data("sent_ids", shape=[S], dtype="int64")
        mask_pos = fluid.data("mask_pos", shape=[1], dtype="int64")
        mask_label = fluid.data("mask_label", shape=[1], dtype="int64")
        input_mask = fluid.data("input_mask", shape=[S], dtype="float32")
        bias = bert.padding_attn_bias(input_mask)
        x = bert.bert_embedding(src, pos, sent, CFG, dropout)
        enc = bert.encoder(x, CFG["layers"], CFG["hidden"], CFG["heads"],
                           CFG["ffn"], dropout, attn_bias=bias)
        picked = L.gather(L.reshape(enc, [-1, CFG["hidden"]]), mask_pos)
        loss = L.mean(L.softmax_with_cross_entropy(
            L.fc(picked, CFG["vocab_size"]), mask_label))
        lr = L.linear_lr_warmup(L.polynomial_decay(PEAK, DECAY, 0.0, 1.0),
                                WARMUP, 0.0, PEAK)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    main.random_seed = startup.random_seed = 5
    return main, startup, loss, lr


def _bert_feed(step):
    r = np.random.RandomState(100 + step)
    mask = np.ones((B, S), np.float32)
    mask[0, 10:] = 0.0
    mask[2, 5:] = 0.0
    return {"src_ids": r.randint(0, CFG["vocab_size"], (B, S)),
            "pos_ids": np.tile(np.arange(S), (B, 1)),
            "sent_ids": r.randint(0, CFG["type_vocab"], (B, S)),
            "mask_pos": r.randint(0, B * S, (N_MASK, 1)),
            "mask_label": r.randint(0, CFG["vocab_size"], (N_MASK, 1)),
            "input_mask": mask}


def _persistables(scope, program):
    out = {}
    for v in program.list_vars():
        sv = scope.find_var(v.name) if v.persistable else None
        if sv is not None and sv.is_initialized():
            out[v.name] = sv.value().array.clone()
    return out


def _port_bert(dropout=0.0, mode="compiled"):
    tcore.set_flag("FLAGS_executor_mode", mode)
    main, startup, loss, lr = _sched_bert(tfluid, tbert, dropout)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    return main, startup, loss, lr, exe, scope


def _steps(exe, main, loss, lr, scope, steps):
    out = [exe.run(main, feed=_bert_feed(s), fetch_list=[loss, lr],
                   scope=scope) for s in steps]
    return [(o[0].copy(), o[1].copy()) for o in out]


def test_bert_with_the_schedule_matches_the_tpu_package():
    jm, js, jloss, jlr = _sched_bert(jfluid, jbert)
    tm, ts, tloss, tlr = _sched_bert(tfluid, tbert)
    assert _ops(tm) == _ops(jm)
    assert texecutor._whole_compilable(tm.global_block().ops)
    # append_backward left the schedule's ops alone: no grad of them
    types = {op.type for op in tm.global_block().ops}
    assert "conditional_block" in types and not {
        t for t in types if t.endswith("_grad") and t.split("_grad")[0] in (
            "conditional_block", "less_than", "logical_and", "logical_not",
            "increment", "elementwise_min", "assign")}
    # one start: the port's startup values (the int64 counter, -1, as the
    # TPU package's int32: JAX without x64) on the TPU package's device
    # (``_to_jax_scope``: its step compiles once)
    tcore.set_flag("FLAGS_executor_mode", "compiled")
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(ts, scope=tscope)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    names = [v.name for v in jm.global_block().vars.values()
             if v.persistable]
    _to_jax_scope(tscope, names, jscope)
    # the floats, compared at the end
    arrays = [n for n in names if tscope.find_var(n) is not None
              and tscope.find_var(n).value().array.is_floating_point()]
    jl, tl, jr, tr = [], [], [], []
    for step in range(8):
        feed = _bert_feed(step)
        a, b = jexe.run(jm, feed=feed, fetch_list=[jloss, jlr], scope=jscope)
        c, d = texe.run(tm, feed=feed, fetch_list=[tloss, tlr], scope=tscope)
        jl.append(float(a[0]))
        jr.append(float(b[0]))
        tl.append(float(c[0]))
        tr.append(float(d[0]))
        assert texe._last_run_mode == "compiled"
    np.testing.assert_allclose(tr, jr, rtol=1e-6, atol=1e-6 * PEAK)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    # the K projections' biases: exact grad 0, rounding noise that Adam
    # turns into steps of up to ±lr (tests/test_torch_train_slice.py:443)
    k_bias = {f"fc_{6 * i + 1}.b_0" for i in range(CFG["layers"])}
    for name in arrays:
        want = np.asarray(jscope.find_var(name).get_tensor())
        got = tscope.find_var(name).value().array.numpy()
        atol = 2 * sum(tr) if name in k_bias else 1e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


def test_bert_schedule_compiled_equals_interpreted_and_lr0_step():
    main, startup, loss, lr, exe, scope = _port_bert(0.1)
    params = {p.name for p in main.all_parameters()}
    start = _persistables(scope, main)
    got = _steps(exe, main, loss, lr, scope, [0])
    assert got[0][1].tolist() == [0.0] and exe._last_run_mode == "compiled"
    after = _persistables(scope, main)
    for n in params:  # LR 0: Adam moves nothing
        assert torch.equal(after[n], start[n]), n
    moments = [n for n in after if "_moment" in n]
    assert moments and all(not torch.equal(after[n], start[n])
                           for n in moments)
    got += _steps(exe, main, loss, lr, scope, range(1, 10))
    cstate = _persistables(scope, main)
    main, startup, loss, lr, exe, scope = _port_bert(0.1, "interpreted")
    want = _steps(exe, main, loss, lr, scope, range(10))
    for (a, b), (c, d) in zip(got, want):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    istate = _persistables(scope, main)
    assert sorted(cstate) == sorted(istate)
    for n in cstate:
        assert torch.equal(cstate[n], istate[n]), n
    assert int(cstate["@LR_DECAY_COUNTER@"].reshape(-1)[0]) == 9
    assert [float(g[1][0]) for g in got][:5] == [
        0.0, np.float32(np.float32(PEAK) * np.float32(1) / np.float32(3)),
        np.float32(np.float32(PEAK) * np.float32(2) / np.float32(3)),
        float(np.float32(np.float32(PEAK) * (np.float32(1) - np.float32(3)
                                             / np.float32(8)))),
        float(np.float32(np.float32(PEAK) * (np.float32(1) - np.float32(4)
                                             / np.float32(8))))]


def test_bert_schedule_window_of_4_equals_single_runs():
    """Steps 2-5, across the warm-up boundary, as one window."""
    main, startup, loss, lr, exe, scope = _port_bert(0.1)
    _steps(exe, main, loss, lr, scope, [0, 1])
    feeds = [_bert_feed(s) for s in range(2, 6)]
    stacked = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
    wl, wr = exe.run(main, feed=stacked, fetch_list=[loss, lr], scope=scope,
                     n_steps=4)
    wstate = _persistables(scope, main)
    main, startup, loss, lr, exe, scope = _port_bert(0.1)
    single = _steps(exe, main, loss, lr, scope, range(6))[2:]
    sstate = _persistables(scope, main)
    assert np.array_equal(wl, np.stack([s[0] for s in single]))
    assert np.array_equal(wr, np.stack([s[1] for s in single]))
    assert wr.reshape(-1)[1] == np.float32(np.float32(PEAK) * (
        np.float32(1) - np.float32(3) / np.float32(8)))
    for n in sstate:
        assert torch.equal(wstate[n], sstate[n]), n


@pytest.mark.parametrize("mode", ["compiled", "interpreted"])
def test_bert_schedule_killed_at_step_5_resumes_bitwise(tmp_path, mode):
    main, startup, loss, lr, exe, scope = _port_bert(0.1, mode)
    oracle = _steps(exe, main, loss, lr, scope, range(9))
    ostate = _persistables(scope, main)
    main, startup, loss, lr, exe, scope = _port_bert(0.1, mode)
    _steps(exe, main, loss, lr, scope, range(5))
    path = tfluid.io.save_checkpoint(
        exe, str(tmp_path), main_program=main, scope=scope,
        global_step=tfluid.Executor._rng_counters[scope])
    saved = _persistables(scope, main)
    del exe, scope  # the kill
    main, startup, loss, lr, exe, scope = _port_bert(0.1, mode)
    manifest = exe.resume_from(str(tmp_path), program=main, scope=scope)
    assert manifest["global_step"] == 6 and path.endswith("ckpt-6")
    restored = _persistables(scope, main)
    for n in ("@LR_DECAY_COUNTER@", "linear_warmup_0.warmup_lr"):
        assert torch.equal(restored[n], saved[n]), n
    resumed = _steps(exe, main, loss, lr, scope, range(5, 9))
    for (a, b), (c, d) in zip(resumed, oracle[5:]):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    rstate = _persistables(scope, main)
    for n in ostate:
        assert torch.equal(rstate[n], ostate[n]), n
