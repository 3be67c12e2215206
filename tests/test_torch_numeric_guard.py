"""The numeric fault guard of paddle_tpu_torch (``FLAGS_check_nan_inf``,
``FLAGS_nan_inf_action``) against the TPU package's, ported from
tests/test_numeric_faults.py for the cases the port has:

- ``raise`` localizes the first non-finite op through the interpreter,
  on the interpreted path (:99) and from a compiled step (:119), and
  runs a compiled window step by step to do so;
- ``skip`` leaves the params and the Momentum slots of a poisoned step
  bitwise at their pre-step values, compiled and interpreted (:142), and
  the run lands on the TPU package's state after the same steps
  (parameters at rtol 1e-5, atol 1e-6: f32 sums in other orders);
- a window discards only its poisoned step (:170);
- one compiled block per flag setting, none per step (:244, :282);
- ``rollback`` without a checkpoint plane raises the typed error (:401);
- ``rollback`` with the checkpoint plane (:310, :373): two poisoned steps
  in a row restore the last checkpoint taken outside the fault window,
  and the replay is bitwise the unfaulted oracle's, compiled, segmented
  (the net with a Print island) and interpreted, and inside a compiled
  window (the monitor takes the window's verdicts in order); a
  persistent fault spends the budget and raises the typed error;
- an unknown action is rejected (:418);
- ``fused_health`` against the TPU package's on the same arrays.

Left out, with the module each waits for (ROADMAP.md): the PS guard and
the monitor's trace events (telemetry). The segmented block's guard is
in tests/test_torch_segmented_executor.py.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid.ir import fused_health as j_fused_health
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.ir import fused_health as t_fused_health
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy

from tests import faultinject

_FLAGS = ("FLAGS_check_nan_inf", "FLAGS_nan_inf_action",
          "FLAGS_executor_mode", "FLAGS_nan_inf_tolerance",
          "FLAGS_nan_inf_max_rollbacks")


@pytest.fixture
def flags():
    """Set the guard and mode flags of both packages for one test and
    restore them."""
    saved = {k: tcore.globals_[k] for k in _FLAGS}
    jsaved = {k: jcore.globals_[k] for k in _FLAGS}

    def set_(name, value):
        tcore.set_flag(name, value)
        jcore.set_flag(name, value)
    yield set_
    for k, v in saved.items():
        tcore.set_flag(k, v)
    for k, v in jsaved.items():
        jcore.set_flag(k, v)


def _mlp_program(fluid, seed=7, lr=0.1, with_print=False):
    """The reference's guard MLP (tests/test_numeric_faults.py:23); with
    ``with_print`` its loss goes through a Print island, so the block runs
    segmented."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.data("x", shape=[8], dtype="float32")
        y = fluid.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(h, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        if with_print:
            loss = fluid.layers.Print(loss, message="l",
                                      print_phase="forward")
        fluid.optimizer.Momentum(lr, momentum=0.9).minimize(loss)
    return main, startup, loss


def _batch(rng, n=16):
    return {"x": rng.rand(n, 8).astype("float32"),
            "y": rng.randint(0, 4, (n, 1)).astype("int64")}


def _snapshot(scope, program):
    """Every initialized persistable of ``program`` (params, Momentum
    velocities, the learning rate) as numpy."""
    out = {}
    for v in program.list_vars():
        sv = scope.find_var(v.name) if v.persistable else None
        if sv is not None and sv.is_initialized():
            out[v.name] = sv.value().array.clone().numpy()
    return out


def _blocks(exe, main):
    """The executor's compiled blocks of ``main``."""
    return [cb for cb in exe._compiled_cache.values() if cb.program is main]


def _port(with_print=False):
    main, startup, loss = _mlp_program(tfluid, with_print=with_print)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    return main, loss, exe, scope


# ---------------------------------------------------------------- raise
def test_interpreter_localizer_names_op_var_dtype_indices(flags):
    flags("FLAGS_check_nan_inf", True)
    flags("FLAGS_nan_inf_action", "raise")
    flags("FLAGS_executor_mode", "interpreted")
    main, loss, exe, scope = _port()
    feed = faultinject.poison_feed(_batch(np.random.RandomState(0)), "x",
                                   "nan", index=3)
    with pytest.raises(FloatingPointError) as ei:
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    msg = str(ei.value)
    assert "op #" in msg and "output Out" in msg
    assert "var '" in msg and "float32" in msg
    assert "NaN" in msg and "first offending flat indices" in msg
    assert "op #0 'mul'" in msg and "16 NaN / 0 Inf" in msg  # x's row 0


def test_compiled_raise_localizes_through_interpreter(flags):
    flags("FLAGS_check_nan_inf", True)
    flags("FLAGS_nan_inf_action", "raise")
    main, loss, exe, scope = _port()
    clean = _batch(np.random.RandomState(0))
    exe.run(main, feed=clean, fetch_list=[loss], scope=scope)
    assert exe._last_run_mode == "compiled"
    before = _snapshot(scope, main)
    with pytest.raises(FloatingPointError) as ei:
        exe.run(main, feed=faultinject.poison_feed(clean, "x", "inf"),
                fetch_list=[loss], scope=scope)
    msg = str(ei.value)
    # the scope's steps: the startup run 0, the clean step 1
    assert "numeric fault at global step 2" in msg
    assert "op #0 'mul'" in msg and "Inf" in msg
    after = _snapshot(scope, main)
    for n in before:  # the select kept the pre-step state
        np.testing.assert_array_equal(before[n], after[n], err_msg=n)


def test_raise_runs_a_window_step_by_step(flags):
    """Under raise a compiled window runs one step at a time, so the
    tripped step is localized from its own pre-step state: the state the
    raise leaves equals two single runs of the clean slices."""
    flags("FLAGS_check_nan_inf", True)
    flags("FLAGS_nan_inf_action", "raise")
    rng = np.random.RandomState(5)
    xw = rng.rand(4, 16, 8).astype("float32")
    yw = rng.randint(0, 4, (4, 16, 1)).astype("int64")
    xbad = xw.copy()
    xbad[2, 3, 1] = np.nan
    main, loss, exe, scope = _port()
    with pytest.raises(FloatingPointError) as ei:
        exe.run(main, feed={"x": xbad, "y": yw}, fetch_list=[loss],
                scope=scope, n_steps=4)
    assert "numeric fault at global step 3" in str(ei.value)
    main2, loss2, exe2, scope2 = _port()
    for i in range(2):
        exe2.run(main2, feed={"x": xw[i], "y": yw[i]}, fetch_list=[loss2],
                 scope=scope2)
    got, want = _snapshot(scope, main), _snapshot(scope2, main2)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


# ----------------------------------------------------------------- skip
@pytest.mark.parametrize("run_mode", ["compiled", "interpreted"])
def test_skip_leaves_params_and_slots_bit_identical(flags, run_mode):
    flags("FLAGS_check_nan_inf", True)
    flags("FLAGS_nan_inf_action", "skip")
    flags("FLAGS_executor_mode", run_mode)
    main, loss, exe, scope = _port()
    clean = _batch(np.random.RandomState(0))
    exe.run(main, feed=clean, fetch_list=[loss], scope=scope)
    before = _snapshot(scope, main)  # params AND momentum slots
    assert any("velocity" in n for n in before)
    (bad_loss,) = exe.run(main, feed=faultinject.poison_feed(clean, "x",
                                                             "nan"),
                          fetch_list=[loss], scope=scope)
    assert exe._last_run_mode == run_mode
    after = _snapshot(scope, main)
    assert not bool(exe._last_health)
    assert np.isnan(bad_loss).any()  # the fetch shows the NaN
    assert set(before) == set(after)
    for n in before:
        np.testing.assert_array_equal(before[n], after[n], err_msg=n)
    (lv,) = exe.run(main, feed=clean, fetch_list=[loss], scope=scope)
    assert np.isfinite(lv).all() and bool(exe._last_health)


def test_skip_matches_jax_package(flags):
    """Four steps, the second poisoned, under skip in both packages from
    the TPU package's startup parameters: the same losses (the poisoned
    one NaN in both) and the same final state."""
    flags("FLAGS_check_nan_inf", True)
    flags("FLAGS_nan_inf_action", "skip")
    jm, js, jloss = _mlp_program(jfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
              for v in jm.list_vars() if v.persistable
              and jscope.find_var(v.name) is not None}
    tm, tloss, texe, tscope = _port()
    set_params_from_numpy(tscope, arrays)
    rng = np.random.RandomState(3)
    feeds = [_batch(rng) for _ in range(4)]
    feeds[1] = faultinject.poison_feed(feeds[1], "x", "inf", index=5)
    jl = [float(jexe.run(jm, feed=f, fetch_list=[jloss],
                         scope=jscope)[0][0]) for f in feeds]
    tl = [float(texe.run(tm, feed=f, fetch_list=[tloss],
                         scope=tscope)[0][0]) for f in feeds]
    assert np.isnan(jl[1]) and np.isnan(tl[1])
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    got = _snapshot(tscope, tm)
    for n in arrays:
        np.testing.assert_allclose(
            got[n], np.asarray(jscope.find_var(n).get_tensor()),
            rtol=1e-5, atol=1e-6, err_msg=n)


def test_skip_window_discards_only_the_bad_slice(flags):
    """A window of 4 with step 2 poisoned lands on the state of training
    on the clean slices 0, 1 and 3 alone, bitwise (the step counter
    advances over the skipped step)."""
    flags("FLAGS_check_nan_inf", True)
    flags("FLAGS_nan_inf_action", "skip")
    K = 4
    rng = np.random.RandomState(1)
    xw = rng.rand(K, 16, 8).astype("float32")
    yw = rng.randint(0, 4, (K, 16, 1)).astype("int64")
    xbad = xw.copy()
    xbad[2, 0, 0] = np.inf
    main, loss, exe, scope = _port()
    (losses,) = exe.run(main, feed={"x": xbad, "y": yw}, fetch_list=[loss],
                        scope=scope, n_steps=K)
    assert exe._last_run_mode == "compiled"
    got = _snapshot(scope, main)
    assert exe._last_health.tolist() == [True, True, False, True]
    losses = losses.ravel()
    assert np.isnan(losses[2]) and np.isfinite(losses[[0, 1, 3]]).all()
    main2, loss2, exe2, scope2 = _port()
    for i in (0, 1, 3):
        exe2.run(main2, feed={"x": xw[i], "y": yw[i]}, fetch_list=[loss2],
                 scope=scope2)
    want = _snapshot(scope2, main2)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_guard_no_per_step_rebuild(flags):
    """Windows with the guard on, one of them tripped: one compiled block
    for the program, the same one every run."""
    flags("FLAGS_check_nan_inf", True)
    flags("FLAGS_nan_inf_action", "skip")
    K = 4
    rng = np.random.RandomState(2)
    main, loss, exe, scope = _port()
    windows = [{"x": rng.rand(K, 16, 8).astype("float32"),
                "y": rng.randint(0, 4, (K, 16, 1)).astype("int64")}
               for _ in range(5)]
    windows[1]["x"][1, 0, 0] = np.nan
    exe.run(main, feed=windows[0], fetch_list=[loss], scope=scope,
            n_steps=K)
    cb = exe._last_block
    for w in windows[1:]:
        exe.run(main, feed=w, fetch_list=[loss], scope=scope, n_steps=K)
        assert exe._last_block is cb
    assert _blocks(exe, main) == [cb]
    assert cb.stats["eager"] == 5 * K


def test_flipping_guard_flags_rebuilds_block(flags):
    main, loss, exe, scope = _port()
    clean = _batch(np.random.RandomState(0))
    bad = faultinject.poison_feed(clean, "x", "nan")
    exe.run(main, feed=clean, fetch_list=[loss], scope=scope)  # unguarded
    unguarded = exe._last_block
    assert not unguarded._guard_active
    before = _snapshot(scope, main)
    flags("FLAGS_check_nan_inf", True)
    flags("FLAGS_nan_inf_action", "skip")
    exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
    assert exe._last_block is not unguarded
    assert exe._last_block._guard_action == "skip"
    after = _snapshot(scope, main)
    for n in before:  # the new block guarded the step
        np.testing.assert_array_equal(before[n], after[n], err_msg=n)
    flags("FLAGS_nan_inf_action", "raise")
    with pytest.raises(FloatingPointError):
        exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
    assert len(_blocks(exe, main)) == 3
    flags("FLAGS_check_nan_inf", False)
    exe.run(main, feed=clean, fetch_list=[loss], scope=scope)
    assert exe._last_block is unguarded and len(_blocks(exe, main)) == 3


# ---------------------------------------------- rollback, unknown action
@pytest.mark.parametrize("run_mode", ["compiled", "interpreted"])
def test_rollback_without_checkpoint_plane_is_typed(flags, run_mode):
    flags("FLAGS_check_nan_inf", True)
    flags("FLAGS_nan_inf_action", "rollback")
    flags("FLAGS_executor_mode", run_mode)
    main, loss, exe, scope = _port()
    before = _snapshot(scope, main)
    with pytest.raises(tcore.NumericFaultError) as ei:
        exe.run(main, feed=faultinject.poison_feed(
            _batch(np.random.RandomState(0)), "x", "nan"),
            fetch_list=[loss], scope=scope)
    assert "no checkpoint plane" in str(ei.value)
    after = _snapshot(scope, main)
    for n in before:  # the step was discarded before the raise
        np.testing.assert_array_equal(before[n], after[n], err_msg=n)


def _rollback_flags(flags, tolerance, max_rollbacks=2):
    flags("FLAGS_check_nan_inf", True)
    flags("FLAGS_nan_inf_action", "rollback")
    flags("FLAGS_nan_inf_tolerance", tolerance)
    flags("FLAGS_nan_inf_max_rollbacks", max_rollbacks)


def _path(flags, run_mode):
    """(executor mode, with_print) of a run mode: segmented is the
    compiled mode on the net with a Print island."""
    flags("FLAGS_executor_mode", "interpreted" if run_mode == "interpreted"
          else "compiled")
    return run_mode == "segmented"


@pytest.mark.parametrize("run_mode", ["compiled", "segmented",
                                      "interpreted"])
def test_rollback_resumes_bit_identical_to_unfaulted_oracle(
        flags, tmp_path, run_mode):
    """tests/test_numeric_faults.py:310: steps 4 and 5 poisoned once (a
    transient fault), tolerance 2, a checkpoint every 2 steps. The second
    trip restores the last checkpoint, taken outside the fault window
    (a tripped step never checkpoints); the loop rewinds its feed cursor
    to the restored step, and every loss, the replayed ones included,
    equals the unfaulted oracle's bit for bit."""
    _rollback_flags(flags, 2)
    with_print = _path(flags, run_mode)
    rng = np.random.RandomState(3)
    feeds = [_batch(rng) for _ in range(8)]
    main, loss, exe, scope = _port(with_print)
    oracle = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0][0]) for f in feeds]
    oracle_state = _snapshot(scope, main)

    main, loss, exe, scope = _port(with_print)
    rolled = {}
    # the startup run counted one step: feed i runs at step base + i
    base = tfluid.Executor._rng_counters[scope]
    exe.set_auto_checkpoint(str(tmp_path), every_n_steps=2, program=main,
                            scope=scope)
    exe.set_health_monitor(str(tmp_path), program=main, scope=scope,
                           on_rollback=lambda m: rolled.update(m))
    got = [None] * len(feeds)
    poisoned = {4, 5}
    i = 0
    while i < len(feeds):
        feed = feeds[i]
        if i in poisoned:
            feed = faultinject.poison_feed(feed, "x", "nan")
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert exe._last_run_mode == run_mode
        if rolled:
            i = int(rolled["global_step"]) - base
            assert i < 4, "the checkpoint must predate the fault window"
            poisoned = set()
            rolled.clear()
            continue
        got[i] = float(lv[0])
        i += 1
    mon = exe._health_monitor
    assert (mon.rollbacks, mon.trips) == (1, 2)
    assert mon.last_trip_step == base + 5
    assert exe.health_stats()["trips"] == 2
    assert got == oracle
    state = _snapshot(scope, main)
    for n in oracle_state:
        np.testing.assert_array_equal(state[n], oracle_state[n], err_msg=n)


@pytest.mark.parametrize("run_mode", ["compiled", "segmented",
                                      "interpreted"])
def test_rollback_exhausts_retries_with_typed_error(flags, tmp_path,
                                                    run_mode):
    """tests/test_numeric_faults.py:373: a persistent fault (the same
    poisoned feed after each restore) spends the budget and raises
    core.NumericFaultError."""
    _rollback_flags(flags, 1, max_rollbacks=1)
    main, loss, exe, scope = _port(_path(flags, run_mode))
    clean = _batch(np.random.RandomState(0))
    bad = faultinject.poison_feed(clean, "x", "nan")
    exe.set_auto_checkpoint(str(tmp_path), every_n_steps=1, program=main,
                            scope=scope)
    exe.run(main, feed=clean, fetch_list=[loss], scope=scope)  # ckpt-2
    exe.run(main, feed=bad, fetch_list=[loss], scope=scope)  # rollback 1
    assert exe._health_monitor.rollbacks == 1
    assert tfluid.Executor._rng_counters[scope] == 2  # restored
    with pytest.raises(tcore.NumericFaultError) as ei:
        exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
    assert "rollback budget" in str(ei.value)


def test_rollback_without_intact_checkpoint_is_typed(flags, tmp_path):
    _rollback_flags(flags, 1)
    main, loss, exe, scope = _port()
    exe.set_health_monitor(str(tmp_path / "empty"), program=main,
                           scope=scope)
    with pytest.raises(tcore.NumericFaultError,
                       match="no intact checkpoint"):
        exe.run(main, feed=faultinject.poison_feed(
            _batch(np.random.RandomState(0)), "x", "nan"),
            fetch_list=[loss], scope=scope)


def test_rollback_inside_a_compiled_window(flags, tmp_path):
    """Windows of 2 steps, a checkpoint every 2 steps, tolerance 2: both
    steps of the third window poisoned. The monitor takes the window's two
    verdicts in order, the second rolls back to the checkpoint after the
    second window (none is taken from the tripped one), and the window's
    replay gives the unfaulted windows' losses and state bitwise."""
    _rollback_flags(flags, 2)
    K = 2
    rng = np.random.RandomState(6)
    windows = [{"x": rng.rand(K, 16, 8).astype("float32"),
                "y": rng.randint(0, 4, (K, 16, 1)).astype("int64")}
               for _ in range(4)]
    main, loss, exe, scope = _port()
    oracle = [exe.run(main, feed=w, fetch_list=[loss], scope=scope,
                      n_steps=K)[0].ravel().tolist() for w in windows]
    oracle_state = _snapshot(scope, main)

    main, loss, exe, scope = _port()
    exe.set_auto_checkpoint(str(tmp_path), every_n_steps=2, program=main,
                            scope=scope)
    got, j, poisoned = [None] * len(windows), 0, True
    while j < len(windows):
        w = windows[j]
        if j == 2 and poisoned:
            w = dict(w, x=np.full_like(w["x"], np.nan))
        out = exe.run(main, feed=w, fetch_list=[loss], scope=scope,
                      n_steps=K)[0].ravel().tolist()
        assert exe._last_run_mode == "compiled"
        mon = exe._health_monitor
        if mon is not None and mon.rollbacks and poisoned:
            assert exe._last_health.tolist() == [False, False]
            assert mon.last_manifest["global_step"] == 5
            j = (mon.last_manifest["global_step"] - 1) // K
            poisoned = False
            continue
        got[j] = out
        j += 1
    assert sorted(os.listdir(str(tmp_path))) == ["ckpt-5", "ckpt-7",
                                                 "ckpt-9"]
    assert (mon.rollbacks, mon.trips) == (1, 2)
    assert got == oracle
    state = _snapshot(scope, main)
    for n in oracle_state:
        np.testing.assert_array_equal(state[n], oracle_state[n], err_msg=n)


@pytest.mark.parametrize("run_mode", ["compiled", "interpreted"])
def test_unknown_action_is_rejected_not_silently_inert(flags, run_mode):
    flags("FLAGS_executor_mode", run_mode)
    main, loss, exe, scope = _port()
    flags("FLAGS_check_nan_inf", True)
    flags("FLAGS_nan_inf_action", "abort")
    with pytest.raises(ValueError, match="FLAGS_nan_inf_action"):
        exe.run(main, feed=_batch(np.random.RandomState(0)),
                fetch_list=[loss], scope=scope)


# --------------------------------------------------------- fused_health
@pytest.mark.parametrize("case", ["finite", "nan", "inf", "ints_only",
                                  "empty", "bf16_inf"])
def test_fused_health_matches_jax(case):
    r = np.random.RandomState(4)
    a = r.normal(size=(3, 5)).astype(np.float32)
    b = r.normal(size=(7,)).astype(np.float32)
    ints = np.array([1, 2, 3], np.int32)
    vals = {"finite": [a, b, ints], "nan": [a, b, ints], "inf": [a, b],
            "ints_only": [ints], "empty": [], "bf16_inf": [a, b]}[case]
    if case == "nan":
        vals[1] = b.copy()
        vals[1][4] = np.nan
    if case == "inf":
        vals[0] = a.copy()
        vals[0][2, 1] = -np.inf
    tvals = [torch.from_numpy(v) for v in vals]
    jvals = [jnp.asarray(v) for v in vals]
    if case == "bf16_inf":
        big = np.full((4,), 3e38, np.float32)  # inf once rounded to bf16
        tvals.append(torch.from_numpy(big).to(torch.bfloat16))
        jvals.append(jnp.asarray(big).astype(jnp.bfloat16))
    got = t_fused_health(tvals)
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == bool(j_fused_health(jvals))
