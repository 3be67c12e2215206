"""The segmented executor of paddle_tpu_torch (``_SegmentedBlock``,
fluid/ir.py's ``analyze_block_segments``) on the CPU, ported case by case
from tests/test_segmented_executor.py and
tests/test_numeric_faults.py:222:

- the partition into maximal compiled runs and islands, the island
  reasons (:46, :64), and the port's partition of the Wide&Deep training
  program equal to the TPU package's;
- a program with ``Print`` trains as compiled segments with the print
  done every step (:197); a value goes from a segment to an island and
  back (:220, through print's Out); state written back and used by the
  next step (:246);
- an all-island block and the flag off run interpreted (:282, :300), and
  so does a block with an island fed LoD (segments take dense feeds);
- an unknown fetch and an uninitialized persistable raise before any
  state changes (:338, :369); a failed segment plan raises rather than
  interpreting;
- the segments draw what the whole compiled step draws, on a dropout
  program with a ``Print`` (:430);
- ``skip`` discards a poisoned step across the island, a Print island
  and Wide&Deep's auc island fed a NaN feature, and ``raise`` names the
  op;
- the GPU's schedule (an eager warm-up, a capture of each compiled
  segment, then replays around the eager island) rehearsed with a fake
  CUDA graph whose replay re-runs the captured segment on the same
  tensors.

Segmented runs are held to the port's interpreter bitwise.
"""
import contextlib

import numpy as np
import pytest
import torch

from paddle_tpu.fluid.ir import analyze_block_segments as j_analyze
from paddle_tpu.models import wide_deep as jwide_deep
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import core
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid.ir import (analyze_block_segments,
                                       op_island_reason, segment_summary)
from paddle_tpu_torch.models import wide_deep

_FLAGS = ("FLAGS_executor_segmentation", "FLAGS_executor_seg_min_ops",
          "FLAGS_executor_mode", "FLAGS_check_nan_inf",
          "FLAGS_nan_inf_action")


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = {k: core.globals_[k] for k in _FLAGS}
    yield
    for k, v in saved.items():
        core.set_flag(k, v)


@contextlib.contextmanager
def _segmentation(enabled, min_ops=None):
    core.set_flag("FLAGS_executor_segmentation", enabled)
    if min_ops is not None:
        core.set_flag("FLAGS_executor_seg_min_ops", min_ops)
    yield


def _cpu():
    return fluid.Executor(fluid.CPUPlace())


def _state(scope, program):
    return {v.name: scope.find_var(v.name).value().array.clone()
            for v in program.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None
            and scope.find_var(v.name).is_initialized()}


def _assert_same_state(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


# --------------------------------------------------------------- analysis
def test_analysis_partitions_maximal_runs():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[4], dtype="float32")
        h = fluid.layers.scale(x, scale=2.0)
        h = fluid.layers.Print(h, message="dbg")
        h = fluid.layers.scale(h, scale=3.0)
        fluid.layers.relu(h)
    segs = analyze_block_segments(main.global_block().ops)
    assert [s.kind for s in segs] == ["compiled", "island", "compiled"]
    assert [len(s.ops) for s in segs] == [1, 1, 2]
    assert segs[1].island_reasons == ["stateful"]
    assert [(s.start, s.stop) for s in segs] == [(0, 1), (1, 2), (2, 4)]
    summary = segment_summary(segs)
    assert summary[1]["op_types"] == ["print"]
    assert summary[2]["n_ops"] == 2


def test_island_reasons():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[4], dtype="float32")
        y = fluid.data("y", shape=[4], dtype="float32")
        axis = fluid.layers.fill_constant([1], "int32", 1)
        fluid.layers.relu(x)
        fluid.layers.concat([x, y], axis=axis)
        fluid.layers.concat([x, y], axis=1)
        fluid.layers.Print(x)
    ops = {op.type + str(bool(op.inputs.get("AxisTensor"))): op
           for op in main.global_block().ops}
    assert op_island_reason(ops["reluFalse"]) is None
    assert op_island_reason(ops["concatTrue"]) == "host_inputs"
    assert op_island_reason(ops["concatFalse"]) is None
    assert op_island_reason(ops["printFalse"]) == "stateful"

    class FakeOp:
        type = "no_such_op_xyz"
        attrs = {}
        inputs = {}
    assert op_island_reason(FakeOp()) == "unregistered"

    class LoopOp(FakeOp):
        type = "relu"
        attrs = {"sub_block": object()}
    assert op_island_reason(LoopOp()) == "control_flow"


def test_wide_deep_partition_matches_the_tpu_package():
    kw = dict(num_dense=13, num_slots=26, sparse_dim=1000, embedding_dim=16,
              hidden=(400, 400, 400))
    jmain = jwide_deep.build_wide_deep_program(**kw)[0]
    with fluid.unique_name.guard():
        tmain = wide_deep.build_wide_deep_program(**kw)[0]
    jops = [op for op in jmain.global_block().ops
            if op.type not in ("feed", "fetch")]
    tops = tmain.global_block().ops
    assert len(tops) == 364
    jseg, tseg = j_analyze(jops), analyze_block_segments(tops)
    assert [(s.kind, s.start, s.stop, [o.type for o in s.ops],
             s.island_reasons) for s in tseg] == \
        [(s.kind, s.start, s.stop, [o.type for o in s.ops],
          s.island_reasons) for s in jseg]
    assert [(s.kind, s.start, s.stop) for s in tseg] == \
        [("compiled", 0, 152), ("island", 152, 153), ("compiled", 153, 364)]


# ------------------------------------------------------- print trainers
def _print_trainer(message="loss="):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[8], dtype="float32")
        y = fluid.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(h, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        fluid.layers.Print(loss, message=message, summarize=1)
        fluid.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    return main, startup, loss


def _train(segmentation, steps=3, mode="compiled"):
    core.set_flag("FLAGS_executor_mode", mode)
    with _segmentation(segmentation), fluid.unique_name.guard():
        main, startup, loss = _print_trainer()
        exe, scope = _cpu(), fluid.Scope()
        r = np.random.RandomState(0)
        X = r.rand(32, 8).astype("float32")
        Y = r.randint(0, 4, (32, 1)).astype("int64")
        exe.run(startup, scope=scope)
        out = [exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss],
                       scope=scope)[0] for _ in range(steps)]
    return out, exe, _state(scope, main)


def test_print_program_trains_as_compiled_segments(capsys):
    seg, exe, seg_state = _train(True)
    assert exe._last_run_mode == "segmented"
    sb = exe._last_block
    assert sb.kind == "segmented"
    assert [o.type for s in sb.segments if s.kind == "island"
            for o in s.ops] == ["print"]
    compiled = [o.type for s in sb.segments if s.kind == "compiled"
                for o in s.ops]
    assert "momentum" in compiled
    assert any(t.endswith("_grad") for t in compiled)
    assert sb.stats["islands"] == 3 and sb.stats["eager"] == 3
    assert capsys.readouterr().out.count("loss=") == 3
    interp, iexe, int_state = _train(True, mode="interpreted")
    assert iexe._last_run_mode == "interpreted"
    for a, b in zip(seg, interp):
        assert np.array_equal(a, b)
    _assert_same_state(seg_state, int_state)
    assert float(seg[-1][0]) < float(seg[0][0])


def test_flag_off_restores_interpreter():
    out, exe, _ = _train(False)
    assert exe._last_run_mode == "interpreted"


def test_n_steps_is_a_host_loop_with_the_final_fetches(capsys):
    with fluid.unique_name.guard():
        main, startup, loss = _print_trainer()
    r = np.random.RandomState(1)
    feed = {"x": r.rand(16, 8).astype("float32"),
            "y": r.randint(0, 4, (16, 1)).astype("int64")}
    runs = []
    for n_steps in (1, 3):
        exe, scope = _cpu(), fluid.Scope()
        exe.run(startup, scope=scope)
        if n_steps == 1:
            got = [exe.run(main, feed=feed, fetch_list=[loss],
                           scope=scope)[0] for _ in range(3)][-1]
        else:
            (got,) = exe.run(main, feed=feed, fetch_list=[loss],
                             scope=scope, n_steps=3)
        assert exe._last_run_mode == "segmented"
        runs.append((got, _state(scope, main)))
    assert np.array_equal(runs[0][0], runs[1][0])
    _assert_same_state(runs[0][1], runs[1][1])
    assert capsys.readouterr().out.count("loss=") == 6


# ------------------------------------------------------------ env handoff
def test_island_output_feeds_compiled_segment_and_back(capsys):
    """compiled → island (print reads a computed tensor on the host and
    passes it on as Out) → compiled (reads the island's Out)."""
    with _segmentation(True, min_ops=2):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", shape=[4], dtype="float32")
            a = fluid.layers.scale(x, scale=2.0)
            b = fluid.layers.elementwise_add(a, a)
            c = fluid.layers.Print(b, message="handoff")
            d = fluid.layers.scale(c, scale=0.5)
        exe, scope = _cpu(), fluid.Scope()
        X = np.arange(8, dtype="float32").reshape(2, 4)
        exe.run(startup, scope=scope)
        (o,) = exe.run(main, feed={"x": X}, fetch_list=[d], scope=scope)
    assert exe._last_run_mode == "segmented"
    sb = exe._last_block
    assert [s.kind for s in sb.segments] == ["compiled", "island",
                                             "compiled"]
    assert b.name in sb.segments[0].out_names
    assert c.name in sb.segments[2].in_names
    assert np.array_equal(o, 2 * X)
    assert "handoff" in capsys.readouterr().out


def test_state_writeback_across_steps(capsys):
    """Param state a compiled segment writes lands in the scope, and the
    next step reads it: repeated steps on one batch keep moving the
    weight, bitwise as the interpreter moves it."""
    def run(mode):
        core.set_flag("FLAGS_executor_mode", mode)
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.data("x", shape=[4], dtype="float32")
            y = fluid.data("y", shape=[1], dtype="float32")
            p = fluid.layers.fc(x, 1, param_attr=fluid.ParamAttr(
                name="sdw_w"), bias_attr=False)
            loss = fluid.layers.mean(fluid.layers.square(
                fluid.layers.elementwise_sub(p, y)))
            fluid.layers.Print(loss, summarize=1)
            fluid.optimizer.SGD(0.1).minimize(loss)
        exe, scope = _cpu(), fluid.Scope()
        r = np.random.RandomState(4)
        X = r.rand(16, 4).astype("float32")
        Y = r.rand(16, 1).astype("float32")
        exe.run(startup, scope=scope)
        w0 = scope.find_var("sdw_w").value().array.clone()
        losses = [float(exe.run(main, feed={"x": X, "y": Y},
                                fetch_list=[loss], scope=scope)[0][0])
                  for _ in range(5)]
        return exe, w0, scope.find_var("sdw_w").value().array, losses

    with _segmentation(True, min_ops=1):
        exe, w0, w1, losses = run("compiled")
        _, iw0, iw1, ilosses = run("interpreted")
    assert exe._last_run_mode == "segmented"
    assert not torch.equal(w0, w1)
    assert losses[-1] < losses[0] * 0.9
    assert torch.equal(w0, iw0) and torch.equal(w1, iw1)
    assert losses == ilosses


# ------------------------------------------------------------- fallbacks
def test_all_island_block_stays_interpreted(capsys):
    with _segmentation(True):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", shape=[4], dtype="float32")
            h = fluid.layers.scale(x, scale=2.0)
            fluid.layers.Print(h)
        exe, scope = _cpu(), fluid.Scope()
        exe.run(startup, scope=scope)
        (o,) = exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                       fetch_list=[h], scope=scope)
    assert exe._last_run_mode == "interpreted"
    assert np.array_equal(o, np.full((2, 4), 2.0, "float32"))
    # no segmented block planned: the key is remembered as too small
    assert all(cb.kind == "compiled"
               for cb in exe._compiled_cache.values())
    assert len(exe._unsegmentable) == 1


def test_lod_feed_into_a_block_with_an_island_runs_interpreted(capsys):
    """Segments take dense feeds: a block that does not compile whole and
    is fed LoD runs interpreted, as it did before segmentation, with no
    block planned, and trains as the interpreter does."""
    def run(mode):
        core.set_flag("FLAGS_executor_mode", mode)
        with fluid.unique_name.guard():
            main, startup, loss = _print_trainer()
        exe, scope = _cpu(), fluid.Scope()
        exe.run(startup, scope=scope)
        r = np.random.RandomState(2)
        x = fluid.LoDTensor(torch.from_numpy(r.rand(6, 8).astype("float32")),
                            lod=[[0, 2, 6]])
        y = r.randint(0, 4, (6, 1)).astype("int64")
        out = [exe.run(main, feed={"x": x, "y": y}, fetch_list=[loss],
                       scope=scope)[0] for _ in range(2)]
        return out, exe, _state(scope, main)

    with _segmentation(True):
        seg, exe, seg_state = run("compiled")
        interp, _, int_state = run("interpreted")
    assert exe._last_run_mode == "interpreted"
    # the startup's compiled block alone: no segment plan was built
    assert all(cb.kind == "compiled"
               for cb in exe._compiled_cache.values())
    assert not exe._unsegmentable
    for a, b in zip(seg, interp):
        assert np.array_equal(a, b)
    _assert_same_state(seg_state, int_state)
    assert capsys.readouterr().out.count("loss=") == 4


def test_unknown_fetch_fails_before_any_state_changes(capsys):
    with _segmentation(True), fluid.unique_name.guard():
        main, startup, loss = _print_trainer()
    exe, scope = _cpu(), fluid.Scope()
    r = np.random.RandomState(0)
    feed = {"x": r.rand(8, 8).astype("float32"),
            "y": r.randint(0, 4, (8, 1)).astype("int64")}
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    before = _state(scope, main)
    printed = capsys.readouterr().out.count("loss=")
    with pytest.raises(KeyError, match="no_such_var"):
        exe.run(main, feed=feed, fetch_list=["no_such_var"], scope=scope)
    _assert_same_state(before, _state(scope, main))
    assert capsys.readouterr().out.count("loss=") == 0 and printed == 1
    (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe._last_run_mode == "segmented" and np.isfinite(lv).all()


def test_uninitialized_persistable_raises_like_compiled():
    with _segmentation(True):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", shape=[8], dtype="float32")
            h = fluid.layers.fc(x, 16, act="relu",
                                param_attr=fluid.ParamAttr(name="up_w"))
            fluid.layers.Print(h, summarize=1)
            for _ in range(6):
                h = fluid.layers.scale(h, scale=1.0)
        exe, scope = _cpu(), fluid.Scope()  # startup NOT run
        with pytest.raises(RuntimeError, match="up_w"):
            exe.run(main, feed={"x": np.ones((2, 8), "float32")},
                    fetch_list=[h], scope=scope)
    assert scope.find_var("up_w") is None or \
        not scope.find_var("up_w").is_initialized()


def test_failed_segment_plan_raises(monkeypatch):
    """A plan that fails to build raises: nothing falls back to the
    interpreter."""
    def broken(self):
        raise ValueError("segment plan refused")
    monkeypatch.setattr(texecutor._SegmentedBlock, "_plan_segments", broken)
    with fluid.unique_name.guard():
        main, startup, loss = _print_trainer()
    exe, scope = _cpu(), fluid.Scope()
    exe.run(startup, scope=scope)
    r = np.random.RandomState(0)
    with pytest.raises(ValueError, match="segment plan refused"):
        exe.run(main, feed={"x": r.rand(8, 8).astype("float32"),
                            "y": r.randint(0, 4, (8, 1)).astype("int64")},
                fetch_list=[loss], scope=scope)
    assert exe._last_run_mode != "interpreted"


# ------------------------------------------------------ rng determinism
def test_segmented_rng_matches_fused_compiled(capsys):
    """A dropout program cut by a Print after it draws what the whole
    compiled step draws: keys come from the ops' indices in the block. A
    dropout after the island draws what the interpreter draws."""
    def run(with_print, mode="compiled"):
        core.set_flag("FLAGS_executor_mode", mode)
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 1234
        with fluid.program_guard(main, startup):
            x = fluid.data("x", shape=[8], dtype="float32")
            h = fluid.layers.dropout(x, dropout_prob=0.5)
            o = fluid.layers.scale(h, scale=1.0)
            for _ in range(4):
                o = fluid.layers.scale(o, scale=1.0)
            fetch = [o]
            if with_print:
                fluid.layers.Print(o, summarize=1)
                fetch.append(fluid.layers.dropout(o, dropout_prob=0.5))
        exe, scope = _cpu(), fluid.Scope()
        X = np.ones((4, 8), "float32")
        exe.run(startup, scope=scope)
        vals = [exe.run(main, feed={"x": X}, fetch_list=fetch,
                        scope=scope) for _ in range(2)]
        return vals, exe._last_run_mode

    with _segmentation(True, min_ops=4):
        seg, m1 = run(True)
        fused, m2 = run(False)
        interp, m3 = run(True, "interpreted")
    assert (m1, m2, m3) == ("segmented", "compiled", "interpreted")
    for a, b, c in zip(seg, fused, interp):
        assert np.array_equal(a[0], b[0])
        assert np.array_equal(a[0], c[0]) and np.array_equal(a[1], c[1])
    assert not np.array_equal(seg[0][0], seg[1][0])  # a new mask a step
    assert not np.array_equal(seg[0][1], seg[1][1])


# ---------------------------------------------------- numeric fault guard
def _mlp_with_print():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.data("x", shape=[8], dtype="float32")
        y = fluid.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(h, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, y))
        fluid.layers.Print(loss, summarize=1)
        fluid.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    return main, startup, loss


def test_skip_discards_a_poisoned_step_across_the_island(capsys):
    core.set_flag("FLAGS_check_nan_inf", True)
    core.set_flag("FLAGS_nan_inf_action", "skip")
    core.set_flag("FLAGS_executor_seg_min_ops", 1)
    main, startup, loss = _mlp_with_print()
    r = np.random.RandomState(0)
    clean = {"x": r.rand(16, 8).astype("float32"),
             "y": r.randint(0, 4, (16, 1)).astype("int64")}
    bad = dict(clean, x=clean["x"].copy())
    bad["x"][3, 2] = np.nan
    results = {}
    for mode in ("compiled", "interpreted"):
        core.set_flag("FLAGS_executor_mode", mode)
        exe, scope = _cpu(), fluid.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=clean, fetch_list=[loss], scope=scope)
        before = _state(scope, main)
        exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
        assert not bool(exe._last_health)
        _assert_same_state(before, _state(scope, main))
        exe.run(main, feed=clean, fetch_list=[loss], scope=scope)
        results[mode] = (exe._last_run_mode, _state(scope, main))
    assert results["compiled"][0] == "segmented"
    assert results["interpreted"][0] == "interpreted"
    _assert_same_state(results["compiled"][1], results["interpreted"][1])


def test_skip_discards_a_poisoned_wide_deep_step_across_the_auc_island():
    """A NaN in the dense features reaches the auc island as a NaN
    prediction: the island counts it in range, the step's health trips,
    and the select puts back every table, moment and histogram."""
    core.set_flag("FLAGS_check_nan_inf", True)
    core.set_flag("FLAGS_nan_inf_action", "skip")
    nb = wide_deep.ctr_reader(64, num_slots=4, sparse_dim=1000, seed=0)
    clean = [nb(), nb()]
    bad = dict(clean[0], dense=clean[0]["dense"].copy())
    bad["dense"][5, 3] = np.nan
    results = {}
    for mode in ("compiled", "interpreted"):
        core.set_flag("FLAGS_executor_mode", mode)
        with fluid.unique_name.guard():
            main, startup, _, loss, auc = wide_deep.build_wide_deep_program(
                num_slots=4, sparse_dim=1000, embedding_dim=8,
                hidden=(32, 32))
        exe, scope = _cpu(), fluid.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=clean[0], fetch_list=[loss, auc], scope=scope)
        before = _state(scope, main)
        exe.run(main, feed=bad, fetch_list=[loss, auc], scope=scope)
        assert not bool(exe._last_health)
        after = _state(scope, main)
        after.pop("@RNG_COUNTER@", None), before.pop("@RNG_COUNTER@", None)
        _assert_same_state(before, after)
        exe.run(main, feed=clean[1], fetch_list=[loss, auc], scope=scope)
        assert bool(exe._last_health)
        results[mode] = (exe._last_run_mode, _state(scope, main))
    assert results["compiled"][0] == "segmented"
    assert results["interpreted"][0] == "interpreted"
    _assert_same_state(results["compiled"][1], results["interpreted"][1])


def test_raise_names_the_op_of_a_segmented_step(capsys):
    core.set_flag("FLAGS_check_nan_inf", True)
    core.set_flag("FLAGS_nan_inf_action", "raise")
    core.set_flag("FLAGS_executor_seg_min_ops", 1)
    main, startup, loss = _mlp_with_print()
    exe, scope = _cpu(), fluid.Scope()
    exe.run(startup, scope=scope)
    r = np.random.RandomState(0)
    feed = {"x": r.rand(16, 8).astype("float32"),
            "y": r.randint(0, 4, (16, 1)).astype("int64")}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe._last_run_mode == "segmented"
    before = _state(scope, main)
    feed["x"][0, 0] = np.inf
    with pytest.raises(FloatingPointError, match="op #0 'mul'"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    after = _state(scope, main)
    after.pop("@RNG_COUNTER@", None), before.pop("@RNG_COUNTER@", None)
    _assert_same_state(before, after)


def test_segment_health_flags_cover_their_float_outputs(capsys):
    core.set_flag("FLAGS_check_nan_inf", True)
    core.set_flag("FLAGS_nan_inf_action", "skip")
    main, startup, loss = _mlp_with_print()
    exe, scope = _cpu(), fluid.Scope()
    exe.run(startup, scope=scope)
    r = np.random.RandomState(0)
    exe.run(main, feed={"x": r.rand(16, 8).astype("float32"),
                        "y": r.randint(0, 4, (16, 1)).astype("int64")},
            fetch_list=[loss], scope=scope)
    sb = exe._last_block
    assert sb.kind == "segmented" and bool(exe._last_health)
    for seg in sb.segments:
        if seg.kind == "compiled":
            assert seg.guard_names and set(seg.guard_names) <= \
                set(seg.out_names)
    assert loss.name in sb.segments[0].guard_names


# ------------------------------------------- the GPU's schedule, rehearsed
class _FakeGraph:
    """A CUDA graph stand-in: the capture runs the segment eagerly (the
    fake context records nothing), and a replay re-runs the captured
    segment on the same input tensors and copies its results into the
    captured outputs, as a replay overwrites them in place."""

    def __init__(self):
        self.fn = None

    def replay(self):
        if self.fn is not None:
            self.fn()


def test_graph_schedule_rehearsed_with_a_fake_graph(monkeypatch):
    real_capture = texecutor._SegmentedBlock._capture_segment
    real_compute = texecutor._SegmentedBlock._seg_compute

    def capture(self, seg, env, stable, rt):
        seen = {n: env[n] for n in seg.in_names if n in env}
        outs, flag = real_capture(self, seg, env, stable, rt)
        graph, static_in, captured, cflag = rt[seg.start]
        inputs = dict(seen, **static_in)
        for n in seg.in_names:  # stable inputs are read where they were
            if n in seen and n not in static_in:
                assert inputs[n] is env[n] or n in seg.state_writes

        def replay():
            o, _ = real_compute(self, seg, inputs)
            for n, t in captured.items():
                t.copy_(o[n])
        graph.fn = replay
        return outs, flag

    def run_on_stream(self, scope, feeds, return_numpy=True):
        fetched, self.last_health = self._run_on_stream(scope, feeds)
        return [t.clone().numpy() for t in fetched]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(texecutor._SegmentedBlock, "_capture_segment",
                        capture)
    monkeypatch.setattr(texecutor._SegmentedBlock, "run", run_on_stream)

    def train(mode, steps=5):
        core.set_flag("FLAGS_executor_mode", mode)
        with fluid.unique_name.guard():
            main, startup, _, loss, auc = wide_deep.build_wide_deep_program(
                num_slots=4, sparse_dim=1000, embedding_dim=8,
                hidden=(32, 32))
        exe, scope = _cpu(), fluid.Scope()
        exe.run(startup, scope=scope)
        exe._stream = "fake"  # the executor's stream: the graph path
        nb = wide_deep.ctr_reader(64, num_slots=4, sparse_dim=1000, seed=0)
        out, execs = [], []
        for _ in range(steps):
            out.append(exe.run(main, feed=nb(), fetch_list=[loss, auc],
                               scope=scope))
            execs.append(getattr(exe._last_block, "last_exec", None))
        return out, execs, exe, _state(scope, main)

    seg, execs, exe, seg_state = train("compiled")
    interp, _, _, int_state = train("interpreted")
    assert execs == ["eager", "capture", "replay", "replay", "replay"]
    sb = exe._last_block
    assert sb.stats["captures"] == 2 and sb.stats["islands"] == 5
    assert sb.stats["replays"] == 2 * 4
    assert not any(sb.graph_launches.values())
    for a, b in zip(seg, interp):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    _assert_same_state(seg_state, int_state)
