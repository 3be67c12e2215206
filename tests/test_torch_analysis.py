"""The port's Program verifier (paddle_tpu_torch/fluid/analysis.py) against
the TPU package's (paddle_tpu/fluid/analysis.py), on the programs
tests/test_analysis.py builds, each built by both packages:

- ``verify_program``'s diagnostics equal the TPU package's: rule,
  severity, block, op index, var and fix hint, in order (the messages
  name each package's own machinery and are not compared), for the
  dataflow rules, ``dtype-mismatch`` (mixed inputs, a cast's out_dtype),
  ``shape-mismatch`` (mul, matmul), ``dead-op`` and ``dead-var`` (with a
  fetch list, without one, with the dead output fetched) and
  ``donation-safety`` (a segment summary of a program that grew an op,
  a plan that donates a buffer a later op reads, the guard's select);
- ``maybe_verify``: once per program version at a plan's first compile
  (``FLAGS_program_verify``), a segmented plan checked against its
  program, and at "error" a ``ProgramVerifyError`` before anything runs.
"""
import numpy as np
import pytest

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import analysis as janalysis
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid import ir as jir
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import analysis as tanalysis
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import ir as tir

SIDES = ((jfluid, janalysis, jir), (tfluid, tanalysis, tir))


@pytest.fixture(autouse=True)
def _fresh_tmp_names(monkeypatch):
    """Both packages name temporaries from a process-wide counter that
    ``unique_name.guard`` does not reset: start both from zero."""
    from paddle_tpu.fluid import unique_name as jnames
    from paddle_tpu_torch.fluid import unique_name as tnames
    for m in (jnames, tnames):
        monkeypatch.setattr(m, "dygraph_parameter_name_generator",
                            m.UniqueNameGenerator())


def _key(diags):
    return [(d.rule, d.severity, d.block, d.op_idx, d.var, d.fix_hint)
            for d in diags]


def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, 16, act="relu")
        loss = fluid.layers.mean(fluid.layers.fc(h, 4))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss.name


def _hand(build):
    """``build(block, program)`` on an empty program of each package."""
    out = []
    for fluid, _, _ in SIDES:
        main = fluid.Program()
        build(main.global_block(), main)
        out.append(main)
    return out


def _def_before_use(b, _):
    b.create_var(name="ghost", shape=(2, 4), dtype="float32",
                 persistable=False)
    b.create_var(name="out", shape=(2, 4), dtype="float32")
    b.append_op(type="relu", inputs={"X": ["ghost"]},
                outputs={"Out": ["out"]}, attrs={})


def _missing_desc(b, _):
    b.create_var(name="out", shape=(2,), dtype="float32")
    b.append_op(type="relu", inputs={"X": ["never_declared"]},
                outputs={"Out": ["out"]}, attrs={})
    b.create_var(name="o2", shape=(2,), dtype="float32")
    b.append_op(type="relu", inputs={"X": ["@EMPTY@"]},
                outputs={"Out": ["o2"]}, attrs={})


def _dtype_mismatch(b, _):
    b.create_var(name="a", shape=(4,), dtype="float32", persistable=True)
    b.create_var(name="i", shape=(4,), dtype="int32", persistable=True)
    b.create_var(name="out", shape=(4,), dtype="float32")
    b.append_op(type="elementwise_add", inputs={"X": ["a"], "Y": ["i"]},
                outputs={"Out": ["out"]}, attrs={})
    b.create_var(name="c", shape=(4,), dtype="float32")
    b.append_op(type="cast", inputs={"X": ["a"]}, outputs={"Out": ["c"]},
                attrs={"in_dtype": tcore.VarDesc.VarType.FP32,
                       "out_dtype": tcore.VarDesc.VarType.INT64})


def _mul_shapes(k):
    def build(b, _):
        b.create_var(name="x", shape=(-1, 8), dtype="float32",
                     persistable=True)
        b.create_var(name="w", shape=(k, 4), dtype="float32",
                     persistable=True)
        b.create_var(name="out", shape=(-1, 4), dtype="float32")
        b.append_op(type="mul", inputs={"X": ["x"], "Y": ["w"]},
                    outputs={"Out": ["out"]},
                    attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
    return build


def _matmul_shapes(b, _):
    b.create_var(name="x", shape=(2, 3, 8), dtype="float32",
                 persistable=True)
    b.create_var(name="y", shape=(2, 4, 5), dtype="float32",
                 persistable=True)
    b.create_var(name="out", shape=(2, 3, 5), dtype="float32")
    b.append_op(type="matmul", inputs={"X": ["x"], "Y": ["y"]},
                outputs={"Out": ["out"]},
                attrs={"transpose_X": False, "transpose_Y": False})


def _sub_block_read(b, main):
    b.create_var(name="x", shape=(4,), dtype="float32", persistable=True)
    b.create_var(name="hidden", shape=(4,), dtype="float32")
    b.append_op(type="scale", inputs={"X": ["x"]},
                outputs={"Out": ["hidden"]}, attrs={"scale": 1.0})
    sub = main._create_block()
    sub.create_var(name="sub_out", shape=(4,), dtype="float32")
    sub.append_op(type="relu", inputs={"X": ["hidden"]},
                  outputs={"Out": ["sub_out"]}, attrs={})
    main._rollback()
    b.create_var(name="cond", shape=(1,), dtype="bool", persistable=True)
    b.append_op(type="conditional_block", inputs={"Cond": ["cond"]},
                outputs={}, attrs={"sub_block": sub})


HAND = {"def_before_use": (_def_before_use, ["out"], "def-before-use"),
        "missing_desc": (_missing_desc, ["out", "o2"], "missing-var-desc"),
        "dtype_mismatch": (_dtype_mismatch, ["out", "c"], "dtype-mismatch"),
        "mul_bad": (_mul_shapes(9), ["out"], "shape-mismatch"),
        "mul_good": (_mul_shapes(8), ["out"], None),
        "matmul_bad": (_matmul_shapes, ["out"], "shape-mismatch"),
        "sub_block_read": (_sub_block_read, None,
                           "undeclared-sub-block-read")}


@pytest.mark.parametrize("case", sorted(HAND))
def test_rule_diagnostics_equal_the_tpu_package(case):
    build, fetch, rule = HAND[case]
    jm, tm = _hand(build)
    j = janalysis.verify_program(jm, fetch_names=fetch)
    t = tanalysis.verify_program(tm, fetch_names=fetch)
    assert _key(t) == _key(j)
    assert (rule in [d.rule for d in t]) == (rule is not None)
    if rule is None:
        assert t == []


@pytest.mark.parametrize("fetch", ["loss", "unknown", "revived"])
def test_dead_code_rules_equal_the_tpu_package(fetch):
    got = []
    for fluid, analysis, _ in SIDES:
        main, startup, loss = _mlp(fluid)
        b = main.global_block()
        b.create_var(name="unused_out", shape=(1,), dtype="float32")
        b.append_op(type="scale", inputs={"X": [loss]},
                    outputs={"Out": ["unused_out"]}, attrs={"scale": 2.0})
        b.create_var(name="orphan", shape=(3,), dtype="float32")
        names = {"loss": [loss], "unknown": None,
                 "revived": [loss, "unused_out"]}[fetch]
        got.append(analysis.verify_program(main, fetch_names=names))
        assert analysis.verify_program(startup, fetch_names=[]) == []
    assert _key(got[1]) == _key(got[0])
    rules = [d.rule for d in got[1]]
    assert ("dead-op" in rules) == (fetch == "loss")
    assert ("dead-var" in rules) == (fetch != "unknown")


def test_clean_mlp_verifies_clean():
    for fluid, analysis, _ in SIDES:
        main, startup, loss = _mlp(fluid)
        assert analysis.verify_program(main, fetch_names=[loss]) == []


def _summary(ir, main):
    ops = [op for op in main.global_block().ops
           if op.type not in ("feed", "fetch")]
    return ir.segment_summary(ir.analyze_block_segments(ops))


def test_donation_rules_equal_the_tpu_package():
    """A plan that covers fewer ops than the program; a compiled segment
    that donates a buffer a later op reads and does not return; the same
    plan under the guard's select action."""
    got = {"stale": [], "donated": [], "guard": []}
    for fluid, analysis, ir in SIDES:
        main, _, loss = _mlp(fluid)
        plan = _summary(ir, main)
        b = main.global_block()
        b.create_var(name="w_read", shape=(1,), dtype="float32")
        b.append_op(type="scale", inputs={"X": [loss]},
                    outputs={"Out": ["w_read"]}, attrs={"scale": 1.0})
        got["stale"].append(analysis.verify_program(
            main, fetch_names=[loss, "w_read"], segment_plan=plan))
        ops = [op for op in b.ops if op.type not in ("feed", "fetch")]
        donor = dict(kind="compiled", start=0, stop=len(ops) - 1,
                     out_names=[], donated_names=[loss])
        tail = dict(kind="compiled", start=len(ops) - 1, stop=len(ops),
                    out_names=["w_read"], donated_names=[])
        got["donated"].append(analysis.verify_program(
            main, fetch_names=["w_read"], segment_plan=[donor, tail]))
        core = jcore if fluid is jfluid else tcore
        old = (core.globals_["FLAGS_check_nan_inf"],
               core.globals_["FLAGS_nan_inf_action"])
        core.set_flag("FLAGS_check_nan_inf", True)
        core.set_flag("FLAGS_nan_inf_action", "skip")
        try:
            got["guard"].append(analysis.verify_program(
                main, fetch_names=["w_read"], segment_plan=[donor, tail]))
        finally:
            core.set_flag("FLAGS_check_nan_inf", old[0])
            core.set_flag("FLAGS_nan_inf_action", old[1])
    for what, (j, t) in got.items():
        assert _key(t) == _key(j), what
        assert [d.rule for d in t] == ["donation-safety"], what
        assert t[0].severity == "error"


def _island_program(fluid):
    """A trainer that segments: fc layers and SGD around a Print."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[4], dtype="float32")
        h = fluid.layers.fc(x, 8, act="relu")
        h = fluid.layers.fc(h, 8, act="relu")
        loss = fluid.layers.mean(fluid.layers.fc(h, 1))
        fluid.layers.Print(loss, message="loss")
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_executor_verifies_once_a_version_and_checks_its_plan(
        monkeypatch):
    calls = []
    real = tanalysis.verify_program

    def counting(*a, **kw):
        calls.append(kw.get("where"))
        return real(*a, **kw)
    monkeypatch.setattr(tanalysis, "verify_program", counting)
    monkeypatch.setitem(tcore.globals_._values, "FLAGS_program_verify",
                        "error")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    main, startup, loss = _mlp(tfluid)
    exe.run(startup, scope=scope)
    for _ in range(4):
        exe.run(main, feed={"x": np.ones((2, 8), "float32")},
                fetch_list=[loss], scope=scope)
    assert calls.count("executor") == 2     # startup and main, once each
    imain, istartup, iloss = _island_program(tfluid)
    exe.run(istartup, scope=scope)
    exe.run(imain, feed={"x": np.ones((2, 4), "float32")},
            fetch_list=[iloss], scope=scope)
    assert exe._last_run_mode == "segmented"
    assert calls.count("executor-plan") == 1
    assert (imain._version, "executor-plan") in imain._verify_versions


def test_error_level_raises_before_the_run(monkeypatch):
    monkeypatch.setitem(tcore.globals_._values, "FLAGS_program_verify",
                        "error")
    main = tfluid.Program()
    b = main.global_block()
    b.create_var(name="x", shape=(-1, 4), dtype="float32", is_data=True,
                 need_check_feed=True)
    b.create_var(name="ghost", shape=(2, 4), dtype="float32")
    b.create_var(name="out", shape=(2, 4), dtype="float32")
    b.append_op(type="elementwise_add", inputs={"X": ["x"], "Y": ["ghost"]},
                outputs={"Out": ["out"]}, attrs={})
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with pytest.raises(tanalysis.ProgramVerifyError) as ei:
        exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                fetch_list=["out"], scope=scope)
    assert [d.rule for d in ei.value.diagnostics] == ["def-before-use"]
    assert tanalysis.rule_ids() == janalysis.rule_ids()
    with pytest.raises(ValueError, match="FLAGS_program_verify"):
        tanalysis.maybe_verify(main, "api", level="loud")
