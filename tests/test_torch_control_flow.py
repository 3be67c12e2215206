"""Control flow of paddle_tpu_torch against the TPU package, and its
lowering in the port's executor, on the CPU.

- Each new op against its TPU kernel on the same numpy inputs: the
  comparisons and logical ops, floor, ceil, cos and exp kernel against
  kernel; the tensor-array ops, select_input and select_output (stateful:
  they read the scope) as small programs through both executors.
- The port's counterparts of the TPU package's own control-flow tests
  (tests/test_dygraph_to_static.py:191-288: a while compiles, a cond
  compiles, a branch's write to an outer var is masked, a dropout in a
  while body draws a new mask each iteration) and the rng-in-cond routing
  (tests/test_backward_executor.py:515-555).
- case and switch_case with three branches, a nested Switch, a While over
  tensor arrays, a Switch case that assigns a numpy constant (the plan
  binds it once: no host copy while the step runs), each compiled against
  the interpreter bitwise. On the CPU the compiled step is the planned
  step; the GPU's schedule for a loop (an eager warm-up, then the body
  captured once and replayed each iteration) is rehearsed with a fake CUDA
  graph whose replay re-runs the captured body on the same buffers.
- A While over one shared encoder layer (hidden 64, 2 heads) against the
  TPU package at the serve parity tests' tolerance (rtol = atol = 1e-4),
  and with dropout compiled against interpreted bitwise.
- The ProgramDesc bytes of a Switch and of a While program equal the TPU
  package's.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import executor as jexecutor
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.registry import OPS as TOPS

_FLAGS = ("FLAGS_executor_mode", "FLAGS_executor_seg_min_ops",
          "FLAGS_executor_segmentation")


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = {k: tcore.globals_[k] for k in _FLAGS}
    yield
    for k, v in saved.items():
        tcore.set_flag(k, v)


@pytest.fixture(autouse=True)
def _fresh_tmp_names(monkeypatch):
    """Both packages name temporaries from a process-wide counter that
    ``unique_name.guard`` does not reset: start both from zero."""
    from paddle_tpu.fluid import unique_name as jnames
    from paddle_tpu_torch.fluid import unique_name as tnames
    for m in (jnames, tnames):
        monkeypatch.setattr(m, "dygraph_parameter_name_generator",
                            m.UniqueNameGenerator())


def _cpu():
    return tfluid.Executor(tfluid.CPUPlace())


def _run(build, feed, mode, runs=2, min_ops=None):
    """``build(fluid)`` → (main, startup, fetches) in the port, run
    ``runs`` times in ``mode`` on a fresh scope → (fetches of each run,
    the executor, the persistables at the end)."""
    tcore.set_flag("FLAGS_executor_mode", mode)
    if min_ops is not None:
        tcore.set_flag("FLAGS_executor_seg_min_ops", min_ops)
    tfluid.unique_name.dygraph_parameter_name_generator = \
        tfluid.unique_name.UniqueNameGenerator()
    with tfluid.unique_name.guard():
        main, startup, fetch = _build_in(tfluid, build)
    main.random_seed = startup.random_seed = 7
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(startup, scope=scope)
    feeds = feed if isinstance(feed, list) else [feed] * runs
    out = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
           for f in feeds]
    exe.scope = scope  # kept alive with the executor
    state = {}
    for v in main.list_vars():
        sv = scope.find_var(v.name) if v.persistable else None
        if sv is not None and sv.is_initialized():
            state[v.name] = sv.value().array.clone()
    return out, exe, state


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for p, q in zip(x, y):
            assert p.dtype == q.dtype and np.array_equal(p, q)


def _same_state(a, b):
    assert sorted(a) == sorted(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


def _compiled_vs_interpreted(build, feed, runs=3, min_ops=None):
    got, exe, gs = _run(build, feed, "compiled", runs, min_ops)
    want, _, ws = _run(build, feed, "interpreted", runs, min_ops)
    _bitwise(got, want)
    _same_state(gs, ws)
    return got, exe


# ------------------------------------------------------- kernel vs kernel
def _rand(r, shape, kind):
    if kind == "bool":
        return r.rand(*shape) > 0.5
    if kind == "int64":
        return r.randint(-3, 4, shape).astype(np.int64)
    return (r.randn(*shape) * 3).astype(np.float32)


def _both(op, ins, attrs=None):
    attrs = dict(attrs or {})
    j = JOPS.get(op).kernel({k: [jnp.asarray(v)] for k, v in ins.items()},
                            attrs)["Out"][0]
    t = TOPS.get(op).kernel({k: [torch.from_numpy(np.asarray(v))]
                             for k, v in ins.items()}, attrs)["Out"][0]
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("op,kind", [
    ("equal", "int64"), ("not_equal", "int64"), ("equal", "float32"),
    ("not_equal", "float32"), ("logical_and", "bool"),
    ("logical_or", "bool"), ("logical_xor", "bool")])
@pytest.mark.parametrize("yshape", [(4, 5), (5,), (1,)])
def test_binary_predicates_match_the_tpu_kernels(op, kind, yshape):
    r = np.random.RandomState(0)
    x = _rand(r, (4, 5), kind)
    y = _rand(r, yshape, kind)
    j, t = _both(op, {"X": x, "Y": y}, {"axis": -1})
    assert t.dtype == np.bool_ and np.array_equal(t, j)


@pytest.mark.parametrize("op", ["logical_not", "floor", "ceil", "cos",
                                "exp"])
def test_unary_ops_match_the_tpu_kernels(op):
    r = np.random.RandomState(1)
    x = _rand(r, (3, 7), "bool" if op == "logical_not" else "float32")
    j, t = _both(op, {"X": x})
    assert t.shape == j.shape and t.dtype == j.dtype
    if op in ("cos", "exp"):
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    else:
        assert np.array_equal(t, j)


def test_ceil_and_floor_have_no_grad_cos_and_exp_do():
    for op in ("ceil", "floor"):
        assert TOPS.get(op).no_grad and JOPS.get(op).no_grad
    for op in ("cos", "exp"):
        assert not TOPS.get(op).no_grad and not JOPS.get(op).no_grad


_STATEFUL = ("while", "conditional_block", "select_input", "select_output",
             "write_to_array", "read_from_array", "lod_array_length",
             "tensor_array_to_tensor", "array_to_lod_tensor", "assert")


@pytest.mark.parametrize("op", _STATEFUL)
def test_control_flow_ops_registered_as_in_the_tpu_package(op):
    t, j = TOPS.get(op), JOPS.get(op)
    assert t.stateful and t.no_grad
    assert (t.stateful, t.no_grad, t.attr_defaults) == \
        (j.stateful, j.no_grad, j.attr_defaults)


# --------------------------------------------------- stateful op programs
def _arrays_program(fluid):
    L = fluid.layers
    x = fluid.data("x", shape=[3, 2], dtype="float32",
                   append_batch_size=False)
    zero = L.fill_constant([1], "int64", 0)
    one = L.fill_constant([1], "int64", 1)
    two = L.fill_constant([1], "int64", 2)
    arr = L.array_write(x, zero)
    L.array_write(x * 2.0, one, arr)
    L.array_write(x * 3.0, two, arr)
    back = L.array_read(arr, one)
    n = L.array_length(arr)
    cat, idx = L.tensor_array_to_tensor(arr, axis=1)
    stk, _ = L.tensor_array_to_tensor(arr, axis=0, use_stack=True)
    block = fluid.default_main_program().current_block()
    flat = block.create_var(name="flat", dtype=x.dtype)
    block.append_op(type="array_to_lod_tensor", inputs={"X": [arr]},
                    outputs={"Out": [flat]})
    return [back, n, cat, idx, stk, flat]


def _select_program(fluid):
    L = fluid.layers
    x = fluid.data("x", shape=[3], dtype="float32", append_batch_size=False)
    m = fluid.data("m", shape=[1], dtype="int32", append_batch_size=False)
    a = L.scale(x, scale=2.0)
    b = L.scale(x, scale=-1.0)
    block = fluid.default_main_program().current_block()
    picked = block.create_var(name="picked", dtype=x.dtype)
    block.append_op(type="select_input", inputs={"X": [a, b], "Mask": [m]},
                    outputs={"Out": [picked]})
    o0 = L.fill_constant([3], "float32", -5.0)
    o1 = L.fill_constant([3], "float32", -7.0)
    block.append_op(type="select_output", inputs={"X": [x], "Mask": [m]},
                    outputs={"Out": [o0, o1]})
    return [picked, o0, o1]


def _both_programs(build, feed):
    with jfluid.unique_name.guard():
        jm, js = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(jm, js):
            jf = build(jfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    jout = jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)
    with tfluid.unique_name.guard():
        tm, ts = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(tm, ts):
            tf = build(tfluid)
    texe, tscope = _cpu(), tfluid.Scope()
    texe.run(ts, scope=tscope)
    tout = texe.run(tm, feed=feed, fetch_list=tf, scope=tscope)
    return [np.asarray(o) for o in jout], tout


def test_tensor_array_ops_match_the_tpu_package():
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    jout, tout = _both_programs(_arrays_program, {"x": x})
    for j, t in zip(jout, tout):
        assert t.shape == j.shape and np.array_equal(t, j)
    assert tout[1].tolist() == [3] and tout[3].tolist() == [2, 2, 2]
    assert np.array_equal(tout[2], np.concatenate([x, 2 * x, 3 * x], 1))


@pytest.mark.parametrize("mask", [0, 1])
def test_select_input_and_output_match_the_tpu_package(mask):
    feed = {"x": np.array([1.0, -2.0, 3.0], np.float32),
            "m": np.array([mask], np.int32)}
    jout, tout = _both_programs(_select_program, feed)
    for j, t in zip(jout, tout):
        assert np.array_equal(t, j)
    assert np.array_equal(tout[0], feed["x"] * (2.0 if mask == 0 else -1.0))
    assert np.array_equal(tout[1 + mask], feed["x"])


def test_array_to_lod_tensor_with_a_rank_table_names_a7():
    """The RankTable branch (ROADMAP A7's DynamicRNN slice) joins the
    sequences back in their order with their LoD; an empty array
    raises."""
    op = TOPS.get("array_to_lod_tensor")

    class _Op:
        inputs = {"X": ["a"], "RankTable": ["t"]}

        def input(self, slot):
            return self.inputs.get(slot, [])

    scope = tfluid.Scope()
    scope.var("t").set_value(tcore.LoDRankTable([(1, 2), (0, 1)]))
    with pytest.raises(ValueError, match="empty array"):
        op.kernel({}, {"_op": _Op(), "_scope": scope})
    arr = scope.var("a").get_lod_tensor_array()
    arr.append(tfluid.LoDTensor(torch.tensor([[1.0], [2.0]])))
    arr.append(tfluid.LoDTensor(torch.tensor([[3.0]])))
    out = op.kernel({}, {"_op": _Op(), "_scope": scope})
    assert out["_lod"] == {"Out": [((0, 1, 3),)]}
    assert out["Out"][0].reshape(-1).tolist() == [2.0, 1.0, 3.0]


def test_assert_raises_on_a_false_condition():
    def build(fluid):
        x = fluid.data("x", shape=[2], dtype="float32",
                       append_batch_size=False)
        fluid.layers.Assert(fluid.layers.reduce_sum(x) > 0.0, data=[x])
        return [fluid.layers.scale(x, scale=2.0)]
    out, _, _ = _run(build, {"x": np.ones(2, np.float32)}, "compiled", 1)
    assert np.array_equal(out[0][0], np.full(2, 2.0, np.float32))
    with pytest.raises(AssertionError, match="Assert failed"):
        _run(build, {"x": -np.ones(2, np.float32)}, "compiled", 1)


def test_is_empty_is_pure_and_on_the_device_of_x():
    t = TOPS.get("is_empty").kernel({"X": [torch.zeros(0, 3)]}, {})["Out"][0]
    assert t.tolist() == [True] and t.dtype == torch.bool
    assert texecutor._whole_compilable([]) is True


# ---------------------------------- the TPU package's control-flow tests
def _while_doubling(fluid):
    x = fluid.data("x", shape=[4], dtype="float32", append_batch_size=False)
    limit = fluid.layers.fill_constant([1], "float32", 100.0)
    (out,) = fluid.layers.while_loop(
        lambda v: fluid.layers.reduce_sum(v) < limit, lambda v: v * 2.0, [x])
    return [out]


def test_static_while_compiles():
    """tests/test_dygraph_to_static.py:192: the while is compilable (the
    TPU package lowers it to lax.while_loop); here the block runs
    segmented, the loop's body as its own compiled plan, iterated from the
    host."""
    with tfluid.unique_name.guard():
        main, _, _ = _build_in(tfluid, _while_doubling)
    ops = main.global_block().ops
    assert texecutor._ops_compilable(ops)
    assert not texecutor._whole_compilable(ops)
    out, exe, _ = _run(_while_doubling, {"x": np.ones(4, np.float32)},
                       "compiled", 1, min_ops=1)
    np.testing.assert_allclose(out[0][0], np.full(4, 32.0), rtol=1e-6)
    blk = exe._last_block
    assert exe._last_run_mode == "segmented"
    assert [s.kind for s in blk.segments] == ["compiled", "loop"]
    assert blk.loop_stats["iterations"] == 5 and blk.stats["islands"] == 0


def _build_in(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fetch = build(fluid)
    return main, startup, fetch


def _cond_program(fluid):
    x = fluid.data("x", shape=[3], dtype="float32", append_batch_size=False)
    pred = fluid.layers.reduce_sum(x) > 0.0
    return [fluid.layers.cond(pred, lambda: x * 2.0, lambda: x - 1.0)]


def test_static_cond_compiles():
    """tests/test_dygraph_to_static.py:221: a cond of two pure branches
    is one compiled step (both branches, selected on the device)."""
    with tfluid.unique_name.guard():
        main, _, _ = _build_in(tfluid, _cond_program)
    assert texecutor._whole_compilable(main.global_block().ops)
    feeds = [{"x": np.ones(3, np.float32)}, {"x": -np.ones(3, np.float32)}]
    got, exe, _ = _run(_cond_program, feeds, "compiled")
    assert exe._last_run_mode == "compiled"
    np.testing.assert_allclose(got[0][0], np.full(3, 2.0), rtol=1e-6)
    np.testing.assert_allclose(got[1][0], np.full(3, -2.0), rtol=1e-6)
    want, _, _ = _run(_cond_program, feeds, "interpreted")
    _bitwise(got, want)


def _outer_write_program(fluid):
    from_layers = fluid.layers
    x = fluid.data("x", shape=[2], dtype="float32", append_batch_size=False)
    acc = from_layers.fill_constant([2], "float32", 7.0)
    pred = from_layers.reduce_sum(x) > 0.0

    def t_fn():
        from_layers.assign(x * 10.0, acc)
        return x

    def f_fn():
        from_layers.assign(x * -1.0, acc)
        return x
    from_layers.cond(pred, t_fn, f_fn)
    return [acc]


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cond_branch_write_to_outer_var_masked(sign):
    """tests/test_dygraph_to_static.py:241: the untaken branch's write to
    an outer var does not land."""
    feed = {"x": np.full(2, sign, np.float32)}
    got, exe = _compiled_vs_interpreted(_outer_write_program, feed, runs=2)
    assert exe._last_run_mode == "compiled"
    want = 10.0 if sign > 0 else 1.0
    np.testing.assert_allclose(got[0][0], np.full(2, want), rtol=1e-6)


def _while_dropout(fluid):
    L = fluid.layers
    x = fluid.data("x", shape=[1000], dtype="float32",
                   append_batch_size=False)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 2)
    acc = L.fill_constant([1000], "float32", 0.0)

    def body(i, acc):
        d = L.dropout(x, dropout_prob=0.5)
        return i + 1, L.elementwise_add(acc, d)
    _, acc_out = L.while_loop(lambda i, acc: i < n, body, [i, acc])
    return [acc_out]


def test_while_loop_rng_differs_per_iteration():
    """tests/test_dygraph_to_static.py:266: a dropout in a while body
    draws a new mask each iteration (its key folds in the iteration), on
    the compiled loop and in the interpreter alike."""
    feed = {"x": np.ones(1000, np.float32)}
    got, exe = _compiled_vs_interpreted(_while_dropout, feed, runs=3,
                                        min_ops=1)
    assert exe._last_run_mode == "segmented"
    for run in got:
        assert len(np.unique(np.round(run[0], 4))) >= 3
    assert not np.array_equal(got[0][0], got[1][0])  # and each step


def _rng_cond_program(with_dropout):
    def build(fluid):
        x = fluid.data("x", shape=[4], dtype="float32")
        pred = fluid.data("p", shape=[1], dtype="bool")

        def fbranch():
            h = fluid.layers.dropout(x, 0.5) if with_dropout else x
            return fluid.layers.scale(h, scale=-1.0)
        return [fluid.layers.cond(
            pred, lambda: fluid.layers.scale(x, scale=2.0), fbranch)]
    return build


@pytest.mark.parametrize("min_ops", [1, 100])
def test_rng_in_cond_routes_away_from_the_whole_compiled_step(min_ops):
    """tests/test_backward_executor.py:515: a random op in a branch would
    draw in the untaken branch under the both-branch lowering, so the
    block is not compiled whole: it runs segmented (its conditionals as
    islands) or, below FLAGS_executor_seg_min_ops, interpreted, and the
    taken branch is exact."""
    with tfluid.unique_name.guard():
        main, _, _ = _build_in(tfluid, _rng_cond_program(True))
    assert not texecutor._ops_compilable(main.global_block().ops)
    with tfluid.unique_name.guard():
        mainc, _, _ = _build_in(tfluid, _rng_cond_program(False))
    assert texecutor._whole_compilable(mainc.global_block().ops)
    X = np.arange(8, dtype="float32").reshape(2, 4)
    feed = {"x": X, "p": np.array([True])}
    got, exe = _compiled_vs_interpreted(_rng_cond_program(True), feed,
                                        runs=2, min_ops=min_ops)
    np.testing.assert_allclose(got[0][0], 2 * X)
    assert exe._last_run_mode == ("segmented" if min_ops == 1
                                  else "interpreted")
    for cb in exe._compiled_cache.values():  # the startup's fetches none
        assert not cb.fetch_names or type(cb) is not texecutor._CompiledBlock
    if min_ops == 1:
        assert [op.type for s in exe._last_block.segments
                if s.kind == "island" for op in s.ops] == [
            "conditional_block", "conditional_block", "select_input"]
    # the false branch taken: its dropout keeps or zeroes each element
    got, _ = _compiled_vs_interpreted(
        _rng_cond_program(True), {"x": X, "p": np.array([False])}, runs=2,
        min_ops=min_ops)
    assert np.all((got[0][0] == 0) | (got[0][0] == -X))


# ------------------------------------------------ case, switch, nesting
def _case_program(fluid):
    L = fluid.layers
    x = fluid.data("x", shape=[3], dtype="float32", append_batch_size=False)
    k = fluid.data("k", shape=[1], dtype="int64", append_batch_size=False)
    one = L.fill_constant([1], "int64", 1)
    two = L.fill_constant([1], "int64", 2)
    a = L.case([(L.less_than(k, one), lambda: x * 2.0),
                (L.less_than(k, two), lambda: x * 3.0)],
               default=lambda: x * 4.0)
    b = L.switch_case(k, {0: lambda: x + 1.0, 1: lambda: x + 2.0},
                      default=lambda: x + 3.0)
    return [a, b]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_case_and_switch_case_three_branches(k):
    x = np.array([1.0, -2.0, 0.5], np.float32)
    feed = {"x": x, "k": np.array([k], np.int64)}
    got, exe = _compiled_vs_interpreted(_case_program, feed, runs=2)
    assert exe._last_run_mode == "compiled"
    np.testing.assert_allclose(got[0][0], x * (2.0, 3.0, 4.0)[k])
    np.testing.assert_allclose(got[0][1], x + (1.0, 2.0, 3.0)[k])
    jout, tout = _both_programs(_case_program, feed)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, rtol=1e-6)


def _nested_switch(fluid):
    L = fluid.layers
    k = fluid.data("k", shape=[1], dtype="int64", append_batch_size=False)
    out = L.create_global_var([1], 0.0, "float32", persistable=True,
                              name="picked")
    c1 = L.fill_constant([1], "int64", 1)
    c3 = L.fill_constant([1], "int64", 3)
    with L.Switch() as outer:
        with outer.case(L.less_than(k, c3)):
            with L.Switch() as inner:
                with inner.case(L.less_than(k, c1)):
                    L.assign(L.fill_constant([1], "float32", 10.0), out)
                with inner.default():
                    L.assign(L.fill_constant([1], "float32", 20.0), out)
        with outer.default():
            L.assign(L.fill_constant([1], "float32", 30.0), out)
    return [out]


@pytest.mark.parametrize("k,want", [(0, 10.0), (2, 20.0), (5, 30.0)])
def test_nested_switch(k, want):
    feed = {"k": np.array([k], np.int64)}
    got, exe = _compiled_vs_interpreted(_nested_switch, feed, runs=2)
    assert exe._last_run_mode == "compiled"
    assert got[0][0].tolist() == [want]
    # a clone remaps every sub_block attr, the nested ones too, and runs
    # the same
    main = exe._last_block.program
    clone = main.clone(for_test=True)
    subs = [(b.idx, op.attrs["sub_block"].idx) for b in clone.blocks
            for op in b.ops if "sub_block" in op.attrs]
    assert len(subs) == 4 and (1, 2) in subs  # the inner Switch's
    for b in clone.blocks:
        for op in b.ops:
            if "sub_block" in op.attrs:
                assert op.attrs["sub_block"] is clone.block(
                    op.attrs["sub_block"].idx)
    out = exe.run(clone, feed=feed, fetch_list=list(
        exe._last_block.fetch_names), scope=exe.scope)
    assert out[0].tolist() == [want]


def _switch_without_default(fluid):
    L = fluid.layers
    k = fluid.data("k", shape=[1], dtype="int64", append_batch_size=False)
    out = L.create_global_var([1], 5.0, "float32", persistable=True,
                              name="kept")
    with L.Switch() as s:
        with s.case(L.less_than(k, L.fill_constant([1], "int64", 0))):
            L.assign(L.fill_constant([1], "float32", -1.0), out)
    return [out]


def test_switch_without_a_taken_case_keeps_the_persistable():
    """A conditional write to a var the scope holds keeps its value when
    no case holds: the compiled step reads it as state and selects."""
    got, exe = _compiled_vs_interpreted(
        _switch_without_default, {"k": np.array([3], np.int64)}, runs=2)
    assert exe._last_run_mode == "compiled"
    assert [n for n in exe._last_block.mut_state if n.startswith("kept")]
    assert got[1][0].tolist() == [5.0]


def _assign_numpy_switch(fluid):
    L = fluid.layers
    step = L.autoincreased_step_counter(counter_name="@LR_DECAY_COUNTER@",
                                        begin=0, step=1)
    lr = L.create_global_var([1], 0.5, "float32", persistable=True,
                             name="hand_lr")
    with L.Switch() as s:
        with s.case(L.less_than(step, L.fill_constant([1], "int64", 2))):
            L.assign(np.array([0.25], np.float32), lr)
        with s.default():
            L.assign(np.array([0.125], np.float32), lr)
    return [lr]


def test_switch_case_assigning_a_numpy_constant(monkeypatch):
    """``assign(numpy, lr)`` in a Switch case (a schedule written by hand):
    compiled equals the interpreter, and once the plan is bound the step
    makes no constant from host data (under a CUDA graph that copy could
    not be captured): the constant is bound on the device and copied."""
    got, exe = _compiled_vs_interpreted(_assign_numpy_switch, {}, runs=4)
    assert [g[0].tolist() for g in got] == [[0.25], [0.25], [0.125],
                                            [0.125]]
    cb = exe._last_block
    consts = [st for u in cb._units if isinstance(u, texecutor._CondStep)
              for st in u.steps if "_const" in st.attrs]
    assert len(consts) == 2

    def no_host_tensor(*a, **k):
        raise AssertionError("the compiled step made the constant from "
                             "host data")
    from paddle_tpu_torch.ops import tensor_ops
    tcore.set_flag("FLAGS_executor_mode", "compiled")
    monkeypatch.setattr(tensor_ops, "assign_value_tensor", no_host_tensor)
    out = exe.run(cb.program, feed={}, fetch_list=list(cb.fetch_names),
                  scope=exe.scope)
    assert out[0].tolist() == [0.125] and exe._last_block is cb


# ------------------------------------------------------ tensor-array loop
def _while_arrays(fluid):
    L = fluid.layers
    x = fluid.data("x", shape=[3], dtype="float32", append_batch_size=False)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 4)
    arr = L.create_array("float32")
    c = L.less_than(i, n)
    w = L.While(c)
    with w.block():
        y = L.scale(x, scale=2.0) * L.cast(i, "float32")
        L.array_write(y, i, arr)
        L.increment(i)
        L.less_than(i, n, cond=c)
    t, idx = L.tensor_array_to_tensor(arr, axis=0)
    return [t, idx, L.array_length(arr)]


@pytest.mark.parametrize("min_ops", [1, 100])
def test_while_with_tensor_arrays(min_ops):
    """A body that writes an array each iteration is stateful: its while
    runs in the interpreter (an island of the segmented step, or the
    whole block interpreted), equal to the interpreter and to the TPU
    package."""
    x = np.array([1.0, 2.0, 3.0], np.float32)
    got, exe = _compiled_vs_interpreted(_while_arrays, {"x": x}, runs=2,
                                        min_ops=min_ops)
    want = np.concatenate([2 * x * k for k in range(4)])
    assert np.array_equal(got[0][0], want)
    assert got[0][1].tolist() == [3] * 4 and got[0][2].tolist() == [4]
    jout, tout = _both_programs(_while_arrays, {"x": x})
    for j, t in zip(jout, tout):
        assert np.array_equal(t, j)


# -------------------------------------- the shared encoder layer in a loop
H, HEADS, FFN, SEQ, BATCH, TRIPS = 64, 2, 128, 16, 2, 3


def _shared_encoder(dropout):
    def build(fluid):
        bert = tbert if fluid is tfluid else jbert
        L = fluid.layers
        x = fluid.data("x", shape=[SEQ, H], dtype="float32")
        mask = fluid.data("input_mask", shape=[SEQ], dtype="float32")
        bias = bert.padding_attn_bias(mask)
        h = L.assign(x)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", TRIPS)

        def body(i, h):
            return (L.increment(i, in_place=False),
                    bert.encoder_layer(h, H, HEADS, FFN, dropout,
                                       attn_bias=bias))
        _, out = L.while_loop(lambda i, h: L.less_than(i, n), body, [i, h])
        return [out]
    return build


def _encoder_feed(seed=0):
    r = np.random.RandomState(seed)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[1, 9:] = 0.0
    return {"x": r.randn(BATCH, SEQ, H).astype(np.float32),
            "input_mask": mask}


def test_shared_encoder_while_matches_the_tpu_package():
    """One encoder layer applied 3 times in a while_loop, its parameters
    made once: the TPU package (lax.while_loop over its plain attention)
    and the port from the same numpy parameters agree at the serve parity
    tests' rtol = atol = 1e-4."""
    from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
    build = _shared_encoder(0.0)
    with jfluid.unique_name.guard():
        jm, js, jf = _build_in(jfluid, build)
    with tfluid.unique_name.guard():
        tm, ts, tf = _build_in(tfluid, build)
    assert len(tm.all_parameters()) == 16
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
              for v in jm.global_block().vars.values() if v.persistable}
    texe, tscope = _cpu(), tfluid.Scope()
    texe.run(ts, scope=tscope)
    set_params_from_numpy(tscope, arrays)
    tcore.set_flag("FLAGS_executor_mode", "compiled")
    feed = _encoder_feed()
    jout, = jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)
    assert jexecutor._ops_compilable(jm.global_block().ops)
    tout, = texe.run(tm, feed=feed, fetch_list=tf, scope=tscope)
    assert texe._last_run_mode == "segmented"
    assert texe._last_block.last_iterations == {
        s.start: TRIPS for s in texe._last_block.segments
        if s.kind == "loop"}
    np.testing.assert_allclose(tout, np.asarray(jout), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_shared_encoder_while_compiled_equals_interpreted(dropout):
    feeds = [_encoder_feed(s) for s in range(3)]
    got, exe = _compiled_vs_interpreted(_shared_encoder(dropout), feeds)
    assert exe._last_run_mode == "segmented"
    assert exe._last_block.loop_stats["iterations"] == 3 * TRIPS


# ------------------------------------------------ the GPU loop, rehearsed
class _FakeGraph:
    """A CUDA graph on the CPU: its first replay is skipped (the fake
    capture ran the work already), every later one calls ``fn``."""

    def __init__(self):
        self.fn = None
        self.first = True

    def replay(self):
        if self.first:
            self.first = False
        elif self.fn is not None:
            self.fn()


def test_loop_schedule_rehearsed_with_a_fake_graph(monkeypatch):
    """The GPU's schedule of a segmented block with a compiled loop: an
    eager warm-up, then the compiled segment captured and the loop body
    captured at its first iteration and replayed each iteration, the
    carried values through the body's static buffers; bitwise the
    interpreter's, with dropout in the body."""
    real_capture = texecutor._SegmentedBlock._capture_segment
    real_compute = texecutor._SegmentedBlock._seg_compute
    real_body = texecutor._SegmentedBlock._capture_body

    def capture(self, seg, plan, env, stable, rt):
        seen = {n: env[n] for n in seg.in_names if n in env}
        outs, flag = real_capture(self, seg, plan, env, stable, rt)
        graph, static_in, captured, _ = rt[plan.key]
        inputs = dict(seen, **static_in)

        def replay():
            o, _ = real_compute(self, seg, plan, inputs)
            for n, t in captured.items():
                t.copy_(o[n])
        graph.fn = replay
        return outs, flag

    def capture_body(self, lp):
        real_body(self, lp)
        captured = dict(lp.gouts)

        def replay():
            local = dict(lp.inplace)
            local.update(lp.bufs)
            new = texecutor._SegmentedBlock._body_pass(lp, local)
            for k, t in captured.items():
                t.copy_(new[k])
        lp.graph.fn = replay

    def run_on_stream(self, scope, feeds, return_numpy=True):
        fetched, self.last_health = self._run_on_stream(scope, feeds)
        return [t.clone().numpy() for t in fetched]

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(texecutor._SegmentedBlock, "_capture_segment",
                        capture)
    monkeypatch.setattr(texecutor._SegmentedBlock, "_capture_body",
                        capture_body)
    monkeypatch.setattr(texecutor._SegmentedBlock, "run", run_on_stream)
    monkeypatch.setattr(texecutor.Executor, "_stream", "fake",
                        raising=False)

    feeds = [_encoder_feed(s) for s in range(4)]
    build = _shared_encoder(0.1)
    tcore.set_flag("FLAGS_executor_mode", "compiled")
    with tfluid.unique_name.guard():
        main, startup, fetch = _build_in(tfluid, build)
    main.random_seed = startup.random_seed = 7
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(startup, scope=scope)
    exe._stream = "fake"
    got, execs = [], []
    for f in feeds:
        got.append(exe.run(main, feed=f, fetch_list=fetch, scope=scope))
        execs.append(exe._last_block.last_exec)
    sb = exe._last_block
    assert execs == ["eager", "capture", "replay", "replay"]
    assert sb.loop_stats == {"iterations": 4 * TRIPS,
                             "body_replays": 3 * TRIPS,
                             "body_captures": 1}
    want, _, _ = _run(build, feeds, "interpreted")
    _bitwise(got, want)


# ------------------------------------------------------ ProgramDesc bytes
def _switch_and_while(fluid):
    L = fluid.layers
    lr = L.linear_lr_warmup(L.piecewise_decay([3, 6], [0.1, 0.01, 0.001]),
                            2, 0.0, 0.1)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    acc = L.fill_constant([1], "float32", 0.0)
    _, acc = L.while_loop(lambda i, a: L.less_than(i, n),
                          lambda i, a: (i + 1, a + lr), [i, acc])
    c = L.cond(L.reduce_sum(acc) > 0.1, lambda: acc * 2.0, lambda: acc)
    return [lr, c]


def test_program_desc_bytes_equal_the_tpu_packages():
    with jfluid.unique_name.guard():
        jm, js, _ = _build_in(jfluid, _switch_and_while)
    with tfluid.unique_name.guard():
        tm, ts, _ = _build_in(tfluid, _switch_and_while)
    assert tm.num_blocks == jm.num_blocks == 9
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    back = tfluid.Program.parse_from_string(tm.serialize_to_string())
    assert back.serialize_to_string() == tm.serialize_to_string()
    clone = tm.clone(for_test=True)
    for b, cb in zip(tm.blocks, clone.blocks):
        for op, cop in zip(b.ops, cb.ops):
            sub = op.attrs.get("sub_block")
            if sub is not None:
                assert cop.attrs["sub_block"] is clone.block(sub.idx)


def test_prune_keeps_a_conditional_a_target_needs():
    with tfluid.unique_name.guard():
        tm, ts, (lr, c) = _build_in(tfluid, _switch_and_while)
    pruned = tm._prune([lr])
    types = [op.type for op in pruned.global_block().ops]
    assert types.count("conditional_block") == 5 and "while" not in types
    exe, scope = _cpu(), tfluid.Scope()
    exe.run(ts, scope=scope)
    got = [exe.run(pruned, fetch_list=[lr], scope=scope)[0].tolist()
           for _ in range(4)]
    assert exe._last_run_mode == "compiled"
    assert got == [[0.0], [np.float32(0.05)], [np.float32(0.1)],
                   [np.float32(0.01)]]
