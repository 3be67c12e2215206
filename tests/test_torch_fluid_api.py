"""The fluid-level names and the twelve layers over registered ops of the
port (paddle_tpu_torch/fluid/__init__.py, framework.py, core.py,
param_attr.py, layers/, debugger.py, install_check.py) against the TPU
package's (paddle_tpu/fluid/__init__.py:76-169, framework.py:105-110,
core.py:43-149, :300, :447, param_attr.py:61, layers/):

- each name builds the TPU package's ops and attrs (one_hot, embedding,
  the twelve layers: the same op types, slots and public attrs on the
  same program), and the layers that compute deterministically give the
  TPU package's outputs on the same seeded inputs (rtol 1e-6, atol 1e-6;
  gelu at 1e-5, the erf of each package);
- set_flags/get_flags, require_version, load_op_library, in_dygraph_mode,
  name_scope, device_guard, CUDAPinnedPlace, SelectedRows, the typed
  errors and WeightNormParamAttr behave as the TPU package's;
- ``fluid.__all__`` holds every name of the TPU package's but those
  that wait on ROADMAP A7 (dygraph), A8 and A9;
- the debugger prints the TPU package's text for the same program, and
  ``install_check.run_check`` trains its model one step on the CPU.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid import debugger as jdebugger
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import debugger as tdebugger
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy

# the names of paddle_tpu.fluid.__all__ the port does not have yet, with
# the ROADMAP item that brings each
WAITING = {"dygraph": "A7", "tpu_places": "A8", "memory_optimize": "A8",
           "release_memory": "A8", "profiler": "A9", "telemetry": "A9",
           "transpiler": "A9", "DistributeTranspiler": "A9",
           "DistributeTranspilerConfig": "A9", "Communicator": "A9"}
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _fresh_tmp_names(monkeypatch):
    """Both packages name temporaries from a process-wide counter that
    ``unique_name.guard`` does not reset: start both from zero."""
    from paddle_tpu.fluid import unique_name as jnames
    from paddle_tpu_torch.fluid import unique_name as tnames
    for m in (jnames, tnames):
        monkeypatch.setattr(m, "dygraph_parameter_name_generator",
                            m.UniqueNameGenerator())


def _ops(program):
    return [(op.type, dict(op.inputs), dict(op.outputs),
             {k: v for k, v in op.attrs.items() if not k.startswith("_")})
            for op in program.global_block().ops]


def _build(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        out = build(fluid)
    return main, startup, out


def _x(f, name="x", shape=(6,), dtype="float32"):
    return f.data(name, shape=list(shape), dtype=dtype)


# name → (build(fluid) → output var, feed from a RandomState, tolerance or
# None when the output is random)
LAYERS = {
    "gelu": (lambda f: f.layers.gelu(_x(f)),
             lambda r: {"x": r.randn(3, 6).astype(np.float32)},
             dict(rtol=1e-5, atol=1e-6)),
    "gelu_approximate": (lambda f: f.layers.gelu(_x(f), approximate=True),
                         lambda r: {"x": r.randn(3, 6).astype(np.float32)},
                         dict(rtol=1e-5, atol=1e-6)),
    "mul": (lambda f: f.layers.mul(_x(f, shape=(2, 3)),
                                   _x(f, "y", (6, 4)), x_num_col_dims=1),
            lambda r: {"x": r.randn(5, 2, 3).astype(np.float32),
                       "y": r.randn(2, 6, 4).astype(np.float32)[0]},
            dict(rtol=1e-5, atol=1e-6)),
    "sum": (lambda f: f.layers.sum([_x(f), _x(f, "y")]),
            lambda r: {"x": r.randn(3, 6).astype(np.float32),
                       "y": r.randn(3, 6).astype(np.float32)}, TOL),
    "sum_one": (lambda f: f.layers.sum(_x(f)),
                lambda r: {"x": r.randn(3, 6).astype(np.float32)}, TOL),
    "reduce_max": (lambda f: f.layers.reduce_max(_x(f), dim=1),
                   lambda r: {"x": r.randn(3, 6).astype(np.float32)}, TOL),
    "reduce_min": (lambda f: f.layers.reduce_min(_x(f), dim=[1],
                                                  keep_dim=True),
                   lambda r: {"x": r.randn(3, 6).astype(np.float32)}, TOL),
    "reduce_prod": (lambda f: f.layers.reduce_prod(_x(f)),
                    lambda r: {"x": r.rand(3, 6).astype(np.float32) + 0.5},
                    dict(rtol=1e-5, atol=1e-6)),
    "reduce_all": (lambda f: f.layers.reduce_all(_x(f, dtype="bool"),
                                                 dim=1),
                   lambda r: {"x": r.rand(3, 6) > 0.2}, TOL),
    "reduce_any": (lambda f: f.layers.reduce_any(_x(f, dtype="bool")),
                   lambda r: {"x": r.rand(3, 6) > 0.9}, TOL),
    "isfinite": (lambda f: f.layers.isfinite(_x(f)),
                 lambda r: {"x": np.where(r.rand(3, 6) > 0.9, np.inf,
                                          1.0).astype(np.float32)}, TOL),
    "uniform_random": (lambda f: f.layers.uniform_random(
        [4, 5], min=-2.0, max=3.0, seed=7), lambda r: {}, None),
    "gaussian_random": (lambda f: f.layers.gaussian_random(
        [4, 5], mean=1.0, std=2.0, seed=7), lambda r: {}, None),
    "one_hot": (lambda f: f.one_hot(_x(f, shape=(4,), dtype="int64"), 7),
                lambda r: {"x": r.randint(0, 7, (3, 4)).astype(np.int64)},
                TOL),
    "embedding": (lambda f: f.embedding(
        _x(f, shape=(4,), dtype="int64"), size=[11, 5], padding_idx=-1,
        param_attr=f.ParamAttr(name="emb_w")),
        lambda r: {"x": r.randint(0, 11, (3, 4)).astype(np.int64)}, TOL),
}


def _run_jax(main, startup, feed, out):
    scope = jcore.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor()
        exe.run(startup)
        res = np.asarray(exe.run(main, feed=feed, fetch_list=[out])[0])
        params = {v.name: np.asarray(scope.find_var(v.name).get_tensor()
                                     .array)
                  for v in main.list_vars() if v.persistable
                  and scope.find_var(v.name) is not None}
    return res, params


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_and_runs_as_the_tpu_package(name):
    build, feed_of, tol = LAYERS[name]
    tm, ts, tout = _build(tfluid, build)
    jm, js, jout = _build(jfluid, build)
    assert _ops(tm) == _ops(jm)
    assert _ops(ts) == _ops(js)
    assert tout.name == jout.name
    assert tuple(tout.shape) == tuple(jout.shape)
    feed = feed_of(np.random.RandomState(len(name)))
    want, params = _run_jax(jm, js, feed, jout.name)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    set_params_from_numpy(scope, params)
    got = exe.run(tm, feed=feed, fetch_list=[tout.name], scope=scope)[0]
    assert got.shape == want.shape and got.dtype == want.dtype
    if tol is not None:
        np.testing.assert_allclose(got, want, **tol)
    elif name == "uniform_random":
        assert got.min() >= -2.0 and got.max() < 3.0
    else:
        assert abs(float(got.mean()) - 1.0) < 2.0


def test_array_to_lod_tensor_joins_an_array_and_refuses_a_rank_table():
    def build(f, table):
        arr = f.layers.create_array("float32")
        for i in range(3):
            idx = f.layers.fill_constant([1], "int64", i)
            f.layers.array_write(f.layers.fill_constant([2, 3], "float32",
                                                        float(i)), idx, arr)
        if table:
            x = f.layers.data("seq", shape=[1], dtype="float32",
                              lod_level=1)
            return f.layers.array_to_lod_tensor(
                arr, f.layers.lod_rank_table(x)), arr
        return f.layers.array_to_lod_tensor(arr, None), arr
    tm, ts, (out, _) = _build(tfluid, lambda f: build(f, False))
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    got = exe.run(tm, fetch_list=[out], scope=scope)[0]
    np.testing.assert_array_equal(got, np.repeat([0.0, 1.0, 2.0], 2)[
        :, None].repeat(3, 1).astype(np.float32))
    # with a rank table: the same op and slots as the TPU package's layer,
    # which the port's op refuses at run time
    jm, _, (jout, jarr) = _build(jfluid, lambda f: build(f, True))
    (jop,) = [op for op in jm.global_block().ops
              if op.type == "array_to_lod_tensor"]
    tm, ts = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(tm, ts):
        _, arr = build(tfluid, False)
        table = tm.global_block().create_var(
            name="rank_table", type=tcore.VarDesc.VarType.LOD_RANK_TABLE,
            persistable=True)
        out = tfluid.layers.array_to_lod_tensor(arr, table)
    top = tm.global_block().ops[-1]
    assert top.type == jop.type and sorted(top.inputs) == sorted(jop.inputs)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    scope.var("rank_table").set_value(tcore.LoDTensor(torch.zeros(1)))
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        exe.run(tm, fetch_list=[out], scope=scope)


def test_flags_round_trip_as_the_tpu_package():
    name = "FLAGS_executor_seg_min_ops"
    for fluid in (tfluid, jfluid):
        old = fluid.get_flags(name)[name]
        fluid.set_flags({name: old + 3})
        assert fluid.get_flags([name]) == {name: old + 3}
        assert fluid.get_flags(name) == {name: old + 3}
        fluid.set_flags({name: old})
    with pytest.raises(KeyError):
        tfluid.set_flags({"FLAGS_not_a_flag": 1})


def test_version_and_library_names():
    for fluid in (tfluid, jfluid):
        fluid.require_version("1.6.0")
        fluid.require_version("1.7.0", "1.7.9")
        with pytest.raises(Exception, match="required"):
            fluid.require_version("2.0.0")
        with pytest.raises(TypeError):
            fluid.require_version(1.6)
        with pytest.raises(NotImplementedError, match="register_op"):
            fluid.load_op_library("custom.so")
        assert fluid.in_dygraph_mode() is False


def test_name_scope_and_device_guard_change_no_op():
    def build(f):
        x = _x(f)
        with f.name_scope("block1"), f.device_guard("gpu"):
            return f.layers.relu(x)
    tm, _, _ = _build(tfluid, build)
    jm, _, _ = _build(jfluid, build)
    assert _ops(tm) == _ops(jm)


def test_places_selected_rows_and_errors():
    assert isinstance(tfluid.CUDAPinnedPlace(), tfluid.CPUPlace)
    assert repr(tfluid.CUDAPinnedPlace()) == repr(jfluid.CUDAPinnedPlace())
    assert tfluid.CUDAPinnedPlace().torch_device() == torch.device("cpu")
    rows, height = [3, 0, 3, 5], 7
    vals = np.random.RandomState(1).randn(4, 2).astype(np.float32)
    t, j = tcore.SelectedRows(rows, height), jcore.SelectedRows(rows, height)
    t.get_tensor().set(vals, tfluid.CPUPlace())
    j.get_tensor().set(vals)
    np.testing.assert_allclose(t.to_dense().numpy(),
                               np.asarray(j.to_dense()), rtol=1e-6)
    assert (t.rows(), t.height(), repr(t)) == (j.rows(), j.height(), repr(j))
    for name in ("EOFException", "CheckpointError", "NumericFaultError",
                 "WorkerDeadError", "RpcProtocolError", "SpillCorruptionError",
                 "StaleClusterViewError", "DeadlineExceededError",
                 "OverloadedError", "CircuitOpenError"):
        tcls, jcls = getattr(tcore, name), getattr(jcore, name)
        assert [b.__name__ for b in tcls.__mro__] \
            == [b.__name__ for b in jcls.__mro__], name
    assert tcore.StaleClusterViewError("m", {"v": 1}).view_dict == {"v": 1}
    assert tcore.OverloadedError("m", 2).retry_after_s == 2.0
    assert tcore.DeadlineExceededError("m", 0.5).queue_wait_s == 0.5
    w = tfluid.WeightNormParamAttr(dim=1, name="wn")
    jw = jfluid.WeightNormParamAttr(dim=1, name="wn")
    assert (w.dim, w.name) == (jw.dim, jw.name)
    assert isinstance(w, tfluid.ParamAttr)


def test_fluid_names_cover_the_tpu_package():
    missing = set(jfluid.__all__) - set(tfluid.__all__)
    assert missing == set(WAITING)
    for n in tfluid.__all__:
        assert hasattr(tfluid, n), n
    for n in ("compiler", "metrics", "average", "debugger", "install_check",
              "CompiledProgram", "BuildStrategy", "ExecutionStrategy",
              "LoDTensorArray", "Tensor"):
        assert hasattr(tfluid, n), n


def test_debugger_prints_the_tpu_package_text(capsys):
    def build(f):
        x = _x(f)
        loss = f.layers.mean(f.layers.fc(x, 3, act="relu"))
        f.optimizer.SGD(0.1).minimize(loss)
        return loss
    tm, _, _ = _build(tfluid, build)
    jm, _, _ = _build(jfluid, build)
    for show in (False, True):
        assert tdebugger.pprint_program_codes(tm, show) \
            == jdebugger.pprint_program_codes(jm, show)
    assert "= mul(" in capsys.readouterr().out


def test_install_check_runs_on_the_cpu(capsys):
    loss = tfluid.install_check.run_check(tfluid.CPUPlace())
    assert np.all(np.isfinite(loss))
    assert "installed successfully" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tfluid.install_check.run_check()
