"""The compiled executor step of paddle_tpu_torch (``_CompiledBlock``) on
the CPU, where it runs its plan eagerly (the CUDA graph over the plan
runs only on the card: ``python3 chip_smoke.py``).

- Compiled against interpreted, the port's oracle: the small-config BERT
  pretraining step and an MLP with SGD, 3 steps at dropout 0.1: losses,
  dropout masks and updated parameters bitwise equal (the TPU package's
  tests/test_backward_executor.py:127 holds its two paths to rtol 1e-5;
  here both run the same torch kernels in the same order, so equality is
  exact).
- Compiled against the TPU package's compiled path at dropout 0: the
  golden encoder trajectories (SGD and Adam) at rtol 1e-4 and atol 1e-5
  (tests/test_book_models.py:399-418), and two Adam steps of the
  small-config BERT step from the same numpy parameters (losses at
  rtol = atol = 1e-5, the tolerance of test_torch_train_slice.py).
- The contracts: state classification errors, intermediates absent from
  the scope but fetchable, the cache key, a replaced state var, the mode
  flag, per-step dropout masks, routing of a block with a host read, what
  the compiled step refuses (a window's LoD fetch; an unknown NaN guard
  action),
  the routing cache, and a compiled step with JAX blocked from the
  process.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import rng as trng
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import resolve_base_info

from test_torch_train_slice import (_build_pretrain, _pretrain_feed,
                                    _run_encoder_golden)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def mode():
    """Set FLAGS_executor_mode for one test and restore the default."""
    def set_mode(m):
        tcore.set_flag("FLAGS_executor_mode", m)
    yield set_mode
    tcore.set_flag("FLAGS_executor_mode", "compiled")


def _mlp(dropout=0.1, lr=0.1):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.data("x", [8])
        y = tfluid.data("y", [1], dtype="int64")
        h = tfluid.layers.fc(x, 16, act="gelu")
        h = tfluid.layers.dropout(h, dropout,
                                  dropout_implementation="upscale_in_train")
        logits = tfluid.layers.fc(h, 4)
        loss = tfluid.layers.mean(
            tfluid.layers.softmax_with_cross_entropy(logits, y))
        tfluid.optimizer.SGD(lr).minimize(loss)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss


def _mlp_feed(step, batch=6):
    r = np.random.RandomState(100 + step)
    return {"x": r.normal(size=(batch, 8)).astype(np.float32),
            "y": r.randint(0, 4, (batch, 1))}


def _bert(dropout=0.1):
    main, startup, _, (loss,) = _build_pretrain(tfluid, tbert, dropout)
    main.random_seed = 3
    return main, startup, loss


def _masks(main):
    return [op.output("Mask")[0] for op in main.global_block().ops
            if op.type == "dropout"]


def _train(build, feed_of, run_mode, mode, steps=3):
    """``steps`` steps in ``run_mode`` from the startup program: → (per
    step [loss, first dropout mask], {param: final value}, executor)."""
    mode(run_mode)
    main, startup, loss = build()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    fetched = [exe.run(main, feed=feed_of(s),
                       fetch_list=[loss, _masks(main)[0]], scope=scope)
               for s in range(steps)]
    assert exe._last_run_mode == run_mode
    params = {p.name: scope.find_var(p.name).value().array.clone()
              for p in main.all_parameters()}
    return fetched, params, exe


# --------------------------------------------- compiled against interpreted
@pytest.mark.parametrize("model", ["bert", "mlp_sgd"])
def test_compiled_matches_interpreted_bitwise(model, mode):
    build, feed_of = ((_bert, _pretrain_feed) if model == "bert"
                      else (_mlp, _mlp_feed))
    comp, cparams, exe = _train(build, feed_of, "compiled", mode)
    interp, iparams, _ = _train(build, feed_of, "interpreted", mode)
    assert exe._last_block.stats["eager"] == 3
    for (cl, cm), (il, im) in zip(comp, interp):
        assert np.array_equal(cl, il) and np.array_equal(cm, im)
    assert cparams.keys() == iparams.keys()
    for n in cparams:
        assert torch.equal(cparams[n], iparams[n]), n
    # training moved the parameters
    main, startup, _ = build()
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    w = main.all_parameters()[0].name
    assert not torch.equal(scope.find_var(w).value().array, cparams[w])


def test_dropout_masks_differ_per_step_and_match_the_interpreter(mode):
    comp, _, _ = _train(_bert, _pretrain_feed, "compiled", mode)
    interp, _, _ = _train(_bert, _pretrain_feed, "interpreted", mode)
    masks = [m for _, m in comp]
    assert not np.array_equal(masks[0], masks[1])
    assert not np.array_equal(masks[1], masks[2])
    for m in masks:
        assert abs(m.mean() - 0.9) < 0.05
    for (_, cm), (_, im) in zip(comp, interp):
        assert np.array_equal(cm, im)


# ------------------------------------------- against the TPU package
@pytest.mark.parametrize("fixture,opt,prefix", [
    ("golden_encoder_trajectory.npz",
     lambda: tfluid.optimizer.SGD(0.05), "ge"),
    ("golden_encoder_adam_trajectory.npz",
     lambda: tfluid.optimizer.Adam(0.01, beta1=0.9, beta2=0.999,
                                   epsilon=1e-8), "gea"),
])
def test_interpreted_golden_trajectory(fixture, opt, prefix, mode):
    """The oracle on the golden encoder trajectories (the default, compiled
    path runs them in test_torch_train_slice.py), and the compiled losses
    bitwise equal to the oracle's on this program too."""
    mode("interpreted")
    got, golden, run_mode = _run_encoder_golden(fixture, opt, prefix)
    assert run_mode == "interpreted"
    np.testing.assert_allclose(got, golden, rtol=1e-4, atol=1e-5)
    mode("compiled")
    compiled, _, run_mode = _run_encoder_golden(fixture, opt, prefix)
    assert run_mode == "compiled"
    assert compiled == got


def test_compiled_bert_steps_match_jax_compiled(mode):
    """Two Adam steps (lr 1e-3, dropout 0) from the TPU package's startup
    parameters, both packages on their compiled paths."""
    mode("compiled")
    jm, js, _, jfetch = _build_pretrain(jfluid, jbert)
    tm, ts, _, tfetch = _build_pretrain(tfluid, tbert)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
              for v in jm.global_block().vars.values() if v.persistable}
    tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    texe.run(ts, scope=tscope)
    set_params_from_numpy(tscope, arrays)
    for step in range(2):
        feed = _pretrain_feed(step)
        jl = jexe.run(jm, feed=feed, fetch_list=jfetch, scope=jscope)[0]
        tl = texe.run(tm, feed=feed, fetch_list=tfetch, scope=tscope)[0]
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    assert jexe._last_run_mode == texe._last_run_mode == "compiled"
    w = "word_embedding"
    np.testing.assert_allclose(tscope.find_var(w).value().array.numpy(),
                               np.asarray(jscope.find_var(w).get_tensor()),
                               rtol=0, atol=1e-5)


# -------------------------------------------------------------- contracts
def test_registry_declares_what_the_plan_reads():
    for t in ("reshape2", "fill_constant", "uniform_random",
              "gaussian_random"):
        assert "ShapeTensor" in TOPS.get(t).host_inputs
    assert "Shape" in TOPS.get("reshape2").host_inputs
    main, _, _ = _bert()
    for op in main.global_block().ops:
        assert not texecutor._op_is_stateful(op), op.type
        assert not texecutor._op_reads_host_values(op), op.type
    assert texecutor._ops_compilable(main.global_block().ops)
    assert resolve_base_info("fused_attention_qkv_grad") \
        is TOPS.get("fused_attention_qkv")
    assert texecutor._op_needs_rng("fused_attention_qkv_grad")
    assert not texecutor._op_needs_rng("mul_grad")


def test_classify_block_state_errors():
    main, startup, loss = _mlp()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(RuntimeError, match="fc_0.w_0"):
        exe.run(main, feed=_mlp_feed(0), fetch_list=[loss],
                scope=tfluid.Scope())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_mlp_feed(0), fetch_list=[loss], scope=scope)
    # y stays in the scope from the run before: still a missing feed
    with pytest.raises(KeyError, match="'y'"):
        exe.run(main, feed={"x": _mlp_feed(1)["x"]}, fetch_list=[loss],
                scope=scope)
    assert exe._last_run_mode == "compiled"


def test_block_state_fields():
    main, startup, loss = _bert()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    params = {p.name for p in main.all_parameters()}
    assert params <= set(exe._last_block.extra_writeback)
    exe.run(main, feed=_pretrain_feed(0), fetch_list=[loss], scope=scope)
    cb = exe._last_block
    assert cb.kind == "compiled"
    mut = set(cb.mut_state)
    assert params <= mut
    assert any(n.endswith("moment1_0") for n in mut)
    assert all(n not in mut for n in cb.ro_state)
    lr = [n for n in cb.ro_state if "learning_rate" in n]
    assert lr, cb.ro_state


def test_intermediates_leave_the_scope_but_stay_fetchable(mode):
    main, startup, loss = _mlp(dropout=0.0)
    block = main.global_block()
    hidden = [op for op in block.ops if op.type == "mul"][0].output("Out")[0]
    grad = main.all_parameters()[0].name + "@GRAD"
    fetch = [loss, hidden, grad]
    got = {}
    for m in ("compiled", "interpreted"):
        mode(m)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        got[m] = exe.run(main, feed=_mlp_feed(0), fetch_list=fetch,
                         scope=scope)
        present = [scope.find_var(n) is not None for n in (hidden, grad)]
        assert present == ([False, False] if m == "compiled"
                           else [True, True])
        assert scope.find_var(main.all_parameters()[0].name) is not None
    for c, i in zip(got["compiled"], got["interpreted"]):
        assert np.array_equal(c, i)
    lod = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    lod.run(startup, scope=scope)
    out = lod.run(main, feed=_mlp_feed(0), fetch_list=fetch, scope=scope,
                  return_numpy=False)
    assert all(isinstance(t, tfluid.LoDTensor) for t in out)
    assert np.array_equal(out[1].numpy(), got["compiled"][1])


def test_cache_rebuilds_on_version_feed_shape_and_scope():
    main, startup, loss = _mlp()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    run = lambda sc, f: exe.run(main, feed=f, fetch_list=[loss],  # noqa
                                scope=sc)
    run(scope, _mlp_feed(0))
    first = exe._last_block
    run(scope, _mlp_feed(1))
    assert exe._last_block is first and first.stats["eager"] == 2
    run(scope, _mlp_feed(2, batch=3))
    assert exe._last_block is not first
    scope2 = tfluid.Scope()
    exe.run(startup, scope=scope2)
    run(scope2, _mlp_feed(0))
    assert exe._last_block is not first \
        and exe._last_block._scope_ref() is scope2
    with tfluid.program_guard(main, startup):
        tfluid.layers.scale(loss, 2.0)
    run(scope, _mlp_feed(0))
    assert exe._last_block.program._version == main._version \
        and exe._last_block is not first
    # two startup blocks (one a scope), four of main
    n = len(exe._compiled_cache)
    assert n == 6 and exe.graph_stats()["blocks"] == n
    exe.close()
    assert not exe._compiled_cache


def test_replaced_state_var_is_read(mode):
    main, startup, loss = _mlp(dropout=0.0)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_mlp_feed(0), fetch_list=[loss], scope=scope)
    w = main.all_parameters()[0].name
    scope.find_var(w).set_value(tfluid.LoDTensor(
        torch.zeros_like(scope.find_var(w).value().array)))
    (got,) = exe.run(main, feed=_mlp_feed(1), fetch_list=[loss],
                     scope=scope)
    mode("interpreted")
    ref_scope = tfluid.Scope()
    exe.run(startup, scope=ref_scope)
    for v in main.global_block().vars.values():
        if v.persistable and scope.find_var(v.name) is not None:
            ref_scope.var(v.name).set_value(tfluid.LoDTensor(
                scope.find_var(v.name).value().array.clone()))
    # the compiled run already advanced w: compare one more step of each
    mode("compiled")
    (a,) = exe.run(main, feed=_mlp_feed(2), fetch_list=[loss], scope=scope)
    mode("interpreted")
    (b,) = exe.run(main, feed=_mlp_feed(2), fetch_list=[loss],
                   scope=ref_scope)
    assert np.array_equal(a, b)
    assert np.isfinite(got).all()


def test_mode_flag_routes_to_the_interpreter(mode):
    main, startup, loss = _mlp()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    assert exe._last_run_mode == "compiled"
    n = len(exe._compiled_cache)
    mode("interpreted")
    exe.run(main, feed=_mlp_feed(0), fetch_list=[loss], scope=scope)
    assert exe._last_run_mode == "interpreted"
    assert len(exe._compiled_cache) == n
    mode("eager")
    with pytest.raises(ValueError, match="FLAGS_executor_mode"):
        exe.run(main, feed=_mlp_feed(0), fetch_list=[loss], scope=scope)


@pytest.mark.parametrize("asked", ["nan_guard", "lod_feed"])
def test_compiled_step_refuses_what_it_does_not_lower(asked):
    """The NaN guard takes the actions raise, skip and rollback
    (tests/test_torch_numeric_guard.py): any other action is refused when
    the block is built, rather than guard nothing. A LoD feed is taken
    (its plan keyed by the LoD), but a window cannot stack a fetch that
    carries LoD and refuses it, as the TPU package does."""
    main, startup, loss = _mlp()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    if asked == "nan_guard":
        tcore.set_flag("FLAGS_check_nan_inf", True)
        tcore.set_flag("FLAGS_nan_inf_action", "warn")
        try:
            with pytest.raises(ValueError, match="FLAGS_nan_inf_action"):
                exe.run(main, feed=_mlp_feed(0), fetch_list=[loss],
                        scope=scope)
        finally:
            tcore.set_flag("FLAGS_check_nan_inf", False)
            tcore.set_flag("FLAGS_nan_inf_action", "raise")
        return
    feed = _mlp_feed(0)
    n = feed["x"].shape[0]
    feed["x"] = tfluid.LoDTensor(torch.from_numpy(feed["x"]), [[0, 2, n]])
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe._last_run_mode == "compiled"
    with pytest.raises(NotImplementedError, match="LoD"):
        exe.run(main, feed=feed, fetch_list=[loss, "x"], scope=scope,
                n_steps=2)


def test_block_with_a_host_read_runs_interpreted():
    """reshape2 fed a Shape tensor reads its values on the host: the block
    is not compilable and runs through the interpreter."""
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.data("x", [6])
        tfluid.data("shp", [2], dtype="int32", append_batch_size=False)
    block = main.global_block()
    for n in ("out", "xs"):
        block.create_var(name=n)
    block.append_op(type="reshape2", inputs={"X": [x.name], "Shape": ["shp"]},
                    outputs={"Out": ["out"], "XShape": ["xs"]})
    assert texecutor._op_reads_host_values(block.ops[0])
    exe = tfluid.Executor(tfluid.CPUPlace())
    xv = np.arange(12, dtype=np.float32).reshape(2, 6)
    (out,) = exe.run(main, feed={"x": xv, "shp": np.array([3, 4], np.int32)},
                     fetch_list=["out"], scope=tfluid.Scope())
    assert exe._last_run_mode == "interpreted"
    assert np.array_equal(out, xv.reshape(3, 4))


def _reshape_by_shape_tensor(main, x):
    """Append reshape2 fed a Shape tensor ("shp"): a host read."""
    block = main.global_block()
    with tfluid.program_guard(main, tfluid.Program()):
        tfluid.data("shp", [2], dtype="int32", append_batch_size=False)
    for n in ("out", "xs"):
        block.create_var(name=n)
    block.append_op(type="reshape2", inputs={"X": [x.name], "Shape": ["shp"]},
                    outputs={"Out": ["out"], "XShape": ["xs"]})


def test_lod_feed_to_a_block_that_runs_interpreted():
    """A block routed to the interpreter under the default flag (one
    host-reading op: too small to segment) takes a LoD feed as the
    interpreter does."""
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.data("x", [6])
    _reshape_by_shape_tensor(main, x)
    exe = tfluid.Executor(tfluid.CPUPlace())
    xv = np.arange(12, dtype=np.float32).reshape(2, 6)
    feed = {"x": tfluid.LoDTensor(torch.from_numpy(xv), [[0, 1, 2]]),
            "shp": np.array([4, 3], np.int32)}
    (out,) = exe.run(main, feed=feed, fetch_list=["out"],
                     scope=tfluid.Scope())
    assert exe._last_run_mode == "interpreted"
    assert np.array_equal(out, xv.reshape(4, 3))


def test_compilability_follows_the_program_version():
    """Whether a block compiles is decided once per program version: an
    op appended later that reads host values routes the next run to the
    interpreter."""
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.data("x", [6])
        y = tfluid.layers.scale(x, 2.0)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    xv = np.arange(12, dtype=np.float32).reshape(2, 6)
    (out,) = exe.run(main, feed={"x": xv}, fetch_list=[y], scope=scope)
    assert exe._last_run_mode == "compiled"
    assert np.array_equal(out, 2 * xv)
    _reshape_by_shape_tensor(main, x)
    (out,) = exe.run(main, feed={"x": xv, "shp": np.array([3, 4], np.int32)},
                     fetch_list=["out"], scope=scope)
    assert exe._last_run_mode == "interpreted"
    assert np.array_equal(out, xv.reshape(3, 4))


# ----------------------------------------------------------- the draws
def test_counter_hash_and_draws():
    vals = np.random.RandomState(0).randint(0, 2 ** 32, 64, dtype=np.uint64)
    got = trng.hash32(torch.from_numpy(vals.astype(np.int64)))
    assert got.tolist() == [trng.hash32_int(int(v)) for v in vals]
    k1, k2 = (torch.tensor([k], dtype=torch.int64) for k in (11, 12))
    m1 = trng.keep_mask(k1, (256, 512), 0.1)
    assert torch.equal(m1, trng.keep_mask(k1, (256, 512), 0.1))
    assert not torch.equal(m1, trng.keep_mask(k2, (256, 512), 0.1))
    assert abs(m1.float().mean().item() - 0.9) < 0.005
    u = trng.uniform(k1, (100000,))
    assert 0.0 < u.min().item() and u.max().item() < 1.0
    assert abs(u.mean().item() - 0.5) < 0.005
    z = trng.normal(k2, (100000,))
    assert abs(z.mean().item()) < 0.02 and abs(z.std().item() - 1.0) < 0.02
    s = trng.attention_seed(trng.fixed_key(5, "cpu"))
    assert s.dtype == torch.int32 and s.shape == (1,) and s.item() >= 0


def test_step_keys_follow_seed_step_and_op():
    keys = texecutor._StepKeys(9, [0, 4, 7], "cpu")
    got = []
    for step in (0, 0, 1):
        keys.begin(torch.tensor([step], dtype=torch.int64))
        got.append([keys.key(i).item() for i in (0, 4, 7)])
        keys.end()
    assert got[0] == got[1] and got[0] != got[2]
    assert len(set(got[0])) == 3
    other = texecutor._StepKeys(10, [0, 4, 7], "cpu")
    other.begin(torch.zeros(1, dtype=torch.int64))
    assert other.key(4).item() != got[0][1]


def test_compiled_step_without_jax():
    """The port's compiled step runs on the CPU in a process where jax
    cannot be imported."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'paddle_tpu'): sys.modules[m] = None\n"
        "import numpy as np\n"
        "from paddle_tpu_torch import fluid\n"
        "main, startup = fluid.Program(), fluid.Program()\n"
        "with fluid.program_guard(main, startup):\n"
        "    x = fluid.data('x', [4])\n"
        "    h = fluid.layers.dropout(fluid.layers.fc(x, 3), 0.1)\n"
        "    loss = fluid.layers.mean(h)\n"
        "    fluid.optimizer.SGD(0.1).minimize(loss)\n"
        "exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()\n"
        "exe.run(startup, scope=scope)\n"
        "for _ in range(2):\n"
        "    l, = exe.run(main, feed={'x': np.ones((2, 4), np.float32)},\n"
        "                 fetch_list=[loss], scope=scope)\n"
        "assert np.isfinite(l).all()\n"
        "print(exe._last_run_mode, sorted(m for m in sys.modules\n"
        "      if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu')\n"
        "      and sys.modules[m] is not None))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "compiled []", res.stdout
