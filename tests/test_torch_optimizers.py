"""The optimizer stack of paddle_tpu_torch (fluid/optimizer.py, clip.py,
regularizer.py, backward.calc_gradient) against the TPU package's, on the
CPU.

On the small MLP of the TPU package's own optimizer tests
(tests/test_backward_executor.py:12-20: fc 16 relu, fc 4 softmax, cross
entropy, batch 64):
- Each optimizer of paddle_tpu/fluid/optimizer.py but PipelineOptimizer:
  SGD :227, Momentum :242, LarsMomentum :269, Adagrad :297, Adam :323,
  Adamax :364, DecayedAdagrad :419, Adadelta :443, RMSProp :469 (and
  centered), Ftrl :500, Lamb :528 (and with exclude_from_weight_decay_fn),
  DGCMomentum :880, and Dpsgd :402 at sigma 0; the ones of
  tests/test_backward_executor.py:59-62 each also under
  GradientClipByValue, GradientClipByNorm and GradientClipByGlobalNorm
  (paddle_tpu/fluid/clip.py) and under L1Decay (regularizer.py:29).
  Each case holds: the ops of every block (types, slots, attrs) and the
  accumulator names equal the TPU package's, the ProgramDesc bytes of the
  main and startup programs equal its bytes (the port's serializer), and 4
  steps from the same numpy start (the TPU package's initial parameters
  and the startups' constants, set into both scopes) give losses and
  every persistable at rtol 1e-5, atol 1e-6 (tests/
  test_gradient_merge.py:69); compiled and interpreted runs of the port
  bitwise alike.
- GradientMergeOptimizer :715 at k = 1 and k = 4 (the same checks, and no
  update mid-window, and 4 micro-batches of 16 against one step on their
  64 rows; in a window of 4 runs bitwise the single runs), GradientMerge
  over Dpsgd (a random op in the conditional: the
  block runs segmented, the conditional an island, bitwise the
  interpreter's), LookaheadOptimizer :812, the clips through
  set_gradient_clip (a per-parameter clip with param_list=, and a
  global-norm group), and fluid.gradients (backward.py:310, :340).
- ModelAverage :563 and ExponentialMovingAverage :577 raise
  NotImplementedError as the TPU package's do; the AMP decorator clips
  after it unscales.
"""
import functools

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import clip as jclip
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import clip as tclip
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy

RTOL, ATOL = 1e-5, 1e-6  # tests/test_gradient_merge.py:69
STEPS = 4
SEED = 5


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """Both packages name temporaries from a process-wide counter that
    ``unique_name.guard`` does not reset, and keep the clip of
    ``set_gradient_clip`` process-wide: start both from scratch."""
    from paddle_tpu.fluid import unique_name as jnames
    from paddle_tpu_torch.fluid import unique_name as tnames
    for m in (jnames, tnames):
        monkeypatch.setattr(m, "dygraph_parameter_name_generator",
                            m.UniqueNameGenerator())
    for m in (jclip, tclip):
        monkeypatch.setattr(m, "_gradient_clip_attr", None)
    saved = tcore.globals_["FLAGS_executor_mode"]
    # one intra-op thread: these small programs gain nothing from more,
    # and several test processes share the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tcore.set_flag("FLAGS_executor_mode", saved)


def _mlp(fluid, make):
    """``make(fluid)`` → an optimizer (or a callable that minimizes the
    loss), on the MLP of tests/test_backward_executor.py:12 → (main,
    startup, loss, optimizer)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[8], dtype="float32")
        label = fluid.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        pred = fluid.layers.fc(h, 4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        opt = make(fluid)
        opt.minimize(loss)
    main.random_seed = startup.random_seed = SEED
    return main, startup, loss, opt


def _feed(step):
    r = np.random.RandomState(2 + step)
    return {"x": r.rand(64, 8).astype("float32"),
            "y": r.randint(0, 4, (64, 1)).astype("int64")}


def _ops(program):
    return [[(op.type, {k: list(v) for k, v in op.inputs.items()},
              {k: list(v) for k, v in op.outputs.items()},
              {k: v for k, v in op.attrs.items()
               if not k.startswith("_") and k != "sub_block"})
             for op in b.ops] for b in program.blocks]


def _jax_state(scope, program):
    out = {}
    for v in program.list_vars():
        sv = scope.find_var(v.name) if v.persistable else None
        if sv is not None and sv.is_initialized():
            out[v.name] = np.asarray(sv.get_tensor())
    return out


def _port_state(scope, program):
    out = {}
    for v in program.list_vars():
        sv = scope.find_var(v.name) if v.persistable else None
        if sv is not None and sv.is_initialized():
            out[v.name] = sv.value().array.clone()
    return out


@functools.lru_cache(maxsize=1)
def _jax_params():
    """The TPU package's initial parameters of the MLP: its startup run
    once, since every case creates and draws its parameters alike, before
    any accumulator (test_start_parameters_are_every_cases)."""
    jm, js, _, _ = _mlp(jfluid, lambda f: f.optimizer.SGD(0.1))
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    exe.run(js, scope=scope)
    return {p.name: np.asarray(scope.find_var(p.name).get_tensor())
            for p in jm.all_parameters()}


def _start(main, startup):
    """The start both packages train from, as numpy: the TPU package's
    parameters (and what the startup copies from them), and the port's
    startup values of the other persistables (learning rates,
    accumulators and counters: constants)."""
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    start = {n: t.numpy() for n, t in _port_state(scope, main).items()}
    params = _jax_params()
    start.update(params)
    for op in startup.global_block().ops:  # Lookahead's slow weights
        if op.type == "assign" and op.input("X")[0] in params:
            start[op.output("Out")[0]] = params[op.input("X")[0]]
    return start


def _run_jax(main, loss, start, steps=STEPS, feed=_feed):
    """The TPU package's run from ``start``, set into its scope in place of
    a run of each case's startup program, whose compile would be a third
    of a case's time; → (losses, state)."""
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    for n, a in start.items():
        scope.var(n).get_tensor().set(a)
    losses = [float(exe.run(main, feed=feed(s), fetch_list=[loss],
                            scope=scope)[0][0]) for s in range(steps)]
    return losses, _jax_state(scope, main)


def _run_port(main, startup, loss, start, mode, steps=STEPS, feed=_feed):
    """The port from ``start`` (its float values; the integer counters
    start alike) → (losses, state, the executor)."""
    tcore.set_flag("FLAGS_executor_mode", mode)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    set_params_from_numpy(scope, {n: a for n, a in start.items()
                                  if a.dtype.kind == "f"})
    losses = [exe.run(main, feed=feed(s), fetch_list=[loss],
                      scope=scope)[0].copy() for s in range(steps)]
    exe.scope = scope
    return losses, _port_state(scope, main), exe


def _hold(make, steps=STEPS, feed=_feed, mode="compiled"):
    """Build both packages' programs with ``make``, compare their ops,
    accumulators and bytes, train both from one start and compare the
    losses and every persistable; then the port interpreted, bitwise.
    → (TPU losses, port losses, the port's executor, its programs, its
    states)."""
    jm, js, jl, jopt = _mlp(jfluid, make)
    tm, ts, tl, topt = _mlp(tfluid, make)
    assert _ops(tm) == _ops(jm)
    jacc = getattr(jopt, "_accumulators", {})
    tacc = getattr(topt, "_accumulators", {})
    assert {k: {p: v.name for p, v in d.items()} for k, d in tacc.items()} \
        == {k: {p: v.name for p, v in d.items()} for k, d in jacc.items()}
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    start = _start(tm, ts)
    jlosses, jstate = _run_jax(jm, jl, start, steps, feed)
    tlosses, tstate, exe = _run_port(tm, ts, tl, start, mode, steps, feed)
    assert exe._last_run_mode == mode
    np.testing.assert_allclose([float(x[0]) for x in tlosses], jlosses,
                               rtol=RTOL, atol=ATOL)
    assert sorted(tstate) == sorted(jstate)
    for n, want in jstate.items():
        # JAX without x64 holds an int64 counter as int32
        np.testing.assert_allclose(tstate[n].numpy(), want, rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    ilosses, istate, _ = _run_port(tm, ts, tl, start, "interpreted", steps,
                                   feed)
    for a, b in zip(tlosses, ilosses):
        assert np.array_equal(a, b)
    for n in tstate:
        assert torch.equal(tstate[n], istate[n]), n
    return jlosses, tlosses, exe, (tm, ts), (start, tstate)


# ------------------------------------------------------ every optimizer
def _kw(name):
    """tests/test_backward_executor.py:66-69's arguments."""
    kw = {"momentum": 0.9} if name in ("Momentum", "LarsMomentum") else {}
    kw["learning_rate"] = 0.01 if name in ("RMSProp", "Adam", "Lamb") \
        else 0.1
    return kw


BASE = ["Adam", "Momentum", "Adagrad", "RMSProp", "Lamb", "Adamax",
        "Adadelta", "DecayedAdagrad", "Ftrl", "LarsMomentum"]
CLIPS = {
    "none": lambda f: None,
    "value": lambda f: f.clip.GradientClipByValue(0.05),
    "norm": lambda f: f.clip.GradientClipByNorm(0.1),
    "global_norm": lambda f: f.clip.GradientClipByGlobalNorm(0.1),
    "l1decay": lambda f: None,
}


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("name", BASE)
def test_all_optimizers_step(name, clip):
    """tests/test_backward_executor.py:59's list, each with and without
    each clip and L1Decay."""
    def make(f):
        kw = _kw(name)
        if clip == "l1decay":
            kw["regularization"] = f.regularizer.L1Decay(1e-3)
        elif clip != "none":
            kw["grad_clip"] = CLIPS[clip](f)
        return getattr(f.optimizer, name)(**kw)
    jl, tl, _, (tm, _), _ = _hold(make)
    types = [op.type for op in tm.global_block().ops]
    want = {"none": None, "value": "clip", "norm": "clip_by_norm",
            "global_norm": "squared_l2_norm", "l1decay": "sign"}[clip]
    assert want is None or types.count(want) == 4
    assert jl[-1] != jl[0] and np.isfinite(tl[-1]).all()


OTHERS = {
    "SGD": lambda f: f.optimizer.SGD(0.5),
    "RMSProp_centered": lambda f: f.optimizer.RMSProp(
        0.01, momentum=0.5, centered=True),
    "Lamb_excluding_biases": lambda f: f.optimizer.Lamb(
        0.01, lamb_weight_decay=0.01,
        exclude_from_weight_decay_fn=lambda p: p.name.endswith(".b_0")),
    "Ftrl_l1_l2": lambda f: f.optimizer.Ftrl(0.1, l1=1e-3, l2=1e-3,
                                             lr_power=-0.3),
    "DGCMomentum": lambda f: f.optimizer.DGCMomentumOptimizer(
        0.1, momentum=0.9, rampup_begin_step=0),
    "Dpsgd_sigma0": lambda f: f.optimizer.Dpsgd(0.01, clip=1.0,
                                                batch_size=32, sigma=0),
    "Adam_L2Decay": lambda f: f.optimizer.Adam(
        0.01, regularization=f.regularizer.L2Decay(1e-2)),
}


@pytest.mark.parametrize("name", sorted(OTHERS))
def test_other_optimizers_step(name):
    _hold(OTHERS[name])


def test_lamb_excludes_what_its_function_names():
    tm = _mlp(tfluid, OTHERS["Lamb_excluding_biases"])[0]
    wd = {op.input("Param")[0]: op.attr("weight_decay")
          for op in tm.global_block().ops if op.type == "lamb"}
    assert wd == {"fc_0.b_0": 0.0, "fc_0.w_0": 0.01, "fc_1.b_0": 0.0,
                  "fc_1.w_0": 0.01}


def test_dpsgd_is_random_and_compiles():
    """A random op: keyed per step, compiled (it sits in no conditional)
    and bitwise the interpreter's at sigma > 0."""
    def make(f):
        return f.optimizer.Dpsgd(0.01, clip=1.0, batch_size=32, sigma=1.0)
    tm, ts, tl, _ = _mlp(tfluid, make)
    start = _start(tm, ts)
    got, gstate, exe = _run_port(tm, ts, tl, start, "compiled", steps=3)
    assert exe._last_run_mode == "compiled"
    want, wstate, _ = _run_port(tm, ts, tl, start, "interpreted", steps=3)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    for n in gstate:
        assert torch.equal(gstate[n], wstate[n]), n
    assert len({float(a[0]) for a in got}) == 3


# --------------------------------------------- GradientMerge, Lookahead
@pytest.mark.parametrize("k", [1, 4])
def test_gradient_merge(k):
    """paddle_tpu/fluid/optimizer.py:715 over Adam: k = 1 has no cond;
    k = 4 updates only at the 4th micro-step (the losses repeat in
    windows of 4 on one batch) and keeps the parameters bitwise before."""
    def make(f):
        return f.optimizer.GradientMergeOptimizer(f.optimizer.Adam(0.01),
                                                  k_steps=k, avg=True)
    one = _feed(0)
    jl, tl, exe, (tm, _), (start, _) = _hold(make, steps=8,
                                             feed=lambda s: one)
    types = [op.type for op in tm.global_block().ops]
    assert ("conditional_block" in types) == (k > 1)
    assert tm.num_blocks == (3 if k > 1 else 1)
    if k == 4:
        assert jl[:4] == [jl[0]] * 4 and jl[4:] == [jl[4]] * 4
        assert [float(x[0]) for x in tl[:4]] == [float(tl[0][0])] * 4
        # micro-steps 1-3 leave every parameter bitwise
        tm, ts, tloss, _ = _mlp(tfluid, make)
        _, state, _ = _run_port(tm, ts, tloss, start, "compiled", steps=3,
                                feed=lambda s: one)
        for p in tm.all_parameters():
            assert np.array_equal(state[p.name].numpy(), start[p.name])
        step = [n for n in state if n.startswith("gradient_merge_step")]
        assert len(step) == 1 and state[step[0]].tolist() == [3]


def test_gradient_merge_matches_one_big_batch():
    """tests/test_gradient_merge.py:34's oracle in the port: 4
    micro-batches of 16 merged (avg) against one Adam step on their 64
    rows."""
    big = _feed(0)
    micro = [{n: a[16 * i:16 * (i + 1)] for n, a in big.items()}
             for i in range(4)]
    tm, ts, tl, _ = _mlp(tfluid, lambda f: f.optimizer.
                         GradientMergeOptimizer(f.optimizer.Adam(1e-2),
                                                k_steps=4, avg=True))
    bm, bs, bl, _ = _mlp(tfluid, lambda f: f.optimizer.Adam(1e-2))
    start = _start(bm, bs)
    _, gm, _ = _run_port(tm, ts, tl, start, "compiled", steps=4,
                         feed=lambda s: micro[s])
    _, one, _ = _run_port(bm, bs, bl, start, "compiled", steps=1,
                          feed=lambda s: big)
    for p in bm.all_parameters():
        np.testing.assert_allclose(gm[p.name].numpy(), one[p.name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=p.name)


def test_lookahead():
    """paddle_tpu/fluid/optimizer.py:812 (tests/test_backward_executor.py
    :101's arguments): the slow weights blend at every 3rd step."""
    def make(f):
        return f.optimizer.LookaheadOptimizer(f.optimizer.SGD(0.3),
                                              alpha=0.5, k=3)
    _, _, _, (tm, ts), (start, _) = _hold(make, steps=7)
    assert [op.type for op in ts.global_block().ops].count("assign") == 4
    slow = {p.name: p.name + "_slow_0" for p in tm.all_parameters()}
    for p, s in slow.items():
        assert np.array_equal(start[s], start[p])  # the startup's assign
    # after step 6 (a sync) the fast weights equal the slow ones, and
    # after step 5 they differ
    tm, ts, tl, _ = _mlp(tfluid, make)
    for steps, synced in ((5, False), (6, True)):
        _, state, _ = _run_port(tm, ts, tl, start, "compiled", steps=steps)
        assert all(torch.equal(state[p], state[s])
                   for p, s in slow.items()) == synced


# ----------------------------------------------------- clips, gradients
def test_set_gradient_clip_with_a_param_list():
    """set_gradient_clip(param_list=): the listed parameters carry the
    clip; as in the TPU package the clip is also the process-wide one,
    which every other parameter takes."""
    def make(f):
        opt = f.optimizer.SGD(0.5)
        params = f.default_main_program().all_parameters()
        f.clip.set_gradient_clip(f.clip.GradientClipByNorm(0.05),
                                 param_list=params[:2])
        return opt
    _, _, _, (tm, _), _ = _hold(make)
    assert [p.gradient_clip_attr is not None
            for p in tm.all_parameters()] == [True, True, False, False]
    types = [op.type for op in tm.global_block().ops]
    assert types.count("clip_by_norm") == 4


def test_set_gradient_clip_global_norm_groups_every_grad():
    def make(f):
        f.clip.set_gradient_clip(f.clip.GradientClipByGlobalNorm(0.1))
        return f.optimizer.Momentum(0.1, momentum=0.9)
    _, _, _, (tm, _), _ = _hold(make)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("squared_l2_norm") == 4 and "sqrt" in types
    roles = {op.attr("op_role") for op in tm.global_block().ops
             if op.type == "squared_l2_norm"}
    assert roles == {1}


def test_the_global_norm_scales_by_clip_over_the_norm():
    """The clipped grads' global norm is clip_norm when the raw norm
    exceeds it."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.data("x", shape=[8], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 3))
        pg = tfluid.append_backward(loss)
        clipped = tfluid.clip.GradientClipByGlobalNorm(1e-3)._process_group(
            pg)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    outs = exe.run(main, feed={"x": np.ones((4, 8), np.float32)},
                   fetch_list=[g for _, g in pg] + [g for _, g in clipped],
                   scope=scope)
    raw, cl = outs[:len(pg)], outs[len(pg):]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in raw))
    assert norm > 1e-3
    cnorm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in cl))
    np.testing.assert_allclose(cnorm, 1e-3, rtol=1e-5)


def test_gradients_match_the_tpu_package():
    """fluid.gradients (backward.py:340) of two targets with respect to a
    data input and a hidden var."""
    def build(f):
        main, startup = f.Program(), f.Program()
        with f.unique_name.guard(), f.program_guard(main, startup):
            x = f.data("x", shape=[6], dtype="float32")
            h = f.layers.fc(x, 5, act="sigmoid")
            y = f.layers.fc(h, 3)
            z = f.layers.reduce_mean(f.layers.elementwise_mul(h, h))
            gx, gh = f.gradients([y, z], [x, h])
            gb = f.backward.gradients(z, x)
        main.random_seed = startup.random_seed = SEED
        return main, startup, [gx, gh, gb[0]]
    assert tfluid.backward.gradients is tfluid.gradients
    jm, js, jf = build(jfluid)
    tm, ts, tf_ = build(tfluid)
    assert _ops(tm) == _ops(jm)
    with pytest.raises(AssertionError, match="target_gradients"):
        with tfluid.program_guard(tm, ts):
            tfluid.gradients(tm.global_block().var("x"),
                             tm.global_block().var("x"),
                             target_gradients=[1.0])
    feed = {"x": np.random.RandomState(0).randn(4, 6).astype(np.float32)}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    want = jexe.run(jm, feed=feed, fetch_list=jf, scope=jscope)
    start = _jax_state(jscope, jm)
    for mode in ("compiled", "interpreted"):
        tcore.set_flag("FLAGS_executor_mode", mode)
        texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        texe.run(ts, scope=tscope)
        set_params_from_numpy(tscope, start)
        got = texe.run(tm, feed=feed, fetch_list=tf_, scope=tscope)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL,
                                       atol=ATOL)


def test_model_average_and_ema_raise_as_in_the_tpu_package():
    for fluid in (jfluid, tfluid):
        with pytest.raises(NotImplementedError):
            fluid.optimizer.ModelAverage(0.15)
        with pytest.raises(NotImplementedError):
            fluid.optimizer.ExponentialMovingAverage(0.999)
    assert "PipelineOptimizer" not in tfluid.optimizer.__all__
    assert set(jfluid.optimizer.__all__) - set(tfluid.optimizer.__all__) \
        == {"PipelineOptimizer"}


def test_amp_clips_after_the_unscale():
    """The AMP decorator hands the inner optimizer unscaled f32 grads: the
    global-norm clip reads each ``.unscaled`` grad, as in the TPU
    package."""
    from paddle_tpu.fluid.contrib import mixed_precision as jmp
    from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp

    def make(mp):
        def inner(f):
            opt = f.optimizer.Lamb(
                0.01, grad_clip=f.clip.GradientClipByGlobalNorm(1.0))
            return mp.decorate(opt, init_loss_scaling=8.0,
                               use_dynamic_loss_scaling=True,
                               use_fp16=True)
        return inner
    jm = _mlp(jfluid, make(jmp))[0]
    tm = _mlp(tfluid, make(tmp))[0]
    assert _ops(tm) == _ops(jm)
    ops = tm.global_block().ops
    norms = [op.input("X")[0] for op in ops if op.type == "squared_l2_norm"]
    assert len(norms) == 4 and all(".unscaled" in n for n in norms)
    first_norm = [i for i, op in enumerate(ops)
                  if op.type == "squared_l2_norm"][0]
    unscale = [i for i, op in enumerate(ops) if op.type == "elementwise_div"
               and ".unscaled" in op.output("Out")[0]]
    assert unscale and max(unscale) < first_norm


@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_dpsgd_under_gradient_merge_runs_segmented(sigma):
    """A random op in GradientMerge's conditional (dpsgd) sends its block
    to the segmented path, the conditional an island run by the
    interpreter (it draws in the taken branch alone): bitwise the
    interpreter's; at sigma 0 the TPU package's at the optimizer tests'
    tolerance."""
    def make(f):
        return f.optimizer.GradientMergeOptimizer(
            f.optimizer.Dpsgd(0.1, clip=1.0, batch_size=64, sigma=sigma),
            k_steps=2)
    tm, ts, tl, _ = _mlp(tfluid, make)
    jm, js, jl, _ = _mlp(jfluid, make)
    start = _start(tm, ts)
    jlosses, jstate = _run_jax(jm, jl, start, steps=4)
    got, gstate, exe = _run_port(tm, ts, tl, start, "compiled", steps=4)
    assert exe._last_run_mode == "segmented"
    assert exe._last_block.stats["islands"] > 0
    want, wstate, _ = _run_port(tm, ts, tl, start, "interpreted", steps=4)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    for n in gstate:
        assert torch.equal(gstate[n], wstate[n]), n
    p = "fc_0.w_0"
    assert not np.array_equal(gstate[p].numpy(), start[p])
    if sigma == 0.0:
        np.testing.assert_allclose([float(x[0]) for x in got], jlosses,
                                   rtol=RTOL, atol=ATOL)
        for n, w in jstate.items():
            np.testing.assert_allclose(gstate[n].numpy(), w, rtol=RTOL,
                                       atol=ATOL, err_msg=n)


def test_start_parameters_are_every_cases():
    """The TPU package draws the MLP's parameters alike whatever its
    optimizer adds to the startup program after them (what _start relies
    on), and the port's startup constants equal its own."""
    for make in (lambda f: f.optimizer.Lamb(0.01),
                 lambda f: f.optimizer.LookaheadOptimizer(
                     f.optimizer.Adamax(0.1), k=3)):
        jm, js, _, _ = _mlp(jfluid, make)
        tm, ts, _, _ = _mlp(tfluid, make)
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        exe.run(js, scope=scope)
        jstate = _jax_state(scope, jm)
        start = _start(tm, ts)
        assert sorted(start) == sorted(jstate)
        for n, want in jstate.items():
            assert np.array_equal(start[n], want), n


def test_gradient_merge_in_a_window_equals_single_runs():
    """Executor.run(n_steps=4) of GradientMerge(Lamb + global-norm clip,
    k = 2): the window's losses and every persistable bitwise 4 single
    compiled runs' (the conditional inside the windowed step)."""
    def make(f):
        return f.optimizer.GradientMergeOptimizer(
            f.optimizer.Lamb(0.01, grad_clip=f.clip.GradientClipByGlobalNorm(
                0.1)), k_steps=2)
    tm, ts, tl, _ = _mlp(tfluid, make)
    start = _start(tm, ts)
    single, sstate, _ = _run_port(tm, ts, tl, start, "compiled", steps=4)
    tcore.set_flag("FLAGS_executor_mode", "compiled")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    set_params_from_numpy(scope, {n: a for n, a in start.items()
                                  if a.dtype.kind == "f"})
    feeds = [_feed(s) for s in range(4)]
    win, = exe.run(tm, feed={n: np.stack([f[n] for f in feeds])
                             for n in feeds[0]},
                   fetch_list=[tl], scope=scope, n_steps=4)
    assert exe._last_run_mode == "compiled"
    assert np.array_equal(win.reshape(-1), np.concatenate(single))
    wstate = _port_state(scope, tm)
    for n in sstate:
        assert torch.equal(wstate[n], sstate[n]), n
