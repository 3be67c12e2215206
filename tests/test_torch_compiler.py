"""The port's CompiledProgram, BuildStrategy and ExecutionStrategy
(paddle_tpu_torch/fluid/compiler.py) and the passes BuildStrategy selects
(fluid/ir.py) against the TPU package's (paddle_tpu/fluid/compiler.py,
ir.py:679-746, :1120-1242, :1383), on the CPU:

- without a strategy that selects a pass, a compiled-program run, plain
  or ``with_data_parallel``, is bitwise the plain ``Executor.run``: a
  ResNet-18 train step (image 16) and a 2-layer BERT pretraining step, 3
  steps each, losses and every persistable;
- ``fuse_elewise_add_act_pass`` and ``fuse_bn_act_pass`` rewrite the
  ResNet train program and its ``clone(for_test=True)`` (taken before the
  optimizer, as the reference's scripts do) exactly as the TPU package's
  passes do: op types, slots, var names and public attrs; nothing fuses in
  the train program (its grad ops read each intermediate), 8 + 8 ops
  fuse in the eval clone of ResNet-18;
- the fused eval program's fetches against the unfused program's
  (bitwise) and against the TPU package's fused program (rtol 1e-4, atol
  1e-5, tests/test_torch_resnet.py's tolerance for the two packages'
  ResNet);
- the fused eval program, which holds the stateful
  ``fused_batch_norm_act``, runs segmented, and interpreted under
  ``ExecutionStrategy(allow_mixed_compilation=False)``, bitwise alike;
- the eval idiom: a test clone compiled with ``share_vars_from`` reads
  the trained scope; refetching an intermediate restores the pristine
  program (tests/test_ir_passes.py:350); more than one place and
  ``n_steps`` > 1 through ``with_data_parallel`` raise;
- graph_viz, graph_to_program, the absorbed passes and
  block_segmentation_pass as in the TPU package; the pass registries
  equal.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid import ir as jir
from paddle_tpu.models import bert as jbert  # noqa: F401
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import ir as tir
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tresnet

CPU = tfluid.CPUPlace()
BERT_CFG = dict(vocab_size=128, hidden=64, layers=2, heads=4, ffn=128,
                max_len=16, type_vocab=2)
FUSED = ("fused_batch_norm_act", "fused_elemwise_activation")
PKG_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the bitwise checks compare CPU products, which
    contended BLAS threads may split differently from call to call."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_tmp_names(monkeypatch):
    """Both packages name temporaries from a process-wide counter that
    ``unique_name.guard`` does not reset: start both from zero."""
    from paddle_tpu.fluid import unique_name as jnames
    from paddle_tpu_torch.fluid import unique_name as tnames
    for m in (jnames, tnames):
        monkeypatch.setattr(m, "dygraph_parameter_name_generator",
                            m.UniqueNameGenerator())


@pytest.fixture(autouse=True)
def _default_flags_seed():
    """The TPU package's startup draws from FLAGS_seed, which another test
    file may have left set (tests/test_torch_resnet.py)."""
    old = jcore.globals_["FLAGS_seed"]
    jcore.globals_["FLAGS_seed"] = 0
    yield
    jcore.globals_["FLAGS_seed"] = old


def resnet_train_and_eval(fluid, resnet, depth=18, image=16, classes=4,
                          lr=0.01):
    """models/resnet.py's train step with the eval clone taken before the
    optimizer: (main, startup, test, [loss, acc, pred])."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("image", shape=[3, image, image], dtype="float32")
        label = fluid.data("label", shape=[1], dtype="int64")
        pred = resnet.resnet(img, classes, depth)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        acc = fluid.layers.accuracy(pred, label)
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(lr, momentum=0.9).minimize(loss)
    return main, startup, test, [loss.name, acc.name, pred.name]


def _image_feed(seed, batch=2, image=16, classes=4):
    r = np.random.RandomState(seed)
    return {"image": r.rand(batch, 3, image, image).astype(np.float32),
            "label": r.randint(0, classes, (batch, 1)).astype(np.int64)}


def _ops(program):
    """(type, inputs, outputs, public attrs) of every op of block 0."""
    return [(op.type, {s: list(n) for s, n in op.inputs.items()},
             {s: list(n) for s, n in op.outputs.items()},
             {k: v for k, v in op.attrs.items() if not k.startswith("_")})
            for op in program.global_block().ops]


def _census(program):
    types = [op.type for op in program.global_block().ops]
    return {t: types.count(t) for t in FUSED + ("batch_norm", "relu")}


def _persistables(program):
    return sorted(v.name for v in program.global_block().vars.values()
                  if v.persistable)


def _jax_init(startup, main):
    scope = jcore.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor().run(startup)
    return scope, {n: np.asarray(scope.find_var(n).get_tensor().array)
                   for n in _persistables(main)
                   if scope.find_var(n) is not None}


def _state(scope, names):
    return [scope.find_var(n).value().array.numpy().copy() for n in names]


def _assert_runs_equal(a, b):
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert np.array_equal(u, v)


# ------------------------------------------------ no strategy: plain runs
def _three_steps(program, startup, feeds, fetch, init, wrap):
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    set_params_from_numpy(scope, init)
    prog = wrap(program)
    outs = [exe.run(prog, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]
    assert exe._last_run_mode == "compiled"
    return outs, _state(scope, sorted(init))


WRAPS = {
    "compiled": lambda p: tfluid.CompiledProgram(p),
    "data_parallel": lambda p: tfluid.CompiledProgram(p).with_data_parallel(
        loss_name="unused", places=[CPU]),
    "empty_build_strategy": lambda p: tfluid.CompiledProgram(
        p, build_strategy=tfluid.BuildStrategy()).with_data_parallel(
        exec_strategy=tfluid.ExecutionStrategy()),
}


@pytest.mark.parametrize("wrap", sorted(WRAPS))
def test_resnet_compiled_program_is_the_plain_run(wrap):
    main, startup, _, fetch = resnet_train_and_eval(tfluid, tresnet)
    init = {n: np.random.RandomState(i).rand(
        *main.global_block().var(n).shape).astype(np.float32) * 0.1 + 0.5
        for i, n in enumerate(_persistables(main))
        if main.global_block().var(n).dtype == tfluid.core.VarDesc.VarType.FP32
        and "velocity" not in n}
    feeds = [_image_feed(s) for s in range(3)]
    plain = _three_steps(main, startup, feeds, fetch[:2], init, lambda p: p)
    got = _three_steps(main, startup, feeds, fetch[:2], init, WRAPS[wrap])
    _assert_runs_equal(plain[0], got[0])
    _assert_runs_equal([plain[1]], [got[1]])


def _bert_feed(step, b=4, s=16, n_mask=10):
    r = np.random.RandomState(step)
    mask = np.ones((b, s), np.float32)
    mask[0, 10:] = 0.0
    return {"src_ids": r.randint(0, BERT_CFG["vocab_size"], (b, s)),
            "pos_ids": np.tile(np.arange(s), (b, 1)),
            "sent_ids": r.randint(0, BERT_CFG["type_vocab"], (b, s)),
            "mask_pos": r.randint(0, b * s, (n_mask, 1)),
            "mask_label": r.randint(0, BERT_CFG["vocab_size"], (n_mask, 1)),
            "input_mask": mask}


@pytest.mark.parametrize("wrap", sorted(WRAPS))
def test_bert_compiled_program_is_the_plain_run(wrap):
    with tfluid.unique_name.guard():
        main, startup, _, fetches = tbert.build_bert_pretrain_program(
            BERT_CFG, seq_len=16, dropout=0.1, lr=1e-3, use_input_mask=True)
    startup.random_seed = 5
    fetch = [fetches[0].name]
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    init = dict(zip(_persistables(main),
                    _state(scope, _persistables(main))))
    feeds = [_bert_feed(s) for s in range(3)]
    plain = _three_steps(main, startup, feeds, fetch, init, lambda p: p)
    got = _three_steps(main, startup, feeds, fetch, init, WRAPS[wrap])
    _assert_runs_equal(plain[0], got[0])
    _assert_runs_equal([plain[1]], [got[1]])


def test_allow_mixed_compilation_keeps_a_pure_block_compiled():
    """The flag pins a block with an island to the interpreter; a block
    without one compiles whole either way (the TPU package's rule)."""
    with tfluid.unique_name.guard():
        main, startup, _, fetches = tbert.build_bert_pretrain_program(
            BERT_CFG, seq_len=16, dropout=0.0, lr=1e-3, use_input_mask=True)
    es = tfluid.ExecutionStrategy()
    es.allow_mixed_compilation = False
    cp = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=fetches[0].name, exec_strategy=es)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(cp, feed=_bert_feed(0), fetch_list=[fetches[0]], scope=scope)
    assert exe._last_run_mode == "compiled"
    assert tfluid.core.get_flag("FLAGS_executor_segmentation") is True


# --------------------------------------------------- the fuse passes
def _both_resnets():
    t = resnet_train_and_eval(tfluid, tresnet)
    j = resnet_train_and_eval(jfluid, jresnet)
    assert _ops(t[0]) == _ops(j[0]) and _ops(t[2]) == _ops(j[2])
    return t, j


PASS_SETS = {"elewise": ["fuse_elewise_add_act_pass"],
             "bn_act": ["fuse_bn_act_pass"],
             "both": ["fuse_elewise_add_act_pass", "fuse_bn_act_pass"]}


@pytest.mark.parametrize("which", ["train", "eval"])
@pytest.mark.parametrize("passes", sorted(PASS_SETS))
def test_fuse_passes_rewrite_resnet_as_the_tpu_package(which, passes):
    t, j = _both_resnets()
    idx = 0 if which == "train" else 2
    fetch = t[3]
    tp = tir.PassManager(PASS_SETS[passes]).apply(t[idx], protected=fetch)
    jp = jir.PassManager(PASS_SETS[passes]).apply(j[idx], protected=fetch)
    assert _ops(tp) == _ops(jp)
    assert sorted(tp.global_block().vars) == sorted(jp.global_block().vars)
    census = _census(tp)
    if which == "train":
        # the grad ops read every add and batch_norm output
        assert census["fused_batch_norm_act"] == 0
        assert census["fused_elemwise_activation"] == 0
    else:
        # ResNet-18: the stem's and each of 8 blocks' first batch_norm +
        # relu, and each block's residual add + relu
        assert census["fused_batch_norm_act"] == (
            9 if passes in ("bn_act", "both") else 0)
        assert census["fused_elemwise_activation"] == (
            8 if passes in ("elewise", "both") else 0)


def _eval_runs(test, startup, init, feeds, fetch, bs=None, es=None,
               share=None):
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    set_params_from_numpy(scope, init)
    cp = tfluid.CompiledProgram(test, build_strategy=bs)
    if es is not None:
        cp = cp.with_data_parallel(exec_strategy=es)
    outs = [exe.run(cp, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]
    return outs, exe._last_run_mode, cp


def _fuse_strategy():
    bs = tfluid.BuildStrategy()
    bs.fuse_bn_act_ops = True
    bs.fuse_elewise_add_act_ops = True
    return bs


def test_fused_eval_program_against_unfused_and_the_tpu_package():
    t, j = _both_resnets()
    jscope, init = _jax_init(j[1], j[0])
    # moving statistics away from 0 and 1, so the eval path reads them
    r = np.random.RandomState(7)
    for n in list(init):
        if n.endswith(".mean") or "_mean" in n:
            init[n] = (r.rand(*init[n].shape) * 0.2).astype(np.float32)
        elif n.endswith(".var") or "_variance" in n:
            init[n] = (r.rand(*init[n].shape) + 0.5).astype(np.float32)
    feeds = [_image_feed(10 + s) for s in range(3)]
    fetch = t[3]
    plain, mode, _ = _eval_runs(t[2], t[1], init, feeds, fetch)
    assert mode == "compiled"
    fused, mode, cp = _eval_runs(t[2].clone(), t[1], init, feeds, fetch,
                                 bs=_fuse_strategy())
    assert _census(cp._program)["fused_batch_norm_act"] == 9
    # the stateful fused op is an island: compiled segments around it
    assert mode == "segmented"
    _assert_runs_equal(plain, fused)
    es = tfluid.ExecutionStrategy()
    es.allow_mixed_compilation = False
    interp, mode, _ = _eval_runs(t[2].clone(), t[1], init, feeds, fetch,
                                 bs=_fuse_strategy(), es=es)
    assert mode == "interpreted"
    _assert_runs_equal(fused, interp)
    # the TPU package's fused eval program on the same values
    jtest = jir.PassManager(["fuse_elewise_add_act_pass",
                             "fuse_bn_act_pass"]).apply(j[2],
                                                        protected=fetch)
    for n, a in init.items():
        v = jscope.find_var(n)
        if v is not None:
            v.get_tensor().set(a)
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor()
        for f, got in zip(feeds, fused):
            want = jexe.run(jtest, feed=f, fetch_list=fetch)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, np.asarray(w).reshape(g.shape),
                                           **PKG_TOL)


def test_share_vars_from_reads_the_trained_scope():
    """The reference's eval idiom: the train program compiled with a
    loss, the test clone compiled with share_vars_from=it and run with no
    scope reads the trained variables."""
    main, startup, test, fetch = resnet_train_and_eval(tfluid, tresnet)
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    train = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=fetch[0], build_strategy=_fuse_strategy())
    for s in range(2):
        exe.run(train, feed=_image_feed(s), fetch_list=fetch[:2],
                scope=scope)
    ev = tfluid.CompiledProgram(test).with_data_parallel(
        share_vars_from=train, build_strategy=_fuse_strategy())
    feed = _image_feed(9)
    got = exe.run(ev, feed=feed, fetch_list=fetch)
    want = exe.run(test, feed=feed, fetch_list=fetch, scope=scope)
    _assert_runs_equal([got], [want])
    unrun = tfluid.CompiledProgram(test).with_data_parallel(
        share_vars_from=tfluid.CompiledProgram(main))
    with pytest.raises(ValueError, match="has not run"):
        exe.run(unrun, feed=feed, fetch_list=fetch)


def test_refetch_after_fusion_restores_the_pristine_program():
    """tests/test_ir_passes.py:350 on the port."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", shape=[4], dtype="float32")
            y = fluid.data("y", shape=[4], dtype="float32")
            h = fluid.layers.elementwise_add(x, y)
            out = fluid.layers.relu(h)
        return main, startup, h, out
    main, startup, mid, out = build(tfluid)
    bs = tfluid.BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    cp = tfluid.CompiledProgram(main, build_strategy=bs)
    rng = np.random.RandomState(14)
    feed = {"x": rng.randn(2, 4).astype("float32"),
            "y": rng.randn(2, 4).astype("float32")}
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    (o1,) = exe.run(cp, feed=feed, fetch_list=[out.name], scope=scope)
    assert "fused_elemwise_activation" in [
        op.type for op in cp._program.global_block().ops]
    o2, m2 = exe.run(cp, feed=feed, fetch_list=[out.name, mid.name],
                     scope=scope)
    assert "fused_elemwise_activation" not in [
        op.type for op in cp._program.global_block().ops]
    np.testing.assert_allclose(o1, o2, rtol=1e-6)
    np.testing.assert_allclose(m2, feed["x"] + feed["y"], rtol=1e-6)
    np.testing.assert_array_equal(o1, np.maximum(feed["x"] + feed["y"], 0))


def test_data_parallel_refuses_what_needs_more_devices():
    main, startup, _, fetch = resnet_train_and_eval(tfluid, tresnet)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=fetch[0], places=[CPU, CPU])
    cp = tfluid.CompiledProgram(main).with_data_parallel(loss_name=fetch[0])
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(NotImplementedError, match="n_steps > 1"):
        exe.run(cp, feed=_image_feed(0), fetch_list=fetch[:1], scope=scope,
                n_steps=2)
    # a window passes through the plain CompiledProgram
    win = {k: np.stack([v, v]) for k, v in _image_feed(0).items()}
    out = exe.run(tfluid.CompiledProgram(main), feed=win,
                  fetch_list=fetch[:1], scope=scope, n_steps=2)
    assert out[0].shape[0] == 2


def test_strategies_carry_the_tpu_package_defaults():
    from paddle_tpu.fluid import compiler as jcomp
    for tcls, jcls in ((tfluid.BuildStrategy, jcomp.BuildStrategy),
                       (tfluid.ExecutionStrategy, jcomp.ExecutionStrategy)):
        assert vars(tcls()) == vars(jcls())
    for name in ("ReduceStrategy", "GradientScaleStrategy"):
        t = getattr(tfluid.BuildStrategy, name)
        j = getattr(jcomp.BuildStrategy, name)
        assert {k: v for k, v in vars(t).items() if not k.startswith("_")} \
            == {k: v for k, v in vars(j).items() if not k.startswith("_")}


# --------------------------------------------- tooling passes, registry
def test_graph_viz_pass_writes_the_tpu_package_dot(tmp_path):
    t, j = _both_resnets()
    texts = []
    for ir, prog, name in ((tir, t[2], "t.dot"), (jir, j[2], "j.dot")):
        p = ir.get_pass("graph_viz_pass")
        p.set("graph_viz_path", str(tmp_path / name))
        p.apply(ir.Graph(prog))
        texts.append((tmp_path / name).read_text())
    assert texts[0] == texts[1] and texts[0].startswith("digraph G {")
    bs = tfluid.BuildStrategy()
    bs.debug_graphviz_path = str(tmp_path / "bs.dot")
    exe, scope = tfluid.Executor(CPU), tfluid.Scope()
    exe.run(t[1], scope=scope)
    exe.run(tfluid.CompiledProgram(t[2], build_strategy=bs),
            feed=_image_feed(0), fetch_list=t[3][:1], scope=scope)
    assert (tmp_path / "bs.dot").read_text().startswith("digraph G {")


def test_block_segmentation_pass_matches_the_tpu_package():
    t, j = _both_resnets()
    names = ["fuse_bn_act_pass", "block_segmentation_pass"]
    tp = tir.PassManager(names).apply(t[2], protected=t[3])
    jp = jir.PassManager(names).apply(j[2], protected=t[3])
    assert tp._segment_plan == jp._segment_plan
    kinds = [s["kind"] for s in tp._segment_plan]
    assert kinds.count("island") == 9
    assert all(r == "stateful" for s in tp._segment_plan
               for r in s["island_reasons"])


def test_identity_passes_leave_the_program():
    t, j = _both_resnets()
    before = _ops(t[0])
    absorbed = sorted(n for n in jir.all_registered_passes()
                      if isinstance(jir.get_pass(n), jir.AbsorbedPass))
    assert absorbed == sorted(
        n for n in tir.all_registered_passes()
        if isinstance(tir.get_pass(n), tir.AbsorbedPass))
    tir.PassManager(absorbed + ["graph_to_program_pass"]).apply(t[0])
    assert _ops(t[0]) == before


def test_pass_registries_are_equal():
    assert tir.all_registered_passes() == jir.all_registered_passes()


# ------------------------------------------- chip_smoke's phase 19
def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_19", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_resnet50_census_is_chip_smokes():
    """chip_smoke's CP_RESNET_CENSUS is what the TPU package's passes give
    on the ResNet-50 programs phase 19 builds (its widths but the image,
    which no pass reads), and what the port's give."""
    cs = _chip_smoke()
    for fluid, resnet, ir in ((jfluid, jresnet, jir),
                              (tfluid, tresnet, tir)):
        main, _, test, fetch = resnet_train_and_eval(
            fluid, resnet, depth=50, image=32, classes=1000)
        names = ["fuse_elewise_add_act_pass", "fuse_bn_act_pass"]
        census = {which: {t: [op.type for op in ir.PassManager(names).apply(
            prog, protected=fetch).global_block().ops].count(t)
            for t in cs.CP_RESNET_CENSUS[which]}
            for which, prog in (("train", main), ("eval", test))}
        assert census == cs.CP_RESNET_CENSUS


def test_chip_smoke_phase_19_rehearsed(monkeypatch):
    """phase_compiler on the CPU: ResNet-50 at image 64 and batch 4,
    BERT at 2 layers of hidden 64 and batch 2, the longctx lane at its
    CPU size (its kernel comparisons need the card), the multiprocess
    loader and run_check, with every comparison it makes on the card and
    no kernel to count."""
    cs = _chip_smoke()
    zeros = cs.NO_KERNELS
    monkeypatch.setattr(tfluid, "CUDAPlace", lambda i=0: CPU)
    monkeypatch.setattr(tbert, "bert_base_config", lambda: dict(
        BERT_CFG, max_len=128))
    monkeypatch.setattr(cs, "TRAIN_BATCH", 2)
    monkeypatch.setattr(cs, "CP_IMAGE", 64)
    monkeypatch.setattr(cs, "CP_RESNET_BATCH", 4)
    monkeypatch.setattr(cs, "MP_BATCHES", 16)
    for name in ("TRAIN_STEP_WANT", "LONGCTX_WANT"):
        monkeypatch.setattr(cs, name, zeros)
    monkeypatch.setattr(cs, "_step_want", lambda *a, **k: zeros)
    monkeypatch.setattr(cs, "_attention_route", lambda main: "f32")
    monkeypatch.setattr(cs, "_launch_counts", lambda: zeros)
    monkeypatch.setattr(cs, "_device_kernel_counts",
                        lambda fn, **k: (fn(), zeros)[1])
    clone = cs._clone_scope
    monkeypatch.setattr(cs, "_clone_scope",
                        lambda scope, names, dev: clone(scope, names, "cpu"))

    def gate(exe, delta, want, what):
        assert exe._last_run_mode == "compiled", what
        return exe._last_block.last_exec
    monkeypatch.setattr(cs, "_gate_run", gate)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)

    class _Stream:  # the longctx trace's side stream and graph
        def wait_stream(self, other):
            pass

    class _Graph:
        def replay(self):
            pass
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    from paddle_tpu_torch import bench
    lane, inputs = bench.bench_longctx, bench.longctx_inputs
    monkeypatch.setattr(bench, "bench_longctx", lambda device: dict(
        lane(iters=1, warmup=1, device="cpu"), bound_ms=0.365,
        power_limit="CPU"))
    monkeypatch.setattr(bench, "longctx_inputs", lambda device, **s: inputs(
        device=torch.device("cpu"), **bench.LONGCTX_CPU))
    monkeypatch.setattr(cs, "_cp_longctx", lambda f, b: {})
    lines = []
    monkeypatch.setattr(cs, "_log", lambda *a: lines.append(" ".join(
        str(x) for x in a)))
    out = cs.phase_compiler({}, {})
    assert (out["wrapper"], out["executed"]) == (zeros, zeros)
    assert out["resnet"]["census"] == cs.CP_RESNET_CENSUS
    text = "\n".join(lines)
    assert "FAIL" not in text
    for want in ("(no build strategy) vs Executor.run: 3 runs, every fetch "
                 "bitwise equal", "33 islands",
                 "allow_mixed_compilation=False (interpreted) vs segmented",
                 "BERT-base interpreted vs Executor.run after 3 steps",
                 "none of this process's", "run_check() on the card"):
        assert want in text, want
