"""RecomputeOptimizer and its remat lowering in paddle_tpu_torch
(``fluid/recompute_lowering.py``) against the plain step and against the
TPU package's remat run:

- an MLP of three fc layers with relu between two checkpoints (the
  reference's tests/test_backward_executor.py:614, relu for tanh): 5 SGD
  steps, losses and trained weights equal the plain run's at rtol 2e-5,
  atol 1e-6 (the reference's tolerance: autograd may sum fan-in grads in
  another order than append_backward's sum ops), and the plan engaged
  with no warning; a weight tied across segments falls back with the
  reference's warning; a state write inside a segment reaches the scope
  (:699);
- small BERT (3 layers, hidden 64, 4 heads, ffn 128, S = 16, batch 2)
  with ``recompute=True``: the plan engages with no warning, its losses
  match the plain build's at rtol 2e-5 and the TPU package's remat run at
  rtol 1e-4, atol 1e-5 (test_torch_train_slice.py's tolerance);
  compiled against interpreted (which does not remat) at rtol 2e-5;
- a segment holding dropout 0.1 falls back with the warning;
- the liveness plan: between a segment's forward and its span the step's
  env holds the segment's boundary values and none of its interior;
- autograd through the gather kernel (what a span runs for the MLM
  head's gather) sums repeated rows as the gather_grad kernel does,
  bitwise, and as the TPU package's grad at 1e-6.
"""
import warnings

import numpy as np
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import recompute_lowering
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.registry import OPS as TOPS

REMAT_RTOL = 2e-5
CFG = dict(vocab_size=128, hidden=64, layers=3, heads=4, ffn=128,
           max_len=16, type_vocab=2)
S, B, N_MASK = 16, 2, 5


def _mlp(use_remat, tied=False):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.data("x", shape=[6], dtype="float32")
        y = tfluid.data("y", shape=[1], dtype="float32")
        h = tfluid.layers.fc(x, 16, act="relu")
        ck = []
        for i in range(3):
            nm = "rm_shared" if tied else f"rm_{i}"
            h = tfluid.layers.fc(h, 16, act="relu",
                                 param_attr=tfluid.ParamAttr(name=nm + "_w"),
                                 bias_attr=False)
            ck.append(h)
        pred = tfluid.layers.fc(h, 1)
        loss = tfluid.layers.mean(tfluid.layers.square(
            tfluid.layers.elementwise_sub(pred, y)))
        opt = tfluid.optimizer.SGD(0.1)
        if use_remat:
            opt = tfluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ck[:-1])  # 2 boundaries → 2 segments
        opt.minimize(loss)
    return main, startup, loss


def _train(main, startup, loss, feed, steps=5, weight="rm_1_w"):
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    out = [float(exe.run(main, feed=feed, fetch_list=[loss],
                         scope=scope)[0][0]) for _ in range(steps)]
    v = scope.find_var(weight)
    return out, (v.value().array.clone().numpy() if v else None), exe, scope


def _mlp_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(8, 6).astype("float32"),
            "y": rng.rand(8, 1).astype("float32")}


def test_recompute_mlp_matches_plain():
    plain, w_plain, _, _ = _train(*_mlp(False), _mlp_feed())
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a fallback warning fails the test
        remat, w_remat, exe, _ = _train(*_mlp(True), _mlp_feed())
    assert exe._last_run_mode == "compiled"
    plan = exe._last_block._remat_plan
    assert plan is not None and len(plan.segments) == 2
    np.testing.assert_allclose(remat, plain, rtol=REMAT_RTOL, atol=1e-6)
    np.testing.assert_allclose(w_remat, w_plain, rtol=REMAT_RTOL, atol=1e-6)


def test_recompute_tied_weight_falls_back_with_warning():
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        losses, _, exe, _ = _train(*_mlp(True, tied=True), _mlp_feed(),
                                   weight="rm_shared_w")
    msgs = [str(r.message) for r in rec]
    assert any("RecomputeOptimizer checkpoints not lowerable onto" in m
               and "executing without rematerialization" in m
               for m in msgs), msgs
    assert exe._last_block._remat_plan is None
    assert all(np.isfinite(losses))


def test_recompute_segment_keeps_state_writebacks():
    """A persistable written inside a segment (a running sum, as
    batch_norm's running mean in the reference test) must reach the
    scope: boundary values include state writebacks."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.data("x", shape=[6], dtype="float32")
        y = tfluid.data("y", shape=[1], dtype="float32")
        h = tfluid.layers.fc(x, 8, act="relu")
        ck1 = h
        h = tfluid.layers.fc(h, 8, bias_attr=False)
        acc = main.global_block().create_var(
            name="running_sum", shape=(1,), dtype="float32",
            persistable=True)
        acc.stop_gradient = True
        sv = startup.global_block().create_var(
            name="running_sum", shape=(1,), dtype="float32",
            persistable=True)
        tfluid.initializer.Constant(0.0)(sv, startup.global_block())
        main.global_block().append_op(
            type="elementwise_add",
            inputs={"X": [acc], "Y": [tfluid.layers.mean(h)]},
            outputs={"Out": [acc]}, attrs={"axis": -1})
        h = tfluid.layers.fc(h, 8, act="relu")
        ck2 = h
        pred = tfluid.layers.fc(h, 1)
        loss = tfluid.layers.mean(tfluid.layers.square(
            tfluid.layers.elementwise_sub(pred, y)))
        opt = tfluid.optimizer.RecomputeOptimizer(tfluid.optimizer.SGD(0.1))
        opt._set_checkpoints([ck1, ck2])
        opt.minimize(loss)
    feed = _mlp_feed()
    feed["x"] = feed["x"] + 3.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, acc_v, exe, scope = _train(main, startup, loss, feed, steps=3,
                                      weight="running_sum")
    cb = exe._last_block
    assert cb._remat_plan is not None
    seg = cb._remat_plan.segments[0]
    assert "running_sum" in seg.outs
    assert abs(float(acc_v[0])) > 1e-6, "the in-segment write was dropped"


# ----------------------------------------------------------------- BERT
def _bert(fluid, bert, recompute, dropout=0.0):
    with fluid.unique_name.guard():
        main, startup, _, fetches = bert.build_bert_pretrain_program(
            CFG, seq_len=S, dropout=dropout, lr=1e-3, recompute=recompute)
    startup.random_seed = 5
    return main, startup, fetches


def _bert_feed(step):
    r = np.random.RandomState(step)
    return {"src_ids": r.randint(0, CFG["vocab_size"], (B, S)),
            "pos_ids": np.tile(np.arange(S), (B, 1)),
            "sent_ids": r.randint(0, CFG["type_vocab"], (B, S)),
            "mask_pos": r.randint(0, B * S, (N_MASK, 1)),
            "mask_label": r.randint(0, CFG["vocab_size"], (N_MASK, 1))}


def _bert_losses(recompute, arrays, run_mode="compiled", steps=3):
    saved = tcore.globals_["FLAGS_executor_mode"]
    tcore.set_flag("FLAGS_executor_mode", run_mode)
    try:
        main, startup, fetches = _bert(tfluid, tbert, recompute)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        set_params_from_numpy(scope, arrays)
        losses = [float(exe.run(main, feed=_bert_feed(i), fetch_list=fetches,
                                scope=scope)[0][0]) for i in range(steps)]
        assert exe._last_run_mode == run_mode
        return losses, exe
    finally:
        tcore.set_flag("FLAGS_executor_mode", saved)


def test_recompute_bert_matches_plain_and_jax():
    jm, js, jf = _bert(jfluid, jbert, True)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
              for v in jm.global_block().vars.values() if v.persistable}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jl = [float(jexe.run(jm, feed=_bert_feed(i), fetch_list=jf,
                             scope=jscope)[0][0]) for i in range(3)]
        remat, exe = _bert_losses(True, arrays)
    plan = exe._last_block._remat_plan
    assert plan is not None and len(plan.segments) == CFG["layers"] - 1
    plain, _ = _bert_losses(False, arrays)
    interp, _ = _bert_losses(True, arrays, "interpreted")
    np.testing.assert_allclose(remat, plain, rtol=REMAT_RTOL)
    np.testing.assert_allclose(remat, interp, rtol=REMAT_RTOL)
    np.testing.assert_allclose(remat, jl, rtol=1e-4, atol=1e-5)


def test_recompute_segment_with_dropout_falls_back():
    main, startup, fetches = _bert(tfluid, tbert, True, dropout=0.1)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        (loss,) = exe.run(main, feed=_bert_feed(0), fetch_list=fetches,
                          scope=scope)
    msgs = [str(r.message) for r in rec]
    # the segment's first random op: its attention (dropout_rate 0.1)
    assert any("not lowerable" in m
               and "rng op 'fused_attention_qkv' inside a segment" in m
               for m in msgs), msgs
    assert exe._last_block._remat_plan is None
    assert np.isfinite(loss).all()


def test_liveness_frees_segment_interiors(monkeypatch):
    """Record the step's env as each span starts: it holds the span's
    segment inputs and its boundary values' grads, and no value of any
    segment's interior; each segment's forward leaves only its boundary
    values behind."""
    main, startup, fetches = _bert(tfluid, tbert, True)
    seen = {"fwd": [], "span": []}
    fwd_run, span_run = (recompute_lowering.SegmentForward.run,
                         recompute_lowering.Span.run)

    def fwd(self, env):
        before = set(env)
        fwd_run(self, env)
        seen["fwd"].append((self.seg, set(env) - before))

    def span(self, env):
        seen["span"].append((self.seg, set(env)))
        span_run(self, env)
    monkeypatch.setattr(recompute_lowering.SegmentForward, "run", fwd)
    monkeypatch.setattr(recompute_lowering.Span, "run", span)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_bert_feed(0), fetch_list=fetches, scope=scope)
    plan = exe._last_block._remat_plan
    interior = set()
    for seg in plan.segments:
        written = {n for op in seg.ops for n in op.output_arg_names}
        interior |= written - set(seg.outs)
    assert len(interior) >= 40  # 25 a layer, 2 layers remat'd
    assert [s for s, _ in seen["fwd"]] == plan.segments
    for seg, added in seen["fwd"]:
        assert added <= set(seg.outs), added - set(seg.outs)
    assert len(seen["span"]) == len(plan.segments)
    for seg, env in seen["span"]:
        assert not env & interior, sorted(env & interior)[:5]
        assert set(seg.ins) - {"@EMPTY@"} <= env
        assert {n + "@GRAD" for n in seg.outs
                if n + "@GRAD" in main.global_block().vars} <= env


def test_gather_autograd_matches_gather_grad():
    r = np.random.RandomState(7)
    x = r.normal(size=(10, 6)).astype(np.float32)
    idx = np.array([[3], [1], [3], [9], [3], [1]], np.int64)
    g = r.normal(size=(6, 6)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    out = TOPS.get("gather").kernel({"X": [tx], "Index": [
        torch.from_numpy(idx)]}, {})["Out"][0]
    (auto,) = torch.autograd.grad(out, tx, torch.from_numpy(g))
    kern = TOPS.get("gather_grad").kernel(
        {"X": [torch.from_numpy(x)], "Index": [torch.from_numpy(idx)],
         "Out@GRAD": [torch.from_numpy(g)]}, {})["X@GRAD"][0]
    assert torch.equal(auto, kern)
    _, vjp = jax.vjp(lambda a: JOPS.get("gather").kernel(
        {"X": [a], "Index": [jnp.asarray(idx)]}, {})["Out"][0],
        jnp.asarray(x))
    np.testing.assert_allclose(auto.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)
