"""BERT pretraining under LAMB with a global-norm clip in paddle_tpu_torch,
against the TPU package, on the CPU: the slice of chip_smoke.py's phase
17 at a small width.

- A 2-layer, hidden-64 BERT (tests/test_torch_train_slice.py's config)
  built from models/bert.py's pieces, trained by Lamb (paddle_tpu/fluid/
  optimizer.py:528) under BERT's schedule (linear_lr_warmup over
  polynomial_decay), weight decay 0.01 on every weight but the LayerNorm
  scales and biases and every bias, the grads clipped by global norm 1.0
  (paddle_tpu/fluid/clip.py:41): the same ops and ProgramDesc bytes as
  the TPU package's, and 5 steps from the same numpy start at rtol 1e-4,
  atol 1e-5 (tests/test_book_models.py:388-418's tolerance) in losses,
  LRs and every persistable, the K projections' biases excepted as in
  tests/test_torch_lr_schedules.py (an exact-zero grad whose rounding
  noise LAMB turns into a step of up to ±lr). Compiled and interpreted
  bitwise at dropout 0.1.
- Checkpoints with the new state: LAMB under GradientMerge (k = 4,
  paddle_tpu/fluid/optimizer.py:715), killed mid-window and resumed
  through save_checkpoint / resume_from, replays the unbroken run's
  losses and state bitwise (the merge step and the accumulators are
  persistables); a checkpoint of the TPU package's LAMB run loads into
  the port and continues within tests/test_torch_checkpoint.py's
  rtol = atol = 1e-5.
- chip_smoke.py's phase 17 rehearsed on the CPU at that width (the card
  patched to the CPU, the launch gates to zero kernels), and its launch
  tuples read from its programs at full width.
"""
import functools
import sys
import os

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import clip as jclip
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import clip as tclip
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import bert as tbert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=128, hidden=64, layers=2, heads=4, ffn=128, max_len=16,
           type_vocab=2)  # tests/test_torch_train_slice.py's
S, B, N_MASK = 16, 4, 10
PEAK, DECAY, WARMUP = 1e-3, 8, 3
RTOL, ATOL = 1e-4, 1e-5  # tests/test_book_models.py:388-418
LOSS_TOL = 1e-5          # tests/test_torch_checkpoint.py's, across packages


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
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


def _no_decay(p):
    return p.name.startswith("layer_norm") or p.name.endswith(".b_0")


def _lamb_bert(fluid, dropout=0.0, k=None):
    """The masked-LM step with path (a)'s optimizer (under GradientMerge
    of ``k`` micro-steps when ``k``) → (main, startup, loss, lr)."""
    bert = jbert if fluid is jfluid else tbert
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
        opt = fluid.optimizer.Lamb(
            learning_rate=lr, lamb_weight_decay=0.01,
            exclude_from_weight_decay_fn=_no_decay,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0))
        if k is not None:
            opt = fluid.optimizer.GradientMergeOptimizer(opt, k_steps=k)
        opt.minimize(loss)
    main.random_seed = startup.random_seed = 5
    return main, startup, loss, lr


def _feed(step):
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


def _ops(program):
    return [[(op.type, {k: v for k, v in op.attrs.items()
                        if not k.startswith("_") and k != "sub_block"})
             for op in b.ops] for b in program.blocks]


def _persistables(scope, program):
    out = {}
    for v in program.list_vars():
        sv = scope.find_var(v.name) if v.persistable else None
        if sv is not None and sv.is_initialized():
            out[v.name] = sv.value().array.clone()
    return out


def _jax_floats(scope, program):
    arrays = {v.name: np.asarray(scope.find_var(v.name).get_tensor())
              for v in program.global_block().vars.values()
              if v.persistable and scope.find_var(v.name) is not None}
    return {n: a for n, a in arrays.items() if a.dtype.kind == "f"}


def _port(mode, dropout=0.0, k=None):
    tcore.set_flag("FLAGS_executor_mode", mode)
    main, startup, loss, lr = _lamb_bert(tfluid, dropout, k)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    return main, startup, loss, lr, exe, scope


def _steps(exe, main, loss, lr, scope, steps):
    out = [exe.run(main, feed=_feed(s), fetch_list=[loss, lr], scope=scope)
           for s in steps]
    return [(a.copy(), b.copy()) for a, b in out]


# ------------------------------------------------------------ the slice
@pytest.fixture(scope="module")
def tpu_run(tmp_path_factory):
    """One run of the TPU package's LAMB BERT, shared by the slice and the
    checkpoint test (its compile is most of each): the startup values, 6
    steps' losses and LRs, the persistables after 5 steps, and a
    checkpoint after 2 (global step 3)."""
    jm, js, jl, jlr = _lamb_bert(jfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    run = {"start": _jax_floats(jscope, jm), "losses": [], "lrs": [],
           "ckpt": str(tmp_path_factory.mktemp("tpu_lamb_ckpt"))}
    for step in range(6):
        if step == 2:
            with jfluid.scope_guard(jscope):
                jfluid.save_checkpoint(jexe, run["ckpt"], jm, scope=jscope,
                                       global_step=3)
        if step == 5:
            run["after5"] = _jax_floats(jscope, jm)
        a, b = jexe.run(jm, feed=_feed(step), fetch_list=[jl, jlr],
                        scope=jscope)
        run["losses"].append(float(a[0]))
        run["lrs"].append(float(b[0]))
    return run


def test_lamb_bert_matches_the_tpu_package(tpu_run):
    jm, js, _, _ = _lamb_bert(jfluid)
    tm, ts, tl, tlr = _lamb_bert(tfluid)
    assert _ops(tm) == _ops(jm)
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.serialize_to_string() == js.serialize_to_string()
    ops = tm.global_block().ops
    assert texecutor._whole_compilable(ops)
    n = len(tm.all_parameters())
    assert [op.type for op in ops].count("squared_l2_norm") == n
    assert [op.type for op in ops].count("lamb") == n
    wd = {op.input("Param")[0]: op.attr("weight_decay") for op in ops
          if op.type == "lamb"}
    assert wd["fc_0.w_0"] == 0.01 and wd["word_embedding"] == 0.01
    assert wd["fc_0.b_0"] == wd["layer_norm_0.w_0"] == 0.0
    tcore.set_flag("FLAGS_executor_mode", "compiled")
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(ts, scope=tscope)
    set_params_from_numpy(tscope, tpu_run["start"])
    tloss, tlrs = [], []
    for step in range(5):
        c, d = texe.run(tm, feed=_feed(step), fetch_list=[tl, tlr],
                        scope=tscope)
        assert texe._last_run_mode == "compiled"
        tloss.append(float(c[0]))
        tlrs.append(float(d[0]))
    np.testing.assert_allclose(tlrs, tpu_run["lrs"][:5], rtol=1e-6,
                               atol=1e-6 * PEAK)
    np.testing.assert_allclose(tloss, tpu_run["losses"][:5], rtol=RTOL,
                               atol=ATOL)
    k_bias = {f"fc_{6 * i + 1}.b_0" for i in range(CFG["layers"])}
    for name, want in tpu_run["after5"].items():
        got = tscope.find_var(name).value().array.numpy()
        atol = 2 * sum(tlrs) if name in k_bias else ATOL
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                                   err_msg=name)


def test_lamb_bert_compiled_equals_interpreted():
    main, _, loss, lr, exe, scope = _port("compiled", 0.1)
    got = _steps(exe, main, loss, lr, scope, range(6))
    assert exe._last_run_mode == "compiled"
    cstate = _persistables(scope, main)
    main, _, loss, lr, exe, scope = _port("interpreted", 0.1)
    want = _steps(exe, main, loss, lr, scope, range(6))
    for (a, b), (c, d) in zip(got, want):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    istate = _persistables(scope, main)
    assert sorted(cstate) == sorted(istate)
    for n in cstate:
        assert torch.equal(cstate[n], istate[n]), n
    assert got[0][1].tolist() == [0.0] and got[-1][0] < got[1][0]


# --------------------------------------------------------- checkpoints
@pytest.mark.parametrize("mode", ["compiled", "interpreted"])
def test_lamb_gradient_merge_killed_mid_window_resumes_bitwise(tmp_path,
                                                               mode):
    """10 micro-steps unbroken against 6, a save, the kill (window 2, two
    micro-steps in), a resume and 4 more."""
    main, startup, loss, lr, exe, scope = _port(mode, 0.1, k=4)
    oracle = _steps(exe, main, loss, lr, scope, range(10))
    ostate = _persistables(scope, main)
    main, startup, loss, lr, exe, scope = _port(mode, 0.1, k=4)
    _steps(exe, main, loss, lr, scope, range(6))
    saved = _persistables(scope, main)
    step = [n for n in saved if n.startswith("gradient_merge_step")]
    accs = [n for n in saved if n.endswith("@GradientMerge_0")]
    assert len(step) == 1 and saved[step[0]].tolist() == [6]
    assert len(accs) == len(main.all_parameters())
    assert any(bool(saved[n].any()) for n in accs)  # mid-window
    tfluid.io.save_checkpoint(
        exe, str(tmp_path), main_program=main, scope=scope,
        global_step=tfluid.Executor._rng_counters[scope])
    del exe, scope  # the kill
    main, startup, loss, lr, exe, scope = _port(mode, 0.1, k=4)
    manifest = exe.resume_from(str(tmp_path), program=main, scope=scope)
    assert manifest["global_step"] == 7
    restored = _persistables(scope, main)
    for n in step + accs:
        assert torch.equal(restored[n], saved[n]), n
    resumed = _steps(exe, main, loss, lr, scope, range(6, 10))
    for (a, b), (c, d) in zip(resumed, oracle[6:]):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    rstate = _persistables(scope, main)
    for n in ostate:
        assert torch.equal(rstate[n], ostate[n]), n


def test_tpu_package_lamb_checkpoint_continues_in_the_port(tpu_run):
    main, _, loss, lr, exe, scope = _port("compiled")
    m = tfluid.load_checkpoint(exe, tpu_run["ckpt"], main, scope=scope)
    assert m["global_step"] == 3
    moments = [v.name for v in main.list_vars() if "_moment1_" in v.name]
    assert moments and all(scope.find_var(n).value().array.any()
                           for n in moments)
    got = [float(o[0][0]) for o in _steps(exe, main, loss, lr, scope,
                                          range(2, 6))]
    np.testing.assert_allclose(got, tpu_run["losses"][2:6], rtol=LOSS_TOL,
                               atol=LOSS_TOL)


# ------------------------------------------------- chip_smoke's phase 17
def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def test_chip_smoke_optimizer_gates():
    """The launch tuples phase 17 holds the card to follow from its
    programs at full width: (a) the train phase's, (b) the f32 route's at
    dropout 0; (a)'s clip vars are the global norm and its scale."""
    cs = _chip_smoke()
    cfg = tbert.bert_base_config()
    main = cs._cf_pretrain_program(cfg, cs.TRAIN_DROPOUT, cs._lamb())[0]
    ops = main.global_block().ops
    assert cs._step_want(ops, cs._attention_route(main)) == \
        cs.TRAIN_STEP_WANT
    norm, scale = cs._clip_vars(main)
    types = {n: op.type for op in ops for n in op.output_arg_names}
    assert types[norm] == "sqrt" and types[scale] == "elementwise_div"
    assert cs.GM_K * cs.GM_MICRO == cs.TRAIN_BATCH

    def merged(f, loss):
        f.optimizer.GradientMergeOptimizer(f.optimizer.Adam(cs.GM_LR),
                                           k_steps=cs.GM_K).minimize(loss)
    gm = cs._cf_pretrain_program(cfg, 0.0, merged)[0]
    assert cs._step_want(gm.global_block().ops, cs._attention_route(gm)) \
        == cs.GM_WANT


def test_chip_smoke_phase_17_rehearsed(monkeypatch):
    """phase_optimizers on the CPU at 2 layers of hidden 64, S = 16: every
    comparison it makes on the card (compiled against interpreted
    bitwise, the global norm against float64, the clip engaged, the
    merged step against the batch's, the small cases against the CPU),
    with no kernel to count."""
    cs = _chip_smoke()
    zeros = cs.NO_KERNELS
    monkeypatch.setattr(tfluid, "CUDAPlace", lambda i=0: tfluid.CPUPlace())
    monkeypatch.setattr(tbert, "bert_base_config", lambda: dict(CFG))
    monkeypatch.setattr(cs, "S", S)
    monkeypatch.setattr(cs, "TRAIN_BATCH", 8)
    monkeypatch.setattr(cs, "GM_MICRO", 2)
    monkeypatch.setattr(cs, "CHECK_BATCH", 2)
    # the K projections' biases (exact-zero grads) are 128 of ~130 k
    # elements at this width, ~1e-4 of BERT-base's
    monkeypatch.setattr(cs, "GM_SHARE", 1e-2)
    monkeypatch.setattr(cs, "TRAIN_STEP_WANT", zeros)
    monkeypatch.setattr(cs, "GM_WANT", zeros)
    monkeypatch.setattr(cs, "SMALL_EXECS", ("eager",) * cs.SMALL_RUNS)
    monkeypatch.setattr(cs, "DPSGD_N", 1 << 16)
    monkeypatch.setattr(cs, "OPT_TIMED", 3)
    monkeypatch.setattr(cs, "_step_want", lambda *a, **k: zeros)
    monkeypatch.setattr(cs, "_attention_route", lambda main: "f32")
    monkeypatch.setattr(cs, "_launch_counts", lambda: zeros)
    monkeypatch.setattr(cs, "_card_line", lambda: "CPU")
    monkeypatch.setattr(cs, "_drop", lambda exe: exe.close())
    monkeypatch.setattr(cs, "_dpsgd_law",
                        functools.partial(cs._dpsgd_law, device="cpu"))
    monkeypatch.setattr(cs, "_device_kernel_counts",
                        lambda fn, **k: (fn(), zeros)[1])

    def gate(exe, delta, want, what):
        assert exe._last_run_mode == "compiled", what
        return exe._last_block.last_exec
    monkeypatch.setattr(cs, "_gate_run", gate)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    lines = []
    monkeypatch.setattr(cs, "_log", lambda *a: lines.append(" ".join(
        str(x) for x in a)))
    out = cs.phase_optimizers(1.0)
    assert out == {"wrapper": zeros, "executed": zeros}
    text = "\n".join(lines)
    assert "FAIL" not in text
    for want in ("the clip engaged", "the global norm over",
                 "micro-steps 1-3 left", "after micro-step 4 vs one Adam",
                 "fluid.gradients", "dpsgd at sigma"):
        assert want in text, want
    assert tclip._gradient_clip_attr is None
