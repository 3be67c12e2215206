"""The recurrent models of chip_smoke's phase 21 on paddle_tpu_torch against
the TPU package, on the CPU, at 2 layers and a width of 32 (the builders
are chip_smoke's, each run in both packages):

- (a) the book's stacked-LSTM sentiment net (dynamic_lstm, every second
  reversed): 3 Adagrad steps on ragged batches from the TPU package's
  startup values, the losses and every persistable at rtol 1e-5,
  atol 1e-6 (rtol 1e-4 after a step: Adagrad divides by the root of the
  squared grads), the port's compiled runs bitwise its interpreter's;
  its op census after the inference passes equal to the TPU package's,
  and with a bias-free projection fc_lstm_fuse_pass's fusion_lstm;
- (b) the book's chapter 8 translator: the bidirectional GRUCell encoder
  and the attention decoder under layers.rnn, 2 Adam steps; its beam
  decode through BeamSearchDecoder and dynamic_decode, ids bitwise and
  scores at rtol 1e-5;
- (c) the legacy LoD path: the DynamicRNN scorer forward, compiled
  (segmented around its islands) bitwise interpreted; the contrib
  TrainingDecoder's 2 Adam steps; the contrib BeamSearchDecoder's step
  program run from the host for 4 steps and beam_search_decode, ids and
  LoDs bitwise; the encoder's fc_gru_fuse_pass.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy

RTOL, ATOL = 1e-5, 1e-6
W = 32        # widths: hidden, embedding
DICT = 60     # vocabularies
LEN = 6       # (b) padded lengths

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_rnn", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small kernels gain nothing from more,
    several test processes share the host's cores, and the CPU's BLAS
    may split a product differently from call to call when its threads
    are contended, which the bitwise checks here would see."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pin_seed():
    old = jcore.globals_["FLAGS_seed"]
    jcore.globals_["FLAGS_seed"] = 0
    yield
    jcore.globals_["FLAGS_seed"] = old


def _both(build, *a, **kw):
    with jfluid.unique_name.guard():
        j = build(jfluid, *a, **kw)
    with tfluid.unique_name.guard():
        t = build(tfluid, *a, **kw)
    return j, t


def _types(prog):
    return [op.type for op in prog.global_block().ops
            if op.type not in ("feed", "fetch")]


def _start_alike(jstart, tstart, jscope=None, tscope=None):
    """Both startups run; the port's scope gets the TPU package's values.
    → (jexe, jscope, texe, tscope, the persistable names)."""
    jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
    jscope = jscope or jcore.Scope()
    tscope = tscope or tfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    texe.run(tstart, scope=tscope)
    names = sorted(v.name for v in jstart.global_block().vars.values()
                   if v.persistable)
    set_params_from_numpy(tscope, {
        n: np.asarray(jscope.find_var(n).get_tensor().array).astype(
            tscope.find_var(n).value().array.numpy().dtype)
        for n in names if tscope.find_var(n) is not None})
    return jexe, jscope, texe, tscope, names


def _copy_scope(src, names):
    dst = tfluid.Scope()
    for n in list(names) + ["@RNG_COUNTER@"]:
        v = src.find_var(n)
        if v is not None and v.is_initialized():
            dst.var(n).set_value(tfluid.LoDTensor(v.value().array.clone()))
    return dst


def _interpreted(exe, main, feed, fetch, scope):
    tcore.set_flag("FLAGS_executor_mode", "interpreted")
    try:
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    finally:
        tcore.set_flag("FLAGS_executor_mode", "compiled")


def _lod_ids(rng, n, lens, hi):
    lens = rng.randint(lens[0], lens[1] + 1, n)
    offs = [0] + [int(x) for x in np.cumsum(lens)]
    return rng.randint(0, hi, (offs[-1], 1)).astype(np.int64), offs


def _feeds(spec):
    """{name: array or (array, offsets)} → (the TPU package's feed, the
    port's)."""
    jf, tf = {}, {}
    for k, v in spec.items():
        if isinstance(v, tuple):
            jf[k] = jcore.LoDTensor(v[0], lod=[v[1]])
            tf[k] = tfluid.LoDTensor(torch.from_numpy(v[0]), [v[1]])
        else:
            jf[k] = tf[k] = v
    return jf, tf


def _train_both(jmain, tmain, jstart, tstart, fetch_j, fetch_t, batches,
                rtol=RTOL, atol=ATOL):
    """Steps of both packages from the TPU package's start, the port
    compiled and interpreted: fetches and persistables compared. → (the
    port's executor, its scope, how each compiled run ran)."""
    jexe, jscope, texe, tscope, names = _start_alike(jstart, tstart)
    iscope = _copy_scope(tscope, names)
    modes = []
    for i, spec in enumerate(batches):
        jf, tf = _feeds(spec)
        with jfluid.scope_guard(jscope):
            jout = jexe.run(jmain, feed=jf, fetch_list=fetch_j)
        tout = texe.run(tmain, feed=tf, fetch_list=fetch_t, scope=tscope)
        modes.append(texe._last_run_mode)
        iout = _interpreted(texe, tmain, tf, fetch_t, iscope)
        for a, b, c in zip(tout, jout, iout):
            np.testing.assert_allclose(a, np.asarray(b), rtol=rtol,
                                       atol=atol, err_msg=f"step {i}")
            assert np.array_equal(a, c), f"step {i}: compiled != interpreted"
    for n in names:
        got = tscope.find_var(n).value().array
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jscope.find_var(n).get_tensor().array),
            rtol=rtol, atol=atol, err_msg=n)
        assert torch.equal(got, iscope.find_var(n).value().array), n
    return texe, tscope, modes


# ---------------------------------------------------------------- (a)
def _sentiment_batches(n, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        words, offs = _lod_ids(rng, batch, (2, 7), DICT)
        out.append({"words": (words, offs),
                    "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)})
    return out


def test_sentiment_stacked_lstm_against_the_tpu_package():
    (jm, js, _, _, jl, ja), (tm, ts, _, _, tl, ta) = _both(
        cs.rnn_sentiment_program, DICT, W, W, 2)
    assert _types(tm) == _types(jm)
    lstm = [op for op in tm.global_block().ops if op.type == "dynamic_lstm"]
    assert [op.attrs["is_reverse"] for op in lstm] == [False, True]
    _, _, modes = _train_both(jm, tm, js, ts, [jl, ja], [tl, ta],
                              _sentiment_batches(3), rtol=1e-4, atol=1e-5)
    assert modes == ["compiled"] * 3


def _served_census(tmp, build, place=None):
    """Each package's program ``build`` saved with its prediction and
    loaded by its AnalysisPredictor: the op census after the inference
    passes. → (the TPU package's census, the port's)."""
    import paddle_tpu.inference as jinf
    import paddle_tpu_torch.inference as tinf
    out = []
    for fluid, inf in ((jfluid, jinf), (tfluid, tinf)):
        with fluid.unique_name.guard():
            r = build(fluid)
        main, startup, pred = r[0], r[1], r[3] if len(r) > 3 else r[2]
        exe = (fluid.Executor(fluid.CPUPlace()) if fluid is tfluid
               else fluid.Executor())
        scope = fluid.Scope() if fluid is tfluid else jcore.Scope()
        d = os.path.join(str(tmp), fluid.__name__)
        with fluid.scope_guard(scope):
            exe.run(startup)
            fluid.io.save_inference_model(d, ["words"], [pred], exe, main)
        cfg = inf.Config(d)
        if fluid is tfluid:
            cfg.disable_gpu()
        out.append(cs._census(inf.create_predictor(cfg)._program))
    return out


def test_sentiment_census_after_the_inference_passes(tmp_path):
    """fc_lstm_fuse_pass leaves the stacked net unfused (each projection
    has a bias and more than one reader) in both packages."""
    j, t = _served_census(tmp_path, lambda f: cs.rnn_sentiment_program(
        f, DICT, W, W, 3))
    assert t == j == cs.RNN_SENT_CENSUS


def test_lstm_classifier_fc_lstm_fuse_pass(tmp_path):
    """A bias-free projection read by the LSTM alone fuses into
    fusion_lstm, in both packages, and serves what the unfused program
    computes, bitwise."""
    from paddle_tpu.fluid import ir as jir
    from paddle_tpu_torch.fluid import ir as tir
    (jm, js, jp), (tm, ts, tp) = _both(cs.rnn_lstm_classifier, DICT, W, W)
    jexe, jscope, texe, tscope, _ = _start_alike(js, ts)
    jf, tf = _feeds(_sentiment_batches(1)[0])
    plain = texe.run(tm, feed=tf, fetch_list=[tp], scope=tscope)[0]
    fused, jfused = tm.clone(), jm.clone()
    tir.apply_inference_passes(fused, tscope)
    jir.apply_inference_passes(jfused, jscope)
    assert cs._census(fused) == cs._census(jfused)
    assert _served_census(tmp_path, lambda f: cs.rnn_lstm_classifier(
        f, DICT, W, W)) == [cs.RNN_FUSED_CENSUS] * 2
    got = texe.run(fused, feed=tf, fetch_list=[tp.name], scope=tscope)[0]
    assert np.array_equal(got, plain)
    with jfluid.scope_guard(jscope):
        want = jexe.run(jfused, feed=jf, fetch_list=[jp.name])[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- (b)
def _mt_batch(rng, batch):
    src_len = rng.randint(2, LEN + 1, batch).astype(np.int64)
    trg_len = rng.randint(2, LEN + 1, batch).astype(np.int64)
    return {"src": rng.randint(2, DICT, (batch, LEN)).astype(np.int64),
            "src_len": src_len,
            "trg": rng.randint(2, DICT, (batch, LEN)).astype(np.int64),
            "trg_next": rng.randint(1, DICT, (batch, LEN, 1)).astype(
                np.int64),
            "trg_len": trg_len}


def test_translator_train_and_beam_decode_against_the_tpu_package():
    (jm, js, jl), (tm, ts, tl) = _both(cs.mt_train_program, DICT, W, LEN)
    assert _types(tm) == _types(jm)
    rng = np.random.RandomState(1)
    texe, tscope, modes = _train_both(jm, tm, js, ts, [jl], [tl],
                                      [_mt_batch(rng, 3) for _ in range(2)],
                                      rtol=1e-4, atol=1e-5)
    assert modes == ["compiled"] * 2
    (jd, _, jids, jsc), (td, _, tids, tsc) = _both(
        cs.mt_decode_program, DICT, W, LEN, 3, 5)
    assert _types(td) == _types(jd)
    jscope = jcore.Scope()
    names = [v.name for v in jd.global_block().vars.values()
             if v.persistable]
    for n in names:
        jscope.var(n).get_tensor().set(
            tscope.find_var(n).value().array.numpy())
    feed = {k: v for k, v in _mt_batch(rng, 2).items()
            if k in ("src", "src_len")}
    with jfluid.scope_guard(jscope):
        ji, js_ = jfluid.Executor().run(jd, feed=feed,
                                        fetch_list=[jids, jsc])
    ti, ts_ = texe.run(td, feed=feed, fetch_list=[tids, tsc], scope=tscope)
    assert ti.shape == (2, 5, 3)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts_, np.asarray(js_), rtol=RTOL, atol=ATOL)
    ii, is_ = _interpreted(texe, td, feed, [tids, tsc], tscope)
    assert np.array_equal(ti, ii) and np.array_equal(ts_, is_)


# ---------------------------------------------------------------- (c)
def _legacy_batch(rng, batch):
    src, soffs = _lod_ids(rng, batch, (2, 6), DICT)
    trg, toffs = _lod_ids(rng, batch, (1, 5), DICT)
    nxt = rng.randint(0, DICT, trg.shape).astype(np.int64)
    return {"lsrc": (src, soffs), "ltrg": (trg, toffs),
            "ltrg_next": (nxt, toffs)}


def test_dynamic_rnn_scorer_against_the_tpu_package():
    (jm, js, jsc, jhs), (tm, ts, tsc, ths) = _both(cs.lg_score_program,
                                                    DICT, W)
    assert _types(tm) == _types(jm)
    sub = tm.block(1)
    assert [op.type for op in sub.ops] == [op.type for op in
                                           jm.block(1).ops]
    jexe, jscope, texe, tscope, _ = _start_alike(js, ts)
    rng = np.random.RandomState(2)
    for _ in range(2):
        jf, tf = _feeds(_legacy_batch(rng, 5))
        with jfluid.scope_guard(jscope):
            jo = jexe.run(jm, feed=jf, fetch_list=[jsc, jhs],
                          return_numpy=False)
        to = texe.run(tm, feed=tf, fetch_list=[tsc, ths], scope=tscope,
                      return_numpy=False)
        assert texe._last_run_mode == "segmented"
        io = _interpreted(texe, tm, tf, [tsc, ths], tscope)
        for a, b, c in zip(to, jo, io):
            np.testing.assert_allclose(a.numpy(), np.asarray(b.array),
                                       rtol=RTOL, atol=ATOL)
            assert np.array_equal(a.numpy(), np.asarray(c))
        assert to[1].lod() == [list(x) for x in jo[1].lod()]


def test_training_decoder_against_the_tpu_package():
    (jm, js, jl), (tm, ts, tl) = _both(cs.lg_train_program, DICT, W, LEN)
    assert _types(tm) == _types(jm)
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(2):
        src, soffs = _lod_ids(rng, 3, (2, 6), DICT)
        lens = rng.randint(1, LEN + 1, 3)
        mask = (np.arange(LEN)[:, None] < lens[None, :]).astype(np.float32)
        batches.append({"lsrc": (src, soffs),
                        "ttrg": rng.randint(0, DICT, (LEN, 3)).astype(
                            np.int64),
                        "ttrg_next": rng.randint(0, DICT, (LEN, 3, 1)).astype(
                            np.int64),
                        "ttrg_mask": mask})
    _, _, modes = _train_both(jm, tm, js, ts, [jl], [tl], batches,
                              rtol=1e-4, atol=1e-5)
    assert modes == ["compiled"] * 2


def test_contrib_beam_search_host_loop_against_the_tpu_package():
    beam = 3
    (jm, js, *jf), (tm, ts, *tf) = _both(cs.lg_beam_program, DICT, W, beam)
    assert _types(tm) == _types(jm)
    jexe, jscope, texe, tscope, _ = _start_alike(js, ts)
    rng = np.random.RandomState(4)
    n = 2
    ids = np.full((n, 1), cs.MT_BOS, np.int64)
    scores = np.zeros((n, 1), np.float32)
    lod = [list(range(n + 1)), list(range(n + 1))]
    h = rng.normal(size=(n, W)).astype(np.float32)
    jarr = ([], [])
    tarr = ([], [])
    for step in range(4):
        jfeed = {"bs_ids": jcore.LoDTensor(ids, lod=lod),
                 "bs_scores": jcore.LoDTensor(scores, lod=lod), "bs_h": h}
        tfeed = {"bs_ids": tfluid.LoDTensor(torch.from_numpy(ids), lod),
                 "bs_scores": tfluid.LoDTensor(torch.from_numpy(scores),
                                               lod), "bs_h": h}
        with jfluid.scope_guard(jscope):
            jo = jexe.run(jm, feed=jfeed, fetch_list=jf, return_numpy=False)
        to = texe.run(tm, feed=tfeed, fetch_list=tf, scope=tscope,
                      return_numpy=False)
        io = _interpreted(texe, tm, tfeed, tf, tscope)
        assert texe._last_run_mode == "interpreted"
        for k, (a, b, c) in enumerate(zip(to, jo, io)):
            a = a.numpy() if hasattr(a, "numpy") else np.asarray(a)
            b = np.asarray(b.array)
            if k == 0 or k == 2:
                np.testing.assert_array_equal(a.reshape(-1), b.reshape(-1))
            else:
                np.testing.assert_allclose(a.reshape(b.shape), b,
                                           rtol=RTOL, atol=ATOL)
            assert np.array_equal(a, np.asarray(c))
        assert to[0].lod() == [list(x) for x in jo[0].lod()]
        sel, sel_sc = to[0], to[1]
        parent = to[2].numpy().astype(np.int64)
        ids, scores = sel.numpy(), sel_sc.numpy()
        lod = sel.lod()
        h = to[3].numpy()[parent]
        tarr[0].append((ids, lod))
        tarr[1].append((scores, lod))
        jarr[0].append(jcore.LoDTensor(ids, lod=lod))
        jarr[1].append(jcore.LoDTensor(scores, lod=lod))
    # the backtrace of the same selections
    (jd, _, jsid, jssc), (td, _, tsid, tssc) = _both(_decode_program, beam)
    tds = tfluid.Scope()
    for name, arr in zip(("step_ids", "step_scores"), tarr):
        a = tds.var(name).get_lod_tensor_array()
        for v, lv in arr:
            a.append(tfluid.LoDTensor(torch.from_numpy(v), lv))
    jds = jcore.Scope()
    for name, arr in zip(("step_ids", "step_scores"), jarr):
        a = jds.var(name).get_lod_tensor_array()
        a.extend(arr)
    with jfluid.scope_guard(jds):
        jo = jfluid.Executor().run(jd, fetch_list=[jsid, jssc],
                                   return_numpy=False)
    to = tfluid.Executor(tfluid.CPUPlace()).run(
        td, fetch_list=[tsid, tssc], scope=tds, return_numpy=False)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0].array))
    np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1].array))
    assert to[0].lod() == [list(x) for x in jo[0].lod()]


def _decode_program(fluid, beam):
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        block = main.global_block()
        ids = block.create_var(
            name="step_ids", type=fluid.core.VarDesc.VarType.LOD_TENSOR_ARRAY,
            dtype="int64")
        scores = block.create_var(
            name="step_scores",
            type=fluid.core.VarDesc.VarType.LOD_TENSOR_ARRAY,
            dtype="float32")
        sid, ssc = fluid.layers.beam_search_decode(ids, scores, beam,
                                                   cs.MT_EOS)
    return main, None, sid, ssc


def test_encoder_fc_gru_fuse_pass():
    from paddle_tpu.fluid import ir as jir
    from paddle_tpu_torch.fluid import ir as tir
    (jm, js, je), (tm, ts, te) = _both(cs.lg_encoder_program, DICT, W)
    jexe, jscope, texe, tscope, _ = _start_alike(js, ts)
    rng = np.random.RandomState(5)
    jf, tf = _feeds({"lsrc": _lod_ids(rng, 4, (1, 6), DICT)})
    plain = texe.run(tm, feed=tf, fetch_list=[te], scope=tscope)[0]
    fused = tm.clone()
    jfused = jm.clone()
    tir.apply_inference_passes(fused, tscope)
    jir.apply_inference_passes(jfused, jscope)
    assert cs._census(fused) == cs._census(jfused)
    assert "fusion_gru" in cs._census(fused)
    assert "dynamic_gru" not in cs._census(fused)
    got = texe.run(fused, feed=tf, fetch_list=[te.name], scope=tscope)[0]
    assert np.array_equal(got, plain)
    with jfluid.scope_guard(jscope):
        want = jfluid.Executor().run(jfused, feed=jf, fetch_list=[je.name])[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- phase 21
def test_chip_smoke_phase_21_rehearsed(monkeypatch):
    """phase_rnn on the CPU at small sizes (widths 16, dicts 40, batch 4,
    8 tokens, 3 decode steps): every comparison it makes on the card,
    each compiled or segmented run's kind as a card run's (eager,
    capture, replays), no kernel to count."""
    import paddle_tpu_torch.inference as tinference
    zeros = cs.NO_KERNELS
    monkeypatch.setattr(tfluid, "CUDAPlace", lambda i=0: tfluid.CPUPlace())
    for name, value in (("LOD_VOCAB", 120), ("RNN_EMB", 16), ("RNN_HID", 16),
                        ("RNN_BATCH", 4), ("RNN_CHECK_BATCH", 2),
                        ("MT_DICT", 40), ("MT_HID", 16), ("MT_BATCH", 4),
                        ("MT_LEN", 8), ("MT_MAX_STEP", 3), ("LG_LENS", (2, 8)),
                        ("LG_BEAM_STEPS", 3), ("RNN_RAGGED", 4),
                        ("RNN_TIMED", 2), ("MD_STEPS", 4)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_launch_counts", lambda: zeros)
    monkeypatch.setattr(cs, "_device_kernel_counts",
                        lambda fn, **k: (fn(), zeros)[1])
    monkeypatch.setattr(cs, "_check_trace", lambda *a: None)
    monkeypatch.setattr(cs, "_card_line", lambda: "CPU")
    monkeypatch.setattr(cs, "_on_card", lambda *a: None)
    clone = cs._clone_scope
    monkeypatch.setattr(cs, "_clone_scope",
                        lambda scope, names, dev: clone(scope, names, "cpu"))
    config = tinference.Config

    def cpu_config(d):
        c = config(d)
        c.disable_gpu()
        return c
    monkeypatch.setattr(tinference, "Config", cpu_config)
    runs = {}

    def kind(exe, mode, what):
        assert exe._last_run_mode == mode, (what, exe._last_run_mode)
        if mode == "interpreted":
            return mode
        # the block is held, so that a later block cannot take its id
        seen = runs.setdefault(id(exe._last_block), [exe._last_block, 0])
        seen[1] += 1
        n = seen[1]
        return ("eager", "capture")[n - 1] if n <= 2 else "replay"
    monkeypatch.setattr(cs, "_gate_run", lambda exe, delta, want, what:
                        kind(exe, "compiled", what))
    monkeypatch.setattr(cs, "_rnn_gate", lambda exe, before, mode, what,
                        book: kind(exe, mode, what))
    monkeypatch.setattr(cs, "_interpreted", lambda iexe, main, feed, fetch,
                        scope, want, book, what: _interpreted(iexe, main,
                                                              feed, fetch,
                                                              scope))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    lines = []
    monkeypatch.setattr(cs, "_log", lambda *a: lines.append(" ".join(
        str(x) for x in a)))
    out = cs.phase_rnn()
    text = "\n".join(lines)
    assert "FAIL" not in text and "DIFFER" not in text
    for want in ("(a) stacked-LSTM sentiment net batch 4", "ragged batches",
                 "(a) stacked-LSTM sentiment net, a request",
                 "(c) fusion_lstm", "(b) GRU translator batch 4",
                 "(b) beam decode", "(c) encoder (fc_gru_fuse_pass)",
                 "(c) DynamicRNN scorer", "(c) contrib TrainingDecoder",
                 "(c) contrib BeamSearchDecoder", "phase 21 in"):
        assert want in text, want
    assert out["wrapper"] == zeros and out["executed"] == zeros
