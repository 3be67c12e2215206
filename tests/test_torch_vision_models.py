"""The vision and loss batch's programs and layers on paddle_tpu_torch
against the TPU package, on the CPU:

- CycleGAN, DeepLabv3+ and CRNN-CTC, chip_smoke.py's user programs of
  phase 22 (``cyclegan_programs``, ``deeplab_program``,
  ``crnn_program``), built in both packages: at full width the same op
  types and parameters; at a small depth and width 2 training steps from
  the TPU package's start, every loss and (at step 1) every parameter's
  grad at rtol 1e-4, atol 1e-5 (f32 sums in other orders through deep
  nets), the port's compiled (or segmented) run bitwise its
  interpreter's. DeepLabv3+ runs at dropout 0 here (the two packages
  draw different masks), its eval clone's mean_iou exactly; CRNN's
  decoded ids and edit distances exactly;
- each layer of the batch (fluid.layers' new names) built in both
  packages into one program, its outputs compared at rtol 1e-5, atol
  1e-6 and its compiled run bitwise its interpreted one;
- py_func in a program (an island of a segmented step), the
  affine_channel program served through the predictor after
  conv_affine_channel_fuse_pass, and chip_smoke's phase 22 rehearsed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.ops import loss_extra_ops as jloss_extra
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from tests.test_torch_models_a7 import (_j_feed, _jax_values, _no_dropout,
                                        _persistables, _t_feed)
from tests.test_torch_rnn_layers import cs

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: several test processes share the host's
    cores, and the bitwise checks must not see a product split
    differently between two calls."""
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


def _params(prog):
    return sorted((v.name, tuple(v.shape))
                  for v in prog.global_block().vars.values() if v.persistable)


class _Pair:
    """Both packages' executors and scopes from the TPU package's start
    (every startup in ``starts`` run in turn), and a copy of the port's
    scope for its interpreter."""

    def __init__(self, jstarts, tstarts, names):
        self.jexe, self.jscope = jfluid.Executor(), jcore.Scope()
        self.texe = tfluid.Executor(tfluid.CPUPlace())
        self.tscope = tfluid.Scope()
        with jfluid.scope_guard(self.jscope):
            for s in jstarts:
                self.jexe.run(s)
        for s in tstarts:
            self.texe.run(s, scope=self.tscope)
        self.names = names
        set_params_from_numpy(self.tscope, _jax_values(
            self.jscope, names, self.tscope))
        self.iscope = tfluid.Scope()
        for n in names + ["@RNG_COUNTER@"]:
            v = self.tscope.find_var(n)
            if v is not None and v.is_initialized():
                self.iscope.var(n).set_value(tfluid.LoDTensor(
                    v.value().array.clone()))

    def run(self, jmain, tmain, feed, jfetch, tfetch, mode="compiled"):
        """One run of each: the TPU package, the port (in ``mode``) and the
        port's interpreter, the last two bitwise alike. → (the TPU
        package's fetches, the port's), as numpy."""
        tout = self.texe.run(tmain, feed=_t_feed(feed), fetch_list=tfetch,
                             scope=self.tscope, return_numpy=False)
        assert self.texe._last_run_mode == mode
        tcore.set_flag("FLAGS_executor_mode", "interpreted")
        try:
            iout = self.texe.run(tmain, feed=_t_feed(feed),
                                 fetch_list=tfetch, scope=self.iscope,
                                 return_numpy=False)
        finally:
            tcore.set_flag("FLAGS_executor_mode", "compiled")
        for a, b in zip(tout, iout):
            assert np.array_equal(a.numpy(), b.numpy()), \
                "compiled vs interpreted"
            assert a.lod() == b.lod()
        with jfluid.scope_guard(self.jscope):
            jout = self.jexe.run(jmain, feed=_j_feed(feed), fetch_list=jfetch)
        return [np.asarray(v) for v in jout], [v.numpy() for v in tout]

    def resync(self):
        """Both of the port's scopes take the TPU package's persistables
        (a deep net whose ReLU kinks flip under rounding parts from the
        reference within a step; its steps then compare alone)."""
        vals = _jax_values(self.jscope, self.names, self.tscope)
        set_params_from_numpy(self.tscope, vals)
        set_params_from_numpy(self.iscope, vals)

    def same_state(self, tmain, reference=True):
        """The port's compiled and interpreted persistables bitwise alike,
        and with ``reference`` the TPU package's at RTOL."""
        for n in _persistables(tmain):
            a = self.tscope.find_var(n).value().array
            assert torch.equal(a, self.iscope.find_var(n).value().array), n
            if not reference:
                continue
            np.testing.assert_allclose(
                a.numpy(), np.asarray(self.jscope.find_var(n).get_tensor()
                                      .array), rtol=RTOL, atol=ATOL,
                err_msg=n)


def _grad_names(prog):
    block = prog.global_block()
    return [p.name + "@GRAD" for p in block.all_parameters()
            if block.has_var(p.name + "@GRAD")]


def _agree(jout, tout, what, exact=()):
    for k, (a, b) in enumerate(zip(tout, jout)):
        if k in exact:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} fetch {k}")


# ---------------------------------------------------- full-width builds
FULL = [("cyclegan", cs.cyclegan_programs, {}),
        ("deeplab", cs.deeplab_program, {}),
        ("crnn", cs.crnn_program, {})]


@pytest.mark.parametrize("name,build,kw", FULL, ids=[f[0] for f in FULL])
def test_programs_equal_the_tpu_package_at_full_width(name, build, kw):
    j, t = _both(build, **kw)
    progs = ([(j[k][0], t[k][0]) for k in ("g", "da", "db")]
             if isinstance(j, dict) else [(j[0], t[0])])
    for jp, tp in progs:
        assert _types(tp) == _types(jp)
        assert _params(tp) == _params(jp)


# --------------------------------------------------------- (a) CycleGAN
GAN = dict(depth=1, width=1 / 16, image=32)


def _gan_images(rng):
    return {k: rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
            for k in ("real_A", "real_B")}


def test_cyclegan_two_steps_against_the_tpu_package():
    j, t = _both(cs.cyclegan_programs, **GAN)
    assert {op.type for op in t["g"][0].global_block().ops} >= {
        "instance_norm", "conv2d_transpose", "pad2d", "mse_loss",
        "instance_norm_grad", "conv2d_transpose_grad"}
    names = sorted({n for k in ("g", "da", "db")
                    for n in _persistables(j[k][0])})
    pair = _Pair([j[k][1] for k in ("g", "da", "db")],
                 [t[k][1] for k in ("g", "da", "db")], names)
    feed = _gan_images(np.random.RandomState(0))
    for step in range(2):
        grads = {k: _grad_names(t[k][0]) if step == 0 else []
                 for k in ("g", "da", "db")}
        jg, tg = pair.run(j["g"][0], t["g"][0], feed,
                          [j["g"][2], j["g"][3], j["g"][4]] + grads["g"],
                          [t["g"][2], t["g"][3], t["g"][4]] + grads["g"])
        _agree(jg, tg, f"generators step {step}")
        fakes = {"fake_A": tg[1], "fake_B": tg[2]}
        for k, real, fake in (("da", "real_A", "fake_A"),
                              ("db", "real_B", "fake_B")):
            f = {real: feed[real], fake: fakes[fake]}
            jd, td = pair.run(j[k][0], t[k][0], f, [j[k][2]] + grads[k],
                              [t[k][2]] + grads[k])
            _agree(jd, td, f"{k} step {step}")
    for k in ("g", "da", "db"):
        pair.same_state(t[k][0])


# ------------------------------------------------------- (b) DeepLabv3+
DL = dict(depth=1, width=1 / 16, crop=33, classes=5)


def _dl_feed(rng, bs, crop, classes):
    label = rng.randint(0, classes, (bs, 1, crop, crop)).astype(np.int64)
    label[rng.rand(*label.shape) < 0.2] = cs.DL_IGNORE
    return {"image": rng.normal(size=(bs, 3, crop, crop)).astype(np.float32),
            "label": label}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_deeplab_two_steps_and_mean_iou_against_the_tpu_package():
    """Each step's loss at RTOL, step 1's parameter grads within
    KINK_L2_TOL relative L2 (chip_smoke.py's for conv nets: at this width
    batch norm sees 18 values a channel in the exit flow and rounding
    moves ReLU kinks, ~2e-2 measured), each step from the TPU package's
    state (resync); then the eval clone's mean_iou, wrong and correct
    counts exactly."""
    j, t = _both(cs.deeplab_program, **DL)
    _no_dropout(j[0], t[0])
    ops = {op.type for op in t[0].global_block().ops}
    assert {"bilinear_interp", "bilinear_interp_grad", "dropout",
            "mean_iou"} <= ops
    pair = _Pair([j[1]], [t[1]], _persistables(j[0]))
    feed = _dl_feed(np.random.RandomState(1), 2, 33, 5)
    for step in range(2):
        g = _grad_names(t[0]) if step == 0 else []
        jo, to = pair.run(j[0], t[0], feed, [j[3]] + g, [t[3]] + g)
        np.testing.assert_allclose(to[0], jo[0], rtol=RTOL, atol=ATOL)
        for name, a, b in zip(g, to[1:], jo[1:]):
            assert _rel_l2(a, b) <= cs.KINK_L2_TOL, name
        pair.same_state(t[0], reference=False)
        pair.resync()
    # the eval clone's mean_iou from the trained state, exactly
    jo, to = pair.run(j[2], t[2], feed, list(j[4:7]), list(t[4:7]))
    _agree(jo, to, "mean_iou", exact=(1, 2))
    np.testing.assert_array_equal(to[0], jo[0])


# --------------------------------------------------------- (c) CRNN-CTC
CRNN = dict(width=0.25, hidden=8, classes=6, shape=(1, 16, 128))


def _crnn_feed(rng, bs, shape, classes, lens=(1, 4)):
    n = rng.randint(lens[0], lens[1] + 1, bs)
    offs = [0] + [int(x) for x in np.cumsum(n)]
    return {"pixel": rng.normal(size=(bs,) + tuple(shape)).astype(
        np.float32),
            "label": (rng.randint(0, classes, (offs[-1], 1)).astype(
                np.int32), offs)}


class _SafeLogJnp:
    """``jax.numpy`` with a ``log`` whose argument 0 becomes 1: the TPU
    warpctc kernel's ``lse`` takes log(0) where both terms are
    unreachable and then replaces the value by NEG_INF, so its value is
    unchanged, but its backward (0 / 0) is NaN there and the NaN reaches
    every grad of a CTC program. With this ``log`` the reference's grads
    are CTC's true ones, the port's (ROADMAP C)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def log(x):
        return jnp.log(jnp.where(x > 0, x, jnp.ones_like(x)))


def test_crnn_ctc_two_steps_and_decode_against_the_tpu_package(
        monkeypatch):
    """Two steps: the loss and every parameter grad at RTOL, the decoded
    ids, their LoD and the edit distances exactly, the step segmented
    (warpctc reads its Label on the host; ctc_align and edit_distance
    are islands), compiled segments bitwise the interpreter. The TPU
    package's unpatched grads are NaN (its warpctc's lse), the port's
    finite; the reference runs with ``_SafeLogJnp``."""
    j, t = _both(cs.crnn_program, **CRNN)
    feed = _crnn_feed(np.random.RandomState(2), 4, CRNN["shape"], 6)
    g = _grad_names(t[0])
    pair = _Pair([j[1]], [t[1]], _persistables(j[0]))
    with jfluid.scope_guard(pair.jscope):
        raw = jfluid.Executor().run(j[0].clone(for_test=False),
                                    feed=_j_feed(feed), fetch_list=g[:1])
    assert np.isnan(np.asarray(raw[0])).any()
    pair = _Pair([j[1]], [t[1]], _persistables(j[0]))
    monkeypatch.setattr(jloss_extra, "jnp", _SafeLogJnp())
    for step in range(2):
        fetch = g if step == 0 else []
        jo, to = pair.run(j[0], t[0], feed, [j[2], j[3], j[4]] + fetch,
                          [t[2], t[3], t[4]] + fetch, mode="segmented")
        _agree(jo, to, f"step {step}", exact=(1, 2))
        assert all(np.isfinite(v).all() for v in to)
    pair.same_state(t[0])


# ---------------------------------------------------------- the layers
def _layer_feed(rng):
    seg = rng.randint(0, 4, (2, 8, 8)).astype(np.int32)
    seg[rng.rand(2, 8, 8) < 0.2] = 255
    return {"vs_label": np.array([[1], [2]], np.int64), "vs_seg": seg}


def test_every_layer_in_both_packages():
    """chip_smoke's ``vision_layers_program`` (every layer of the batch
    but the two that draw) in both packages: two steps, every output and
    the loss at RTOL (the integer ones exactly), the port compiled
    bitwise its interpreter."""
    j, t = _both(cs.vision_layers_program, random=False)
    assert _types(t[0]) == _types(j[0])
    pair = _Pair([j[1]], [t[1]], _persistables(j[0]))
    feed = _layer_feed(np.random.RandomState(4))
    n = len(j[3])
    for step in range(2):
        jo, to = pair.run(j[0], t[0], feed, [j[2]] + list(j[3]),
                          [t[2]] + list(t[3]))
        _agree(jo, to, f"step {step}", exact=(n - 1, n))
    pair.same_state(t[0])


_RANDOM = ("random_crop", "sampled_softmax_with_cross_entropy", "py_func")
BATTERY = [c for c in cs._vs_battery() if c[0] not in _RANDOM]


@pytest.mark.parametrize("case", BATTERY, ids=[c[0] for c in BATTERY])
def test_chip_smoke_battery_against_the_tpu_package(case, monkeypatch):
    """Each case of phase 22's op battery (d) (its random ops and py_func
    aside) against the TPU package's kernel: outputs and generic grads at
    rtol 1e-4, atol 1e-5 (the card holds the same cases against the
    CPU port); warpctc's reference with ``_SafeLogJnp``."""
    from tests.test_torch_vision_ops import run_both
    op_type, ins, attrs, lod, diff = case
    monkeypatch.setattr(jloss_extra, "jnp", _SafeLogJnp())
    run_both(op_type, ins, attrs, lod=lod, grad=bool(diff), diff=diff,
             tol=(RTOL, ATOL))


def _py_func_program(fluid):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [4], "float32")
        h = L.fc(L.fc(L.fc(x, 8, act="relu"), 8, act="relu"), 4)
        out = main.current_block().create_var(name="py_out", shape=[-1, 4],
                                              dtype="float32")
        L.py_func(lambda a: np.tanh(a) * 2.0, h, out,
                  backward_func=lambda *a: None)
        y = L.reduce_mean(L.fc(L.fc(L.fc(out, 8, act="relu"), 8,
                                    act="relu"), 1))
    return main, startup, h, out, y


def test_py_func_in_a_program():
    """py_func's numpy callable as an island of the port's segmented
    step (interpreted in the TPU package's), the same values; the op has
    no grad in either package, so its backward_func is never called."""
    j, t = _both(_py_func_program)
    assert not any(op.type == "py_func_grad"
                   for op in t[0].global_block().ops)
    pair = _Pair([j[1]], [t[1]], _persistables(j[0]))
    feed = {"x": np.random.RandomState(5).normal(size=(3, 4)).astype(
        np.float32)}
    jo, to = pair.run(j[0], t[0], feed, list(j[2:]), list(t[2:]),
                      mode="segmented")
    _agree(jo, to, "py_func")
    np.testing.assert_allclose(to[1], np.tanh(to[0]) * 2.0, rtol=1e-6)


def test_affine_channel_fuse_pass_through_the_predictor(tmp_path):
    """chip_smoke's frozen-BN program (conv2d + affine_channel, the
    Detectron-style backbone) saved and served by AnalysisPredictor in
    both packages: conv_affine_channel_fuse_pass folds every
    affine_channel into conv2d_fusion in both, and the served output
    matches the unfused program's."""
    import paddle_tpu.inference as jinf
    import paddle_tpu_torch.inference as tinf
    feed = np.random.RandomState(6).normal(
        size=(2, 3, 16, 16)).astype(np.float32)
    got, jscope = [], None
    for fluid, inf in ((jfluid, jinf), (tfluid, tinf)):
        with fluid.unique_name.guard():
            main, startup, pred = cs.affine_channel_program(fluid, 0.25, 16)
        exe = (fluid.Executor(fluid.CPUPlace()) if fluid is tfluid
               else fluid.Executor())
        scope = fluid.Scope() if fluid is tfluid else jcore.Scope()
        d = str(tmp_path / fluid.__name__)
        with fluid.scope_guard(scope):
            exe.run(startup)
            if jscope is None:
                jscope = scope
            else:
                set_params_from_numpy(scope, _jax_values(
                    jscope, _persistables(main), scope))
            plain = exe.run(main, feed={"image": feed}, fetch_list=[pred])[0]
            fluid.io.save_inference_model(d, ["image"], [pred], exe, main)
        cfg = inf.Config(d)
        if fluid is tfluid:
            cfg.disable_gpu()
        p = inf.create_predictor(cfg)
        census = cs._census(p._program)
        assert "affine_channel" not in census and \
            census.get("conv2d_fusion") == cs.AFFINE_CONVS, census
        served = p.run([feed])[0]
        np.testing.assert_allclose(served, np.asarray(plain), rtol=RTOL,
                                   atol=ATOL)
        got.append(np.asarray(served))
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)


def test_chip_smoke_phase_22_rehearsed(monkeypatch):
    """phase_vision on the CPU at small sizes (width 1/16, CycleGAN at
    32x32 with one block, DeepLabv3+ at 33x33 with one middle block and
    lr 0.03, where at 0.01 its loss over 9 label blocks an image is
    noise for 4 steps, CRNN at 16x128, 4 steps, 6 of the battery's
    cases): every comparison it makes on the card,
    each compiled or segmented run's kind as a card run's (eager,
    capture, replays), the dropout kernel booked from DeepLabv3+'s
    steps and held to its plain version at their dropout shape."""
    import paddle_tpu_torch.inference as tinference
    from tests.test_torch_rnn_layers import _interpreted
    zeros = cs.NO_KERNELS
    monkeypatch.setattr(tfluid, "CUDAPlace", lambda i=0: tfluid.CPUPlace())
    for name, value in (("VS_WIDTH", 1 / 16), ("GAN_IMAGE", 32),
                        ("GAN_BLOCKS", 1), ("GAN_CHECK_IMAGE", 32),
                        ("DL_MIDDLE", 1), ("DL_CROP", 33),
                        ("DL_CHECK_CROP", 33), ("DL_BATCH", 2),
                        ("DL_CHECK_MIDDLE", 1),
                        ("DL_LR", 0.03),
                        ("CRNN_SHAPE", (1, 16, 128)), ("CRNN_HID", 8),
                        ("CRNN_LABEL", (1, 4)), ("CRNN_BATCH", 4),
                        ("CRNN_CHECK_BATCH", 2), ("VS_EVAL_RUNS", 2),
                        ("MD_STEPS", 4)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_launch_counts", lambda: zeros)
    monkeypatch.setattr(cs, "_device_kernel_counts",
                        lambda fn, **k: (fn(), zeros)[1])
    monkeypatch.setattr(cs, "_check_trace", lambda *a: None)
    monkeypatch.setattr(cs, "_card_line", lambda: "CPU")
    clone = cs._clone_scope
    monkeypatch.setattr(cs, "_clone_scope",
                        lambda scope, names, dev: clone(scope, names, "cpu"))
    config = tinference.Config

    def cpu_config(d):
        c = config(d)
        c.disable_gpu()
        return c
    monkeypatch.setattr(tinference, "Config", cpu_config)
    affine, battery = cs.affine_channel_program, cs._vs_battery
    monkeypatch.setattr(cs, "affine_channel_program",
                        lambda fluid: affine(fluid, 0.25, 16))
    monkeypatch.setattr(cs, "_vs_battery", lambda: [
        c for c in battery() if c[0] in (
            "conv2d_transpose", "warpctc", "mean_iou", "random_crop",
            "py_func", "bilinear_interp")])
    monkeypatch.setattr(cs, "VS_CARD", "cpu")
    dropped = []
    monkeypatch.setattr(cs, "_dropout_agrees", lambda dk, x, key, rate, up,
                        what, tag: dropped.append((tuple(x.shape), rate)))
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
    out = cs.phase_vision()
    text = "\n".join(lines)
    assert "FAIL" not in text and "DIFFER" not in text
    for want in ("(a) CycleGAN 32x32", "instance_norm and",
                 "(a) CycleGAN generators", "(a) CycleGAN discriminator A",
                 "(b) DeepLabv3+ 33x33 batch 2", "(b) the eval clone",
                 "mean_iou on the card and the CPU", "(c) CRNN-CTC",
                 "compiled segments and", "greedy decode",
                 "(d) 6 op types", "(d) the layers' program",
                 "conv_affine_channel_fuse_pass", "phase 22 in"):
        assert want in text, want
    assert out["wrapper"] == zeros
    assert out["executed"][4] > 0 and not any(out["executed"][:4])
    # the kernel held to its plain version at the step's dropout shape
    assert dropped == [((2, 16, 3, 3), cs.DL_DROPOUT)], dropped
