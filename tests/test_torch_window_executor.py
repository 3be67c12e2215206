"""Step windows of paddle_tpu_torch (``Executor.run(..., n_steps=k)``) on
the CPU, mirroring tests/test_window_executor.py: a feed with a leading
[k, ...] dim on a var whose first dim is -1 carries k distinct batches,
one slice a step; fetches come back stacked [k, ...].

- Parity: for k in {1, 4, 8} the port's compiled window is BITWISE equal
  to k single port runs (the same one-step plan run k times; on the card
  k replays of one graph), losses and updated weights, and within rtol
  1e-4 of the JAX package's window (an XLA scan) on the same numpy MLP,
  weights and batches (the reference's own window test holds its scan to
  its per-step runs at rtol 2e-5).
- Dropout: port against port, bitwise (jax.random draws cannot be
  reproduced); the step counter advances once a step.
- The contract's edges: mixed windowed and broadcast feeds, a length
  mismatch, a windowed LoD feed, normal feeds not taken for windows, a
  feed with a ``k`` attribute (the reference's WindowBatch), the
  interpreter's windowed fallback and its same-feed ``n_steps`` (the
  final step's fetches), and FLAGS_feed_device_cache.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid.reader import WindowBatch as JWindowBatch
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.executor import _window_feed_names

IN, HID, CLS = 6, 8, 3
WIN_TOL = 1e-4


class KFeed(dict):
    """A feed dict that knows its window length, as the reference's
    WindowBatch (paddle_tpu/fluid/reader.py) does."""

    def __init__(self, data, k):
        super().__init__(data)
        self.k = k


@pytest.fixture
def mode():
    def set_mode(m):
        tcore.set_flag("FLAGS_executor_mode", m)
    yield set_mode
    tcore.set_flag("FLAGS_executor_mode", "compiled")


def _weights():
    r = np.random.RandomState(5)
    return {"w1": (r.normal(size=(IN, HID)) * 0.5).astype(np.float32),
            "b1": (r.normal(size=(HID,)) * 0.1).astype(np.float32),
            "w2": (r.normal(size=(HID, CLS)) * 0.5).astype(np.float32),
            "b2": (r.normal(size=(CLS,)) * 0.1).astype(np.float32)}


def _build(fluid, dropout=0.0, seed=11):
    """fc-relu-(dropout)-fc, softmax cross-entropy, Momentum; the weights
    from numpy, so both packages start from the same ones."""
    w = _weights()

    def attr(name):
        return fluid.ParamAttr(
            name=name, initializer=fluid.initializer.NumpyArrayInitializer(
                w[name]))
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[IN], dtype="float32")
        y = fluid.data("y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, HID, act="relu", param_attr=attr("w1"),
                            bias_attr=attr("b1"))
        if dropout:
            h = fluid.layers.dropout(
                h, dropout, dropout_implementation="upscale_in_train")
        logits = fluid.layers.fc(h, CLS, param_attr=attr("w2"),
                                 bias_attr=attr("b2"))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Momentum(0.05, momentum=0.9).minimize(loss)
    return main, startup, loss


def _data(k, batch=8, seed=0):
    r = np.random.RandomState(seed)
    return (r.rand(k, batch, IN).astype(np.float32),
            r.randint(0, CLS, (k, batch, 1)).astype(np.int64))


def _torch_run(X, Y, windowed, dropout=0.0):
    """The port on the CPU: one window over the k slices, or k single
    runs. → (losses [k], the updated weights)."""
    main, startup, loss = _build(tfluid, dropout)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    k = X.shape[0]
    if windowed:
        feed = KFeed({"x": X, "y": Y}, k)
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        assert out.shape == (k, 1)
        losses = out[:, 0]
    else:
        losses = np.array([exe.run(main, feed={"x": X[i], "y": Y[i]},
                                   fetch_list=[loss], scope=scope)[0][0]
                           for i in range(k)])
    assert exe._last_run_mode == "compiled"
    ws = {n: scope.find_var(n).value().array.numpy().copy()
          for n in _weights()}
    return losses, ws


def _jax_window(X, Y):
    main, startup, loss = _build(jfluid)
    exe, scope = jfluid.Executor(), jcore.Scope()
    k = X.shape[0]
    with jfluid.scope_guard(scope):
        exe.run(startup)
        out, = exe.run(main, feed=JWindowBatch({"x": X, "y": Y}, k, k),
                       fetch_list=[loss])
        ws = {n: np.asarray(scope.find_var(n).get_tensor().array)
              for n in _weights()}
    return np.asarray(out).reshape(k, -1)[:, 0], ws


def _assert_bitwise(a, b):
    la, wa = a
    lb, wb = b
    assert np.array_equal(la, lb), (la, lb)
    for n in wa:
        assert np.array_equal(wa[n], wb[n]), n


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("k", [1, 4, 8])
def test_window_parity_compiled(k):
    X, Y = _data(k)
    win = _torch_run(X, Y, windowed=True)
    _assert_bitwise(win, _torch_run(X, Y, windowed=False))
    jl, jw = _jax_window(X, Y)
    np.testing.assert_allclose(win[0], jl, rtol=WIN_TOL, atol=1e-6)
    for n in jw:
        np.testing.assert_allclose(win[1][n], jw[n], rtol=WIN_TOL,
                                   atol=1e-6, err_msg=n)


def test_window_rng_parity_with_dropout():
    """The step counter advances once a step inside a window, so the
    window draws the masks of k single runs: bitwise equal."""
    X, Y = _data(4)
    win = _torch_run(X, Y, windowed=True, dropout=0.5)
    _assert_bitwise(win, _torch_run(X, Y, windowed=False, dropout=0.5))
    # the masks differ from step to step: the losses are not those of a
    # run without dropout
    assert not np.array_equal(win[0], _torch_run(X, Y, windowed=True)[0])


def test_window_mixed_broadcast_and_windowed_feeds():
    """A windowed x beside a y of the var's own rank: y feeds every
    step."""
    X, Y = _data(4)
    y0 = Y[0]
    main, startup, loss = _build(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    out, = exe.run(main, feed={"x": X, "y": y0}, fetch_list=[loss],
                   scope=scope, n_steps=4)
    main2, startup2, loss2 = _build(tfluid)
    exe2, scope2 = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe2.run(startup2, scope=scope2)
    seq = [exe2.run(main2, feed={"x": X[i], "y": y0}, fetch_list=[loss2],
                    scope=scope2)[0][0] for i in range(4)]
    assert np.array_equal(out[:, 0], np.array(seq))


# --------------------------------------------------------------- contract
def test_window_length_mismatch_raises():
    main, startup, loss = _build(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    X, Y = _data(4)
    with pytest.raises(ValueError, match="does not match n_steps"):
        exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss], scope=scope,
                n_steps=8)


def test_windowed_lod_feed_refused():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", shape=[6], dtype="float32")
        tfluid.layers.scale(x, scale=2.0)
    t = tcore.LoDTensor(torch.ones(4, 8, 6), lod=[[0, 4, 8]])
    with pytest.raises(NotImplementedError, match="LoD"):
        _window_feed_names(main, {"x": t}, 4)


def test_window_detection_ignores_normal_feeds():
    main, _, _ = _build(tfluid)
    X, Y = _data(4)
    assert _window_feed_names(main, {"x": X[0], "y": Y[0]}, 1) == ()
    assert _window_feed_names(main, {"x": X[0], "y": Y[0]}, 4) == ()
    assert set(_window_feed_names(main, {"x": X, "y": Y}, 4)) == {"x", "y"}
    assert _window_feed_names(main, {"x": X, "y": Y[0]}, 4) == ("x",)
    # a plain run with a window-ranked feed of another length is no window
    assert _window_feed_names(main, {"x": X}, 1) == ()


def test_k_attribute_feed_sets_n_steps():
    """A feed with an int ``k`` is k stacked batches: it sets n_steps
    (bitwise as an explicit n_steps), and a contradicting n_steps
    raises."""
    X, Y = _data(4)
    implied = _torch_run(X, Y, windowed=True)
    main, startup, loss = _build(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    out, = exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss],
                   scope=scope, n_steps=4)
    assert np.array_equal(out[:, 0], implied[0])
    with pytest.raises(ValueError, match="window of 4"):
        exe.run(main, feed=KFeed({"x": X, "y": Y}, 4), fetch_list=[loss],
                scope=scope, n_steps=2)


def test_interpreted_window_fallback_matches_compiled(mode):
    """Windowed feeds on the interpreter run step by step with the same
    stacked contract: bitwise equal to the compiled window."""
    X, Y = _data(4)
    compiled = _torch_run(X, Y, windowed=True, dropout=0.3)
    mode("interpreted")
    main, startup, loss = _build(tfluid, dropout=0.3)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    out, = exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss],
                   scope=scope, n_steps=4)
    assert exe._last_run_mode == "interpreted" and out.shape == (4, 1)
    ws = {n: scope.find_var(n).value().array.numpy() for n in _weights()}
    _assert_bitwise(compiled, (out[:, 0], ws))


def test_same_feed_n_steps_interpreted_returns_final_fetches(mode):
    """The same feeds for n_steps: the compiled path stacks every step's
    fetches [n, 1]; the interpreter returns the final step's [1], as the
    TPU package's interpreted branch does. Both run n steps."""
    X, Y = _data(1)
    feed = {"x": X[0], "y": Y[0]}
    got = {}
    for m in ("compiled", "interpreted"):
        mode(m)
        main, startup, loss = _build(tfluid)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       n_steps=3)
        assert exe._last_run_mode == m
        got[m] = (out, scope.find_var("w1").value().array.numpy().copy())
    assert got["compiled"][0].shape == (3, 1)
    assert got["interpreted"][0].shape == (1,)
    assert got["interpreted"][0][0] == got["compiled"][0][-1, 0]
    assert np.array_equal(got["interpreted"][1], got["compiled"][1])
    assert not np.array_equal(got["compiled"][0][0], got["compiled"][0][-1])


def test_n_steps_must_be_positive():
    main, startup, loss = _build(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(ValueError, match="n_steps"):
        exe.run(main, feed={}, fetch_list=[loss], n_steps=0)


# ------------------------------------------------------------- feed cache
def test_feed_cache_skips_unchanged_and_reuploads_mutated():
    """FLAGS_feed_device_cache (on by default): the same ndarray fed again
    unchanged is not uploaded again; mutated in place it is, and the run
    reads the new values; a fresh array of a name is a new upload."""
    assert tcore.get_flag("FLAGS_feed_device_cache") is True
    main, startup, loss = _build(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    X, Y = _data(1)
    x, y = X[0].copy(), Y[0].copy()

    def run():
        return exe.run(main, feed={"x": x, "y": y}, fetch_list=[loss],
                       scope=scope)[0][0]
    run()
    assert exe.feed_stats == {"uploads": 2, "cache_hits": 0}
    run()
    assert exe.feed_stats == {"uploads": 2, "cache_hits": 2}
    x[0, 0] += 1.0  # in place: same object, new content
    run()
    assert exe.feed_stats == {"uploads": 3, "cache_hits": 3}
    cached = exe._feed_cache["x"][3]
    assert torch.equal(cached, torch.from_numpy(x))
    # the cached device copy does not share the array's memory
    x[0, 0] += 1.0
    assert not torch.equal(cached, torch.from_numpy(x))
    y = y.copy()
    run()
    assert exe.feed_stats["uploads"] == 5


def test_feed_cache_off_uploads_every_run():
    main, startup, loss = _build(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    X, Y = _data(1)
    tcore.set_flag("FLAGS_feed_device_cache", False)
    try:
        for _ in range(2):
            exe.run(main, feed={"x": X[0], "y": Y[0]}, fetch_list=[loss],
                    scope=scope)
    finally:
        tcore.set_flag("FLAGS_feed_device_cache", True)
    assert exe.feed_stats == {"uploads": 0, "cache_hits": 0}
    assert not exe._feed_cache
