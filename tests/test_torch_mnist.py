"""The MNIST-MLP front end of paddle_tpu_torch (models/mnist.py and bench's
mnist lane) against the TPU package, on the CPU:

- each new op's kernel against the TPU package's on the same numpy
  inputs (relu, softmax, cross_entropy, top_k, accuracy, momentum) at
  1e-5, and the generic grads of relu, softmax, cross_entropy and top_k
  against ``jax.vjp`` of the reference kernels at 1e-5 (the tolerance of
  tests/test_torch_train_slice.py); relu's grad at 0 is JAX's ½;
- the MNIST builders of both packages emit the same op lists, the MLP's
  and the conv net's;
- ``golden_mnist_trajectory.npz`` (tests/test_book_models.py:220): ten SGD
  steps of the fixture's MLP through the port at rtol 1e-4, atol 1e-5;
- a few Momentum steps of the MNIST program from the same weights,
  against the TPU package, at rtol 1e-4.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.fluid import core as jcore
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.ops.registry import OPS as TOPS

from test_torch_train_slice import _grad_both

TOL = 1e-5
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "golden_mnist_trajectory.npz")


def _r(seed):
    return np.random.RandomState(seed)


def _kernels(op_type, ins, attrs):
    """Both packages' forward kernels on numpy ``ins`` → (jax outs, torch
    outs), slot → numpy array."""
    jattrs = dict(JOPS.get(op_type).attr_defaults, **attrs)
    tattrs = dict(TOPS.get(op_type).attr_defaults, **attrs)
    jout = JOPS.get(op_type).kernel(
        {s: [None if a is None else jnp.asarray(a)] for s, a in ins.items()},
        jattrs)
    tout = TOPS.get(op_type).kernel(
        {s: [None if a is None else torch.from_numpy(np.asarray(a))]
         for s, a in ins.items()}, tattrs)
    assert set(jout) == set(tout), (set(jout), set(tout))
    return ({s: np.asarray(v[0]) for s, v in jout.items()},
            {s: v[0].numpy() for s, v in tout.items()})


def _same(op_type, ins, attrs, exact=()):
    j, t = _kernels(op_type, ins, attrs)
    for slot in j:
        assert t[slot].shape == j[slot].shape, slot
        if slot in exact:
            assert np.array_equal(t[slot], j[slot]), slot
        else:
            np.testing.assert_allclose(t[slot], j[slot], rtol=TOL, atol=TOL,
                                       err_msg=slot)
    return t


# --------------------------------------------------------------- forward
def test_relu():
    x = _r(0).normal(size=(4, 7)).astype(np.float32)
    x[0, :3] = 0.0
    _same("relu", {"X": x}, {})


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax(axis):
    _same("softmax", {"X": _r(1).normal(size=(3, 5, 6)).astype(np.float32)
                      * 4}, {"axis": axis})


@pytest.mark.parametrize("kind", ["hard", "ignore", "soft"])
def test_cross_entropy(kind):
    r = _r(2)
    p = r.dirichlet(np.ones(10), size=6).astype(np.float32)
    if kind == "soft":
        label = r.dirichlet(np.ones(10), size=6).astype(np.float32)
    else:
        label = r.randint(0, 10, (6, 1)).astype(np.int64)
        if kind == "ignore":
            label[2, 0] = -100
    _same("cross_entropy", {"X": p, "Label": label},
          {"soft_label": kind == "soft"})


@pytest.mark.parametrize("k", [1, 3])
def test_top_k(k):
    t = _same("top_k", {"X": _r(3).normal(size=(5, 9)).astype(np.float32)},
              {"k": k}, exact=("Indices",))
    assert t["Indices"].dtype == np.int64  # the Indices var's dtype


@pytest.mark.parametrize("k", [1, 3])
def test_accuracy(k):
    r = _r(4)
    x = r.normal(size=(16, 10)).astype(np.float32)
    label = r.randint(0, 10, (16, 1)).astype(np.int64)
    label[:4, 0] = np.argmax(x[:4], axis=1)  # some hits
    vals, idx = torch.topk(torch.from_numpy(x), k)
    t = _same("accuracy", {"Out": vals.numpy(), "Indices": idx.numpy(),
                           "Label": label}, {},
              exact=("Correct", "Total"))
    want = np.mean([label[i, 0] in idx[i].tolist() for i in range(16)])
    assert t["Accuracy"][0] == pytest.approx(want)


@pytest.mark.parametrize("nesterov,reg", [(False, ""), (True, ""),
                                          (False, "l2_decay")])
def test_momentum(nesterov, reg):
    r = _r(5)
    ins = {"Param": r.normal(size=(7, 3)).astype(np.float32),
           "Grad": r.normal(size=(7, 3)).astype(np.float32),
           "Velocity": r.normal(size=(7, 3)).astype(np.float32),
           "LearningRate": np.array([0.05], np.float32)}
    _same("momentum", ins, {"mu": 0.9, "use_nesterov": nesterov,
                            "regularization_method": reg,
                            "regularization_coeff": 0.01})


# ----------------------------------------------------------------- grads
def test_grad_relu_ties_split_evenly():
    x = _r(6).normal(size=(4, 9)).astype(np.float32)
    x[1, :4] = 0.0
    g = _grad_both("relu", {"X": x}, {})
    assert (g["X@GRAD"][0].numpy()[1, :4] != 0).all()  # ½ g, not 0


@pytest.mark.parametrize("axis", [-1, 0])
def test_grad_softmax(axis):
    _grad_both("softmax", {"X": _r(7).normal(size=(4, 6)).astype(
        np.float32) * 3}, {"axis": axis})


@pytest.mark.parametrize("ignore", [False, True])
def test_grad_cross_entropy(ignore):
    r = _r(8)
    label = r.randint(0, 10, (6, 1)).astype(np.int64)
    if ignore:
        label[3, 0] = -100
    g = _grad_both("cross_entropy", {
        "X": r.dirichlet(np.ones(10), size=6).astype(np.float32),
        "Label": label}, {})
    assert g["Label@GRAD"] == [None]


def test_grad_top_k():
    _grad_both("top_k", {"X": _r(9).normal(size=(5, 8)).astype(np.float32)},
               {"k": 3})


# -------------------------------------------------------------- programs
def _types(program):
    return [op.type for op in program.global_block().ops]


def test_mnist_builder_op_lists_match():
    with tfluid.unique_name.guard():
        tmain, tstart, tfeeds, tloss, tacc = tmnist.build_mnist_program()
    with jfluid.unique_name.guard():
        jmain, jstart, jfeeds, jloss, jacc = jmnist.build_mnist_program()
    assert _types(tmain) == _types(jmain)
    assert _types(tstart) == _types(jstart)
    assert tfeeds == jfeeds == ["img", "label"]
    assert {"relu", "softmax", "cross_entropy", "top_k", "accuracy",
            "adam"} <= set(_types(tmain))


def test_mnist_conv_net_names_its_slice():
    """The LeNet-style conv net (ROADMAP A9): both builders emit the same
    op lists, in the main and the startup program."""
    with tfluid.unique_name.guard():
        tmain, tstart, tfeeds, _, _ = tmnist.build_mnist_program(net="conv")
    with jfluid.unique_name.guard():
        jmain, jstart, jfeeds, _, _ = jmnist.build_mnist_program(net="conv")
    assert _types(tmain) == _types(jmain)
    assert _types(tstart) == _types(jstart)
    assert tfeeds == jfeeds == ["img", "label"]
    assert _types(tmain).count("conv2d") == 2
    assert {"pool2d", "batch_norm", "conv2d_grad", "pool2d_grad",
            "batch_norm_grad", "adam"} <= set(_types(tmain))
    with pytest.raises(ValueError, match="'mlp' or 'conv'"):
        tmnist.build_mnist_program(net="lenet")


def test_mnist_golden_trajectory():
    fx = np.load(FIXTURE)
    X, Y = fx["X"].astype(np.float32), fx["Y"]

    def attr(name, key):
        return tfluid.ParamAttr(
            name=name, initializer=tfluid.initializer.NumpyArrayInitializer(
                fx[key].astype(np.float32)))
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        img = tfluid.data("img", shape=[784], dtype="float32")
        label = tfluid.data("label", shape=[1], dtype="int64")
        h = tfluid.layers.fc(img, 64, act="relu",
                             param_attr=attr("g_w1", "w1"),
                             bias_attr=attr("g_b1", "b1"))
        pred = tfluid.layers.fc(h, 10, act="softmax",
                                param_attr=attr("g_w2", "w2"),
                                bias_attr=attr("g_b2", "b2"))
        loss = tfluid.layers.mean(tfluid.layers.cross_entropy(pred, label))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    got = [float(exe.run(main, feed={"img": X, "label": Y},
                         fetch_list=[loss], scope=scope)[0][0])
           for _ in range(len(fx["losses"]))]
    assert exe._last_run_mode == "compiled"
    np.testing.assert_allclose(got, fx["losses"], rtol=1e-4, atol=1e-5)


def _momentum_mnist(fluid, run):
    """The bench lane's MLP, narrowed, with numpy weights and Momentum."""
    r = _r(10)
    shapes = {"w1": (784, 32), "b1": (32,), "w2": (32, 32), "b2": (32,),
              "w3": (32, 10), "b3": (10,)}
    w = {n: (r.normal(size=s) * 0.05).astype(np.float32)
         for n, s in shapes.items()}

    def attr(n):
        return fluid.ParamAttr(
            name=n, initializer=fluid.initializer.NumpyArrayInitializer(w[n]))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("img", shape=[784], dtype="float32")
        label = fluid.data("label", shape=[1], dtype="int64")
        h = fluid.layers.fc(img, 32, act="relu", param_attr=attr("w1"),
                            bias_attr=attr("b1"))
        h = fluid.layers.fc(h, 32, act="relu", param_attr=attr("w2"),
                            bias_attr=attr("b2"))
        pred = fluid.layers.fc(h, 10, act="softmax", param_attr=attr("w3"),
                               bias_attr=attr("b3"))
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        acc = fluid.layers.accuracy(pred, label)
        fluid.optimizer.Momentum(0.05, momentum=0.9).minimize(loss)
    rd = _r(11)
    X = rd.rand(16, 784).astype(np.float32)
    Y = rd.randint(0, 10, (16, 1)).astype(np.int64)
    return run(main, startup, {"img": X, "label": Y}, [loss, acc])


def test_momentum_mnist_steps_match_jax():
    def trun(main, startup, feed, fetch):
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        return [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
                for _ in range(4)]

    def jrun(main, startup, feed, fetch):
        exe, scope = jfluid.Executor(), jcore.Scope()
        with jfluid.scope_guard(scope):
            exe.run(startup)
            return [exe.run(main, feed=feed, fetch_list=fetch)
                    for _ in range(4)]
    t = _momentum_mnist(tfluid, trun)
    j = _momentum_mnist(jfluid, jrun)
    np.testing.assert_allclose([float(s[0][0]) for s in t],
                               [float(np.asarray(s[0]).ravel()[0]) for s in j],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose([float(s[1][0]) for s in t],
                               [float(np.asarray(s[1]).ravel()[0]) for s in j])
    losses = [float(s[0][0]) for s in t]
    assert losses[-1] < losses[0]
