"""The ops of the optimizer stack in paddle_tpu_torch against the TPU
package's kernels, on the CPU, on the same seeded numpy inputs.

- paddle_tpu/ops/math_ops.py: ``clip`` :340, ``clip_by_norm`` :345 (above
  and below its max), ``squared_l2_norm`` :353, ``l1_norm`` :358, the
  activations ``sqrt`` :242, ``rsqrt`` :243, ``abs`` :244, ``reciprocal``
  :255, ``sign`` :263 and ``pow`` :310, and ``elementwise_mod`` :65 on
  floats and on int32 and int64 with negative operands (the divisor's
  sign, as Python's ``%``): each output at OP_TOL
  (tests/test_torch_train_slice.py:48), and the grads of the
  differentiable ones through each package's generic grad (torch
  autograd against jax.vjp) under seeded output grads, at OP_TOL.
- paddle_tpu/ops/optimizer_ops.py, every update op: ``adamax`` :70,
  ``adagrad`` :85, ``decayed_adagrad`` :94, ``adadelta`` :104,
  ``rmsprop`` :117 (centered and not), ``ftrl`` :142 (lr_power -0.5 and
  another, with zero grads on fresh accumulators, which keep their
  parameters), ``lamb`` :167 (with and without weight decay, and a zero
  parameter, whose trust ratio is 1), ``lars_momentum`` :193 (and its
  fallback to lr), ``dpsgd`` :212 at sigma 0, ``proximal_gd`` :227,
  ``proximal_adagrad`` :238 and ``average_accumulates`` :251: every
  output slot of the TPU kernel, under its name, at OP_TOL or tighter.
- ``dpsgd`` at sigma > 0 by distribution (the port cannot draw
  ``jax.random.normal``'s bits): the noise's mean and standard deviation
  over 2^16 elements, and a draw that changes with the key.
- The registry: the 23 ops the optimizer stack adds are registered with
  the TPU package's no_grad flags, random flags and attr defaults.
- The layers (paddle_tpu/fluid/layers/nn.py :808-976, ops.py :36-38,
  tensor.py :103): one program of each package builds the same ops and
  ProgramDesc bytes and computes the same values at OP_TOL.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.ops import rng
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad

OP_TOL = 1e-5  # tests/test_torch_train_slice.py:48


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small kernels gain nothing from more,
    and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

NEW_OPS = ("clip", "clip_by_norm", "squared_l2_norm", "l1_norm", "sqrt",
           "rsqrt", "abs", "reciprocal", "sign", "pow", "lamb",
           "lars_momentum", "adagrad", "adamax", "decayed_adagrad",
           "adadelta", "rmsprop", "ftrl", "dpsgd", "proximal_gd",
           "proximal_adagrad", "average_accumulates", "elementwise_mod")


def _r(seed):
    return np.random.RandomState(seed)


def _kernels(op_type, ins, attrs):
    """Both kernels on numpy ``ins`` (slot → list of arrays) → (torch
    outputs, jax outputs, the torch inputs, the jax inputs, the attrs of
    each)."""
    tattrs = dict(TOPS.get(op_type).attr_defaults, **attrs)
    jattrs = dict(JOPS.get(op_type).attr_defaults, **attrs)
    tins = {s: [torch.from_numpy(np.asarray(a).copy()) for a in v]
            for s, v in ins.items()}
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    return (TOPS.get(op_type).kernel(tins, tattrs),
            JOPS.get(op_type).kernel(jins, jattrs), tins, jins, tattrs,
            jattrs)


def _both(op_type, ins, attrs=None, grad=True, tol=OP_TOL):
    """Every output slot of both kernels at ``tol``; with ``grad`` also
    the generic grads of every input slot under seeded output grads."""
    tout, jout, tins, jins, tattrs, jattrs = _kernels(op_type, ins,
                                                      attrs or {})
    assert set(tout) == set(jout)
    r = _r(99)
    for slot in jout:
        t, j = tout[slot][0].detach().numpy(), np.asarray(jout[slot][0])
        # JAX without x64 holds an int64 as int32
        assert t.shape == j.shape and (t.dtype == j.dtype or (
            t.dtype == np.int64 and j.dtype == np.int32)), slot
        np.testing.assert_allclose(t, j, rtol=tol, atol=tol, err_msg=slot)
        if grad and np.issubdtype(j.dtype, np.floating):
            g = r.normal(size=j.shape).astype(j.dtype)
            tins[slot + "@GRAD"] = [torch.from_numpy(g)]
            jins[slot + "@GRAD"] = [jnp.asarray(g)]
    if grad:
        slots = list(ins)
        wanted = [s + "@GRAD" for s in slots]
        tg = t_generic_grad(op_type, tins, tattrs, wanted, slots)
        jg = j_generic_grad(op_type, jins, jattrs, wanted, slots)
        assert set(tg) == set(jg)
        for slot in jg:
            for t, j in zip(tg[slot], jg[slot]):
                assert (t is None) == (j is None), slot
                if j is not None:
                    np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                               rtol=tol, atol=tol,
                                               err_msg=slot)
    return tout


# ------------------------------------------------------------- math ops
def test_the_registry_has_the_optimizer_stacks_ops():
    for op in NEW_OPS:
        t, j = TOPS.get(op), JOPS.get(op)
        assert (t.no_grad, t.needs_rng) == (j.no_grad, j.needs_rng), op
        assert t.attr_defaults == j.attr_defaults, op
    # 123 with the optimizer stack; then 49 more: the 19 LoD sequence ops,
    # sequence_mask, cos_sim and 28 activations; then 6 fused ops (the
    # BuildStrategy fusions, skip_layernorm and the three LoD fusions);
    # then 61: tensor_ops' 53, isinf, isnan, lstm, lstm_unit, nce,
    # hierarchical_sigmoid, linear_chain_crf and crf_decoding; then 24:
    # the 9 left of rnn_ops, the 10 LoD control ops, fusion_gru,
    # fusion_lstm, rnn_memory_helper, cumsum and elementwise_floordiv;
    # then 69: the rest of nn_ops (29), math_ops (17), nn_extra_ops (13)
    # and loss_extra_ops (9), and py_func; then 44: vision_ops (18),
    # detection_ops (16), detection_train_ops (9) and detection_map; then
    # 47: framework_ops' 8, hash, the 4 reader ops, cudnn_lstm, the 2
    # engine stubs, metrics_misc_ops' 22 and fused_ops' 9
    assert len(TOPS.all_op_types()) == \
        123 + 49 + 6 + 61 + 24 + 69 + 44 + 47


@pytest.mark.parametrize("lo,hi", [(-0.5, 0.5), (0.0, 2.0), (-3.0, -1.0)])
def test_clip(lo, hi):
    x = (_r(0).randn(6, 7) * 2).astype(np.float32)
    out = _both("clip", {"X": [x]}, {"min": lo, "max": hi})
    assert out["Out"][0].min() >= lo and out["Out"][0].max() <= hi


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_norm_above_and_below_its_max(max_norm):
    x = _r(1).randn(5, 9).astype(np.float32)
    out = _both("clip_by_norm", {"X": [x]}, {"max_norm": max_norm})
    norm = float(torch.linalg.vector_norm(out["Out"][0]))
    want = min(max_norm, float(np.linalg.norm(x.astype(np.float64))))
    assert abs(norm - want) <= 1e-5 * want


@pytest.mark.parametrize("op", ["squared_l2_norm", "l1_norm"])
def test_norms(op):
    x = _r(2).randn(4, 3, 5).astype(np.float32)
    out = _both(op, {"X": [x]})["Out"][0]
    assert tuple(out.shape) == (1,)
    x64 = x.astype(np.float64)
    want = (x64 ** 2).sum() if op == "squared_l2_norm" else abs(x64).sum()
    np.testing.assert_allclose(out.numpy(), [want], rtol=1e-6)


@pytest.mark.parametrize("op,attrs,positive", [
    ("sqrt", {}, True), ("rsqrt", {}, True), ("abs", {}, False),
    ("reciprocal", {}, True), ("pow", {"factor": 2.0}, False),
    ("pow", {"factor": 0.5}, True), ("pow", {"factor": 3.0}, False)])
def test_activations(op, attrs, positive):
    x = _r(3).randn(8, 6).astype(np.float32)
    x = np.abs(x) + 0.1 if positive else x
    _both(op, {"X": [x]}, attrs)


def test_sign_has_no_grad_and_is_exact():
    x = _r(4).randn(5, 5).astype(np.float32)
    x[0, :3] = 0.0
    out = _both("sign", {"X": [x]}, grad=False)["Out"][0].numpy()
    assert np.array_equal(out, np.sign(x))
    assert TOPS.get("sign").no_grad and JOPS.get("sign").no_grad


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64])
@pytest.mark.parametrize("yshape", [(4, 6), (6,), (1,)])
def test_elementwise_mod_takes_the_divisors_sign(dtype, yshape):
    r = _r(5)
    if dtype == np.float32:
        x = (r.randn(4, 6) * 7).astype(dtype)
        y = (np.abs(r.randn(*yshape)) * 3 + 0.5).astype(dtype)
        y.reshape(-1)[::2] *= -1
    else:
        x = r.randint(-20, 21, (4, 6)).astype(dtype)
        y = r.choice([-7, -3, 2, 4, 5], yshape).astype(dtype)
    out = _both("elementwise_mod", {"X": [x], "Y": [y]}, {"axis": -1},
                grad=dtype == np.float32)["Out"][0].numpy()
    want = np.mod(x, np.broadcast_to(y, x.shape))
    if dtype == np.float32:
        np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-5)
    else:
        assert out.dtype == dtype and np.array_equal(out, want)
    # the divisor's sign, as Python's %, which torch.fmod would break
    yb = np.broadcast_to(y, x.shape)
    assert np.all((out == 0) | (np.sign(out) == np.sign(yb)))


def test_gradient_merge_step_mod_k_as_int32():
    """GradientMerge's condition: step % k == 0 on an int32 [1]."""
    for step in range(1, 9):
        out = _both("elementwise_mod",
                    {"X": [np.array([step], np.int32)],
                     "Y": [np.array([4], np.int32)]}, grad=False)
        assert out["Out"][0].tolist() == [step % 4]


# --------------------------------------------------------- update ops
def _param_ins(r, shape=(6, 5), lr=0.01):
    return {"Param": [r.randn(*shape).astype(np.float32)],
            "Grad": [r.randn(*shape).astype(np.float32)],
            "LearningRate": [np.array([lr], np.float32)]}


def _pos(r, shape=(6, 5)):
    return (np.abs(r.randn(*shape)) + 0.05).astype(np.float32)


def _pow(v):
    return np.array([v], np.float32)


def _update_case(name):
    r = _r(10 + UPDATE_CASES.index(name))
    ins = _param_ins(r)
    attrs = {}
    op = name.split(":")[0]
    if op == "adamax":
        ins.update(Moment=[r.randn(6, 5).astype(np.float32) * 0.1],
                   InfNorm=[_pos(r)], Beta1Pow=[_pow(0.9 ** 3)])
        attrs = {"beta1": 0.9, "beta2": 0.99, "epsilon": 1e-8}
    elif op in ("adagrad", "decayed_adagrad"):
        ins.update(Moment=[_pos(r)])
        attrs = {"decay": 0.9} if op == "decayed_adagrad" else {}
    elif op == "adadelta":
        del ins["LearningRate"]
        ins.update(AvgSquaredGrad=[_pos(r)], AvgSquaredUpdate=[_pos(r)])
        attrs = {"rho": 0.9, "epsilon": 1e-6}
    elif op == "rmsprop":
        ms = _pos(r) + 1.0
        ins.update(MeanSquare=[ms], Moment=[r.randn(6, 5).astype(
            np.float32) * 0.1], MeanGrad=[r.randn(6, 5).astype(
                np.float32) * 0.1])
        attrs = {"decay": 0.9, "momentum": 0.5, "epsilon": 1e-6,
                 "centered": name.endswith("centered")}
    elif op == "ftrl":
        sq = _pos(r)
        g = ins["Grad"][0]
        sq[0] = 0.0  # fresh accumulators, zero grads: the denominator 0
        g[0] = 0.0
        ins.update(SquaredAccumulator=[sq], LinearAccumulator=[
            r.randn(6, 5).astype(np.float32)])
        power = name.endswith("power")
        # l2 0: the zero rows' denominator is 0 (lr_power -0.5)
        attrs = {"l1": 0.1, "l2": 0.01 if power else 0.0,
                 "lr_power": -0.3 if power else -0.5}
    elif op == "lamb":
        if name.endswith("zero_param"):
            ins["Param"][0][:] = 0.0
        ins.update(Moment1=[r.randn(6, 5).astype(np.float32) * 0.1],
                   Moment2=[_pos(r) * 0.1], Beta1Pow=[_pow(0.9 ** 2)],
                   Beta2Pow=[_pow(0.999 ** 2)])
        attrs = {"weight_decay": 0.0 if name.endswith("no_decay")
                 else 0.01}
    elif op == "lars_momentum":
        if name.endswith("fallback"):
            ins["Param"][0][:] = 0.0
        ins.update(Velocity=[r.randn(6, 5).astype(np.float32) * 0.1])
        attrs = {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 5e-4}
    elif op == "proximal_gd":
        attrs = {"l1": 0.05, "l2": 0.1}
        ins["LearningRate"] = [np.array([0.5], np.float32)]
    elif op == "proximal_adagrad":
        ins.update(Moment=[_pos(r)])
        attrs = {"l1": 0.05, "l2": 0.1}
        ins["LearningRate"] = [np.array([0.5], np.float32)]
    elif op == "dpsgd":
        attrs = {"clip": 1.0, "batch_size": 32.0, "sigma": 0.0}
    elif op == "average_accumulates":
        ins = {"param": [r.randn(6, 5).astype(np.float32)],
               "in_sum_1": [r.randn(6, 5).astype(np.float32)],
               "in_sum_2": [r.randn(6, 5).astype(np.float32)],
               "in_sum_3": [r.randn(6, 5).astype(np.float32)],
               "in_num_accumulates": [np.array([3], np.int64)],
               "in_old_num_accumulates": [np.array([1], np.int64)],
               "in_num_updates": [np.array([7], np.int64)]}
    return op, ins, attrs


UPDATE_CASES = ["adamax", "adagrad", "decayed_adagrad", "adadelta",
                "rmsprop", "rmsprop:centered", "ftrl", "ftrl:power",
                "lamb", "lamb:no_decay", "lamb:zero_param",
                "lars_momentum", "lars_momentum:fallback", "dpsgd",
                "proximal_gd", "proximal_adagrad", "average_accumulates"]


@pytest.mark.parametrize("name", UPDATE_CASES)
def test_update_op_matches_the_tpu_kernel(name):
    op, ins, attrs = _update_case(name)
    if op == "dpsgd":
        tattrs = dict(attrs, _rng=lambda: rng.fixed_key(3, "cpu"))
        jattrs = dict(attrs, _rng=jax.random.PRNGKey(3))
        tout = TOPS.get(op).kernel(
            {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()},
            dict(TOPS.get(op).attr_defaults, **tattrs))
        jout = JOPS.get(op).kernel(
            {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
            dict(JOPS.get(op).attr_defaults, **jattrs))
        assert set(tout) == set(jout) == {"ParamOut"}
        np.testing.assert_allclose(tout["ParamOut"][0].numpy(),
                                   np.asarray(jout["ParamOut"][0]),
                                   rtol=OP_TOL, atol=OP_TOL)
        return
    tout = _both(op, ins, attrs, grad=False)
    if name == "ftrl":  # the zero-denominator row keeps its parameter
        assert np.array_equal(tout["ParamOut"][0][0].numpy(),
                              ins["Param"][0][0])
    if name == "lamb:zero_param":  # trust ratio 1: p - lr * r
        assert tout["ParamOut"][0].abs().max() > 0


def _dpsgd_noise(key, sigma, n=1 << 16):
    """The noise the port's dpsgd adds, recovered from ParamOut at a zero
    grad: p_new = p - lr * noise / bs."""
    p = torch.zeros(n)
    outs = TOPS.get("dpsgd").kernel(
        {"Param": [p], "Grad": [torch.zeros(n)],
         "LearningRate": [torch.tensor([1.0])]},
        {"clip": 2.0, "batch_size": 1.0, "sigma": sigma,
         "_rng": lambda: key})
    return -outs["ParamOut"][0]


def test_dpsgd_noise_by_distribution():
    sigma, clip = 0.5, 2.0
    z = _dpsgd_noise(rng.fixed_key(11, "cpu"), sigma).double()
    std = sigma * clip
    assert abs(float(z.mean())) < 4 * std / 256  # 4 sigma of the mean
    assert abs(float(z.std()) / std - 1) < 0.02
    # the TPU kernel's noise, recovered alike, has the same law
    j = JOPS.get("dpsgd").kernel(
        {"Param": [jnp.zeros(1 << 16)], "Grad": [jnp.zeros(1 << 16)],
         "LearningRate": [jnp.ones(1)]},
        {"clip": clip, "batch_size": 1.0, "sigma": sigma,
         "_rng": jax.random.PRNGKey(0)})
    jz = -np.asarray(j["ParamOut"][0], np.float64)
    assert abs(jz.std() / std - 1) < 0.02
    other = _dpsgd_noise(rng.fixed_key(12, "cpu"), sigma)
    assert not torch.equal(other.double(), z)


def _layers_program(fluid):
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[4, 6], dtype="float32",
                       append_batch_size=False)
        k = fluid.data("k", shape=[4, 6], dtype="int32",
                       append_batch_size=False)
        pos = L.abs(x) + 0.5
        outs = [L.clip(x, -0.5, 0.5), L.clip_by_norm(x, 1.0), L.sign(x),
                L.pow(pos, 1.5), L.sqrt(pos), L.rsqrt(pos), L.abs(x),
                L.reciprocal(pos), L.sums([x, pos, x]),
                L.elementwise_max(x, pos * 0.5),
                L.elementwise_pow(pos, L.fill_constant([1], "float32", 2.0)),
                L.elementwise_mod(k, L.fill_constant([1], "int32", 3))]
    return main, outs


def test_layers_match_the_tpu_package(monkeypatch):
    from paddle_tpu.fluid import unique_name as jnames
    from paddle_tpu_torch.fluid import unique_name as tnames
    for m in (jnames, tnames):
        monkeypatch.setattr(m, "dygraph_parameter_name_generator",
                            m.UniqueNameGenerator())
    jm, jouts = _layers_program(jfluid)
    tm, touts = _layers_program(tfluid)
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    assert tm.serialize_to_string() == jm.serialize_to_string()
    r = _r(7)
    feed = {"x": r.randn(4, 6).astype(np.float32),
            "k": r.randint(-9, 10, (4, 6)).astype(np.int32)}
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed=feed, fetch_list=jouts, scope=jfluid.Scope())
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed=feed, fetch_list=touts, scope=tfluid.Scope())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=OP_TOL,
                                   atol=OP_TOL)
