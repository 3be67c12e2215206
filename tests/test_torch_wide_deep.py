"""Wide&Deep CTR training on paddle_tpu_torch against the TPU package, on
the CPU (models/wide_deep.py, the ops it adds, bench's wide_deep lane):

- each new op's forward and generic grad against the TPU kernels on the
  same numpy inputs at 1e-5: lookup_table with ids [N, 1] and [N, T, 1]
  and with ``padding_idx``, concat on axes 0 and 1, sigmoid, log_loss
  with p near 0 and 1;
- ``auc`` bitwise over three accumulating calls (the histograms and the
  AUC), with predictions on bucket edges, p = 1.0 (bucket nt) and one
  label class only (AUC 0); the TPU kernel keeps its counts in int32 (x64
  is off), so values are compared, not dtypes; the device sweep against
  the host loop ``auc_from_histograms``; a NaN prediction counted in
  bucket 0;
- the model: the same op types in order, parameter names and partition;
  five Adam steps at 4 slots, 1000 ids, embeddings of 8, hidden (32, 32),
  batch 64, from the TPU package's startup values: losses and parameters
  at rtol 1e-4, atol 1e-5, the AUC within 1e-3 (one ulp of sigmoid can
  move a prediction one bucket), the histograms' totals equal;
- ``golden_embedding_trajectory.npz`` (tests/test_book_models.py:420)
  through the port at rtol 1e-4, atol 1e-5: the gather forward and the
  scatter-add grad every embedding table of this model trains through;
- the wide_deep lane's CPU result line at 1000 ids a slot.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid.ir import analyze_block_segments as j_analyze
from paddle_tpu.models import wide_deep as jwide_deep
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
from paddle_tpu.utils.metrics import auc_from_histograms as j_auc_hist
from paddle_tpu_torch import bench, fluid as tfluid
from paddle_tpu_torch.fluid.ir import analyze_block_segments
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import wide_deep as twide_deep
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad
from paddle_tpu_torch.utils.metrics import (auc_from_histograms,
                                            auc_from_histograms_device)

TOL = 1e-5
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "golden_embedding_trajectory.npz")
SMALL = dict(num_dense=13, num_slots=4, sparse_dim=1000, embedding_dim=8,
             hidden=(32, 32), lr=1e-3)


@pytest.fixture(autouse=True)
def _pin_seed():
    """The TPU package's startup draws from ``program.random_seed or
    FLAGS_seed``; pin FLAGS_seed so that an earlier test that sets it
    changes nothing here."""
    old = jcore.globals_["FLAGS_seed"]
    jcore.globals_["FLAGS_seed"] = 0
    yield
    jcore.globals_["FLAGS_seed"] = old


def _r(seed):
    return np.random.RandomState(seed)


def _both(op_type, ins, attrs, grad=True):
    """Both packages' forward kernels, and with ``grad`` their generic
    grads under seeded output grads, on numpy ``ins`` (slot → list of
    arrays or None); every output and every ``<slot>@GRAD`` compared at
    TOL."""
    tattrs = dict(TOPS.get(op_type).attr_defaults, **attrs)
    jattrs = dict(JOPS.get(op_type).attr_defaults, **attrs)
    tins = {s: [None if a is None else torch.from_numpy(np.asarray(a))
                for a in v] for s, v in ins.items()}
    jins = {s: [None if a is None else jnp.asarray(a) for a in v]
            for s, v in ins.items()}
    tout = TOPS.get(op_type).kernel(tins, tattrs)
    jout = JOPS.get(op_type).kernel(jins, jattrs)
    assert set(tout) == set(jout)
    r = _r(99)
    for slot in jout:
        t, j = tout[slot][0].detach().numpy(), np.asarray(jout[slot][0])
        assert t.shape == j.shape, slot
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL, err_msg=slot)
        if grad and np.issubdtype(j.dtype, np.floating):
            g = r.normal(size=j.shape).astype(np.float32)
            tins[slot + "@GRAD"] = [torch.from_numpy(g)]
            jins[slot + "@GRAD"] = [jnp.asarray(g)]
    if not grad:
        return tout
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
                                           rtol=TOL, atol=TOL,
                                           err_msg=slot)
    return tout


# ------------------------------------------------------------------ ops
@pytest.mark.parametrize("ids_shape,pad", [((9, 1), -1), ((3, 5, 1), -1),
                                           ((9, 1), 2)])
def test_lookup_table(ids_shape, pad):
    r = _r(0)
    w = r.normal(size=(7, 4)).astype(np.float32)
    ids = r.randint(0, 7, ids_shape).astype(np.int64)
    ids.reshape(-1)[:3] = 2  # repeated ids, and the padding id
    out = _both("lookup_table", {"W": [w], "Ids": [ids]},
                {"padding_idx": pad})
    assert tuple(out["Out"][0].shape) == ids_shape[:-1] + (4,)


@pytest.mark.parametrize("axis", [0, 1])
def test_concat(axis):
    r = _r(1)
    xs = [r.normal(size=(3, 4)).astype(np.float32),
          r.normal(size=(3, 4)).astype(np.float32),
          r.normal(size=(3, 4)).astype(np.float32)]
    _both("concat", {"X": xs}, {"axis": axis})


def test_concat_axis_tensor():
    r = _r(2)
    xs = [r.normal(size=(2, 3)).astype(np.float32) for _ in range(2)]
    out = _both("concat", {"X": xs, "AxisTensor": [np.array([1], np.int32)]},
                {}, grad=False)
    assert tuple(out["Out"][0].shape) == (2, 6)


def test_sigmoid():
    x = _r(3).normal(size=(5, 6)).astype(np.float32) * 4
    _both("sigmoid", {"X": [x]}, {})


def test_log_loss_near_0_and_1():
    r = _r(4)
    p = r.uniform(0.01, 0.99, (12, 1)).astype(np.float32)
    p[:3, 0] = [0.0, 1e-6, 1.0 - 1e-6]
    p[3, 0] = 1.0
    label = r.randint(0, 2, (12, 1)).astype(np.float32)
    label[:4, 0] = [1, 0, 1, 0]
    _both("log_loss", {"Predicted": [p], "Labels": [label]},
          {"epsilon": 1e-4})


# ------------------------------------------------------------------ auc
def _auc_batches():
    nt = 4095
    r = _r(5)
    batches = []
    for i in range(3):
        p = r.uniform(0, 1, 64).astype(np.float32)
        p[:8] = np.arange(8, dtype=np.float32) * 7 / nt  # bucket edges
        p[8] = 1.0  # bucket nt
        p[9] = np.float32(0.5)
        label = r.randint(0, 2, (64, 1)).astype(np.int64)
        batches.append((np.stack([1 - p, p], axis=1), label))
    # one label class only: AUC 0
    p = r.uniform(0, 1, 16).astype(np.float32)
    only = (np.stack([1 - p, p], axis=1), np.ones((16, 1), np.int64))
    return nt, batches, only


def _auc_run(kernel, as_array, pred, label, pos, neg, nt):
    outs = kernel({"Predict": [as_array(pred)], "Label": [as_array(label)],
                   "StatPos": [as_array(pos)], "StatNeg": [as_array(neg)]},
                  {"curve": "ROC", "num_thresholds": nt, "slide_steps": 1})
    return [np.asarray(outs[k][0]) for k in ("AUC", "StatPosOut",
                                             "StatNegOut")]


def test_auc_bitwise_over_accumulating_calls():
    nt, batches, only = _auc_batches()
    jk, tk = JOPS.get("auc").kernel, TOPS.get("auc").kernel
    zeros = np.zeros(nt + 1, np.int64)
    jpos = jneg = tpos = tneg = zeros
    for pred, label in batches:
        ja, jpos, jneg = _auc_run(jk, jnp.asarray, pred, label, jpos, jneg,
                                  nt)
        ta, tpos, tneg = _auc_run(tk, torch.from_numpy, pred, label,
                                  tpos, tneg, nt)
        assert ta.dtype == np.float32 and ta.shape == (1,)
        assert np.array_equal(tpos, jpos.astype(np.int64))
        assert np.array_equal(tneg, jneg.astype(np.int64))
        assert ta.tobytes() == ja.astype(np.float32).tobytes()
    assert tpos[nt] >= 3 and 0.0 < float(ta[0]) < 1.0
    ta, tp, tn = _auc_run(tk, torch.from_numpy, *only, zeros, zeros, nt)
    ja, _, _ = _auc_run(jk, jnp.asarray, *only, zeros, zeros, nt)
    assert float(ta[0]) == float(ja[0]) == 0.0
    assert int(tn.sum()) == 0 and int(tp.sum()) == 16


def test_auc_buckets_a_nan_prediction_in_range():
    """A NaN prediction counts in bucket 0: the scatter stays in range, so
    a poisoned step reaches the numeric fault guard. A negative one wraps
    as the TPU kernel's numpy index does: -0.5 lands in bucket
    4096 - 2047 = 2049."""
    nt = 4095
    p = np.array([np.nan, -0.5, 0.25, 1.0], np.float32)
    pred = np.stack([1 - p, p], axis=1)
    label = np.array([[1], [0], [1], [0]], np.int64)
    zeros = np.zeros(nt + 1, np.int64)
    _, pos, neg = _auc_run(TOPS.get("auc").kernel, torch.from_numpy, pred,
                           label, zeros, zeros, nt)
    assert pos[0] == 1 and neg[2049] == 1
    assert pos[int(np.float32(0.25) * nt)] == 1 and neg[nt] == 1
    assert int(pos.sum()) + int(neg.sum()) == 4


@pytest.mark.parametrize("positive", [False, True])
def test_auc_out_of_range_predictions_match_reference(positive):
    """Predictions outside [0, 1] bucket as the TPU kernel's numpy does:
    min(trunc(p * nt), nt), a negative bucket wrapped by the index."""
    nt = 4095
    p = np.array([-0.5, -1.0, 0.0, 0.25, 1.0], np.float32)
    pred = np.stack([1 - p, p], axis=1)
    label = np.full((len(p), 1), int(positive), np.int64)
    zeros = np.zeros(nt + 1, np.int64)
    ta, tpos, tneg = _auc_run(TOPS.get("auc").kernel, torch.from_numpy,
                              pred, label, zeros, zeros, nt)
    ja, jpos, jneg = _auc_run(JOPS.get("auc").kernel, jnp.asarray, pred,
                              label, zeros, zeros, nt)
    assert np.array_equal(tpos, jpos.astype(np.int64))
    assert np.array_equal(tneg, jneg.astype(np.int64))
    hist = tpos if positive else tneg
    assert sorted(np.nonzero(hist)[0].tolist()) == [0, 1, 1023, 2049, 4095]
    assert ta.tobytes() == ja.astype(np.float32).tobytes()


def test_auc_device_sweep_is_the_host_loop():
    r = _r(6)
    for n, hi in ((4096, 50), (4096, 500), (17, 3)):
        pos = r.randint(0, hi, n).astype(np.int64)
        neg = r.randint(0, hi, n).astype(np.int64)
        pos[r.rand(n) < 0.3] = 0
        want = j_auc_hist(pos, neg)
        assert auc_from_histograms(pos, neg) == want
        got = auc_from_histograms_device(torch.from_numpy(pos),
                                         torch.from_numpy(neg))
        assert got.dtype == torch.float64 and float(got) == want
    z = torch.zeros(8, dtype=torch.int64)
    assert float(auc_from_histograms_device(z, z + 1)) == 0.0


# ---------------------------------------------------------------- model
def _programs(**kw):
    cfg = dict(SMALL, **kw)
    with jfluid.unique_name.guard():
        j = jwide_deep.build_wide_deep_program(**cfg)
    with tfluid.unique_name.guard():
        t = twide_deep.build_wide_deep_program(**cfg)
    return j, t


def test_programs_match():
    (jmain, jstart, jfeeds, jloss, jauc), (tmain, tstart, tfeeds, tloss,
                                           tauc) = _programs()
    jops = [op for op in jmain.global_block().ops
            if op.type not in ("feed", "fetch")]
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jops]
    assert tfeeds == jfeeds
    jp = sorted(v.name for v in jmain.global_block().vars.values()
                if v.persistable)
    tp = sorted(v.name for v in tmain.global_block().vars.values()
                if v.persistable)
    assert tp == jp
    assert [(s.kind, s.start, s.stop) for s in
            analyze_block_segments(tmain.global_block().ops)] == \
        [(s.kind, s.start, s.stop) for s in j_analyze(jops)]
    for name in ("wide_emb_0", "deep_emb_3", "deep_fc_w_0", "wide_dense_w"):
        assert tmain.global_block().vars[name].shape == \
            tuple(jmain.global_block().vars[name].shape)


def test_ctr_reader_draws_alike():
    a = jwide_deep.ctr_reader(32, num_slots=5, sparse_dim=100, seed=3)
    b = twide_deep.ctr_reader(32, num_slots=5, sparse_dim=100, seed=3)
    for _ in range(2):
        fa, fb = a(), b()
        assert sorted(fa) == sorted(fb)
        for k in fa:
            assert np.array_equal(fa[k], fb[k]) and \
                fa[k].dtype == fb[k].dtype


def test_adam_steps_match_the_tpu_package():
    (jmain, jstart, _, jloss, jauc), (tmain, tstart, _, tloss, tauc) = \
        _programs()
    jexe, jscope = jfluid.Executor(), jcore.Scope()
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    names = sorted(v.name for v in jmain.global_block().vars.values()
                   if v.persistable)
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    texe.run(tstart, scope=tscope)
    set_params_from_numpy(tscope, {
        n: np.asarray(jscope.find_var(n).get_tensor().array).astype(
            tscope.find_var(n).value().array.numpy().dtype)
        for n in names})
    nb = twide_deep.ctr_reader(64, num_dense=13, num_slots=4,
                               sparse_dim=1000, seed=0)
    feeds = [nb() for _ in range(5)]
    jl, tl = [], []
    for f in feeds:
        with jfluid.scope_guard(jscope):
            l, a = jexe.run(jmain, feed=f, fetch_list=[jloss, jauc])
        jl.append((float(np.asarray(l).ravel()[0]),
                   float(np.asarray(a).ravel()[0])))
        l, a = texe.run(tmain, feed=f, fetch_list=[tloss, tauc],
                        scope=tscope)
        tl.append((float(l.ravel()[0]), float(a.ravel()[0])))
    assert jexe._last_run_mode == texe._last_run_mode == "segmented"
    np.testing.assert_allclose([x[0] for x in tl], [x[0] for x in jl],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose([x[1] for x in tl], [x[1] for x in jl],
                               atol=1e-3)
    for n in names:
        want = np.asarray(jscope.find_var(n).get_tensor().array)
        got = tscope.find_var(n).value().array.numpy()
        if n.endswith(("_stat_pos", "_stat_neg")):
            continue  # a prediction may sit one bucket away: totals below
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    jp = [np.asarray(jscope.find_var(n).get_tensor().array)
          for n in names if n.endswith(("_stat_pos", "_stat_neg"))]
    tp = [tscope.find_var(n).value().array.numpy()
          for n in names if n.endswith(("_stat_pos", "_stat_neg"))]
    assert [int(x.sum()) for x in tp] == [int(x.sum()) for x in jp]
    assert sum(int(x.sum()) for x in tp) == 5 * 64


# --------------------------------------------------- golden trajectory
def test_embedding_golden_trajectory_on_the_port():
    fx = np.load(FIXTURE)
    golden = fx["losses"]
    ini = tfluid.initializer.NumpyArrayInitializer
    V, E = fx["ew"].shape
    T = fx["IDS"].shape[1]
    CLS = fx["fw"].shape[1]
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ids = tfluid.data("ids", shape=[T], dtype="int64")
        label = tfluid.data("label", shape=[1], dtype="int64")
        emb = tfluid.layers.embedding(
            ids, [V, E], param_attr=tfluid.ParamAttr(
                name="gemb_w", initializer=ini(fx["ew"].astype("float32"))))
        pooled = tfluid.layers.reduce_mean(emb, dim=1)
        pred = tfluid.layers.fc(
            pooled, CLS, act="softmax",
            param_attr=tfluid.ParamAttr(
                name="gemb_fw", initializer=ini(fx["fw"].astype("float32"))),
            bias_attr=tfluid.ParamAttr(
                name="gemb_fb", initializer=ini(fx["fb"].astype("float32"))))
        loss = tfluid.layers.mean(tfluid.layers.cross_entropy(pred, label))
        tfluid.optimizer.SGD(0.2).minimize(loss)
    assert "lookup_table_v2" in [op.type for op in main.global_block().ops]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    got = [float(exe.run(main, feed={"ids": fx["IDS"], "label": fx["Y"]},
                         fetch_list=[loss], scope=scope)[0].ravel()[0])
           for _ in range(len(golden))]
    np.testing.assert_allclose(got, golden, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------- lane
def test_wide_deep_lane_cpu_line():
    res = bench.bench_wide_deep(sparse_dim=1000, device="cpu")
    assert res["metric"] == "wide_deep_ctr_samples_per_sec_per_chip"
    assert res["unit"] == "samples/s" and res["value"] > 0
    assert (res["batch"], res["steps"]) == (256, 5)
    assert res["embedding_params"] == 26 * 1000 * 16 + 26 * 1000
    assert res["compiled_metric"] is True
    assert res["executor_mode"] == "segmented"
    assert res["timed_window"] == {"eager": 5, "captures": 0,
                                   "replays": 0, "islands": 5}
    assert 0.0 <= res["auc"] <= 1.0 and np.isfinite(res["loss"])
    assert res["device"] == "cpu" and res["cpu_smoke"] is True
    assert jax.devices()[0].platform == "cpu"  # nothing here ran on a card
