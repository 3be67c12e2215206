"""The loss op batch in paddle_tpu_torch against the TPU package's
kernels, on the CPU: nn_ops.py's 13 losses (log_softmax, cross_entropy2,
sigmoid_cross_entropy_with_logits, bce_loss, huber_loss, smooth_l1_loss,
kldiv_loss, hinge_loss, rank_loss, margin_rank_loss, nll_loss, mse_loss,
bpr_loss), loss_extra_ops.py's 9 (warpctc, ctc_align, edit_distance,
center_loss, grid_sampler, random_crop,
sampled_softmax_with_cross_entropy, spectral_norm,
teacher_student_sigmoid_loss) and framework_ops.py's py_func:

- outputs and generic grads at rtol 1e-5, atol 1e-6 (the port's op
  tests' tolerance) through ``test_torch_vision_ops.run_both``; integer
  outputs exactly; each ``ignore_index`` and ``normalize`` mask as the
  TPU kernel has it (an out-of-range label picks NaN in both);
- center_loss and grid_sampler held against ``OPS.get(t).kernel``, the
  loss_extra_ops.py registration that wins over nn_extra_ops.py's;
- warpctc's loss against the TPU kernel, and its grad where the TPU
  kernel's is finite; the TPU kernel's ``lse`` backward divides 0 by 0
  where both terms are unreachable, so its grad holds NaN rows that the
  port's does not (ROADMAP C). The port's grad is held against
  ``torch.nn.functional.ctc_loss``'s, an independent CTC. A label its
  sequence cannot hold gives the TPU kernel's 1e30 and a zero grad;
- the random ops (random_crop, sampled softmax) by what a draw must
  give, their bits being the port's own;
- py_func in a program, compiled and interpreted.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch.ops import rng
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad
from tests.test_torch_vision_ops import RTOL, ATOL, run_both

NEW_OPS = (
    "log_softmax", "cross_entropy2", "sigmoid_cross_entropy_with_logits",
    "bce_loss", "huber_loss", "smooth_l1_loss", "kldiv_loss", "hinge_loss",
    "rank_loss", "margin_rank_loss", "nll_loss", "mse_loss", "bpr_loss",
    "warpctc", "ctc_align", "edit_distance", "center_loss", "grid_sampler",
    "random_crop", "sampled_softmax_with_cross_entropy", "spectral_norm",
    "teacher_student_sigmoid_loss", "py_func")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _probs(shape, seed=0):
    e = np.exp(_x(shape, seed))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_every_op_registered_with_the_reference_flags():
    for t in NEW_OPS:
        ti, ji = TOPS.get(t), JOPS.get(t)
        for flag in ("no_grad", "stateful", "needs_rng", "needs_lod"):
            assert getattr(ti, flag) == getattr(ji, flag), (t, flag)
        assert list(ti.diff_input_slots or []) == \
            list(ji.diff_input_slots or []), t
        assert tuple(ti.host_inputs) == tuple(ji.host_inputs), t


def test_double_registrations_take_loss_extra_ops():
    """center_loss and grid_sampler: the TPU package registers both in
    nn_extra_ops.py and again in loss_extra_ops.py, imported later."""
    for t in ("center_loss", "grid_sampler"):
        assert JOPS.get(t).kernel.__module__ == \
            "paddle_tpu.ops.loss_extra_ops"
        assert TOPS.get(t).kernel.__module__ == \
            "paddle_tpu_torch.ops.loss_extra_ops"


LBL5 = np.array([[1], [0], [3], [2], [3]], np.int64)
LOSSES = [
    ("log_softmax", {"X": [_x((3, 5))]}, {"axis": -1}, None),
    ("log_softmax", {"X": [_x((3, 4, 5))]}, {"axis": 1}, None),
    ("cross_entropy2", {"X": [_probs((5, 4))], "Label": [LBL5]}, {}, ["X"]),
    ("sigmoid_cross_entropy_with_logits",
     {"X": [_x((4, 3))], "Label": [np.array([[1, 0, -100], [0, 1, 1],
                                             [-100, -100, 0], [1, 1, 0]],
                                            np.float32)]},
     {"ignore_index": -100}, ["X"]),
    ("sigmoid_cross_entropy_with_logits",
     {"X": [_x((4, 3))], "Label": [np.array([[1, 0, -1], [0, 1, 1],
                                             [-1, -1, 0], [1, 1, 0]],
                                            np.float32)]},
     {"ignore_index": -1, "normalize": True}, ["X"]),
    ("bce_loss", {"X": [1 / (1 + np.exp(-_x((4, 3))))],
                  "Label": [(np.abs(_x((4, 3), 1)) > 0.5).astype("f4")]},
     {}, ["X"]),
    ("huber_loss", {"X": [_x((5, 1))], "Y": [_x((5, 1), 1)]},
     {"delta": 0.6}, ["X"]),
    ("smooth_l1_loss", {"X": [_x((4, 3, 2))], "Y": [_x((4, 3, 2), 1)],
                        "InsideWeight": [np.abs(_x((4, 3, 2), 2))],
                        "OutsideWeight": [np.abs(_x((4, 3, 2), 3))]},
     {"sigma": 1.5}, ["X"]),
    ("smooth_l1_loss", {"X": [_x((4, 3))], "Y": [_x((4, 3), 1)]}, {},
     ["X"]),
    ("kldiv_loss", {"X": [_x((3, 4))], "Target": [_probs((3, 4), 1)
                                                  * (_x((3, 4), 2) > -.5)]},
     {"reduction": "mean"}, ["X"]),
    ("kldiv_loss", {"X": [_x((3, 4))], "Target": [_probs((3, 4), 1)]},
     {"reduction": "batchmean"}, ["X"]),
    ("kldiv_loss", {"X": [_x((3, 4))], "Target": [_probs((3, 4), 1)]},
     {"reduction": "none"}, ["X"]),
    ("hinge_loss", {"Logits": [_x((5, 1))],
                    "Labels": [(_x((5, 1), 1) > 0).astype("f4")]}, {},
     ["Logits"]),
    ("rank_loss", {"Label": [(_x((5, 1), 2) > 0).astype("f4")],
                   "Left": [_x((5, 1))], "Right": [_x((5, 1), 1)]}, {},
     ["Left", "Right"]),
    ("margin_rank_loss", {"Label": [np.sign(_x((5, 1), 2))],
                          "X1": [_x((5, 1))], "X2": [_x((5, 1), 1)]},
     {"margin": 0.1}, ["X1", "X2"]),
    ("nll_loss", {"X": [np.log(_probs((5, 4)))],
                  "Label": [LBL5.reshape(-1)],
                  "Weight": [np.abs(_x((4,), 1))]}, {}, ["X"]),
    ("nll_loss", {"X": [np.log(_probs((5, 4)))],
                  "Label": [LBL5.reshape(-1)]}, {"reduction": "sum"}, ["X"]),
    ("nll_loss", {"X": [np.log(_probs((5, 4)))],
                  "Label": [LBL5.reshape(-1)]}, {"reduction": "none"},
     ["X"]),
    ("mse_loss", {"X": [_x((4, 3))], "Y": [_x((4, 3), 1)]}, {}, ["X", "Y"]),
    ("bpr_loss", {"X": [_x((5, 4))], "Label": [LBL5]}, {}, ["X"]),
]


@pytest.mark.parametrize("op_type,ins,attrs,diff", LOSSES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LOSSES)])
def test_nn_losses(op_type, ins, attrs, diff):
    run_both(op_type, ins, attrs, diff=diff)


@pytest.mark.parametrize("op_type", ["nll_loss", "cross_entropy2"])
def test_ignored_labels_as_the_tpu_kernel(op_type):
    """nll_loss's ignore_index weighs the row 0 but its gather still
    picks outside the classes (NaN, which stays in the sum: NaN·0), and
    cross_entropy2 applies no ignore_index: both as the TPU kernel."""
    lbl = np.array([1, -100, 2, 0], np.int64)
    if op_type == "nll_loss":
        ins = {"X": [np.log(_probs((4, 3)))], "Label": [lbl]}
    else:
        ins = {"X": [_probs((4, 3))], "Label": [lbl.reshape(-1, 1)]}
    o = run_both(op_type, ins, {}, grad=False)
    first = next(iter(o.values()))[0].numpy()
    assert np.isnan(first).any()


def _ctc_case(seed, t_lens, lab_lens, c=5, blank=0):
    r = np.random.RandomState(seed)
    logits = r.normal(size=(sum(t_lens), c)).astype(np.float32) * 2
    labels = r.randint(1, c, (sum(lab_lens), 1)).astype(np.int32)
    lod = {"Logits": [(tuple(np.concatenate([[0], np.cumsum(t_lens)])
                             .tolist()),)],
           "Label": [(tuple(np.concatenate([[0], np.cumsum(lab_lens)])
                            .tolist()),)]}
    return logits, labels, lod


def _ctc_both(logits, labels, lod, attrs):
    tattrs = dict(TOPS.get("warpctc").attr_defaults, _lod=lod, **attrs)
    jattrs = dict(JOPS.get("warpctc").attr_defaults, _lod=lod, **attrs)
    g = np.random.RandomState(9).normal(size=(len(lod["Label"][0][0]) - 1,
                                              1)).astype(np.float32)
    tins = {"Logits": [torch.from_numpy(logits)],
            "Label": [torch.from_numpy(labels)],
            "Loss@GRAD": [torch.from_numpy(g)]}
    jins = {"Logits": [jnp.asarray(logits)], "Label": [jnp.asarray(labels)],
            "Loss@GRAD": [jnp.asarray(g)]}
    tl = TOPS.get("warpctc").kernel(tins, tattrs)["Loss"][0].numpy()
    jl = np.asarray(JOPS.get("warpctc").kernel(jins, jattrs)["Loss"][0])
    tg = t_generic_grad("warpctc", tins, tattrs, ["Logits@GRAD"],
                        ["Logits", "Label"])["Logits@GRAD"][0].numpy()
    jg = np.asarray(j_generic_grad("warpctc", jins, jattrs, ["Logits@GRAD"],
                                   ["Logits", "Label"])["Logits@GRAD"][0])
    return tl, jl, tg, jg, g


@pytest.mark.parametrize("norm", [False, True])
def test_warpctc_against_the_tpu_kernel_and_torch_ctc(norm):
    t_lens, lab_lens = [7, 5, 9], [3, 2, 4]
    logits, labels, lod = _ctc_case(0, t_lens, lab_lens)
    tl, jl, tg, jg, g = _ctc_both(logits, labels, lod,
                                  {"norm_by_times": norm})
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    fin = np.isfinite(jg)
    np.testing.assert_allclose(tg[fin], jg[fin], rtol=1e-4, atol=1e-5)
    assert np.isfinite(tg).all()
    # an independent CTC: torch's, over the same padded sequences
    n, tm = len(t_lens), max(t_lens)
    lp = torch.zeros((tm, n, logits.shape[1]))
    x = torch.from_numpy(logits).requires_grad_()
    offs = np.concatenate([[0], np.cumsum(t_lens)])
    logp = torch.log_softmax(x, -1)
    for i in range(n):
        lp[:t_lens[i], i] = logp[offs[i]:offs[i + 1]]
    ref = F.ctc_loss(lp, torch.from_numpy(labels.reshape(-1)).long(),
                     torch.tensor(t_lens), torch.tensor(lab_lens),
                     blank=0, reduction="none")
    if norm:
        ref = ref / torch.tensor(t_lens, dtype=torch.float32)
    np.testing.assert_allclose(tl.reshape(-1), ref.detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    (gref,) = torch.autograd.grad(ref, x, torch.from_numpy(g.reshape(-1)))
    np.testing.assert_allclose(tg, gref.numpy(), rtol=1e-4, atol=1e-5)


def test_warpctc_infeasible_label():
    """A label longer than its sequence allows: the TPU kernel's loss
    (−NEG_INF = 1e30, not inf) in both; the port's grad on that row is
    0 and finite elsewhere, where the TPU kernel's holds NaN."""
    logits, labels, lod = _ctc_case(1, [6, 2], [2, 3])
    tl, jl, tg, jg, _ = _ctc_both(logits, labels, lod, {})
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    assert tl[1, 0] == np.float32(1e30)
    assert np.isfinite(tg).all() and not tg[6:].any()
    fin = np.isfinite(jg)
    np.testing.assert_allclose(tg[fin], jg[fin], rtol=1e-4, atol=1e-5)
    assert not fin.all()


def test_ctc_align_both_modes():
    x = np.array([0, 1, 1, 0, 2, 2, 2, 0, 3, 0, 0, 0, 4, 4], np.int32)
    lod = {"Input": [((0, 9, 12, 14),)]}
    o = run_both("ctc_align", {"Input": [x.reshape(-1, 1)]},
                 {"blank": 0}, grad=False, lod=lod)
    assert o["_lod"]["Output"] == [((0, 3, 4, 5),)]
    np.testing.assert_array_equal(o["Output"][0].numpy().reshape(-1),
                                  [1, 2, 3, -1, 4])
    run_both("ctc_align", {"Input": [x.reshape(-1, 1)]},
             {"blank": 0, "merge_repeated": False}, grad=False, lod=lod)
    padded = np.array([[0, 1, 1, 2, 0, 2], [3, 3, 0, 0, 0, 0]], np.int32)
    run_both("ctc_align", {"Input": [padded],
                           "InputLength": [np.array([[6], [3]], np.int64)]},
             {"blank": 0, "padding_value": -1}, grad=False)


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance(normalized):
    hyp = np.array([1, 2, 3, 4, 5, 5, 1, 2], np.int64).reshape(-1, 1)
    ref = np.array([1, 3, 3, 5, 5, 2, 1], np.int64).reshape(-1, 1)
    lod = {"Hyps": [((0, 4, 6, 8),)], "Refs": [((0, 3, 5, 7),)]}
    o = run_both("edit_distance", {"Hyps": [hyp], "Refs": [ref]},
                 {"normalized": normalized}, grad=False, lod=lod)
    if not normalized:
        np.testing.assert_array_equal(o["Out"][0].numpy().reshape(-1),
                                      [2, 0, 2])


def test_center_loss():
    x = _x((6, 4))
    lbl = np.array([[0], [2], [2], [1], [0], [2]], np.int64)
    cen = _x((3, 4), 1)
    for ins, attrs in (
            ({"X": [x], "Label": [lbl], "Centers": [cen],
              "CenterUpdateRate": [np.array([0.3], np.float32)]}, {}),
            ({"X": [x], "Label": [lbl], "Centers": [cen]},
             {"need_update": False})):
        run_both("center_loss", ins, attrs, diff=["X"])


def test_grid_sampler():
    x = _x((2, 3, 5, 6))
    grid = np.random.RandomState(1).uniform(
        -1.2, 1.2, (2, 4, 3, 2)).astype(np.float32)
    run_both("grid_sampler", {"X": [x], "Grid": [grid]})


def test_spectral_norm():
    for w, dim in ((_x((4, 3, 2)), 0), (_x((3, 5)), 1)):
        h = w.shape[dim]
        rest = w.size // h
        run_both("spectral_norm", {"Weight": [w], "U": [_x((h,), 1)],
                                   "V": [_x((rest,), 2)]},
                 {"dim": dim, "power_iters": 2}, diff=["Weight"],
                 tol=(1e-4, 1e-5))


def test_teacher_student_sigmoid_loss():
    x = _x((6, 1)) * 10
    label = np.array([[1], [0], [-1.3], [-2.0], [1], [-1.0]], np.float32)
    run_both("teacher_student_sigmoid_loss", {"X": [x], "Label": [label]},
             {"soft_max_up_bound": 15.0, "soft_max_lower_bound": -15.0},
             diff=["X"])


def _key(seed):
    return lambda: torch.full((1,), rng.hash32_int(seed), dtype=torch.int64)


def test_random_crop_is_a_window_of_x():
    x = torch.arange(2 * 3 * 7 * 6, dtype=torch.float32).reshape(2, 3, 7, 6)
    attrs = dict(TOPS.get("random_crop").attr_defaults, shape=[4, 3])
    starts = set()
    for seed in range(12):
        o = TOPS.get("random_crop").kernel({"X": [x]},
                                           dict(attrs, _rng=_key(seed)))
        o = o["Out"][0]
        assert o.shape == (2, 3, 4, 3)
        h0, w0 = divmod(int(o[0, 0, 0, 0].item()), 6)
        assert 0 <= h0 <= 3 and 0 <= w0 <= 3
        assert torch.equal(o, x[:, :, h0:h0 + 4, w0:w0 + 3])
        starts.add((h0, w0))
    assert len(starts) > 3


def test_sampled_softmax_over_the_drawn_columns():
    """The loss is softmax CE over [label, the drawn columns]: rebuilt from
    the same draw, and its grad (a column drawn twice adds) through the
    generic grad matches autograd's through a plain gather."""
    n, v, s = 6, 9, 5
    logits = torch.from_numpy(_x((n, v)))
    label = torch.from_numpy(np.arange(n).reshape(n, 1) % v)
    attrs = dict(TOPS.get("sampled_softmax_with_cross_entropy")
                 .attr_defaults, num_samples=s, _rng=_key(3))
    loss = TOPS.get("sampled_softmax_with_cross_entropy").kernel(
        {"Logits": [logits], "Label": [label]}, attrs)["Loss"][0]
    cols = torch.cat([label, rng.randint(_key(3)(), (n, s), 0, v)], 1)
    x = logits.clone().requires_grad_()
    ref = -torch.log_softmax(torch.gather(x, 1, cols), -1)[:, :1]
    np.testing.assert_allclose(loss.numpy(), ref.detach().numpy(),
                               rtol=RTOL, atol=ATOL)
    g = torch.from_numpy(_x((n, 1), 5))
    tg = t_generic_grad("sampled_softmax_with_cross_entropy",
                        {"Logits": [logits], "Label": [label],
                         "Loss@GRAD": [g]}, attrs, ["Logits@GRAD"],
                        ["Logits", "Label"])["Logits@GRAD"][0]
    (gref,) = torch.autograd.grad(ref, x, g)
    np.testing.assert_allclose(tg.numpy(), gref.numpy(), rtol=RTOL,
                               atol=ATOL)
