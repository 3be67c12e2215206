"""The training slice of paddle_tpu_torch against the TPU package.

- Program: both packages build the small-config BERT pretraining step
  (2 layers, hidden 64, 4 heads, ffn 128, vocab 128, S = 16, input mask
  on) and ``append_backward`` + Adam emit the same ops, slots and public
  attrs — and the same ``_fwd_in`` / ``_fwd_idx`` records.
- Per-op grads: the port's ``run_generic_grad`` (torch autograd over the
  forward kernel) against the TPU package's (``jax.vjp``) on the same
  seeded numpy inputs and output grads, at 1e-5 in f32 (the per-op
  tolerance of test_torch_ops.py); dropout_grad, adam and sgd kernel
  against kernel.
- Golden trajectories: the port reproduces
  tests/fixtures/golden_encoder_trajectory.npz (SGD) and
  golden_encoder_adam_trajectory.npz at the JAX tests' tolerance, rtol 1e-4
  and atol 1e-5 (tests/test_book_models.py:388-418).
- Five Adam steps of the small pretraining program at dropout 0, from the
  same numpy parameters: the same losses and final parameters (tolerances
  at the test); again at seq_len 256 (max_len 256), the length at which
  the card runs bf16 attention on the streamed kernels.
- The ``_fwd_idx`` rule: with attention dropout 0.1, the executor's grads
  equal a direct autograd of the attention with the seed the forward drew.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.ops import rng as trng
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad

CFG = dict(vocab_size=128, hidden=64, layers=2, heads=4, ffn=128, max_len=16,
           type_vocab=2)
S, B, N_MASK = 16, 4, 10
OP_TOL = 1e-5
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _canonical(program):
    """Ops as (type, slots, public attrs, _fwd_in, _fwd_idx) with
    non-persistable, non-data var names replaced by their order of first
    appearance (temp-name counters differ between the packages' runs)."""
    block = program.global_block()
    ids = {}

    def name(n):
        v = block.vars.get(n)
        if v is not None and (v.persistable or v.is_data):
            return n
        return ids.setdefault(n, f"t{len(ids)}")

    ops = []
    for op in block.ops:
        ops.append((op.type,
                    {s: [name(n) for n in ns] for s, ns in op.inputs.items()},
                    {s: [name(n) for n in ns] for s, ns in op.outputs.items()},
                    {k: v for k, v in op.attrs.items()
                     if not k.startswith("_")},
                    op.attrs.get("_fwd_in"), op.attrs.get("_fwd_idx")))
    params = {v.name: (tuple(v.shape), v.dtype, v.persistable)
              for v in block.vars.values() if v.persistable or v.is_data}
    return ops, params


def _build_pretrain(fluid, bert, dropout=0.0, lr=1e-3):
    with fluid.unique_name.guard():
        main, startup, feeds, fetches = bert.build_bert_pretrain_program(
            CFG, seq_len=S, dropout=dropout, lr=lr, use_input_mask=True)
    startup.random_seed = 5
    return main, startup, feeds, fetches


def _pretrain_feed(step):
    r = np.random.RandomState(step)
    mask = np.ones((B, S), np.float32)
    mask[0, 10:] = 0.0
    mask[2, 5:] = 0.0
    return {"src_ids": r.randint(0, CFG["vocab_size"], (B, S)),
            "pos_ids": np.tile(np.arange(S), (B, 1)),
            "sent_ids": r.randint(0, CFG["type_vocab"], (B, S)),
            "mask_pos": r.randint(0, B * S, (N_MASK, 1)),
            "mask_label": r.randint(0, CFG["vocab_size"], (N_MASK, 1)),
            "input_mask": mask}


# ---------------------------------------------------------------- program
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_pretrain_programs_are_identical(dropout):
    jm, js, jfeeds, jfetch = _build_pretrain(jfluid, jbert, dropout)
    tm, ts, tfeeds, tfetch = _build_pretrain(tfluid, tbert, dropout)
    for jp, tp in ((jm, tm), (js, ts)):
        jops, jparams = _canonical(jp)
        tops, tparams = _canonical(tp)
        assert [o[0] for o in jops] == [o[0] for o in tops]
        for jo, to in zip(jops, tops):
            assert jo == to, (jo, to)
        assert jparams == tparams
    assert [v.name for v in jfeeds] == [v.name for v in tfeeds]
    assert jm._appending_grad_times == tm._appending_grad_times == 1
    types = [op.type for op in tm.global_block().ops]
    assert types.count("fused_attention_qkv_grad") == CFG["layers"]
    assert types.count("adam") == len(tm.all_parameters())
    if dropout:
        grads = [op for op in tm.global_block().ops
                 if op.type == "fused_attention_qkv_grad"]
        fwd = [i for i, op in enumerate(tm.global_block().ops)
               if op.type == "fused_attention_qkv"]
        assert [op.attrs["_fwd_idx"] for op in grads] == fwd[::-1]


def test_unported_options_raise():
    """use_amp and recompute are ported (tests/test_torch_amp.py,
    tests/test_torch_recompute.py), and so is the optimizer's grad_clip
    (tests/test_torch_optimizers.py): it builds its clip ops, where it
    raised before it was ported. append_backward's ``checkpoints`` and
    ``callbacks``, which raised on the port, are accepted and ignored as
    in the TPU package (its backward.py:150-152): both packages build the
    same program with them as without them."""
    with tfluid.unique_name.guard():
        main, _, _, (loss,) = tbert.build_bert_pretrain_program(
            CFG, seq_len=S, use_amp=True, recompute=True)
    assert main._recompute_opt["checkpoints"]
    assert "cast" in [op.type for op in main.global_block().ops]
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.data("x", shape=[4], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 2))
        tfluid.optimizer.Adam(1e-3, grad_clip=tfluid.clip.GradientClipByNorm(
            1.0)).minimize(loss)
    types = [op.type for op in main.global_block().ops]
    assert types.count("clip_by_norm") == 2

    def build(fluid, **kw):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.data("x", shape=[4], dtype="float32")
            h = fluid.layers.fc(x, 3, act="relu")
            loss = fluid.layers.mean(fluid.layers.fc(h, 2))
            pg = fluid.append_backward(
                loss, **{k: (v(h) if callable(v) else v)
                         for k, v in kw.items()})
        return main, [(p.name, g.name) for p, g in pg]

    plain = build(tfluid)
    opts = dict(checkpoints=lambda h: [h], callbacks=[lambda *a: None])
    for fluid in (tfluid, jfluid):
        main, pairs = build(fluid, **opts)
        assert pairs == plain[1]
        assert _canonical(main) == _canonical(plain[0])


# ---------------------------------------------------------- per-op grads
def _r(seed):
    return np.random.RandomState(seed)


def _f32(r, *shape):
    return r.normal(size=shape).astype(np.float32)


def _grad_both(op_type, ins, attrs, tol=OP_TOL):
    """Both packages' generic grad of ``op_type`` on numpy ``ins`` (slot →
    array or None) with seeded output grads for every float output; every
    ``<slot>@GRAD`` compared."""
    tattrs = dict(TOPS.get(op_type).attr_defaults, **attrs)
    jattrs = dict(JOPS.get(op_type).attr_defaults, **attrs)
    tattrs["_rng"] = lambda: torch.zeros(1, dtype=torch.int64)
    jattrs["_rng"] = jax.random.key(0)
    tins = {s: [None if a is None else torch.from_numpy(np.asarray(a))]
            for s, a in ins.items()}
    jins = {s: [None if a is None else jnp.asarray(a)] for s, a in ins.items()}
    fwd = TOPS.get(op_type).kernel(tins, tattrs)
    r = _r(99)
    for slot, vals in fwd.items():
        if vals[0].is_floating_point():
            g = _f32(r, *vals[0].shape)
            tins[slot + "@GRAD"] = [torch.from_numpy(g)]
            jins[slot + "@GRAD"] = [jnp.asarray(g)]
    slots = list(ins)
    wanted = [s + "@GRAD" for s in slots]
    tg = t_generic_grad(op_type, tins, tattrs, wanted, slots)
    jg = j_generic_grad(op_type, jins, jattrs, wanted, slots)
    assert set(tg) == set(jg), (set(tg), set(jg))
    for slot in jg:
        for t, j in zip(tg[slot], jg[slot]):
            assert (t is None) == (j is None), slot
            if j is not None:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=tol, atol=tol, err_msg=slot)
    return tg


@pytest.mark.parametrize("ignore", [False, True])
def test_grad_softmax_with_cross_entropy(ignore):
    r = _r(1)
    label = r.randint(0, 10, (6, 1)).astype(np.int64)
    if ignore:
        label[2, 0] = -100
    g = _grad_both("softmax_with_cross_entropy",
                   {"Logits": _f32(r, 6, 10) * 3, "Label": label}, {})
    assert g["Label@GRAD"] == [None]


def test_grad_gather_repeated_indices():
    r = _r(2)
    idx = np.array([1, 3, 1, 7, 1, 0], np.int64)
    g = _grad_both("gather", {"X": _f32(r, 8, 5), "Index": idx}, {})
    # the three reads of row 1 add up; unread rows get zeros
    assert (g["X@GRAD"][0][[2, 4, 5, 6]] == 0).all()


def test_grad_mean_sum_square_sub():
    r = _r(3)
    _grad_both("mean", {"X": _f32(r, 3, 4)}, {})
    _grad_both("square", {"X": _f32(r, 3, 4)}, {})
    _grad_both("elementwise_sub", {"X": _f32(r, 2, 3, 4),
                                   "Y": _f32(r, 2, 3, 4)}, {"axis": -1})
    tins = {"X": [torch.from_numpy(_f32(r, 2, 3)) for _ in range(3)]}
    total = TOPS.get("sum").kernel(tins, {})["Out"][0]
    np.testing.assert_allclose(total.numpy(),
                               sum(t.numpy() for t in tins["X"]), rtol=1e-6)


@pytest.mark.parametrize("bna", [1, 2])
def test_grad_layer_norm(bna):
    r = _r(4)
    x = _f32(r, 2, 3, 8) * 3 + 1
    d = int(np.prod(x.shape[bna:]))
    _grad_both("layer_norm", {"X": x, "Scale": _f32(r, d), "Bias": _f32(r, d)},
               {"epsilon": 1e-5, "begin_norm_axis": bna})


@pytest.mark.parametrize("xshape,yshape,xn", [((6, 12), (12, 5), 1),
                                              ((2, 3, 4), (4, 5), 2)])
def test_grad_mul(xshape, yshape, xn):
    r = _r(5)
    _grad_both("mul", {"X": _f32(r, *xshape), "Y": _f32(r, *yshape)},
               {"x_num_col_dims": xn, "y_num_col_dims": 1})


@pytest.mark.parametrize("yshape,axis", [((5,), 2), ((2, 3, 5), -1)])
def test_grad_elementwise_add_broadcast(yshape, axis):
    r = _r(6)
    _grad_both("elementwise_add", {"X": _f32(r, 2, 3, 5),
                                   "Y": _f32(r, *yshape)}, {"axis": axis})


@pytest.mark.parametrize("approximate", [False, True])
def test_grad_gelu(approximate):
    _grad_both("gelu", {"X": np.linspace(-5, 5, 60, dtype=np.float32)
                        .reshape(4, 15)}, {"approximate": approximate})


@pytest.mark.parametrize("padding_idx", [-1, 3])
def test_grad_lookup_table_v2(padding_idx):
    r = _r(7)
    ids = r.randint(0, 10, size=(3, 7)).astype(np.int64)
    ids[0, :3] = 3
    g = _grad_both("lookup_table_v2", {"W": _f32(r, 10, 6), "Ids": ids},
                   {"padding_idx": padding_idx})
    assert g["Ids@GRAD"] == [None]


def test_grad_scale_reshape_unsqueeze():
    r = _r(8)
    _grad_both("scale", {"X": _f32(r, 3, 5)},
               {"scale": 0.37, "bias": -2.0, "bias_after_scale": True})
    _grad_both("reshape2", {"X": _f32(r, 2, 3, 4)}, {"shape": [0, -1]})
    _grad_both("unsqueeze2", {"X": _f32(r, 2, 3)}, {"axes": [1]})


def test_grad_fused_attention_qkv_keypad():
    """The attention op's generic grad: the port's goes through
    FlashAttentionFunction (plain backward on the CPU), the TPU package's
    through the Pallas backward kernels in the interpreter."""
    r = _r(9)
    bsz, s, h, d = 2, 16, 4, 8
    bias = np.zeros((bsz, 1, 1, s), np.float32)
    bias[0, ..., 11:] = -1e9
    ins = {"Q": _f32(r, bsz, s, h * d), "K": _f32(r, bsz, s, h * d),
           "V": _f32(r, bsz, s, h * d), "Bias": bias}
    with fa.interpret_guard():
        g = _grad_both("fused_attention_qkv", ins,
                       {"num_heads": h, "causal": False, "dropout_rate": 0.0})
    assert g["Bias@GRAD"] == [None]  # Bias is not a diff input


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_mask_contract_and_grad(impl):
    """Out = X·Mask (/(1−p) when upscaling) with the Mask the op emits, and
    dropout_grad of both packages on ONE shared Mask agree."""
    r = _r(10)
    x = _f32(r, 64, 32)
    p = 0.3
    attrs = dict(TOPS.get("dropout").attr_defaults, dropout_prob=p,
                 dropout_implementation=impl)
    key = torch.tensor([3], dtype=torch.int64)
    outs = TOPS.get("dropout").kernel({"X": [torch.from_numpy(x)]},
                                      dict(attrs, _rng=lambda: key))
    mask = outs["Mask"][0]
    assert mask.dtype == torch.uint8
    scale = 1.0 / (1.0 - p) if impl == "upscale_in_train" else 1.0
    np.testing.assert_allclose(outs["Out"][0].numpy(),
                               x * mask.numpy() * scale, rtol=1e-6)
    assert abs(mask.float().mean().item() - (1.0 - p)) < 0.03
    g = _f32(r, 64, 32)
    tg = TOPS.get("dropout_grad").kernel(
        {"Out@GRAD": [torch.from_numpy(g)], "Mask": [mask]}, attrs)
    jg = JOPS.get("dropout_grad").kernel(
        {"Out@GRAD": [jnp.asarray(g)], "Mask": [jnp.asarray(mask.numpy())]},
        attrs)
    np.testing.assert_allclose(tg["X@GRAD"][0].numpy(),
                               np.asarray(jg["X@GRAD"][0]), rtol=1e-6)
    test = TOPS.get("dropout").kernel({"X": [torch.from_numpy(x)]},
                                      dict(attrs, is_test=True))
    np.testing.assert_allclose(test["Out"][0].numpy(),
                               x if impl == "upscale_in_train"
                               else x * (1.0 - p), rtol=1e-6)


@pytest.mark.parametrize("step", [1, 7])
def test_adam_and_sgd_kernels(step):
    r = _r(11)
    p_, g_, m_, v_ = (_f32(r, 5, 3) for _ in range(4))
    v_ = np.abs(v_)
    ins = {"Param": p_, "Grad": g_, "Moment1": m_, "Moment2": v_,
           "LearningRate": np.array([0.01], np.float32),
           "Beta1Pow": np.array([0.9 ** step], np.float32),
           "Beta2Pow": np.array([0.999 ** step], np.float32)}
    for op_type, slots in (("adam", list(ins)),
                           ("sgd", ["Param", "Grad", "LearningRate"])):
        attrs = dict(JOPS.get(op_type).attr_defaults)
        assert attrs == TOPS.get(op_type).attr_defaults
        tout = TOPS.get(op_type).kernel(
            {s: [torch.from_numpy(ins[s])] for s in slots}, attrs)
        jout = JOPS.get(op_type).kernel(
            {s: [jnp.asarray(ins[s])] for s in slots}, attrs)
        assert set(tout) == set(jout)
        for slot in jout:
            np.testing.assert_allclose(tout[slot][0].numpy(),
                                       np.asarray(jout[slot][0]),
                                       rtol=1e-6, atol=1e-7, err_msg=slot)


def _build_l2_regression(fluid, w0, b0):
    """fc regression under SGD with L2Decay: 0.1 on the optimizer (the
    bias takes it) and 0.5 on the weight's own ParamAttr (which wins)."""
    ini = fluid.initializer.NumpyArrayInitializer
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [8])
        t = fluid.data("t", [3])
        y = fluid.layers.fc(x, 3, param_attr=fluid.ParamAttr(
            name="w", initializer=ini(w0),
            regularizer=fluid.regularizer.L2Decay(0.5)),
            bias_attr=fluid.ParamAttr(name="b", initializer=ini(b0)))
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(y, t)))
        fluid.optimizer.SGD(
            0.1, regularization=fluid.regularizer.L2Decay(0.1)).minimize(loss)
    return main, startup, loss


def test_l2_decay_regularization_matches_jax():
    r = _r(13)
    w0, b0 = _f32(r, 8, 3), _f32(r, 3)
    feed = {"x": _f32(r, 4, 8), "t": _f32(r, 4, 3)}
    jm, js, jloss = _build_l2_regression(jfluid, w0, b0)
    tm, ts, tloss = _build_l2_regression(tfluid, w0, b0)
    jops, _ = _canonical(jm)
    tops, _ = _canonical(tm)
    assert jops == tops
    assert [op.type for op in tm.global_block().ops].count("scale") == 2
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    texe.run(ts, scope=tscope)
    for _ in range(3):
        jl = jexe.run(jm, feed=feed, fetch_list=[jloss], scope=jscope)[0]
        tl = texe.run(tm, feed=feed, fetch_list=[tloss], scope=tscope)[0]
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
    for n in ("w", "b"):
        np.testing.assert_allclose(
            tscope.find_var(n).value().array.numpy(),
            np.asarray(jscope.find_var(n).get_tensor()), rtol=1e-6,
            atol=1e-7)


# --------------------------------------------------- golden trajectories
def _run_encoder_golden(fixture, make_optimizer, prefix):
    """tests/test_book_models.py's encoder-layer golden harness, built with
    the port on the CPU: → (losses, golden losses, the executor's
    ``_last_run_mode``)."""
    fluid = tfluid
    fx = np.load(os.path.join(FIXTURES, fixture))
    ini = fluid.initializer.NumpyArrayInitializer

    def pa(key):
        return fluid.ParamAttr(name=f"{prefix}_{key}",
                               initializer=ini(fx[key].astype("float32")))

    H = fx["wq"].shape[0]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[6, H], dtype="float32")
        t = fluid.data("t", shape=[6, H], dtype="float32")
        q = fluid.layers.fc(x, H, num_flatten_dims=2,
                            param_attr=pa("wq"), bias_attr=pa("bq"))
        k = fluid.layers.fc(x, H, num_flatten_dims=2,
                            param_attr=pa("wk"), bias_attr=pa("bk"))
        v = fluid.layers.fc(x, H, num_flatten_dims=2,
                            param_attr=pa("wv"), bias_attr=pa("bv"))
        ctx = tbert.fused_multihead_attention(q, k, v, n_head=2)
        attn = fluid.layers.fc(ctx, H, num_flatten_dims=2,
                               param_attr=pa("wo"), bias_attr=pa("bo"))
        h1 = fluid.layers.layer_norm(
            fluid.layers.elementwise_add(x, attn), begin_norm_axis=2,
            param_attr=pa("g1"), bias_attr=pa("e1"))
        f = fluid.layers.fc(h1, fx["w1"].shape[1], num_flatten_dims=2,
                            act="gelu", param_attr=pa("w1"),
                            bias_attr=pa("b1"))
        f2 = fluid.layers.fc(f, H, num_flatten_dims=2,
                             param_attr=pa("w2"), bias_attr=pa("b2"))
        out2 = fluid.layers.layer_norm(
            fluid.layers.elementwise_add(h1, f2), begin_norm_axis=2,
            param_attr=pa("g2"), bias_attr=pa("e2"))
        loss = fluid.layers.mean(fluid.layers.square(
            fluid.layers.elementwise_sub(out2, t)))
        make_optimizer().minimize(loss)

    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    got = []
    for _ in range(len(fx["losses"])):
        (l,) = exe.run(main, feed={"x": fx["X"].astype("float32"),
                                   "t": fx["T"].astype("float32")},
                       fetch_list=[loss], scope=scope)
        got.append(float(np.asarray(l).ravel()[0]))
    return got, fx["losses"], exe._last_run_mode


@pytest.mark.parametrize("fixture,opt,prefix", [
    ("golden_encoder_trajectory.npz",
     lambda: tfluid.optimizer.SGD(0.05), "ge"),
    ("golden_encoder_adam_trajectory.npz",
     lambda: tfluid.optimizer.Adam(0.01, beta1=0.9, beta2=0.999,
                                   epsilon=1e-8), "gea"),
])
def test_encoder_golden_trajectory(fixture, opt, prefix):
    got, golden, run_mode = _run_encoder_golden(fixture, opt, prefix)
    assert run_mode == "compiled"  # the default path
    np.testing.assert_allclose(got, golden, rtol=1e-4, atol=1e-5)


# ------------------------------------------ pretraining steps vs the JAX run
def test_five_adam_steps_match_jax():
    """Five Adam steps (lr 1e-3) of the small pretraining program at
    dropout 0, both packages from the TPU package's startup parameters.
    Losses: rtol = atol = 1e-5 (measured 5e-7: the two sum in other
    orders). Parameters: atol 1e-5, except the K projections' biases,
    whose exact grad is 0 (softmax is invariant to the q·b_k it adds to a
    row): their grads are rounding noise, which Adam's m/(√v+ε) turns into
    steps of ±lr, so those may differ by up to 2·lr per step."""
    lr = 1e-3
    jm, js, _, jfetch = _build_pretrain(jfluid, jbert, lr=lr)
    tm, ts, _, tfetch = _build_pretrain(tfluid, tbert, lr=lr)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
              for v in jm.global_block().vars.values() if v.persistable}
    tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    texe.run(ts, scope=tscope)
    set_params_from_numpy(tscope, arrays)
    jl, tl = [], []
    for step in range(5):
        feed = _pretrain_feed(step)
        jl.append(float(jexe.run(jm, feed=feed, fetch_list=jfetch,
                                 scope=jscope)[0][0]))
        tl.append(float(texe.run(tm, feed=feed, fetch_list=tfetch,
                                 scope=tscope)[0][0]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    # the K projection of each layer is the 2nd fc of its attention
    k_bias = {f"fc_{6 * i + 1}.b_0" for i in range(CFG["layers"])}
    for name in arrays:
        want = np.asarray(jscope.find_var(name).get_tensor())
        got = tscope.find_var(name).value().array.numpy()
        atol = 2 * lr * 5 if name in k_bias else 1e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


# BERT's pretraining at a length where the card runs bf16 attention on the
# streamed kernels (S above 128): the narrow config at max_len 256
CFG_256 = dict(CFG, max_len=256)
S_256, B_256, N_MASK_256 = 256, 2, 64


def _pretrain_feed_256(step):
    r = np.random.RandomState(100 + step)
    mask = np.ones((B_256, S_256), np.float32)
    mask[0, 200:] = 0.0
    mask[1, 131:] = 0.0
    return {"src_ids": r.randint(0, CFG["vocab_size"], (B_256, S_256)),
            "pos_ids": np.tile(np.arange(S_256), (B_256, 1)),
            "sent_ids": r.randint(0, CFG["type_vocab"], (B_256, S_256)),
            "mask_pos": r.randint(0, B_256 * S_256, (N_MASK_256, 1)),
            "mask_label": r.randint(0, CFG["vocab_size"], (N_MASK_256, 1)),
            "input_mask": mask}


def test_five_adam_steps_match_jax_at_seq_len_256():
    """test_five_adam_steps_match_jax at seq_len 256 (2 layers, hidden 64,
    4 heads, max_len 256, an input mask that pads each row past 128): the
    model whose attention takes the streamed route on the card, held to
    the reference on the CPU from the same numpy parameters, at that
    test's tolerances."""
    lr = 1e-3
    progs = []
    for fluid, bert in ((jfluid, jbert), (tfluid, tbert)):
        with fluid.unique_name.guard():
            main, startup, _, fetches = bert.build_bert_pretrain_program(
                CFG_256, seq_len=S_256, dropout=0.0, lr=lr,
                use_input_mask=True)
        startup.random_seed = 5
        progs.append((main, startup, fetches))
    (jm, js, jfetch), (tm, ts, tfetch) = progs
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name).get_tensor())
              for v in jm.global_block().vars.values() if v.persistable}
    tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    texe.run(ts, scope=tscope)
    set_params_from_numpy(tscope, arrays)
    jl, tl = [], []
    for step in range(5):
        feed = _pretrain_feed_256(step)
        jl.append(float(jexe.run(jm, feed=feed, fetch_list=jfetch,
                                 scope=jscope)[0][0]))
        tl.append(float(texe.run(tm, feed=feed, fetch_list=tfetch,
                                 scope=tscope)[0][0]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    k_bias = {f"fc_{6 * i + 1}.b_0" for i in range(CFG["layers"])}
    for name in arrays:
        want = np.asarray(jscope.find_var(name).get_tensor())
        got = tscope.find_var(name).value().array.numpy()
        atol = 2 * lr * 5 if name in k_bias else 1e-5
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=name)


def test_attention_dropout_grads_use_the_forward_seed():
    """The ``_fwd_idx`` rule. The attention's grad op re-runs the forward
    under autograd; it must draw the forward's dropout seed, or the
    backward regenerates another mask and training is silently wrong. The
    executor's Out and grads must equal a direct autograd of
    ``flash_attention`` with the seed of the forward op's key, and differ
    from those of any other seed."""
    h, d, bsz, s = 2, 8, 2, 16
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        q, k, v = (tfluid.data(n, [s, h * d], stop_gradient=False)
                   for n in "qkv")
        mask = tfluid.data("mask", [s])
        ctx = tbert.fused_multihead_attention(
            q, k, v, h, dropout_rate=0.1,
            attn_bias=tbert.padding_attn_bias(mask))
        loss = tfluid.layers.mean(tfluid.layers.square(ctx))
        tfluid.append_backward(loss)
    main.random_seed = 77
    ops = main.global_block().ops
    fwd_idx = [op.type for op in ops].index("fused_attention_qkv")
    grad_op = ops[[op.type for op in ops].index("fused_attention_qkv_grad")]
    assert grad_op.attrs["_fwd_idx"] == fwd_idx
    r = _r(12)
    feed = {n: _f32(r, bsz, s, h * d) for n in "qkv"}
    feed["mask"] = np.ones((bsz, s), np.float32)
    feed["mask"][1, 9:] = 0.0
    exe = tfluid.Executor(tfluid.CPUPlace())
    out, gq, gk, gv = exe.run(main, feed=feed,
                              fetch_list=[ctx, "q@GRAD", "k@GRAD", "v@GRAD"],
                              scope=tfluid.Scope())

    def direct(idx):
        """Out and grads with the seed op ``idx`` would draw in step 0."""
        step_key = trng.step_key(77, torch.zeros(1, dtype=torch.int64))
        seed = trng.attention_seed(trng.op_keys(
            step_key, trng.hashed_indices([idx], "cpu")))
        tq, tk, tv = (torch.from_numpy(feed[n]).reshape(bsz, s, h, d)
                      .permute(0, 2, 1, 3).contiguous().requires_grad_()
                      for n in "qkv")
        bias = torch.from_numpy((1.0 - feed["mask"]) * -1e9)
        o = tfa.flash_attention(tq, tk, tv, d ** -0.5, dropout_rate=0.1,
                                dropout_seed=seed, bias=bias)
        o = o.permute(0, 2, 1, 3).reshape(bsz, s, h * d)
        grads = torch.autograd.grad(torch.mean(torch.square(o)), (tq, tk, tv))
        return [o.detach().numpy()] + [
            g.permute(0, 2, 1, 3).reshape(bsz, s, h * d).numpy()
            for g in grads]

    got = [out, gq, gk, gv]
    for g, w in zip(got, direct(fwd_idx)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    wrong = direct(ops.index(grad_op))  # the grad op's own index
    assert not np.allclose(gq, wrong[1], rtol=1e-3, atol=1e-4)
