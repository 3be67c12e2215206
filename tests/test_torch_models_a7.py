"""The op library's first model batch on paddle_tpu_torch against the TPU
package, on the CPU (models/se_resnext.py, book_extra.py's VGG and SRL
tagger, word2vec.py, ptb_lm.py; fluid/nets.py glu; AMP on ResNet):

- each build function gives the TPU package's op list and parameters
  (names and shapes) at the widths its card phase runs, uncut (SE-ResNeXt-50 at
  224x224, VGG16, the PTB "large" LM, the N-gram and skip-gram LMs at the
  book's dict 2048, the SRL tagger at label_semantic_roles' 44,068 words
  and 59 labels);
- each of the five programs trains 2 steps in both packages from the
  port's startup parameters (``_to_jax_scope``), at small sizes:
  SE-ResNeXt-50 at 32x32, 10 classes, batch 4, Nesterov Momentum 0.01
  (at lr 0.1 and batch 2 both packages diverge, ROADMAP C); VGG at
  depth "small"; the PTB LM at hidden 32, 2 layers, 8 steps; the N-gram
  LM; the skip-gram LM under nce (the TPU kernel's draw replaced, inside
  the test only, by the port's SampleLabels of the same step through
  pytest's monkeypatch on jax.random.randint) and under hsigmoid; the
  SRL tagger on ragged LoD batches with a length-1 sentence, its decode
  exactly. Dropout 0 (SE-ResNeXt's classifier dropout set to 0 in both
  programs). Losses at rtol 1e-4, atol 1e-5 (tests/test_torch_book_lod.py's
  tolerance); the port's compiled runs bitwise its interpreter's;
- AMP: a decorated ResNet-18 (32x32, batch 16) in both packages, 2
  Momentum steps, the losses within 2e-2 relative (bf16 products, as
  tests/test_torch_amp.py holds BERT), the first step's grads within
  twice the TPU package's own bf16 error of its AMP grads; compiled
  bitwise interpreted;
- the PTB LM at the large configuration's SGD 1.0 and clip 10, vocab
  10,000, hidden 400: 10 steps on one batch, every loss at 1e-4;
- SE-ResNeXt-50 and AMP ResNet-18 compare each step from the same state
  (the second from the TPU package's state after the first): a ReLU
  kink that rounding flips parts the trajectories within a step
  (SE-ResNeXt's first-step grads differ by ~1e-2 relative L2 in its last
  stage, whose batch norm sees 4 values a channel at 32x32); SE-ResNeXt's
  first-step grads are held in relative L2 (5e-2, chip_smoke.py's
  KINK_L2_TOL);
- nets.glu against the TPU package's on the same input.
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid.contrib import mixed_precision as jmp
from paddle_tpu.models import book_extra as jbook
from paddle_tpu.models import ptb_lm as jptb
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import se_resnext as jse
from paddle_tpu.models import word2vec as jw2v
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import book_extra as tbook
from paddle_tpu_torch.models import ptb_lm as tptb
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import se_resnext as tse
from paddle_tpu_torch.models import word2vec as tw2v

RTOL, ATOL = 1e-4, 1e-5
AMP_LOSS_RTOL = 2e-2
AMP_GRAD_NOISE_X = 2.0
KINK_L2_TOL = 5e-2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the bitwise checks here must not see a CPU
    product split differently between two calls."""
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


def _build(jbuild, tbuild, **kw):
    with jfluid.unique_name.guard():
        j = jbuild(**kw)
    with tfluid.unique_name.guard():
        t = tbuild(**kw)
    return j, t


def _no_dropout(*programs):
    for p in programs:
        for op in p.global_block().ops:
            if op.type == "dropout":
                op._set_attr("dropout_prob", 0.0)


def _persistables(program):
    return sorted(v.name for v in program.global_block().vars.values()
                  if v.persistable)


def _jax_values(jscope, names, tscope):
    """The TPU package's values of ``names`` in the port's dtypes."""
    return {n: np.asarray(jscope.find_var(n).get_tensor().array).astype(
        tscope.find_var(n).value().array.numpy().dtype)
        for n in names if tscope.find_var(n) is not None
        and jscope.find_var(n) is not None}


def _start_alike(jmain, jstart, tstart):
    """The port's startup runs, and the TPU package's scope takes its
    values (``_to_jax_scope``). → (jexe, jscope, texe, tscope, iscope):
    iscope a copy of tscope for the port's interpreter."""
    jexe, jscope = jfluid.Executor(), jcore.Scope()
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    names = _persistables(jmain)
    texe.run(tstart, scope=tscope)
    _to_jax_scope(tscope, names, jscope)
    iscope = tfluid.Scope()
    for n in names + ["@RNG_COUNTER@"]:
        v = tscope.find_var(n)
        if v is not None and v.is_initialized():
            iscope.var(n).set_value(tfluid.LoDTensor(
                v.value().array.clone()))
    return jexe, jscope, texe, tscope, iscope


def _to_jax_scope(tscope, names, jscope):
    """The port's values of ``names`` into the TPU package's scope, put
    on its CPU device. Both packages then start from one state without
    the TPU package's startup program, which XLA compiles on its own (9 s
    for SE-ResNeXt-50), and its step compiles once: arrays put on a
    device carry their sharding, where a startup's results carry none
    and make the second step compile again."""
    for n in names:
        v = tscope.find_var(n)
        if v is not None and v.is_initialized():
            jscope.var(n).get_tensor().set(v.value().numpy(),
                                           jfluid.CPUPlace())


def _t_feed(feed):
    return {k: (tfluid.LoDTensor(torch.from_numpy(v[0]), [v[1]])
                if isinstance(v, tuple) else v) for k, v in feed.items()}


def _j_feed(feed):
    return {k: (jcore.LoDTensor(v[0], lod=[v[1]])
                if isinstance(v, tuple) else v) for k, v in feed.items()}


def _train_both(j, t, feeds, fetch_idx=(3,), before_jax=None,
                resync=False):
    """``len(feeds)`` steps of the two programs (build results ``j`` and
    ``t``; fetches at ``fetch_idx`` of them) from the same parameters:
    the TPU package, the port compiled and the port interpreted. The
    port's compiled fetches bitwise its interpreted ones. ``before_jax(i,
    fetched)`` runs between the port's step i and the TPU package's.
    ``resync``: each step after the first starts the port from the TPU
    package's persistables (a net whose ReLU kinks flip under rounding
    parts from the reference within a step; its steps compare alone). →
    (TPU package fetches, port fetches) a step, as numpy lists."""
    jmain, jstart, tmain, tstart = j[0], j[1], t[0], t[1]
    jfetch = [j[i] for i in fetch_idx]
    tfetch = [t[i] for i in fetch_idx]
    jexe, jscope, texe, tscope, iscope = _start_alike(jmain, jstart, tstart)
    jout, tout = [], []
    for i, feed in enumerate(feeds):
        if resync and i:
            vals = _jax_values(jscope, _persistables(jmain), tscope)
            set_params_from_numpy(tscope, vals)
            set_params_from_numpy(iscope, vals)
        tf = texe.run(tmain, feed=_t_feed(feed), fetch_list=tfetch,
                      scope=tscope)
        assert texe._last_run_mode == "compiled"
        tcore.set_flag("FLAGS_executor_mode", "interpreted")
        try:
            itf = texe.run(tmain, feed=_t_feed(feed), fetch_list=tfetch,
                           scope=iscope)
        finally:
            tcore.set_flag("FLAGS_executor_mode", "compiled")
        for a, b in zip(tf, itf):
            assert np.array_equal(a, b), "compiled vs interpreted"
        if before_jax is not None:
            before_jax(i, tf)
        with jfluid.scope_guard(jscope):
            jf = jexe.run(jmain, feed=_j_feed(feed), fetch_list=jfetch)
        jout.append([np.asarray(v) for v in jf])
        tout.append([np.asarray(v) for v in tf])
    for n in _persistables(tmain):
        a = tscope.find_var(n).value().array
        assert torch.equal(a, iscope.find_var(n).value().array), n
    return jout, tout


def _losses_agree(jout, tout, k=0, rtol=RTOL, atol=ATOL):
    jl = np.array([np.asarray(s[k]).reshape(-1)[0] for s in jout])
    tl = np.array([np.asarray(s[k]).reshape(-1)[0] for s in tout])
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    return tl


# ------------------------------------------------------------ programs
FULL = [
    ("se_resnext50", jse.build_se_resnext_train_program,
     tse.build_se_resnext_train_program,
     dict(class_dim=1000, image_size=224, lr=0.0125)),
    ("vgg16", jbook.build_vgg_cifar, tbook.build_vgg_cifar,
     dict(depth="16")),
    ("ptb_large", jptb.build_ptb_lm_program, tptb.build_ptb_lm_program,
     dict(vocab_size=10000, hidden_size=1500, num_layers=2, num_steps=35,
          init_scale=0.04, max_grad_norm=10.0)),
    ("ngram", jw2v.build_ngram_lm_program, tw2v.build_ngram_lm_program,
     dict(dict_size=2048, emb_dim=32, hid_dim=256, window=4)),
    ("skipgram_nce", jw2v.build_skipgram_program,
     tw2v.build_skipgram_program, dict(dict_size=2048, emb_dim=32,
                                       neg_num=5, loss_type="nce")),
    ("skipgram_hsigmoid", jw2v.build_skipgram_program,
     tw2v.build_skipgram_program, dict(dict_size=2048, emb_dim=32,
                                       loss_type="hsigmoid")),
    ("srl", jbook.build_srl_crf_program, tbook.build_srl_crf_program,
     dict(word_dict_len=44068, label_dict_len=59, emb=32, hidden=512)),
]


@pytest.mark.parametrize("name,jb,tb,kw", FULL, ids=[f[0] for f in FULL])
def test_programs_equal_the_tpu_package_at_full_width(name, jb, tb, kw):
    j, t = _build(jb, tb, **kw)
    assert [op.type for op in t[0].global_block().ops] == \
        [op.type for op in j[0].global_block().ops
         if op.type not in ("feed", "fetch")]

    def params(p):
        return sorted((v.name, tuple(v.shape))
                      for v in p.global_block().vars.values()
                      if v.persistable)
    assert params(t[0]) == params(j[0])


def _images(rng, bs, size, classes):
    return {"image": rng.normal(size=(bs, 3, size, size)).astype(
        np.float32), "label": rng.randint(0, classes, (bs, 1)).astype(
            np.int64)}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_se_resnext50_two_steps():
    """Step 1's loss at RTOL, every parameter's grad within KINK_L2_TOL
    relative L2 (chip_smoke.py's for conv nets: rounding moves a ReLU
    kink, ~1e-2 measured in the last stage, where batch norm sees 4
    values a channel), then step 2 from the TPU package's state after
    step 1 (resync), its loss at RTOL. Nesterov Momentum at 0.01: the
    reference's loss falls on a fixed batch (3.29 → 2.81 → 2.39 at lr
    1e-3 measured, and faster at 0.01)."""
    j, t = _build(jse.build_se_resnext_train_program,
                  tse.build_se_resnext_train_program,
                  class_dim=10, image_size=32, lr=0.01)
    _no_dropout(j[0], t[0])
    grads = [p.name + "@GRAD" for p in t[0].all_parameters()
             if j[0].global_block().has_var(p.name + "@GRAD")]
    assert len(grads) == len(t[0].all_parameters()) - 106  # BN means/vars
    j = j[:4] + tuple(j[0].global_block().var(g) for g in grads)
    t = t[:4] + tuple(t[0].global_block().var(g) for g in grads)
    rng = np.random.RandomState(0)
    feeds = [_images(rng, 4, 32, 10) for _ in range(2)]
    jout, tout = _train_both(j, t, feeds, resync=True,
                             fetch_idx=tuple(range(3, 4 + len(grads))))
    _losses_agree(jout, tout)
    for k, g in enumerate(grads):
        assert _rel_l2(tout[0][k + 1], jout[0][k + 1]) <= KINK_L2_TOL, g


def test_vgg_small_two_steps():
    j, t = _build(jbook.build_vgg_cifar, tbook.build_vgg_cifar)
    rng = np.random.RandomState(1)
    feeds = [{"img": rng.normal(size=(4, 3, 32, 32)).astype(np.float32),
              "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
             for _ in range(2)]
    jout, tout = _train_both(j, t, feeds, fetch_idx=(3, 4))
    _losses_agree(jout, tout)


def test_ptb_lm_two_steps():
    kw = dict(vocab_size=50, hidden_size=32, num_layers=2, num_steps=8)
    j, t = _build(jptb.build_ptb_lm_program, tptb.build_ptb_lm_program,
                  **kw)
    rng = np.random.RandomState(2)
    feeds = [{"x": rng.randint(0, 50, (3, 8)).astype(np.int64),
              "y": rng.randint(0, 50, (3, 8, 1)).astype(np.int64)}
             for _ in range(2)]
    jout, tout = _train_both(j, t, feeds, fetch_idx=(3, 4, 5))
    _losses_agree(jout, tout)
    for k in (1, 2):  # last_h, last_c
        for js, ts in zip(jout, tout):
            assert ts[k].shape == (2, 3, 32)
            np.testing.assert_allclose(ts[k], js[k], rtol=RTOL, atol=ATOL)


def test_ptb_lm_ten_steps_at_sgd_1():
    """The large configuration's optimizer (SGD 1.0, global-norm clip 10,
    init scale 0.04) at the published vocabulary and 35 steps, hidden
    400, batch 20, without dropout, 10 steps on one repeated batch: the
    port's losses within RTOL of the TPU package's at every step, and
    the TPU package's own loss rises within the 10 steps (the updates
    overshoot on a repeated batch; chip_smoke.py's phase 20 (c) gates
    the card's 10 losses on the CPU port's for this reason)."""
    kw = dict(vocab_size=10000, hidden_size=400, num_layers=2,
              num_steps=35, init_scale=0.04, lr=1.0, max_grad_norm=10.0)
    j, t = _build(jptb.build_ptb_lm_program, tptb.build_ptb_lm_program,
                  **kw)
    rng = np.random.RandomState(22)
    feed = {"x": rng.randint(0, 10000, (20, 35)).astype(np.int64),
            "y": rng.randint(0, 10000, (20, 35, 1)).astype(np.int64)}
    jout, tout = _train_both(j, t, [feed] * 10)
    _losses_agree(jout, tout)
    jl = [float(s[0].reshape(-1)[0]) for s in jout]
    assert jl[-1] < jl[0]
    assert any(b > a for a, b in zip(jl, jl[1:])), jl


def test_ngram_lm_two_steps():
    j, t = _build(jw2v.build_ngram_lm_program, tw2v.build_ngram_lm_program,
                  dict_size=64, emb_dim=8, hid_dim=16, window=4, lr=0.5)
    rng = np.random.RandomState(3)
    feeds = [{**{f"word_{i}": rng.randint(0, 64, (8, 1)).astype(np.int64)
                 for i in range(4)},
              "target": rng.randint(0, 64, (8, 1)).astype(np.int64)}
             for _ in range(2)]
    jout, tout = _train_both(j, t, feeds)
    _losses_agree(jout, tout)


def _skipgram_feeds(seed, n=2, bs=8, vocab=64):
    rng = np.random.RandomState(seed)
    return [{"center": rng.randint(0, vocab, (bs, 1)).astype(np.int64),
             "context": rng.randint(0, vocab, (bs, 1)).astype(np.int64)}
            for _ in range(n)]


def _sample_labels(built):
    nce = [op for op in built[0].global_block().ops if op.type == "nce"][0]
    return built[:4] + (built[0].global_block().var(
        nce.output("SampleLabels")[0]),)


def test_skipgram_nce_two_steps(monkeypatch):
    """The TPU kernel draws its negatives with jax.random.randint; here
    that draw returns the port's SampleLabels of the same step, so Cost
    compares on the same negatives. The TPU package runs interpreted, so
    the draw happens at every step."""
    j, t = _build(jw2v.build_skipgram_program, tw2v.build_skipgram_program,
                  dict_size=64, emb_dim=8, neg_num=5, lr=0.5,
                  loss_type="nce")
    j, t = _sample_labels(j), _sample_labels(t)
    drawn = {}

    def port_draw(key, shape, minval, maxval, *a, **k):
        want = drawn["labels"]
        assert tuple(shape) == want.shape and (minval, maxval) == (0, 64)
        return jax.numpy.asarray(want.astype(np.int32))

    def keep(i, fetched):
        drawn["labels"] = np.asarray(fetched[1])
    monkeypatch.setattr(jax.random, "randint", port_draw)
    mode = jcore.globals_["FLAGS_executor_mode"]
    jcore.set_flag("FLAGS_executor_mode", "interpreted")
    try:
        jout, tout = _train_both(j, t, _skipgram_feeds(4),
                                 fetch_idx=(3, 4), before_jax=keep)
    finally:
        jcore.set_flag("FLAGS_executor_mode", mode)
    _losses_agree(jout, tout)
    for js, ts in zip(jout, tout):
        np.testing.assert_array_equal(ts[1], js[1])
        assert ts[1].min() >= 0 and ts[1].max() < 64


def test_skipgram_hsigmoid_two_steps():
    j, t = _build(jw2v.build_skipgram_program, tw2v.build_skipgram_program,
                  dict_size=64, emb_dim=8, lr=0.5, loss_type="hsigmoid")
    jout, tout = _train_both(j, t, _skipgram_feeds(5))
    _losses_agree(jout, tout)


def _srl_feed(rng, lens, vocab, labels):
    offs = [0] + np.cumsum(lens).tolist()
    n = offs[-1]
    return {"word": (rng.randint(0, vocab, (n, 1)).astype(np.int64), offs),
            "target": (rng.randint(0, labels, (n, 1)).astype(np.int64),
                       offs)}


def test_srl_crf_two_steps_and_decode():
    j, t = _build(jbook.build_srl_crf_program, tbook.build_srl_crf_program,
                  word_dict_len=50, label_dict_len=7, emb=8, hidden=16,
                  lr=0.1)
    rng = np.random.RandomState(6)
    feeds = [_srl_feed(rng, [3, 1, 6, 2], 50, 7),
             _srl_feed(rng, [5, 4, 1], 50, 7)]
    jout, tout = _train_both(j, t, feeds, fetch_idx=(3, 4))
    _losses_agree(jout, tout)
    for js, ts in zip(jout, tout):
        assert ts[1].shape == (sum(np.diff(feeds[0]["word"][1])), 1) \
            or ts[1].shape[0] == js[1].shape[0]
        np.testing.assert_array_equal(ts[1], js[1])


def _amp_resnet(fluid, resnet, mp):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("image", shape=[3, 32, 32], dtype="float32")
        label = fluid.data("label", shape=[1], dtype="int64")
        pred = resnet.resnet(img, 10, 18)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        mp.decorate(fluid.optimizer.Momentum(0.01, momentum=0.9)).minimize(
            loss)
    return main, startup, None, loss


def _with_grads(j, t):
    """The build results with every parameter grad both programs hold
    appended (fetched after the loss) → (j, t, grad names)."""
    grads = [p.name + "@GRAD" for p in t[0].all_parameters()
             if j[0].global_block().has_var(p.name + "@GRAD")
             and t[0].global_block().has_var(p.name + "@GRAD")]
    return (j[:4] + tuple(j[0].global_block().var(g) for g in grads),
            t[:4] + tuple(t[0].global_block().var(g) for g in grads), grads)


class _NoDecorate:
    @staticmethod
    def decorate(opt):
        return opt


def test_amp_resnet18_two_steps():
    """Each of 2 steps at batch 16 from the TPU package's state (resync:
    bf16 products move ReLU kinks, and the trajectories part; at batch 4
    the last stage's batch norm, over 4 values a channel, parts even
    single steps by 3e-2), the losses within AMP_LOSS_RTOL (measured:
    7.3e-3 and 2.5e-3). The first step's grads of all 62 parameters:
    bf16 products move each grad of this net by 1e-2 to 0.45 in relative
    L2 from its f32 value in the TPU package itself (the early layers'
    grads are sums that cancel), so each of the port's AMP grads is held
    to the TPU package's AMP grad within AMP_GRAD_NOISE_X times that
    package's own bf16 error, its AMP grad against its f32 grad on the
    same step (measured: 1.39 times at most, fc_0.b_0; the port's and
    the TPU package's AMP grads are nearer each other, 0.32 over all
    parameters, than either is to the f32 grads, 0.39 and 0.37). A zero
    grad sits 1.0 from it, a wrong sign 2.0. The f32 step's grads agree
    across the packages within KINK_L2_TOL."""
    j, t, grads = _with_grads(_amp_resnet(jfluid, jresnet, jmp),
                              _amp_resnet(tfluid, tresnet, tmp))
    assert len(grads) == 62
    assert [op.type for op in t[0].global_block().ops] == \
        [op.type for op in j[0].global_block().ops
         if op.type not in ("feed", "fetch")]
    assert sum(op.type == "cast" for op in t[0].global_block().ops) > 20
    rng = np.random.RandomState(7)
    feeds = [_images(rng, 16, 32, 10) for _ in range(2)]
    fetch_idx = tuple(range(3, 4 + len(grads)))
    jout, tout = _train_both(j, t, feeds, resync=True, fetch_idx=fetch_idx)
    _losses_agree(jout, tout, rtol=AMP_LOSS_RTOL, atol=0)
    jf, tf, _ = _with_grads(_amp_resnet(jfluid, jresnet, _NoDecorate),
                            _amp_resnet(tfluid, tresnet, _NoDecorate))
    jf32, tf32 = _train_both(jf, tf, feeds[:1], fetch_idx=fetch_idx)
    for k, g in enumerate(grads, 1):
        assert _rel_l2(tf32[0][k], jf32[0][k]) <= KINK_L2_TOL, g
        own = _rel_l2(jout[0][k], jf32[0][k])
        assert _rel_l2(tout[0][k], jout[0][k]) <= AMP_GRAD_NOISE_X * own, g


def test_glu_matches_the_tpu_package():
    from paddle_tpu.fluid import nets as jnets
    from paddle_tpu_torch.fluid import nets as tnets
    x = np.random.RandomState(8).normal(size=(3, 8)).astype(np.float32)
    outs = []
    for fluid, nets in ((jfluid, jnets), (tfluid, tnets)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            v = fluid.data("x", shape=[8], dtype="float32")
            y = nets.glu(v, dim=-1)
        assert [op.type for op in main.global_block().ops
                if op.type not in ("feed", "fetch")] == \
            ["split", "sigmoid", "elementwise_mul"]
        exe = fluid.Executor(fluid.CPUPlace())
        outs.append(np.asarray(exe.run(main, feed={"x": x},
                                       fetch_list=[y])[0]))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)
    a, b = x[:, :4], x[:, 4:]
    np.testing.assert_allclose(outs[1], a / (1 + np.exp(-b)), rtol=1e-6)


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_20", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phase_20_rehearsed(monkeypatch):
    """phase_models on the CPU at small sizes (SE-ResNeXt-50 and
    ResNet-50 at 64x64, batch 2; VGG16 at batch 4; the PTB LM at hidden
    32; word2vec at dict 64; the SRL tagger at 100 words, 9 tags and 4
    sentences): every comparison it makes on the card, each run's kind
    as a card run's (eager, capture, replays), no kernel to count."""
    cs = _chip_smoke()
    zeros = cs.NO_KERNELS
    monkeypatch.setattr(tfluid, "CUDAPlace", lambda i=0: tfluid.CPUPlace())
    for name, value in (("MD_SE_BATCH", 2), ("MD_SE_CLASSES", 10),
                        ("MD_IMAGE", 64), ("MD_VGG_BATCH", 4),
                        ("MD_PTB", dict(cs.MD_PTB, vocab_size=50,
                                        hidden_size=32, num_steps=8)),
                        ("MD_PTB_BATCH", 3), ("MD_W2V_DICT", 64),
                        ("MD_NGRAM_HID", 16), ("MD_W2V_BATCH", 8),
                        ("MD_SRL", dict(word_dict_len=100, label_dict_len=9,
                                        emb=8, hidden=16)),
                        ("MD_SRL_BATCH", 4), ("MD_AMP_BATCH", 2),
                        ("MD_STEPS", 5)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_step_want", lambda *a, **k: (0, 0, 0, 0, 1)
                        + (0,) * 7)
    monkeypatch.setattr(cs, "_launch_counts", lambda: zeros)
    monkeypatch.setattr(cs, "_device_kernel_counts",
                        lambda fn, **k: (fn(), zeros)[1])
    monkeypatch.setattr(cs, "_check_trace", lambda *a: None)
    monkeypatch.setattr(cs, "_card_line", lambda: "CPU")
    clone = cs._clone_scope
    monkeypatch.setattr(cs, "_clone_scope",
                        lambda scope, names, dev: clone(scope, names, "cpu"))
    runs = {}

    def gate(exe, delta, want, what):
        assert exe._last_run_mode == "compiled", what
        # the block is held, so that a later block cannot take its id
        seen = runs.setdefault(id(exe._last_block), [exe._last_block, 0])
        seen[1] += 1
        n = seen[1]
        return ("eager", "capture")[n - 1] if n <= 2 else "replay"
    monkeypatch.setattr(cs, "_gate_run", gate)
    monkeypatch.setattr(cs, "_interpreted", lambda iexe, main, feed, fetch,
                        scope, want, book, what: _interp(iexe, main, feed,
                                                         fetch, scope))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    lines = []
    monkeypatch.setattr(cs, "_log", lambda *a: lines.append(" ".join(
        str(x) for x in a)))
    out = cs.phase_models(121.0)
    text = "\n".join(lines)
    assert "FAIL" not in text and "DIFFERS" not in text
    for want in ("(a) SE-ResNeXt-50 batch 2 f32: 5 steps",
                 "(b) VGG16 batch 4", "(c) PTB LSTM LM large batch 3",
                 "(d) skip-gram nce", "(d) skip-gram hsigmoid",
                 "(e) SRL tagger, the Viterbi decode", "fetch 1 (",
                 "AMP on ResNet-50 batch 2", "groups [1, 32]"):
        assert want in text, want
    assert set(out) >= {"se_resnext", "vgg16", "ptb", "word2vec", "srl",
                        "amp", "wrapper", "executed"}


def _interp(iexe, main, feed, fetch, scope):
    mode = tcore.globals_["FLAGS_executor_mode"]
    tcore.set_flag("FLAGS_executor_mode", "interpreted")
    try:
        return iexe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    finally:
        tcore.set_flag("FLAGS_executor_mode", mode)
