"""The book's LoD models on paddle_tpu_torch against the TPU package, on the
CPU (models/book_extra.py, fluid/nets.py):

- understand_sentiment's conv net (emb 32, hid 32, 2 classes, the
  5147-word vocabulary) on ragged word batches made from a seed the way
  paddle_tpu/dataset/imdb.py's synthetic reader makes them: 5 Adagrad
  steps from the TPU package's startup values, the losses, accuracies and
  every persistable at rtol 1e-4, atol 1e-5; the port's compiled plans
  bitwise its interpreter's, each new LoD a new plan;
- the recommender: 5 Adam steps the same way, its two LoD slots pooled by
  sequence_pool("sum") and the towers joined by cos_sim;
- fit_a_line, and the programs' op types and parameters alike;
- nets.simple_img_conv_pool and nets.img_conv_group build the TPU
  package's ops.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.models import book_extra as jbook
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import book_extra as tbook

RTOL, ATOL = 1e-4, 1e-5
VOCAB = 5147  # paddle_tpu/dataset/imdb.py:13


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


def sentiment_batch(rng, batch):
    """(flat word ids [T, 1], offsets, labels [batch, 1]) the way the
    synthetic IMDB reader draws a review: 8-119 base ids and length // 6
    marker ids from the label's half of 10..109, shuffled."""
    seqs, labels = [], []
    for _ in range(batch):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(8, 120))
        base = rng.randint(0, VOCAB, size=length)
        marker = rng.choice(np.arange(10, 60) if label == 0
                            else np.arange(60, 110), size=max(2, length // 6))
        ids = np.concatenate([base, marker])
        rng.shuffle(ids)
        seqs.append(ids)
        labels.append(label)
    offs = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    return (np.concatenate(seqs).reshape(-1, 1).astype(np.int64),
            [int(o) for o in offs], np.array(labels, np.int64).reshape(-1, 1))


def _both_programs(build, *a, **kw):
    with jfluid.unique_name.guard():
        j = build[0](*a, **kw)
    with tfluid.unique_name.guard():
        t = build[1](*a, **kw)
    return j, t


def _start_alike(jmain, jstart, tstart):
    """Both startups run, the port's scope given the TPU package's values.
    → (jexe, jscope, texe, tscope, persistable names)."""
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
        for n in names if tscope.find_var(n) is not None})
    return jexe, jscope, texe, tscope, names


def _copy_scope(src, names):
    dst = tfluid.Scope()
    for n in names + ["@RNG_COUNTER@"]:
        v = src.find_var(n)
        if v is not None and v.is_initialized():
            dst.var(n).set_value(tfluid.LoDTensor(v.value().array.clone()))
    return dst


def test_sentiment_five_steps_against_the_tpu_package():
    (jmain, jstart, _, jloss, jacc), (tmain, tstart, _, tloss, tacc) = \
        _both_programs((jbook.build_sentiment_program,
                        tbook.build_sentiment_program), VOCAB)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops
         if op.type not in ("feed", "fetch")]
    jexe, jscope, texe, tscope, names = _start_alike(jmain, jstart, tstart)
    iscope = _copy_scope(tscope, names)
    rng = np.random.RandomState(0)
    jl, tl, il = [], [], []
    for _ in range(5):
        words, offs, label = sentiment_batch(rng, 8)
        with jfluid.scope_guard(jscope):
            jl.append(jexe.run(jmain, feed={
                "words": jcore.LoDTensor(words, lod=[offs]),
                "label": label}, fetch_list=[jloss, jacc]))
        feed = {"words": tfluid.LoDTensor(torch.from_numpy(words), [offs]),
                "label": label}
        tl.append(texe.run(tmain, feed=feed, fetch_list=[tloss, tacc],
                           scope=tscope))
        assert texe._last_run_mode == "compiled"
        tcore.set_flag("FLAGS_executor_mode", "interpreted")
        try:
            il.append(texe.run(tmain, feed=feed, fetch_list=[tloss, tacc],
                               scope=iscope))
        finally:
            tcore.set_flag("FLAGS_executor_mode", "compiled")
    for (l, a), (jlv, jav), (ilv, iav) in zip(tl, jl, il):
        np.testing.assert_allclose(l, np.asarray(jlv), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a, np.asarray(jav), rtol=RTOL, atol=ATOL)
        assert np.array_equal(l, ilv) and np.array_equal(a, iav)
    for n in names:
        want = np.asarray(jscope.find_var(n).get_tensor().array)
        got = tscope.find_var(n).value().array
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=n)
        assert torch.equal(got, iscope.find_var(n).value().array), n
    # a plan a LoD: five ragged batches, five plans, none captured
    lod_plans = [k for k in texe._compiled_cache if k[-1]]
    assert len(lod_plans) == 4  # Executor._LOD_PLANS_KEPT of the 5


def _movie_batch(rng, batch, n_users=50, n_movies=40):
    def ids(hi):
        return rng.randint(0, hi, (batch, 1)).astype(np.int64)

    def ragged(hi, lo_len, hi_len):
        lens = rng.randint(lo_len, hi_len, batch)
        offs = [int(o) for o in np.concatenate([[0], np.cumsum(lens)])]
        return rng.randint(0, hi, (offs[-1], 1)).astype(np.int64), offs
    cats, coffs = ragged(18, 1, 4)
    title, toffs = ragged(1000, 0, 6)  # an empty title now and then
    return {"user_id": ids(n_users + 1), "gender_id": ids(2),
            "age_id": ids(7), "job_id": ids(21),
            "movie_id": ids(n_movies + 1), "category_id": (cats, coffs),
            "movie_title": (title, toffs),
            "score": rng.uniform(1, 5, (batch, 1)).astype(np.float32)}


def test_recommender_five_steps_against_the_tpu_package():
    (jmain, jstart, _, jloss), (tmain, tstart, _, tloss) = \
        _both_programs((jbook.build_recommender_program,
                        tbook.build_recommender_program), 50, 40)
    jexe, jscope, texe, tscope, names = _start_alike(jmain, jstart, tstart)
    rng = np.random.RandomState(1)
    for _ in range(5):
        b = _movie_batch(rng, 16)
        jf, tf = {}, {}
        for k, v in b.items():
            if isinstance(v, tuple):
                jf[k] = jcore.LoDTensor(v[0], lod=[v[1]])
                tf[k] = tfluid.LoDTensor(torch.from_numpy(v[0]), [v[1]])
            else:
                jf[k] = tf[k] = v
        with jfluid.scope_guard(jscope):
            (jl,) = jexe.run(jmain, feed=jf, fetch_list=[jloss])
        (tl,) = texe.run(tmain, feed=tf, fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=RTOL, atol=ATOL)
    for n in names:
        np.testing.assert_allclose(
            tscope.find_var(n).value().array.numpy(),
            np.asarray(jscope.find_var(n).get_tensor().array), rtol=RTOL,
            atol=ATOL, err_msg=n)


def test_fit_a_line_against_the_tpu_package():
    (jmain, jstart, _, jloss), (tmain, tstart, _, tloss) = _both_programs(
        (jbook.build_fit_a_line, tbook.build_fit_a_line))
    jexe, jscope, texe, tscope, names = _start_alike(jmain, jstart, tstart)
    rng = np.random.RandomState(2)
    for _ in range(3):
        f = {"x": rng.rand(16, 13).astype(np.float32),
             "y": rng.rand(16, 1).astype(np.float32)}
        with jfluid.scope_guard(jscope):
            (jl,) = jexe.run(jmain, feed=f, fetch_list=[jloss])
        (tl,) = texe.run(tmain, feed=f, fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("net", ["simple_img_conv_pool", "img_conv_group"])
def test_nets_build_the_tpu_packages_ops(net):
    def build(fluid):
        main = fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main, fluid.Program()):
            img = fluid.data("img", shape=[3, 16, 16], dtype="float32")
            if net == "simple_img_conv_pool":
                out = fluid.nets.simple_img_conv_pool(
                    img, num_filters=4, filter_size=3, pool_size=2,
                    pool_stride=2, act="relu")
            else:
                out = fluid.nets.img_conv_group(
                    img, conv_num_filter=[4, 4], pool_size=2, pool_stride=2,
                    conv_act="relu", conv_with_batchnorm=True,
                    conv_batchnorm_drop_rate=0.1)
        return main, out
    (jm, jo), (tm, to) = build(jfluid), build(tfluid)
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    assert tuple(to.shape) == tuple(jo.shape)
