"""The fused LSTM, NCE, hierarchical sigmoid and the linear-chain CRF of
paddle_tpu_torch against the TPU package's kernels, on the CPU
(ops/rnn_ops.py, ops/loss_extra_ops.py; the TPU package's
paddle_tpu/ops/rnn_ops.py:270, :283 and loss_extra_ops.py:203, :256,
:291, :340):

- lstm, unidirectional and bidirectional, 1 and 2 layers, dropout 0:
  Out, LastH, LastC and the generic grads of Input, W, InitH and InitC
  at rtol 1e-5, atol 1e-6 (the port's op tests' tolerance), and
  tests/test_rnn_ops.py::test_lstm_dense_multilayer_shapes' case;
  dropout between layers only when is_test is false; lstm_unit;
- nce: Cost, SampleLogits and the grads of Input, Weight and Bias
  against the TPU kernel with its draw (jax.random.randint) replaced,
  inside the test only, by the port's SampleLabels; the draw itself by
  distribution;
- hierarchical_sigmoid with and without a bias, num_classes a power of
  two or not, forward and grads;
- linear_chain_crf over ragged LoD batches with a length-1 sequence: the
  log-likelihood and the grads of Emission and Transition; crf_decoding
  exactly, alone and against a Label; both with K = 59 tags as the SRL
  tagger has them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad
from tests.test_torch_vision_ops import _jitted

RTOL, ATOL = 1e-5, 1e-6
KEY = 4242


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).normal(size=shape)
            * scale).astype(np.float32)


def _kernels(op_type, ins, attrs, lods=None):
    """Both kernels on numpy ``ins``, the TPU package's compiled by XLA as
    its compiled step runs it (``_jitted``). → (port ins, port attrs,
    port outs, TPU ins, TPU attrs, TPU outs)."""
    tattrs = dict(TOPS.get(op_type).attr_defaults, **attrs)
    jattrs = dict(JOPS.get(op_type).attr_defaults, **attrs)
    if lods is not None:
        tattrs["_lod"] = jattrs["_lod"] = lods
    if TOPS.get(op_type).needs_rng:
        tattrs["_rng"] = lambda: torch.tensor([KEY], dtype=torch.int64)
        jattrs["_rng"] = jax.random.key(0)
    tins = {s: [torch.from_numpy(np.asarray(a)) for a in v]
            for s, v in ins.items()}
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    tout = TOPS.get(op_type).kernel(tins, tattrs)
    with _jitted(op_type):
        jout = JOPS.get(op_type).kernel(jins, jattrs)
    return tins, tattrs, tout, jins, jattrs, jout


def _compare(op_type, ins, attrs, lods=None, slots=None, grad_of=None,
             exact=()):
    """Outputs ``slots`` compared (``exact`` ones bitwise), then the
    generic grads of ``grad_of`` under seeded grads of the float outputs
    among ``slots``. → the port's outputs."""
    tins, tattrs, tout, jins, jattrs, jout = _kernels(op_type, ins, attrs,
                                                      lods)
    r = np.random.RandomState(11)
    for slot in slots or [s for s in jout if not s.startswith("_")]:
        t, j = tout[slot][0].detach().numpy(), np.asarray(jout[slot][0])
        assert t.shape == j.shape, (slot, t.shape, j.shape)
        if slot in exact or not np.issubdtype(j.dtype, np.floating):
            np.testing.assert_array_equal(t, j, err_msg=slot)
        else:
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL,
                                       err_msg=slot)
        if grad_of and np.issubdtype(j.dtype, np.floating):
            g = r.normal(size=j.shape).astype(np.float32)
            tins[slot + "@GRAD"] = [torch.from_numpy(g)]
            jins[slot + "@GRAD"] = [jnp.asarray(g)]
    if grad_of:
        wanted = [s + "@GRAD" for s in grad_of]
        fwd = list(ins)
        tg = t_generic_grad(op_type, tins, tattrs, wanted, fwd)
        with _jitted(op_type):
            jg = j_generic_grad(op_type, jins, jattrs, wanted, fwd)
        for s in wanted:
            np.testing.assert_allclose(tg[s][0].numpy(), np.asarray(jg[s][0]),
                                       rtol=RTOL, atol=ATOL, err_msg=s)
    return tout


# ------------------------------------------------------------------ lstm
def _lstm_inputs(B, T, D, H, L, dirs, seed=1):
    total, d_in = 0, D
    for _ in range(L):
        total += dirs * (d_in * 4 * H + H * 4 * H + 4 * H)
        d_in = H * dirs
    return {"Input": [_x((B, T, D), seed)],
            "W": [_x((total,), seed + 1, 0.3)],
            "InitH": [_x((L * dirs, B, H), seed + 2, 0.5)],
            "InitC": [_x((L * dirs, B, H), seed + 3, 0.5)]}


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidi", [False, True], ids=["uni", "bi"])
def test_lstm_forward_and_grads(layers, bidi):
    B, T, D, H = 3, 5, 4, 6
    ins = _lstm_inputs(B, T, D, H, layers, 2 if bidi else 1)
    out = _compare("lstm", ins, {"hidden_size": H, "num_layers": layers,
                                 "is_bidirec": bidi, "max_len": T,
                                 "dropout_prob": 0.0},
                   slots=("Out", "LastH", "LastC"),
                   grad_of=("Input", "W", "InitH", "InitC"))
    assert tuple(out["Out"][0].shape) == (B, T, H * (2 if bidi else 1))


def test_lstm_dense_multilayer_shapes():
    """tests/test_rnn_ops.py::test_lstm_dense_multilayer_shapes' case."""
    rng = np.random.RandomState(4)
    B, T, D, H, L = 2, 5, 3, 4, 2
    x = rng.randn(B, T, D).astype(np.float32)
    total = (D * 4 * H + H * 4 * H + 4 * H) + (H * 4 * H + H * 4 * H + 4 * H)
    w = (rng.randn(total) * 0.1).astype(np.float32)
    init = np.zeros((L, B, H), np.float32)
    out = _compare("lstm", {"Input": [x], "W": [w], "InitH": [init],
                            "InitC": [init]},
                   {"hidden_size": H, "num_layers": L, "is_bidirec": False,
                    "is_test": True, "max_len": T},
                   slots=("Out", "LastH", "LastC"))
    o, lh = out["Out"][0].numpy(), out["LastH"][0].numpy()
    assert o.shape == (B, T, H) and lh.shape == (L, B, H)
    np.testing.assert_allclose(lh[-1], o[:, -1, :], rtol=1e-5)


def test_lstm_dropout_between_layers_only_in_training():
    B, T, D, H = 4, 6, 5, 8
    ins = _lstm_inputs(B, T, D, H, 2, 1, seed=5)
    base = {"hidden_size": H, "num_layers": 2, "max_len": T}
    plain = _kernels("lstm", ins, dict(base, dropout_prob=0.0))[2]
    test = _kernels("lstm", ins, dict(base, dropout_prob=0.5,
                                      is_test=True))[2]
    train = _kernels("lstm", ins, dict(base, dropout_prob=0.5))[2]
    assert torch.equal(plain["Out"][0], test["Out"][0])
    # the first layer runs before any dropout: its last state is alike
    assert torch.equal(plain["LastH"][0][0], train["LastH"][0][0])
    assert not torch.equal(plain["Out"][0], train["Out"][0])
    one = _kernels("lstm", ins, dict(base, dropout_prob=0.5, num_layers=1))
    assert torch.equal(one[2]["Out"][0], _kernels(
        "lstm", ins, dict(base, dropout_prob=0.0, num_layers=1))[2]["Out"][0])


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit(forget_bias):
    _compare("lstm_unit", {"X": [_x((3, 16))], "C_prev": [_x((3, 4), 1)]},
             {"forget_bias": forget_bias}, grad_of=("X", "C_prev"))


# ------------------------------------------------------------------- nce
@pytest.mark.parametrize("bias", [True, False])
def test_nce_against_the_tpu_kernel_on_the_ports_draw(bias, monkeypatch):
    N, D, V, k = 6, 5, 20, 4
    ins = {"Input": [_x((N, D))],
           "Label": [np.random.RandomState(2).randint(0, V, (N, 1))],
           "Weight": [_x((V, D), 3)]}
    if bias:
        ins["Bias"] = [_x((V, 1), 4)]
    attrs = {"num_total_classes": V, "num_neg_samples": k}
    port = _kernels("nce", ins, attrs)[2]
    labels = port["SampleLabels"][0].numpy()
    assert labels.shape == (N, k)

    def port_draw(key, shape, minval, maxval, *a, **kw):
        assert tuple(shape) == (N, k) and (minval, maxval) == (0, V)
        return jnp.asarray(labels.astype(np.int32))
    monkeypatch.setattr(jax.random, "randint", port_draw)
    grad_of = ("Input", "Weight") + (("Bias",) if bias else ())
    _compare("nce", ins, attrs, slots=("Cost", "SampleLogits",
                                       "SampleLabels"), grad_of=grad_of)


def test_nce_draw_is_uniform():
    N, D, V, k = 4000, 2, 50, 5
    ins = {"Input": [_x((N, D))], "Label": [np.zeros((N, 1), np.int64)],
           "Weight": [_x((V, D), 3)]}
    lab = _kernels("nce", ins, {"num_total_classes": V,
                                "num_neg_samples": k})[2]["SampleLabels"][0]
    counts = np.bincount(lab.numpy().reshape(-1), minlength=V)
    assert counts.sum() == N * k and lab.min() >= 0 and lab.max() < V
    expect = N * k / V
    assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect))


# ---------------------------------------------------------------- hsigmoid
@pytest.mark.parametrize("classes", [6, 8, 13])
@pytest.mark.parametrize("bias", [True, False])
def test_hierarchical_sigmoid(classes, bias):
    N, D = 7, 5
    ins = {"X": [_x((N, D))], "W": [_x((classes - 1, D), 1)],
           "Label": [np.random.RandomState(2).randint(0, classes, (N, 1))]}
    if bias:
        ins["Bias"] = [_x((classes - 1, 1), 3)]
    _compare("hierarchical_sigmoid", ins, {"num_classes": classes},
             slots=("Out", "PreOut"),
             grad_of=("X", "W") + (("Bias",) if bias else ()))


# --------------------------------------------------------------------- CRF
CRF_LODS = [((0, 3, 4, 9, 11),), ((0, 1),), ((0, 6, 7, 8),)]


def _crf_inputs(lod, K, seed=0):
    n = lod[0][-1]
    rng = np.random.RandomState(seed)
    return {"Emission": [_x((n, K), seed)],
            "Transition": [_x((K + 2, K), seed + 1, 0.5)],
            "Label": [rng.randint(0, K, (n, 1)).astype(np.int64)]}


@pytest.mark.parametrize("lod,K", [(CRF_LODS[0], 5), (CRF_LODS[0], 59),
                                   (CRF_LODS[1], 59), (CRF_LODS[2], 59)],
                         ids=["ragged-5", "ragged-59", "one_token-59",
                              "ones_and_six-59"])
def test_linear_chain_crf(lod, K):
    ins = _crf_inputs(lod, K)
    lods = {"Emission": [lod], "Label": [lod], "Transition": [None]}
    _compare("linear_chain_crf", ins, {}, lods=lods,
             slots=("LogLikelihood", "Alpha", "EmissionExps",
                    "TransitionExps"),
             grad_of=("Emission", "Transition"))


@pytest.mark.parametrize("lod", CRF_LODS, ids=["ragged", "one_token",
                                               "ones_and_six"])
@pytest.mark.parametrize("with_label", [False, True])
def test_crf_decoding_exact(lod, with_label):
    ins = _crf_inputs(lod, 59, seed=3)
    if not with_label:
        ins.pop("Label")
    lods = {"Emission": [lod], "Label": [lod], "Transition": [None]}
    _, _, tout, _, _, jout = _kernels("crf_decoding", ins, {}, lods)
    np.testing.assert_array_equal(tout["ViterbiPath"][0].numpy(),
                                  np.asarray(jout["ViterbiPath"][0]))
    assert tout["_lod"] == {"ViterbiPath": [lod]}


def test_crf_decoding_is_the_viterbi_path():
    """Against brute force over every path of a short sequence."""
    import itertools
    K, n = 4, 4
    ins = _crf_inputs(((0, n),), K, seed=9)
    ins.pop("Label")
    path = _kernels("crf_decoding", ins, {},
                    {"Emission": [((0, n),)]})[2]["ViterbiPath"][0]
    em, tr = ins["Emission"][0], ins["Transition"][0]

    def score(p):
        s = tr[0, p[0]] + tr[1, p[-1]] + sum(em[i, p[i]] for i in range(n))
        return s + sum(tr[2 + p[i], p[i + 1]] for i in range(n - 1))
    best = max(itertools.product(range(K), repeat=n), key=score)
    assert path.reshape(-1).tolist() == list(best)
