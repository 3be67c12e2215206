"""The f32 flash-attention route (the forward, dQ and dK/dV on split-TF32
wgmma and TMA), on the CPU.

On the card, f32 attention at head dims up to 64 runs the f32 kernels:
``csrc/flash_attention_fwd_f32.cu`` (64 query rows a block, 64-key tiles),
then in the backward ``csrc/flash_attention_bwd_dq_f32.cu`` (128 query rows
a block, 64 a warpgroup, 32-key stages; it takes delta = rowsum(dO∘O)
itself and writes it) and ``csrc/flash_attention_bwd_dkdv_f32.cu`` (64
keys a block, 32-row query stages), which reads that delta. chip_smoke.py holds them against
``flash_attention_reference``, ``flash_attention_bwd_dq_f32_reference`` and
``flash_attention_bwd_reference``. Here those plain versions are held
against the TPU package's Pallas kernels in f32 (``_pallas_fwd``,
pallas_call :318; ``jax.vjp`` of ``flash_attention``: its backward
pallas_calls :514 and :543; ``_pallas_bwd``'s dQ, pallas_call :543, and its
delta prologue :492; through the Pallas interpreter, blocks of 64) on the
same seeded numpy inputs at the lengths that cross the kernels' tiles: 200
x 300 ragged with a key-padding bias and dropout 0.3, S = Sk = 256 causal,
and for dQ and delta also 200 x 300 causal. Tolerances: 1e-4 for O, lse,
delta and the grads (chip_smoke's F32_TOL: f32 sums in another order on
each side).

Then the route (shapes and dtype alone): f32 up to head dim 64 takes the
f32 kernels, above it the tiled forward and the split backward, bf16 its
own kernels, f16 and head dims above 128 no kernel; on tensors that claim
a CUDA device (no card: they stand in for them) those raise before any
launch. The dispatch to each wrapper, the f32 backward's order (dQ with
delta, then dK/dV on that delta) and its head-dim padding, the launch
counters, and each instance's shared memory against the 232,448 bytes a
block may have.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

F32_TOL = 1e-4
BLOCK = 64
D = 64
SEED = 2718
CSRC = os.path.join(os.path.dirname(os.path.abspath(tfa.__file__)), "csrc")
# (S, Sk, causal, bias, dropout rate): the cases held to the Pallas kernels
CASES = {"256x256 causal": (256, 256, True, False, 0.0),
         "200x300 bias dropout 0.3": (200, 300, False, True, 0.3)}


@pytest.fixture(autouse=True)
def _interpret():
    with fa.interpret_guard(), fa.block_override(BLOCK, BLOCK):
        yield


def _inputs(S, Sk, with_bias, seed):
    r = np.random.RandomState(seed)
    q, do = (r.normal(size=(2, 2, S, D)).astype(np.float32) for _ in "qo")
    k, v = (r.normal(size=(2, 2, Sk, D)).astype(np.float32) for _ in "kv")
    bias = None
    if with_bias:
        bias = np.zeros((2, Sk), np.float32)
        for b in range(2):
            bias[b, r.randint(Sk // 3, Sk):] = -1e9
    return q, k, v, do, bias


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fwd_matches_pallas_in_f32(case):
    S, Sk, causal, with_bias, rate = CASES[case]
    q, k, v, _, bias = _inputs(S, Sk, with_bias, seed=S + Sk)
    sm = 1.0 / np.sqrt(D)
    assert tfa.fwd_route((2, 2, S, D), (2, 2, Sk, D), torch.float32) == "f32"
    jo, jlse = fa._pallas_fwd(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray([SEED], jnp.int32),
        sm, causal, *fa._block_sizes(S, Sk, D), rate,
        bias=None if bias is None else jnp.asarray(bias))
    to, tlse = tfa.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), sm, causal, rate,
        torch.tensor([SEED], dtype=torch.int32),
        None if bias is None else torch.from_numpy(bias))
    assert to.dtype == torch.float32 and tuple(tlse.shape) == (4, S)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :, 0],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("where", ["one key", "every key"])
def test_plain_fwd_keeps_a_nan_bias_as_pallas(where):
    """A NaN in the key-padding bias (an input mask gone bad): Pallas
    keeps it (``jnp.maximum(bias, NEG_INF)``, a NaN row max, no dead
    row), so every row of the poisoned batch is NaN, at one key or at
    every key, and the numeric guard sees it in the loss. The plain
    version gives NaN at the same places and agrees elsewhere; the card's
    forwards are held to it (chip_smoke.py's [route] NaN lines)."""
    S = Sk = 128
    q, k, v, _, bias = _inputs(S, Sk, True, seed=77)
    if where == "one key":
        bias[0, 3] = np.nan
    else:
        bias[0] = np.nan
    sm = 1.0 / np.sqrt(D)
    jo, _ = fa._pallas_fwd(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray([SEED], jnp.int32),
        sm, False, *fa._block_sizes(S, Sk, D), 0.0, bias=jnp.asarray(bias))
    to, _ = tfa.flash_attention_fwd(
        *(torch.from_numpy(a) for a in (q, k, v)), sm, False, 0.0, None,
        torch.from_numpy(bias))
    jo, to = np.asarray(jo), to.numpy()
    assert np.isnan(jo[0]).all() and not np.isnan(jo[1]).any()
    np.testing.assert_array_equal(np.isnan(to), np.isnan(jo))
    np.testing.assert_allclose(to[1], jo[1], rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_bwd_matches_pallas_in_f32(case):
    S, Sk, causal, with_bias, rate = CASES[case]
    q, k, v, do, bias = _inputs(S, Sk, with_bias, seed=S * Sk)
    sm = 1.0 / np.sqrt(D)
    assert tfa.bwd_route((2, 2, S, D), (2, 2, Sk, D), torch.float32) == "f32"
    seed = jnp.asarray([SEED], jnp.int32) if rate else None
    jb = None if bias is None else jnp.asarray(bias)

    def f(q_, k_, v_):
        return fa.flash_attention(q_, k_, v_, sm, causal, dropout_rate=rate,
                                  dropout_seed=seed, bias=jb)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tb = None if bias is None else torch.from_numpy(bias)
    tseed = torch.tensor([SEED], dtype=torch.int32) if rate else None
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, sm, causal, rate, tseed, tb)
    got = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, sm, causal, rate,
                                  tseed, tb)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=name)


# the dQ cases: CASES and a causal ragged case with S != Sk
DQ_CASES = dict(CASES, **{"200x300 causal": (200, 300, True, False, 0.0)})


@pytest.mark.parametrize("case", sorted(DQ_CASES))
def test_plain_dq_with_delta_matches_pallas_in_f32(case):
    """flash_attention_bwd_dq_f32_reference, the f32 dQ kernel's plain
    version: its dQ against ``_pallas_bwd``'s dQ (pallas_call :543) and its
    delta against the prologue's expression (:492), on the Pallas
    forward's O and lse for both sides."""
    S, Sk, causal, with_bias, rate = DQ_CASES[case]
    q, k, v, do, bias = _inputs(S, Sk, with_bias, seed=S + 2 * Sk)
    sm = 1.0 / np.sqrt(D)
    jseed = jnp.asarray([SEED], jnp.int32)
    jb = None if bias is None else jnp.asarray(bias)
    blocks = fa._block_sizes(S, Sk, D)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jlse = fa._pallas_fwd(jq, jk, jv, jseed, sm, causal, *blocks, rate,
                              bias=jb)
    jlse = jlse[:, :, 0]
    want_dq = np.asarray(fa._pallas_bwd(jq, jk, jv, jo, jlse, jseed, jdo, sm,
                                        causal, *blocks, rate,
                                        bias=jb)[0])
    want_delta = np.asarray(jnp.sum(
        jo.reshape(4, S, D).astype(jnp.float32)
        * jdo.reshape(4, S, D).astype(jnp.float32), -1))
    tseed = torch.tensor([SEED], dtype=torch.int32) if rate else None
    dq, delta = tfa.flash_attention_bwd_dq_f32_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jlse)),
        torch.from_numpy(do), sm, causal, rate, tseed,
        None if bias is None else torch.from_numpy(bias))
    assert dq.dtype == delta.dtype == torch.float32
    assert tuple(delta.shape) == (4, S)
    np.testing.assert_allclose(dq.numpy(), want_dq, rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(delta.numpy(), want_delta, rtol=F32_TOL,
                               atol=F32_TOL)


# --------------------------------------------------------------- routes
@pytest.mark.parametrize("S,Sk,d,dtype,fwd,bwd", [
    (128, 128, 64, torch.float32, "f32", "f32"),
    (1, 1, 64, torch.float32, "f32", "f32"),
    (200, 77, 64, torch.float32, "f32", "f32"),
    (512, 512, 64, torch.float32, "f32", "f32"),
    (128, 128, 8, torch.float32, "f32", "f32"),
    (128, 128, 40, torch.float32, "f32", "f32"),
    (128, 128, 65, torch.float32, "tiled", "split"),
    (128, 128, 96, torch.float32, "tiled", "split"),
    (128, 128, 128, torch.float32, "tiled", "split"),
    (128, 128, 192, torch.float32, "tiled", "split"),
    (128, 128, 64, torch.bfloat16, "whole", "fused"),
    (256, 256, 64, torch.bfloat16, "streamed", "streamed"),
    (128, 128, 64, torch.float16, "tiled", "split"),
])
def test_f32_route_by_head_dim_and_dtype(S, Sk, d, dtype, fwd, bwd):
    q, k = (2, 12, S, d), (2, 12, Sk, d)
    assert tfa.fwd_route(q, k, dtype) == fwd
    assert tfa.bwd_route(q, k, dtype) == bwd


def test_f32_route_covers_every_length_up_to_head_dim_64():
    for S in (1, 16, 64, 77, 128, 129, 200, 256, 512, 1000):
        for Sk in (1, 64, 77, 128, 300, 512):
            for d in range(1, tfa.F32_MAX_HEAD_DIM + 1):
                q, k = (2, 3, S, d), (2, 3, Sk, d)
                assert tfa.fwd_route(q, k, torch.float32) == "f32"
                assert tfa.bwd_route(q, k, torch.float32) == "f32"


class _OnCard:
    """A CPU tensor that claims a CUDA device: the wrappers' checks read
    its device, dtype, shape and layout before any launch, so no card is
    needed to see what they refuse."""

    def __init__(self, t):
        self._t = t
        self.is_cuda = True
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._t.is_contiguous()


@pytest.mark.parametrize("d,dtype,err", [
    (192, torch.float32, ValueError), (64, torch.float16, TypeError)])
@pytest.mark.parametrize("wrapper", ["flash_attention_fwd_f32_cuda",
                                     "flash_attention_fwd_tiled_cuda"])
def test_no_instance_raises_on_cuda_tensors_and_launches_nothing(
        d, dtype, err, wrapper):
    """A head dim above 128 and f16 route to the tiled forward, which has
    no instance for them: it raises on CUDA tensors, as the f32 wrapper
    does, before anything is built or launched."""
    q = _OnCard(torch.zeros(1, 2, 16, d, dtype=dtype))
    assert tfa.fwd_route(q.shape, q.shape, dtype) == "tiled"
    before = tfa.launch_counts()
    with pytest.raises(err):
        getattr(tfa, wrapper)(q, q, q, 0.5)
    assert tfa.launch_counts() == before


F32_WRAPPERS = [
    ("flash_attention_fwd_f32_cuda", ()),
    ("flash_attention_bwd_dkdv_f32_cuda", ("do", "rows", "rows")),
    # (q, k, v, o, lse, do)
    ("flash_attention_bwd_dq_f32_cuda", ("do", "rows", "do"))]


@pytest.mark.parametrize("wrapper,args", F32_WRAPPERS)
def test_f32_wrappers_refuse_head_dims_above_64(wrapper, args):
    """f32 at D = 96 is the tiled route's: the f32 wrappers refuse it on
    CUDA tensors, launching nothing."""
    q = _OnCard(torch.zeros(1, 2, 16, 96))
    rows = _OnCard(torch.zeros(2, 16))
    extra = [q if a == "do" else rows for a in args]
    before = tfa.launch_counts()
    with pytest.raises(ValueError, match="head dims up to 64"):
        getattr(tfa, wrapper)(q, q, q, *extra, 0.5)
    assert tfa.launch_counts() == before


@pytest.mark.parametrize("wrapper,args", F32_WRAPPERS)
def test_f32_wrappers_refuse_bf16_and_launch_nothing(wrapper, args):
    """bf16 at D = 64 is the whole-block and fused kernels' (S = 16): the
    f32 wrappers refuse it on CUDA tensors, launching nothing."""
    q = _OnCard(torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16))
    rows = _OnCard(torch.zeros(2, 16))
    extra = [q if a == "do" else rows for a in args]
    assert tfa.bwd_route(q.shape, q.shape, q.dtype) == "fused"
    before = tfa.launch_counts()
    with pytest.raises(ValueError, match="takes f32"):
        getattr(tfa, wrapper)(q, q, q, *extra, 0.5)
    assert tfa.launch_counts() == before


@pytest.mark.parametrize("which", ["forward", "dkdv", "dq"])
def test_f32_wrappers_refuse_cpu_tensors_and_launch_nothing(which):
    q = torch.zeros(1, 2, 100, 64)
    rows = torch.zeros(2, 100)
    before = tfa.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        if which == "forward":
            tfa.flash_attention_fwd_f32_cuda(q, q, q, 0.5)
        elif which == "dkdv":
            tfa.flash_attention_bwd_dkdv_f32_cuda(q, q, q, q, rows, rows,
                                                  0.5)
        else:
            tfa.flash_attention_bwd_dq_f32_cuda(q, q, q, q, rows, q, 0.5)
    assert tfa.launch_counts() == before
    # the CPU entries take the plain versions for the same tensors
    o, lse = tfa.flash_attention_fwd(q, q, q, 0.5)
    grads = tfa.flash_attention_bwd(q, q, q, o, lse, q, 0.5)
    assert all(g.shape == q.shape for g in grads)
    assert tfa.launch_counts() == before


def test_f32_backward_takes_delta_then_dkdv_then_dq(monkeypatch):
    """flash_attention_bwd_f32_cuda: the f32 dQ kernel on q, k, v, O and dO
    padded to the instance's head dim (40 → 64), which returns dQ and
    delta, then the f32 dK/dV kernel on the same padded operands reading
    that delta; no torch pass of bwd_delta and no split-route dQ kernel;
    the grads sliced back."""
    calls = []
    made = torch.full((2, 16), 7.0)

    def dq(q, k, v, o, lse, do, *tail):
        calls.append(("dq", *(t.shape[-1] for t in (q, k, v, o, do))))
        return 3 * torch.ones_like(q), made

    def dkdv(q, k, v, do, lse, delta, *tail):
        calls.append(("dkdv", *(t.shape[-1] for t in (q, k, v, do)),
                      delta is made))
        return torch.ones_like(k), 2 * torch.ones_like(v)

    def never(*a, **kw):
        raise AssertionError("the f32 route took the old route's delta or "
                             "dQ kernel")
    monkeypatch.setattr(tfa, "flash_attention_bwd_dq_f32_cuda", dq)
    monkeypatch.setattr(tfa, "flash_attention_bwd_dkdv_f32_cuda", dkdv)
    monkeypatch.setattr(tfa, "flash_attention_bwd_q_cuda", never)
    monkeypatch.setattr(tfa, "bwd_delta", never)
    q = torch.zeros(1, 2, 16, 40)
    lse = torch.zeros(2, 16)
    dq_, dk_, dv_ = tfa.flash_attention_bwd_f32_cuda(q, q, q, q, lse, q, 0.5)
    assert calls == [("dq", 64, 64, 64, 64, 64), ("dkdv", 64, 64, 64, 64,
                                                  True)]
    assert dq_.shape == dk_.shape == dv_.shape == q.shape
    assert dq_.eq(3).all() and dk_.eq(1).all() and dv_.eq(2).all()


def test_cuda_backward_dispatches_f32_to_the_f32_route(monkeypatch):
    called = []
    for route, name in (("fused", "flash_attention_bwd_fused_cuda"),
                        ("streamed", "flash_attention_bwd_streamed_cuda"),
                        ("f32", "flash_attention_bwd_f32_cuda"),
                        ("split", "flash_attention_bwd_split_cuda")):
        monkeypatch.setattr(tfa, name,
                            lambda *a, route=route: called.append(route))
    for d in (64, 96):
        q = torch.zeros(1, 2, 128, d)
        tfa.flash_attention_bwd_cuda(q, q, q, q, torch.zeros(2, 128), q, 0.5)
    assert called == ["f32", "split"]


def test_f32_counts_are_launch_counts():
    counts = tfa.launch_counts()
    assert counts["flash_attention_fwd_f32"] == tfa.fwd_f32_launch_count
    assert counts["flash_attention_bwd_dkdv_f32"] == \
        tfa.bwd_dkdv_f32_launch_count
    assert counts["flash_attention_bwd_dq_f32"] == \
        tfa.bwd_dq_f32_launch_count


# ------------------------------------------------------------ shared memory
@pytest.mark.parametrize("dp", [32, 64])
def test_f32_instances_fit_the_shared_memory_of_a_block(dp):
    """Each instance's shared memory, as the wrapper's Python lays it out,
    at or below the 232,448 bytes a block may ask for; the forward's
    leaves room for a second block an SM (228 KB an SM, 1 KB of it kept
    for each block), as its header says."""
    fwd, bwd = tfa.fwd_f32_smem_bytes(dp), tfa.bwd_dkdv_f32_smem_bytes(dp)
    dq = tfa.bwd_dq_f32_smem_bytes(dp)
    assert fwd <= tfa.SMEM_LIMIT and bwd <= tfa.SMEM_LIMIT
    assert dq <= tfa.SMEM_LIMIT
    assert 2 * (fwd + 1024) <= 228 * 1024


@pytest.mark.parametrize("source,fn", [
    ("FWD_F32_SOURCE", "fwd_f32_smem_bytes"),
    ("BWD_DKDV_F32_SOURCE", "bwd_dkdv_f32_smem_bytes"),
    ("BWD_DQ_F32_SOURCE", "bwd_dq_f32_smem_bytes")])
def test_f32_sources_state_the_budget_the_wrapper_computes(source, fn):
    """The byte count each source's header gives for its D = 64 instance
    is the one the wrapper computes: the layout and its note agree."""
    with open(os.path.join(CSRC, getattr(tfa, source))) as f:
        text = f.read()
    assert f"{getattr(tfa, fn)(64):,} B" in text
