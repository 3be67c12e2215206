"""The flash-attention forward and backward at the streamed kernels' lengths
(bf16, S or Sk above 128), on the CPU.

On the card, bf16 attention with S or Sk above 128 runs the streamed
kernels (``csrc/flash_attention_fwd_streamed.cu``: 128 query rows a block,
an online softmax over 128-key tiles; ``csrc/flash_attention_bwd_streamed.cu``:
a dQ kernel that takes delta itself, then a dK/dV kernel), which
chip_smoke.py holds against ``flash_attention_reference`` and
``flash_attention_bwd_reference``. Here those plain versions are held
against the TPU package's Pallas kernels (``_pallas_fwd``, pallas_call :318,
and ``jax.vjp`` of ``flash_attention``: its two backward pallas_calls, :514
and :543, through the Pallas interpreter, blocks of 64) on the same seeded
numpy inputs in bf16: S = Sk = 256 causal, and 200 x 300 ragged with a
key-padding bias and dropout 0.1. Tolerances are the bf16 ones of the other
flash files: 2e-2 for O and the grads (one bf16 ulp at |value| up to 4; P
and dS rounded to bf16 at the same points on both sides), 2e-5 for lse (an
f32 max and sum of f32 exponentials in both). The dropout mask is fed
across by seed: the port's ``keep_mask`` equals ``keep_mask_reference`` bit
for bit on the case's whole grid, checked here as well.

Then the three-way route (a function of shapes and dtype alone) over a grid,
the forward and the backward always agreeing; the dispatch to the wrapper
each route names; the streamed wrappers' refusal of CPU tensors, which
launches nothing; the sources' use of hopper_common.cuh; and chip_smoke's
launch gates over the nine counts.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch.fluid import executor
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

BF16_TOL = 2e-2
LSE_TOL = 2e-5
BLOCK = 64
D = 32
SEED = 4321
RATE = 0.1
CSRC = os.path.join(os.path.dirname(os.path.abspath(tfa.__file__)), "csrc")
# (S, Sk, causal, bias, dropout rate): the two cases held to the Pallas
# kernels
CASES = {"256x256 causal": (256, 256, True, False, 0.0),
         "200x300 bias dropout": (200, 300, False, True, RATE)}


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
def test_plain_fwd_matches_pallas_at_streamed_lengths(case):
    S, Sk, causal, with_bias, rate = CASES[case]
    q, k, v, _, bias = _inputs(S, Sk, with_bias, seed=S + Sk)
    sm = 1.0 / np.sqrt(D)
    assert tfa.fwd_route((2, 2, S, D), (2, 2, Sk, D),
                         torch.bfloat16) == "streamed"
    jo, jlse = fa._pallas_fwd(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray([SEED], jnp.int32), sm, causal,
        *fa._block_sizes(S, Sk, D), rate,
        bias=None if bias is None else jnp.asarray(bias))
    to, tlse = tfa.flash_attention_fwd(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), sm,
        causal, rate, torch.tensor([SEED], dtype=torch.int32),
        None if bias is None else torch.from_numpy(bias))
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == (2, 2, S, D)
    assert tuple(tlse.shape) == (4, S)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :, 0],
                               rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_bwd_matches_pallas_at_streamed_lengths(case):
    S, Sk, causal, with_bias, rate = CASES[case]
    q, k, v, do, bias = _inputs(S, Sk, with_bias, seed=S * Sk)
    sm = 1.0 / np.sqrt(D)
    assert tfa.bwd_route((2, 2, S, D), (2, 2, Sk, D),
                         torch.bfloat16) == "streamed"
    seed = jnp.asarray([SEED], jnp.int32) if rate else None
    jb = None if bias is None else jnp.asarray(bias)

    def f(q_, k_, v_):
        return fa.flash_attention(q_, k_, v_, sm, causal, dropout_rate=rate,
                                  dropout_seed=seed, bias=jb)
    _, vjp = jax.vjp(f, *(jnp.asarray(a).astype(jnp.bfloat16)
                          for a in (q, k, v)))
    want = [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do).astype(jnp.bfloat16))]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    tb = None if bias is None else torch.from_numpy(bias)
    tseed = torch.tensor([SEED], dtype=torch.int32) if rate else None
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, sm, causal, rate, tseed, tb)
    got = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, sm, causal, rate,
                                  tseed, tb)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=name)


def test_dropout_mask_is_the_pallas_kernels_on_the_ragged_grid():
    """The mask both sides draw at 200 x 300 from SEED, for every batch ·
    head: the port's keep_mask against keep_mask_reference, bit for bit."""
    rows, cols = np.arange(200), np.arange(300)
    for bh in range(4):
        want = fa.keep_mask_reference(SEED, bh, rows, cols, RATE)
        got = tfa.keep_mask(SEED, bh, torch.from_numpy(rows)[:, None],
                            torch.from_numpy(cols)[None, :], RATE)
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- routes
@pytest.mark.parametrize("S,Sk,dtype,want", [
    (129, 128, torch.bfloat16, "streamed"),
    (128, 129, torch.bfloat16, "streamed"),
    (512, 512, torch.bfloat16, "streamed"),
    (200, 300, torch.bfloat16, "streamed"),
    (1, 4096, torch.bfloat16, "streamed"),
    (128, 128, torch.bfloat16, "whole"),
    (512, 512, torch.float32, "f32"),
    (129, 128, torch.float32, "f32"),
    (512, 512, torch.float16, "tiled"),
])
def test_three_way_route_by_length_and_dtype(S, Sk, dtype, want):
    q, k = (2, 12, S, 64), (2, 12, Sk, 64)
    assert tfa.fwd_route(q, k, dtype) == want
    assert tfa.bwd_route(q, k, dtype) == {"whole": "fused",
                                          "streamed": "streamed",
                                          "f32": "f32",
                                          "tiled": "split"}[want]


def test_three_way_route_grid_forward_and_backward_agree():
    """Over dtype x S x Sk x D: the backward route is the forward's pair,
    bf16 above 128 at a head dim the kernels take is streamed, and every
    route occurs."""
    pairs = {"whole": "fused", "streamed": "streamed", "f32": "f32",
             "tiled": "split"}
    seen = set()
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for S in (1, 64, 128, 129, 200, 256, 512):
            for Sk in (1, 77, 128, 129, 300, 512):
                for d in (8, 40, 64, 96, 128, 129, 256):
                    q, k = (2, 3, S, d), (2, 3, Sk, d)
                    fam = tfa.fwd_route(q, k, dtype)
                    assert tfa.bwd_route(q, k, dtype) == pairs[fam]
                    long = S > tfa.WHOLE_MAX_LEN or Sk > tfa.WHOLE_MAX_LEN
                    takes = tfa.kernel_head_dim(d) is not None
                    assert (fam == "streamed") == (
                        dtype == torch.bfloat16 and long and takes)
                    seen.add(fam)
    assert seen == set(pairs)


@pytest.mark.parametrize("S,Sk,dtype,want", [
    (256, 256, torch.bfloat16, "streamed"), (100, 77, torch.bfloat16, "whole"),
    (256, 256, torch.float32, "f32")])
def test_cuda_forward_dispatches_to_the_streamed_wrapper(monkeypatch, S, Sk,
                                                         dtype, want):
    """flash_attention_cuda hands its arguments to the wrapper fwd_route
    names (each replaced here by a recorder: no card)."""
    called = []
    for route, name in (("whole", "flash_attention_fwd_whole_cuda"),
                        ("streamed", "flash_attention_fwd_streamed_cuda"),
                        ("f32", "flash_attention_fwd_f32_cuda"),
                        ("tiled", "flash_attention_fwd_tiled_cuda")):
        monkeypatch.setattr(tfa, name,
                            lambda *a, route=route: called.append(route))
    q = torch.zeros(1, 2, S, 16, dtype=dtype)
    k = torch.zeros(1, 2, Sk, 16, dtype=dtype)
    tfa.flash_attention_cuda(q, k, k, 0.25)
    assert called == [want]


@pytest.mark.parametrize("S,Sk,dtype,want", [
    (256, 256, torch.bfloat16, "streamed"), (100, 77, torch.bfloat16, "fused"),
    (256, 256, torch.float32, "f32")])
def test_cuda_backward_dispatches_to_the_streamed_wrapper(monkeypatch, S, Sk,
                                                          dtype, want):
    """flash_attention_bwd_cuda hands its arguments to the wrapper
    bwd_route names."""
    called = []
    for route, name in (("fused", "flash_attention_bwd_fused_cuda"),
                        ("streamed", "flash_attention_bwd_streamed_cuda"),
                        ("f32", "flash_attention_bwd_f32_cuda"),
                        ("split", "flash_attention_bwd_split_cuda")):
        monkeypatch.setattr(tfa, name,
                            lambda *a, route=route: called.append(route))
    q = torch.zeros(1, 2, S, 16, dtype=dtype)
    k = torch.zeros(1, 2, Sk, 16, dtype=dtype)
    lse = torch.zeros(2, S)
    tfa.flash_attention_bwd_cuda(q, k, k, q, lse, q, 0.25)
    assert called == [want]


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_streamed_wrappers_refuse_cpu_tensors_and_launch_nothing(which):
    q = torch.zeros(1, 2, 200, 8, dtype=torch.bfloat16)
    lse = torch.zeros(2, 200)
    before = tfa.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        if which == "forward":
            tfa.flash_attention_fwd_streamed_cuda(q, q, q, 0.5)
        else:
            tfa.flash_attention_bwd_streamed_cuda(q, q, q, q, lse, q, 0.5)
    assert tfa.launch_counts() == before
    # the CPU entries take the plain versions for the same tensors
    o, lse = tfa.flash_attention_fwd(q, q, q, 0.5)
    grads = tfa.flash_attention_bwd(q, q, q, o, lse, q, 0.5)
    assert all(g.shape == q.shape for g in grads)
    assert tfa.launch_counts() == before


def test_streamed_counts_are_launch_counts():
    counts = tfa.launch_counts()
    assert counts["flash_attention_fwd_streamed"] == \
        tfa.fwd_streamed_launch_count
    assert counts["flash_attention_bwd_dq_streamed"] == \
        tfa.bwd_dq_streamed_launch_count
    assert counts["flash_attention_bwd_dkdv_streamed"] == \
        tfa.bwd_dkdv_streamed_launch_count


# --------------------------------------------------------------- sources
HELPERS = ("mbar_init", "mbar_wait", "mbar_arrive", "tma_load", "bulk_load",
           "tma_store", "desc_k", "desc_mn", "wgmma_ss", "wgmma_rs", "dot8",
           "encode_tiled", "tensor_map")


@pytest.mark.parametrize("source", ["FWD_STREAMED_SOURCE",
                                    "BWD_STREAMED_SOURCE"])
def test_streamed_sources_share_the_hopper_helpers(source):
    """The TMA, mbarrier, bulk-copy and wgmma helpers live in
    hopper_common.cuh, which both streamed sources include; neither defines
    its own."""
    with open(os.path.join(CSRC, "hopper_common.cuh")) as f:
        header = f.read()
    for name in HELPERS:
        assert re.search(rf"\b{name}\(", header), name
    with open(os.path.join(CSRC, getattr(tfa, source))) as f:
        text = f.read()
    assert '#include "hopper_common.cuh"' in text
    for name in HELPERS:
        assert not re.search(rf"^\S.*\b{name}\([^;]*\)\s*\{{", text,
                             re.M), name


@pytest.mark.parametrize("kernel", ["flash_fwd_streamed_kernel",
                                    "flash_bwd_dq_streamed_kernel",
                                    "flash_bwd_dkdv_streamed_kernel"])
def test_streamed_sources_define_the_traced_kernels(kernel):
    """Each device name chip_smoke counts in a trace is a kernel of the
    streamed sources."""
    assert kernel in chip_smoke.DEVICE_KERNELS
    text = "".join(open(os.path.join(CSRC, getattr(tfa, s))).read()
                   for s in ("FWD_STREAMED_SOURCE", "BWD_STREAMED_SOURCE"))
    assert re.search(rf"__global__[^;{{]*\b{kernel}\(", text)


# ------------------------------------------------- chip_smoke's gates
def test_chip_smoke_kernels_match_the_executors_counts():
    """chip_smoke's KERNELS are the counts the executor's graph accounting
    reads, one device name each, no name a substring of another (a trace
    counts by substring); every launch tuple has an entry for each, the
    streamed ones seventh to ninth (the three f32 ones follow)."""
    assert set(chip_smoke.KERNELS) == set(executor._launch_counts())
    assert len(chip_smoke.KERNELS) == len(executor._launch_counts()) == 12
    assert chip_smoke.KERNELS[6:9] == (
        "flash_attention_fwd_streamed", "flash_attention_bwd_dq_streamed",
        "flash_attention_bwd_dkdv_streamed")
    names = chip_smoke.DEVICE_KERNELS
    assert len(names) == len(chip_smoke.KERNELS)
    for a in names:
        assert sum(a in b for b in names) == 1, a
    for want in (chip_smoke.LANE_STEP_WANT, chip_smoke.TRAIN_STEP_WANT,
                 chip_smoke.WMT_STEP_WANT, chip_smoke.WMT_LANE_WANT,
                 chip_smoke.WMT_DECODE_WANT):
        assert len(want) == 12 and want[6:9] == (0, 0, 0)
    assert chip_smoke.LANE512_STEP_WANT == (0, 0, 0, 0, 0, 0, 24, 12, 12, 0,
                                            0, 0)


def test_chip_smoke_lane512_gate_follows_from_the_program():
    """The S = 512 lane's gate from its program: the 12 attention ops of
    BERT-base at S = 512 take the streamed route in bf16, each launching
    the forward twice (once more under the generic grad) and the streamed
    pair once, and no dropout at rate 0."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.models import bert
    cfg = dict(bert.bert_base_config(), hidden=64, heads=4, ffn=128,
               vocab_size=64)
    with fluid.unique_name.guard():
        main = bert.build_bert_pretrain_program(
            cfg, seq_len=512, dropout=0.0, lr=1e-4)[0]
    ops = main.global_block().ops
    assert chip_smoke._step_want(ops, "streamed") == \
        chip_smoke.LANE512_STEP_WANT
