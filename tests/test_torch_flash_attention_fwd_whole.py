"""The flash-attention forward at the whole-block kernel's lengths (S, Sk up
to 128), on the CPU.

``flash_attention_reference`` is the plain version that chip_smoke.py holds
the whole-block CUDA kernel (``csrc/flash_attention_fwd_whole.cu``) against
on the card, and what the CPU runs. Here its O and lse are held against the
TPU package's ``_pallas_fwd`` (pallas_call :318, through the Pallas
interpreter, blocks of 64: two query and two key blocks at 128, an online
softmax over them) on the same seeded numpy inputs: S x Sk of 128 x 128,
100 x 77, 1 x 1 and 64 x 128, causal or not, no bias, a key-padding bias
or dead rows, dropout 0 and 0.1, f32 and bf16.
tests/test_torch_flash_attention.py covers S >= 200, the tiled kernel's
lengths. Tolerances: O within 2e-5 in f32 and 2e-2 in bf16, that file's
(bf16 operands; P rounded to bf16 before P V on both sides); lse within
2e-5 in both dtypes, since it is an f32 max and an f32 sum of f32
exponentials in both packages (the products of bf16 operands are exact in
f32). Dead rows give O = 0 and lse = +1e30 exactly.

Then the route that picks the whole-block kernel or the tiled one (a
function of shapes and dtype alone) at its edges and against the
backward's route, the dispatch by it, and the whole-block wrapper's
refusal of CPU tensors, which launches nothing.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch.fluid import executor
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

F32_TOL = 2e-5
BF16_TOL = 2e-2
LSE_TOL = 2e-5
BLOCK = 64
D = 32
SEED = 4321
DTYPES = {"f32": (torch.float32, jnp.float32, F32_TOL),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}
CSRC = os.path.join(os.path.dirname(os.path.abspath(tfa.__file__)), "csrc")


@pytest.fixture(autouse=True)
def _interpret():
    with fa.interpret_guard(), fa.block_override(BLOCK, BLOCK):
        yield


def _inputs(S, Sk, bias_kind, seed):
    r = np.random.RandomState(seed)
    q = r.normal(size=(2, 2, S, D)).astype(np.float32)
    k = r.normal(size=(2, 2, Sk, D)).astype(np.float32)
    v = r.normal(size=(2, 2, Sk, D)).astype(np.float32)
    bias = None
    if bias_kind == "pad":
        bias = np.zeros((2, Sk), np.float32)
        for b in range(2):
            bias[b, r.randint(Sk // 3, Sk):] = -1e9
    elif bias_kind == "dead":
        bias = np.zeros((2, Sk), np.float32)
        bias[0, :] = -1e30  # batch row 0: every key masked → dead rows
        bias[1, Sk // 2:] = -1e30
    return q, k, v, bias


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", [None, "pad", "dead"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,Sk", [(128, 128), (100, 77), (1, 1), (64, 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_fwd_matches_pallas_at_whole_lengths(dtype, S, Sk, causal,
                                                   bias_kind, rate):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v, bias = _inputs(S, Sk, bias_kind, seed=S + Sk)
    sm = 1.0 / np.sqrt(D)
    jo, jlse = fa._pallas_fwd(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
        jnp.asarray([SEED], jnp.int32), sm, causal,
        *fa._block_sizes(S, Sk, D), rate,
        bias=None if bias is None else jnp.asarray(bias))
    to, tlse = tfa.flash_attention_fwd(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), sm, causal, rate,
        torch.tensor([SEED], dtype=torch.int32),
        None if bias is None else torch.from_numpy(bias))
    assert to.dtype == tdt and tuple(to.shape) == (2, 2, S, D)
    assert tlse.dtype == torch.float32 and tuple(tlse.shape) == (4, S)
    to, tlse = to.float().numpy(), tlse.numpy()
    np.testing.assert_allclose(to, np.asarray(jo.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(tlse, np.asarray(jlse)[:, :, 0],
                               rtol=LSE_TOL, atol=LSE_TOL)
    if bias_kind == "dead":
        # batch row 0 masks every key: its rows are dead in both heads
        assert (to[0] == 0).all()
        assert (tlse[:2] == np.float32(1e30)).all()


@pytest.mark.parametrize("S,Sk,dtype,want", [
    (128, 128, torch.bfloat16, "whole"),
    (129, 128, torch.bfloat16, "streamed"),
    (128, 129, torch.bfloat16, "streamed"),
    (129, 129, torch.bfloat16, "streamed"),
    (1, 1, torch.bfloat16, "whole"),
    (100, 77, torch.bfloat16, "whole"),
    (128, 128, torch.float32, "f32"),
    (129, 128, torch.float32, "f32"),
    (1, 1, torch.float32, "f32"),
    (128, 128, torch.float16, "tiled"),
])
def test_fwd_route_by_length_and_dtype(S, Sk, dtype, want):
    assert tfa.fwd_route((2, 12, S, 64), (2, 12, Sk, 64), dtype) == want


@pytest.mark.parametrize("d,want", [(8, "whole"), (40, "whole"),
                                    (96, "whole"), (128, "whole"),
                                    (129, "tiled"), (192, "tiled")])
def test_fwd_route_by_head_dim(d, want):
    """Every head dim the kernels take (padded to the next instance) runs
    whole; above 128 there is no instance and the tiled wrapper raises."""
    assert tfa.fwd_route((2, 2, 128, d), (2, 2, 128, d),
                         torch.bfloat16) == want


def test_fwd_route_is_bwd_route_over_a_grid():
    """One predicate decides both: the whole-block forward runs exactly
    where the fused backward does, the streamed forward exactly where the
    streamed backward does."""
    both = {"whole": "fused", "streamed": "streamed", "f32": "f32",
            "tiled": "split"}
    seen = set()
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for S in (1, 16, 64, 100, 127, 128, 129, 200, 256):
            for Sk in (1, 77, 128, 129, 512):
                for d in (8, 32, 40, 64, 96, 128, 129, 256):
                    q, k = (2, 3, S, d), (2, 3, Sk, d)
                    fwd = tfa.fwd_route(q, k, dtype)
                    assert tfa.bwd_route(q, k, dtype) == both[fwd]
                    assert (fwd == "whole") == tfa.holds_whole(q, k, dtype)
                    seen.add(fwd)
    assert seen == {"whole", "streamed", "f32", "tiled"}


@pytest.mark.parametrize("S,dtype,want", [
    (128, torch.bfloat16, "whole"), (129, torch.bfloat16, "streamed"),
    (128, torch.float32, "f32")])
def test_cuda_forward_dispatches_by_fwd_route(monkeypatch, S, dtype, want):
    """flash_attention_cuda hands its arguments to the wrapper fwd_route
    names (both replaced here by recorders: no card)."""
    called = []
    for route, name in (("whole", "flash_attention_fwd_whole_cuda"),
                        ("streamed", "flash_attention_fwd_streamed_cuda"),
                        ("f32", "flash_attention_fwd_f32_cuda"),
                        ("tiled", "flash_attention_fwd_tiled_cuda")):
        monkeypatch.setattr(tfa, name,
                            lambda *a, route=route: called.append(route))
    q = torch.zeros(1, 2, S, 16, dtype=dtype)
    tfa.flash_attention_cuda(q, q, q, 0.25)
    assert called == [want]


def test_whole_wrapper_refuses_cpu_tensors_and_launches_nothing():
    q = torch.zeros(1, 2, 16, 8, dtype=torch.bfloat16)
    before = tfa.launch_counts()
    assert before["flash_attention_fwd_whole"] == tfa.fwd_whole_launch_count
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_fwd_whole_cuda(q, q, q, 0.5)
    assert tfa.launch_counts() == before
    # the CPU entry takes the plain version for the same tensors
    o, lse = tfa.flash_attention_fwd(q, q, q, 0.5)
    assert o.shape == q.shape and tuple(lse.shape) == (2, 16)
    assert tfa.launch_counts() == before


def test_chip_smoke_gates_count_every_kernel_once():
    """chip_smoke's launch gates: one entry for each count the executor's
    graph accounting reads, in KERNELS' order; no device kernel's name a
    substring of another's (a trace counts kernels by substring); the
    whole-block forward and the fused backward on the bf16 lane, the f32
    forward and dK/dV kernels and the split route's dQ kernel on the f32
    train step."""
    assert set(chip_smoke.KERNELS) == set(executor._launch_counts())
    names = chip_smoke.DEVICE_KERNELS
    assert len(names) == len(chip_smoke.KERNELS)
    for a in names:
        assert sum(a in b for b in names) == 1, a
    lane = dict(zip(chip_smoke.KERNELS, chip_smoke.LANE_STEP_WANT))
    train = dict(zip(chip_smoke.KERNELS, chip_smoke.TRAIN_STEP_WANT))
    assert lane["flash_attention_fwd_whole"] == 24 \
        and lane["flash_attention_fwd"] == 0
    assert train["flash_attention_fwd_f32"] == 24 \
        and train["flash_attention_fwd"] == 0 \
        and train["flash_attention_fwd_whole"] == 0
    assert train["flash_attention_bwd_dkdv_f32"] == 12 \
        and train["flash_attention_bwd_kv"] == 0 \
        and train["flash_attention_bwd_q"] == 12


def test_whole_block_sources_share_the_hopper_helpers():
    """The TMA, mbarrier and wgmma helpers live in hopper_common.cuh,
    which both whole-block sources include; neither defines its own."""
    helpers = ("mbar_init", "mbar_wait", "tma_load", "desc_k", "desc_mn",
               "wgmma_ss", "wgmma_rs", "encode_tiled", "tensor_map")
    with open(os.path.join(CSRC, "hopper_common.cuh")) as f:
        header = f.read()
    for name in helpers:
        assert re.search(rf"\b{name}\(", header), name
    for source in (tfa.FWD_WHOLE_SOURCE, tfa.BWD_FUSED_SOURCE):
        with open(os.path.join(CSRC, source)) as f:
            text = f.read()
        assert '#include "hopper_common.cuh"' in text, source
        for name in helpers:
            assert not re.search(
                rf"^\S.*\b{name}\([^;]*\)\s*\{{", text, re.M), (source, name)
