"""The flash-attention backward at the fused kernel's lengths (S, Sk up to
128), on the CPU.

``flash_attention_bwd_reference`` is the plain version that chip_smoke.py
holds the fused CUDA kernel (``csrc/flash_attention_bwd_fused.cu``) against
on the card, and what the CPU runs. Here it gets O and lse from the port's
plain forward and is held against the TPU package's ``jax.vjp`` of
``flash_attention`` (its forward and both backward pallas_calls, :514 and
:543, through the Pallas interpreter, blocks of 64) on the same seeded
numpy inputs: S = Sk = 128, ragged 100 x 77, a single row and key, causal
or not, no bias, a key-padding bias or dead rows, dropout 0 and 0.1, f32
and bf16. tests/test_torch_flash_attention_bwd.py covers S >= 200, the
split kernels' lengths. Tolerances are that file's: 2e-5 in f32, 2e-2 in
bf16 (one bf16 ulp at |grad| up to 4), with its reasons.

Then the route that picks the fused kernel or the split ones (a function of
shapes and dtype alone) at its edges, and the entry's refusals: a device
that is neither CUDA nor the CPU, and CPU tensors handed to the kernel's
wrapper, which launches nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from test_torch_flash_attention_bwd import (_compare, _inputs, _jax_grads,
                                            _port_grads)

F32_TOL = 2e-5
BF16_TOL = 2e-2
BLOCK = 64
D = 32
DTYPES = {"f32": (torch.float32, jnp.float32, F32_TOL),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


@pytest.fixture(autouse=True)
def _interpret():
    with fa.interpret_guard(), fa.block_override(BLOCK, BLOCK):
        yield


def _check(dtype, S, Sk, causal, bias_kind, rate):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v, do, bias = _inputs(2, 2, S, Sk, D, bias_kind, seed=S + Sk)
    sm = 1.0 / np.sqrt(D)
    got = _port_grads(q, k, v, do, bias, sm, causal, rate, tdt)
    want = _jax_grads(q, k, v, do, bias, sm, causal, rate, jdt)
    _compare(got, want, tol)
    return got


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", [None, "pad", "dead"])
@pytest.mark.parametrize("S,Sk", [(128, 128), (100, 77), (1, 1)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_bwd_matches_pallas_at_fused_lengths(dtype, S, Sk, bias_kind,
                                                   rate):
    got = _check(dtype, S, Sk, False, bias_kind, rate)
    if bias_kind == "dead":
        # batch row 0 masks every key: P = 0, so no grad reaches it
        for g in got:
            assert (g[0] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S,Sk", [(128, 128), (100, 77)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_bwd_matches_pallas_causal_at_fused_lengths(dtype, S, Sk,
                                                          rate):
    _check(dtype, S, Sk, True, "pad", rate)


@pytest.mark.parametrize("S,Sk,dtype,want", [
    (128, 128, torch.bfloat16, "fused"),
    (129, 128, torch.bfloat16, "streamed"),
    (128, 129, torch.bfloat16, "streamed"),
    (1, 1, torch.bfloat16, "fused"),
    (100, 77, torch.bfloat16, "fused"),
    (128, 128, torch.float32, "f32"),
    (100, 77, torch.float32, "f32"),
    (128, 128, torch.float16, "split"),
])
def test_bwd_route_by_length_and_dtype(S, Sk, dtype, want):
    assert tfa.bwd_route((2, 12, S, 64), (2, 12, Sk, 64), dtype) == want


@pytest.mark.parametrize("d,want", [(8, "fused"), (40, "fused"),
                                    (96, "fused"), (128, "fused"),
                                    (192, "split")])
def test_bwd_route_by_head_dim(d, want):
    """Every head dim the kernels take (padded to the next instance) may
    run fused; above 128 there is no instance and the split wrappers
    raise."""
    assert tfa.bwd_route((2, 2, 128, d), (2, 2, 128, d),
                         torch.bfloat16) == want


def test_bwd_entry_refuses_a_device_without_kernels():
    q = torch.empty(1, 1, 4, 8, device="meta")
    lse = torch.empty(1, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tfa.flash_attention_bwd(q, q, q, q, lse, q, 0.5)


def test_fused_wrapper_refuses_cpu_tensors_and_launches_nothing():
    q = torch.zeros(1, 2, 16, 8, dtype=torch.bfloat16)
    lse = torch.zeros(2, 16)
    before = tfa.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_bwd_fused_cuda(q, q, q, q, lse, q, 0.5)
    assert tfa.launch_counts() == before
    # the CPU entry takes the plain version for the same tensors
    dq, dk, dv = tfa.flash_attention_bwd(q, q, q, q, lse, q, 0.5)
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert tfa.launch_counts() == before
