"""paddle_tpu_torch's flash-attention backward against the Pallas kernels.

The port's plain backward (``flash_attention_bwd_reference``: the CPU
dispatch target, and what chip_smoke.py holds the dK/dV and dQ CUDA kernels
against on the card) gets O and lse from the port's plain forward; the TPU
package's ``jax.vjp`` of ``flash_attention`` runs its forward and its two
backward pallas_calls through the Pallas interpreter. Both see the same
seeded numpy q, k, v, dO, bias and dropout seed, with block sizes forced to
64 so that several Q and K blocks and ragged edges occur, over the config
set of tests/test_flash_attention.py: ragged and aligned S/Sk, causal or
not, f32 and bf16, with and without the key-padding bias, dropout 0 and
0.1, dead rows.

Tolerances. f32: 2e-5, the TPU package's own tolerance for the flash
forward (tests/test_flash_attention.py:36), ten times tighter than its
grad tolerance (2e-4, :55): both sides compute the same products and sum
over at most 256 rows in f32, in other orders (measured: 2.6e-6 at
|grad| up to 5.5). bf16: 2e-2, the bf16 forward tolerance: both sides
round P′ and dS to bf16 at the same points, but O (hence delta) and the
products' sums differ by rounding, so a value near a rounding boundary
lands one bf16 ulp apart — 2^-8 relative, 0.0156 at |grad| = 4 (measured:
0.0078). The dropout masks are bit-identical (keep_mask vs
keep_mask_reference, in test_torch_flash_attention.py), so the dropout
cases take the same tolerances.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

F32_TOL = 2e-5
BF16_TOL = 2e-2
BLOCK = 64
SEED = 4321


@pytest.fixture(autouse=True)
def _interpret():
    with fa.interpret_guard(), fa.block_override(BLOCK, BLOCK):
        yield


def _inputs(B, H, S, Sk, D, bias_kind, seed=0):
    r = np.random.RandomState(seed)
    q, do = (r.normal(size=(B, H, S, D)).astype(np.float32) for _ in "qo")
    k, v = (r.normal(size=(B, H, Sk, D)).astype(np.float32) for _ in "kv")
    bias = None
    if bias_kind == "pad":
        bias = np.zeros((B, Sk), np.float32)
        for b in range(B):
            bias[b, r.randint(Sk // 3, Sk):] = -1e9
    elif bias_kind == "dead":
        bias = np.zeros((B, Sk), np.float32)
        bias[0, :] = -1e30  # batch row 0: every key masked → dead rows
        bias[1, Sk // 2:] = -1e30
    return q, k, v, do, bias


@functools.lru_cache(maxsize=None)
def _grads_fn(sm, causal, rate):
    """The TPU package's ``jax.vjp`` of ``flash_attention`` (its forward
    and both backward pallas_calls) as one ``jax.jit``, its bias and
    dropout seed traced: XLA compiles the interpreted kernels' grid loops
    once for each shape, dtype and bias kind, where eager dispatch runs
    them primitive by primitive. Every caller runs it under ``_interpret``
    (the interpreter, blocks of BLOCK), which its traces bake in."""
    def grads(q, k, v, do, bias, seed):
        def f(q_, k_, v_):
            return fa.flash_attention(q_, k_, v_, sm, causal,
                                      dropout_rate=rate, dropout_seed=seed,
                                      bias=bias)
        return jax.vjp(f, q, k, v)[1](do)
    return jax.jit(grads)


def _jax_grads(q, k, v, do, bias, sm, causal, rate, dt):
    seed = jnp.asarray([SEED], jnp.int32) if rate else None
    jb = None if bias is None else jnp.asarray(bias)
    prim = [jnp.asarray(a).astype(dt) for a in (q, k, v, do)]
    return [np.asarray(g.astype(jnp.float32))
            for g in _grads_fn(float(sm), causal, rate)(*prim, jb, seed)]


def _port_grads(q, k, v, do, bias, sm, causal, rate, dt):
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dt) for a in (q, k, v, do))
    tb = None if bias is None else torch.from_numpy(bias)
    seed = torch.tensor([SEED], dtype=torch.int32) if rate else None
    o, lse = tfa.flash_attention_reference(tq, tk, tv, sm, causal, rate,
                                           seed, tb)
    grads = tfa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo, sm,
                                              causal, rate, seed, tb)
    return [g.float().numpy() for g in grads]


def _compare(got, want, tol):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", [None, "pad", "dead"])
@pytest.mark.parametrize("S,Sk", [(256, 256), (200, 77)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_bwd_matches_pallas_f32(causal, S, Sk, bias_kind, rate):
    q, k, v, do, bias = _inputs(2, 2, S, Sk, 32, bias_kind, seed=S + Sk)
    sm = 1.0 / np.sqrt(32)
    got = _port_grads(q, k, v, do, bias, sm, causal, rate, torch.float32)
    want = _jax_grads(q, k, v, do, bias, sm, causal, rate, jnp.float32)
    _compare(got, want, F32_TOL)
    if bias_kind == "dead":
        # dead rows: P = 0, so their dQ is 0 and they add nothing to dK/dV
        assert (got[0][0] == 0).all()
        if not causal:
            assert (got[1][0] == 0).all() and (got[2][0] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S,Sk", [(256, 256), (200, 77)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_bwd_matches_pallas_bf16(causal, S, Sk, rate):
    q, k, v, do, bias = _inputs(2, 2, S, Sk, 32, "pad", seed=7)
    sm = 1.0 / np.sqrt(32)
    got = _port_grads(q, k, v, do, bias, sm, causal, rate, torch.bfloat16)
    want = _jax_grads(q, k, v, do, bias, sm, causal, rate, jnp.bfloat16)
    _compare(got, want, BF16_TOL)


@pytest.mark.parametrize("D", [8, 64])
def test_head_dims_and_one_row_block(D):
    """A head dim off the tested 32 and S, Sk below one block."""
    q, k, v, do, bias = _inputs(1, 3, 40, 24, D, "pad", seed=D)
    sm = 0.3
    got = _port_grads(q, k, v, do, bias, sm, False, 0.1, torch.float32)
    want = _jax_grads(q, k, v, do, bias, sm, False, 0.1, jnp.float32)
    _compare(got, want, F32_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_through_flash_attention_equals_plain_bwd(causal, rate):
    """torch autograd through the port's ``flash_attention`` (the
    FlashAttentionFunction) gives exactly the plain backward's grads, and
    only q, k and v get them."""
    q, k, v, do, bias = _inputs(2, 2, 96, 80, 16, "pad", seed=11)
    sm = 0.25
    seed = torch.tensor([SEED], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tb, tdo = torch.from_numpy(bias), torch.from_numpy(do)
    o = tfa.flash_attention(tq, tk, tv, sm, causal, rate,
                            seed if rate else None, tb)
    got = torch.autograd.grad(o, (tq, tk, tv), tdo)
    want = _port_grads(q, k, v, do, bias, sm, causal, rate, torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert tfa.bwd_kv_launch_count == tfa.bwd_q_launch_count == 0


def test_bias_gets_zero_grad_and_seed_none():
    q, k, v, do, bias = _inputs(1, 2, 32, 32, 8, "pad", seed=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_()
    seed = torch.tensor([SEED], dtype=torch.int32)
    o, _ = tfa.FlashAttentionFunction.apply(tq, tk, tv, seed, tb, 0.5, False,
                                            0.1)
    gq, gb = torch.autograd.grad(o, (tq, tb), torch.from_numpy(do))
    assert gb.shape == tb.shape and (gb == 0).all()
    assert gq.abs().sum() > 0
    assert not seed.requires_grad


def test_dropout_without_seed_raises():
    q, k, v, _, _ = _inputs(1, 1, 16, 16, 8, None)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(tq, tk, tv, 0.5, dropout_rate=0.1)


def test_bwd_entry_rules():
    q, k, v, do, _ = _inputs(1, 1, 16, 16, 8, None)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, 0.5)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_bwd(*(t.to("meta") for t in (tq, tk, tv, o,
                                                          lse, tdo)), 0.5)
    # a CPU tensor never reaches the kernel wrappers
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_cuda(tq, tk, tv, o, lse, tdo, 0.5)
    delta = tfa.bwd_delta(o, tdo)
    assert tuple(delta.shape) == (1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_kv_cuda(tq, tk, tv, tdo, lse, delta, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_q_cuda(tq, tk, tv, tdo, lse, delta, 0.5)
