"""paddle_tpu_torch's flash-attention forward against the Pallas kernel.

The port's plain PyTorch version (the CPU dispatch target, and what
chip_smoke.py holds the CUDA kernel against on the card) is compared with
the TPU package's Pallas kernel run through the Pallas interpreter, on the
same seeded numpy inputs: O through ``flash_attention`` and lse through
``_pallas_fwd``, with block sizes forced small so several K blocks and
ragged edges occur. Tolerances: f32 2e-5 (the reference's own flash
tolerance, tests/test_flash_attention.py), bf16 2e-2. The dropout mask is
compared bit for bit with ``keep_mask_reference``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

F32_TOL = 2e-5
BF16_TOL = 2e-2
BLOCK = 64  # forces several Q and K blocks at S = 256, ragged at 200 / 77
SEED = 4321


@pytest.fixture(autouse=True)
def _interpret():
    with fa.interpret_guard(), fa.block_override(BLOCK, BLOCK):
        yield


def _inputs(B, H, S, Sk, D, bias_kind, seed=0):
    r = np.random.RandomState(seed)
    q = r.normal(size=(B, H, S, D)).astype(np.float32)
    k = r.normal(size=(B, H, Sk, D)).astype(np.float32)
    v = r.normal(size=(B, H, Sk, D)).astype(np.float32)
    bias = None
    if bias_kind == "pad":
        bias = np.zeros((B, Sk), np.float32)
        for b in range(B):
            bias[b, r.randint(Sk // 3, Sk):] = -1e9
    elif bias_kind == "dead":
        bias = np.zeros((B, Sk), np.float32)
        bias[0, :] = -1e30  # batch row 0: every key masked → dead rows
        bias[1, Sk // 2:] = -1e30
    return q, k, v, bias


def _jax(a, dtype):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _torch(a, dtype):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _run_both(q, k, v, bias, causal, rate, bf16):
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    sm = 1.0 / np.sqrt(q.shape[-1])
    jseed = jnp.asarray([SEED], jnp.int32) if rate else None
    tseed = torch.tensor([SEED], dtype=torch.int32) if rate else None
    jo = fa.flash_attention(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt), sm,
                            causal, dropout_rate=rate, dropout_seed=jseed,
                            bias=_jax(bias, jnp.float32))
    to = tfa.flash_attention(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt),
                             sm, causal, dropout_rate=rate,
                             dropout_seed=tseed,
                             bias=_torch(bias, torch.float32))
    return np.asarray(jo.astype(jnp.float32)), to.float().numpy()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", [None, "pad", "dead"])
@pytest.mark.parametrize("S,Sk", [(256, 256), (200, 77)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_f32(causal, S, Sk, bias_kind, rate):
    q, k, v, bias = _inputs(2, 2, S, Sk, 32, bias_kind, seed=S + Sk)
    jo, to = _run_both(q, k, v, bias, causal, rate, bf16=False)
    np.testing.assert_allclose(to, jo, rtol=F32_TOL, atol=F32_TOL)
    if bias_kind == "dead":
        assert (to[0] == 0).all()


@pytest.mark.parametrize("S,Sk", [(256, 256), (200, 77)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_bf16(causal, S, Sk):
    q, k, v, bias = _inputs(2, 2, S, Sk, 32, "pad", seed=7)
    jo, to = _run_both(q, k, v, bias, causal, 0.0, bf16=True)
    np.testing.assert_allclose(to, jo, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("bias_kind", [None, "dead"])
@pytest.mark.parametrize("S,Sk,causal", [(256, 256, True), (200, 77, False)])
def test_lse_matches_pallas(S, Sk, causal, bias_kind, rate):
    """lse: the Pallas kernel's 128-lane wire form, lane 0, against the
    port's [B·H, S]; dead rows carry +1e30 in both."""
    q, k, v, bias = _inputs(2, 2, S, Sk, 8, bias_kind, seed=3)
    sm = 0.3
    jb = None if bias is None else jnp.asarray(bias)
    _, jlse = fa._pallas_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray([SEED], jnp.int32), sm, causal,
                             BLOCK, BLOCK, rate, bias=jb)
    _, tlse = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), sm,
        causal, rate, torch.tensor([SEED], dtype=torch.int32),
        None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :, 0],
                               rtol=F32_TOL, atol=F32_TOL)
    if bias_kind == "dead":
        assert (tlse.numpy()[:2] == np.float32(1e30)).all()


@pytest.mark.parametrize("seed,bh,rate", [(0, 0, 0.1), (SEED, 5, 0.1),
                                          (2 ** 31 - 1, 383, 0.5),
                                          (99, 11, 0.02)])
def test_keep_mask_bit_exact(seed, bh, rate):
    rows = np.arange(0, 4096, 7)
    cols = np.arange(3, 2000, 5)
    want = fa.keep_mask_reference(seed, bh, rows, cols, rate)
    got = tfa.keep_mask(seed, bh, torch.from_numpy(rows)[:, None],
                        torch.from_numpy(cols)[None, :], rate)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_call_does_not_count_launches():
    before = tfa.launch_count
    q, k, v, bias = _inputs(1, 2, 64, 64, 16, "pad")
    tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), 0.25,
                        bias=torch.from_numpy(bias))
    assert tfa.launch_count == before == 0


def test_entry_rules():
    q, k, v, _ = _inputs(1, 1, 16, 16, 8, None)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(tq, tk, tv, 0.5, dropout_rate=0.1)
    # mixed dtypes are promoted before dispatch
    mixed = tfa.flash_attention(tq.to(torch.bfloat16), tk, tv, 0.5)
    assert mixed.dtype == torch.float32
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_fwd(tq.to("meta"), tk.to("meta"),
                                tv.to("meta"), 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(tq, tk, tv, 0.5)
