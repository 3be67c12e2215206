"""bench.py's longctx lane on the port (``paddle_tpu_torch.bench``'s
``longctx``) at its CPU size, against the TPU package's lane
(bench.py:1653-1700, its one-chip half) on the CPU.

The lane's step at S = Sk = 384, causal, bf16, B = 1, H = 2, D = 64 (q, k,
v from ``RandomState(0).randn · 0.3``, bench.py's draw), through the
port's ``flash_attention`` autograd function, whose wrappers run their
plain versions on CPU tensors (on the card: the streamed kernels, 64 key
tiles of 128 at S = 8192), against ``jax.value_and_grad`` of the TPU
package's ``flash_attention`` under ``interpret_guard()`` (its Pallas
forward and both backward pallas_calls, blocks of 64): the loss sum(O²)
in f32 and the lane's total within 2e-3 relative, each of dQ, dK and dV
within 2e-2 (the bf16 tolerance of the other flash files: one bf16 ulp at
|value| up to 4). Then the lane's JSON line at the CPU size carries
bench.py's keys, and bench.py's FLOP count gives 360.8 GFLOP a step at
the card's shape. Last, chip_smoke's planted fault for its S = 8192
limits (one tile of the causal grid left out) is held to a direct
computation, and each limit fails it at the CPU size.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch import bench

GRAD_TOL = 2e-2
LOSS_RTOL = 2e-3
BLOCK = 64


@pytest.fixture(autouse=True)
def _interpret():
    with fa.interpret_guard(), fa.block_override(BLOCK, BLOCK):
        yield


def _jax_step(q, k, v):
    sm = 1.0 / float(np.sqrt(q.shape[-1]))

    def loss(q2, k2, v2):
        return jnp.sum(fa.flash_attention(q2, k2, v2, sm, causal=True)
                       .astype(jnp.float32) ** 2)
    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(q, k, v)
    total = val + sum(jnp.sum(g.astype(jnp.float32) ** 2) for g in grads)
    return float(total), float(val), [np.asarray(g.astype(jnp.float32))
                                      for g in grads]


def test_longctx_step_matches_the_tpu_package():
    shape = bench.LONGCTX_CPU
    assert (shape["seq_len"], shape["heads"]) == (384, 2)
    q, k, v = bench.longctx_inputs(device=torch.device("cpu"), **shape)
    assert q.dtype == torch.bfloat16 and q.shape == (1, 2, 384, 64)
    total, loss, grads = bench.longctx_step(q, k, v)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    jtotal, jloss, jgrads = _jax_step(jq, jk, jv)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(total), jtotal, rtol=LOSS_RTOL)
    for name, g, w in zip("qkv", grads, jgrads):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg="d" + name)
    # causal: the last key's grads come from the last query row alone
    assert torch.count_nonzero(grads[1][0, :, -1]) > 0


def test_longctx_lane_line_at_the_cpu_size():
    res = bench.bench_longctx(iters=1, warmup=1, device="cpu")
    assert res["metric"] == "longctx_attention_tokens_per_sec"
    for key in ("value", "unit", "vs_baseline", "seq_len", "heads",
                "head_dim", "mode", "devices", "step_ms", "attn_tflops"):
        assert key in res, key
    assert (res["seq_len"], res["heads"], res["head_dim"]) == (384, 2, 64)
    assert res["mode"] == "flash_causal_1card" and res["devices"] == 1
    assert res["device"] == "cpu" and "bound_ms" not in res
    assert np.isfinite(res["loss"]) and res["value"] > 0


def test_longctx_flop_count_and_bound():
    flops = bench.longctx_flops(**bench.LONGCTX)
    assert flops == 4.0 * 1 * 12 * 8192 ** 2 * 64 / 2.0 * 3.5
    assert round(flops / 1e9, 1) == 360.8
    assert round(flops / bench.H100_BF16_PEAK_FLOPS * 1e3, 3) == 0.365
    if not torch.cuda.is_available():  # the lane runs on the card only
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.bench_longctx()


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_longctx",
                                                  path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_skipped_tile_is_the_masked_attention():
    """chip_smoke._longctx_skip_tile, from the causal outputs, against
    attention in f64 with query tile 2's scores on key tile 1 masked:
    the forward recomputed under the mask, the backward with the causal
    forward's P, lse and delta and that tile's terms dropped (what kernels
    that skip it give); then each of chip_smoke's LONGCTX_TOL measures
    fails the skipped tile and passes the outputs themselves."""
    cs = _chip_smoke()
    rng = np.random.RandomState(21)
    B, H, S, D = 1, 2, 3 * cs.LONGCTX_BLOCK, 64
    q, k, v = (torch.from_numpy(rng.randn(B, H, S, D) * 0.3)
               for _ in range(3))
    do = torch.from_numpy(rng.randn(B, H, S, D))
    sm = D ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    qt, kt = 2, 1
    tile = torch.zeros(S, S, dtype=torch.bool)
    tile[qt * cs.LONGCTX_BLOCK:(qt + 1) * cs.LONGCTX_BLOCK,
         kt * cs.LONGCTX_BLOCK:(kt + 1) * cs.LONGCTX_BLOCK] = True
    s = q @ k.transpose(-1, -2) * sm

    def forward(mask):
        t = s.masked_fill(~mask, float("-inf"))
        return torch.softmax(t, -1) @ v, torch.logsumexp(t, -1)
    o, lse = forward(causal)
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    ds = p * (do @ v.transpose(-1, -2) - (o * do).sum(-1, keepdim=True)) * sm
    keep = (~tile).double()
    full = (o, lse.reshape(B * H, S), ds @ k, ds.transpose(-1, -2) @ q,
            p.transpose(-1, -2) @ do)
    o2, lse2 = forward(causal & ~tile)
    direct = (o2, lse2.reshape(B * H, S), (ds * keep) @ k,
              (ds * keep).transpose(-1, -2) @ q,
              (p * keep).transpose(-1, -2) @ do)
    f32 = [t.float() for t in full]
    got = cs._longctx_skip_tile(q.float(), k.float(), v.float(),
                                do.float(), sm, *f32, qt, kt)
    for name, g, w in zip(cs.LONGCTX_TOL, got, direct):
        np.testing.assert_allclose(g.double().numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    want = dict(zip(cs.LONGCTX_TOL, f32))
    planted = cs._longctx_errs(dict(zip(cs.LONGCTX_TOL, got)), want)
    same = cs._longctx_errs(want, want)
    for name, limit in cs.LONGCTX_TOL.items():
        assert planted[name][0] > limit, (name, planted[name])
        assert same[name] == (0.0, 0.0), name
