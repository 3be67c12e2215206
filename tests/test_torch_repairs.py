"""The repairs of ROADMAP C1, C2 and C4 in paddle_tpu_torch, on the CPU,
against the TPU package where it has a counterpart.

- C1, attention takes every shape the reference takes: the route
  (``attention_ops.attention_route``) is the TPU package's rule, a pure
  function of the shapes: the flash kernels for no bias or the
  key-padding bias at any head dim, dtype and B·H, the einsum path for
  other bias shapes. On the card the kernels take head dims up to 128 (a
  head dim they have no instance for runs zero-padded: through the plain
  versions the padded D = 96 equals the unpadded one bitwise) and raise
  above. The einsum path draws the flash kernels' dropout mask. The TPU
  package's fused_attention_qkv at D = 96 and 192 (the Pallas kernel
  under ``interpret_guard()``) matches the port at 1e-5.
- C2, a step that repeats indices is reproducible: the registered
  ``gather_grad`` (duplicates summed in a fixed order) against
  ``jax.vjp`` of the TPU package's op, with duplicate indices, at 1e-5;
  the executor runs it for the grad op that append_backward emits, and
  lookup_table_v2's grad stays the generic one (autograd's ``w[ids]``
  backward, which sorts its indices), also against ``jax.vjp``.
- C4: a fetched bf16 var comes back as ``ml_dtypes.bfloat16``, bit for
  bit, on both executor paths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu.ops.registry import run_generic_grad as j_generic_grad
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.ops import attention_ops
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.registry import OPS as TOPS
from paddle_tpu_torch.ops.registry import run_generic_grad as t_generic_grad

TOL = 1e-5
F32, BF16 = torch.float32, torch.bfloat16


def _r(seed):
    return np.random.RandomState(seed)


# -------------------------------------------------------------------- C1
@pytest.mark.parametrize("shape,bias,want", [
    ((2, 12, 128, 64), None, "flash"),
    ((2, 8, 128, 96), None, "flash"),
    ((2, 8, 128, 96), "keypad", "flash"),
    ((2, 2, 128, 192), None, "flash"),   # the kernels raise on the card
    ((2, 2, 128, 192), "keypad", "flash"),
    ((4096, 16, 16, 64), None, "flash"),     # B·H = 65536
    ((5462, 12, 16, 64), "keypad", "flash"),  # B·H = 65544
    ((2, 12, 128, 64), "full", "einsum"),
    ((2, 12, 128, 64), "batch-only", "einsum"),
    ((2, 12, 128, 64), "keys-only", "einsum"),
])
def test_attention_route(shape, bias, want):
    B, H, S, D = shape
    bias_shape = {None: None, "keypad": (B, 1, 1, S), "full": (B, H, S, S),
                  "batch-only": (B, 1, 1, 1), "keys-only": (1, 1, 1, S)}[bias]
    assert attention_ops.attention_route(shape, shape, bias_shape) == want


@pytest.mark.parametrize("d,want", [(8, 8), (20, 32), (40, 64), (64, 64),
                                    (96, 128), (128, 128), (129, None),
                                    (192, None)])
def test_kernel_head_dim(d, want):
    assert tfa.kernel_head_dim(d) == want


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_padded_head_dim_is_exact_in_the_plain_path(dtype):
    """D = 96 zero-padded to 128 (what the CUDA wrappers do) through the
    plain versions: O, lse, dQ, dK and dV equal the unpadded path's
    bitwise, with dropout, causal masking and a key-padding bias."""
    r = _r(1)
    q, k, v, do = (torch.from_numpy(r.normal(size=(2, 3, 50, 96))
                                    .astype(np.float32)).to(dtype)
                   for _ in range(4))
    bias = torch.zeros(2, 50)
    bias[1, 30:] = -1e9
    sm = 96 ** -0.5
    args = (sm, True, 0.1, 1234, bias)
    o, lse = tfa.flash_attention_reference(q, k, v, *args)
    pad = [tfa.pad_head_dim(t, 128) for t in (q, k, v, do)]
    assert all(t.shape[-1] == 128 and t.is_contiguous() for t in pad)
    op, lsep = tfa.flash_attention_reference(*pad[:3], *args)
    assert torch.equal(op[..., :96], o) and torch.equal(lsep, lse)
    assert not op[..., 96:].any()
    grads = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, *args)
    gpad = tfa.flash_attention_bwd_reference(
        *pad[:3], tfa.pad_head_dim(o, 128), lse, pad[3], *args)
    for g, gp in zip(grads, gpad):
        assert torch.equal(gp[..., :96], g) and not gp[..., 96:].any()


def test_einsum_route_draws_the_flash_mask():
    """At dropout > 0 the einsum path keeps what the flash kernels keep:
    its output equals the flash plain version's at the same seed, and the
    mask differs from another seed's."""
    r = _r(2)
    q, k, v = (torch.from_numpy(r.normal(size=(2, 3, 40, 16))
                                .astype(np.float32)) for _ in range(3))
    bias = torch.zeros(2, 40)
    bias[0, 25:] = -1e9
    seed = torch.tensor([987654], dtype=torch.int32)
    sm = 0.25
    got = attention_ops._einsum_attention(q, k, v, sm, bias[:, None, None],
                                          False, 0.3, seed)
    want, _ = tfa.flash_attention_reference(q, k, v, sm, False, 0.3,
                                            987654, bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    other = attention_ops._einsum_attention(
        q, k, v, sm, bias[:, None, None], False, 0.3,
        torch.tensor([987655], dtype=torch.int32))
    assert not np.allclose(other.numpy(), want.numpy(), atol=1e-3)


def test_keep_mask_takes_a_device_seed():
    """The flash mask's seed may be an int32 [1] tensor (read where it
    lies, so a CUDA graph can capture the einsum path's mask): the same
    bits as the int."""
    bh = torch.arange(6).reshape(6, 1, 1)
    rows, cols = torch.arange(33)[:, None], torch.arange(17)[None, :]
    for seed in (0, 1234, 2 ** 31 - 1):
        assert torch.equal(
            tfa.keep_mask(seed, bh, rows, cols, 0.2),
            tfa.keep_mask(torch.tensor([seed], dtype=torch.int32), bh, rows,
                          cols, 0.2))


def _attention_op_both(d, heads, bias_kind):
    """fused_attention_qkv of both packages at head dim ``d``, the JAX
    side through the Pallas kernel in interpret mode."""
    r = _r(3)
    B, S = 2, 16
    q, k, v = (r.normal(size=(B, S, heads * d)).astype(np.float32)
               for _ in range(3))
    bias = None
    if bias_kind == "keypad":
        bias = np.zeros((B, 1, 1, S), np.float32)
        bias[0, ..., 11:] = -1e9
    attrs = {"num_heads": heads, "causal": False, "dropout_rate": 0.0}
    with jfa.interpret_guard():
        jout = JOPS.get("fused_attention_qkv").kernel(
            {"Q": [jnp.asarray(q)], "K": [jnp.asarray(k)],
             "V": [jnp.asarray(v)],
             "Bias": [None if bias is None else jnp.asarray(bias)]},
            dict(JOPS.get("fused_attention_qkv").attr_defaults, **attrs))
    tout = TOPS.get("fused_attention_qkv").kernel(
        {"Q": [torch.from_numpy(q)], "K": [torch.from_numpy(k)],
         "V": [torch.from_numpy(v)],
         "Bias": [None if bias is None else torch.from_numpy(bias)]},
        dict(TOPS.get("fused_attention_qkv").attr_defaults, **attrs))
    return np.asarray(jout["Out"][0]), tout["Out"][0].numpy()


@pytest.mark.parametrize("d,heads", [(96, 8), (192, 2)])
@pytest.mark.parametrize("bias_kind", [None, "keypad"])
def test_fused_attention_against_jax_at_any_head_dim(d, heads, bias_kind):
    j, t = _attention_op_both(d, heads, bias_kind)
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64),
                                     (torch.float64, 192)])
def test_flash_route_on_the_cpu_takes_any_dtype_and_head_dim(dtype, d):
    """On CPU tensors the flash route's plain version runs what the card's
    kernels have no instance for; it agrees with the einsum path."""
    r = _r(7)
    q, k, v = (torch.from_numpy(r.normal(size=(2, 2, 24, d))).to(dtype)
               for _ in range(3))
    bias = torch.zeros(2, 24, dtype=torch.float32)
    bias[1, 17:] = -1e9
    sm = d ** -0.5
    got = tfa.flash_attention(q, k, v, sm, bias=bias)
    want = attention_ops._einsum_attention(q, k, v, sm, bias[:, None, None])
    assert got.dtype == dtype
    # both paths sum in f32, whatever the operands' dtype
    tol = 2e-3 if dtype == torch.float16 else TOL
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(),
                               rtol=tol, atol=tol)


# -------------------------------------------------------------------- C2
def _registered_grad_vs_jax(op_type, ins, attrs, out_slot, in_slot):
    """The port's registered ``<op>_grad`` kernel against the TPU
    package's generic grad (``jax.vjp``) on the same numpy inputs and
    output grad."""
    tattrs = dict(TOPS.get(op_type).attr_defaults, **attrs)
    jattrs = dict(JOPS.get(op_type).attr_defaults, **attrs)
    tins = {s: [torch.from_numpy(a)] for s, a in ins.items()}
    jins = {s: [jnp.asarray(a)] for s, a in ins.items()}
    fwd = TOPS.get(op_type).kernel(tins, tattrs)[out_slot][0]
    g = _r(99).normal(size=tuple(fwd.shape)).astype(np.float32)
    tins[out_slot] = [fwd]
    jins[out_slot] = [jnp.asarray(fwd.numpy())]
    tins[out_slot + "@GRAD"] = [torch.from_numpy(g)]
    jins[out_slot + "@GRAD"] = [jnp.asarray(g)]
    grad_info = TOPS.get(op_type + "_grad")
    got = grad_info.kernel(tins, tattrs)[in_slot + "@GRAD"][0]
    want = j_generic_grad(op_type, jins, jattrs, [in_slot + "@GRAD"],
                          list(ins))[in_slot + "@GRAD"][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    return got


def test_gather_grad_duplicate_indices():
    r = _r(4)
    idx = np.array([[1], [3], [1], [7], [1], [0], [3]], np.int64)
    g = _registered_grad_vs_jax(
        "gather", {"X": r.normal(size=(8, 5)).astype(np.float32),
                   "Index": idx}, {}, "Out", "X")
    assert not g[[2, 4, 5, 6]].any()  # unread rows


@pytest.mark.parametrize("padding_idx", [-1, 3])
def test_lookup_table_v2_generic_grad_duplicate_indices(padding_idx):
    """lookup_table_v2 has no registered grad: the port's generic grad
    (autograd through ``w[ids]``) against ``jax.vjp`` with repeated ids."""
    r = _r(5)
    ids = r.randint(0, 10, size=(3, 7)).astype(np.int64)
    ids[0, :3] = 3
    ids[1, :] = 4  # one row read seven times
    w = r.normal(size=(10, 6)).astype(np.float32)
    attrs = dict(TOPS.get("lookup_table_v2").attr_defaults,
                 padding_idx=padding_idx)
    g = _r(99).normal(size=(3, 7, 6)).astype(np.float32)
    got = t_generic_grad(
        "lookup_table_v2", {"W": [torch.from_numpy(w)],
                            "Ids": [torch.from_numpy(ids)],
                            "Out@GRAD": [torch.from_numpy(g)]},
        attrs, ["W@GRAD"], ["W", "Ids"])["W@GRAD"][0]
    want = j_generic_grad(
        "lookup_table_v2", {"W": [jnp.asarray(w)], "Ids": [jnp.asarray(ids)],
                            "Out@GRAD": [jnp.asarray(g)]},
        dict(JOPS.get("lookup_table_v2").attr_defaults,
             padding_idx=padding_idx), ["W@GRAD"], ["W", "Ids"])["W@GRAD"][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert not TOPS.has("lookup_table_v2_grad")


def test_index_grads_are_repeatable():
    """Run twice on the same inputs, the registered grads give the same
    bits (on the CPU as on the card, where index_add_'s atomics did not)."""
    r = _r(6)
    n = 4096
    idx = torch.from_numpy(r.randint(0, 64, size=(n, 1)))
    x = torch.zeros(64, 32)
    g = torch.from_numpy(r.normal(size=(n, 32)).astype(np.float32))
    kern = TOPS.get("gather_grad").kernel
    ins = {"X": [x], "Index": [idx], "Out@GRAD": [g]}
    assert torch.equal(kern(ins, {})["X@GRAD"][0], kern(ins, {})["X@GRAD"][0])


def test_executor_runs_the_registered_index_grads():
    """append_backward emits gather_grad and lookup_table_v2_grad; the
    executor resolves gather_grad to its registered kernel and
    lookup_table_v2_grad to the generic grad."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        ids = tfluid.data("ids", [5], dtype="int64")
        pos = tfluid.data("pos", [1], dtype="int64")
        emb = tfluid.layers.embedding(ids, [20, 4])
        flat = tfluid.layers.reshape(emb, [-1, 4])
        loss = tfluid.layers.mean(tfluid.layers.gather(flat, pos))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    ops = main.global_block().ops
    for t, registered in (("gather_grad", True),
                          ("lookup_table_v2_grad", False)):
        i, op = next((i, op) for i, op in enumerate(ops) if op.type == t)
        info, grad_of, _ = texecutor._resolve(op, i)
        if registered:
            assert info is TOPS.get(t) and grad_of is None
        else:
            assert grad_of == t[:-len("_grad")]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"ids": np.array([[1, 2, 2, 2, 3], [2, 2, 5, 6, 7]]),
            "pos": np.array([[0], [2], [2], [7]])}
    l1, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(l1).all()


# -------------------------------------------------------------------- C4
@pytest.mark.parametrize("mode", ["compiled", "interpreted"])
def test_fetched_bf16_is_ml_dtypes_bfloat16(mode):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    assert tcore.BF16_HOST_DTYPE == np.dtype(ml_dtypes.bfloat16)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [4], dtype="bfloat16")
        y = tfluid.layers.scale(x, scale=2.0)
    # values a bf16 holds exactly, fed as f32 into the bf16 var
    xs = np.array([[1.5, -2.25, 3.0e38, 0.1]], dtype=ml_dtypes.bfloat16)
    tcore.set_flag("FLAGS_executor_mode", mode)
    try:
        exe = tfluid.Executor(tfluid.CPUPlace())
        out, back = exe.run(main, feed={"x": xs.astype(np.float32)},
                            fetch_list=[y, x])
    finally:
        tcore.set_flag("FLAGS_executor_mode", "compiled")
    assert exe._last_run_mode == mode
    assert out.dtype == ml_dtypes.bfloat16 and back.dtype == out.dtype
    assert np.array_equal(back.view(np.uint16), xs.view(np.uint16))
    with np.errstate(over="ignore"):  # 3e38 · 2 is inf in bf16 too
        want = (xs.astype(np.float32) * 2).astype(ml_dtypes.bfloat16)
    assert np.array_equal(out.view(np.uint16), want.view(np.uint16))


def test_lodtensor_numpy_bf16_bits():
    t = torch.tensor([1.0, -0.0, 65504.0, 1e-30], dtype=torch.bfloat16)
    a = tcore.LoDTensor(t).numpy()
    assert a.dtype == tcore.BF16_HOST_DTYPE
    if a.dtype.name == "bfloat16":
        assert np.array_equal(a.view(np.int16), t.view(torch.int16).numpy())
    np.testing.assert_array_equal(a.astype(np.float32), t.float().numpy())


# ------------------------------------------------- bf16 scalars (ROADMAP C1)
# Every registered op of the port that does arithmetic with Python
# scalars, on bf16 inputs, against the TPU package's kernel on the same
# inputs. JAX rounds a weak-typed Python scalar (and ``jnp.asarray(v,
# x.dtype)``) to bf16 before the arithmetic; the port rounds its scalars
# to X's dtype on the host (``math_ops.scalar_as``). Bitwise where the
# reference's arithmetic allows it, else within BF16_TOL with the
# reference's output dtype. Dropout's training upscale is left as it is
# (the roadmap's note: the bias is the reference's).
BF16_TOL = 2e-2
BF16 = torch.bfloat16


def _bf16(a):
    return np.asarray(a, np.float32).astype(jnp.bfloat16)


def _sc_inputs(case):
    r = _r(100)
    x = _bf16(r.normal(size=(64, 64)))
    probs = np.abs(r.normal(size=(16, 12))) + 0.05
    probs /= probs.sum(-1, keepdims=True)
    onehot = np.eye(16)[r.randint(0, 16, (3, 5))]
    img = _bf16(r.normal(size=(4, 3, 5, 5)))
    c3 = (_bf16(r.normal(size=3)), _bf16(r.normal(size=3)),
          _bf16(r.normal(size=3)), _bf16(np.abs(r.normal(size=3)) + 0.1))
    return {
        "scale": {"X": x},
        "scale_tensor": {"X": x, "ScaleTensor": np.array([0.1], np.float32)},
        "gelu": {"X": _bf16(np.linspace(-6, 6, 8192).reshape(1, -1))},
        "cross_entropy": {"X": _bf16(probs),
                          "Label": r.randint(0, 12, (16, 1)).astype(np.int64)},
        "cross_entropy_soft": {"X": _bf16(probs),
                               "Label": _bf16(np.eye(12)[
                                   r.randint(0, 12, 16)] * 0.9 + 0.1 / 12)},
        "softmax_with_cross_entropy": {
            "Logits": _bf16(r.normal(size=(16, 12)) * 3),
            "Label": r.randint(0, 12, (16, 1)).astype(np.int64)},
        "label_smooth": {"X": _bf16(onehot)},
        "label_smooth_prior": {"X": _bf16(onehot),
                               "PriorDist": _bf16(np.full(16, 1 / 16))},
        "add_position_encoding": {"X": _bf16(r.normal(size=(2, 80, 64)))},
        "increment": {"X": _bf16([3.0])},
        "dropout": {"X": x},
        "batch_norm": {"X": img, "Scale": c3[0], "Bias": c3[1],
                       "Mean": c3[2], "Variance": c3[3]},
        "layer_norm": {"X": _bf16(r.normal(size=(4, 6, 8))),
                       "Scale": _bf16(r.normal(size=8)),
                       "Bias": _bf16(r.normal(size=8))},
        "pool2d": {"X": img},
    }[case]


# (case, op, attrs, bitwise): what is not bitwise is held at BF16_TOL
SCALAR_CASES = [
    ("scale", "scale", {"scale": 0.1}, True),
    ("scale", "scale", {"scale": 1 / 3, "bias": 0.7}, True),
    ("scale", "scale", {"scale": 1 / 3, "bias": 0.7,
                        "bias_after_scale": False}, True),
    ("scale", "scale", {"scale": -1e9, "bias": 1.0}, True),
    ("scale_tensor", "scale", {"bias": 0.7}, True),
    ("gelu", "gelu", {"approximate": True}, False),
    ("gelu", "gelu", {"approximate": False}, False),
    ("cross_entropy", "cross_entropy", {}, True),
    ("cross_entropy_soft", "cross_entropy", {"soft_label": True}, True),
    ("softmax_with_cross_entropy", "softmax_with_cross_entropy", {}, False),
    ("label_smooth", "label_smooth", {"epsilon": 0.1}, True),
    ("label_smooth_prior", "label_smooth", {"epsilon": 0.1}, True),
    ("add_position_encoding", "add_position_encoding", {}, True),
    ("add_position_encoding", "add_position_encoding",
     {"alpha": 0.5, "beta": 3.0}, True),
    ("increment", "increment", {"step": 0.1}, True),
    ("dropout", "dropout", {"is_test": True, "dropout_prob": 0.1}, True),
    ("batch_norm", "batch_norm", {"momentum": 0.9, "epsilon": 1e-5}, False),
    ("layer_norm", "layer_norm", {"begin_norm_axis": 2}, True),
    ("pool2d", "pool2d", {"pooling_type": "avg", "ksize": [3, 3],
                          "paddings": [1, 1], "exclusive": False}, True),
]


@pytest.mark.parametrize("case,op,attrs,bitwise", SCALAR_CASES,
                         ids=[f"{c[1]}-{i}" for i, c in
                              enumerate(SCALAR_CASES)])
def test_bf16_scalar_ops_match_reference(case, op, attrs, bitwise):
    ins = _sc_inputs(case)
    jattrs = dict(JOPS.get(op).attr_defaults, **attrs)
    tattrs = dict(TOPS.get(op).attr_defaults, **attrs)
    tattrs["_rng"] = lambda: torch.zeros(1, dtype=torch.int64)
    jout = JOPS.get(op).kernel({s: [jnp.asarray(a)] for s, a in ins.items()},
                               jattrs)
    tout = TOPS.get(op).kernel(
        {s: [torch.from_numpy(np.asarray(a, np.float32)).to(BF16)
             if np.asarray(a).dtype == jnp.bfloat16
             else torch.from_numpy(np.asarray(a))] for s, a in ins.items()},
        tattrs)
    for slot in jout:
        j = np.asarray(jout[slot][0])
        t = tout[slot][0]
        if slot == "XShape" or j.size == 0:
            continue
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), slot
        got, want = t.float().numpy(), j.astype(np.float32)
        if bitwise:
            np.testing.assert_array_equal(got, want, err_msg=slot)
        else:
            np.testing.assert_allclose(got, want, rtol=BF16_TOL,
                                       atol=BF16_TOL, err_msg=slot)


def test_approximate_gelu_returns_f32_for_bf16():
    """The reference's sqrt(2/pi) is a numpy f64 scalar, not weak-typed:
    a bf16 x gives f32 there, and here. The values agree to f32 rounding
    (measured 5.8e-7), far inside BF16_TOL."""
    x = np.linspace(-6, 6, 8192).reshape(1, -1).astype(jnp.bfloat16)
    j = np.asarray(JOPS.get("gelu").kernel({"X": [jnp.asarray(x)]},
                                           {"approximate": True})["Out"][0])
    t = TOPS.get("gelu").kernel(
        {"X": [torch.from_numpy(x.astype(np.float32)).to(BF16)]},
        {"approximate": True})["Out"][0]
    assert j.dtype == np.float32 and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)
    # f32 in, f32 out: unchanged
    t32 = TOPS.get("gelu").kernel(
        {"X": [torch.from_numpy(x.astype(np.float32))]},
        {"approximate": True})["Out"][0]
    assert t32.dtype == torch.float32


def test_scale_rounds_its_scalars_on_the_host():
    """``scalar_as`` is a host-side cast: a Python number, bf16's value of
    the scalar, and the op makes no tensor of it."""
    from paddle_tpu_torch.ops.math_ops import scalar_as
    assert scalar_as(0.1, BF16) == 0.10009765625
    assert scalar_as(10000.0, BF16) == 9984.0
    assert scalar_as(0.1, torch.float32) == float(np.float32(0.1))
    assert scalar_as(2.7, torch.int64) == 2 and isinstance(
        scalar_as(2.7, torch.int64), int)
