"""Each op of paddle_tpu_torch's BERT-encoder slice against the TPU
package's registry kernel (``paddle_tpu.ops.registry.OPS.get(t).kernel``)
on the same seeded numpy inputs, at small shapes. Tolerance 1e-5 in f32.
The attention ops run the Pallas flash kernel through the interpreter on
the JAX side where it would take the kernel path."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.ops.registry import OPS as TOPS

TOL = 1e-5


def _run(op_type, ins, attrs, rtol=TOL, atol=TOL, skip=("XShape",)):
    """Run both kernels on numpy ``ins`` (slot → array or None) and compare
    every output slot; XShape-style slots compare by shape only."""
    jins = {s: [None if a is None else jnp.asarray(a)] for s, a in ins.items()}
    tins = {s: [None if a is None else torch.from_numpy(np.asarray(a))]
            for s, a in ins.items()}
    jattrs = dict(JOPS.get(op_type).attr_defaults, **attrs)
    tattrs = dict(TOPS.get(op_type).attr_defaults, **attrs)
    jout = JOPS.get(op_type).kernel(jins, jattrs)
    tout = TOPS.get(op_type).kernel(tins, tattrs)
    assert set(jout) == set(tout), (set(jout), set(tout))
    for slot in jout:
        j = np.asarray(jout[slot][0])
        t = tout[slot][0]
        assert tuple(t.shape) == j.shape, (slot, tuple(t.shape), j.shape)
        if slot in skip:
            continue
        np.testing.assert_allclose(t.float().numpy(), j.astype(np.float32),
                                   rtol=rtol, atol=atol, err_msg=slot)
    return tout


def _r(seed):
    return np.random.RandomState(seed)


@pytest.mark.parametrize("xshape,yshape,xn", [((6, 12), (12, 5), 1),
                                              ((2, 3, 4), (4, 5), 2),
                                              ((2, 3, 4), (12, 7), 1)])
def test_mul(xshape, yshape, xn):
    r = _r(0)
    _run("mul", {"X": r.normal(size=xshape).astype(np.float32),
                 "Y": r.normal(size=yshape).astype(np.float32)},
         {"x_num_col_dims": xn, "y_num_col_dims": 1})


@pytest.mark.parametrize("yshape,axis", [((2, 3, 4), -1), ((4,), -1),
                                         ((3,), 1), ((3, 4), 1),
                                         ((2, 3), 0), ((3, 1), 1)])
def test_elementwise_add(yshape, axis):
    r = _r(1)
    _run("elementwise_add", {"X": r.normal(size=(2, 3, 4)).astype(np.float32),
                             "Y": r.normal(size=yshape).astype(np.float32)},
         {"axis": axis})


@pytest.mark.parametrize("bias_after_scale", [True, False])
def test_scale(bias_after_scale):
    _run("scale", {"X": _r(2).normal(size=(3, 5)).astype(np.float32)},
         {"scale": -1e9, "bias": 1.0, "bias_after_scale": bias_after_scale})
    _run("scale", {"X": _r(2).normal(size=(3, 5)).astype(np.float32)},
         {"scale": 0.37, "bias": -2.0, "bias_after_scale": bias_after_scale})


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu(approximate):
    x = np.linspace(-6, 6, 97, dtype=np.float32).reshape(1, 97)
    _run("gelu", {"X": x}, {"approximate": approximate})


@pytest.mark.parametrize("bna,affine", [(1, True), (2, True), (2, False)])
def test_layer_norm(bna, affine):
    r = _r(3)
    x = (r.normal(size=(2, 3, 8)) * 3 + 1).astype(np.float32)
    d = int(np.prod(x.shape[bna:]))
    ins = {"X": x,
           "Scale": r.normal(size=(d,)).astype(np.float32) if affine else None,
           "Bias": r.normal(size=(d,)).astype(np.float32) if affine else None}
    out = _run("layer_norm", ins, {"epsilon": 1e-5, "begin_norm_axis": bna})
    assert tuple(out["Mean"][0].shape) == x.shape[:bna]


@pytest.mark.parametrize("padding_idx", [-1, 0, 3])
def test_lookup_table_v2(padding_idx):
    r = _r(4)
    ids = r.randint(0, 10, size=(3, 7)).astype(np.int64)
    ids[0, :3] = 3
    ids[1, 0] = 0
    _run("lookup_table_v2", {"W": r.normal(size=(10, 6)).astype(np.float32),
                             "Ids": ids}, {"padding_idx": padding_idx})


@pytest.mark.parametrize("shape", [[0, -1], [6, 4], [-1, 2, 2]])
def test_reshape2(shape):
    _run("reshape2", {"X": _r(5).normal(size=(2, 3, 4)).astype(np.float32)},
         {"shape": shape})


@pytest.mark.parametrize("axes", [[1], [0, 2], [-1]])
def test_unsqueeze2(axes):
    _run("unsqueeze2", {"X": _r(6).normal(size=(2, 3)).astype(np.float32)},
         {"axes": axes})


# --------------------------------------------------------------- attention
B, S, H, D = 2, 16, 4, 8


def _bias(kind, r):
    if kind is None:
        return None
    if kind == "keypad":  # [B,1,1,S]: the kernel path
        m = np.zeros((B, 1, 1, S), np.float32)
        m[0, ..., 11:] = -1e9
        m[1, ..., :] = -1e9  # all keys padded: uniform average, not dead
        return m
    return r.normal(size=(B, H, S, S)).astype(np.float32)  # einsum path


@pytest.mark.parametrize("interpret", [True, False])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
def test_fused_attention_qkv(bias_kind, causal, interpret):
    r = _r(7)
    q, k, v = (r.normal(size=(B, S, H * D)).astype(np.float32)
               for _ in range(3))
    ins = {"Q": q, "K": k, "V": v, "Bias": _bias(bias_kind, r)}
    attrs = {"num_heads": H, "causal": causal, "dropout_rate": 0.0}
    if interpret:
        with fa.interpret_guard():
            _run("fused_attention_qkv", ins, attrs)
    else:
        _run("fused_attention_qkv", ins, attrs)


@pytest.mark.parametrize("layout", ["packed_w", "qkv3", "qkv5"])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
def test_multihead_matmul(layout, bias_kind):
    r = _r(8)
    N = H * D
    attrs = {"head_number": H, "alpha": 1.0 / np.sqrt(D)}
    if layout == "packed_w":
        ins = {"Input": r.normal(size=(B, S, N)).astype(np.float32),
               "W": (r.normal(size=(N, 3, N)) / np.sqrt(N)).astype(
                   np.float32),
               "Bias": r.normal(size=(3, N)).astype(np.float32)}
    elif layout == "qkv3":
        ins = {"Input": r.normal(size=(B, S, 3 * N)).astype(np.float32)}
    else:
        ins = {"Input": r.normal(size=(B, S, 3, H, D)).astype(np.float32)}
    ins["BiasQK"] = _bias(bias_kind, r)
    with fa.interpret_guard():
        _run("multihead_matmul", ins, attrs)


def test_fused_attention_dropout_draws_from_generator():
    """Rate > 0 takes the kernel seed from the op's random key: the same
    key gives the same output, another key another one."""
    r = _r(9)
    q, k, v = (torch.from_numpy(r.normal(size=(B, S, H * D)).astype(
        np.float32)) for _ in range(3))
    kern = TOPS.get("fused_attention_qkv").kernel

    def run(seed):
        key = torch.tensor([seed], dtype=torch.int64)
        return kern({"Q": [q], "K": [k], "V": [v]},
                    {"num_heads": H, "dropout_rate": 0.3, "causal": False,
                     "_rng": lambda: key})["Out"][0]
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


# ------------------------------------------------ the dropout kernel module
@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_op_against_jax(impl):
    """The dropout op on a CPU tensor runs the plain version of
    ops/cuda/dropout.py: the counter-hash mask of ops/rng.py, no kernel
    launch. Against the TPU package's op on the same x: the masks are
    other bits (jax.random) with the same keep fraction, and where both
    keep, the outputs agree to 1e-5."""
    import jax
    from paddle_tpu_torch.ops import rng as trng
    from paddle_tpu_torch.ops.cuda import dropout as cuda_dropout
    x = _r(11).normal(size=(64, 256)).astype(np.float32)
    attrs = {"dropout_prob": 0.1, "dropout_implementation": impl}
    key = torch.tensor([12345], dtype=torch.int64)
    before = cuda_dropout.launch_count
    tout = TOPS.get("dropout").kernel(
        {"X": [torch.from_numpy(x)]}, dict(attrs, _rng=lambda: key))
    assert cuda_dropout.launch_count == before
    jout = JOPS.get("dropout").kernel(
        {"X": [jnp.asarray(x)]}, dict(attrs, _rng=jax.random.PRNGKey(3)))
    tm, jm = tout["Mask"][0].numpy(), np.asarray(jout["Mask"][0])
    assert np.array_equal(tm, trng.keep_mask(key, x.shape, 0.1).numpy())
    assert abs(tm.mean() - 0.9) < 0.01 and abs(jm.mean() - 0.9) < 0.01
    both = (tm == 1) & (jm == 1)
    np.testing.assert_allclose(tout["Out"][0].numpy()[both],
                               np.asarray(jout["Out"][0])[both],
                               rtol=TOL, atol=TOL)
    assert not tout["Out"][0].numpy()[tm == 0].any()


def test_dropout_kernel_wrapper_takes_cuda_tensors_only():
    from paddle_tpu_torch.ops.cuda import dropout as cuda_dropout
    x = torch.ones(8)
    key = torch.tensor([1], dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_dropout.dropout_cuda(x, key, 0.1, True)
    o, m = cuda_dropout.dropout(x, key, 0.1, True)
    ro, rm = cuda_dropout.dropout_reference(x, key, 0.1, True)
    assert torch.equal(o, ro) and torch.equal(m, rm)


def test_dropout_kernel_hashes_as_the_plain_version():
    """The kernel's hash (csrc/dropout.cu, `bits24`) has ops/rng.py's
    constants and shifts, in its order: the two draw the same bits."""
    import os
    import re
    from paddle_tpu_torch.ops import rng as trng
    from paddle_tpu_torch.ops.cuda import build
    src = open(os.path.join(build.CSRC, "dropout.cu")).read()
    consts = dict(re.findall(r"constexpr uint32_t (C\d) = (0x[0-9A-F]+)u;",
                             src))
    assert int(consts["C1"], 16) == trng._C1
    assert int(consts["C2"], 16) == trng._C2
    body = src[src.index("uint32_t bits24("):]
    body = body[:body.index("}")]
    assert "uint32_t x = i ^ key;" in body
    steps = re.findall(r"x (\^|\*)= (key|x >> \d+|C\d)|return x >> (\d+)",
                       body)
    assert steps == [("^", "x >> 16", ""), ("*", "C1", ""),
                     ("^", "key", ""), ("^", "x >> 15", ""),
                     ("*", "C2", ""), ("^", "x >> 15", ""), ("", "", "8")]
