"""The numerics and the interface of the tensor-core flash kernels, on the CPU.

The forward and the dK/dV kernels (paddle_tpu_torch/ops/cuda/csrc/) run
their f32 products as split TF32: each operand x becomes hi = tf32(x) and
lo = tf32(x - hi), and a product is lo·hi + hi·lo + hi·hi, each term on
the tensor cores with f32 sums. Here a torch emulation of that rounding
(cvt.rna.tf32.f32: round to nearest, ties away from zero, on the low 13
mantissa bits) shows, at the BERT-base shape and from a numpy seed, why:
the three-term products QKᵀ and PV stay within chip_smoke.py's F32_TOL of
the f32 products, and a one-term TF32 QKᵀ does not.

Also held here, since no CUDA compiler runs on the CPU: each kernel
source's ``extern "C"`` prototypes against the ctypes signatures the
wrapper declares, and chip_smoke.py's bound arithmetic against the figures
PERF.md quotes (NVIDIA H100 SXM: 3.35 TB/s, 495 TFLOP/s TF32, 989 TFLOP/s
bf16)."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

CSRC = os.path.join(os.path.dirname(os.path.abspath(tfa.__file__)), "csrc")
B, H, S, D = 8, 12, 128, 64  # BERT-base at the served batch
SEED = 3141


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (10 mantissa bits), ties away from
    zero: add half of the dropped range to the magnitude bits, clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_matmul(a, b):
    """a @ b as the kernels compute it: lo·hi + hi·lo + hi·hi, each term a
    product of TF32 values summed in f32."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _close(x, y):
    tol = chip_smoke.F32_TOL
    return torch.allclose(x, y, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def bert_operands():
    r = np.random.RandomState(SEED)
    q, k, v = (torch.from_numpy(r.normal(size=(B, H, S, D)).astype(np.float32))
               for _ in range(3))
    bias = np.zeros((B, S), np.float32)
    for i in range(B):
        bias[i, r.randint(S // 4, S + 1):] = -1e9
    return q, k, v, torch.from_numpy(bias)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -11), 3.0e-3], dtype=torch.float32)
    got = tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0 + 2 ** -10
    assert got[2] == 1.0 + 2 ** -10      # a tie rounds away from zero
    assert got[3] == 1.0                 # below half an ulp rounds down
    assert got[4] == -(1.0 + 2 ** -9)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((got - x).abs() <= x.abs() * 2 ** -11).all()


def test_split_tf32_is_exact_to_22_bits():
    r = np.random.RandomState(SEED)
    x = torch.from_numpy(r.normal(size=4096).astype(np.float32))
    hi = tf32(x)
    lo = tf32(x - hi)
    assert ((hi + lo - x).abs() <= x.abs() * 2 ** -21).all()


def test_three_term_qk_within_f32_tol_and_one_term_not(bert_operands):
    q, k, _, _ = bert_operands
    kt = k.transpose(-1, -2)
    want = q @ kt
    assert _close(split_tf32_matmul(q, kt), want)
    one_term = tf32(q) @ tf32(kt)
    assert not _close(one_term, want)
    # the one-term error is the operands' rounding, 2^-11 of each, summed
    # over D = 64 products: orders of magnitude above the three-term one
    err1 = (one_term - want).abs().max().item()
    err3 = (split_tf32_matmul(q, kt) - want).abs().max().item()
    assert err1 > 50 * err3


def test_three_term_pv_within_f32_tol(bert_operands):
    q, k, v, bias = bert_operands
    s = (q @ k.transpose(-1, -2)) * D ** -0.5 + bias[:, None, None, :]
    p = torch.exp(s - s.amax(-1, keepdim=True))  # P in [0, 1], as the kernel
    want = p @ v
    assert _close(split_tf32_matmul(p, v), want)


def test_three_term_attention_matches_the_plain_version(bert_operands):
    """The whole forward with every product in split TF32 against the plain
    version's f32: O within F32_TOL, as chip_smoke.py holds the kernel."""
    q, k, v, bias = bert_operands
    o_ref, _ = tfa.flash_attention_reference(q, k, v, D ** -0.5, bias=bias)
    s = split_tf32_matmul(q, k.transpose(-1, -2)) * D ** -0.5 \
        + torch.clamp(bias, min=tfa.NEG_INF)[:, None, None, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    o = split_tf32_matmul(p, v) / p.sum(-1, keepdim=True)
    assert _close(o, o_ref)


# --------------------------------------------------------------------------
# the C interface: prototypes against the wrapper's ctypes signatures
# --------------------------------------------------------------------------
_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float,
           "unsigned int": ctypes.c_uint32}


def _extern_c_prototypes(source):
    """{name: (return type, [ctypes of each parameter])} of the functions
    defined in the source's extern "C" block."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    block = text[text.index('extern "C" {'):]
    protos = {}
    for ret, name, params in re.findall(
            r"^(int|const char\*)\s+(\w+)\(([^)]*)\)\s*\{", block, re.M):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            ctype = re.sub(r"\s*\b\w+$", "", p).replace(" *", "*")
            types.append(_CTYPES[ctype])
        protos[name] = (ret, types)
    return protos


@pytest.mark.parametrize("source", sorted(tfa._SIGNATURES))
def test_extern_c_prototypes_match_the_wrapper(source):
    protos = _extern_c_prototypes(source)
    want = tfa._SIGNATURES[source]
    assert set(protos) == set(want) | {"paddle_cuda_error_string"}
    for name, argtypes in want.items():
        ret, got = protos[name]
        assert ret == "int", name
        assert got == argtypes, name
    assert protos["paddle_cuda_error_string"] == ("const char*",
                                                  [ctypes.c_int])


@pytest.mark.parametrize("source", sorted(tfa._SIGNATURES))
def test_kernel_sources_include_only_headers_of_the_package(source):
    with open(os.path.join(CSRC, source)) as f:
        local = re.findall(r'^#include "([^"]+)"', f.read(), re.M)
    assert "tc_common.cuh" in local
    for name in local:
        assert os.path.exists(os.path.join(CSRC, name)), name


# --------------------------------------------------------------------------
# chip_smoke.py's bounds: bytes over 3.35 TB/s, f32 work as split TF32
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fn,args,ms,by", [
    ("fwd_bound", (8, 12, 128, 128, 64, "float32"), 0.0038, "bytes"),
    ("fwd_bound", (32, 12, 128, 128, 64, "float32"), 0.0151, "bytes"),
    ("fwd_bound", (8, 12, 128, 128, 64, "bfloat16"), 0.0019, "bytes"),
    ("_bwd_bound", (32, 12, 128, 128, 64, 8, "kv"), 0.0227, "bytes"),
    ("_bwd_bound", (32, 12, 128, 128, 64, 6, "q"), 0.0189, "bytes"),
])
def test_chip_smoke_bounds(fn, args, ms, by):
    bound_ms, bound_by, flop, nbytes = getattr(chip_smoke, fn)(*args)
    assert round(bound_ms, 4) == ms and bound_by == by
    assert bound_ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_chip_smoke_f32_rate_is_split_tf32():
    # 3·F over 495 TFLOP/s: 0.0024 ms for the served forward, 0.0195 ms for
    # dK/dV at batch 32; each under its bytes time, so bytes bound both
    flop = chip_smoke.fwd_bound(8, 12, 128, 128, 64, "float32")[2]
    assert round(3 * flop / 495e12 * 1e3, 4) == 0.0024
    flop = chip_smoke._bwd_bound(32, 12, 128, 128, 64, 8, "kv")[2]
    assert round(3 * flop / 495e12 * 1e3, 4) == 0.0195
    assert chip_smoke.bound(flop, 0, "float32") == (
        pytest.approx(3 * flop / 495e12 * 1e3), "operations")
    assert chip_smoke.bound(flop, 0, "bfloat16")[0] == pytest.approx(
        flop / 989e12 * 1e3)
