"""The numerics and the interface of the tensor-core flash kernels, on the CPU.

The forward, dK/dV and dQ kernels (paddle_tpu_torch/ops/cuda/csrc/) run
their f32 products as split TF32: each operand x becomes hi = tf32(x) and
lo = tf32(x - hi), and a product is lo·hi + hi·lo + hi·hi, each term on
the tensor cores with f32 sums. Here a torch emulation of that rounding
(cvt.rna.tf32.f32: round to nearest, ties away from zero, on the low 13
mantissa bits) shows, at the BERT-base shapes and from a numpy seed, why:
the three-term products QKᵀ, PV, dQ = dS·K, dV = P′ᵀ·dO and dK = dSᵀ·Q
stay within chip_smoke.py's F32_TOL of the f32 products, and one-term TF32
QKᵀ, dS·K, P′ᵀ·dO and dSᵀ·Q do not.

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
TRAIN_B = 32                 # and at the trained batch
SEED = 3141
DQ_SEED = 1234               # the dropout mask's seed


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


@pytest.fixture(scope="module")
def bert_train_operands():
    """q, k, v, dO and the key-padding bias at the training shape (batch
    32), from a numpy seed."""
    r = np.random.RandomState(SEED + 1)
    q, k, v, do = (torch.from_numpy(
        r.normal(size=(TRAIN_B, H, S, D)).astype(np.float32))
        for _ in range(4))
    bias = np.zeros((TRAIN_B, S), np.float32)
    for i in range(TRAIN_B):
        bias[i, r.randint(S // 4, S + 1):] = -1e9
    return q, k, v, do, torch.from_numpy(bias)


def _dq_chain(operands, rate):
    """(dS, lse, delta, the plain f32 dQ) of the plain backward at dropout
    ``rate``, the forward's lse and O from the plain forward."""
    q, k, v, do, bias = operands
    o, lse = tfa.flash_attention_reference(q, k, v, D ** -0.5, False, rate,
                                           DQ_SEED, bias)
    delta = tfa.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, D ** -0.5, False, rate, DQ_SEED, bias)
    _, ds = tfa._bwd_probs(*args)
    return ds, lse, delta, tfa.flash_attention_bwd_q_reference(*args)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_three_term_dq_within_f32_tol_and_one_term_not(bert_train_operands,
                                                       rate):
    """dQ = dS·K as the dQ kernel's last product computes it, at the
    training shape, with dropout 0 and 0.1 (dS carries keep_mask's mask
    and 1/(1 - rate)): split TF32 within F32_TOL of the plain f32 dQ, one
    TF32 product not."""
    k = bert_train_operands[1]
    ds, _, _, want = _dq_chain(bert_train_operands, rate)
    assert _close(split_tf32_matmul(ds, k), want)
    one_term = tf32(ds) @ tf32(k)
    assert not _close(one_term, want)
    err1 = (one_term - want).abs().max().item()
    err3 = (split_tf32_matmul(ds, k) - want).abs().max().item()
    assert err1 > 50 * err3


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_three_term_dq_chain_matches_the_plain_version(bert_train_operands,
                                                       rate):
    """The whole dQ kernel with every product in split TF32: S = QKᵀ and
    dP = dO·Vᵀ recomputed, dS = P∘(dP′ − delta)·scale with dropout as a
    multiply by 1/(1 - rate), then dS·K; within F32_TOL of the plain f32
    dQ, as chip_smoke.py holds the kernel."""
    q, k, v, do, bias = bert_train_operands
    _, lse, delta, want = _dq_chain(bert_train_operands, rate)
    s = split_tf32_matmul(q, k.transpose(-1, -2)) * D ** -0.5 \
        + torch.clamp(bias, min=tfa.NEG_INF)[:, None, None, :]
    p = torch.exp(s - lse.reshape(TRAIN_B, H, S, 1))
    dp = split_tf32_matmul(do, v.transpose(-1, -2))
    if rate:
        keep = tfa.keep_mask(DQ_SEED,
                             torch.arange(TRAIN_B * H).reshape(TRAIN_B, H, 1,
                                                               1),
                             torch.arange(S)[:, None],
                             torch.arange(S)[None, :], rate)
        dp = dp * keep.to(dp.dtype) * (1.0 / (1.0 - rate))
    ds = p * (dp - delta.reshape(TRAIN_B, H, S, 1)) * D ** -0.5
    assert _close(split_tf32_matmul(ds, k), want)


def _dkdv_chain(operands, rate):
    """(P′, dS, the plain f32 dK and dV) of the plain backward at dropout
    ``rate``, the forward's lse and O from the plain forward."""
    q, k, v, do, bias = operands
    o, lse = tfa.flash_attention_reference(q, k, v, D ** -0.5, False, rate,
                                           DQ_SEED, bias)
    delta = tfa.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, D ** -0.5, False, rate, DQ_SEED, bias)
    p_eff, ds = tfa._bwd_probs(*args)
    dk, dv = tfa.flash_attention_bwd_kv_reference(*args)
    return p_eff, ds, dk, dv


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_three_term_dv_dk_within_f32_tol_and_one_term_not(
        bert_train_operands, rate):
    """dV = P′ᵀ·dO and dK = dSᵀ·Q as the f32 dK/dV kernel's last two
    products compute them, at the training shape, with dropout 0 and 0.1:
    split TF32 within F32_TOL of the plain f32 products, one TF32 product
    not."""
    q, _, _, do, _ = bert_train_operands
    p_eff, ds, dk, dv = _dkdv_chain(bert_train_operands, rate)
    for name, a, b, want in (("dV", p_eff.transpose(-1, -2), do, dv),
                             ("dK", ds.transpose(-1, -2), q, dk)):
        three = split_tf32_matmul(a, b)
        assert _close(three, want), name
        one_term = tf32(a) @ tf32(b)
        assert not _close(one_term, want), name
        err1 = (one_term - want).abs().max().item()
        err3 = (three - want).abs().max().item()
        assert err1 > 50 * err3, name


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_three_term_dkdv_chain_matches_the_plain_version(bert_train_operands,
                                                         rate):
    """The whole f32 dK/dV kernel with every product in split TF32: Sᵀ =
    K·Qᵀ and dPᵀ = V·dOᵀ recomputed key-major, P′ᵀ and dSᵀ with dropout as
    a multiply by 1/(1 - rate), then dV = P′ᵀ·dO and dK = dSᵀ·Q; within
    F32_TOL of the plain f32 dK and dV, as chip_smoke.py holds the
    kernel."""
    q, k, v, do, bias = bert_train_operands
    o, lse = tfa.flash_attention_reference(q, k, v, D ** -0.5, False, rate,
                                           DQ_SEED, bias)
    delta = tfa.bwd_delta(o, do)
    _, _, want_dk, want_dv = _dkdv_chain(bert_train_operands, rate)
    st = split_tf32_matmul(k, q.transpose(-1, -2)) * D ** -0.5 \
        + torch.clamp(bias, min=tfa.NEG_INF)[:, None, :, None]
    pt = torch.exp(st - lse.reshape(TRAIN_B, H, 1, S))
    dpt = split_tf32_matmul(v, do.transpose(-1, -2))
    pe = pt
    if rate:
        keep = tfa.keep_mask(DQ_SEED,
                             torch.arange(TRAIN_B * H).reshape(TRAIN_B, H, 1,
                                                               1),
                             torch.arange(S)[None, :],
                             torch.arange(S)[:, None], rate).to(pt.dtype)
        pe = pt * keep * (1.0 / (1.0 - rate))
        dpt = dpt * keep * (1.0 / (1.0 - rate))
    dst = pt * (dpt - delta.reshape(TRAIN_B, H, 1, S)) * D ** -0.5
    assert _close(split_tf32_matmul(pe, do), want_dv)
    assert _close(split_tf32_matmul(dst, q), want_dk)


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
    ("_bwd_bound", (32, 12, 128, 128, 64, 8, "kv", "bfloat16"), 0.0114,
     "bytes"),
    ("_bwd_bound", (32, 12, 128, 128, 64, 6, "q", "bfloat16"), 0.0095,
     "bytes"),
    # the whole backward reads q, k, v, O, dO and lse: 8 tensors of q's
    # size moved, 100,876,288 B in f32
    ("_bwd_bound", (32, 12, 128, 128, 64, 10, "qkv"), 0.0301, "bytes"),
    ("_bwd_bound", (32, 12, 128, 128, 64, 10, "qkv", "bfloat16"), 0.0151,
     "bytes"),
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


def test_dq_bounds_worked_by_hand():
    """The dQ rows' bounds from their parts, at B=32 H=12 S=Sk=128 D=64:
    q, k, v and dO are 32·12·128·64 = 3,145,728 values each; lse and delta
    2 · 49,152 f32; the bias 32·128 f32; dQ one more of q's size. Dropout
    adds no byte the bound counts (the seed is one int32), so the dropout
    row's bound is the f32 row's."""
    n = 32 * 12 * 128 * 64
    rowstats = 2 * 32 * 12 * 128 * 4 + 32 * 128 * 4
    f32 = chip_smoke._bwd_bound(32, 12, 128, 128, 64, 6, "q")
    assert f32[3] == 5 * n * 4 + rowstats == 63_324_160  # the header's 63.3 MB
    assert f32[2] == 6 * 32 * 12 * 128 * 128 * 64 == 2_415_919_104
    assert round(3 * f32[2] / 495e12 * 1e3, 4) == 0.0146  # split-TF32 time
    assert round(f32[3] / 3.35e12 * 1e3, 4) == 0.0189
    bf16 = chip_smoke._bwd_bound(32, 12, 128, 128, 64, 6, "q", "bfloat16")
    assert bf16[3] == 5 * n * 2 + rowstats == 31_866_880
    assert round(bf16[2] / 989e12 * 1e3, 4) == 0.0024
    kv = chip_smoke._bwd_bound(32, 12, 128, 128, 64, 8, "kv", "bfloat16")
    assert kv[3] == 6 * n * 2 + rowstats == 38_158_336


def test_no_cuda_core_product_loop_remains():
    """Every product of the three kernels runs on the tensor cores: no
    source under csrc/ keeps the CUDA-core tile product, its staging or a
    scalar fmaf loop; the dQ kernel takes its K/V tiles by cp.async and
    its products from tc_common.cuh."""
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name)) as f:
            text = f.read()
        assert not re.search(r"\b(tile_dot|load_tile|fmaf)\b", text), name
    with open(os.path.join(CSRC, tfa.BWD_KERNEL_SOURCE)) as f:
        text = f.read()
    body = text[text.index("flash_bwd_q_kernel("):
                text.index("struct BwdArgs")]
    for call in ("tc::copy_tile_async", "tc::cp_async_wait<1>", "tc::mma",
                 "tc::a_from_acc", "tc::load_b_kn", "tc::load_b_nk"):
        assert call in body, call


def test_ptxas_report_names_each_kernel_instance():
    """chip_smoke.py's [build] lines: the kernel, dtype, head dim,
    registers and spills of each instance, from nvcc -Xptxas -v output
    whose entry names carry the anonymous namespace's per-file prefix."""
    text = (
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__flash_"
        "attention_bwd_cu_56a507fd18flash_bwd_q_kernelIfLi64EEEvPKT_' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _ZN45_GLOBAL__N__flash_"
        "attention_bwd_cu_56a507fd18flash_bwd_q_kernelIfLi64EEEvPKT_\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 124 registers, used 1 barriers, 460 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__flash_"
        "attention_bwd_cu_56a507fd19flash_bwd_kv_kernelI13__nv_bfloat16Li8EE"
        "EvPKT_' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n")
    assert chip_smoke.ptxas_report(text) == [
        ("flash_bwd_q_kernel", "f32", 64, 124, 0, 0),
        ("flash_bwd_kv_kernel", "bf16", 8, 96, 8, 12)]
