"""The BERT encoder slice of paddle_tpu_torch against the TPU package.

Both packages build the same tiny-config encoder program (vocab 128,
hidden 32, 2 layers, 4 heads, ffn 64, S=16, B=2, padding input_mask); the
programs must agree op for op. The TPU package's startup parameters are
carried into the port's scope with set_params_from_numpy, and both
Executor.run calls on one feed must agree at rtol = atol = 1e-4 (the
golden-trajectory tolerance of tests/test_book_models.py), with the JAX
side's attention both through the Pallas interpreter and not. Also: the
port's own startup distributions, its import hygiene, and that its
Executor never falls back to the CPU on its own."""
import ast
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import bert as tbert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=128, hidden=32, layers=2, heads=4, ffn=64, max_len=16,
           type_vocab=2)
S, B = 16, 2
TOL = 1e-4


def _build(fluid, bert):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = fluid.data("src_ids", [S], dtype="int64")
        pos = fluid.data("pos_ids", [S], dtype="int64")
        sent = fluid.data("sent_ids", [S], dtype="int64")
        mask = fluid.data("input_mask", [S], dtype="float32")
        bias = bert.padding_attn_bias(mask)
        x = bert.bert_embedding(src, pos, sent, CFG)
        enc = bert.encoder(x, CFG["layers"], CFG["hidden"], CFG["heads"],
                           CFG["ffn"], attn_bias=bias)
    startup.random_seed = 11
    return main, startup, enc


def _feed(seed=0):
    r = np.random.RandomState(seed)
    mask = np.ones((B, S), np.float32)
    mask[0, 11:] = 0.0
    mask[1, 5:] = 0.0
    return {"src_ids": r.randint(0, CFG["vocab_size"], (B, S)),
            "pos_ids": np.tile(np.arange(S), (B, 1)),
            "sent_ids": r.randint(0, CFG["type_vocab"], (B, S)),
            "input_mask": mask}


def _canonical(program):
    """Ops as (type, slots, attrs) with non-parameter var names replaced by
    their order of first appearance (temp-name counters differ between
    processes); parameters and data vars keep their names."""
    block = program.global_block()
    ids = {}

    def name(n):
        v = block.vars.get(n)
        if v is not None and (v.persistable or v.is_data):
            return n
        return ids.setdefault(n, f"t{len(ids)}")

    ops = []
    for op in block.ops:
        ops.append((op.type,
                    {s: [name(n) for n in ns] for s, ns in op.inputs.items()},
                    {s: [name(n) for n in ns] for s, ns in op.outputs.items()},
                    {k: v for k, v in op.attrs.items()
                     if not k.startswith("_")}))
    params = {v.name: (tuple(v.shape), v.dtype, v.persistable)
              for v in block.vars.values() if v.persistable or v.is_data}
    return ops, params


def test_programs_are_identical():
    jm, js, jenc = _build(jfluid, jbert)
    tm, ts, tenc = _build(tfluid, tbert)
    for jp, tp in ((jm, tm), (js, ts)):
        jops, jparams = _canonical(jp)
        tops, tparams = _canonical(tp)
        assert [o[0] for o in jops] == [o[0] for o in tops]
        for jo, to in zip(jops, tops):
            assert jo == to, (jo, to)
        assert jparams == tparams
    assert {op.type for op in tm.global_block().ops} == {
        "lookup_table_v2", "elementwise_add", "layer_norm", "mul", "scale",
        "unsqueeze2", "gelu", "fused_attention_qkv"}
    assert jenc.shape == tenc.shape == (-1, S, CFG["hidden"])


def _jax_params(jm, js):
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(js, scope=scope)
    return scope, exe, {
        v.name: np.asarray(scope.find_var(v.name).get_tensor())
        for v in jm.global_block().vars.values() if v.persistable}


@pytest.mark.parametrize("interpret", [True, False])
def test_encoder_matches_reference(interpret):
    jm, js, jenc = _build(jfluid, jbert)
    tm, ts, tenc = _build(tfluid, tbert)
    jscope, jexe, arrays = _jax_params(jm, js)
    assert len(arrays) == len(tm.all_parameters()) == 3 + 2 + 2 * 16
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.run(ts, scope=tscope)
    set_params_from_numpy(tscope, arrays, tfluid.CPUPlace())
    feed = _feed()
    if interpret:
        with fa.interpret_guard():
            jout, = jexe.run(jm, feed=feed, fetch_list=[jenc], scope=jscope)
    else:
        jout, = jexe.run(jm, feed=feed, fetch_list=[jenc], scope=jscope)
    tout, = texe.run(tm, feed=feed, fetch_list=[tenc], scope=tscope)
    assert tout.shape == (B, S, CFG["hidden"]) and tout.dtype == np.float32
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)


def test_set_params_from_numpy_rejects_mismatches():
    tm, ts, _ = _build(tfluid, tbert)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(ts, scope=scope)
    w = scope.find_var("word_embedding").value().array
    good = np.ones(tuple(w.shape), np.float32)
    with pytest.raises(KeyError, match="no_such_param"):
        set_params_from_numpy(scope, {"word_embedding": good,
                                      "no_such_param": good})
    with pytest.raises(ValueError, match="shape"):
        set_params_from_numpy(scope, {"word_embedding": good[:3]})
    with pytest.raises(TypeError, match="dtype"):
        set_params_from_numpy(scope, {"word_embedding": good.astype(
            np.float64)})
    # a rejected call writes nothing
    assert not torch.equal(scope.find_var("word_embedding").value().array,
                           torch.ones_like(w))
    set_params_from_numpy(scope, {"word_embedding": good})
    assert torch.equal(scope.find_var("word_embedding").value().array,
                       torch.ones_like(w))


def test_own_startup_distributions():
    tm, ts, _ = _build(tfluid, tbert)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope, scope2 = tfluid.Scope(), tfluid.Scope()
    exe.run(ts, scope=scope)
    exe.run(ts, scope=scope2)
    get = lambda sc, n: sc.find_var(n).value().array.numpy()  # noqa: E731
    n_fc = 0
    for p in tm.all_parameters():
        a = get(scope, p.name)
        assert a.shape == tuple(p.shape) and a.dtype == np.float32
        # a fresh scope replays the same steps: same values
        np.testing.assert_array_equal(a, get(scope2, p.name))
        if p.name.endswith("_embedding"):
            # truncated normal, scale 0.02, cut at 2σ
            assert np.abs(a).max() <= 0.04 + 1e-7
            if a.size >= 4096:  # std of N(0,1) cut at ±2 is 0.8796
                assert abs(a.std() - 0.02 * 0.8796) < 0.0015
        elif p.name.startswith("layer_norm") and ".w_" in p.name:
            assert (a == 1.0).all()
        elif ".b_" in p.name:
            assert (a == 0.0).all()
        else:  # fc weight: Xavier uniform
            n_fc += 1
            limit = math.sqrt(6.0 / (a.shape[0] + a.shape[1]))
            assert np.abs(a).max() <= limit
            assert np.abs(a).max() > 0.9 * limit
            assert abs(a.mean()) < 0.1 * limit
    assert n_fc == 6 * CFG["layers"]
    # another seed gives other weights
    ts.random_seed = 12
    exe.run(ts, scope=scope2)
    assert not np.array_equal(get(scope, "word_embedding"),
                              get(scope2, "word_embedding"))


def test_executor_input_errors():
    tm, ts, tenc = _build(tfluid, tbert)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with pytest.raises(RuntimeError, match="startup"):
        exe.run(tm, feed=_feed(), fetch_list=[tenc], scope=scope)
    exe.run(ts, scope=scope)
    feed = _feed()
    del feed["input_mask"]
    with pytest.raises(KeyError, match="input_mask"):
        exe.run(tm, feed=feed, fetch_list=[tenc], scope=scope)


def test_executor_without_place_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default place resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfluid.Executor(tfluid.CUDAPlace(0))


def _port_files():
    root = os.path.join(REPO, "paddle_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_or_reference():
    banned = ("jax", "jaxlib", "paddle_tpu")
    bad = []
    files = _port_files()
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in banned:
                    bad.append(f"{os.path.relpath(path, REPO)}: {n}")
    assert not bad, bad


def test_port_import_leaves_jax_unloaded():
    code = ("import sys; import paddle_tpu_torch.fluid, "
            "paddle_tpu_torch.models.bert; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
