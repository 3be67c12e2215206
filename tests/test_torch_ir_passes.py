"""The port's pass system (paddle_tpu_torch/fluid/ir.py) against the TPU
package's, pass by pass, on the programs tests/test_ir_passes.py builds:
fc (:72), simplify + identity scale (:87), conv_bn (:175),
conv_eltwiseadd_bn (:199), fc_elementwise_layernorm (:232, :301),
embedding (:268, :318, :380), quant (:413), multihead (:596-706),
protected fetches (:327) and the pipeline (:538).

Each program is built by both packages under the same names, the port's
scope takes the TPU package's startup values, and after the pass: the op
types are the same sequence, the folded or packed weights are equal, and
the outputs match the unrewritten program and the TPU package's at the
JAX test's tolerance.
"""
import numpy as np
import pytest

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid import ir as jir
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import ir as tir
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.ops import attention_ops as tattention_ops


@pytest.fixture(autouse=True)
def _fresh_tmp_names(monkeypatch):
    """Both packages name temporaries from a process-wide counter that
    ``unique_name.guard`` does not reset: start both from zero."""
    from paddle_tpu.fluid import unique_name as jnames
    from paddle_tpu_torch.fluid import unique_name as tnames
    for m in (jnames, tnames):
        monkeypatch.setattr(m, "dygraph_parameter_name_generator",
                            m.UniqueNameGenerator())


class _Side:
    def __init__(self, fluid, ir, main, scope, out):
        self.fluid, self.ir = fluid, ir
        self.main, self.scope, self.out = main, scope, out

    def run(self, feed, fetch=None, program=None):
        fetch = fetch or [self.out]
        names = [f if isinstance(f, str) else f.name for f in fetch]
        program = program or self.main
        if self.fluid is tfluid:
            exe = tfluid.Executor(tfluid.CPUPlace())
            return exe.run(program, feed=feed, fetch_list=names,
                           scope=self.scope)
        with jfluid.scope_guard(self.scope):
            return [np.asarray(a) for a in jfluid.Executor().run(
                program, feed=feed, fetch_list=names)]

    def apply(self, passes, protected=(), scope=True):
        pm = self.ir.PassManager(passes, self.scope if scope else None)
        return pm.apply(self.main, protected=list(protected))

    def types(self, program=None):
        return [op.type for op in (program or self.main).global_block().ops]

    def get(self, name):
        v = self.scope.find_var(name)
        if v is None:
            return None
        if self.fluid is tfluid:
            return v.value().numpy()
        return np.asarray(v.get_tensor().array)

    def set(self, name, arr):
        if self.fluid is tfluid:
            set_params_from_numpy(self.scope, {name: arr})
        else:
            self.scope.find_var(name).get_tensor().set(arr)


def _pair(build):
    """``build(fluid)`` in both packages; the port's persistables take the
    TPU package's startup values."""
    jm, js = jfluid.Program(), jfluid.Program()
    with jfluid.unique_name.guard(), jfluid.program_guard(jm, js):
        jout = build(jfluid)
    jscope = jcore.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor().run(js)
    tm, ts = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(tm, ts):
        tout = build(tfluid)
    tscope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(ts, scope=tscope)
    set_params_from_numpy(tscope, {
        v.name: np.asarray(jscope.find_var(v.name).get_tensor().array)
        for v in tm.list_vars()
        if v.persistable and tscope.find_var(v.name) is not None})
    j = _Side(jfluid, jir, jm, jscope, jout)
    t = _Side(tfluid, tir, tm, tscope, tout)
    assert t.types() == j.types()
    return j, t


def _check(j, t, feed, passes, rtol, atol, protected=(), jprog=None,
           tprog=None):
    """Outputs before, the passes in both packages, then: the same op
    types, and the outputs within (rtol, atol) of before and of the TPU
    package's."""
    before = t.run(feed)[0]
    np.testing.assert_allclose(before, j.run(feed)[0], rtol=rtol, atol=atol)
    jp = jprog or j.apply(passes, protected)
    tp = tprog or t.apply(passes, protected)
    assert t.types(tp) == j.types(jp)
    after = t.run(feed, program=tp)[0]
    np.testing.assert_allclose(after, before, rtol=rtol, atol=atol)
    np.testing.assert_allclose(after, j.run(feed, program=jp)[0],
                               rtol=rtol, atol=atol)
    return t.types(tp)


# ------------------------------------------------------------------ fc
def test_fc_fuse_pass():
    j, t = _pair(lambda f: f.layers.fc(
        f.data("x", shape=[4], dtype="float32"), 3, act="relu"))
    x = np.random.RandomState(0).rand(2, 4).astype("float32")
    types = _check(j, t, {"x": x}, ["fc_fuse_pass"], 1e-6, 1e-6)
    assert "fc" in types and "mul" not in types and "relu" not in types


def test_protected_fetch_is_not_fused():
    """A fetched intermediate survives: fc_fuse_pass does not absorb the
    relu when the fc's pre-activation output is protected."""
    def build(f):
        h = f.layers.fc(f.data("x", shape=[4], dtype="float32"), 3)
        return h, f.layers.relu(h)
    j, t = _pair(build)
    mid = t.out[0].name
    x = np.random.RandomState(1).rand(2, 4).astype("float32")
    for side in (j, t):
        side.out = side.out[1]
    types = _check(j, t, {"x": x}, ["fc_fuse_pass"], 1e-6, 1e-6,
                   protected=[mid])
    assert types == ["fc", "relu"]
    np.testing.assert_allclose(t.run({"x": x}, [mid])[0],
                               j.run({"x": x}, [mid])[0], rtol=1e-6)
    _, t2 = _pair(build)  # without protection the relu is absorbed
    assert t2.types(t2.apply(["fc_fuse_pass"])) == ["fc"]


# -------------------------------------------- dropout, identity scale
def test_simplify_and_identity_scale_clean():
    def build(f):
        x = f.data("x", shape=[4], dtype="float32")
        h = f.layers.dropout(x, dropout_prob=0.3)
        h = f.layers.scale(h, scale=1.0, bias=0.0)
        return f.layers.scale(h, scale=2.0)
    j, t = _pair(build)
    x = np.random.RandomState(1).rand(2, 4).astype("float32")
    passes = ["is_test_pass", "simplify_with_basic_ops_pass",
              "identity_scale_op_clean_pass"]
    jp, tp = j.apply(passes), t.apply(passes)
    assert t.types(tp) == j.types(jp) == ["scale", "scale"]
    got = t.run({"x": x}, program=tp)[0]
    np.testing.assert_allclose(got, x * 0.7 * 2.0, rtol=1e-6)
    np.testing.assert_allclose(got, j.run({"x": x}, program=jp)[0],
                               rtol=1e-6)


def test_simplify_upscale_in_train_becomes_assign():
    def build(f):
        x = f.data("x", shape=[4], dtype="float32")
        return f.layers.dropout(x, dropout_prob=0.3,
                                dropout_implementation="upscale_in_train")
    j, t = _pair(build)
    x = np.random.RandomState(2).rand(2, 4).astype("float32")
    passes = ["is_test_pass", "simplify_with_basic_ops_pass"]
    jp, tp = j.apply(passes), t.apply(passes)
    assert t.types(tp) == j.types(jp) == ["assign"]
    np.testing.assert_array_equal(t.run({"x": x}, program=tp)[0], x)


def test_identity_scale_clean_keeps_zero_scale():
    def build(f):
        x = f.data("x", shape=[4], dtype="float32")
        h = f.layers.scale(x, scale=0.0, bias=0.0)
        return f.layers.elementwise_add(h, h)
    j, t = _pair(build)
    x = np.random.RandomState(10).rand(2, 4).astype("float32")
    types = _check(j, t, {"x": x}, ["identity_scale_op_clean_pass"], 1e-6,
                   1e-6)
    assert "scale" in types


# ------------------------------------------------------------ conv + bn
def _set_bn_stats(sides, rng, c):
    mean, var = rng.rand(c).astype("float32") * 0.5, \
        rng.rand(c).astype("float32") + 0.5
    for s in sides:
        bn = [op for op in s.main.global_block().ops
              if op.type == "batch_norm"][0]
        s.set(bn.input("Mean")[0], mean)
        s.set(bn.input("Variance")[0], var)


def _folded(sides):
    """The folded filter and bias of each side's conv2d_fusion."""
    res = []
    for s in sides:
        op = [o for o in s.main.global_block().ops
              if o.type == "conv2d_fusion"][0]
        res.append((s.get(op.input("Filter")[0]), s.get(op.input("Bias")[0])))
    return res


def test_conv_bn_fuse_pass():
    def build(f):
        img = f.data("img", shape=[3, 8, 8], dtype="float32")
        c = f.layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                            bias_attr=False)
        return f.layers.batch_norm(c, is_test=True)
    j, t = _pair(build)
    rng = np.random.RandomState(3)
    _set_bn_stats((j, t), rng, 4)
    x = rng.randn(2, 3, 8, 8).astype("float32")
    types = _check(j, t, {"img": x}, ["conv_bn_fuse_pass"], 1e-4, 1e-5)
    assert "batch_norm" not in types and "conv2d_fusion" in types
    (jw, jb), (tw, tb) = _folded((j, t))
    assert tw.tobytes() == jw.tobytes() and tb.tobytes() == jb.tobytes()


def test_conv_eltwiseadd_bn_fuse_pass():
    def build(f):
        img = f.data("img", shape=[3, 6, 6], dtype="float32")
        c = f.layers.conv2d(img, num_filters=2, filter_size=3,
                            bias_attr=True)
        return f.layers.batch_norm(c, is_test=True)
    j, t = _pair(build)
    rng = np.random.RandomState(4)
    _set_bn_stats((j, t), rng, 2)
    adds = [op for op in t.main.global_block().ops
            if op.type == "elementwise_add"]
    if adds:
        b = rng.rand(2).astype("float32")
        for s in (j, t):
            s.set(adds[0].input("Y")[0], b)
    x = rng.randn(2, 3, 6, 6).astype("float32")
    passes = ["conv_eltwiseadd_bn_fuse_pass", "conv_bn_fuse_pass"]
    types = _check(j, t, {"img": x}, passes, 1e-4, 1e-5)
    assert "batch_norm" not in types
    (jw, jb), (tw, tb) = _folded((j, t))
    assert tw.tobytes() == jw.tobytes() and tb.tobytes() == jb.tobytes()


# ------------------------------------------------- transformer fusions
def test_fc_elementwise_layernorm_fuse():
    def build(f):
        x = f.data("x", shape=[8], dtype="float32")
        res = f.data("res", shape=[6], dtype="float32")
        h = f.layers.fc(x, 6)
        return f.layers.layer_norm(f.layers.elementwise_add(h, res),
                                   begin_norm_axis=1)
    j, t = _pair(build)
    rng = np.random.RandomState(5)
    feed = {"x": rng.randn(3, 8).astype("float32"),
            "res": rng.randn(3, 6).astype("float32")}
    types = _check(j, t, feed, ["fc_fuse_pass",
                                "fc_elementwise_layernorm_fuse_pass"],
                   1e-5, 1e-5)
    assert types == ["fused_fc_elementwise_layernorm"]


def test_fc_elementwise_layernorm_guards_begin_norm_axis():
    def build(f):
        x = f.data("x", shape=[4, 8], dtype="float32")
        res = f.data("res", shape=[4, 6], dtype="float32")
        h = f.layers.fc(x, 6, num_flatten_dims=2)
        return f.layers.layer_norm(f.layers.elementwise_add(h, res),
                                   begin_norm_axis=1)
    j, t = _pair(build)
    rng = np.random.RandomState(12)
    feed = {"x": rng.randn(2, 4, 8).astype("float32"),
            "res": rng.randn(2, 4, 6).astype("float32")}
    types = _check(j, t, feed, ["fc_fuse_pass",
                                "fc_elementwise_layernorm_fuse_pass"],
                   1e-5, 1e-5)
    assert "fused_fc_elementwise_layernorm" not in types


def _emb_build(padding_idx=None):
    def build(f):
        a = f.data("a", shape=[16, 1], dtype="int64")
        b = f.data("b", shape=[16, 1], dtype="int64")
        ea = f.layers.embedding(a, size=[30, 8], padding_idx=padding_idx)
        eb = f.layers.embedding(b, size=[30, 8])
        return f.layers.layer_norm(f.layers.elementwise_add(ea, eb),
                                   begin_norm_axis=2)
    return build


@pytest.mark.parametrize("padding_idx", [None, 0])
def test_embedding_eltwise_layernorm_fuse(padding_idx):
    j, t = _pair(_emb_build(padding_idx))
    rng = np.random.RandomState(7)
    feed = {"a": rng.randint(0, 30, (2, 16, 1)).astype("int64"),
            "b": rng.randint(0, 30, (2, 16, 1)).astype("int64")}
    types = _check(j, t, feed, ["embedding_eltwise_layernorm_fuse_pass"],
                   1e-5, 1e-5)
    if padding_idx is None:
        assert types == ["fused_embedding_eltwise_layernorm"]
    else:
        assert "fused_embedding_eltwise_layernorm" not in types


def test_embedding_fuse_matches_lookup_table_v2():
    def build(f):
        blk = f.default_main_program().global_block()
        a = f.data("a", shape=[16], dtype="int64")
        b = f.data("b", shape=[16], dtype="int64")
        wa = f.layers.create_parameter([30, 8], "float32", name="va_w")
        wb = f.layers.create_parameter([30, 8], "float32", name="vb_w")
        ea = blk.create_var(name="ea_v2", dtype="float32", shape=[-1, 16, 8])
        eb = blk.create_var(name="eb_v2", dtype="float32", shape=[-1, 16, 8])
        blk.append_op(type="lookup_table_v2",
                      inputs={"W": [wa.name], "Ids": [a.name]},
                      outputs={"Out": [ea.name]}, attrs={"padding_idx": -1})
        blk.append_op(type="lookup_table_v2",
                      inputs={"W": [wb.name], "Ids": [b.name]},
                      outputs={"Out": [eb.name]}, attrs={"padding_idx": -1})
        return f.layers.layer_norm(f.layers.elementwise_add(ea, eb),
                                   begin_norm_axis=2)
    j, t = _pair(build)
    rng = np.random.RandomState(15)
    feed = {"a": rng.randint(0, 30, (2, 16)).astype("int64"),
            "b": rng.randint(0, 30, (2, 16)).astype("int64")}
    types = _check(j, t, feed, ["embedding_eltwise_layernorm_fuse_pass"],
                   1e-5, 1e-5)
    assert types == ["fused_embedding_eltwise_layernorm"]


# -------------------------------------------------------- quant/dequant
def test_delete_quant_dequant_pass():
    def build(f):
        x = f.data("x", shape=[4], dtype="float32")
        blk = f.default_main_program().global_block()
        q = blk.create_var(name="q_out", dtype="float32")
        s = blk.create_var(name="q_scale", dtype="float32")
        blk.append_op(
            type="fake_quantize_dequantize_moving_average_abs_max",
            inputs={"X": [x.name]},
            outputs={"Out": [q.name], "OutScale": [s.name]},
            attrs={"bit_length": 8, "moving_rate": 0.9})
        return f.layers.scale(q, scale=2.0)
    j, t = _pair(build)
    x = np.random.RandomState(8).rand(2, 4).astype("float32")
    jp = j.apply(["delete_quant_dequant_op_pass"])
    tp = t.apply(["delete_quant_dequant_op_pass"])
    assert t.types(tp) == j.types(jp) == ["scale"]
    np.testing.assert_allclose(t.run({"x": x}, program=tp)[0], x * 2.0,
                               rtol=1e-5)


# ------------------------------------------------------ multihead fusion
def _raw_attention(H=2, D=4, N=8, S=6, merge_perm=(0, 2, 1, 3), sm_axis=-1,
                   mask_shape=None):
    """The decomposed attention a reference-serialized transformer carries
    (tests/test_ir_passes.py:572-593)."""
    def build(f):
        x = f.data("x", shape=[S, N], dtype="float32")
        mask = f.data("mask", shape=list(mask_shape or [H, S, S]),
                      dtype="float32")

        def proj(tag):
            p = f.layers.fc(x, H * D, num_flatten_dims=2,
                            param_attr=f.ParamAttr(name=tag + "_w"),
                            bias_attr=f.ParamAttr(name=tag + "_b"))
            r = f.layers.reshape(p, [0, 0, H, D])
            return f.layers.transpose(r, [0, 2, 1, 3])

        q, k, v = proj("q"), proj("k"), proj("v")
        qs = f.layers.scale(q, scale=float(1.0 / np.sqrt(D)))
        qk = f.layers.matmul(qs, k, transpose_y=True)
        attn = f.layers.softmax(f.layers.elementwise_add(qk, mask),
                                axis=sm_axis)
        ctx = f.layers.matmul(attn, v)
        ctx_t = f.layers.transpose(ctx, list(merge_perm))
        return f.layers.reshape(ctx_t, [0, 0, H * D])
    return build


def _mh_feed(seed, b=2, H=2, S=6, N=8):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(b, S, N).astype("float32"),
            "mask": rng.uniform(-1, 0, (b, H, S, S)).astype("float32")}


def test_multihead_matmul_fuse_pass_v2_packs_the_reference_weights():
    j, t = _pair(_raw_attention())
    feed = _mh_feed(0)
    passes = ["multihead_matmul_fuse_pass_v2"]
    types = _check(j, t, feed, passes, 1e-5, 1e-5,
                   protected=[t.out.name])
    assert types == ["multihead_matmul"]
    op = t.main.global_block().ops[0]
    for slot in ("W", "Bias"):
        name = op.input(slot)[0]
        assert t.get(name).tobytes() == j.get(name).tobytes()
        assert t.scope.find_var(name).value().array.device.type == "cpu"
    for dead in ("q_w", "k_w", "v_w", "q_b", "k_b", "v_b"):
        assert t.scope.find_var(dead) is None, dead
        assert j.scope.find_var(dead) is None, dead
    assert op.attrs["head_number"] == 2
    assert op.attrs["alpha"] == pytest.approx(0.5)


def test_multihead_fuse_in_inference_pipeline():
    j, t = _pair(_raw_attention())
    feed = _mh_feed(1, b=1)
    feed["mask"] = np.zeros_like(feed["mask"])
    jp = jir.apply_inference_passes(j.main, scope=j.scope)
    tp = tir.apply_inference_passes(t.main, scope=t.scope)
    types = _check(j, t, feed, None, 1e-5, 1e-5, jprog=jp, tprog=tp)
    assert types.count("multihead_matmul") == 1


def test_multihead_fuse_skips_without_scope():
    j, t = _pair(_raw_attention())
    n = len(t.types())
    fused = t.apply(["multihead_matmul_fuse_pass_v2"], [t.out.name],
                    scope=False)
    assert len(t.types(fused)) == n


@pytest.mark.parametrize("variant", [dict(merge_perm=(0, 1, 2, 3), S=2),
                                     dict(sm_axis=2, S=2), dict(S=2)])
def test_multihead_fuse_gates_on_perm_and_softmax_axis(variant):
    j, t = _pair(_raw_attention(**variant))
    passes = ["multihead_matmul_fuse_pass_v2"]
    jt = j.types(j.apply(passes, [j.out.name]))
    tt = t.types(t.apply(passes, [t.out.name]))
    assert tt == jt
    fused = variant == dict(S=2)
    assert ("multihead_matmul" in tt) == fused


def test_multihead_fused_op_takes_the_flash_route_for_keypad_mask(
        monkeypatch):
    H, D, N, S = 2, 64, 8, 128
    j, t = _pair(_raw_attention(H=H, D=D, N=N, S=S, mask_shape=[1, 1, S]))
    pad = np.zeros((2, 1, 1, S), np.float32)
    pad[:, :, :, S // 2:] = -1e9
    feed = {"x": np.random.RandomState(0).rand(2, S, N).astype("float32"),
            "mask": pad}
    calls = []
    real = tattention_ops.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tattention_ops, "flash_attention", counting)
    types = _check(j, t, feed, ["multihead_matmul_fuse_pass_v2"], 1e-5,
                   1e-5, protected=[t.out.name])
    assert types == ["multihead_matmul"]
    calls.clear()
    t.run(feed)
    assert len(calls) == 1


# ------------------------------------------------------------ pipeline
def test_inference_pipeline_end_to_end():
    def build(f):
        img = f.data("img", shape=[3, 8, 8], dtype="float32")
        c = f.layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                            bias_attr=False)
        c = f.layers.batch_norm(c, is_test=True)
        h = f.layers.fc(c, 10, num_flatten_dims=1)
        h = f.layers.dropout(h, dropout_prob=0.1, is_test=True)
        return f.layers.scale(h, scale=1.0, bias=0.0)
    j, t = _pair(build)
    x = np.random.RandomState(9).randn(2, 3, 8, 8).astype("float32")
    n_before = len(t.types())
    jp = jir.apply_inference_passes(j.main, j.scope)
    tp = tir.apply_inference_passes(t.main, t.scope)
    types = _check(j, t, {"img": x}, None, 1e-4, 1e-5, jprog=jp, tprog=tp)
    assert len(types) < n_before
    assert "batch_norm" not in types and "dropout" not in types


def test_registry_holds_the_inference_passes():
    names = tir.all_registered_passes()
    for n in tir.INFERENCE_PASSES + ["multihead_matmul_fuse_pass"]:
        assert n in names
        assert n in jir.all_registered_passes()
    assert tir.INFERENCE_PASSES == jir.INFERENCE_PASSES
    with pytest.raises(ValueError):
        tir.get_pass("not_a_real_pass")
