"""The port's predictor (paddle_tpu_torch/inference) against the TPU
package's: a counterpart of each test of tests/test_inference.py but the
XLA executable-cache one, the BERT census after the pass pipeline, the
attention-dropout caveat, and ResNet-50 through the pipeline.

- train, save_inference_model, predictor (handles, list API, clone,
  PredictorPool, load_inference_model + Executor.run, model and params
  from memory buffers in the golden format, a customized pass builder,
  bf16 and the misc API), at tests/test_inference.py's tolerance (rtol
  1e-5, atol 1e-6), the same outputs from the TPU package's predictor;
- a config uses the card unless it says disable_gpu(): on a host without
  CUDA the predictor raises instead of serving from the CPU;
- BERT (2 layers, hidden 64, input mask) saved with the encoder output
  and the MLM logits: the same op census after the passes in both
  packages (13 fc, 1 fused_embedding_eltwise_layernorm, 2
  fused_attention_qkv, ...), outputs equal to ``clone(for_test=True)``
  run with ``use_prune=True``; at dropout 0.1 both keep dropout_rate 0.1
  on fused_attention_qkv (no is_test attr: ROADMAP C "carried");
- ResNet-50 at 32x32 with 10 classes, saved with the logits and the
  softmax: 53 conv2d_fusion, 49 relu, 16 elementwise_add, 1 fc, 2
  pool2d, 1 flatten2, 1 softmax in both packages; the logits within rtol
  1e-4, atol 1e-5 of ``clone(for_test=True)`` (tests/test_ir_passes.py:566).
"""
import collections
import os

import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu.fluid import core as jcore
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tresnet

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
RTOL, ATOL = 1e-5, 1e-6  # tests/test_inference.py


@pytest.fixture(autouse=True)
def _fresh_tmp_names(monkeypatch):
    """Both packages name temporaries from a process-wide counter that
    ``unique_name.guard`` does not reset: start both from zero."""
    from paddle_tpu.fluid import unique_name as jnames
    from paddle_tpu_torch.fluid import unique_name as tnames
    for m in (jnames, tnames):
        monkeypatch.setattr(m, "dygraph_parameter_name_generator",
                            m.UniqueNameGenerator())


def _cpu_config(d=None):
    cfg = tinference.Config(d)
    cfg.disable_gpu()
    return cfg


def train_and_save(dirname):
    """tests/test_inference.py's train_and_save on the port: a linear fc
    trained 60 SGD steps toward W, saved with the prediction as target."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.data("x", shape=[4], dtype="float32")
        y = tfluid.data("y", shape=[1], dtype="float32")
        pred = tfluid.layers.fc(x, 1, param_attr=tfluid.ParamAttr(name="w"))
        loss = tfluid.layers.mean(tfluid.layers.square(
            tfluid.layers.elementwise_sub(pred, y)))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    rng = np.random.RandomState(0)
    X = rng.rand(16, 4).astype("float32")
    W = np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32)
    Y = X @ W
    with tfluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(60):
            exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
        tfluid.io.save_inference_model(dirname, ["x"], [pred], exe, main)
        (out,) = exe.run(main, feed={"x": X, "y": Y}, fetch_list=[pred])
    return X, out


def test_predictor_matches_training_forward(tmp_path):
    d = str(tmp_path / "model")
    X, want = train_and_save(d)
    predictor = tinference.create_predictor(_cpu_config(d))
    assert predictor.get_input_names() == ["x"]
    predictor.get_input_handle("x").copy_from_cpu(X)
    predictor.run()
    got = predictor.get_output_handle(
        predictor.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    (jgot,) = jinference.create_predictor(jinference.Config(d)).run([X])
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=RTOL, atol=ATOL)
    with pytest.raises(RuntimeError):
        predictor.get_input_handle("x").copy_to_cpu()
    with pytest.raises(KeyError):
        predictor.get_output_handle("nope")


def test_predictor_run_list_api_and_clone(tmp_path):
    d = str(tmp_path / "model")
    X, want = train_and_save(d)
    predictor = tinference.create_predictor(_cpu_config(d))
    (got,) = predictor.run([X])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    clone = predictor.clone()
    (got2,) = clone.run([X[:3]])
    np.testing.assert_allclose(got2, want[:3], rtol=RTOL, atol=ATOL)


def test_load_inference_model_executor_path(tmp_path):
    d = str(tmp_path / "model")
    X, want = train_and_save(d)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        prog, feeds, fetches = tfluid.io.load_inference_model(d, exe)
        assert feeds == ["x"]
        (got,) = exe.run(prog, feed={"x": X}, fetch_list=fetches)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert sorted(os.listdir(d)) == ["__model__", "fc_0.b_0", "w"]


def test_predictor_from_memory_buffers_golden_format():
    with open(os.path.join(FIXTURES, "golden_fc.program.pb"), "rb") as f:
        prog_bytes = f.read()
    with open(os.path.join(FIXTURES, "golden_fc_b.tensor"), "rb") as f:
        params = f.read()
    with open(os.path.join(FIXTURES, "golden_fc_w.tensor"), "rb") as f:
        params += f.read()
    cfg = _cpu_config()
    cfg.set_model_buffer(prog_bytes, params)
    assert cfg.model_from_memory()
    pred = tinference.create_predictor(cfg)
    exp = np.load(os.path.join(FIXTURES, "golden_expected.npz"))
    x = np.random.RandomState(3).rand(5, 4).astype("float32")
    (out,) = pred.run([x])
    np.testing.assert_allclose(out, x @ exp["w"] + exp["b"], rtol=RTOL,
                               atol=ATOL)
    assert [op.type for op in pred._program.global_block().ops] == ["fc"]


def test_predictor_from_memory_with_feed_and_fetch_ops(tmp_path):
    """A model the port saved, served from memory: its feed and fetch
    ops stay in the program and Executor.run does not run them."""
    d = str(tmp_path / "model")
    X, want = train_and_save(d)
    with open(os.path.join(d, "__model__"), "rb") as f:
        prog_bytes = f.read()
    params = b""
    for n in ("fc_0.b_0", "w"):  # sorted persistable names
        with open(os.path.join(d, n), "rb") as f:
            params += f.read()
    cfg = _cpu_config()
    cfg.set_model_buffer(prog_bytes, params)
    pred = tinference.create_predictor(cfg)
    types = [op.type for op in pred._program.global_block().ops]
    assert types[0] == "feed" and types[-1] == "fetch" and "fc" in types
    (out,) = pred.run([X])
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


def test_predictor_clone_shares_weights(tmp_path):
    d = str(tmp_path / "m1")
    train_and_save(d)
    cfg = _cpu_config(d)
    p1 = tinference.create_predictor(cfg)
    p2 = p1.clone()
    assert p2._scope is p1._scope  # no second copy of the weights
    assert p2._exe is not p1._exe
    x = np.random.RandomState(4).rand(2, 4).astype("float32")
    np.testing.assert_array_equal(p1.run([x])[0], p2.run([x])[0])
    pool = tinference.PredictorPool(cfg, size=3)
    assert pool.size() == 3
    np.testing.assert_array_equal(pool.retrieve(2).run([x])[0],
                                  p1.run([x])[0])


def test_pass_builder_customization(tmp_path):
    d = str(tmp_path / "m2")
    train_and_save(d)
    cfg = _cpu_config(d)
    pb = cfg.pass_builder()
    n0 = len(pb.all_passes())
    pb.delete_pass("fc_fuse_pass")
    assert len(pb.all_passes()) == n0 - 1
    pred = tinference.create_predictor(cfg)
    types = [op.type for op in pred._program.global_block().ops]
    assert "fc" not in types and "mul" in types
    x = np.random.rand(2, 4).astype("float32")
    assert pred.run([x])[0].shape == (2, 1)
    with pytest.raises(ValueError):
        pb.append_pass("not_a_real_pass")
    cfg2 = _cpu_config(d)
    cfg2.switch_ir_optim(False)
    types = [op.type for op in tinference.create_predictor(cfg2)
             ._program.global_block().ops]
    assert types == ["mul", "elementwise_add"]


def test_predictor_misc_api(tmp_path):
    d = str(tmp_path / "m3")
    train_and_save(d)
    cfg = _cpu_config(d)
    cfg.enable_bf16()
    assert cfg.bf16_enabled()
    cfg.set_optim_cache_dir(str(tmp_path / "cache"))
    try:
        pred = tinference.create_predictor(cfg)
        assert tfluid.core.globals_["FLAGS_use_bf16_matmul"]
        shapes = pred.get_input_tensor_shape()
        assert list(shapes) == pred.get_input_names()
        assert shapes["x"] == [-1, 4]
        x = np.random.rand(2, 4).astype("float32")
        y1 = pred.run([x])[0]
        pred.try_shrink_memory()
        assert not pred._exe._compiled_cache
        y2 = pred.run([x])[0]
        np.testing.assert_allclose(y1, y2, rtol=1e-2)
    finally:
        tfluid.core.set_flag("FLAGS_use_bf16_matmul", False)
    assert not os.path.exists(tmp_path / "cache")  # recorded only


def test_config_uses_the_card_unless_told_otherwise(tmp_path):
    d = str(tmp_path / "m4")
    train_and_save(d)
    cfg = tinference.Config(d)
    assert cfg.use_gpu() and cfg.gpu_device_id() == 0
    cfg.enable_use_gpu(100, 0)
    assert cfg.place() == tfluid.CUDAPlace(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tinference.create_predictor(cfg)
    cfg.disable_gpu()
    assert cfg.place() == tfluid.CPUPlace()


# ---------------------------------------------------------------- BERT
CFG = dict(vocab_size=128, hidden=64, layers=2, heads=4, ffn=128, max_len=16,
           type_vocab=2)
S, B = 16, 4
FEEDS = ["src_ids", "pos_ids", "sent_ids", "input_mask", "mask_pos"]
BERT_CENSUS = {"fc": 13, "fused_embedding_eltwise_layernorm": 1,
               "elementwise_add": 4, "layer_norm": 4,
               "fused_attention_qkv": 2, "gelu": 2, "scale": 2,
               "unsqueeze2": 2, "reshape2": 1, "gather": 1}


def _mlm_targets(program):
    ops = program.global_block().ops
    sm = [o for o in ops if o.type == "softmax_with_cross_entropy"][0]
    gather = [o for o in ops if o.type == "gather"][0]
    return [gather.input("X")[0], sm.input("Logits")[0]]


def _bert_feed(seed, batch=B):
    r = np.random.RandomState(seed)
    mask = np.ones((batch, S), np.float32)
    mask[0, 9:] = 0.0
    return {"src_ids": r.randint(0, CFG["vocab_size"], (batch, S)),
            "pos_ids": np.tile(np.arange(S), (batch, 1)),
            "sent_ids": r.randint(0, CFG["type_vocab"], (batch, S)),
            "input_mask": mask,
            "mask_pos": r.randint(0, batch * S, (10, 1)),
            "mask_label": r.randint(0, CFG["vocab_size"], (10, 1))}


def _save_bert(tmp_path, dropout):
    """Both packages build the pretraining program; the port's scope
    takes the TPU package's startup values; each takes one Adam step and
    saves. → (TPU side, port side), each (dir, main, scope, exe)."""
    sides = {}
    for name, fluid, bert in (("j", jfluid, jbert), ("t", tfluid, tbert)):
        with fluid.unique_name.guard():
            main, startup, _, (loss,) = bert.build_bert_pretrain_program(
                CFG, seq_len=S, dropout=dropout, lr=1e-3,
                use_input_mask=True)
        sides[name] = [main, startup, loss]
    jm, js, jloss = sides["j"]
    tm, ts, tloss = sides["t"]
    jexe, jscope = jfluid.Executor(), jcore.Scope()
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    texe.run(ts, scope=tscope)
    set_params_from_numpy(tscope, {
        v.name: np.asarray(jscope.find_var(v.name).get_tensor().array)
        for v in tm.list_vars()
        if v.persistable and tscope.find_var(v.name) is not None
        and jscope.find_var(v.name) is not None})
    out = {}
    for name, fluid, exe, scope, main, loss in (
            ("j", jfluid, jexe, jscope, jm, jloss),
            ("t", tfluid, texe, tscope, tm, tloss)):
        d = str(tmp_path / name)
        with fluid.scope_guard(scope):
            if not dropout:
                exe.run(main, feed=_bert_feed(0), fetch_list=[loss])
            fluid.io.save_inference_model(d, FEEDS, _mlm_targets(main), exe,
                                          main)
        out[name] = (d, main, scope, exe)
    return out["j"], out["t"]


def _census(pred):
    return dict(collections.Counter(
        op.type for op in pred._program.global_block().ops))


def test_bert_census_and_outputs_match_the_reference(tmp_path):
    (jd, jm, jscope, jexe), (td, tm, tscope, texe) = _save_bert(tmp_path,
                                                                 0.0)
    tp = tinference.create_predictor(_cpu_config(td))
    jp = jinference.create_predictor(jinference.Config(jd))
    assert _census(tp) == _census(jp) == BERT_CENSUS
    assert [op.type for op in tp._program.global_block().ops] == \
        [op.type for op in jp._program.global_block().ops]
    assert tp.get_output_names() == jp.get_output_names() \
        == _mlm_targets(tm)
    req = _bert_feed(1)
    got = tp.run([req[k] for k in FEEDS])
    # each package took its own Adam step: the TPU package's predictor
    # serves the port's directory, on the port's weights
    jgot = jinference.create_predictor(jinference.Config(td)).run(
        [req[k] for k in FEEDS])
    want = texe.run(tm.clone(for_test=True), feed={k: req[k] for k in FEEDS},
                    fetch_list=_mlm_targets(tm), scope=tscope,
                    use_prune=True)
    for g, w, j in zip(got, want, jgot):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g, np.asarray(j), rtol=RTOL, atol=ATOL)


def test_attention_dropout_survives_the_passes_in_both_packages(tmp_path):
    """fused_attention_qkv has no is_test attr, so neither clone(for_test)
    nor is_test_pass turns attention dropout off: a served BERT trained
    with dropout keeps dropping attention probabilities (ROADMAP C
    "carried"). The port copies the reference."""
    (jd, *_), (td, *_) = _save_bert(tmp_path, 0.1)
    tp = tinference.create_predictor(_cpu_config(td))
    jp = jinference.create_predictor(jinference.Config(jd))
    want = dict(BERT_CENSUS, assign=7)
    assert _census(tp) == _census(jp) == want
    for p in (tp, jp):
        rates = [op.attrs["dropout_rate"]
                 for op in p._program.global_block().ops
                 if op.type == "fused_attention_qkv"]
        assert rates == [np.float32(0.1)] * 2
        assert not any(op.type == "dropout"
                       for op in p._program.global_block().ops)


# -------------------------------------------------------------- ResNet
RESNET_CENSUS = {"conv2d_fusion": 53, "relu": 49, "elementwise_add": 16,
                 "fc": 1, "pool2d": 2, "flatten2": 1, "softmax": 1}


def _softmax_io(program):
    sm = [o for o in program.global_block().ops if o.type == "softmax"][-1]
    return sm.input("X")[0], sm.output("Out")[0]


def _resnet_dir(fluid, resnet, core, exe, tmp_path, name, params=None):
    with fluid.unique_name.guard():
        main, startup, _, _ = resnet.build_resnet_train_program(
            depth=50, class_dim=10, image_size=32)
    scope = core.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        if params is not None:
            set_params_from_numpy(scope, params)
        d = str(tmp_path / name)
        fluid.io.save_inference_model(d, ["image"], list(_softmax_io(main)),
                                      exe, main)
    return d, main, scope


def test_resnet50_through_the_pipeline(tmp_path):
    jexe = jfluid.Executor()
    jd, jm, jscope = _resnet_dir(jfluid, jresnet, jcore, jexe, tmp_path, "j")
    params = {v.name: np.asarray(jscope.find_var(v.name).get_tensor().array)
              for v in jm.list_vars() if v.persistable
              and jscope.find_var(v.name) is not None}
    texe = tfluid.Executor(tfluid.CPUPlace())
    td, tm, tscope = _resnet_dir(tfluid, tresnet, tfluid.core, texe,
                                 tmp_path, "t", params)
    tp = tinference.create_predictor(_cpu_config(td))
    jp = jinference.create_predictor(jinference.Config(jd))
    assert _census(tp) == _census(jp) == RESNET_CENSUS
    for op in tp._program.global_block().ops:
        if op.type == "conv2d_fusion":
            for slot in ("Filter", "Bias"):
                n = op.input(slot)[0]
                assert tp._scope.find_var(n).value().numpy().tobytes() == \
                    np.asarray(jp._scope.find_var(n).get_tensor().array) \
                    .tobytes(), n
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    logits, prob = tp.run([x])
    want = texe.run(tm.clone(for_test=True), feed={"image": x},
                    fetch_list=list(_softmax_io(tm)), scope=tscope,
                    use_prune=True)
    np.testing.assert_allclose(logits, want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(prob, want[1], rtol=1e-4, atol=1e-5)
    assert np.isfinite(logits).all() and logits.shape == (2, 10)
