"""The port's fluid.io against the TPU package's.

- The LoDTensor stream: the same bytes as the TPU package's for f32, f16,
  bf16, int64 and a 2-level LoD; each package reads the other's bytes
  back bitwise; the golden fixtures (protoc and the reference's format)
  load unchanged and write back to the same bytes.
- save_vars / load_vars per var and combined; save / load pickles read by
  the other package.
- Saved inference directories, both ways: a BERT (2 layers, hidden 64,
  input mask) that the TPU package saves serves from the port's
  predictor, and one the port saves serves from the TPU package's, at
  tests/test_inference.py's tolerance (rtol 1e-5, atol 1e-6); the model
  files are byte-identical when both save the same program.
- save_inference_model verifies the pruned program at level "error".
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu import inference as jinference
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid import io as jio
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.fluid import analysis as tanalysis
from paddle_tpu_torch.fluid import io as tio
from paddle_tpu_torch.models import bert as tbert

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
CFG = dict(vocab_size=128, hidden=64, layers=2, heads=4, ffn=128, max_len=16,
           type_vocab=2)
S, B = 16, 4
FEEDS = ["src_ids", "pos_ids", "sent_ids", "input_mask", "mask_pos"]
RTOL, ATOL = 1e-5, 1e-6  # tests/test_inference.py


def _golden(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _bf16_np():
    import ml_dtypes
    return ml_dtypes.bfloat16


def _arrays():
    r = np.random.RandomState(0)
    return {
        "f32": r.randn(3, 5).astype(np.float32),
        "f16": r.randn(4, 2).astype(np.float16),
        "bf16": r.randn(2, 3, 2).astype(np.float32).astype(_bf16_np()),
        "i64": r.randint(-2**31, 2**31, (6,)).astype(np.int64),
        "i64_wide": r.randint(-2**40, 2**40, (6,)).astype(np.int64),
        "scalar": np.asarray(r.randn(1).astype(np.float32)),
    }


def _torch_of(arr):
    if arr.dtype == _bf16_np():
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class _HostTensor:
    """What the TPU package's writer reads of a LoDTensor (``.array``,
    ``.lod()``), holding a numpy array as it is: its LoDTensor keeps
    int64 as int32 on the device."""

    def __init__(self, arr, lod=None):
        self.array = arr
        self._lod = lod or []

    def lod(self):
        return self._lod


@pytest.fixture(autouse=True)
def _fresh_tmp_names(monkeypatch):
    """Both packages name temporaries from a process-wide counter that
    ``unique_name.guard`` does not reset: start both from zero, so the
    same program gets the same names whatever ran before."""
    from paddle_tpu.fluid import unique_name as jnames
    from paddle_tpu_torch.fluid import unique_name as tnames
    for m in (jnames, tnames):
        monkeypatch.setattr(m, "dygraph_parameter_name_generator",
                            m.UniqueNameGenerator())


@pytest.mark.parametrize("kind", sorted(_arrays()) + ["lod2"])
def test_lod_tensor_stream_matches_reference(kind):
    if kind == "lod2":
        arr = np.arange(14, dtype=np.float32).reshape(7, 2)
        lod = [[0, 1, 3], [0, 2, 4, 7]]
    else:
        arr, lod = _arrays()[kind], None
    jb = jio._serialize_lod_tensor(_HostTensor(arr, lod))
    tb = tio._serialize_lod_tensor(tfluid.LoDTensor(_torch_of(arr), lod))
    assert tb == jb
    back = tio._deserialize_lod_tensor(jb)
    assert back.lod() == (lod or [])
    assert back.numpy().tobytes() == arr.tobytes()
    assert back.array.dtype == _torch_of(arr).dtype
    if kind == "i64_wide":
        return  # the TPU package's LoDTensor refuses ids beyond int32
    jback = jio._deserialize_lod_tensor(tb)
    np.testing.assert_array_equal(
        np.asarray(jback.array).astype(arr.dtype), arr)
    assert jback.lod() == (lod or [])


@pytest.mark.parametrize("name", ["golden_fc_w.tensor", "golden_fc_b.tensor",
                                  "golden_seq.lodtensor"])
def test_golden_tensors_load_unchanged(name):
    b = _golden(name)
    t = tio._deserialize_lod_tensor(b)
    j = jio._deserialize_lod_tensor(b)
    assert t.numpy().tobytes() == np.asarray(j.array).tobytes()
    assert t.lod() == j.lod()
    assert tio._serialize_lod_tensor(t) == b
    exp = np.load(os.path.join(FIXTURES, "golden_expected.npz"))
    key = {"golden_fc_w.tensor": "w", "golden_fc_b.tensor": "b",
           "golden_seq.lodtensor": "seq"}[name]
    np.testing.assert_array_equal(t.numpy(), exp[key])


def test_stream_of_many_and_empty():
    arrs = list(_arrays().values()) + [np.zeros((0, 3), np.float32)]
    tb = b"".join(tio._serialize_lod_tensor(tfluid.LoDTensor(_torch_of(a)))
                  for a in arrs)
    jb = b"".join(jio._serialize_lod_tensor(_HostTensor(a)) for a in arrs)
    assert tb == jb
    got = tio._deserialize_lod_tensor_stream(jb, len(arrs))
    for a, t in zip(arrs, got):
        assert t.numpy().tobytes() == a.tobytes()
        assert tuple(t.array.shape) == a.shape
    with pytest.raises(ValueError):
        tio._deserialize_lod_tensor(jb[:40])


# ------------------------------------------------------------ save / load
def _fc_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[4], dtype="float32")
        pred = fluid.layers.fc(x, 3, act="relu")
        loss = fluid.layers.mean(pred)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, pred


def _persist(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


@pytest.mark.parametrize("filename", [None, "__params__"])
def test_save_load_persistables_both_ways(tmp_path, filename):
    tm, ts, _ = _fc_program(tfluid)
    jm, js, _ = _fc_program(jfluid)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(ts, scope=tscope)
    with tfluid.scope_guard(tscope):
        tio.save_persistables(texe, str(tmp_path / "t"), tm, filename)
    jexe, jscope = jfluid.Executor(), jcore.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
        jio.load_persistables(jexe, str(tmp_path / "t"), jm, filename)
        jio.save_persistables(jexe, str(tmp_path / "j"), jm, filename)
    names = _persist(tm)
    assert names == _persist(jm)
    for n in names:
        assert np.asarray(jscope.find_var(n).get_tensor().array).tobytes() \
            == tscope.find_var(n).value().numpy().tobytes()
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    for f in os.listdir(tmp_path / "t"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    tscope2 = tfluid.Scope()
    with tfluid.scope_guard(tscope2):
        tio.load_persistables(texe, str(tmp_path / "j"), tm, filename)
    for n in names:
        assert tscope2.find_var(n).value().numpy().tobytes() == \
            tscope.find_var(n).value().numpy().tobytes()


def test_load_vars_names_every_missing_file(tmp_path):
    tm, ts, _ = _fc_program(tfluid)
    with pytest.raises(RuntimeError, match="2 checkpoint file"):
        tio.load_params(None, str(tmp_path), tm)


def test_save_load_pickles_both_ways(tmp_path):
    tm, ts, _ = _fc_program(tfluid)
    jm, js, _ = _fc_program(jfluid)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(ts, scope=tscope)
    with tfluid.scope_guard(tscope):
        tio.save(tm, str(tmp_path / "t" / "m"))
    jscope = jcore.Scope()
    with jfluid.scope_guard(jscope):
        jio.load(jm, str(tmp_path / "t" / "m"))
        jio.save(jm, str(tmp_path / "j" / "m"))
    tscope2 = tfluid.Scope()
    with tfluid.scope_guard(tscope2):
        tio.load(tm, str(tmp_path / "j" / "m"), texe)
    for n in _persist(tm):
        want = tscope.find_var(n).value().numpy()
        np.testing.assert_array_equal(
            np.asarray(jscope.find_var(n).get_tensor().array), want)
        np.testing.assert_array_equal(tscope2.find_var(n).value().numpy(),
                                      want)
    assert (tmp_path / "t" / "m.pdmodel").read_bytes() == \
        (tmp_path / "j" / "m.pdmodel").read_bytes() == \
        tm.serialize_to_string()


# ------------------------------------------------- inference directories
def _mlm_targets(program):
    ops = program.global_block().ops
    sm = [o for o in ops if o.type == "softmax_with_cross_entropy"][0]
    gather = [o for o in ops if o.type == "gather"][0]
    return [gather.input("X")[0], sm.input("Logits")[0]]


def _feed(seed=0, batch=B):
    r = np.random.RandomState(seed)
    mask = np.ones((batch, S), np.float32)
    mask[0, 10:] = 0.0
    return {"src_ids": r.randint(0, CFG["vocab_size"], (batch, S)),
            "pos_ids": np.tile(np.arange(S), (batch, 1)),
            "sent_ids": r.randint(0, CFG["type_vocab"], (batch, S)),
            "input_mask": mask,
            "mask_pos": r.randint(0, batch * S, (10, 1)),
            "mask_label": r.randint(0, CFG["vocab_size"], (10, 1))}


def _train_and_save(fluid, bert, core, d, place):
    """Startup, one Adam step, save_inference_model with the encoder
    output and the MLM logits as targets; → the saver's own outputs on a
    request (the clone for test, pruned by the executor)."""
    with fluid.unique_name.guard():
        main, startup, _, (loss,) = bert.build_bert_pretrain_program(
            CFG, seq_len=S, lr=1e-3, use_input_mask=True)
    startup.random_seed = 7
    exe, scope = fluid.Executor(place), core.Scope()
    targets = _mlm_targets(main)
    req = {k: _feed(1)[k] for k in FEEDS}
    with fluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=_feed(0), fetch_list=[loss])
        fluid.io.save_inference_model(d, FEEDS, targets, exe, main)
        want = exe.run(main.clone(for_test=True), feed=req,
                       fetch_list=targets, use_prune=True)
    return main, req, [np.asarray(w) for w in want]


def _serve(inference, d, req, cpu):
    cfg = inference.Config(d)
    if cpu:
        cfg.disable_gpu()
    p = inference.create_predictor(cfg)
    assert p.get_input_names() == FEEDS
    return p.run([req[k] for k in FEEDS]), p


def test_reference_saved_directory_serves_from_the_port(tmp_path):
    d = str(tmp_path / "j")
    _, req, want = _train_and_save(jfluid, jbert, jcore, d, None)
    got, p = _serve(tinference, d, req, cpu=True)
    jgot, _ = _serve(jinference, d, req, cpu=False)
    for g, j, w in zip(got, jgot, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g, np.asarray(j), rtol=RTOL, atol=ATOL)
    assert p._exe._last_run_mode == "compiled"


def test_port_saved_directory_serves_from_the_reference(tmp_path):
    d = str(tmp_path / "t")
    main, req, want = _train_and_save(tfluid, tbert, tfluid.core, d,
                                      tfluid.CPUPlace())
    jgot, _ = _serve(jinference, d, req, cpu=False)
    got, _ = _serve(tinference, d, req, cpu=True)
    for g, j, w in zip(got, jgot, want):
        np.testing.assert_allclose(np.asarray(j), w, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(g, w)  # the port: bitwise on the CPU
    # the TPU package saving the same program writes the same model file
    with jfluid.unique_name.guard():
        jmain = jbert.build_bert_pretrain_program(
            CFG, seq_len=S, lr=1e-3, use_input_mask=True)[0]
    jd = str(tmp_path / "j")
    jexe, jscope = jfluid.Executor(), jcore.Scope()
    with jfluid.scope_guard(jscope):
        jio.save_inference_model(jd, FEEDS, _mlm_targets(jmain), jexe, jmain,
                                 program_only=True)
    assert open(os.path.join(jd, "__model__"), "rb").read() == \
        open(os.path.join(d, "__model__"), "rb").read()
    assert sorted(os.listdir(d)) == sorted(
        ["__model__"] + [v.name for v in tfluid.framework.Program
                         .parse_from_string(open(os.path.join(
                             d, "__model__"), "rb").read()).list_vars()
                         if v.persistable and v.name not in ("feed",
                                                             "fetch")])


def test_load_inference_model_runs_with_feeds_only(tmp_path):
    d = str(tmp_path / "t")
    _, req, want = _train_and_save(tfluid, tbert, tfluid.core, d,
                                   tfluid.CPUPlace())
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        prog, feeds, fetches = tio.load_inference_model(d, exe)
    assert feeds == FEEDS
    assert not any(op.type in ("feed", "fetch")
                   for op in prog.global_block().ops)
    got = exe.run(prog, feed=req, fetch_list=fetches, scope=scope)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_save_inference_model_verifies_the_program(tmp_path):
    main, startup, pred = _fc_program(tfluid)
    main.global_block().ops[0].inputs["X"] = ["not_declared"]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    with tfluid.scope_guard(scope), \
            pytest.raises(tanalysis.ProgramVerifyError,
                          match="missing-var-desc"):
        tio.save_inference_model(str(tmp_path), ["x"], [pred], exe, main)
    assert not os.path.exists(tmp_path / "__model__")
