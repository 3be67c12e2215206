"""The port's program proto, clone and _prune against the TPU package.

- The codec (paddle_tpu_torch/fluid/proto/framework_pb2.py, plain Python)
  against protoc's generated paddle_tpu/fluid/proto/framework_pb2.py, byte
  for byte: each parses the other's bytes and writes them back unchanged,
  on the golden fixtures and on the programs of BERT (2 layers, hidden
  64, dropout 0 and 0.1), LeNet and ResNet-18 at 32x32.
- The serializer: the port and the TPU package build the same programs
  and write the same bytes; the port's ``parse_from_string(b)
  .serialize_to_string() == b`` for every TPU-package-written ``b``;
  hypothesis-drawn attrs of every AttrType (negative ints, longs, NaN and
  -0.0 floats, non-ASCII strings, empty lists, BLOCK and BLOCKS) write
  the same bytes and parse back to the same values.
- ``clone(for_test=True)`` sets is_test on the same op indices, and
  ``_prune`` keeps the same ops; ``Executor.run(use_prune=True)`` runs
  the slice (a pruned training program does not step its optimizer).
"""
import math
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid.proto import framework_pb2 as gpb
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid.proto import framework_pb2 as tpb
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import resnet as tresnet

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
CFG = dict(vocab_size=128, hidden=64, layers=2, heads=4, ffn=128, max_len=16,
           type_vocab=2)


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


def _bert(fluid, bert, dropout=0.0):
    with fluid.unique_name.guard():
        main, startup, _, _ = bert.build_bert_pretrain_program(
            CFG, seq_len=16, dropout=dropout, lr=1e-3, use_input_mask=True)
    return main, startup


def _lenet(fluid, mnist):
    with fluid.unique_name.guard():
        main, startup = mnist.build_mnist_program(net="conv")[:2]
    return main, startup


def _resnet(fluid, resnet):
    with fluid.unique_name.guard():
        main, startup, _, _ = resnet.build_resnet_train_program(
            depth=18, class_dim=10, image_size=32)
    return main, startup


MODELS = {
    "bert": lambda f, b, m, r: _bert(f, b),
    "bert_dropout": lambda f, b, m, r: _bert(f, b, 0.1),
    "lenet": lambda f, b, m, r: _lenet(f, m),
    "resnet18": lambda f, b, m, r: _resnet(f, r),
}


def _both(name):
    j = MODELS[name](jfluid, jbert, jmnist, jresnet)
    t = MODELS[name](tfluid, tbert, tmnist, tresnet)
    return j, t


def _codec_both_ways(b: bytes):
    """Each codec parses ``b`` and writes it back unchanged."""
    g = gpb.ProgramDesc()
    g.ParseFromString(b)
    t = tpb.ProgramDesc()
    t.ParseFromString(b)
    assert g.SerializeToString() == b
    assert t.SerializeToString() == b


# ------------------------------------------------------------------ codec
@pytest.mark.parametrize("path", ["golden_fc.program.pb",
                                  os.path.join("golden_infer_model",
                                               "__model__")])
def test_codec_on_golden_fixtures(path):
    with open(os.path.join(FIXTURES, path), "rb") as f:
        b = f.read()
    _codec_both_ways(b)
    # protoc wrote these, not the TPU package: both packages' programs
    # write every optional field they hold, so they agree with each other
    p = tframework.Program.parse_from_string(b)
    jp = jframework.Program.parse_from_string(b)
    assert p.serialize_to_string() == jp.serialize_to_string()
    _codec_both_ways(p.serialize_to_string())
    assert [op.type for op in p.global_block().ops] == [
        op.type for op in jp.global_block().ops]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_programs_write_the_reference_bytes(name):
    (jm, js), (tm, ts) = _both(name)
    for jp, tp in ((jm, tm), (js, ts)):
        jb = jp.serialize_to_string()
        assert tp.serialize_to_string() == jb
        _codec_both_ways(jb)
        assert tframework.Program.parse_from_string(jb) \
            .serialize_to_string() == jb
        for for_test in (False, True):
            assert tp.clone(for_test).serialize_to_string() == \
                jp.clone(for_test).serialize_to_string()


def test_codec_field_rules():
    """Field-number order, 10-byte negative varints, fixed32 floats,
    unpacked repeats, presence, unknown fields skipped."""
    for mod in (gpb, tpb):
        a = mod.OpDesc()
        a.type = "t"
        v = a.inputs.add()
        v.parameter = "X"
        v.arguments.extend(["a", "b"])
        at = a.attrs.add()
        at.name = "k"
        at.type = mod.INTS
        at.ints.extend([-1, 2])
        at.f = -0.0
        b = a.SerializeToString()
        if mod is gpb:
            want = b
    assert b == want
    assert b.index(b"\x1a\x01t") > b.index(b"\x0a")  # type (3) after inputs
    assert b"\x30\xff\xff\xff\xff\xff\xff\xff\xff\xff\x01" in b
    assert b"\x25\x00\x00\x00\x80" in b
    unknown = b + b"\xb8\x06\x05" + b"\xc2\x06\x02hi"  # fields 103, 104
    t = tpb.OpDesc()
    t.ParseFromString(unknown)
    assert t.SerializeToString() == b
    vd = tpb.VarDesc()
    vd.name = "v"
    vd.type.type = tpb.VarType.FEED_MINIBATCH
    _ = vd.type.lod_tensor.tensor.dims  # read only: not written
    g = gpb.VarDesc()
    g.name = "v"
    g.type.type = gpb.VarType.FEED_MINIBATCH
    assert vd.SerializeToString() == g.SerializeToString()
    assert not vd.type.HasField("lod_tensor")
    pd = tpb.ProgramDesc()
    pd.version.version = 0
    assert pd.SerializeToString() == b"\x22\x02\x08\x00"
    with pytest.raises(tpb.EncodeError):
        tpb.OpDesc().SerializeToString()  # required type unset


# ------------------------------------------------------------ attrs, fuzz
_i32 = st.integers(-(2**31), 2**31 - 1)
_i64 = st.one_of(st.integers(2**31, 2**63 - 1),
                 st.integers(-(2**63), -(2**31) - 1))
_f32 = st.floats(width=32, allow_nan=True, allow_infinity=True)
_text = st.text(alphabet=st.characters(blacklist_categories=("Cs",)),
                max_size=8)
_ATTR = st.one_of(
    st.booleans(), _i32, _i64, _f32, _text,
    st.lists(st.booleans(), min_size=1, max_size=4),
    st.lists(_i32, min_size=1, max_size=4),
    st.lists(st.one_of(_i32, _i64), min_size=1, max_size=4),
    st.lists(_f32, min_size=1, max_size=4),
    st.lists(_text, min_size=1, max_size=4),
    st.just([]),
    st.sampled_from(["@block1", "@block2"]),
    st.just("@blocks"))


def _attr_program(fw, attrs):
    p = fw.Program()
    for i in (1, 2):
        p.blocks.append(fw.Block(p, i, 0))

    def val(v):
        if v == "@block1":
            return p.block(1)
        if v == "@block2":
            return p.block(2)
        if v == "@blocks":
            return [p.block(2), p.block(1)]
        return v
    blk = p.global_block()
    blk.create_var(name="x", shape=[-1, 3], dtype="float32")
    blk.append_op(type="attr_fuzz_op", inputs={"X": ["x"]},
                  outputs={"Out": ["x"]},
                  attrs={k: val(v) for k, v in attrs.items()})
    return p


def _same_value(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_value(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, float):
        return np.float32(a).tobytes() == np.float32(b).tobytes()
    if hasattr(a, "idx"):
        return a.idx == b.idx
    return a == b and type(a) is type(b)


@settings(max_examples=60, deadline=None, database=None)
@given(st.dictionaries(st.from_regex(r"[a-z][a-z0-9_]{0,6}", fullmatch=True),
                       _ATTR, max_size=6))
def test_attrs_of_every_type_write_the_reference_bytes(attrs):
    jb = _attr_program(jframework, attrs).serialize_to_string()
    tb = _attr_program(tframework, attrs).serialize_to_string()
    assert tb == jb
    _codec_both_ways(jb)
    tp = tframework.Program.parse_from_string(jb)
    assert tp.serialize_to_string() == jb
    jp = jframework.Program.parse_from_string(jb)
    ta = tp.global_block().ops[0].attrs
    ja = jp.global_block().ops[0].attrs
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert _same_value(ja[k], ta[k]), (k, ja[k], ta[k])


def test_attr_types_cover_every_attrtype():
    attrs = {"i": -3, "l": 2**40, "f": -0.0, "n": math.nan, "s": "ünï",
             "ints": [1, -2], "longs": [2**40, -1], "floats": [0.5],
             "strs": ["a", "é"], "b": True, "bools": [False, True],
             "e": [], "blk": "@block1", "blks": "@blocks"}
    p = _attr_program(tframework, attrs)
    od = p.desc_proto().blocks[0].ops[0]
    types = {a.name: a.type for a in od.attrs}
    assert types == {"i": tpb.INT, "l": tpb.LONG, "f": tpb.FLOAT,
                     "n": tpb.FLOAT, "s": tpb.STRING, "ints": tpb.INTS,
                     "longs": tpb.LONGS, "floats": tpb.FLOATS,
                     "strs": tpb.STRINGS, "b": tpb.BOOLEAN,
                     "bools": tpb.BOOLEANS, "e": tpb.INTS,
                     "blk": tpb.BLOCK, "blks": tpb.BLOCKS}
    assert p.serialize_to_string() == \
        _attr_program(jframework, attrs).serialize_to_string()


# ----------------------------------------------------------- clone, prune
def _is_test_indices(program):
    return [i for i, op in enumerate(program.global_block().ops)
            if op.attrs.get("is_test") is True]


@pytest.mark.parametrize("name", ["bert_dropout", "resnet18"])
def test_clone_for_test_sets_is_test_where_the_reference_does(name):
    (jm, _), (tm, _) = _both(name)
    assert _is_test_indices(tm) == _is_test_indices(jm) == []
    want = _is_test_indices(jm.clone(for_test=True))
    assert want, "the program has no op with an is_test attr"
    assert _is_test_indices(tm.clone(for_test=True)) == want
    assert _is_test_indices(tm) == []  # the original is untouched


def _mlm_targets(program):
    ops = program.global_block().ops
    sm = [o for o in ops if o.type == "softmax_with_cross_entropy"][0]
    gather = [o for o in ops if o.type == "gather"][0]
    return [gather.input("X")[0], sm.input("Logits")[0]]


@pytest.mark.parametrize("which", [0, 1, None])
def test_prune_keeps_the_reference_ops(which):
    (jm, _), (tm, _) = _both("bert_dropout")
    targets = _mlm_targets(jm)
    targets = targets if which is None else targets[which]
    jp = jm.clone(for_test=True)._prune(targets)
    tp = tm.clone(for_test=True)._prune(targets)
    assert [o.type for o in tp.global_block().ops] == \
        [o.type for o in jp.global_block().ops]
    assert sorted(tp.global_block().vars) == sorted(jp.global_block().vars)
    assert tp.serialize_to_string() == jp.serialize_to_string()
    assert not any(o.type.endswith("_grad") or o.type == "adam"
                   for o in tp.global_block().ops)


def test_clone_keeps_amp_dynamic_state():
    from paddle_tpu_torch.fluid.contrib.mixed_precision import decorate
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.data("x", shape=[4], dtype="float32")
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 3))
        decorate(tfluid.optimizer.SGD(0.1), use_fp16=True,
                 use_dynamic_loss_scaling=True).minimize(loss)
    assert main._amp_dynamic
    c = main.clone()
    assert c._amp_dynamic == main._amp_dynamic
    assert c._amp_dynamic is not main._amp_dynamic


def test_executor_use_prune_runs_the_slice():
    with tfluid.unique_name.guard():
        main, startup, _, (loss,) = tbert.build_bert_pretrain_program(
            CFG, seq_len=16, lr=1e-3, use_input_mask=True)
    startup.random_seed = 3
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    r = np.random.RandomState(0)
    feed = {"src_ids": r.randint(0, 128, (2, 16)),
            "pos_ids": np.tile(np.arange(16), (2, 1)),
            "sent_ids": r.randint(0, 2, (2, 16)),
            "input_mask": np.ones((2, 16), np.float32),
            "mask_pos": r.randint(0, 32, (5, 1)),
            "mask_label": r.randint(0, 128, (5, 1))}
    w = scope.find_var("word_embedding").value().array.clone()
    enc, logits = _mlm_targets(main)
    fwd = {k: v for k, v in feed.items() if k != "mask_label"}
    a = exe.run(main, feed=fwd, fetch_list=[logits], scope=scope,
                use_prune=True)[0]
    b = exe.run(main, feed=fwd, fetch_list=[logits], scope=scope,
                use_prune=True)[0]
    assert np.array_equal(a, b)
    assert scope.find_var("word_embedding").value().array.equal(w)
    assert list(main._prune_cache) == [(main._version, (logits,))]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert not scope.find_var("word_embedding").value().array.equal(w)
