"""The save and load ops, the legacy reader ops and layers, hash and the
stubs of paddle_tpu_torch against the TPU package's, on the CPU
(ops/framework_ops.py's save, load, save_combine, load_combine,
delete_var, fake_init, get_tensor_from_selected_rows and
merge_selected_rows; ops/misc_ops.py's hash; ops/ps_quant_misc_ops.py's
reader ops, cudnn_lstm and engine stubs; fluid/layers/io.py):

- each save op's file byte for byte the TPU package's for the same
  tensors (f32, f16 through ``save_as_fp16``, int32, a 2-level LoD), and
  each package's load ops read the other's files back bitwise;
  ``overwrite=False`` on an existing file raises in both; an int64 var,
  which the TPU package holds as int32 (x64 off) and so saves as INT32,
  saves as INT64 in the port, the same values;
- delete_var, fake_init and the SelectedRows ops on the scope as the TPU
  package leaves it (merge_selected_rows' sums bitwise: the same order);
- the reader ops as tests/test_ps_quant_misc_ops.py drives them;
- the five io layers: the program's data vars as the TPU package's,
  batches through the ``PyReader`` bitwise those fed through ``feed=``,
  ``layers.load`` restoring a saved tensor;
- hash bit for bit: through both executors on ids of the int32 range
  (the TPU package's refuses a wider int64 feed), and kernel to kernel on
  int64 ids at and above 2^31 and negative, which the TPU package takes
  modulo 2^32;
- cudnn_lstm as the lstm op, and the engine and fusion stubs raising.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401 — registers the reference kernels
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.executor import _interpret_op
from paddle_tpu_torch.ops.registry import OPS as TOPS

PKGS = {"jax": (jfluid, jcore), "torch": (tfluid, tcore)}


def _tensors():
    r = np.random.RandomState(0)
    return {"w": (r.randn(3, 5).astype(np.float32), None),
            "ids": (r.randint(-2**31, 2**31, (6, 1)).astype(np.int32), None),
            "seq": (r.randn(5, 2).astype(np.float32), [[0, 1, 2], [0, 2, 5]])}


def _scope_with(pkg, tensors):
    fluid, core = PKGS[pkg]
    scope = core.Scope()
    for n, (a, lod) in tensors.items():
        t = scope.var(n).get_tensor()
        t.set(a, fluid.CPUPlace())
        if lod:
            t.set_lod(lod)
    return scope


def _run_ops(pkg, scope, ops, tensors=None):
    """A program of the raw ``ops`` ((type, inputs, outputs, attrs)), its
    vars declared from ``tensors`` (name → array), run once."""
    fluid, core = PKGS[pkg]
    prog = fluid.Program()
    block = prog.global_block()
    names = {n for _, i, o, _ in ops for v in (*i.values(), *o.values())
             for n in v}
    for n in sorted(names):
        a = (tensors or {}).get(n, (np.zeros(1, np.float32), None))[0]
        block.create_var(name=n, shape=a.shape, dtype=a.dtype,
                         persistable=True)
    for t, i, o, a in ops:
        block.append_op(type=t, inputs=i, outputs=o, attrs=a)
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(prog)
    return scope


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fp16", [False, True])
def test_save_files_are_the_tpu_packages_bytes(tmp_path, fp16):
    tensors = _tensors()
    if fp16:  # save_as_fp16 converts floats; ids stay out of it
        tensors.pop("ids")
    paths = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        ops = [("save", {"X": [n]}, {}, {"file_path": str(d / n),
                                         "save_as_fp16": fp16})
               for n in tensors]
        ops.append(("save_combine", {"X": list(tensors)}, {},
                    {"file_path": str(d / "all"), "save_as_fp16": fp16}))
        _run_ops(pkg, _scope_with(pkg, tensors), ops, tensors)
        paths[pkg] = d
    for n in list(tensors) + ["all"]:
        assert _read(paths["torch"] / n) == _read(paths["jax"] / n), n


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_load_ops_read_the_other_packages_files(tmp_path, writer, reader):
    tensors = _tensors()
    d = tmp_path / writer
    _run_ops(writer, _scope_with(writer, tensors),
             [("save", {"X": [n]}, {}, {"file_path": str(d / n)})
              for n in tensors]
             + [("save_combine", {"X": list(tensors)}, {},
                 {"file_path": str(d / "all")})], tensors)
    core = PKGS[reader][1]
    one = _run_ops(reader, core.Scope(),
                   [("load", {}, {"Out": [n]}, {"file_path": str(d / n)})
                    for n in tensors], tensors)
    combined = _run_ops(reader, core.Scope(),
                        [("load_combine", {}, {"Out": list(tensors)},
                          {"file_path": str(d / "all")})], tensors)
    for scope in (one, combined):
        for n, (a, lod) in tensors.items():
            t = scope.find_var(n).get_tensor()
            got = np.asarray(t.numpy() if reader == "torch" else t.array)
            assert got.dtype == a.dtype and np.array_equal(got, a), n
            assert [list(l) for l in t.lod()] == (lod or []), n


@pytest.mark.parametrize("pkg", list(PKGS))
def test_save_without_overwrite_raises_on_an_existing_file(tmp_path, pkg):
    tensors = {"w": _tensors()["w"]}
    path = str(tmp_path / "w")
    ops = [("save", {"X": ["w"]}, {}, {"file_path": path,
                                       "overwrite": False})]
    _run_ops(pkg, _scope_with(pkg, tensors), ops, tensors)
    with pytest.raises(Exception, match="overwrite is False"):
        _run_ops(pkg, _scope_with(pkg, tensors), ops, tensors)


def test_an_int64_var_saves_its_values_as_int64(tmp_path):
    from paddle_tpu_torch.fluid import io as tio
    ids = np.array([[3], [-2**31], [2**31 - 1]], np.int64)
    tensors = {"ids": (ids, None)}
    files = {}
    for pkg in PKGS:
        path = str(tmp_path / pkg)
        _run_ops(pkg, _scope_with(pkg, tensors),
                 [("save", {"X": ["ids"]}, {}, {"file_path": path})],
                 tensors)
        files[pkg] = tio._deserialize_lod_tensor(_read(path)).array.numpy()
    assert files["torch"].dtype == np.int64
    assert files["jax"].dtype == np.int32   # the TPU package's int64 is int32
    assert np.array_equal(files["torch"], ids)
    assert np.array_equal(files["jax"], ids)


def test_delete_var_and_fake_init_leave_the_scope_alike():
    tensors = {"w": _tensors()["w"],
               "z": (np.zeros((2, 3), np.int64), None)}
    got = {}
    for pkg in PKGS:
        scope = _run_ops(pkg, _scope_with(pkg, {"w": tensors["w"]}), [
            ("delete_var", {"X": ["w"]}, {}, {}),
            ("fake_init", {}, {"Out": ["z"]},
             {"shape": [2, 3], "dtype": int(jcore.VarDesc.VarType.INT64)})],
            tensors)
        z = scope.find_var("z").get_tensor()
        got[pkg] = (scope.find_var("w"),
                    np.asarray(z.numpy() if pkg == "torch" else z.array))
    assert got["jax"][0] is None and got["torch"][0] is None
    assert got["torch"][1].dtype == np.int64
    assert np.array_equal(got["torch"][1], got["jax"][1].astype(np.int64))


def test_selected_rows_ops_merge_in_the_tpu_packages_order():
    r = np.random.RandomState(3)
    rows = [7, 2, 7, 0, 2, 7, 9]
    val = r.randn(len(rows), 4).astype(np.float32) * 1e3
    res = {}
    for pkg, (fluid, core) in PKGS.items():
        scope = core.Scope()
        sr = scope.var("x").get_selected_rows()
        sr.set_rows(rows)
        sr.set_height(10)
        sr.get_tensor().set(val, fluid.CPUPlace())
        _run_ops(pkg, scope, [
            ("merge_selected_rows", {"X": ["x"]}, {"Out": ["m"]}, {}),
            ("get_tensor_from_selected_rows", {"X": ["m"]}, {"Out": ["t"]},
             {})])
        m = scope.find_var("m").get_selected_rows()
        res[pkg] = (list(m.rows()), m.height(),
                    np.asarray(scope.find_var("t").get_tensor().numpy()
                               if pkg == "torch" else
                               scope.find_var("t").get_tensor().array))
    assert res["torch"][:2] == res["jax"][:2] == ([0, 2, 7, 9], 10)
    assert np.array_equal(res["torch"][2], res["jax"][2])


class _Queue:
    def __init__(self, items):
        self.items = list(items)

    def pop(self):
        return self.items.pop(0) if self.items else None


@pytest.mark.parametrize("middle", [None, "create_double_buffer_reader",
                                    "create_custom_reader"])
def test_reader_ops_roundtrip(middle):
    """tests/test_ps_quant_misc_ops.py::test_reader_ops_roundtrip in the
    port: a queue var bound by create_py_reader (through a double-buffer
    or custom reader), two batches read onto the device, then
    StopIteration."""
    batches = [(np.array([[1.0]], np.float32), np.array([[2]], np.int64)),
               (np.array([[3.0]], np.float32),
                tcore.LoDTensor(torch.tensor([[4], [5]]), [[0, 2]]))]
    scope = tcore.Scope()
    scope.var("queue").set_value(_Queue(batches))
    block = tfluid.Program().global_block()
    ops = [block.append_op(type="create_py_reader",
                           inputs={"blocking_queue": ["queue"]},
                           outputs={"Out": ["reader"]})]
    src = "reader"
    if middle:
        ops.append(block.append_op(type=middle,
                                   inputs={"UnderlyingReader": ["reader"]},
                                   outputs={"Out": ["reader2"]}))
        src = "reader2"
    read = block.append_op(type="read", inputs={"Reader": [src]},
                           outputs={"Out": ["x", "y"]})
    cpu = torch.device("cpu")
    for i, op in enumerate(ops):
        _interpret_op(op, i, scope, None, cpu)
    _interpret_op(read, len(ops), scope, None, cpu)
    assert scope.find_var("x").get_tensor().numpy().tolist() == [[1.0]]
    assert scope.find_var("y").get_tensor().numpy().tolist() == [[2]]
    _interpret_op(read, len(ops), scope, None, cpu)
    assert scope.find_var("y").get_tensor().lod() == [[0, 2]]
    with pytest.raises(StopIteration):
        _interpret_op(read, len(ops), scope, None, cpu)


# ------------------------------------------------------------ io layers
def _reader_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        reader = fluid.layers.py_reader(
            capacity=4, shapes=[[-1, 3], [-1, 1]],
            dtypes=["float32", "int64"], lod_levels=[0, 0], name="train",
            use_double_buffer=True)
        reader = fluid.layers.double_buffer(reader)
        x, label = fluid.layers.read_file(reader)
        fc = fluid.layers.fc(x, 4, param_attr=fluid.ParamAttr(
            name="w", initializer=fluid.initializer.Constant(0.5)))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(fc, label))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, reader, loss


def _batches():
    r = np.random.RandomState(5)
    return [(r.randn(2, 3).astype(np.float32),
             r.randint(0, 4, (2, 1)).astype(np.int64)) for _ in range(3)]


def test_io_layers_declare_the_tpu_packages_data_vars():
    progs = {pkg: _reader_program(PKGS[pkg][0]) for pkg in PKGS}
    for pkg, (main, _, reader, _) in progs.items():
        feeds = [(v.name, list(v.shape), int(v.dtype), v.lod_level)
                 for v in PKGS[pkg][0].layers.read_file(reader)]
        progs[pkg] = (feeds, [op.type for op in main.global_block().ops])
    assert progs["torch"] == progs["jax"]
    assert progs["torch"][0][0][:2] == ("train_0", [-1, 3])
    assert "read" not in progs["torch"][1]
    for pkg, (fluid, _) in PKGS.items():
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.data("x", shape=[3], dtype="float32")
            r = fluid.layers.create_py_reader_by_data(2, [x])
            assert fluid.layers.read_file(r) == [x]


def test_py_reader_batches_train_as_the_same_feeds():
    losses = []
    for through_reader in (True, False):
        main, startup, reader, loss = _reader_program(tfluid)
        scope = tcore.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(scope):
            exe.run(startup)
            if through_reader:
                reader.decorate_batch_generator(
                    lambda: iter(_batches()), places=tfluid.CPUPlace())
                feeds = list(reader())
            else:
                feeds = [{"train_0": x, "train_1": y} for x, y in _batches()]
            losses.append([exe.run(main, feed=f, fetch_list=[loss])[0]
                           for f in feeds])
    assert len(losses[0]) == 3
    for a, b in zip(*losses):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_layers_load_restores_what_save_wrote(tmp_path):
    tensors = {"w": _tensors()["w"]}
    path = str(tmp_path / "w")
    _run_ops("jax", _scope_with("jax", tensors),
             [("save", {"X": ["w"]}, {}, {"file_path": path})], tensors)
    got = {}
    for pkg, (fluid, core) in PKGS.items():
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            w = main.global_block().create_var(name="w", shape=[3, 5],
                                               dtype="float32",
                                               persistable=True)
            fluid.layers.load(w, path)
        got[pkg] = [op.type for op in main.global_block().ops]
        scope = core.Scope()
        with fluid.scope_guard(scope):
            fluid.Executor(fluid.CPUPlace()).run(main)
        t = scope.find_var("w").get_tensor()
        assert np.array_equal(
            np.asarray(t.numpy() if pkg == "torch" else t.array),
            tensors["w"][0])
    assert got["torch"] == got["jax"] == ["load"]


# ----------------------------------------------------------------- hash
def _hash_ids(seed, wide):
    r = np.random.RandomState(seed)
    lo, hi = (-2**62, 2**62) if wide else (-2**31, 2**31)
    edge = [[0, 1, 2**31, 2**32 + 5], [-1, -2**40, 7, 2**31 - 1]] if wide \
        else [[0, 1, -2**31, 5], [-1, 2**31 - 1, 7, 123456789]]
    return np.concatenate([np.array(edge), r.randint(lo, hi, (30, 4))]) \
        .astype(np.int64)


@pytest.mark.parametrize("num_hash,mod_by", [(1, 100000), (3, 7),
                                             (2, 2**31 - 1)])
def test_hash_layer_is_the_tpu_packages_bit_for_bit(num_hash, mod_by):
    """Through both executors, on ids of the int32 range (the TPU
    package's executor refuses an int64 feed outside it)."""
    ids = _hash_ids(num_hash, wide=False)
    out = {}
    for pkg, (fluid, core) in PKGS.items():
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = fluid.data("x", shape=[4], dtype="int64")
            h = fluid.layers.hash(x, hash_size=mod_by, num_hash=num_hash)
        with fluid.scope_guard(core.Scope()):
            out[pkg] = np.asarray(fluid.Executor(fluid.CPUPlace()).run(
                main, feed={"x": ids}, fetch_list=[h])[0])
    assert out["torch"].shape == (32, num_hash, 1)
    assert np.array_equal(out["torch"], out["jax"])


@pytest.mark.parametrize("num_hash,mod_by", [(1, 100000), (3, 7),
                                             (2, 2**31 - 1)])
def test_hash_takes_wide_ids_modulo_2_32_as_the_tpu_kernel(num_hash, mod_by):
    """Ids at and above 2^31, above 2^32 and negative, int64: the TPU
    kernel gets them as int32 (x64 off: wrapped modulo 2^32), and the
    port's kernel takes them modulo 2^32 itself."""
    import jax.numpy as jnp
    ids = _hash_ids(num_hash, wide=True)
    attrs = {"num_hash": num_hash, "mod_by": mod_by}
    want = np.asarray(JOPS.get("hash").kernel({"X": [jnp.asarray(ids)]},
                                              attrs)["Out"][0])
    got = TOPS.get("hash").kernel({"X": [torch.from_numpy(ids)]},
                                  attrs)["Out"][0].numpy()
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


# ------------------------------------------------------ alias and stubs
def test_cudnn_lstm_is_the_lstm_op():
    from tests.test_torch_vision_ops import _attrs
    rng = np.random.RandomState(0)
    B, T, I, H = 2, 3, 4, 5
    ins = {"Input": [rng.rand(B, T, I).astype(np.float32)],
           "W": [rng.rand(I * 4 * H + H * 4 * H + 8 * H).astype(np.float32)
                 * 0.1],
           "InitH": [np.zeros((1, B, H), np.float32)],
           "InitC": [np.zeros((1, B, H), np.float32)]}
    attrs = {"hidden_size": H, "num_layers": 1, "input_size": I,
             "is_test": True}
    t = {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}
    got = TOPS.get("cudnn_lstm").kernel(t, _attrs(TOPS, "cudnn_lstm", attrs))
    want = TOPS.get("lstm").kernel(t, _attrs(TOPS, "lstm", attrs))
    import jax.numpy as jnp
    ref = JOPS.get("cudnn_lstm").kernel(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        _attrs(JOPS, "cudnn_lstm", attrs))
    for slot in want:
        for a, b in zip(got[slot], want[slot]):
            assert torch.equal(a, b), slot
    np.testing.assert_allclose(got["Out"][0].numpy(),
                               np.asarray(ref["Out"][0]), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("op_type", [
    "tensorrt_engine", "lite_engine", "fusion_group",
    "conv2d_inception_fusion", "attention_lstm", "fused_embedding_fc_lstm"])
def test_stubs_raise_as_the_tpu_packages_do(op_type):
    for ops in (TOPS, JOPS):
        with pytest.raises(NotImplementedError, match=op_type):
            ops.get(op_type).kernel({}, {})
    t, j = TOPS.get(op_type), JOPS.get(op_type)
    assert (t.no_grad, t.stateful) == (j.no_grad, j.stateful)


def test_save_combine_writes_save_persistables_file(tmp_path):
    """A program of one save_combine op over every persistable, in
    ``fluid.io.save_vars``' order, writes the file
    ``save_persistables(filename=...)`` writes, in both packages (phase
    24 (a) holds the port to it on the card)."""
    files = {}   # each package's own startup values
    for pkg, (fluid, core) in PKGS.items():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.data("x", shape=[3], dtype="float32")
            loss = fluid.layers.mean(fluid.layers.fc(x, 2))
            fluid.optimizer.Adam(0.1).minimize(loss)
        names = [v.name for v in main.list_vars()
                 if v.persistable and v.name not in ("feed", "fetch")]
        scope, exe = core.Scope(), fluid.Executor(fluid.CPUPlace())
        d = tmp_path / pkg
        with fluid.scope_guard(scope):
            exe.run(startup)
            fluid.io.save_persistables(exe, str(d), main,
                                       filename="persistables")
        _run_ops(pkg, scope, [("save_combine", {"X": names}, {},
                               {"file_path": str(d / "all")})])
        files[pkg] = (_read(d / "all"), _read(d / "persistables"))
        assert files[pkg][0] == files[pkg][1], pkg
