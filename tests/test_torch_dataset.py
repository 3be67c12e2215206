"""The Dataset path of paddle_tpu_torch against the TPU package, on the CPU
(fluid/dataset.py, native/, Executor.train_from_dataset,
DataLoader.from_dataset):

- the port builds its own copy of datafeed.cpp (byte for byte the TPU
  package's) into build/paddle_tpu_torch/, named by its hash;
- batches, LoDs and the ``local_shuffle(seed)`` order against the TPU
  package's ``_iter_batches`` over the same slot files: equal with one
  parser thread or one file; with four threads over several files the
  order depends on which thread read which file, so the records are
  compared as a multiset;
- train_from_dataset and infer_from_dataset on tests/test_dataset.py's
  model from the TPU package's startup values: the ``print_period`` lines
  and the parameters at rtol 1e-4, atol 1e-5; a FetchHandler's samples;
- window_size: LoD batches run step by step, dense ones as windows, both
  bitwise the step-by-step run;
- a killed and resumed train_from_dataset (checkpoint_dir, resume_from)
  bitwise an unbroken one;
- DataLoader.from_dataset against the TPU package's ``_iter_batches``,
  with and without drop_last;
- Wide&Deep from slot files: every slot and the label arrive with LoD
  [0, 1, ..., B], the step runs segmented around the auc island, and the
  losses and parameters are bitwise those of the same batches fed dense.
"""
import os
import re

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu_torch import fluid
from paddle_tpu_torch import native
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import wide_deep

RTOL, ATOL = 1e-4, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these small kernels gain nothing from more,
    several test processes share the host's cores, and the CPU's BLAS
    may split a product differently from call to call when its threads
    are contended, which the bitwise checks here would see."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_slot_file(path, rows):
    """rows: (ids, dense, label) lists, in the data feed's grammar:
    ``<n> v1 .. vn`` per slot (paddle_tpu/native/datafeed.cpp:12-16)."""
    with open(path, "w") as f:
        for ids, dense, label in rows:
            parts = [str(len(ids))] + [str(i) for i in ids]
            parts += [str(len(dense))] + [f"{v:.4f}" for v in dense]
            parts += [str(len(label))] + [str(v) for v in label]
            f.write(" ".join(parts) + "\n")


def make_files(tmp_path, n_files=2, rows_per_file=8, seed=0):
    rng = np.random.RandomState(seed)
    files = []
    for k in range(n_files):
        rows = [(rng.randint(0, 20, rng.randint(1, 5)).tolist(),
                 rng.rand(4).round(4).tolist(), [int(rng.randint(0, 2))])
                for _ in range(rows_per_file)]
        p = str(tmp_path / f"part-{k}.txt")
        write_slot_file(p, rows)
        files.append(p)
    return files


def _model(fl, train=True):
    """tests/test_dataset.py's model. → (main, startup, [ids, dense,
    label], loss)."""
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 9
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        ids = fl.data("ids", shape=[1], dtype="int64", lod_level=1)
        dense = fl.data("dense", shape=[4], dtype="float32")
        label = fl.data("label", shape=[1], dtype="int64")
        emb = fl.layers.embedding(ids, size=[20, 8])
        pooled = fl.layers.sequence_pool(emb, "sum")
        feat = fl.layers.concat([pooled, dense], axis=1)
        pred = fl.layers.fc(feat, 2, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(pred, label))
        if train:
            fl.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [ids, dense, label], loss


def _dataset(fl, use_vars, files, threads=1, batch=4, shuffle=None):
    ds = fl.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(batch)
    ds.set_thread(threads)
    ds.set_filelist(files)
    ds.set_use_var(use_vars)
    ds.load_into_memory()
    if shuffle is not None:
        ds.local_shuffle(seed=shuffle)
    return ds


def _host(t):
    a = t.array
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_the_port_builds_its_own_datafeed():
    src = os.path.join(ROOT, "paddle_tpu_torch", "native", "datafeed.cpp")
    with open(src, "rb") as a, open(os.path.join(
            ROOT, "paddle_tpu", "native", "datafeed.cpp"), "rb") as b:
        assert a.read() == b.read()
    lib = native.datafeed_lib()
    assert os.path.dirname(lib._name) == os.path.join(
        ROOT, "build", "paddle_tpu_torch")
    assert re.fullmatch(r"libdatafeed-[0-9a-f]{16}\.so",
                        os.path.basename(lib._name))


@pytest.mark.parametrize("threads,n_files,exact", [
    (1, 3, True), (4, 1, True), (4, 3, False)])
def test_batches_and_shuffle_match_the_tpu_package(tmp_path, threads,
                                                   n_files, exact):
    files = make_files(tmp_path, n_files=n_files)
    tds = _dataset(fluid, _model(fluid)[2], files, threads)
    jds = _dataset(jfluid, _model(jfluid)[2], files, threads)
    for shuffle in (None, 3):
        if shuffle is not None:
            tds.local_shuffle(seed=shuffle)
            jds.local_shuffle(seed=shuffle)
        tb, jb = list(tds._iter_batches()), list(jds._iter_batches())
        assert len(tb) == len(jb) == -(-n_files * 8 // 4)
        if exact:
            for t, j in zip(tb, jb):
                assert sorted(t) == sorted(j)
                for k in j:
                    assert np.array_equal(_host(t[k]), _host(j[k])), k
                    assert t[k].lod() == j[k].lod(), k
            continue

        def records(batches):
            out = []
            for b in batches:
                offs = b["ids"].lod()[0]
                ids = _host(b["ids"]).reshape(-1)
                for i in range(len(offs) - 1):
                    out.append((tuple(ids[offs[i]:offs[i + 1]]),
                                tuple(_host(b["dense"])[i]),
                                int(_host(b["label"])[i, 0])))
            return sorted(out)
        assert records(tb) == records(jb)


def _start_alike(jmain, jstart, tmain, tstart):
    jexe, jscope = jfluid.Executor(), jcore.Scope()
    texe, tscope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    names = sorted(v.name for v in jmain.global_block().vars.values()
                   if v.persistable)
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    texe.run(tstart, scope=tscope)
    set_params_from_numpy(tscope, {
        n: np.asarray(jscope.find_var(n).get_tensor().array) for n in names})
    return jexe, jscope, texe, tscope, names


def _printed(text):
    return [(int(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"\[train_from_dataset\] step (\d+): loss=([-\d.]+)", text)]


def test_train_and_infer_from_dataset_match_the_tpu_package(tmp_path,
                                                            capsys):
    files = make_files(tmp_path, n_files=2, rows_per_file=8)
    jmain, jstart, jvars, jloss = _model(jfluid)
    tmain, tstart, tvars, tloss = _model(fluid)
    jexe, jscope, texe, tscope, names = _start_alike(jmain, jstart, tmain,
                                                     tstart)
    jds, tds = _dataset(jfluid, jvars, files), _dataset(fluid, tvars, files)
    seen = []

    class H(fluid.FetchHandler):
        def handler(self, res_dict):
            seen.append(res_dict["w"])

    w = tmain.global_block().all_parameters()[0]
    for epoch in range(2):
        with jfluid.scope_guard(jscope):
            jexe.train_from_dataset(jmain, jds, fetch_list=[jloss],
                                    fetch_info=["loss"], print_period=1)
        jtext = capsys.readouterr().out
        texe.train_from_dataset(
            tmain, tds, scope=tscope, fetch_list=[tloss],
            fetch_info=["loss"], print_period=1,
            fetch_handler=H({"w": w}, period_secs=60) if epoch else None)
        ttext = capsys.readouterr().out
        jp, tp = _printed(jtext), _printed(ttext)
        assert [s for s, _ in tp] == [s for s, _ in jp] == [0, 1, 2, 3]
        np.testing.assert_allclose([v for _, v in tp], [v for _, v in jp],
                                   rtol=RTOL, atol=ATOL)
    assert texe._last_run_mode == "compiled"
    assert len(seen) == 1 and np.array_equal(
        seen[0], tscope.find_var(w.name).value().array.numpy())
    for n in names:
        np.testing.assert_allclose(
            tscope.find_var(n).value().array.numpy(),
            np.asarray(jscope.find_var(n).get_tensor().array), rtol=RTOL,
            atol=ATOL, err_msg=n)
    # inference over the trained parameters: the same last fetch
    jinf, _, _, jiloss = _model(jfluid, train=False)
    tinf, _, _, tiloss = _model(fluid, train=False)
    with jfluid.scope_guard(jscope):
        (jl,) = jexe.infer_from_dataset(jinf, jds, fetch_list=[jiloss],
                                        print_period=0)
    (tl,) = texe.infer_from_dataset(tinf, tds, scope=tscope,
                                    fetch_list=[tiloss], print_period=0)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=RTOL, atol=ATOL)


def _dense_model():
    """Every slot a float: x [1], dense [4] and y [1], regressed."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[1], dtype="float32")
        dense = fluid.data("dense", shape=[4], dtype="float32")
        y = fluid.data("y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(fluid.layers.concat([x, dense], axis=1), 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, [x, dense, y], loss


def _train(files, window_size, model):
    main, startup, use, loss = model
    ds = _dataset(fluid, use, files)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    out = exe.train_from_dataset(main, ds, scope=scope, fetch_list=[loss],
                                 print_period=0, window_size=window_size)
    return out, {v.name: scope.find_var(v.name).value().array.clone()
                 for v in main.global_block().vars.values()
                 if v.persistable}


def test_window_size_stacks_dense_batches_and_steps_lod_ones(tmp_path):
    files = make_files(tmp_path, n_files=2, rows_per_file=8)
    dense_file = str(tmp_path / "dense.txt")
    rng = np.random.RandomState(1)
    with open(dense_file, "w") as f:
        for _ in range(16):
            f.write("1 %.3f 4 %s 1 %.3f\n" % (
                rng.rand(), " ".join("%.3f" % v for v in rng.rand(4)),
                rng.rand()))
    for fs, model in ((files, _model(fluid)), ([dense_file], _dense_model())):
        one, s1 = _train(fs, 1, model)
        two, s2 = _train(fs, 2, model)
        # a window returns its steps stacked: the last is the last step's
        assert np.array_equal(np.asarray(one[0]).reshape(-1)[-1],
                              np.asarray(two[0]).reshape(-1)[-1])
        for n in s1:
            assert torch.equal(s1[n], s2[n]), n


def test_killed_and_resumed_matches_an_unbroken_run(tmp_path):
    files = make_files(tmp_path, n_files=2, rows_per_file=8)
    main, startup, use, loss = _model(fluid)
    per_epoch = 4

    def fresh():
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        return exe, scope, _dataset(fluid, use, files)

    def state(scope):
        return {v.name: scope.find_var(v.name).value().array.clone()
                for v in main.global_block().vars.values() if v.persistable}

    exe, scope, ds = fresh()
    for _ in range(2):
        want = exe.train_from_dataset(main, ds, scope=scope,
                                      fetch_list=[loss], print_period=0)
    want_state = state(scope)
    ckpt = str(tmp_path / "ckpt")
    exe, scope, ds = fresh()
    exe.train_from_dataset(main, ds, scope=scope, fetch_list=[loss],
                           print_period=0, checkpoint_dir=ckpt,
                           checkpoint_every_n_steps=1)
    # killed after its first pass: the newest checkpoint is that pass's
    # last step (the startup run counts one)
    assert sorted(os.listdir(ckpt))[-1].endswith(str(1 + per_epoch))
    del exe, scope
    exe, scope, ds = fresh()
    got = exe.train_from_dataset(main, ds, scope=scope, fetch_list=[loss],
                                 print_period=0, resume_from=ckpt)
    assert np.array_equal(got[0], want[0])
    got_state = state(scope)
    for n in want_state:
        assert torch.equal(got_state[n], want_state[n]), n


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_from_dataset_against_iter_batches(tmp_path, drop_last):
    files = make_files(tmp_path, n_files=1, rows_per_file=10)
    tds = _dataset(fluid, _model(fluid)[2], files, batch=4)
    jds = _dataset(jfluid, _model(jfluid)[2], files, batch=4)
    ldr = fluid.DataLoader.from_dataset(tds, fluid.CPUPlace(),
                                        drop_last=drop_last)
    got = list(ldr)
    want = list(jds._iter_batches())
    assert len(want) == 3 and len(got) == (2 if drop_last else 3)
    for t, j in zip(got, want):
        for k in j:
            assert np.array_equal(_host(t[k]), _host(j[k]))
            assert t[k].lod() == j[k].lod()


def _ctr_files(tmp_path, batches, slots):
    """``batches`` (ctr_reader feeds) as slot files: label first, then
    the dense features, then one id a slot."""
    path = str(tmp_path / "ctr.txt")
    with open(path, "w") as f:
        for b in batches:
            for i in range(len(b["label"])):
                parts = ["1", str(int(b["label"][i, 0])), "13"]
                parts += ["%r" % float(v) for v in b["dense"][i]]
                for s in range(slots):
                    parts += ["1", str(int(b["slot_%d" % s][i, 0]))]
                f.write(" ".join(parts) + "\n")
    return [path]


def test_wide_deep_from_slot_files_matches_dense_feeds(tmp_path):
    slots, batch = 4, 64
    nb = wide_deep.ctr_reader(batch, num_slots=slots, sparse_dim=1000,
                              seed=0)
    files = _ctr_files(tmp_path, [nb() for _ in range(3)], slots)

    def run(from_dataset):
        with fluid.unique_name.guard():
            main, startup, feeds, loss, auc = \
                wide_deep.build_wide_deep_program(
                    num_slots=slots, sparse_dim=1000, embedding_dim=8,
                    hidden=(32, 32))
        block = main.global_block()
        use = [block.var(n) for n in ["label", "dense"]
               + ["slot_%d" % s for s in range(slots)]]
        ds = _dataset(fluid, use, files, threads=4, batch=batch, shuffle=7)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        exe.run(startup, scope=scope)
        losses = []
        for f in ds._iter_batches():
            assert all(f[n].lod() == [list(range(batch + 1))]
                       for n in f if n != "dense")
            if not from_dataset:
                f = {n: _host(t) for n, t in f.items()}
            losses.append(exe.run(main, feed=f, fetch_list=[loss, auc],
                                  scope=scope))
        if from_dataset:
            # the same pass again, through train_from_dataset
            last = exe.train_from_dataset(main, ds, scope=scope,
                                          fetch_list=[loss, auc],
                                          print_period=0)
        else:
            for f in ds._iter_batches():
                last = exe.run(main, feed={n: _host(t) for n, t in
                                           f.items()},
                               fetch_list=[loss, auc], scope=scope)
        assert exe._last_run_mode == "segmented"
        return losses + [last], {
            v.name: scope.find_var(v.name).value().array.clone()
            for v in main.global_block().vars.values() if v.persistable}

    lod_out, lod_state = run(True)
    dense_out, dense_state = run(False)
    for a, b in zip(lod_out, dense_out):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    for n in dense_state:
        assert torch.equal(lod_state[n], dense_state[n]), n


def test_chip_smoke_phase_18_rehearsed(monkeypatch):
    """phase_lod on the CPU at small sizes: every comparison it makes on
    the card (compiled against interpreted bitwise, card against CPU port,
    the dataset run against dense feeds bitwise, the ops), with no kernel
    to count and no graph to capture."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    zeros = cs.NO_KERNELS
    monkeypatch.setattr(fluid, "CUDAPlace", lambda i=0: fluid.CPUPlace())
    for name, value in (("LOD_DEVICE", "cpu"), ("LOD_BATCH", 4),
                        ("LOD_STEPS", 20), ("LOD_TIMED", 2),
                        ("LOD_FIXED_EXECS", ("eager",) * 5),
                        ("WD_SPARSE_DIM", 1000), ("WD_BATCH", 64),
                        ("_launch_counts", lambda: zeros)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_drop", lambda exe: exe.close())

    def gate(exe, delta, want, what):
        assert exe._last_run_mode == "compiled", what
        return exe._last_block.last_exec
    monkeypatch.setattr(cs, "_gate_run", gate)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **k: 0)
    lines = []
    monkeypatch.setattr(cs, "_log", lambda *a: lines.append(" ".join(
        str(x) for x in a)))
    out = cs.phase_lod()
    assert out == {"wrapper": zeros, "executed": zeros}
    text = "\n".join(lines)
    assert "FAIL" not in text
    for want in ("(a) sentiment conv net", "(b) Wide&Deep",
                 "printed the dense loop's 16 lines", "(c) 24 cases",
                 "phase 18 in"):
        assert want in text, (want, text)
