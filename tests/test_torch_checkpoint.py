"""The checkpoint plane of paddle_tpu_torch (fluid/io.py save_checkpoint,
validate_checkpoint, latest_checkpoint, load_checkpoint;
Executor.set_auto_checkpoint and resume_from) against the TPU package's,
on the CPU:

- each case of tests/test_checkpoint.py run against the port: slots and
  the step counter round-trip, a corrupted or torn checkpoint is never
  selected, validation names every problem, a missing file of load_vars
  is named with the others, the DataLoader's state rides the manifest;
- the port's checkpoint directory equals the TPU package's byte for byte,
  every file and MANIFEST.json, from the same numpy values at the same
  global step (the reference's Adam MLP and a small BERT);
- a checkpoint of either package resumes in the other: the next 4 losses
  of the small BERT at dropout 0 agree within test_torch_train_slice.py's
  rtol = atol = 1e-5;
- a port run killed and resumed in process at dropout 0.1 gives the
  losses and the persistables of the unbroken run bitwise, per step
  (compiled and interpreted) and in windows of a DataLoader;
- the step counter after the startup and N steps equals the TPU
  package's ``Executor._rng_counters[scope]``, and a restore leaves it an
  int64 tensor on the executor's device without building a new block.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid.param_bridge import set_params_from_numpy
from paddle_tpu_torch.models import bert as tbert

from tests import faultinject as FI

CFG = dict(vocab_size=128, hidden=64, layers=2, heads=4, ffn=128, max_len=16,
           type_vocab=2)  # tests/test_torch_train_slice.py's
S, B, N_MASK = 16, 4, 10
LOSS_TOL = 1e-5  # tests/test_torch_train_slice.py's, losses across packages


@pytest.fixture
def mode():
    """Set FLAGS_executor_mode for one test and restore it."""
    saved = tcore.globals_["FLAGS_executor_mode"]
    yield lambda m: tcore.set_flag("FLAGS_executor_mode", m)
    tcore.set_flag("FLAGS_executor_mode", saved)


def _adam_net(fluid, dropout=0.3):
    """The reference's Adam MLP (tests/test_checkpoint.py:22)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.data("x", shape=[6], dtype="float32")
        y = fluid.data("y", shape=[1], dtype="float32")
        h = fluid.layers.fc(x, 8, act="relu")
        h = fluid.layers.dropout(h, dropout_prob=dropout)
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _feed(step):
    rs = np.random.RandomState(99 + step)
    X = rs.rand(8, 6).astype(np.float32)
    return {"x": X, "y": X.sum(1, keepdims=True).astype(np.float32)}


def _bert(fluid, dropout=0.0):
    """The small BERT pretraining step of either package."""
    bert = jbert if fluid is jfluid else tbert
    with fluid.unique_name.guard():
        main, startup, _, fetches = bert.build_bert_pretrain_program(
            CFG, seq_len=S, dropout=dropout, lr=1e-3, use_input_mask=True)
    startup.random_seed = 5
    return main, startup, fetches[0]


def _bert_feed(step):
    r = np.random.RandomState(step)
    mask = np.ones((B, S), np.float32)
    mask[0, 10:] = 0.0
    mask[2, 5:] = 0.0
    return {"src_ids": r.randint(0, CFG["vocab_size"], (B, S)),
            "pos_ids": np.tile(np.arange(S), (B, 1)),
            "sent_ids": r.randint(0, CFG["type_vocab"], (B, S)),
            "mask_pos": r.randint(0, B * S, (N_MASK, 1)),
            "mask_label": r.randint(0, CFG["vocab_size"], (N_MASK, 1)),
            "input_mask": mask}


def _port(build, *args):
    main, startup, loss = build(tfluid, *args)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    return main, startup, loss, exe, scope


def _jax(build, *args):
    main, startup, loss = build(jfluid, *args)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jcore.Scope()
    exe.run(startup, scope=scope)
    _on_device(scope, main)
    return main, startup, loss, exe, scope


def _on_device(scope, program):
    """The TPU package's persistables put on its CPU device: arrays that
    carry their device's sharding, as a step's outputs do, so that the
    step compiles once rather than again at its second run."""
    for v in program.list_vars():
        sv = scope.find_var(v.name) if v.persistable else None
        if sv is not None and sv.is_initialized():
            t = sv.get_tensor()
            t.set(np.asarray(t.array), jfluid.CPUPlace())


def _loss(exe, main, feed, loss, scope):
    return float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]).reshape(-1)[0])


def _persistables(scope, program):
    out = {}
    for v in program.list_vars():
        sv = scope.find_var(v.name) if v.persistable else None
        if sv is not None and sv.is_initialized():
            out[v.name] = sv.value().array.clone().numpy()
    return out


def _jax_arrays(scope, program):
    return {v.name: np.asarray(scope.find_var(v.name).get_tensor().array)
            for v in program.list_vars() if v.persistable
            and scope.find_var(v.name) is not None
            and scope.find_var(v.name).is_initialized()}


# ------------------------------------------- tests/test_checkpoint.py's
@pytest.mark.parametrize("run_mode", ["compiled", "interpreted"])
def test_checkpoint_roundtrip_optimizer_slots_and_rng_counter(
        tmp_path, mode, run_mode):
    mode(run_mode)
    main, startup, loss, exe, scope_a = _port(_adam_net)
    for step in range(4):
        exe.run(main, feed=_feed(step), fetch_list=[loss], scope=scope_a)
    ckpt = tfluid.save_checkpoint(exe, str(tmp_path), main, scope=scope_a,
                                  global_step=5)
    manifest = tfluid.validate_checkpoint(ckpt)
    saved = {n: scope_a.find_var(n).value().array.clone().numpy()
             for n in manifest["files"]}
    assert any("_moment1_" in n for n in manifest["files"]), manifest
    assert any("_moment2_" in n for n in manifest["files"]), manifest
    assert any("_beta1_pow_acc_" in n for n in manifest["files"]), manifest
    assert manifest["rng_counter"] == 5  # startup + 4 train steps
    assert manifest["global_step"] == 5

    # a fresh scope (same program, same names): every array bitwise, the
    # counter restored, and the next step's loss (dropout included) the
    # original scope's exactly
    exe_b, scope_b = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe_b.run(startup, scope=scope_b)
    m = tfluid.load_checkpoint(exe_b, str(tmp_path), main, scope=scope_b)
    assert m["global_step"] == 5
    for n, ref in saved.items():
        np.testing.assert_array_equal(
            scope_b.find_var(n).value().array.numpy(), ref, err_msg=n)
    counter = scope_b.find_var("@RNG_COUNTER@").value().array
    assert counter.dtype == torch.int64 and counter.tolist() == [5]
    assert tfluid.Executor._rng_counters[scope_b] == 5
    la = _loss(exe, main, _feed(4), loss, scope_a)
    lb = _loss(exe_b, main, _feed(4), loss, scope_b)
    assert la == lb


@pytest.mark.parametrize("how", ["truncate", "flip", "delete", "manifest"])
def test_corrupted_checkpoint_never_selected(tmp_path, how):
    """A checkpoint damaged mid-save loses to the previous intact one."""
    main, startup, loss, exe, scope = _port(_adam_net)
    exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
    good = tfluid.save_checkpoint(exe, str(tmp_path), main, scope=scope,
                                  global_step=5)
    exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope)
    bad = tfluid.save_checkpoint(exe, str(tmp_path), main, scope=scope,
                                 global_step=10)
    FI.corrupt_checkpoint(bad, how)
    with pytest.raises(tcore.CheckpointError):
        tfluid.validate_checkpoint(bad)
    assert tfluid.latest_checkpoint(str(tmp_path)) == good
    m = tfluid.load_checkpoint(exe, str(tmp_path), main,
                               scope=tfluid.Scope())
    assert m["global_step"] == 5


def test_validation_aggregates_every_problem(tmp_path):
    main, startup, loss, exe, scope = _port(_adam_net)
    ckpt = tfluid.save_checkpoint(exe, str(tmp_path), main, scope=scope,
                                  global_step=1)
    names = sorted(tfluid.validate_checkpoint(ckpt)["files"])
    assert len(names) >= 4
    victim_a, victim_b = names[0], names[1]
    os.remove(os.path.join(ckpt, victim_a))
    with open(os.path.join(ckpt, victim_b), "r+b") as f:
        f.truncate(3)
    with pytest.raises(tcore.CheckpointError) as ei:
        tfluid.validate_checkpoint(ckpt)
    msg = str(ei.value)
    assert victim_a in msg and victim_b in msg, msg
    assert "2 problem(s)" in msg, msg


def test_torn_tmp_dir_never_selected_and_gets_pruned(tmp_path):
    """A kill mid-save leaves only a .tmp-* directory: never a candidate,
    and the next save removes it."""
    main, startup, loss, exe, scope = _port(_adam_net)
    good = tfluid.save_checkpoint(exe, str(tmp_path), main, scope=scope,
                                  global_step=5)
    torn = tmp_path / ".tmp-ckpt-7-12345"
    torn.mkdir()
    (torn / "w1").write_bytes(b"partial")
    assert tfluid.latest_checkpoint(str(tmp_path)) == good
    tfluid.save_checkpoint(exe, str(tmp_path), main, scope=scope,
                           global_step=9)
    assert not torn.exists()


def test_load_vars_reports_all_missing_files(tmp_path):
    main, startup, loss, exe, scope = _port(_adam_net)
    with tfluid.scope_guard(scope):
        tfluid.save_persistables(exe, str(tmp_path), main)
    saved = sorted(os.listdir(str(tmp_path)))
    assert len(saved) >= 4
    os.remove(os.path.join(str(tmp_path), saved[0]))
    os.remove(os.path.join(str(tmp_path), saved[1]))
    with tfluid.scope_guard(scope):
        with pytest.raises(tcore.CheckpointError) as ei:
            tfluid.load_persistables(exe, str(tmp_path), main)
    msg = str(ei.value)
    assert saved[0] in msg and saved[1] in msg, msg
    assert "2 checkpoint file(s) missing" in msg, msg


def test_dataloader_state_roundtrip_fast_forwards(tmp_path):
    def gen():
        for i in range(10):
            yield {"x": np.full((2, 3), float(i), np.float32)}

    def make_loader():
        ldr = tfluid.reader.DataLoader.from_generator(feed_list=["x"],
                                                      capacity=2)
        ldr.set_batch_generator(gen, places=tfluid.CPUPlace())
        return ldr

    ldr = make_loader()
    it = iter(ldr)
    for _ in range(4):
        batch = next(it)
    assert batch["x"][0, 0] == 3.0
    state = ldr.state_dict()
    assert state == {"epoch": 0, "position": 4}
    main, startup, loss, exe, scope = _port(_adam_net)
    tfluid.save_checkpoint(exe, str(tmp_path), main, scope=scope,
                           global_step=1, dataloader_state=state)
    manifest = tfluid.load_checkpoint(exe, str(tmp_path), main, scope=scope)
    assert manifest["dataloader"] == state
    fresh = make_loader()
    fresh.load_state_dict(manifest["dataloader"])
    assert [b["x"][0, 0] for b in fresh] == [4.0, 5.0, 6.0, 7.0, 8.0, 9.0]
    assert fresh.state_dict() == {"epoch": 1, "position": 0}


def test_half_matched_restore_is_refused(tmp_path):
    """A net rebuilt without unique_name.guard names its parameters fc_2.*
    where the checkpoint holds fc_0.*: load_checkpoint raises before it
    touches the scope (the TPU package's io.py:745-763)."""
    main, startup, loss, exe, scope = _port(_adam_net)
    tfluid.save_checkpoint(exe, str(tmp_path), main, scope=scope,
                           global_step=1)
    other, ostart = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(other, ostart), tfluid.unique_name.guard():
        x = tfluid.data("x", shape=[6], dtype="float32")
        tfluid.layers.fc(x, 8)  # a first fc: the net's are fc_1 and fc_2
        tfluid.layers.fc(tfluid.layers.fc(x, 8), 1)
    scope2 = tfluid.Scope()
    exe.run(ostart, scope=scope2)
    before = _persistables(scope2, other)
    with pytest.raises(tcore.CheckpointError, match="does not cover"):
        tfluid.load_checkpoint(exe, str(tmp_path), other, scope=scope2)
    after = _persistables(scope2, other)
    for n in before:
        np.testing.assert_array_equal(before[n], after[n])
    assert tfluid.Executor._rng_counters[scope2] == 1  # untouched


# --------------------------------------------- against the TPU package
@pytest.mark.parametrize("net", ["adam_mlp", "bert"])
def test_checkpoint_bytes_equal_jax_package(tmp_path, net):
    """Both packages train 2 steps from their own startups, the port's
    scope then takes the TPU package's values: at the same global step
    (3) both checkpoint directories are the same bytes, file for file,
    MANIFEST.json included."""
    build, feed = ((_adam_net, _feed) if net == "adam_mlp"
                   else (_bert, _bert_feed))
    jm, js, jl, jexe, jscope = _jax(build)
    tm, ts, tl, texe, tscope = _port(build)
    for step in range(2):
        jexe.run(jm, feed=feed(step), fetch_list=[jl], scope=jscope)
        texe.run(tm, feed=feed(step), fetch_list=[tl], scope=tscope)
    arrays = _jax_arrays(jscope, jm)
    assert sorted(arrays) == sorted(_persistables(tscope, tm))
    set_params_from_numpy(tscope, arrays)
    with jfluid.scope_guard(jscope):
        jdir = jfluid.save_checkpoint(jexe, str(tmp_path / "jax"), jm,
                                      scope=jscope, global_step=3,
                                      extra={"net": net})
    tdir = tfluid.save_checkpoint(texe, str(tmp_path / "port"), tm,
                                  scope=tscope, global_step=3,
                                  extra={"net": net})
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert "MANIFEST.json" in names and len(names) == len(arrays) + 1
    for n in names:
        assert filecmp.cmp(os.path.join(jdir, n), os.path.join(tdir, n),
                           shallow=False), n
    assert tfluid.validate_checkpoint(tdir)["rng_counter"] == 3


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, direction):
    """The small BERT at dropout 0: one package trains 2 steps and saves;
    the other loads the checkpoint into a scope of its own startup and
    takes 4 steps, which agree with the saver's next 4 within
    rtol = atol = 1e-5 (the packages sum in other orders)."""
    jm, js, jl, jexe, jscope = _jax(_bert)
    tm, ts, tl, texe, tscope = _port(_bert)
    ckdir = str(tmp_path)
    if direction == "jax_to_port":
        saver = (jexe, jm, jl, jscope)
        for step in range(2):
            jexe.run(jm, feed=_bert_feed(step), fetch_list=[jl],
                     scope=jscope)
        with jfluid.scope_guard(jscope):
            jfluid.save_checkpoint(jexe, ckdir, jm, scope=jscope,
                                   global_step=3)
        m = tfluid.load_checkpoint(texe, ckdir, tm, scope=tscope)
        loader = (texe, tm, tl, tscope)
        counter = tscope.find_var("@RNG_COUNTER@").value().array
        assert counter.dtype == torch.int64 and counter.tolist() == [3]
    else:
        saver = (texe, tm, tl, tscope)
        for step in range(2):
            texe.run(tm, feed=_bert_feed(step), fetch_list=[tl],
                     scope=tscope)
        tfluid.save_checkpoint(texe, ckdir, tm, scope=tscope,
                               global_step=3)
        with jfluid.scope_guard(jscope):
            m = jfluid.load_checkpoint(jexe, ckdir, jm, scope=jscope)
        _on_device(jscope, jm)
        loader = (jexe, jm, jl, jscope)
        assert jfluid.Executor._rng_counters[jscope] == 3
    assert m["global_step"] == 3 and m["rng_counter"] == 3
    want = [_loss(saver[0], saver[1], _bert_feed(s), saver[2], saver[3])
            for s in range(2, 6)]
    got = [_loss(loader[0], loader[1], _bert_feed(s), loader[2], loader[3])
           for s in range(2, 6)]
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("how", ["single", "window", "interpreted"])
def test_step_counter_matches_jax_package(how, mode):
    """The startup run counts one step, a run of n_steps n: after the
    startup, 3 single runs and a window of 4, both packages' counters
    read 8, the port's on the device and on the host."""
    if how == "interpreted":
        mode("interpreted")
    jm, js, jl, jexe, jscope = _jax(_adam_net)
    tm, ts, tl, texe, tscope = _port(_adam_net)
    feeds = [_feed(i) for i in range(7)]
    stacked = {n: np.stack([f[n] for f in feeds[3:]]) for n in feeds[0]}
    for exe, m, loss, scope in ((jexe, jm, jl, jscope),
                                (texe, tm, tl, tscope)):
        for f in feeds[:3]:
            exe.run(m, feed=f, fetch_list=[loss], scope=scope)
        if how == "window":
            exe.run(m, feed=stacked, fetch_list=[loss], scope=scope,
                    n_steps=4)
        else:
            for f in feeds[3:]:
                exe.run(m, feed=f, fetch_list=[loss], scope=scope)
    assert jfluid.Executor._rng_counters[jscope] == 8
    assert tfluid.Executor._rng_counters[tscope] == 8
    assert tscope.find_var("@RNG_COUNTER@").value().array.tolist() == [8]


# ------------------------------------------------- kill and resume, port
N_STEPS = 8


def _bert_loader(batches):
    ldr = tfluid.DataLoader.from_generator(capacity=2)
    ldr.set_batch_generator(lambda: iter(batches), places=tfluid.CPUPlace())
    return ldr


def _run_loader(exe, main, loss, scope, ldr, k, stop=None):
    """Losses of the loader's batches, one run a batch (``k`` None) or one
    run a window of ``k``; ``stop(exe)`` ends the loop early (the kill)."""
    out = []
    src = ldr if k is None else ldr.window(k)
    for b in src:
        got = exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]
        out.extend(np.asarray(got).reshape(-1).tolist())
        if stop is not None and stop(exe, scope):
            break
    return out


@pytest.mark.parametrize("how", ["compiled", "interpreted", "window"])
def test_kill_and_resume_bitwise(tmp_path, mode, how):
    """The small BERT at dropout 0.1 fed by a DataLoader, checkpointing
    itself (every 3 steps one by one, every 4 in windows of 2), stopped
    without a save two steps past its last checkpoint, its executor,
    scope and loader dropped; a fresh executor, scope and loader run the
    startup, resume_from(), and go on to the end. Every loss after the
    resume and every persistable at the end equal the unbroken run's bit
    for bit."""
    if how == "interpreted":
        mode("interpreted")
    k, every = (2, 4) if how == "window" else (None, 3)
    batches = [_bert_feed(i) for i in range(N_STEPS)]
    main, startup, loss, exe, scope = _port(_bert, 0.1)
    oracle = _run_loader(exe, main, loss, scope, _bert_loader(batches), None)
    want_state = _persistables(scope, main)
    assert len(oracle) == N_STEPS

    main, startup, loss, exe, scope = _port(_bert, 0.1)
    ldr = _bert_loader(batches)
    exe.set_auto_checkpoint(str(tmp_path), every_n_steps=every,
                            program=main, scope=scope, dataloader=ldr)
    # the counter after step i is i + 2 (the startup counts one); the
    # last checkpoint at 6 (3 · 2) or 5 (windows: 1 + 2 · 2), then 2 more
    kill_at = 8 if k is None else 7
    victim = _run_loader(
        exe, main, loss, scope, ldr, k,
        stop=lambda e, s: tfluid.Executor._rng_counters[s] >= kill_at)
    assert victim == oracle[:len(victim)]
    assert len(victim) == kill_at - 1
    del exe, scope, ldr

    main, startup, loss, exe, scope = _port(_bert, 0.1)
    ldr = _bert_loader(batches)
    manifest = exe.resume_from(str(tmp_path), program=main, scope=scope,
                               dataloader=ldr)
    start = manifest["global_step"] - 1  # train steps in the checkpoint
    assert start == (5 if k is None else 4)
    assert manifest["dataloader"] == {"epoch": 0, "position": start}
    resumed = _run_loader(exe, main, loss, scope, ldr, k)
    assert resumed == oracle[start:]  # bitwise
    got_state = _persistables(scope, main)
    assert sorted(got_state) == sorted(want_state)
    for n in want_state:
        np.testing.assert_array_equal(got_state[n], want_state[n],
                                      err_msg=n)


def test_resume_from_an_empty_root_is_a_fresh_start(tmp_path):
    main, startup, loss, exe, scope = _port(_adam_net)
    assert exe.resume_from(str(tmp_path / "none"), program=main,
                           scope=scope) is None
    assert exe.resume_from(str(tmp_path), program=main,
                           scope=scope) is None


def test_restore_keeps_the_compiled_block(tmp_path):
    """A restore replaces the scope's values; the compiled block built
    before it runs on (no new block), and the step after the restore
    draws the restored step's dropout mask: its loss repeats the loss of
    the step taken from the same checkpointed state."""
    main, startup, loss, exe, scope = _port(_adam_net)
    exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
    block, n_blocks = exe._last_block, len(exe._compiled_cache)
    tfluid.save_checkpoint(exe, str(tmp_path), main, scope=scope,
                           global_step=2)
    first = _loss(exe, main, _feed(1), loss, scope)
    tfluid.load_checkpoint(exe, str(tmp_path), main, scope=scope)
    again = _loss(exe, main, _feed(1), loss, scope)
    assert first == again
    assert exe._last_block is block
    assert len(exe._compiled_cache) == n_blocks


def test_auto_checkpoint_cadence_and_counter_check(tmp_path):
    """set_auto_checkpoint saves at each boundary of the scope's step
    count (the startup counts one), keeps max_to_keep, skips other
    programs' runs, and a host count that disagrees with the device's
    counter fails the save rather than write a wrong manifest."""
    main, startup, loss, exe, scope = _port(_adam_net)
    exe.set_auto_checkpoint(str(tmp_path), every_n_steps=2, program=main,
                            scope=scope, max_to_keep=2)
    for step in range(6):  # counts 2 .. 7
        exe.run(main, feed=_feed(step), fetch_list=[loss], scope=scope)
    assert sorted(os.listdir(str(tmp_path))) == ["ckpt-4", "ckpt-6"]
    exe.run(startup, scope=scope)  # count 8: not the configured program
    assert sorted(os.listdir(str(tmp_path))) == ["ckpt-4", "ckpt-6"]
    tfluid.Executor._rng_counters[scope] += 1  # out of step with the card
    with pytest.raises(RuntimeError, match="on the host"):
        exe.run(main, feed=_feed(0), fetch_list=[loss], scope=scope)
