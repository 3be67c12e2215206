"""The port's reader (paddle_tpu_torch/fluid/reader.py, data_feeder.py)
against the TPU package's (paddle_tpu/fluid/reader.py, data_feeder.py) on
the CPU, as tests/test_checkpoint.py, tests/test_reader_window.py and
tests/test_streaming.py drive it:

- the batches of ``from_generator`` (batch, sample and sample-list
  generators through the DataFeeder), ``from_stream`` and ``PyReader``
  equal the TPU package's for the same generator, and so do their
  ``WindowBatch``es, ``n_valid`` and ``mask`` on a padded tail included;
- ``state_dict``/``load_state_dict`` fast-forward an epoch loader, and a
  stream loader seeks; a stream loader refuses an epoch loader's state;
- the position counts what was handed out: one window of 4 taken from 40
  batches leaves the port's position at 4, where the TPU package's
  prefetching window stage has read 16 (a deliberate difference, ROADMAP
  C "carried");
- ``use_multiprocess=True`` (a forked worker, arrays through shared
  memory) gives the thread loader's batches, LoD included, its windows,
  state and resume position, and the same training losses, bitwise; it
  leaves no segment in /dev/shm after a pass, an abandoned iterator, a
  generator's error or a dead worker, and raises the last two;
- ``from_dataset`` without a dataset raises, and a loader with no
  ``places`` raises on a host without CUDA.
"""
import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore

N = 10


def _gen():
    for i in range(N):
        yield {"x": np.full((2, 3), float(i), np.float32),
               "y": np.full((2, 1), i % 5, np.int64)}


def _samples():
    r = np.random.RandomState(4)
    for _ in range(13):
        yield (r.rand(3).astype(np.float32), np.int64(r.randint(0, 5)))


def _host(v):
    """A batch value of either package as numpy."""
    if isinstance(v, tcore.LoDTensor):
        return v.numpy()
    if isinstance(v, jcore.LoDTensor):
        return np.asarray(v.array)
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for n in w:
            np.testing.assert_array_equal(_host(g[n]), _host(w[n]),
                                          err_msg=n)


def _feed_vars(fluid):
    """``x`` [3] float32 and ``y`` [1] int64 in a fresh main program."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[3], dtype="float32")
        y = fluid.data("y", shape=[1], dtype="int64")
    return main, [x, y]


def _loader(fluid, how, places, capacity=2, drop_last=True):
    main, feeds = _feed_vars(fluid)
    ldr = fluid.reader.DataLoader.from_generator(
        feed_list=feeds, capacity=capacity, drop_last=drop_last)
    return _loader_gen(ldr, how, places, drop_last)


def _loader_gen(ldr, how, places=None, drop_last=True):
    places = tfluid.CPUPlace() if places is None else places
    if how == "batch":
        ldr.set_batch_generator(_gen, places=places)
    elif how == "sample":
        ldr.set_sample_generator(_samples, batch_size=4,
                                 drop_last=drop_last, places=places)
    else:
        def lists():
            buf = []
            for s in _samples():
                buf.append(s)
                if len(buf) == 3:
                    yield buf
                    buf = []
        ldr.set_sample_list_generator(lists, places=places)
    return ldr


@pytest.mark.parametrize("how", ["batch", "sample", "sample_list"])
def test_from_generator_batches_match_jax(how):
    want = list(_loader(jfluid, how, jfluid.CPUPlace()))
    got = list(_loader(tfluid, how, tfluid.CPUPlace()))
    _assert_batches_equal(got, want)
    if how != "batch":  # the DataFeeder's columns, in the vars' dtypes
        assert got[0]["x"].array.dtype == torch.float32
        assert got[0]["y"].array.dtype == torch.int64
        assert got[0]["y"].shape() == [4 if how == "sample" else 3, 1]


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("prefetch", [True, False])
def test_windows_match_jax(drop_last, prefetch):
    """window(4) over 10 batches: two full windows, and with
    drop_last=False a third padded with the last batch, n_valid 2."""
    def windows(fluid):
        ldr = _loader(fluid, "batch", fluid.CPUPlace())
        return list(ldr.window(4, drop_last=drop_last,
                               prefetch_to_device=prefetch))
    want, got = windows(jfluid), windows(tfluid)
    assert len(got) == (2 if drop_last else 3)
    _assert_batches_equal(got, want)
    for g, w in zip(got, want):
        assert isinstance(g, tfluid.reader.WindowBatch)
        assert (g.k, g.n_valid) == (w.k, w.n_valid)
        np.testing.assert_array_equal(g.mask, w.mask)
        assert g.ready is None  # the host: no copy to wait for
        if prefetch:  # uploaded to the place in the vars' dtypes
            assert g["x"].dtype == torch.float32
            assert g["y"].dtype == torch.int64
    if not drop_last:
        assert got[-1].n_valid == 2
        assert got[-1].mask.tolist() == [1.0, 1.0, 0.0, 0.0]


def test_window_stacks_sample_generator_batches():
    """DataFeeder batches (LoDTensors) stack into a window as the TPU
    package's do."""
    def windows(fluid):
        return list(_loader(fluid, "sample", fluid.CPUPlace()).window(
            2, prefetch_to_device=False))
    _assert_batches_equal(windows(tfluid), windows(jfluid))


def test_window_refuses_ragged_batches():
    def gen():
        yield {"x": np.zeros((2, 3), np.float32)}
        yield {"x": np.zeros((3, 3), np.float32)}
    ldr = tfluid.DataLoader.from_generator(capacity=1)
    ldr.set_batch_generator(gen, places=tfluid.CPUPlace())
    with pytest.raises(ValueError, match="ragged batch shapes"):
        list(ldr.window(2, prefetch_to_device=False))


def test_state_dict_fast_forwards_like_jax():
    """tests/test_checkpoint.py:184 on both packages: 4 batches consumed,
    a fresh loader given the state continues at the fifth; a finished
    pass completes the epoch."""
    states, resumed = {}, {}
    for tag, fluid in (("jax", jfluid), ("port", tfluid)):
        ldr = _loader(fluid, "batch", fluid.CPUPlace())
        it = iter(ldr)
        for _ in range(4):
            next(it)
        states[tag] = ldr.state_dict()
        fresh = _loader(fluid, "batch", fluid.CPUPlace())
        fresh.load_state_dict(states[tag])
        resumed[tag] = [float(_host(b["x"])[0, 0]) for b in fresh]
        assert fresh.state_dict() == {"epoch": 1, "position": 0}
    assert states["port"] == states["jax"] == {"epoch": 0, "position": 4}
    assert resumed["port"] == resumed["jax"] == [4.0, 5.0, 6.0, 7.0, 8.0,
                                                 9.0]


def test_window_position_counts_hand_out():
    """The port's epoch loader counts a window when it is handed out: one
    window of 4 taken leaves the position at 4 whatever the prefetch has
    read, and a loader resumed from it continues at batch 4. The TPU
    package's window stage counts its own reads on the prefetch thread
    (reader.py:374-389): with the default prefetch it reaches 16 (the
    window handed out, two in the queue, one blocked on the put), and a
    checkpoint taken there would skip 12 batches on resume."""
    def gen():
        for i in range(40):
            yield {"x": np.full((2, 3), float(i), np.float32)}

    def loader(fluid):
        ldr = fluid.reader.DataLoader.from_generator(feed_list=["x"])
        ldr.set_batch_generator(gen, places=fluid.CPUPlace())
        return ldr

    positions = {}
    for tag, fluid in (("jax", jfluid), ("port", tfluid)):
        ldr = loader(fluid)
        it = iter(ldr.window(4))
        w = next(it)
        assert float(_host(w["x"])[3, 0, 0]) == 3.0
        if tag == "jax":  # until its prefetch has filled up
            deadline = time.time() + 30
            while ldr.state_dict()["position"] < 16 \
                    and time.time() < deadline:
                time.sleep(0.01)
        else:  # the port's prefetch fills up as well, and moves nothing
            time.sleep(0.5)
        positions[tag] = ldr.state_dict()["position"]
        del it
    assert positions == {"jax": 16, "port": 4}
    fresh = loader(tfluid)
    fresh.load_state_dict({"epoch": 0, "position": 4})
    first = next(iter(fresh.window(4)))
    assert _host(first["x"])[:, 0, 0].tolist() == [4.0, 5.0, 6.0, 7.0]


def test_window_position_after_an_epoch():
    ldr = _loader(tfluid, "batch", tfluid.CPUPlace())
    seen = []
    for w in ldr.window(4):
        seen.append(ldr.state_dict()["position"])
    assert seen == [4, 8]
    assert ldr.state_dict() == {"epoch": 1, "position": 0}


def test_pyreader_start_next_reset_matches_jax():
    """The non-iterable protocol: start, next until EOFException, reset,
    and the next epoch starts over, in both packages."""
    out = {}
    for tag, fluid, core in (("jax", jfluid, jcore),
                             ("port", tfluid, tcore)):
        _, feeds = _feed_vars(fluid)
        rdr = fluid.reader.PyReader(feed_list=feeds, capacity=2,
                                    iterable=False)
        rdr.decorate_batch_generator(_gen, places=fluid.CPUPlace())
        epochs = []
        for _ in range(2):
            rdr.start()
            got = []
            while True:
                try:
                    got.append(rdr.next())
                except core.EOFException:
                    rdr.reset()
                    break
            epochs.append(got)
        with pytest.raises(RuntimeError, match="not started"):
            rdr.next()
        out[tag] = epochs
    for g, w in zip(out["port"], out["jax"]):
        _assert_batches_equal(g, w)
    assert len(out["port"][1]) == N


def test_iterable_loader_refuses_start():
    ldr = _loader(tfluid, "batch", tfluid.CPUPlace())
    with pytest.raises(RuntimeError, match="non-iterable"):
        ldr.start()


def _events(offset):
    i = offset
    while True:
        yield (np.full((3,), float(i), np.float32), np.int64(i % 5))
        i += 1


def _stream(fluid, batch_size=4):
    _, feeds = _feed_vars(fluid)
    ldr = fluid.reader.DataLoader.from_stream(feed_list=feeds,
                                              batch_size=batch_size,
                                              capacity=2)
    ldr.set_event_source(_events, places=fluid.CPUPlace())
    return ldr


def _take(it, n):
    return [next(it) for _ in range(n)]


def test_stream_batches_and_windows_match_jax():
    for use_window in (False, True):
        got, want, states = {}, {}, {}
        for tag, fluid, box in (("jax", jfluid, want),
                                ("port", tfluid, got)):
            ldr = _stream(fluid)
            src = ldr.window(3) if use_window else iter(ldr)
            box["items"] = _take(src, 2)
            states[tag] = ldr.state_dict()
        _assert_batches_equal(got["items"], want["items"])
        per = 4 * (3 if use_window else 1)
        assert states["port"] == states["jax"] == {
            "kind": "stream", "stream_offset": 2 * per, "batch_size": 4}


def test_stream_loader_seeks_on_resume():
    ldr = _stream(tfluid)
    it = iter(ldr)
    _take(it, 3)
    state = ldr.state_dict()
    assert state["stream_offset"] == 12
    fresh = _stream(tfluid)
    fresh.load_state_dict(state)
    nxt = next(iter(fresh))
    assert nxt["x"].numpy()[:, 0].tolist() == [12.0, 13.0, 14.0, 15.0]
    assert fresh.stream_offset == 16


def test_stream_loader_refuses_epoch_state():
    """tests/test_streaming.py's kind check: an epoch loader's manifest
    entry in a stream loader raises in both packages."""
    for fluid in (jfluid, tfluid):
        ldr = _stream(fluid)
        with pytest.raises(ValueError, match="cannot resume"):
            ldr.load_state_dict({"epoch": 0, "position": 4})


def _segments():
    """This process's multiprocess-loader segments in /dev/shm."""
    prefix = tfluid.reader.segment_prefix()
    return sorted(n for n in os.listdir("/dev/shm") if n.startswith(prefix))


def _mp_loader(how, capacity=2, **kw):
    main, feeds = _feed_vars(tfluid)
    ldr = tfluid.reader.DataLoader.from_generator(
        feed_list=feeds, capacity=capacity, use_multiprocess=True, **kw)
    return _loader_gen(ldr, how)


def test_multiprocess_and_from_dataset_raise():
    """use_multiprocess=True, which raised before it was ported, now runs
    the generator in a worker process: its batches are the thread
    loader's, bitwise, for each kind of generator, and it leaves no
    segment in /dev/shm; from_dataset (tests/test_torch_dataset.py)
    still raises without a dataset."""
    for how in ("batch", "sample", "sample_list"):
        want = list(_loader(tfluid, how, tfluid.CPUPlace()))
        got = list(_mp_loader(how))
        _assert_batches_equal(got, want)
        assert type(got[0]["x"]) is type(want[0]["x"])
    assert _segments() == []
    with pytest.raises(ValueError, match="dataset"):
        tfluid.DataLoader.from_dataset(None, tfluid.CPUPlace())


def test_no_places_raises_without_cuda():
    """The default place is the card: on a host without CUDA the loader
    raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a host with CUDA: the default place resolves")
    ldr = tfluid.DataLoader.from_generator(capacity=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ldr.set_batch_generator(_gen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _stream(tfluid).set_event_source(_events)


def test_generator_error_reaches_the_consumer():
    def bad():
        yield {"x": np.zeros((2, 3), np.float32)}
        raise IndexError("generator broke")
    ldr = tfluid.DataLoader.from_generator(capacity=4)
    ldr.set_batch_generator(bad, places=tfluid.CPUPlace())
    with pytest.raises(IndexError, match="generator broke"):
        list(ldr)


def test_window_feeds_executor_run():
    """A WindowBatch fed to the port's Executor.run sets n_steps and
    trains as k single runs do, bitwise."""
    def build():
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 3
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            x = tfluid.data("x", shape=[3], dtype="float32")
            y = tfluid.data("y", shape=[1], dtype="int64")
            pred = tfluid.layers.fc(x, 5, act="softmax")
            loss = tfluid.layers.mean(
                tfluid.layers.cross_entropy(pred, y))
            tfluid.optimizer.SGD(0.1).minimize(loss)
        return main, startup, loss

    got = {}
    for how in ("window", "single"):
        main, startup, loss = build()
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        ldr = tfluid.DataLoader.from_generator(feed_list=["x", "y"],
                                               capacity=2)
        ldr.set_batch_generator(_gen, places=tfluid.CPUPlace())
        if how == "window":
            got[how] = np.concatenate([
                exe.run(main, feed=w, fetch_list=[loss], scope=scope)[0]
                for w in ldr.window(5)]).ravel()
        else:
            got[how] = np.concatenate([
                exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]
                for b in ldr]).ravel()
    assert got["window"].shape == (N,)
    np.testing.assert_array_equal(got["window"], got["single"])


# ------------------------------------------------- the worker process
@pytest.fixture
def _one_thread():
    """One intra-op thread for the bitwise training check: CPU products
    under contended BLAS threads may split differently from call to
    call."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_multiprocess_lod_batches_match_the_thread_loader():
    """A sample generator of LoD samples: the worker makes the columns
    with numpy, the loader the LoDTensors, with the thread loader's LoD."""
    def build():
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            a = tfluid.data("a", shape=[3], dtype="float32")
            b = tfluid.data("b", shape=[1], dtype="int64", lod_level=1)
        return [a, b]

    def samples():
        r = np.random.RandomState(0)
        for _ in range(5):
            yield [(r.rand(3).astype(np.float32),
                    r.randint(0, 5, (r.randint(0, 4), 1)))
                   for _ in range(4)]
    got = {}
    for mp in (False, True):
        ldr = tfluid.DataLoader.from_generator(
            feed_list=build(), capacity=2, use_multiprocess=mp)
        ldr.set_sample_list_generator(samples, places=tfluid.CPUPlace())
        got[mp] = list(ldr)
    _assert_batches_equal(got[True], got[False])
    for g, w in zip(got[True], got[False]):
        assert g["b"].lod() == w["b"].lod()
    assert _segments() == []


@pytest.mark.parametrize("prefetch", [True, False])
def test_multiprocess_windows_state_and_resume(prefetch):
    want = list(_loader(tfluid, "batch", tfluid.CPUPlace()).window(
        4, drop_last=False, prefetch_to_device=prefetch))
    ldr = _mp_loader("batch")
    got = list(ldr.window(4, drop_last=False, prefetch_to_device=prefetch))
    _assert_batches_equal(got, want)
    assert [w.n_valid for w in got] == [w.n_valid for w in want]
    assert ldr.state_dict() == {"epoch": 1, "position": 0}
    it = iter(ldr)
    for _ in range(4):
        next(it)
    state = ldr.state_dict()
    assert state == {"epoch": 1, "position": 4}
    it.close()
    fresh = _mp_loader("batch")
    fresh.load_state_dict(state)
    assert [float(_host(b["x"])[0, 0]) for b in fresh] == [
        4.0, 5.0, 6.0, 7.0, 8.0, 9.0]
    assert fresh.state_dict() == {"epoch": 2, "position": 0}
    assert _segments() == []


def test_multiprocess_cleans_up_an_abandoned_iterator():
    """The consumer stops after two batches of many, five times over: the
    worker is stopped and every segment it made is unlinked, by it or by
    the loader."""
    def many():
        for i in range(200):
            yield {"x": np.full((64, 32), float(i), np.float32),
                   "y": np.full((64, 1), i, np.int64)}
    ldr = tfluid.DataLoader.from_generator(capacity=2, use_multiprocess=True)
    ldr.set_batch_generator(many, places=tfluid.CPUPlace())
    for _ in range(5):
        it = iter(ldr)
        assert float(_host(next(it)["x"])[0, 0]) == 0.0
        next(it)
        it.close()
        ldr._mp_proc.join(10)
        assert not ldr._mp_proc.is_alive()
    assert _segments() == []


def test_multiprocess_worker_errors_reach_the_consumer():
    def bad():
        yield {"x": np.zeros((2, 3), np.float32)}
        raise IndexError("generator broke")

    def dies():
        yield {"x": np.zeros((2, 3), np.float32)}
        os._exit(3)
    for gen, match in ((bad, "generator broke"), (dies, "exitcode=3")):
        ldr = tfluid.DataLoader.from_generator(
            capacity=2, use_multiprocess=True, worker_timeout=0.2)
        ldr.set_batch_generator(gen, places=tfluid.CPUPlace())
        with pytest.raises(RuntimeError, match=match):
            list(ldr)
    assert _segments() == []


def test_multiprocess_loader_trains_as_the_thread_loader(_one_thread):
    """test_window_feeds_executor_run's model over the worker's batches
    and windows: the losses of the thread loader's, bitwise."""
    def build():
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = startup.random_seed = 3
        with tfluid.unique_name.guard(), \
                tfluid.program_guard(main, startup):
            x = tfluid.data("x", shape=[3], dtype="float32")
            y = tfluid.data("y", shape=[1], dtype="int64")
            pred = tfluid.layers.fc(x, 5, act="softmax")
            loss = tfluid.layers.mean(
                tfluid.layers.cross_entropy(pred, y))
            tfluid.optimizer.SGD(0.1).minimize(loss)
        return main, startup, loss

    got = {}
    for mp in (False, True):
        for how in ("window", "single"):
            main, startup, loss = build()
            exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
            exe.run(startup, scope=scope)
            ldr = tfluid.DataLoader.from_generator(
                feed_list=["x", "y"], capacity=2, use_multiprocess=mp)
            ldr.set_batch_generator(_gen, places=tfluid.CPUPlace())
            feeds = ldr.window(5) if how == "window" else ldr
            got[mp, how] = np.concatenate([
                exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                for f in feeds]).ravel()
    for how in ("window", "single"):
        np.testing.assert_array_equal(got[True, how], got[False, how])
    assert _segments() == []
