"""DataLoader (counterpart of paddle_tpu/fluid/reader.py; reference:
python/paddle/fluid/reader.py:100 — DataLoader.from_generator,
GeneratorLoader, PyReader).

A host thread prefetches batches through a bounded queue (the reference's
double-buffered BufferedReader). ``set_sample_generator``,
``set_sample_list_generator`` and ``set_batch_generator`` mirror the
reference API; the non-iterable ``start``/``next``/``reset`` protocol
raises ``core.EOFException`` at the end of an epoch.

``window(k)`` stacks k host batches into one ``WindowBatch`` ([k, batch,
...] a feed), which ``Executor.run`` takes as ``n_steps=k`` distinct
steps. With ``prefetch_to_device`` (the default) a second stage copies
window i+1 to the device while window i computes: from pinned host memory,
``non_blocking``, on a stream of the loader's own, in the dtype the
executor's feed path gives each var; the window carries an event recorded
after the copies (``ready``), which ``Executor.run`` makes its stream wait
for.

``state_dict``/``load_state_dict`` carry the input position for a
checkpoint manifest: ``epoch`` (passes completed) and ``position``
(batches handed out this epoch); a loader given a state fast-forwards its
next epoch past ``position`` batches. The position counts what was HANDED
OUT to the caller, batch by batch or window by window, never what a
prefetch stage has read ahead: the TPU package's epoch loader counts its
window stage's reads (reader.py:374-389, ``for batch in self`` on the
prefetch thread), so a checkpoint taken mid-epoch there names up to
prefetch_depth + 1 windows the weights have not seen, and a resume skips
them (ROADMAP C, "carried"). This package counts as the TPU package's
stream loader does (``hand_out``, reader.py:544-549).

``DataLoader.from_stream`` is the unbounded loader whose state is one
event offset, seeked on resume.

``DataLoader.from_dataset`` is a loader over a ``fluid.dataset`` Dataset's
batches, as the reference's DatasetLoader (the TPU package's raises
ModuleNotFoundError: its reader.py:596 imports a module it does not have).

``use_multiprocess=True`` (the TPU package's reader.py:241-350) runs the
generator in a forked worker process: each batch's arrays cross through
``multiprocessing.shared_memory`` and only their metadata is pickled; the
loader's process rebuilds the batch (a sample generator's LoDTensors on
the loader's place, a batch generator's values as numpy arrays). The
worker touches no torch and no device: a sample generator's columns are
made by ``DataFeeder.feed_arrays`` there. At the iterator's end (drained,
abandoned or failed) the worker is terminated, the segments it made but
never handed over are unlinked by it, and the loader unlinks the ones in
the queue while it waits for the worker to exit: no segment stays in
/dev/shm.
"""
from __future__ import annotations

import _posixshmem
import contextlib
import math
import mmap
import os
import queue
import secrets
import signal
import threading
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from . import core
from .core import CUDAPlace, LoDTensor
from .data_feeder import DataFeeder
from .framework import Variable, default_main_program

__all__ = ["DataLoader", "PyReader", "WindowBatch"]


class WindowBatch(dict):
    """K stacked batches as one feed dict: every value carries a leading
    [k, ...] window dim — feed it straight into ``Executor.run`` (it sets
    ``n_steps=k``). ``n_valid`` ≤ k counts the real (unpadded) steps;
    ``mask`` is a [k] float32 0/1 vector. A padded tail window
    (``drop_last=False``) repeats its final real batch, and those padded
    steps DO execute (optimizer updates included): weight per-step
    stacked fetches by ``mask``, or drop the tail. ``ready`` is the event
    after the window's device copies (None on the host)."""

    def __init__(self, data, k: int, n_valid: int):
        super().__init__(data)
        self.k = int(k)
        self.n_valid = int(n_valid)
        self.ready = None

    @property
    def mask(self) -> np.ndarray:
        m = np.zeros(self.k, np.float32)
        m[:self.n_valid] = 1.0
        return m


def _iter_through_queue(src_iter, capacity: int, transform=None):
    """Bridge ``src_iter`` through a bounded queue filled by a daemon
    thread. The producer applies ``transform`` to each item (the device
    upload) so that it overlaps the consumer's compute; an error of the
    generator is raised in the consumer. When the consumer goes away early
    (break, exception, GC) the ``finally`` tells the producer, which drops
    its blocked put instead of holding ``capacity`` items for the life of
    the process."""
    q: "queue.Queue" = queue.Queue(max(1, capacity))
    DONE, ERR = object(), object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in src_iter:
                if transform is not None:
                    item = transform(item)
                if not put(item):
                    return  # the consumer is gone
            put(DONE)
        except BaseException as e:  # raised in the consumer
            put((ERR, e))

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                return
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is ERR:
                raise item[1]
            yield item
    finally:
        stop.set()


def _stack_window(batches, k: int, n_valid: int) -> WindowBatch:
    """Stack a list of feed dicts along a new leading window dim (torch
    tensors with ``torch.stack`` where they lie, the rest with numpy).
    LoD batches are refused (one LoD cannot describe K stacked batches),
    and ragged batch shapes get a pointed error."""
    out = {}
    for name in batches[0]:
        parts = []
        for b in batches:
            v = b[name]
            if isinstance(v, LoDTensor):
                if v.lod():
                    raise ValueError(
                        f"window(): batch var '{name}' carries LoD — "
                        f"stacked windows need dense batches; keep LoD "
                        f"data on the per-step path")
                v = v.array
            parts.append(v if isinstance(v, torch.Tensor)
                         else np.asarray(v))
        shapes = {tuple(p.shape) for p in parts}
        if len(shapes) > 1:
            raise ValueError(
                f"window(): ragged batch shapes for '{name}' "
                f"({sorted(shapes)}) — use a fixed batch_size "
                f"(drop_last=True upstream) so K batches stack")
        if any(isinstance(p, torch.Tensor) for p in parts):
            dev = next(p.device for p in parts
                       if isinstance(p, torch.Tensor))
            out[name] = torch.stack([torch.as_tensor(p, device=dev)
                                     for p in parts])
        else:
            out[name] = np.stack(parts)
    return WindowBatch(out, k, n_valid)


def _first_place(places):
    """The loader's place: the first of ``places``, or ``CUDAPlace(0)``,
    which raises on a host without CUDA (the CPU only when asked for)."""
    if places is None:
        places = CUDAPlace(0)
    if isinstance(places, (list, tuple)):
        places = places[0]
    places.torch_device()
    return places


def _unlink_segment(name: str) -> None:
    """Unlink the POSIX segment ``name`` if it exists, by name alone: a
    segment the worker was making when it stopped may not have its size
    yet, and attaching to it would fail."""
    try:
        _posixshmem.shm_unlink("/" + name)
    except FileNotFoundError:
        pass


def segment_prefix() -> str:
    """The name prefix of the shared-memory segments the multiprocess
    loaders of this process make: /dev/shm shows whose a segment is."""
    return f"psm_ptt{os.getpid()}_"


def _unlink_prefixed(prefix: str) -> None:
    """Unlink every segment in /dev/shm whose name starts with
    ``prefix``: what a worker that died hard (killed, ``os._exit``) made
    and never announced."""
    if not os.path.isdir("/dev/shm"):
        return
    for name in os.listdir("/dev/shm"):
        if name.startswith(prefix):
            _unlink_segment(name)


def _produce(host_fn, meta_q, prefix: str) -> None:
    """The multiprocess loader's worker: each host batch's arrays into
    POSIX shared-memory segments, their (name, shape, dtype, lengths)
    into ``meta_q``; then ("done", None), or ("error", repr) when the
    generator raises. A segment's name goes into ``pending`` before the
    segment exists, and leaves it once its metadata is in the queue: on
    SIGTERM the worker unlinks what ``pending`` holds, and exits. The
    segments are made with ``shm_open`` itself, not ``SharedMemory``,
    so that the resource tracker knows only the loader's attachments."""
    pending = []

    def cleanup(*_):
        for name in pending:
            _unlink_segment(name)
        raise SystemExit(0)

    def put_segment(a) -> str:
        while True:
            name = prefix + secrets.token_hex(8)
            pending.append(name)
            try:
                fd = _posixshmem.shm_open(
                    "/" + name, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
                break
            except FileExistsError:
                pending.pop()
        try:
            size = max(1, a.nbytes)
            os.ftruncate(fd, size)
            with mmap.mmap(fd, size) as m:
                m[:a.nbytes] = a.reshape(-1).view(np.uint8)
        finally:
            os.close(fd)
        return name

    signal.signal(signal.SIGTERM, cleanup)
    try:
        for item in host_fn():
            meta = {}
            for name, v in item.items():
                lengths = None
                if isinstance(v, tuple):
                    v, lengths = v
                elif isinstance(v, LoDTensor):
                    lengths = v.recursive_sequence_lengths() or None
                    v = v.numpy()
                a = np.ascontiguousarray(v)
                meta[name] = (put_segment(a), a.shape, a.dtype.str, lengths)
            meta_q.put(("batch", meta))
            pending.clear()     # the loader owns them now
        meta_q.put(("done", None))
    except Exception as e:      # the generator's error, for the loader
        meta_q.put(("error", repr(e)))


def _take_segments(meta):
    """{name: (ndarray, lengths)} read out of the segments ``meta`` names,
    each unlinked after its copy."""
    from multiprocessing import shared_memory
    out = {}
    for name, (seg_name, shape, dtype, lengths) in meta.items():
        seg = shared_memory.SharedMemory(name=seg_name)
        try:
            arr = np.frombuffer(seg.buf, dtype=np.dtype(dtype),
                                count=math.prod(shape)).reshape(shape).copy()
        finally:
            seg.close()
            seg.unlink()
        out[name] = (arr, lengths)
    return out


def _raw_batch(arrays):
    """A batch generator's values as the worker sent them: numpy arrays,
    and a LoDTensor on the host where the value had a LoD."""
    out = {}
    for name, (arr, lengths) in arrays.items():
        if lengths is None:
            out[name] = arr
        else:
            t = LoDTensor()
            t.set(arr, core.CPUPlace())
            t.set_recursive_sequence_lengths(lengths)
            out[name] = t
    return out


class _GeneratorLoader:
    def __init__(self, feed_list, capacity=16, iterable=True,
                 return_list=False, use_multiprocess=False,
                 drop_last=True, worker_timeout=None, join_timeout=None):
        self._feed_list = feed_list or []
        self._capacity = capacity
        self._iterable = iterable
        self._return_list = return_list
        self._drop_last = drop_last
        # the worker process (use_multiprocess): its liveness and
        # teardown timeouts (None: the FLAGS_dataloader_*_timeout values
        # at iteration time), the generator it runs (host batches, numpy
        # alone) and what the loader makes of a batch it sent
        self._use_multiprocess = bool(use_multiprocess)
        self._worker_timeout = worker_timeout
        self._join_timeout = join_timeout
        self._host_fn: Optional[Callable] = None
        self._from_host: Optional[Callable] = None
        self._mp_proc = None    # the last worker process
        self._batch_fn: Optional[Callable] = None
        self._places = None
        self._dtypes = self._feed_dtypes(self._feed_list)
        self._upload_stream = None
        self._it = None     # the start/next/reset protocol's iterator
        # the input position for a checkpoint manifest: epochs completed,
        # batches handed out this epoch, batches the next epoch skips
        self._epoch = 0
        self._position = 0
        self._skip_next = 0

    @staticmethod
    def _feed_dtypes(feed_list):
        """name → the torch dtype the executor's feed path gives the var
        (its declared dtype), for the vars found in ``feed_list`` or the
        default main program."""
        block = default_main_program().global_block()
        out = {}
        for v in feed_list:
            if not isinstance(v, Variable):
                v = block._find_var_recursive(v)
            if v is not None:
                out[v.name] = core.dtype_to_torch(v.dtype)
        return out

    # -- reference API -----------------------------------------------------
    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        def batch_reader():
            batch = []
            for sample in reader():
                batch.append(sample if isinstance(sample, (list, tuple))
                             else (sample,))
                if len(batch) == batch_size:
                    yield batch
                    batch = []
            if batch and not drop_last:
                yield batch
        return self.set_sample_list_generator(batch_reader, places)

    def set_sample_list_generator(self, reader, places=None):
        places = _first_place(places)
        feeder = DataFeeder(self._feed_list, places)

        def fn():
            for sample_list in reader():
                yield feeder.feed(sample_list)

        def host_fn():
            for sample_list in reader():
                yield feeder.feed_arrays(sample_list)
        self._batch_fn = fn
        self._host_fn, self._from_host = host_fn, feeder.to_tensors
        self._places = places
        return self

    def set_batch_generator(self, reader, places=None):
        places = _first_place(places)
        names = [v.name if isinstance(v, Variable) else v
                 for v in self._feed_list]

        def fn():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    if not isinstance(batch, (list, tuple)):
                        batch = (batch,)
                    yield {n: b for n, b in zip(names, batch)}
        self._batch_fn = fn
        self._host_fn, self._from_host = fn, _raw_batch
        self._places = places
        return self

    def _batches(self):
        """(position, batch) of this epoch, past the fast-forward of a
        loaded state (those batches are generated and dropped)."""
        skip, self._skip_next = self._skip_next, 0
        pos = 0
        for batch in self._iter_raw():
            pos += 1
            if pos > skip:
                yield pos, batch

    def __iter__(self):
        """The batches of one epoch. After ``load_state_dict`` the first
        ``position`` batches are dropped: with the same deterministic
        generator the stream continues where the checkpointed run left
        it."""
        for pos, batch in self._batches():
            self._position = pos
            yield batch
        self._epoch += 1
        self._position = 0

    def _iter_raw(self):
        if self._batch_fn is None:
            raise RuntimeError("DataLoader: no generator set")
        if self._use_multiprocess:
            return self._iter_multiprocess()
        if self._capacity <= 1:
            return self._batch_fn()
        return _iter_through_queue(self._batch_fn(), self._capacity)

    def _iter_multiprocess(self):
        """The batches from a forked worker process (``_produce``) through
        shared memory (module docstring). Fork, so that the generator's
        closure carries over. A worker that dies without its "done"
        raises here once ``worker_timeout`` passes with nothing in the
        queue; the segments it left are found by this iterator's name
        prefix and unlinked."""
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        meta_q = ctx.Queue(max(1, self._capacity))
        # one prefix an iterator: its leftovers are found by name
        prefix = f"{segment_prefix()}{secrets.token_hex(4)}_"
        proc = ctx.Process(target=_produce,
                           args=(self._host_fn, meta_q, prefix),
                           daemon=True)
        with warnings.catch_warnings():
            # fork under threads is deliberate: the worker runs the
            # generator and numpy, no torch
            warnings.simplefilter("ignore", DeprecationWarning)
            warnings.simplefilter("ignore", RuntimeWarning)
            proc.start()
        self._mp_proc = proc
        flags = core.globals_
        liveness = float(self._worker_timeout if self._worker_timeout
                         is not None
                         else flags["FLAGS_dataloader_worker_timeout"])
        join_s = float(self._join_timeout if self._join_timeout is not None
                       else flags["FLAGS_dataloader_join_timeout"])

        def drain():
            while True:
                try:
                    kind, meta = meta_q.get(timeout=0.05)
                except queue.Empty:
                    return
                if kind == "batch":
                    for seg_name, _, _, _ in meta.values():
                        _unlink_segment(seg_name)
        try:
            while True:
                try:
                    kind, meta = meta_q.get(timeout=liveness)
                except queue.Empty:
                    if not proc.is_alive():
                        raise RuntimeError(
                            "multiprocess DataLoader worker died without "
                            f"posting 'done' (exitcode={proc.exitcode})")
                    continue
                if kind == "done":
                    break
                if kind == "error":
                    raise RuntimeError(
                        f"multiprocess DataLoader worker failed: {meta}")
                yield self._from_host(_take_segments(meta))
        finally:
            proc.terminate()
            # drain while the worker exits: its queue's last items must
            # leave the pipe before it can, and their segments are ours
            deadline = time.monotonic() + join_s
            while proc.is_alive() and time.monotonic() < deadline:
                drain()
                proc.join(0.05)
            if proc.is_alive():
                proc.kill()
                proc.join()
            drain()
            meta_q.close()
            _unlink_prefixed(prefix)

    # -------------------------------------------------- checkpoint state
    def state_dict(self):
        """The input position for a checkpoint manifest
        (``Executor.set_auto_checkpoint(dataloader=...)``)."""
        return {"epoch": self._epoch, "position": self._position}

    def load_state_dict(self, state):
        """Restore the counters of a manifest; the NEXT iteration drops
        its first ``position`` batches. Exact only with the deterministic
        generator the checkpointed run used."""
        self._epoch = int(state.get("epoch", 0))
        self._position = int(state.get("position", 0))
        self._skip_next = self._position

    # ------------------------------------------------------------ windows
    def window(self, k: int, drop_last=None, prefetch_to_device=True,
               prefetch_depth=2):
        """WindowBatch dicts of K stacked batches (``exe.run(feed=w)``
        runs the K slices as K steps; on the card each a replay of the
        step's graph).

        ``drop_last`` (None → the loader's): True drops a tail of < k
        batches; False pads the tail window to k by repeating its final
        batch and marks it by ``n_valid``/``mask`` (one window shape, one
        graph; the padded steps do execute).

        ``prefetch_to_device``: a second stage copies window i+1 to the
        loader's place while window i computes (module docstring);
        ``prefetch_depth`` bounds the windows in flight. The position
        advances as each window is handed out."""
        if k < 1:
            raise ValueError(f"window size must be >= 1, got {k}")
        if drop_last is None:
            drop_last = self._drop_last

        def assemble():
            buf, pos = [], 0
            for pos, batch in self._batches():
                buf.append(batch)
                if len(buf) == k:
                    yield pos, _stack_window(buf, k, k)
                    buf = []
            if buf and not drop_last:
                n = len(buf)
                yield pos, _stack_window(buf + [buf[-1]] * (k - n), k, n)

        src = assemble()
        if prefetch_to_device:
            src = _iter_through_queue(
                src, prefetch_depth,
                transform=lambda t: (t[0], self._upload_window(t[1])))

        def hand_out():
            for pos, w in src:
                self._position = pos
                yield w
            self._epoch += 1
            self._position = 0
        return hand_out()

    def _upload_window(self, w: WindowBatch) -> WindowBatch:
        """The prefetch stage's copy of a window to the loader's place, in
        each var's feed dtype: on the card from pinned host memory,
        ``non_blocking``, on the loader's stream (after the work the
        default stream holds, which made any batch already on the card),
        then an event in ``w.ready``."""
        dev = self._places.torch_device()
        stream = None
        if dev.type == "cuda":
            if self._upload_stream is None:
                self._upload_stream = torch.cuda.Stream(dev)
            stream = self._upload_stream
            stream.wait_stream(torch.cuda.current_stream(dev))
        ctx = torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()
        with ctx:
            for name in list(w):
                t = w[name]
                if not isinstance(t, torch.Tensor):
                    t = torch.from_numpy(np.ascontiguousarray(t))
                dt = self._dtypes.get(name)
                if dt is not None:
                    t = t.to(dt)
                if stream is not None and t.device.type == "cpu":
                    t = t.pin_memory().to(dev, non_blocking=True)
                else:
                    t = t.to(dev)
                w[name] = t
        if stream is not None:
            w.ready = torch.cuda.Event()
            w.ready.record(stream)
        return w

    def __call__(self):
        return iter(self)

    # ------------------- non-iterable (start/next/reset) py_reader mode
    # The reference's loop (reader.py PyReader, iterable=False):
    #     reader.start()
    #     while True:
    #         try:    exe.run(feed=reader.next(), ...)
    #         except fluid.core.EOFException:
    #             reader.reset(); break
    def start(self):
        if self._iterable:
            raise RuntimeError(
                "start() is the non-iterable protocol — construct the "
                "loader with iterable=False, or just iterate it")
        if self._it is not None:
            raise RuntimeError(
                "DataLoader already started; call reset() before "
                "starting the next epoch")
        self._it = iter(self)

    def next(self):
        """The next feed dict; raises ``core.EOFException`` when the epoch
        is drained (``reset()`` then ``start()`` begins the next one)."""
        if self._it is None:
            raise RuntimeError("DataLoader not started — call start()")
        try:
            return next(self._it)
        except StopIteration:
            raise core.EOFException(
                "DataLoader drained — call reset() (and start() for the "
                "next epoch)") from None

    next_batch = next  # the py_reader-era name

    def reset(self):
        self._it = None


class _StreamLoader(_GeneratorLoader):
    """The unbounded streaming loader (the TPU package's reader.py:453;
    continuous online learning): no epochs, and the checkpoint state is
    one number, the event offset the trainer has consumed.

    The source is seekable: ``set_event_source(fn)`` takes ``fn(offset)
    -> iterator`` of per-event samples from event #offset, so a resume
    seeks instead of fast-forwarding. The offset advances as a batch or a
    window is handed out, never as the prefetch stages read ahead: a
    checkpoint taken between steps names exactly the events whose
    gradients are in the weights. Batches are always full."""

    def __init__(self, feed_list, batch_size, capacity=16):
        super().__init__(feed_list, capacity, iterable=True,
                         return_list=False, drop_last=True)
        self._batch_size = int(batch_size)
        self._source_fn = None
        self._offset = 0  # events consumed by handed-out batches/windows

    def set_event_source(self, source_fn, places=None):
        """``source_fn(offset)`` yields sample tuples (in feed_list's
        order) deterministically from event #offset."""
        self._source_fn = source_fn
        self._places = _first_place(places)
        return self

    def _raw_batches(self, start: int):
        if self._source_fn is None:
            raise RuntimeError("stream DataLoader: no event source set")
        feeder = DataFeeder(self._feed_list, self._places)

        def gen():
            buf = []
            for ev in self._source_fn(start):
                buf.append(ev if isinstance(ev, (list, tuple)) else (ev,))
                if len(buf) == self._batch_size:
                    yield feeder.feed(buf)
                    buf = []
        if self._capacity > 1:
            return _iter_through_queue(gen(), self._capacity)
        return gen()

    def __iter__(self):
        start = self._offset
        for n, batch in enumerate(self._raw_batches(start), 1):
            # before the yield: a checkpoint taken while the consumer
            # holds this batch includes its events
            self._offset = start + n * self._batch_size
            yield batch

    def window(self, k: int, drop_last=None, prefetch_to_device=True,
               prefetch_depth=2):
        """WindowBatch stream over the unbounded source; the offset
        advances a window at a time as each reaches the consumer."""
        if k < 1:
            raise ValueError(f"window size must be >= 1, got {k}")
        start = self._offset
        per_window = k * self._batch_size

        def assemble():
            buf, wins = [], 0
            for batch in self._raw_batches(start):
                buf.append(batch)
                if len(buf) == k:
                    wins += 1
                    yield (start + wins * per_window,
                           _stack_window(buf, k, k))
                    buf = []

        src = assemble()
        if prefetch_to_device:
            src = _iter_through_queue(
                src, prefetch_depth,
                transform=lambda t: (t[0], self._upload_window(t[1])))

        def hand_out():
            for end, w in src:
                self._offset = end
                yield w
        return hand_out()

    def state_dict(self):
        return {"kind": "stream", "stream_offset": int(self._offset),
                "batch_size": self._batch_size}

    def load_state_dict(self, state):
        if state.get("kind") != "stream":
            # an epoch loader's state ({"epoch", "position"}) in a stream
            # loader is a configuration error: never restart at event 0
            raise ValueError(
                f"stream loader cannot resume from a {state.get('kind')!r}"
                f" dataloader state: {state}")
        self._offset = int(state.get("stream_offset", 0))

    @property
    def stream_offset(self) -> int:
        return self._offset


class _DatasetLoader(_GeneratorLoader):
    """``DataLoader.from_dataset`` (the reference's DatasetLoader,
    reader.py): one feed dict of LoDTensors on the host a batch of the
    dataset (``Dataset._iter_batches``, loaded into memory at the first
    pass if it is not yet), in the dataset's order; ``drop_last`` drops a
    last batch of fewer than ``batch_size`` instances. The loader's
    position, windows and checkpoint state are the generator loader's."""

    def __init__(self, dataset, places, drop_last=True):
        if dataset is None:
            raise ValueError("DataLoader.from_dataset: a dataset must be "
                             "provided")
        super().__init__([], capacity=2, drop_last=drop_last)
        self._dataset = dataset
        self._places = _first_place(places)
        self._batch_fn = self._dataset_batches

    def _dataset_batches(self):
        ds = self._dataset
        ds._ensure_handle()
        if ds.get_memory_data_size() == 0:
            ds._load()
        for feed in ds._iter_batches():
            t = next(iter(feed.values()))
            n = len(t.lod()[0]) - 1 if t.lod() else len(t)
            if self._drop_last and n < ds._batch_size:
                continue
            yield feed


class DataLoader:
    @staticmethod
    def from_generator(feed_list=None, capacity=16, use_double_buffer=True,
                       iterable=True, return_list=False,
                       use_multiprocess=False, drop_last=True,
                       worker_timeout=None, join_timeout=None):
        return _GeneratorLoader(feed_list, capacity, iterable, return_list,
                                use_multiprocess=use_multiprocess,
                                drop_last=drop_last,
                                worker_timeout=worker_timeout,
                                join_timeout=join_timeout)

    @staticmethod
    def from_stream(feed_list=None, batch_size=1, capacity=16):
        """The unbounded streaming loader (``_StreamLoader``): call
        ``set_event_source(fn)`` with a seekable ``fn(offset)``, then
        iterate batches or ``window(k)`` stacks."""
        return _StreamLoader(feed_list, batch_size, capacity)

    @staticmethod
    def from_dataset(dataset, places, drop_last=True):
        """A loader over a Dataset's batches (``_DatasetLoader``; the
        reference's DatasetLoader, reader.py)."""
        return _DatasetLoader(dataset, places, drop_last)


class PyReader(_GeneratorLoader):
    """The reference's PyReader (reader.py:600): the same loader under its
    py_reader-era name."""

    def __init__(self, feed_list=None, capacity=16, use_double_buffer=True,
                 iterable=True, return_list=False):
        super().__init__(feed_list, capacity, iterable, return_list)

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        return self.set_sample_generator(sample_generator, batch_size,
                                         drop_last, places)

    def decorate_sample_list_generator(self, reader, places=None):
        return self.set_sample_list_generator(reader, places)

    def decorate_batch_generator(self, reader, places=None):
        return self.set_batch_generator(reader, places)
