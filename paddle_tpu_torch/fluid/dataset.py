"""The Dataset API over the native data feed (counterpart of
paddle_tpu/fluid/dataset.py; reference: python/paddle/fluid/dataset.py —
DatasetFactory:24, DatasetBase:53, InMemoryDataset:168, QueueDataset;
backed by framework/data_set.h, here paddle_tpu_torch/native/datafeed.cpp).

The slot file format and the API (set_use_var, set_batch_size,
set_thread, set_filelist, load_into_memory, local_shuffle) are the
reference's. A batch comes back as a dict of LoDTensors on the host, and
the executor moves them to its device: an int64 slot is [total, 1] with
one LoD level over the batch's instances; a float slot whose instances
all have the same length is dense [batch, dim], else packed with LoD like
an int slot.

The parser threads take files in turn, so with more than one thread and
more than one file the order of the records, and so of the batches,
depends on which thread read which file first; one thread, or one file,
gives the files' order, and ``local_shuffle(seed)`` then the same order
each time.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np
import torch

__all__ = ["DatasetFactory", "DatasetBase", "InMemoryDataset",
           "QueueDataset"]


class DatasetFactory:
    """reference dataset.py:24 — create_dataset("InMemoryDataset")."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        try:
            return globals()[datafeed_class]()
        except KeyError:
            raise ValueError(f"unknown dataset type {datafeed_class!r}")


class DatasetBase:
    def __init__(self):
        self._batch_size = 1
        self._thread_num = 1
        self._filelist: List[str] = []
        self._use_vars = []
        self._handle = None
        self._pipe_command = None
        self._hdfs = None

    # ----------------------------------------------------- configuration
    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self._thread_num = int(thread_num)

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def set_use_var(self, var_list):
        """The slots' order and dtypes come from the vars, like the
        reference's data_feed.proto (dataset.py set_use_var)."""
        self._use_vars = list(var_list)

    def set_pipe_command(self, cmd):
        self._pipe_command = cmd  # accepted for the reference API; unused

    def set_hdfs_config(self, fs_name, fs_ugi):
        self._hdfs = (fs_name, fs_ugi)

    # ----------------------------------------------------------- engine
    def _is_float(self, v) -> bool:
        from .core import VarDesc
        return v.dtype in (VarDesc.VarType.FP32, VarDesc.VarType.FP64)

    def _spec(self) -> str:
        parts = []
        for v in self._use_vars:
            dims = [d for d in (v.shape or []) if d and d > 0]
            dim = int(np.prod(dims)) if dims else 1
            parts.append(f"{v.name}:{'f' if self._is_float(v) else 'i'}:"
                         f"{dim}")
        return ",".join(parts)

    def _ensure_handle(self):
        if self._handle is None:
            from ..native import datafeed_lib
            self._lib = datafeed_lib()
            self._handle = self._lib.df_create(self._spec().encode())
        files = (ctypes.c_char_p * len(self._filelist))(
            *[f.encode() for f in self._filelist])
        self._lib.df_set_filelist(self._handle, files, len(self._filelist))
        self._lib.df_set_batch(self._handle, self._batch_size)
        self._lib.df_set_threads(self._handle, self._thread_num)

    def _load(self):
        self._ensure_handle()
        self._lib.df_load_into_memory(self._handle)

    def get_memory_data_size(self, fleet=None):
        if self._handle is None:
            return 0
        return int(self._lib.df_memory_size(self._handle))

    def release_memory(self):
        if self._handle is not None:
            self._lib.df_release(self._handle)
            self._handle = None

    # ------------------------------------------------------- iteration
    def _iter_batches(self):
        """Yields a feed dict {var_name: LoDTensor on the host} a batch."""
        from .core import LoDTensor
        self._lib.df_epoch_begin(self._handle)
        while True:
            n = self._lib.df_next_batch(self._handle)
            if n <= 0:
                return
            feed = {}
            for s, v in enumerate(self._use_vars):
                total = self._lib.df_slot_total(self._handle, s)
                isf = self._is_float(v)
                vals = np.empty(int(total), np.float32 if isf else np.int64)
                lod = np.empty(n + 1, np.int64)
                self._lib.df_slot_copy(
                    self._handle, s, vals.ctypes.data_as(ctypes.c_void_p),
                    lod.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
                if isf and (np.diff(lod) == lod[1]).all():
                    # a dense fixed-dim slot → [batch, dim]
                    feed[v.name] = LoDTensor(torch.from_numpy(
                        vals.reshape(n, -1)))
                else:
                    feed[v.name] = LoDTensor(
                        torch.from_numpy(vals.reshape(-1, 1)),
                        (tuple(lod.tolist()),))
            yield feed


class InMemoryDataset(DatasetBase):
    """reference dataset.py:168 — load the files into host memory,
    shuffle, feed."""

    def load_into_memory(self):
        self._load()

    def local_shuffle(self, seed: Optional[int] = None):
        self._lib.df_local_shuffle(
            self._handle, 0 if seed is None else int(seed))

    def global_shuffle(self, fleet=None, thread_num=12):
        """One host: the global shuffle is the local one (the reference
        shuffles across trainers through the fleet)."""
        self.local_shuffle()

    def preload_into_memory(self, thread_num=None):
        if thread_num:
            self.set_thread(thread_num)
        self._load()

    def wait_preload_done(self):
        pass


class QueueDataset(DatasetBase):
    """reference QueueDataset — streaming; this build parses the files at
    the first pass and streams the batches from memory (the same batches,
    host memory permitting)."""

    def _prepare_to_run(self):
        self._load()
