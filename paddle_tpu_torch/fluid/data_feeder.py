"""DataFeeder (counterpart of paddle_tpu/fluid/data_feeder.py; reference:
python/paddle/fluid/data_feeder.py): turns a minibatch of row tuples into
the feed dict of LoDTensors, one column a feed var, in the var's dtype, on
``place``."""
from __future__ import annotations

import numpy as np

from . import core
from .core import LoDTensor
from .framework import default_main_program

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list, place, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        if program is None:
            program = default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape)
            self.feed_dtypes.append(np.dtype(core.dtype_to_np(each_var.dtype)))
        self.place = place

    def feed(self, iterable):
        """Rows of cells (one cell a feed var, in ``feed_list``'s order) →
        {name: LoDTensor}. A var of LoD level 0 stacks its cells, reshaped
        to the var's shape past the batch dim when a cell lacks a dim; a
        var with LoD concatenates them, their lengths as its LoD."""
        return self.to_tensors(self.feed_arrays(iterable))

    def feed_arrays(self, iterable):
        """``feed``'s columns on the host, with numpy alone: {name:
        (ndarray, recursive sequence lengths or None)}. The multiprocess
        DataLoader's worker runs this; ``to_tensors`` makes the
        LoDTensors in the loader's process."""
        cols = [[] for _ in self.feed_names]
        for row in iterable:
            for i, cell in enumerate(row):
                cols[i].append(cell)
        res = {}
        for name, dtype, shape, lod_level, col in zip(
                self.feed_names, self.feed_dtypes, self.feed_shapes,
                self.feed_lod_level, cols):
            if lod_level == 0:
                arr = np.asarray(col, dtype=dtype)
                if arr.ndim == len(shape) - 1 and -1 not in shape[1:]:
                    arr = arr.reshape([len(col)] + list(shape[1:]))
                res[name] = (arr, None)
            else:
                flat = np.concatenate(
                    [np.asarray(c, dtype=dtype).reshape(
                        -1, *np.asarray(c).shape[1:]) for c in col], axis=0)
                res[name] = (flat, [[len(np.asarray(c)) for c in col]])
        return res

    def to_tensors(self, arrays):
        """{name: (ndarray, lengths or None)} → {name: LoDTensor} on the
        feeder's place."""
        res = {}
        for name, (arr, lengths) in arrays.items():
            t = LoDTensor()
            t.set(arr, self.place)
            if lengths is not None:
                t.set_recursive_sequence_lengths(lengths)
            res[name] = t
        return res
