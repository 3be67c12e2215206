"""Data-input layers (counterpart of paddle_tpu/fluid/layers/io.py;
reference: python/paddle/fluid/layers/io.py): ``data``, the legacy
reader layers and ``load``.

As in the TPU package, ``py_reader`` declares plain data vars and returns
a ``PyReader`` over them, appending no reader or ``read`` op: its
``decorate_*`` methods take the Python generators, and iterating it
gives feed dicts for ``Executor.run`` (the loader's prefetch thread and
its upload stream are the double buffer). ``double_buffer`` gives its
reader back and ``read_file`` gives a ``PyReader``'s data vars."""
from __future__ import annotations

from ..core import VarDesc, convert_np_dtype_to_dtype_
from ..layer_helper import LayerHelper

__all__ = ["data", "read_file", "double_buffer", "py_reader",
           "create_py_reader_by_data", "load"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarDesc.VarType.LOD_TENSOR, stop_gradient=True):
    helper = LayerHelper("data")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.main_program.global_block().create_var(
        name=name, shape=shape, dtype=convert_np_dtype_to_dtype_(dtype),
        lod_level=lod_level, type=type, stop_gradient=stop_gradient,
        is_data=True, need_check_feed=True)


def read_file(reader):
    """The data vars a ``py_reader`` handle declared, in its order."""
    from ..reader import PyReader
    if isinstance(reader, PyReader):
        return list(reader._feed_list)
    raise NotImplementedError("read_file: pass the py_reader handle, or "
                              "feed batches through DataLoader")


def double_buffer(reader, place=None, name=None):
    return reader


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """A ``PyReader`` over data vars ``<name>_<i>`` (``py_reader_<i>``
    without a name) of the given shapes, dtypes and LoD levels."""
    from ..reader import PyReader
    names = [(name or "py_reader") + f"_{i}" for i in range(len(shapes))]
    lod_levels = lod_levels or [0] * len(shapes)
    feed_vars = [data(n, shape=list(s), append_batch_size=False, dtype=d,
                      lod_level=l)
                 for n, s, d, l in zip(names, shapes, dtypes, lod_levels)]
    return PyReader(feed_list=feed_vars, capacity=capacity,
                    use_double_buffer=use_double_buffer, iterable=True)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """A ``PyReader`` over existing data vars."""
    from ..reader import PyReader
    return PyReader(feed_list=list(feed_list), capacity=capacity,
                    use_double_buffer=use_double_buffer, iterable=True)


def load(out, file_path, load_as_fp16=None):
    """Appends a ``load`` op that restores ``out`` from a file the
    ``save`` op (or ``fluid.io``'s serializer) wrote."""
    helper = LayerHelper("load")
    attrs = {"file_path": file_path}
    if load_as_fp16 is not None:
        attrs["load_as_fp16"] = bool(load_as_fp16)
    helper.append_op(type="load", inputs={}, outputs={"Out": [out]},
                     attrs=attrs)
    return out
