"""Data-input layers (counterpart of paddle_tpu/fluid/layers/io.py;
reference: python/paddle/fluid/layers/io.py). This slice: ``data``."""
from __future__ import annotations

from ..core import VarDesc, convert_np_dtype_to_dtype_
from ..layer_helper import LayerHelper

__all__ = ["data"]


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
