"""Weight carry-over into a scope of this package.

``set_params_from_numpy`` replaces the values of initialized scope
variables with numpy arrays keyed by parameter name — for example the
parameters of the TPU package's scope after its startup program, read as
``np.asarray(scope.find_var(n).get_tensor())``. Both packages name a
program's parameters alike (same unique_name counters), so the same model
then computes the same function in both. Any mismatch raises: a name the
scope does not hold, a shape or a dtype that differs from the scope's.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .core import LoDTensor, Place, Scope

__all__ = ["set_params_from_numpy"]


def set_params_from_numpy(scope: Scope, arrays: Dict[str, np.ndarray],
                          place: Optional[Place] = None) -> None:
    """Fill ``scope``'s variables from ``arrays`` on ``place`` (default:
    where each variable already lives). Run the startup program first:
    the scope's current values give the shapes and dtypes to match."""
    dev = place.torch_device() if place is not None else None
    staged = {}
    for name, arr in arrays.items():
        v = scope.find_var(name)
        if v is None or not v.is_initialized() \
                or not isinstance(v.value(), LoDTensor):
            raise KeyError(f"set_params_from_numpy: '{name}' is not an "
                           "initialized tensor in the scope (run the startup "
                           "program first)")
        cur = v.value().array
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(cur.shape):
            raise ValueError(f"set_params_from_numpy: '{name}' has shape "
                             f"{tuple(arr.shape)}, the scope holds "
                             f"{tuple(cur.shape)}")
        t = torch.from_numpy(np.array(arr, copy=True, order="C"))
        if t.dtype != cur.dtype:
            raise TypeError(f"set_params_from_numpy: '{name}' has dtype "
                            f"{arr.dtype}, the scope holds {cur.dtype}")
        staged[name] = t.to(dev if dev is not None else cur.device)
    for name, t in staged.items():  # all checked: now write
        scope.find_var(name).set_value(LoDTensor(t))

