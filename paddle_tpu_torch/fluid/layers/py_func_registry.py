"""The callables of the py_func op (reference: operators/py_func_op.cc
keeps a global vector of them; the op's attrs hold their indices)."""
from __future__ import annotations

_CALLABLES = []


def register_callable(fn) -> int:
    _CALLABLES.append(fn)
    return len(_CALLABLES) - 1


def get_callable(idx: int):
    return _CALLABLES[idx]
