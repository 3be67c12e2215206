"""Parameter initializers (counterpart of paddle_tpu/fluid/initializer.py;
reference: python/paddle/fluid/initializer.py). Each initializer appends
the same init op to the startup program as the TPU package does; the
startup run executes it once on the device."""
from __future__ import annotations

import math

import numpy as np

__all__ = [
    "Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier",
    "ConstantInitializer", "UniformInitializer", "NormalInitializer",
    "TruncatedNormalInitializer", "XavierInitializer",
    "NumpyArrayInitializer",
]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    def _compute_fans(self, var):
        shape = var.shape
        if not shape:
            return 1, 1
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]
        receptive = math.prod(shape[2:])
        return shape[1] * receptive, shape[0] * receptive


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = float(value)

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": self._value})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low, self._high, self._seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": self._low, "max": self._high, "seed": self._seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self._mean, "std": self._std, "seed": self._seed})


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self._mean, "std": self._std, "seed": self._seed})


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform, self._seed = uniform, seed
        self._fan_in, self._fan_out = fan_in, fan_out

    def __call__(self, var, block):
        fin, fout = self._compute_fans(var)
        fin = self._fan_in if self._fan_in is not None else fin
        fout = self._fan_out if self._fan_out is not None else fout
        if self._uniform:
            limit = math.sqrt(6.0 / (fin + fout))
            return block.append_op(
                type="uniform_random", outputs={"Out": var},
                attrs={"shape": list(var.shape), "dtype": var.dtype,
                       "min": -limit, "max": limit, "seed": self._seed})
        std = math.sqrt(2.0 / (fin + fout))
        return block.append_op(
            type="gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": 0.0, "std": std, "seed": self._seed})


class NumpyArrayInitializer(Initializer):
    """The given array, written by an ``assign_value`` op (float values as
    fp32_values, others as int32_values, as in the reference)."""

    def __init__(self, value):
        self._value = np.asarray(value)

    def __call__(self, var, block):
        v = self._value
        if v.dtype in (np.float32, np.float64, np.float16):
            attr = {"fp32_values": [float(x) for x in
                                    v.astype(np.float32).flatten()]}
        else:
            attr = {"int32_values": [int(x) for x in v.flatten()]}
        return block.append_op(
            type="assign_value", outputs={"Out": var},
            attrs={"shape": list(v.shape), "dtype": var.dtype, **attr})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
