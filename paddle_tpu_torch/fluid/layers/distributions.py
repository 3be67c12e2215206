"""Probability distributions over layers (counterpart of
paddle_tpu/fluid/layers/distributions.py; reference:
python/paddle/fluid/layers/distributions.py), with the TPU package's
methods: ``Uniform`` and ``Normal`` sample, log_prob and entropy;
``Categorical`` (over logits) entropy and kl_divergence;
``MultivariateNormalDiag`` (a [D, D] scale of which only the diagonal is
read) entropy and kl_divergence. A sample draws through the
``uniform_random`` and ``gaussian_random`` ops with their ``seed``: the
port's counter-hash draws, not jax.random's."""
from __future__ import annotations

import math

__all__ = ["Uniform", "Normal", "Categorical", "MultivariateNormalDiag"]


class Distribution:
    def sample(self, shape, seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError


class Uniform(Distribution):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, shape, seed=0):
        from .nn import uniform_random
        return uniform_random(shape, min=0.0, max=1.0, seed=seed) \
            * (self.high - self.low) + self.low

    def log_prob(self, value):
        from . import ops
        return 0.0 - ops.log(value * 0.0 + (self.high - self.low))

    def entropy(self):
        from . import ops
        return ops.log(self.high - self.low)


class Normal(Distribution):
    def __init__(self, loc, scale):
        self.loc, self.scale = loc, scale

    def sample(self, shape, seed=0):
        from .nn import gaussian_random
        return gaussian_random(shape, mean=0.0, std=1.0, seed=seed) \
            * self.scale + self.loc

    def log_prob(self, value):
        from . import ops
        var = self.scale * self.scale
        return -1.0 * ((value - self.loc) * (value - self.loc)) / (2.0 * var) \
            - ops.log(self.scale) - math.log(math.sqrt(2.0 * math.pi))

    def entropy(self):
        from . import ops
        return 0.5 + 0.5 * math.log(2.0 * math.pi) + ops.log(self.scale)


class Categorical(Distribution):
    """Entropy and KL over the softmax of ``logits`` (log(p + 1e-10))."""

    def __init__(self, logits):
        self.logits = logits

    def _probs(self):
        from .nn import softmax
        return softmax(self.logits)

    def entropy(self):
        from . import ops
        from .nn import reduce_sum
        p = self._probs()
        return 0.0 - reduce_sum(p * ops.log(p + 1e-10), dim=-1)

    def kl_divergence(self, other):
        from . import ops
        from .nn import reduce_sum
        p, q = self._probs(), other._probs()
        return reduce_sum(p * (ops.log(p + 1e-10) - ops.log(q + 1e-10)),
                          dim=-1)


class MultivariateNormalDiag(Distribution):
    """A Gaussian of diagonal scale: 0.5·(D·(1 + log 2π)) + Σ log s for the
    entropy, as the TPU package writes it, and the KL between two."""

    def __init__(self, loc, scale):
        self.loc, self.scale = loc, scale

    def entropy(self):
        from . import ops
        from .nn import reduce_sum
        d = float(self.loc.shape[-1])
        logdet = reduce_sum(ops.log(_diag_part(self.scale) + 1e-10), dim=-1)
        return 0.5 * d * (1.0 + math.log(2.0 * math.pi)) + logdet

    def kl_divergence(self, other):
        from . import ops
        from .nn import reduce_sum
        s1, s2 = _diag_part(self.scale), _diag_part(other.scale)
        var1, var2 = s1 * s1, s2 * s2
        mu = other.loc - self.loc
        return 0.5 * (reduce_sum(var1 / var2, dim=-1)
                      + reduce_sum(mu * mu / var2, dim=-1)
                      - float(self.loc.shape[-1])
                      + 2.0 * (reduce_sum(ops.log(s2 + 1e-10), dim=-1)
                               - reduce_sum(ops.log(s1 + 1e-10), dim=-1)))


def _diag_part(mat):
    """The diagonal of the trailing [D, D] block: mat · eye(D) summed
    over the last axis."""
    from .nn import reduce_sum
    from .tensor import eye
    d = int(mat.shape[-1])
    return reduce_sum(mat * eye(d, dtype=mat.dtype), dim=-1)
