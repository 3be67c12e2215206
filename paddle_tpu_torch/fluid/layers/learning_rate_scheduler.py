"""LR schedules as in-graph ops (counterpart of
paddle_tpu/fluid/layers/learning_rate_scheduler.py; reference:
python/paddle/fluid/layers/learning_rate_scheduler.py). So far: the step
counter and noam_decay. A schedule returns a Variable that the main
program recomputes each run from the auto-incremented global counter, so
it advances once a run, and once a step of an ``Executor.run(n_steps=k)``
window."""
from __future__ import annotations

from .nn import autoincreased_step_counter, elementwise_min
from .tensor import cast

__all__ = ["noam_decay"]


def _decay_step_counter(begin=0):
    """The global step as f32: ``begin`` at the first run."""
    counter = autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=begin, step=1)
    return cast(counter, "float32")


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 · min(step^-0.5, step · warmup_steps^-1.5), step from
    1 (Vaswani et al. 2017, §5.3)."""
    step = _decay_step_counter(1)
    a = step ** -0.5
    b = step * (warmup_steps ** -1.5)
    return (d_model ** -0.5) * elementwise_min(a, b)
