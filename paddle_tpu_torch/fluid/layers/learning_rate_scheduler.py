"""LR schedules as in-graph ops (counterpart of
paddle_tpu/fluid/layers/learning_rate_scheduler.py; reference:
python/paddle/fluid/layers/learning_rate_scheduler.py): every schedule
of the TPU package, each building the same ops in the same order. A
schedule returns a Variable that the main program recomputes each run
from the auto-incremented global counter ``@LR_DECAY_COUNTER@``, which
all schedules share, so it advances once a run, and once a step of an
``Executor.run(n_steps=k)`` window. ``piecewise_decay`` and
``linear_lr_warmup`` write a persistable LR var through a ``Switch``: on
the compiled path both cases run inside the step's CUDA graph and the
taken one's write is selected on the device."""
from __future__ import annotations

import math

from ..core import VarDesc
from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper
from . import control_flow, ops
from .control_flow import Switch
from .nn import autoincreased_step_counter, elementwise_min
from .tensor import assign, cast, fill_constant

__all__ = [
    "exponential_decay", "natural_exp_decay", "inverse_time_decay",
    "polynomial_decay", "piecewise_decay", "noam_decay", "cosine_decay",
    "linear_lr_warmup",
]

_COUNTER = "@LR_DECAY_COUNTER@"


def _decay_step_counter(begin=0):
    """The global step as f32: ``begin`` at the first run."""
    counter = autoincreased_step_counter(
        counter_name=_COUNTER, begin=begin, step=1)
    return cast(counter, "float32")


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 · min(step^-0.5, step · warmup_steps^-1.5), step from
    1 (Vaswani et al. 2017, §5.3)."""
    step = _decay_step_counter(1)
    a = step ** -0.5
    b = step * (warmup_steps ** -1.5)
    return (d_model ** -0.5) * elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr · rate^(step / decay_steps), the exponent floored when
    ``staircase``."""
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return float(learning_rate) * (float(decay_rate) ** div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr · exp(-rate · step / decay_steps)."""
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return float(learning_rate) * ops.exp(div * float(-decay_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + rate · step / decay_steps)."""
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = ops.floor(div)
    return float(learning_rate) / (div * float(decay_rate) + 1.0)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end) · (1 - step / decay_steps)^power + end, the step capped
    at ``decay_steps``; with ``cycle`` the horizon is ``decay_steps``
    times ceil(step / decay_steps) instead, one cycle at step 0 (the
    reference's Switch on step == 0; the TPU package's cycle branch
    imports an ``equal`` that its layers/nn.py does not define and
    raises ImportError, ROADMAP C)."""
    step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(step / float(decay_steps))
        zero_var = fill_constant([1], "float32", 0.0)
        one_var = fill_constant([1], "float32", 1.0)
        with Switch() as switch:
            with switch.case(control_flow.equal(step, zero_var)):
                assign(one_var, div_res)
        decay_steps_var = div_res * float(decay_steps)
        frac = 1.0 - step / decay_steps_var
    else:
        capped = elementwise_min(
            step, fill_constant([1], "float32", float(decay_steps)))
        frac = 1.0 - capped / float(decay_steps)
    return ((float(learning_rate) - float(end_learning_rate))
            * (frac ** power)) + float(end_learning_rate)


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i], values[-1] after the last: a
    ``Switch`` writing a persistable LR var."""
    helper = LayerHelper("piecewise_decay")
    step = autoincreased_step_counter(counter_name=_COUNTER, begin=0, step=1)
    lr = helper.create_or_get_global_variable(
        name=helper.name + ".lr", dtype=VarDesc.VarType.FP32, shape=[1])
    lr.persistable = True
    helper.set_variable_initializer(lr, Constant(float(values[0])))
    with Switch() as switch:
        for i, b in enumerate(boundaries):
            bval = fill_constant([1], VarDesc.VarType.INT64, int(b))
            with switch.case(control_flow.less_than(step, bval)):
                assign(fill_constant([1], "float32", float(values[i])), lr)
        with switch.default():
            assign(fill_constant([1], "float32", float(values[-1])), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr · (cos(π · epoch / epochs) + 1) / 2, epoch = floor(step /
    step_each_epoch)."""
    step = _decay_step_counter()
    epoch = ops.floor(step / float(step_each_epoch))
    return float(learning_rate) * 0.5 * (
        ops.cos(epoch * (math.pi / float(epochs))) + 1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """start_lr + (end_lr - start_lr) · step / warmup_steps while step <
    warmup_steps, then ``learning_rate`` (a float, or a schedule's
    Variable): a ``Switch`` writing a persistable LR var (BERT's warm-up
    over ``polynomial_decay``, Devlin et al. 2019, §A.2)."""
    helper = LayerHelper("linear_warmup")
    lr = helper.create_or_get_global_variable(
        name=helper.name + ".warmup_lr", dtype=VarDesc.VarType.FP32,
        shape=[1])
    lr.persistable = True
    helper.set_variable_initializer(lr, Constant(float(start_lr)))
    step = autoincreased_step_counter(counter_name=_COUNTER, begin=0, step=1)
    with Switch() as switch:
        wval = fill_constant([1], VarDesc.VarType.INT64, int(warmup_steps))
        with switch.case(control_flow.less_than(step, wval)):
            fstep = cast(step, "float32")
            warm = float(start_lr) + (float(end_lr) - float(start_lr)) \
                * fstep / float(warmup_steps)
            assign(warm, lr)
        with switch.default():
            if isinstance(learning_rate, Variable):
                assign(learning_rate, lr)
            else:
                assign(fill_constant([1], "float32", float(learning_rate)), lr)
    return lr
