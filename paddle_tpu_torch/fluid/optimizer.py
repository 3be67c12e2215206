"""Optimizers (counterpart of paddle_tpu/fluid/optimizer.py; reference:
python/paddle/fluid/optimizer.py — Optimizer:55, SGD:842, Momentum:936,
Adagrad:1598, Adam:1714, Adamax:1980, Dpsgd:2152, DecayedAdagrad:2247,
Adadelta:2357, RMSProp:2476, Ftrl:2664, Lamb:2823, LarsMomentum:1484,
ModelAverage:2995, ExponentialMovingAverage:3302, RecomputeOptimizer:3850,
LookaheadOptimizer:4138). Static graph only; every optimizer of the TPU
package but PipelineOptimizer, which comes with the parallel plane.

``minimize`` = append_backward + grad clip + regularization + one update
op per parameter, the reference's contract. Accumulators (moments, beta
powers) and the learning rate are persistable vars that the startup
program fills; each update op writes its outputs back under its inputs'
names. ``GradientMergeOptimizer`` accumulates the grads in persistables
and puts the update in a ``conditional_block`` that fires every k-th
step: the compiled step runs it both-branch (executor.py), so every
micro-step computes the update and keeps the old state where the
condition is false. ``LookaheadOptimizer`` blends slow and fast weights
every k steps by arithmetic on an int64 step counter, with no
conditional. ModelAverage and ExponentialMovingAverage raise
NotImplementedError where the TPU package's do.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

from . import unique_name
from .backward import OP_ROLE_OPTIMIZE, append_backward
from .clip import append_gradient_clip_ops
from .core import VarDesc
from .framework import (Variable, default_main_program,
                        default_startup_program, program_guard)
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "Dpsgd", "DecayedAdagrad",
    "Ftrl", "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer",
    "AdamOptimizer", "AdamaxOptimizer", "DpsgdOptimizer",
    "DecayedAdagradOptimizer", "RMSPropOptimizer", "FtrlOptimizer", "Adadelta",
    "AdadeltaOptimizer", "ModelAverage", "LarsMomentum",
    "LarsMomentumOptimizer", "LambOptimizer", "ExponentialMovingAverage",
    "LookaheadOptimizer", "RecomputeOptimizer", "DGCMomentumOptimizer",
    "DGCMomentum", "Lookahead", "Lamb", "GradientMergeOptimizer",
]


class Optimizer:
    """Base (reference optimizer.py:55)."""

    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, name=None, grad_clip=None):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self._learning_rate_map: Dict[int, Variable] = {}
        self._accumulators: Dict[str, Dict[str, Variable]] = \
            defaultdict(dict)
        self.helper = None
        self.type = getattr(self, "type", "sgd")

    # ------------------------------------------------------------- lr
    def _create_global_learning_rate(self):
        program = default_main_program()
        if id(program) in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[id(program)] = self._learning_rate
            return
        lr_name = unique_name.generate("learning_rate")
        lr_var = program.global_block().create_var(
            name=lr_name, shape=(1,), persistable=True,
            dtype=VarDesc.VarType.FP32)
        lr_var.stop_gradient = True
        startup = default_startup_program().global_block()
        sv = startup.create_var(name=lr_name, shape=(1,), persistable=True,
                                dtype=VarDesc.VarType.FP32)
        Constant(float(self._learning_rate))(sv, startup)
        self._learning_rate_map[id(program)] = lr_var

    def _global_learning_rate(self, program=None):
        program = default_main_program() if program is None else program
        return self._learning_rate_map.get(id(program))

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        base = self._global_learning_rate()
        plr = (param.optimize_attr or {}).get("learning_rate", 1.0)
        if plr == 1.0:
            return base
        helper = LayerHelper("scale")
        out = helper.create_variable_for_type_inference(base.dtype)
        out.shape = base.shape
        helper.append_op(type="scale", inputs={"X": [base]},
                         outputs={"Out": [out]},
                         attrs={"scale": float(plr)})
        return out

    # ----------------------------------------------------- accumulators
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        block = default_main_program().global_block()
        var_name = unique_name.generate(param.name + "_" + name)
        shape = shape if shape is not None else param.shape
        var = block.create_var(name=var_name, shape=shape, persistable=True,
                               dtype=dtype or param.dtype,
                               belong_to_optimizer=True)
        var.stop_gradient = True
        startup = default_startup_program().global_block()
        sv = startup.create_var(name=var_name, shape=shape, persistable=True,
                                dtype=dtype or param.dtype)
        Constant(float(fill_value))(sv, startup)
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # ------------------------------------------------------------- api
    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _create_accumulators(self, block, parameters):
        pass

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        """Sort by name, clip (the optimizer's own ``grad_clip``: a group
        clip over every pair, another per pair; else what
        ``set_gradient_clip`` set), regularize, then the update ops."""
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        clip = self._grad_clip
        if clip is None:
            params_grads = append_gradient_clip_ops(params_grads)
        elif hasattr(clip, "_process_group"):
            params_grads = clip._process_group(params_grads)
        else:
            params_grads = [clip._process(p, g) if g is not None else (p, g)
                            for p, g in params_grads]
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        return self._create_optimization_pass(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        """The update ops for ``params_grads`` (the second half of the
        split backward()/apply_optimize() API)."""
        with program_guard(default_main_program(),
                           startup_program or default_startup_program()):
            return self.apply_gradients(params_grads)

    def _create_optimization_pass(self, parameters_and_grads):
        block = default_main_program().current_block()
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        ops = []
        for param, grad in parameters_and_grads:
            if grad is None or not param.trainable:
                continue
            op = self._append_optimize_op(block, (param, grad))
            op.attrs["op_role"] = OP_ROLE_OPTIMIZE
            op.attrs["op_role_var"] = [param.name, grad.name]
            ops.append(op)
        return ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        """``grad_clip`` is the reference's dygraph-only argument: a static
        program takes its clip from the constructor or from
        ``set_gradient_clip``, as in the TPU package."""
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, name=None, grad_clip=None):
        super().__init__(learning_rate, parameter_list, regularization, name,
                         grad_clip)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="sgd",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]]})


class MomentumOptimizer(Optimizer):
    """v ← mu·v + g, p ← p − lr·v (Nesterov: p − lr·(g + mu·v)); one
    velocity accumulator per parameter."""

    def __init__(self, learning_rate, momentum, parameter_list=None,
                 use_nesterov=False, regularization=None, name=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameter_list, regularization, name,
                         grad_clip)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator("velocity", param_and_grad[0])
        return block.append_op(
            type="momentum",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "VelocityOut": [velocity]},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


class LarsMomentumOptimizer(Optimizer):
    """Momentum under LARS's layer-wise LR (the ``lars_momentum`` op)."""

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameter_list=None,
                 regularization=None, name=None, grad_clip=None):
        super().__init__(learning_rate, parameter_list, regularization, name,
                         grad_clip)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator("velocity", param_and_grad[0])
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameter_list=None,
                 regularization=None, name=None, initial_accumulator_value=0.0,
                 grad_clip=None):
        super().__init__(learning_rate, parameter_list, regularization, name,
                         grad_clip)
        self.type = "adagrad"
        self._epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p,
                                  fill_value=self.initial_accumulator_value)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator("moment", param_and_grad[0])
        return block.append_op(
            type="adagrad",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameter_list=None, regularization=None,
                 name=None, lazy_mode=False, grad_clip=None):
        super().__init__(learning_rate, parameter_list, regularization, name,
                         grad_clip)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1
                                  if not isinstance(self._beta1, Variable)
                                  else 0.9, shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2
                                  if not isinstance(self._beta2, Variable)
                                  else 0.999, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        m1 = self._get_accumulator("moment1", param_and_grad[0])
        m2 = self._get_accumulator("moment2", param_and_grad[0])
        b1p = self._get_accumulator("beta1_pow_acc", param_and_grad[0])
        b2p = self._get_accumulator("beta2_pow_acc", param_and_grad[0])
        return block.append_op(
            type="adam",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "Moment1Out": [m1], "Moment2Out": [m2],
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "lazy_mode": self._lazy_mode})


class AdamaxOptimizer(Optimizer):
    """Adamax; after each parameter's ``adamax`` op a ``scale`` op
    advances its beta-1 power (the op itself does not)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameter_list=None, regularization=None,
                 name=None, grad_clip=None):
        super().__init__(learning_rate, parameter_list, regularization, name,
                         grad_clip)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator("moment", param_and_grad[0])
        inf_norm = self._get_accumulator("inf_norm", param_and_grad[0])
        b1p = self._get_accumulator("beta1_pow_acc", param_and_grad[0])
        op = block.append_op(
            type="adamax",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [moment], "InfNorm": [inf_norm],
                    "Beta1Pow": [b1p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})
        block.append_op(type="scale", inputs={"X": [b1p]},
                        outputs={"Out": [b1p]},
                        attrs={"scale": self._beta1,
                               "op_role": OP_ROLE_OPTIMIZE})
        return op


class DpsgdOptimizer(Optimizer):
    """Differentially private SGD (the ``dpsgd`` op draws its noise from
    the op's key: a random op)."""

    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1e-8, parameter_list=None):
        super().__init__(learning_rate, parameter_list)
        self.type = "dpsgd"
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="dpsgd",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 parameter_list=None, regularization=None, name=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameter_list, regularization, name,
                         grad_clip)
        self.type = "decayed_adagrad"
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator("moment", param_and_grad[0])
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    """Adadelta (its op reads no learning rate)."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 parameter_list=None, regularization=None, name=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameter_list, regularization, name,
                         grad_clip)
        self.type = "adadelta"
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        g = self._get_accumulator("__avg_squared_grad", param_and_grad[0])
        u = self._get_accumulator("__avg_squared_update", param_and_grad[0])
        return block.append_op(
            type="adadelta",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "AvgSquaredGrad": [g], "AvgSquaredUpdate": [u]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "AvgSquaredGradOut": [g], "AvgSquaredUpdateOut": [u]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameter_list=None, regularization=None,
                 name=None, grad_clip=None):
        super().__init__(learning_rate, parameter_list, regularization, name,
                         grad_clip)
        self.type = "rmsprop"
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        mom = self._get_accumulator("momentum", param_and_grad[0])
        ms = self._get_accumulator("mean_square", param_and_grad[0])
        mg = self._get_accumulator("mean_grad", param_and_grad[0])
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [mom], "MeanSquare": [ms], "MeanGrad": [mg],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [mom],
                     "MeanSquareOut": [ms], "MeanGradOut": [mg]},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameter_list=None, regularization=None, name=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameter_list, regularization, name,
                         grad_clip)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        sq = self._get_accumulator("squared", param_and_grad[0])
        lin = self._get_accumulator("linear", param_and_grad[0])
        return block.append_op(
            type="ftrl",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "SquaredAccumOut": [sq], "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class LambOptimizer(AdamOptimizer):
    """LAMB: Adam's accumulators, the ``lamb`` op; a parameter for which
    ``exclude_from_weight_decay_fn`` answers True gets weight decay 0."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameter_list=None,
                 regularization=None, exclude_from_weight_decay_fn=None,
                 name=None, grad_clip=None):
        super().__init__(learning_rate=learning_rate, beta1=beta1,
                         beta2=beta2, epsilon=epsilon,
                         parameter_list=parameter_list,
                         regularization=regularization, name=name,
                         grad_clip=grad_clip)
        self.type = "lamb"
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, param_and_grad):
        m1 = self._get_accumulator("moment1", param_and_grad[0])
        m2 = self._get_accumulator("moment2", param_and_grad[0])
        b1p = self._get_accumulator("beta1_pow_acc", param_and_grad[0])
        b2p = self._get_accumulator("beta2_pow_acc", param_and_grad[0])
        wd = 0.0 if (self._exclude_fn is not None
                     and self._exclude_fn(param_and_grad[0])) \
            else self._weight_decay
        return block.append_op(
            type="lamb",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "Moment1Out": [m1], "Moment2Out": [m2],
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd})


class ModelAverage(Optimizer):
    """reference optimizer.py:2995. Not implemented: it raises
    NotImplementedError after taking its arguments, as the TPU package's
    does."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization=regularization, name=name)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        raise NotImplementedError(
            "ModelAverage is not implemented (nor in the TPU package)")


class ExponentialMovingAverage:
    """reference optimizer.py:3302. Not implemented, as in the TPU
    package."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        raise NotImplementedError("ExponentialMovingAverage is not "
                                  "implemented (nor in the TPU package)")


class RecomputeOptimizer(Optimizer):
    """Rematerialization (reference optimizer.py:3850). The checkpoint
    var names are recorded on the program (``_recompute_opt``) and the
    compiled executor lowers the segments between them
    (fluid/recompute_lowering.py): a segment's forward keeps only its
    boundary values, and its backward span runs the segment's forward
    again under autograd, so only segment boundaries stay live between
    forward and backward. A shape the lowering cannot split runs without
    remat (same numerics, more memory), with a warning."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self._optimizer.backward(loss, startup_program,
                                        parameter_list, no_grad_set,
                                        callbacks)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self._optimizer.apply_optimize(loss, startup_program,
                                              params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_optimize(loss, startup_program,
                                           params_grads)
        if self._checkpoints:
            names = [v.name if hasattr(v, "name") else str(v)
                     for v in self._checkpoints]
            loss.block.program._recompute_opt = {"checkpoints": names}
        return optimize_ops, params_grads


class GradientMergeOptimizer:
    """Gradient accumulation over ``k_steps`` micro-batches (the
    reference's batch-merge capability, ir/multi_batch_merge_pass.cc).
    Each run adds its grads into persistable accumulators in the main
    block; the inner optimizer's update (on the accumulators, averaged
    when ``avg``) and the accumulators' reset sit in a ``cond`` on
    ``step % k == 0`` of an int32 step counter. ``k_steps`` 1 has no
    cond. The compiled step runs the conditional both-branch: each
    micro-step computes the whole update and keeps the old parameters,
    moments and accumulators where the condition is false."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        if inner_optimizer is None:
            raise ValueError("inner optimizer can not be None")
        if int(k_steps) < 1:
            raise ValueError("k_steps should be a positive integer")
        self.inner_optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = bool(avg)
        self.type = "gradient_merge"

    def _create_persistable(self, main_block, startup, name, shape, dtype,
                            value):
        v = main_block.create_var(name=name, shape=shape, dtype=dtype,
                                  persistable=True)
        v.stop_gradient = True
        sb = startup.global_block()
        sv = sb.create_var(name=name, shape=shape, dtype=dtype,
                           persistable=True)
        Constant(float(value))(sv, sb)
        return v

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers import control_flow, tensor
        from .layers import nn as lnn
        main = loss.block.program
        startup = startup_program or default_startup_program()
        k = self.k_steps
        with program_guard(main, startup):
            params_grads = self.inner_optimizer.backward(
                loss, startup_program, parameter_list, no_grad_set)
            block = main.global_block()
            step = self._create_persistable(
                block, startup, unique_name.generate("gradient_merge_step"),
                [1], "int32", 0)
            control_flow.increment(step, value=1, in_place=True)
            merged = []
            for p, g in params_grads:
                if g is None:
                    continue
                acc = self._create_persistable(
                    block, startup,
                    unique_name.generate(p.name + "@GradientMerge"),
                    p.shape, p.dtype, 0.0)
                block.append_op(type="elementwise_add",
                                inputs={"X": [acc.name], "Y": [g.name]},
                                outputs={"Out": [acc.name]},
                                attrs={"axis": -1})
                merged.append((p, acc))

            if k == 1:
                cond_var = None
            else:
                k_var = tensor.fill_constant([1], "int32", k)
                zero = tensor.fill_constant([1], "int32", 0)
                cond_var = control_flow.equal(
                    lnn.elementwise_mod(step, k_var), zero)

            optimize_ops = []

            def _apply():
                new_pg = []
                for p, acc in merged:
                    g = acc
                    if self.avg:
                        g = lnn.scale(acc, scale=1.0 / k)
                    new_pg.append((p, g))
                optimize_ops.extend(
                    self.inner_optimizer.apply_gradients(new_pg))
                for p, acc in merged:
                    # reset the accumulator for the next k-step window
                    main.current_block().append_op(
                        type="scale", inputs={"X": [acc.name]},
                        outputs={"Out": [acc.name]},
                        attrs={"scale": 0.0, "bias": 0.0,
                               "bias_after_scale": True})

            if cond_var is None:
                _apply()
            else:
                control_flow.cond(cond_var, _apply)
        return optimize_ops, params_grads


class LookaheadOptimizer:
    """reference optimizer.py:4138: slow weights track the fast ones every
    k steps, slow += alpha · (fast − slow), fast := slow. A blend by an
    int64 step counter (``is_sync`` = cast(step % k == 0)) in the main
    block: no conditional. The startup program starts each slow weight
    at its parameter."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if inner_optimizer is None:
            raise ValueError("inner optimizer can not be None")
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha should be in [0, 1]")
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = int(k)

    def minimize(self, loss, startup_program=None):
        from . import layers as L
        mini_out = self.inner_optimizer.minimize(
            loss, startup_program=startup_program)
        main = loss.block.program
        startup = startup_program or default_startup_program()
        with program_guard(main, startup):
            self._append_lookahead_ops(main, startup, L)
        return mini_out

    def _append_lookahead_ops(self, main, startup, L):
        block = main.global_block()
        # an integer counter: an f32 one stops counting at 2^24
        step = block.create_var(name=unique_name.generate("lookahead_step"),
                                shape=(1,), persistable=True,
                                dtype=VarDesc.VarType.INT64)
        sv = startup.global_block().create_var(
            name=step.name, shape=(1,), persistable=True,
            dtype=VarDesc.VarType.INT64)
        Constant(0)(sv, startup.global_block())
        block.append_op(type="increment", inputs={"X": [step]},
                        outputs={"Out": [step]}, attrs={"step": 1.0})
        kmod = L.elementwise_mod(step, L.fill_constant([1], "int64", self.k))
        is_sync = L.cast(L.equal(kmod, L.fill_constant([1], "int64", 0)),
                         "float32")
        for param in main.all_parameters():
            slow = block.create_var(
                name=unique_name.generate(param.name + "_slow"),
                shape=param.shape, persistable=True, dtype=param.dtype)
            ssv = startup.global_block().create_var(
                name=slow.name, shape=param.shape, persistable=True,
                dtype=param.dtype)
            startup.global_block().append_op(
                type="assign", inputs={"X": [param.name]},
                outputs={"Out": [ssv]})
            blended = L.elementwise_add(
                slow, L.elementwise_mul(
                    L.elementwise_sub(param, slow),
                    L.fill_constant([1], "float32", self.alpha)))
            new_slow = L.elementwise_add(
                L.elementwise_mul(blended, is_sync),
                L.elementwise_mul(slow, 1.0 - is_sync))
            new_fast = L.elementwise_add(
                L.elementwise_mul(blended, is_sync),
                L.elementwise_mul(param, 1.0 - is_sync))
            block.append_op(type="assign", inputs={"X": [new_slow]},
                            outputs={"Out": [slow]})
            block.append_op(type="assign", inputs={"X": [new_fast]},
                            outputs={"Out": [param]})


class DGCMomentumOptimizer(MomentumOptimizer):
    """reference optimizer.py:1071: deep gradient compression momentum.
    The TPU package keeps the API, the momentum and the rampup knobs and
    makes the compression a no-op (the reference's behaviour below
    ``rampup_begin_step``); so does the port: on one card there is no
    gradient exchange to compress."""

    def __init__(self, learning_rate, momentum, rampup_begin_step,
                 rampup_step=1, sparsity=None, parameter_list=None,
                 use_nesterov=False, local_grad_clip_norm=None,
                 num_trainers=None, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, momentum,
                         parameter_list=parameter_list,
                         use_nesterov=use_nesterov,
                         regularization=regularization,
                         grad_clip=grad_clip, name=name)
        self._rampup_begin_step = rampup_begin_step
        self._rampup_step = rampup_step
        self._sparsity = sparsity or [0.999]


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Dpsgd = DpsgdOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
Lamb = LambOptimizer
DGCMomentum = DGCMomentumOptimizer
Lookahead = LookaheadOptimizer
