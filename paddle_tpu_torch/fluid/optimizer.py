"""Optimizers (counterpart of paddle_tpu/fluid/optimizer.py; reference:
python/paddle/fluid/optimizer.py — Optimizer:55, SGD:842, Adam:1714).
Static graph only; so far the base, SGD and Adam.

``minimize`` = append_backward + grad clip + regularization + one update
op per parameter, the reference's contract. Accumulators (moments, beta
powers) and the learning rate are persistable vars that the startup
program fills; each update op writes its outputs back under its inputs'
names.
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

__all__ = ["SGD", "Adam", "SGDOptimizer", "AdamOptimizer"]


class Optimizer:
    """Base (reference optimizer.py:55)."""

    def __init__(self, learning_rate, parameter_list=None,
                 regularization=None, name=None, grad_clip=None):
        if grad_clip is not None:
            raise NotImplementedError("grad_clip comes in a later slice of "
                                      "paddle_tpu_torch")
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self.regularization = regularization
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
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        return self._create_optimization_pass(params_grads)

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
        if grad_clip is not None:
            raise NotImplementedError("grad_clip comes in a later slice of "
                                      "paddle_tpu_torch")
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


SGD = SGDOptimizer
Adam = AdamOptimizer
