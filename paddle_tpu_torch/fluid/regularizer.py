"""Weight-decay regularizers (counterpart of paddle_tpu/fluid/regularizer.py;
reference: python/paddle/fluid/regularizer.py): L1Decay, L2Decay and
``append_regularization_ops``, which passes a grad through when no
regularizer is set and otherwise appends grad + decay."""
from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """decay = coeff · param, added to the grad."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = float(regularization_coeff)

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(param.dtype)
        decay.shape = param.shape
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff, "op_role": 1})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    """decay = coeff · sign(param), added to the grad."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = float(regularization_coeff)

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype)
        sign.shape = param.shape
        decay = helper.create_variable_for_type_inference(param.dtype)
        decay.shape = param.shape
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]}, attrs={"op_role": 1})
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff, "op_role": 1})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """reference regularizer.py append_regularization_ops: grad += decay.
    A parameter's own regularizer wins over the optimizer's."""
    res = []
    for param, grad in parameters_and_grads:
        reg = param.regularizer if param.regularizer is not None \
            else regularization
        if grad is None or reg is None:
            res.append((param, grad))
            continue
        block = grad.block
        decay = reg(param, grad, block)
        new_grad = block.create_var(
            name=grad.name + "@REGULARIZED",
            dtype=grad.dtype, shape=grad.shape, persistable=False)
        block.append_op(type="sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [new_grad]}, attrs={"op_role": 1})
        res.append((param, new_grad))
    return res


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
