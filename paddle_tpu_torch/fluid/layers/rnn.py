"""Recurrent layers (counterpart of paddle_tpu/fluid/layers/rnn.py;
reference: python/paddle/fluid/layers/rnn.py, layers/nn.py lstm:1040 and
lstm_unit). So far: the dense multi-layer ``lstm`` and the single step
``lstm_unit`` (ops/rnn_ops.py)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["lstm_unit", "lstm"]


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step over dense [N, D] input: fc([x, h]) + lstm_unit op."""
    from .nn import fc
    helper = LayerHelper("lstm_unit", **locals())
    H = hidden_t_prev.shape[-1]
    gates = fc([x_t, hidden_t_prev], 4 * H, param_attr=param_attr,
               bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    c.shape = tuple(cell_t_prev.shape)
    h.shape = tuple(cell_t_prev.shape)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [gates], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": forget_bias})
    return h, c


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Dense multi-layer (bi)LSTM over [B, T, D]. Its weight is one flat
    parameter packing, per layer and direction in order, [Wx, Wh, b]
    (ops/rnn_ops.py). → (out [B, T, H·dirs], last_h, last_c)."""
    helper = LayerHelper("lstm", **locals())
    dtype = helper.input_dtype()
    D = input.shape[-1]
    H, L = hidden_size, num_layers
    dirs = 2 if is_bidirec else 1
    total = 0
    in_dim = D
    for _layer in range(L):
        total += dirs * (in_dim * 4 * H + H * 4 * H + 4 * H)
        in_dim = H * dirs
    w = helper.create_parameter(attr=None, shape=[total], dtype=dtype,
                                default_initializer=default_initializer)
    out_v = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    out_v.shape = tuple(input.shape[:-1]) + (H * dirs,)
    helper.append_op(
        type="lstm",
        inputs={"Input": [input], "W": [w], "InitH": [init_h],
                "InitC": [init_c]},
        outputs={"Out": [out_v], "LastH": [last_h], "LastC": [last_c]},
        attrs={"max_len": max_len, "hidden_size": H, "num_layers": L,
               "is_bidirec": is_bidirec, "dropout_prob": dropout_prob,
               "is_test": is_test, "input_size": D,
               "seed": seed if seed and seed > 0 else 0})
    return out_v, last_h, last_c
