"""ctr_metric_bundle (counterpart of
paddle_tpu/fluid/contrib/layers/metric_op.py; reference:
contrib/layers/metric_op.py): the running sums FleetUtil's global metrics
read (squared error, absolute error, the predicted sum, the sum of
prediction times label, positives and instances), persistable vars
zeroed by the startup program and added to each run."""
from __future__ import annotations

from ... import layers
from ...layer_helper import LayerHelper
from ...core import VarDesc

__all__ = ["ctr_metric_bundle"]


def ctr_metric_bundle(input, label):
    """input: predicted ctr [B,1] float; label: [B,1] float 0/1. Returns
    (sqrerr, abserr, prob, q, pos_num, total_num) accumulator vars —
    persistable running sums matching the reference contract."""
    helper = LayerHelper("ctr_metric_bundle")

    def acc_var(name):
        block = helper.main_program.global_block()
        v = block.create_var(name=helper.name + "_" + name, shape=(1,),
                             dtype=VarDesc.VarType.FP32, persistable=True)
        from ...framework import default_startup_program
        sb = default_startup_program().global_block()
        sb.create_var(name=v.name, shape=(1,), persistable=True,
                      dtype=VarDesc.VarType.FP32)
        sb.append_op(type="fill_constant", inputs={}, outputs={"Out": [v]},
                     attrs={"shape": [1], "value": 0.0,
                            "dtype": VarDesc.VarType.FP32})
        return v

    diff = layers.elementwise_sub(input, label)
    batch_sqrerr = layers.reduce_sum(
        layers.elementwise_mul(diff, diff))
    batch_abserr = layers.reduce_sum(layers.abs(diff))
    batch_prob = layers.reduce_sum(input)
    batch_q = layers.reduce_sum(
        layers.elementwise_mul(input, label))
    batch_pos = layers.reduce_sum(label)
    batch_total = layers.reduce_sum(layers.ones_like(label))

    outs = []
    for name, batch in (("sqrerr", batch_sqrerr), ("abserr", batch_abserr),
                        ("prob", batch_prob), ("q", batch_q),
                        ("pos", batch_pos), ("total", batch_total)):
        acc = acc_var(name)
        b1 = layers.reshape(batch, [1])
        helper.append_op(type="elementwise_add",
                         inputs={"X": [acc], "Y": [b1]},
                         outputs={"Out": [acc]}, attrs={"axis": -1})
        outs.append(acc)
    return tuple(outs)
