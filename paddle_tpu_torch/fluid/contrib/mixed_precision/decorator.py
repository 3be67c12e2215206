"""AMP decorator (counterpart of
paddle_tpu/fluid/contrib/mixed_precision/decorator.py; reference:
contrib/mixed_precision/decorator.py:218).

bf16 first: the inputs of white-list ops (matmul, mul, conv: the tensor
core ops) are cast to bf16 by cast ops spliced before them, and their
outputs are typed bf16; black-list ops stay f32. Parameters stay f32
master copies: a weight's bf16 copy is an intermediate of the step, and
its grad flows back through the cast's grad into the f32 ``W@GRAD``.

Loss scaling: bf16 needs none, so by default the scale API is kept but
inert. ``use_fp16=True`` turns on real loss scaling (reference
decorator.py scaled_loss + update_loss_scaling): the loss is multiplied
by a scale before backward and the grads are divided by it before the
update. Static scaling (``use_dynamic_loss_scaling=False``) multiplies by
a constant. Dynamic scaling keeps the scale and its two counters in three
persistable vars and records them in ``program._amp_dynamic``; the
executor updates them in the step's epilogue from the SAME health scalar
the FLAGS_check_nan_inf guard computes (executor._amp_scale_update), and
discards an overflowed step whole (params and optimizer slots revert, the
scale still updates).
"""
from __future__ import annotations

from typing import Optional

from ... import unique_name
from ...core import VarDesc
from ...framework import default_startup_program, Variable

__all__ = ["decorate", "AutoMixedPrecisionLists"]

WHITE_LIST = {"matmul", "matmul_v2", "mul", "conv2d", "depthwise_conv2d",
              "conv3d", "bmm"}
BLACK_LIST = {"softmax", "softmax_with_cross_entropy", "cross_entropy",
              "cross_entropy2", "exp", "log", "mean", "sum", "layer_norm",
              "batch_norm", "reduce_mean", "reduce_sum"}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
        self.black_varnames = set(custom_black_varnames or [])


def _insert_casts(program, amp_lists: AutoMixedPrecisionLists):
    """Rewrite the main block: the f32 inputs of white-list ops are cast
    to bf16 (one cast op per var, spliced before its first consumer) and
    their outputs are typed bf16. An op that adds an f32 tensor to such an
    output computes in f32 (type promotion), as in the TPU package."""
    block = program.global_block()
    new_ops = []
    cast_cache = {}
    idx = 0
    for op in list(block.ops):
        if op.type in amp_lists.white_list:
            for slot, names in op.inputs.items():
                for k, n in enumerate(names):
                    v = block.vars.get(n)
                    if v is None or v.dtype != VarDesc.VarType.FP32:
                        continue
                    if n in amp_lists.black_varnames:
                        continue
                    key = n
                    if key not in cast_cache:
                        cast_name = n + ".cast_bf16"
                        block.create_var(name=cast_name,
                                         dtype=VarDesc.VarType.BF16,
                                         shape=v.shape, persistable=False)
                        cast_cache[key] = cast_name
                        new_ops.append((op, {"type": "cast",
                                             "inputs": {"X": [n]},
                                             "outputs": {"Out": [cast_name]},
                                             "attrs": {"in_dtype": v.dtype,
                                                       "out_dtype":
                                                       VarDesc.VarType.BF16}}))
                    names[k] = cast_cache[key]
            for slot, names in op.outputs.items():
                for n in names:
                    v = block.vars.get(n)
                    if v is not None:
                        v.dtype = VarDesc.VarType.BF16
    # splice cast ops before their consumers
    for anchor, desc in new_ops:
        pos = block.ops.index(anchor)
        block._insert_op(pos, type=desc["type"], inputs=desc["inputs"],
                         outputs=desc["outputs"], attrs=desc["attrs"])
    return program


def _create_persistable(main_block, startup_block, name, dtype, value):
    """One [1]-shaped persistable state var declared in BOTH programs and
    filled by the startup program (the pattern of the reference's
    create_global_var + loss-scaling initializers)."""
    v = main_block.create_var(name=name, dtype=dtype, shape=(1,),
                              persistable=True)
    v.stop_gradient = True
    startup_block.create_var(name=name, dtype=dtype, shape=(1,),
                             persistable=True)
    startup_block.append_op(type="fill_constant", inputs={},
                            outputs={"Out": [name]},
                            attrs={"shape": [1], "dtype": dtype,
                                   "value": float(value)})
    return v


class OptimizerWithMixedPrecision:
    """reference decorator.py:27."""

    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
                 use_fp16=False):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = init_loss_scaling
        self._loss_scaling = init_loss_scaling
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._use_fp16 = bool(use_fp16)
        self._scale_var: Optional[Variable] = None
        self._train_program = None

    @property
    def _scaling_enabled(self) -> bool:
        # bf16 exponent range equals fp32 — scaling only matters when the
        # user forces the narrow-mantissa fp16-style contract; with it,
        # use_dynamic_loss_scaling picks dynamic vs STATIC scaling (the
        # reference scales whenever fp16 is on — a requested
        # init_loss_scaling must never be silently dropped)
        return self._use_fp16

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        program = loss.block.program
        _insert_casts(program, self._amp_lists)
        if not self._scaling_enabled:
            return self._optimizer.backward(
                loss, startup_program, parameter_list, no_grad_set,
                callbacks)
        if not self._use_dynamic_loss_scaling:
            # STATIC scaling: loss * constant before backward, grads /
            # constant in apply_gradients — no state vars, no executor
            # epilogue involvement
            main_block = loss.block
            scaled = main_block.create_var(
                name=unique_name.generate(loss.name + ".scaled"),
                dtype=loss.dtype, persistable=False)
            scaled.shape = loss.shape
            scaled.stop_gradient = False
            main_block.append_op(
                type="scale", inputs={"X": [loss.name]},
                outputs={"Out": [scaled.name]},
                attrs={"scale": float(self._init_loss_scaling),
                       "bias": 0.0, "bias_after_scale": True})
            return self._optimizer.backward(
                scaled, startup_program, parameter_list, no_grad_set,
                callbacks)
        # dynamic loss scaling: backward runs on loss * loss_scaling so
        # small grads survive the narrow format; the executor's fused
        # guard epilogue owns the scale/counter transition (and the
        # overflow-step discard), keyed off program._amp_dynamic
        startup = startup_program or default_startup_program()
        main_block = loss.block
        startup_block = startup.global_block()
        scale = _create_persistable(
            main_block, startup_block, unique_name.generate("loss_scaling"),
            VarDesc.VarType.FP32, self._init_loss_scaling)
        good = _create_persistable(
            main_block, startup_block,
            unique_name.generate("loss_scaling_good"),
            VarDesc.VarType.INT32, 0)
        bad = _create_persistable(
            main_block, startup_block,
            unique_name.generate("loss_scaling_bad"),
            VarDesc.VarType.INT32, 0)
        self._scale_var = scale
        scaled = main_block.create_var(
            name=unique_name.generate(loss.name + ".scaled"),
            dtype=loss.dtype, persistable=False)
        scaled.shape = loss.shape
        scaled.stop_gradient = False
        main_block.append_op(type="elementwise_mul",
                             inputs={"X": [loss.name], "Y": [scale.name]},
                             outputs={"Out": [scaled.name]},
                             attrs={"axis": -1})
        program._amp_dynamic = {
            "scale": scale.name, "good": good.name, "bad": bad.name,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
        }
        return self._optimizer.backward(
            scaled, startup_program, parameter_list, no_grad_set,
            callbacks)

    def apply_gradients(self, params_grads):
        # cast bf16 grads up to fp32 before the update (master weights),
        # then divide the loss scale back out (reference
        # check_finite_and_unscale's unscale half; the finite half is the
        # executor's fused health scalar)
        from ...layers import tensor as _t
        fixed = []
        for p, g in params_grads:
            if g is not None and g.dtype == VarDesc.VarType.BF16:
                g = _t.cast(g, VarDesc.VarType.FP32)
            if g is not None and self._scaling_enabled:
                block = g.block
                un = block.create_var(
                    name=unique_name.generate(g.name + ".unscaled"),
                    dtype=g.dtype, persistable=False)
                un.shape = g.shape
                if self._use_dynamic_loss_scaling:
                    block.append_op(
                        type="elementwise_div",
                        inputs={"X": [g.name],
                                "Y": [self._scale_var.name]},
                        outputs={"Out": [un.name]}, attrs={"axis": -1})
                else:  # static: divide by the compile-time constant
                    block.append_op(
                        type="scale", inputs={"X": [g.name]},
                        outputs={"Out": [un.name]},
                        attrs={"scale":
                               1.0 / float(self._init_loss_scaling),
                               "bias": 0.0, "bias_after_scale": True})
                g = un
            fixed.append((p, g))
        return self._optimizer.apply_gradients(fixed)

    def apply_optimize(self, loss, startup_program, params_grads):
        # MUST route through the wrapper's apply_gradients: the inner
        # optimizer's apply_optimize would apply the still-SCALED (and
        # possibly bf16) grads raw — a 2**15x update on the split
        # backward()/apply_optimize() API path. Same program_guard as
        # the base Optimizer.apply_optimize, so accumulator/LR init ops
        # land in the CALLER'S startup program.
        from ...framework import default_startup_program, program_guard
        program = loss.block.program
        with program_guard(program,
                           startup_program or default_startup_program()):
            return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads

    @property
    def _loss_scaling_var(self):
        return self._scale_var


def decorate(optimizer, amp_lists=None, init_loss_scaling=2 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, use_fp16=False):
    """reference decorator.py:218. ``use_fp16=True`` activates real
    dynamic loss scaling (see the module docstring); the bf16 default
    keeps the pre-existing inert-scale behavior."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        use_fp16=use_fp16)
