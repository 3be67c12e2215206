"""LayerHelper — shared machinery for layer functions (counterpart of
paddle_tpu/fluid/layer_helper.py; reference: layer_helper.py +
layer_helper_base.py): parameter creation wired to startup-program init
ops, temp variable creation, bias and activation append. Names come from
the same unique_name counters as in the TPU package, so both packages
name the same program's parameters alike."""
from __future__ import annotations

from . import unique_name
from .core import VarDesc
from .framework import (Variable, default_main_program,
                        default_startup_program)
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    # ------------------------------------------------------------------
    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            return [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        pa = self.param_attr
        if isinstance(pa, ParamAttr):
            pa = [pa]
        if len(pa) == 1 and length != 1:
            pa = pa + [copy_attr(pa[0]) for _ in range(length - 1)]
        return pa

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for inp in inputs:
            if dtype is None:
                dtype = inp.dtype
        return dtype

    # ------------------------------------------------------------------
    def create_parameter(self, attr, shape, dtype=None, is_bias=False,
                         default_initializer=None, stop_gradient=False,
                         type=VarDesc.VarType.LOD_TENSOR):
        if attr is False:
            return None
        attr = attr if isinstance(attr, ParamAttr) \
            else ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if default_initializer is None:
            if is_bias:
                attr._set_default_bias_initializer()
            else:
                attr._set_default_param_initializer()
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(
                ".".join([self.name, "w" if not is_bias else "b"]))
        if dtype is None:
            dtype = self.input_dtype() or VarDesc.VarType.FP32

        startup_block = self.startup_program.global_block()
        main_block = self.main_program.global_block()
        # parameter in both programs (reference layer_helper_base.py)
        existing = main_block.vars.get(attr.name)
        if existing is not None:
            return existing
        sp = startup_block.create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs())
        attr.initializer(sp, startup_block)
        param = main_block.create_parameter(
            shape=shape, dtype=dtype, **attr._to_kwargs())
        param.stop_gradient = stop_gradient
        return param

    def create_variable_for_type_inference(self, dtype,
                                           stop_gradient=False) -> Variable:
        return self.main_program.current_block().create_var(
            name=unique_name.generate_with_ignorable_key(
                ".".join([self.name, "tmp"])),
            dtype=dtype, persistable=False, stop_gradient=stop_gradient)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        """A new var of the main program's global block, named after the
        layer."""
        return self.main_program.global_block().create_var(
            *args, persistable=persistable,
            name=unique_name.generate_with_ignorable_key(
                ".".join([self.name, "tmp"])), **kwargs)

    def create_or_get_global_variable(self, name, *args, **kwargs):
        """The main program's global var ``name``, created (persistable by
        default) if it is not there yet."""
        block = self.main_program.global_block()
        if name in block.vars:
            return block.vars[name]
        kwargs.setdefault("persistable", True)
        return block.create_var(*args, name=name, **kwargs)

    def set_variable_initializer(self, var, initializer):
        """``initializer``'s op for ``var`` in the startup program."""
        startup = self.startup_program.global_block()
        sv = startup.create_var(name=var.name, dtype=var.dtype,
                                shape=var.shape, persistable=True)
        initializer(sv, startup)
        return var

    # ------------------------------------------------------------------
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(attr=bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        tmp.shape = input_var.shape
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        else:
            act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        tmp.shape = input_var.shape
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp


def copy_attr(attr: ParamAttr) -> ParamAttr:
    # the NAME is kept: a named attr shared across a multi-input fc means
    # ONE shared parameter
    return ParamAttr(name=attr.name, initializer=attr.initializer,
                     learning_rate=attr.learning_rate,
                     regularizer=attr.regularizer, trainable=attr.trainable,
                     gradient_clip=attr.gradient_clip)
