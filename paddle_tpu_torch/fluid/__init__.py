"""fluid — the Fluid v1.7 front end of paddle_tpu_torch (counterpart of
paddle_tpu/fluid; so far: Program building, the layers of the BERT-base
pretraining step, control flow (While, cond, Switch, the tensor arrays)
and the LR schedules, append_backward and gradients, every optimizer but
PipelineOptimizer, the gradient clips, L1Decay and L2Decay,
contrib.mixed_precision, the Executor, CompiledProgram with the
BuildStrategy's fuse passes (one device), the program proto with clone
and _prune, io (save and load, and the checkpoint plane), the pass system
of ir, the verifier of analysis, the reader's DataLoader (thread or
process prefetch), PyReader and DataFeeder, nets, metrics and average,
the debugger's program printer, install_check, and the Dataset API over
the native data feed).

The names of paddle_tpu.fluid that wait on other items: ``dygraph``
(ROADMAP A7), ``tpu_places``, ``memory_optimize`` and ``release_memory``
(A8), ``profiler``, ``telemetry``, ``transpiler``, the
``DistributeTranspiler*`` names and ``Communicator`` (A9)."""
from . import core
from .core import (CPUPlace, CUDAPlace, TPUPlace, CUDAPinnedPlace,
                   LoDTensor, LoDTensorArray, Scope, global_scope,
                   is_compiled_with_cuda)
from . import framework
from .framework import (Program, Variable, Parameter, program_guard,
                        default_main_program, default_startup_program,
                        cpu_places, cuda_places, name_scope, device_guard,
                        in_dygraph_mode)
from . import unique_name
from . import initializer
from . import regularizer
from . import clip
from .clip import (GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue)
from .param_attr import ParamAttr, WeightNormParamAttr
from . import layers
from .layers.io import data
from . import backward
from .backward import append_backward, gradients
from . import optimizer
from . import executor
from .executor import Executor, FetchHandler, scope_guard
from . import compiler
from .compiler import CompiledProgram, BuildStrategy, ExecutionStrategy
from . import param_bridge
from . import contrib
from . import analysis
from . import ir
from . import io
from .io import (save_vars, save_params, save_persistables, load_vars,
                 load_params, load_persistables, save_inference_model,
                 load_inference_model, save, load, save_checkpoint,
                 load_checkpoint, latest_checkpoint, validate_checkpoint)
from .data_feeder import DataFeeder
from . import reader
from .reader import DataLoader, PyReader
from . import nets
from . import metrics
from . import average
from . import debugger
from . import install_check
from . import dataset
from .dataset import DatasetFactory, InMemoryDataset

Tensor = LoDTensor

# the version require_version checks against: the Fluid API this front
# end implements (the TPU package's version.py full_version is 1.7.0+tpu)
FLUID_VERSION = "1.7.0"


def require_version(min_version, max_version=None):
    """Raise unless the Fluid version this package implements lies in
    [min_version, max_version] (reference: fluid/framework.py
    require_version; the TPU package's fluid/__init__.py:76)."""
    def parse(s):
        parts = str(s).replace("+", ".").split(".")
        nums = [int(p) if p.isdigit() else 0 for p in parts[:3]]
        return tuple(nums + [0] * (3 - len(nums)))
    if not isinstance(min_version, str) or (
            max_version is not None and not isinstance(max_version, str)):
        raise TypeError("version arguments must be strings like '1.7.0'")
    cur = parse(FLUID_VERSION)
    if cur < parse(min_version):
        raise Exception(
            f"installed version {FLUID_VERSION} < required {min_version}")
    if max_version is not None and cur > parse(max_version):
        raise Exception(
            f"installed version {FLUID_VERSION} > allowed {max_version}")


def load_op_library(lib_filename):
    """The reference loads a custom-op .so into its registry. A custom op
    of this package is a torch kernel registered with
    ``paddle_tpu_torch.ops.registry.register_op``."""
    raise NotImplementedError(
        "C++ custom-op libraries do not load into paddle_tpu_torch; "
        "register a torch kernel with "
        "paddle_tpu_torch.ops.registry.register_op instead")


def one_hot(input, depth, allow_out_of_range=False):
    """v1.7's fluid.one_hot: the ``one_hot_v2`` op, which needs no
    trailing dim of 1 on ``input`` (the TPU package's
    fluid/__init__.py:108)."""
    from .layer_helper import LayerHelper
    helper = LayerHelper("one_hot_v2")
    out = helper.create_variable_for_type_inference(
        core.VarDesc.VarType.FP32)
    out.shape = tuple(input.shape) + (depth,)
    helper.append_op(type="one_hot_v2", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"depth": depth,
                            "allow_out_of_range": allow_out_of_range})
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """v1.7's fluid.embedding: the ``lookup_table_v2`` op, ids without a
    trailing dim of 1 (the TPU package's fluid/__init__.py:122)."""
    from .layer_helper import LayerHelper
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    out.shape = tuple(input.shape) + (size[1],)
    helper.append_op(type="lookup_table_v2",
                     inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"padding_idx": pad, "is_sparse": is_sparse,
                            "is_distributed": is_distributed})
    return out


def set_flags(d):
    """Set FLAGS_ values by name (an unknown flag raises KeyError)."""
    core.set_flags(d)


def get_flags(names):
    """{name: value} for a flag name or a list of them."""
    if isinstance(names, str):
        names = [names]
    return {n: core.get_flag(n) for n in names}


__all__ = [
    "core", "framework", "layers", "optimizer", "backward", "initializer",
    "regularizer", "clip", "io", "metrics", "contrib", "compiler",
    "debugger", "Program", "Variable", "Parameter", "Executor",
    "CompiledProgram", "BuildStrategy", "ExecutionStrategy", "CPUPlace",
    "TPUPlace", "CUDAPlace", "CUDAPinnedPlace", "LoDTensor",
    "LoDTensorArray", "Scope", "global_scope", "scope_guard", "ParamAttr",
    "WeightNormParamAttr", "DataFeeder", "DataLoader", "PyReader", "data",
    "program_guard", "default_main_program", "default_startup_program",
    "append_backward", "gradients", "save_inference_model",
    "load_inference_model", "save", "load", "save_vars", "save_params",
    "save_persistables", "load_vars", "load_params", "load_persistables",
    "save_checkpoint", "load_checkpoint", "latest_checkpoint",
    "validate_checkpoint", "in_dygraph_mode", "cpu_places", "cuda_places",
    "name_scope", "device_guard", "dataset", "DatasetFactory",
    "InMemoryDataset", "require_version", "load_op_library", "one_hot",
    "embedding", "set_flags", "get_flags", "FetchHandler", "nets",
    "average", "install_check", "unique_name", "GradientClipByGlobalNorm",
    "GradientClipByNorm", "GradientClipByValue", "param_bridge",
    "analysis", "ir", "reader",
]
