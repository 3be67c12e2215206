"""fluid — the Fluid v1.7 front end of paddle_tpu_torch (counterpart of
paddle_tpu/fluid; so far: Program building, the layers of the BERT-base
pretraining step, control flow (While, cond, Switch, the tensor arrays)
and the LR schedules, append_backward, SGD, Momentum, Adam and
RecomputeOptimizer, contrib.mixed_precision, the Executor, the program
proto with clone and _prune, io (save and load, and the checkpoint
plane), the pass system of ir, the verifier of analysis, and the reader's
DataLoader, PyReader and DataFeeder)."""
from . import core
from .core import (CPUPlace, CUDAPlace, TPUPlace, LoDTensor, Scope,
                   global_scope)
from . import framework
from .framework import (Program, Variable, Parameter, program_guard,
                        default_main_program, default_startup_program,
                        cpu_places, cuda_places)
from . import unique_name
from . import initializer
from . import regularizer
from . import clip
from .param_attr import ParamAttr
from . import layers
from .layers.io import data
from . import backward
from .backward import append_backward
from . import optimizer
from . import executor
from .executor import Executor, scope_guard
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

__all__ = [
    "core", "CPUPlace", "CUDAPlace", "TPUPlace", "LoDTensor", "Scope",
    "global_scope", "scope_guard", "Program", "Variable", "Parameter",
    "program_guard", "default_main_program", "default_startup_program",
    "cpu_places", "cuda_places", "unique_name",
    "initializer", "regularizer", "clip", "ParamAttr", "layers", "data",
    "backward", "append_backward", "optimizer", "Executor", "param_bridge",
    "contrib", "analysis", "ir", "io", "save_vars", "save_params",
    "save_persistables", "load_vars", "load_params", "load_persistables",
    "save_inference_model", "load_inference_model", "save", "load",
    "save_checkpoint", "load_checkpoint", "latest_checkpoint",
    "validate_checkpoint", "DataFeeder", "reader", "DataLoader", "PyReader",
]
