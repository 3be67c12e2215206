"""The inference predictor (counterpart of paddle_tpu/inference/__init__.py;
reference: paddle/fluid/inference/ — AnalysisPredictor
analysis_predictor.cc:288, AnalysisConfig api/analysis_config.cc,
ZeroCopyTensor, PaddlePassBuilder).

A predictor loads a saved inference program (``fluid.io
.save_inference_model``'s directory, or a serialized ProgramDesc and a
tensor stream from memory), runs the pass pipeline of
``fluid.ir.INFERENCE_PASSES`` (or the config's ``pass_builder()``) over
the program and its parameter scope with the fetch targets protected,
and serves each ``run`` as one ``Executor.run`` of the rewritten program:
on the card a CUDA-graph replay of the compiled block, captured once for
each feed shape.

The predictor runs on ``CUDAPlace(device_id)`` (``enable_use_gpu``, the
default) or on the CPU when the config says ``disable_gpu()``; it never
moves from one to the other by itself. ``enable_bf16`` sets
FLAGS_use_bf16_matmul, as the reference does. ``set_optim_cache_dir``
records its directory and does nothing else: the TPU package points XLA's
persistent executable cache there, and a CUDA graph does not outlive its
process (the kernels' build directory persists on its own).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["Config", "AnalysisConfig", "Predictor", "AnalysisPredictor",
           "create_predictor", "create_paddle_predictor", "PredictTensor",
           "PassStrategy", "PredictorPool"]


class AnalysisConfig:
    """reference: api/paddle_analysis_config.h. TensorRT and memory-optim
    switches are recorded only."""

    def __init__(self, model_dir: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._model_dir = model_dir
        self._prog_file = None
        self._params_file = params_file
        self._prog_bytes = None
        self._params_bytes = None
        self._ir_optim = True
        self._use_feed_fetch_ops = False
        self._enable_memory_optim = True
        self._tensorrt = False
        self._use_gpu = True
        self._device_id = 0
        self._bf16 = False
        self._profile = False
        self._pass_builder = None
        self._optim_cache_dir = None

    # -- the model -------------------------------------------------------
    def set_model(self, model_dir, params_file=None):
        self._model_dir = model_dir
        self._params_file = params_file

    def set_model_buffer(self, prog_bytes: bytes, params_bytes: bytes):
        """Serve from memory (analysis_config.cc SetModelBuffer): a
        serialized ProgramDesc and the tensor stream of its persistables
        in sorted name order."""
        self._prog_bytes = bytes(prog_bytes)
        self._params_bytes = bytes(params_bytes)

    def model_from_memory(self) -> bool:
        return self._prog_bytes is not None

    def set_optim_cache_dir(self, cache_dir: str):
        """Recorded only (see the module docstring)."""
        self._optim_cache_dir = cache_dir

    def set_prog_file(self, f):
        self._prog_file = f

    def set_params_file(self, f):
        self._params_file = f

    def model_dir(self):
        return self._model_dir

    # -- switches --------------------------------------------------------
    def switch_ir_optim(self, flag=True):
        self._ir_optim = bool(flag)

    def ir_optim(self) -> bool:
        return self._ir_optim

    def switch_use_feed_fetch_ops(self, flag=True):
        self._use_feed_fetch_ops = bool(flag)

    def enable_memory_optim(self, flag=True):
        self._enable_memory_optim = bool(flag)

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self) -> bool:
        return self._use_gpu

    def gpu_device_id(self) -> int:
        return self._device_id

    def place(self):
        from ..fluid import core
        return core.CUDAPlace(self._device_id) if self._use_gpu \
            else core.CPUPlace()

    def enable_tensorrt_engine(self, **kwargs):
        self._tensorrt = True

    def tensorrt_engine_enabled(self):
        return self._tensorrt

    def switch_specify_input_names(self, flag=True):
        pass

    def specify_input_name(self):
        return True

    def enable_bf16(self):
        """bf16 products (FLAGS_use_bf16_matmul), set when a predictor is
        created."""
        self._bf16 = True

    def bf16_enabled(self):
        return self._bf16

    def enable_profile(self):
        self._profile = True

    def pass_builder(self) -> "PassStrategy":
        """The pass pipeline the predictor will run; edits here change
        it (reference PaddlePassBuilder)."""
        if self._pass_builder is None:
            from ..fluid.ir import INFERENCE_PASSES
            self._pass_builder = PassStrategy(list(INFERENCE_PASSES))
        return self._pass_builder


class PassStrategy:
    """reference: paddle_pass_builder.h PaddlePassBuilder."""

    def __init__(self, passes: List[str]):
        self._passes = list(passes)

    def all_passes(self) -> List[str]:
        return list(self._passes)

    def append_pass(self, name: str):
        from ..fluid.ir import get_pass
        get_pass(name)  # raises for an unknown pass
        self._passes.append(name)

    def insert_pass(self, idx: int, name: str):
        from ..fluid.ir import get_pass
        get_pass(name)
        self._passes.insert(idx, name)

    def delete_pass(self, name: str):
        self._passes = [p for p in self._passes if p != name]


Config = AnalysisConfig


class PredictTensor:
    """A named input or output of a predictor (reference: ZeroCopyTensor,
    inference/api/details/zero_copy_tensor.cc)."""

    def __init__(self, predictor: "AnalysisPredictor", name: str,
                 is_input: bool):
        self._p = predictor
        self.name = name
        self._is_input = is_input

    def copy_from_cpu(self, arr: np.ndarray):
        if not self._is_input:
            raise RuntimeError(f"'{self.name}' is an output tensor")
        self._p._inputs[self.name] = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        if self._is_input:
            raise RuntimeError(f"'{self.name}' is an input tensor")
        return np.asarray(self._p._outputs[self.name])

    def reshape(self, shape):
        pass  # the shape comes with copy_from_cpu

    @property
    def lod(self):
        return self._p._output_lods.get(self.name, [])


class AnalysisPredictor:
    """reference: analysis_predictor.cc:288 Run, :235 PrepareExecutor."""

    def __init__(self, config: AnalysisConfig, _shared=None):
        from .. import fluid
        from ..fluid import core
        self.config = config
        self._exe = fluid.Executor(config.place())
        if _shared is not None:
            # a clone serves from the same scope (reference Clone): no
            # second copy of the weights, its own executor and graphs
            (self._scope, self._program, self._feed_names,
             self._fetch_names) = _shared
        else:
            self._scope = core.Scope()
            if config.model_from_memory():
                self._program, self._feed_names, self._fetch_names = \
                    self._load_from_memory(config)
            else:
                with fluid.scope_guard(self._scope):
                    (self._program, self._feed_names,
                     fetch_targets) = fluid.io.load_inference_model(
                         config.model_dir(), self._exe,
                         model_filename=config._prog_file,
                         params_filename=config._params_file)
                self._fetch_names = [v.name for v in fetch_targets]
            self._optimize(config)
        if config._bf16:
            core.set_flag("FLAGS_use_bf16_matmul", True)
        self._inputs: Dict[str, np.ndarray] = {}
        self._outputs: Dict[str, np.ndarray] = {}
        self._output_lods: Dict[str, list] = {}

    def _load_from_memory(self, config):
        from ..fluid.framework import Program
        from ..fluid.io import _deserialize_lod_tensor_stream
        prog = Program.parse_from_string(config._prog_bytes)
        block = prog.global_block()
        persistables = sorted(
            v.name for v in block.vars.values()
            if v.persistable and v.name not in ("feed", "fetch"))
        tensors = _deserialize_lod_tensor_stream(
            config._params_bytes, len(persistables), self._exe.device)
        for name, t in zip(persistables, tensors):
            self._scope.var(name).set_value(t)
        feeds = [op.output("Out")[0] for op in block.ops
                 if op.type == "feed"]
        fetches = [op.input("X")[0] for op in block.ops
                   if op.type == "fetch"]
        if fetches:
            # a program save_inference_model wrote records its interface
            # in feed and fetch ops (the TPU package's heuristic below
            # finds no output there: the fetch op reads every target)
            return prog, feeds, fetches
        feed_names = [v.name for v in block.vars.values()
                      if getattr(v, "need_check_feed", False)
                      or getattr(v, "is_data", False)]
        written, written_order = set(), []
        for op in block.ops:
            for n in op.output_arg_names:
                if n not in written:
                    written.add(n)
                    written_order.append(n)
        consumed = set()
        for op in block.ops:
            consumed.update(op.input_arg_names)
        # in program order: clients index run()'s results
        fetch_names = [n for n in written_order
                       if n not in consumed
                       and block.vars.get(n) is not None
                       and not block.vars[n].persistable]
        return prog, feed_names, fetch_names

    def _optimize(self, config):
        """reference AnalysisPredictor::OptimizeInferenceProgram
        (analysis_predictor.cc:497): the passes over the program and its
        parameter scope, the fetch targets protected."""
        if not config._ir_optim:
            return
        from ..fluid.ir import INFERENCE_PASSES, PassManager
        names = (config._pass_builder.all_passes()
                 if config._pass_builder is not None else INFERENCE_PASSES)
        pm = PassManager(names, scope=self._scope)
        self._program = pm.apply(self._program, for_test=True,
                                 protected=self._fetch_names)

    # -- interface -------------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def get_input_handle(self, name) -> PredictTensor:
        if name not in self._feed_names:
            raise KeyError(f"unknown input '{name}'")
        return PredictTensor(self, name, True)

    def get_output_handle(self, name) -> PredictTensor:
        if name not in self._fetch_names:
            raise KeyError(f"unknown output '{name}'")
        return PredictTensor(self, name, False)

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """One request: ``inputs`` in ``get_input_names()`` order, or what
        the input handles were given; a ``LoDTensor`` input keeps its LoD
        (a sequence model's words). → the outputs in
        ``get_output_names()`` order, as numpy arrays."""
        from ..fluid.core import LoDTensor
        if inputs is not None:
            for name, arr in zip(self._feed_names, inputs):
                self._inputs[name] = (arr if isinstance(arr, LoDTensor)
                                      else np.asarray(arr))
        missing = [n for n in self._feed_names if n not in self._inputs]
        if missing:
            raise KeyError(f"inputs not set: {missing}")
        fetched = self._exe.run(self._program, feed=dict(self._inputs),
                                fetch_list=self._fetch_names,
                                scope=self._scope, return_numpy=False)
        self._outputs = {}
        self._output_lods = {}
        for n, t in zip(self._fetch_names, fetched):
            self._outputs[n] = t.numpy()
            self._output_lods[n] = t.lod()
        return [self._outputs[n] for n in self._fetch_names]

    def get_input_tensor_shape(self) -> Dict[str, List[int]]:
        block = self._program.global_block()
        return {n: list(getattr(block.vars.get(n), "shape", ()) or ())
                for n in self._feed_names}

    def try_shrink_memory(self):
        """Drop the compiled blocks, their CUDA graphs and the cached
        feeds (reference TryShrinkMemory); the next run builds again."""
        self._exe.close()

    def clone(self, share_weights: bool = True) -> "AnalysisPredictor":
        """reference Clone(): the clone serves from the same scope (no
        second copy of the weights) with its own executor, feeds and
        outputs."""
        if share_weights:
            return AnalysisPredictor(
                self.config, _shared=(self._scope, self._program,
                                      list(self._feed_names),
                                      list(self._fetch_names)))
        return AnalysisPredictor(self.config)


Predictor = AnalysisPredictor


class PredictorPool:
    """reference: api/paddle_inference_api.h PredictorPool — one loaded
    predictor cloned for each serving slot, the weights shared."""

    def __init__(self, config: AnalysisConfig, size: int = 1):
        first = AnalysisPredictor(config)
        self._preds = [first] + [first.clone() for _ in range(size - 1)]

    def retrieve(self, idx: int) -> AnalysisPredictor:
        return self._preds[idx]

    def size(self) -> int:
        return len(self._preds)


def create_predictor(config: AnalysisConfig) -> AnalysisPredictor:
    return AnalysisPredictor(config)


create_paddle_predictor = create_predictor
