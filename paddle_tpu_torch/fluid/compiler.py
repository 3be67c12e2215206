"""CompiledProgram, BuildStrategy and ExecutionStrategy (counterpart of
paddle_tpu/fluid/compiler.py; reference: python/paddle/fluid/compiler.py:87,
pybind BuildStrategy pybind.cc:1946).

At one device ``with_data_parallel`` is a plain run of the program: the
TPU package's ``CoeffNumDevice`` scale is 1 at one device
(paddle_tpu/parallel/data_parallel.py:18-27), and the executor already
compiles every block (one CUDA graph a step on the card). More than one
place is ROADMAP A8 and raises. The BuildStrategy knobs that tune
collectives and memory are recorded; the ones that select ir passes
(``fuse_elewise_add_act_ops``, ``fuse_bn_act_ops``,
``debug_graphviz_path``) run them over the program before its first run,
the fetch targets protected.
"""
from __future__ import annotations

from typing import Optional

from . import core

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class _ReduceStrategy:
    AllReduce = 0
    Reduce = 1


class _GradientScaleStrategy:
    CoeffNumDevice = 0
    One = 1
    Customized = 2


class BuildStrategy:
    ReduceStrategy = _ReduceStrategy
    GradientScaleStrategy = _GradientScaleStrategy

    def __init__(self):
        self.reduce_strategy = _ReduceStrategy.AllReduce
        self.gradient_scale_strategy = _GradientScaleStrategy.CoeffNumDevice
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_optimizer_ops = False
        self.fuse_all_reduce_ops = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.fuse_relu_depthwise_conv = False
        self.fuse_broadcast_ops = False
        self.sync_batch_norm = False
        self.enable_sequential_execution = False
        self.remove_unnecessary_lock = True
        self.num_trainers = 1
        self.trainer_id = 0
        self.trainers_endpoints = []
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.nccl_comm_num = 1
        self.cache_runtime_context = False
        self.debug_graphviz_path = ""


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.allow_op_delay = False
        self.use_thread_barrier = True
        # a block with a stateful or host-reading op runs as compiled
        # segments around interpreted islands (executor.py
        # ``_SegmentedBlock``); False pins such a block to the op-by-op
        # interpreter, the oracle. A block without one compiles whole
        # either way
        self.allow_mixed_compilation = True


class CompiledProgram:
    """reference compiler.py:87."""

    def __init__(self, program_or_graph,
                 build_strategy: Optional[BuildStrategy] = None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = None
        self._is_data_parallel = False
        self._loss_name = None
        self._share_vars_from = None
        self._places = None
        # the scope of the last run, which a program compiled with
        # share_vars_from=self reads
        self._scope = None
        self._bs_passes_applied = False
        self._bs_protected = set()
        self._bs_pristine = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """One place (or none given: the executor's device) is a plain
        run of the program; more raise NotImplementedError (ROADMAP A8).
        ``share_vars_from``: a CompiledProgram that has run, whose scope
        this one's runs read when the caller passes none (the reference's
        eval idiom: the test clone shares the trained variables)."""
        if places is not None and not isinstance(places, (list, tuple)):
            places = [places]
        if places is not None and len(places) > 1:
            raise NotImplementedError(
                f"CompiledProgram.with_data_parallel over {len(places)} "
                "places: multi-device data parallelism is not ported to "
                "paddle_tpu_torch yet (ROADMAP A8); pass one place")
        if share_vars_from is not None and \
                not isinstance(share_vars_from, CompiledProgram):
            raise TypeError("share_vars_from must be a CompiledProgram")
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._share_vars_from = share_vars_from
        self._places = places
        return self

    def _apply_build_strategy_passes(self, scope, fetch_list=None):
        """Run the ir passes the BuildStrategy selects (reference
        BuildStrategy::Apply, parallel_executor.cc:575), in place on the
        program. A fusion whose intermediate a grad op reads does not
        match, so a program with backward ops is safe. Each run's fetch
        targets are protected; when a later run fetches an intermediate
        the first application fused away, the passes run again on the
        pristine program with the union of the fetch sets (a fusion
        cannot be undone in place). A strategy that selects no pass
        leaves the program as it is: the run is the plain run."""
        bs = self._build_strategy
        names = []
        if bs.fuse_elewise_add_act_ops:
            names.append("fuse_elewise_add_act_pass")
        if bs.fuse_bn_act_ops:
            names.append("fuse_bn_act_pass")
        if bs.debug_graphviz_path:
            names.append("graph_viz_pass")
        if not names:
            return
        fetch_names = set()
        for f in fetch_list or ():
            fetch_names.add(f if isinstance(f, str) else f.name)
        if self._bs_passes_applied:
            if fetch_names <= self._bs_protected:
                return
            self._program = self._bs_pristine.clone()
            fetch_names |= self._bs_protected
        else:
            self._bs_pristine = self._program.clone()
        self._bs_passes_applied = True
        self._bs_protected = set(fetch_names)
        from .ir import PassManager
        pm = PassManager(names, scope=scope)
        for p in pm.passes:
            if p.name == "graph_viz_pass":
                p.set("graph_viz_path", bs.debug_graphviz_path)
        self._program = pm.apply(self._program, protected=fetch_names)

    def _run(self, executor, feed, fetch_list, scope, return_numpy,
             n_steps=1):
        """The executor's run of this program (``Executor.run`` hands a
        CompiledProgram here). ``n_steps`` and windowed feeds pass through
        to ``Executor.run``; ``with_data_parallel`` refuses an explicit
        ``n_steps`` > 1, as the TPU package does (compiler.py:166-170),
        and takes a WindowBatch feed as the executor does."""
        if scope is None and self._share_vars_from is not None:
            scope = self._share_vars_from._scope
            if scope is None:
                raise ValueError(
                    "share_vars_from: the shared CompiledProgram has not "
                    "run yet, so it has no variables to share")
        if scope is None:
            scope = core.global_scope()
        self._scope = scope
        self._apply_build_strategy_passes(scope, fetch_list)
        if self._is_data_parallel and int(n_steps) != 1:
            raise NotImplementedError(
                "n_steps > 1 with CompiledProgram.with_data_parallel is not "
                "supported: pass the program to a plain Executor.run for "
                "multi-step windows")
        es = self._exec_strategy
        pinned = es is not None and not es.allow_mixed_compilation
        prev = core.globals_["FLAGS_executor_segmentation"]
        if pinned:
            core.set_flag("FLAGS_executor_segmentation", False)
        try:
            return executor.run(self._program, feed=feed,
                                fetch_list=fetch_list, scope=scope,
                                return_numpy=return_numpy, n_steps=n_steps)
        finally:
            core.set_flag("FLAGS_executor_segmentation", prev)
