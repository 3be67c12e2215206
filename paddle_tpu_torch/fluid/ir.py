"""Graph IR, the pass system and program-level helpers of the executor
(counterpart of paddle_tpu/fluid/ir.py; reference:
paddle/fluid/framework/ir/).

The pass system (the TPU package's ir.py:44-346): ``Graph`` is a live view
of one block (the Operator and Variable objects are the nodes, so a Graph
is its Program again for free), ``OpPattern`` a small backtracking matcher
over op chains with symbolic var links, ``Pass`` with its registry
(``register_pass``, ``get_pass``, ``all_registered_passes``) and
``PassManager`` the ordered pipeline. A pass that folds or packs weights
reads and writes them through ``param_scope`` as numpy arrays on the host
(``_scope_get``, ``_scope_set``), the TPU package's arithmetic; a new
array goes to the device of the weight it was made from, so a rewritten
program's state lies on the card before its first capture.

Every pass of ``INFERENCE_PASSES`` (the TPU package's :1406, the
predictor's pipeline) is here, in its order, with
``apply_inference_passes``: is_test, simplify_with_basic_ops,
delete_quant_dequant_op, multihead_matmul_fuse (v2 and the v1 name), the
three conv folds, embedding_eltwise_layernorm, fc_gru, fc_lstm, fc,
fc_elementwise_layernorm and identity_scale_op_clean. fc_gru and fc_lstm
fold a bias-free projection (a ``mul`` read by the recurrence alone) into
``fusion_gru`` / ``fusion_lstm`` (ops/fused_ops.py), whose ``XX`` output
is the mul's; an fc with a bias is left unfused. Every other pass of the
TPU package is registered too: the two BuildStrategy fusions
(fuse_elewise_add_act, fuse_bn_act; the ``CompiledProgram`` of
compiler.py runs them),
skip_layernorm, the three seq* fusions (their ops need LoD), graph_viz,
graph_to_program, the absorbed passes (the identity here: the compiled
step does their work) and ``block_segmentation_pass``.

Also: ``fused_health``, the numeric fault plane's one health scalar a
step, and the segment analysis of a block (ir.py:1308-1390):
``op_island_reason``, ``BlockSegment``, ``analyze_block_segments`` and
``segment_summary``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.registry import resolve_base_info

__all__ = ["Graph", "OpPattern", "Pass", "PassManager",
           "register_pass", "get_pass", "all_registered_passes",
           "INFERENCE_PASSES", "apply_inference_passes",
           "fused_health", "op_island_reason", "BlockSegment",
           "analyze_block_segments", "segment_summary"]

# control flow (the TPU package's _SEG_CONTROL, ir.py:1264). A block
# that compiles whole lowers its conditionals into its step; in a block
# that also holds an island they run as islands, in the interpreter, and
# a ``while`` whose body compiles becomes a loop segment of the executor
CONTROL_FLOW = frozenset({"while", "conditional_block",
                          "conditional_block_infer", "select_input",
                          "select_output"})


def fused_health(values, device=None) -> torch.Tensor:
    """ONE boolean scalar on the device: True iff every element of every
    floating-point tensor in ``values`` is finite (the TPU package's
    ir.py:1272). Each tensor contributes ``isfinite().all()`` and the
    flags are ANDed on the device: no host sync. Non-float tensors (int
    counters, bool masks) and None are skipped; an empty list is healthy
    (a True made on ``device``)."""
    flags = [torch.isfinite(v).all() for v in values
             if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool, device=device)
    return flags[0] if len(flags) == 1 else torch.stack(flags).all()


def op_reads_host_values(op) -> bool:
    """An op whose kernel reads the VALUES of a connected ``host_inputs``
    slot (registry; a function of the op gives the slots that op reads)
    cannot be replayed by a CUDA graph."""
    info = resolve_base_info(op.type)
    if info is None:
        return False
    slots = info.host_inputs
    if callable(slots):
        slots = slots(op)
    return any(op.inputs.get(s) for s in slots)


def op_island_reason(op) -> Optional[str]:
    """None when ``op`` can run in a compiled segment (a CUDA graph on the
    card); otherwise why not: 'unregistered' (no kernel: the interpreter
    raises with context), 'stateful' (side effects beyond its outputs),
    'host_inputs' (a connected slot whose values the kernel reads on the
    host) or 'control_flow'."""
    info = resolve_base_info(op.type)
    if info is None:
        return "unregistered"
    if info.stateful:
        return "stateful"
    if op_reads_host_values(op):
        return "host_inputs"
    if op.type in CONTROL_FLOW or op.attrs.get("sub_block") is not None:
        return "control_flow"
    return None


class BlockSegment:
    """One maximal run of a block's op list: ``kind`` is 'compiled' (pure
    ops, run as one planned step: one CUDA graph on the card) or 'island'
    (run op by op by the interpreter). ``start`` is the index of its first
    op in the block: the executor keys each random op by its index in the
    block, so a segmented run draws what the whole compiled step draws.
    The executor fills the plan's slots when it builds a step."""

    __slots__ = ("kind", "start", "ops", "island_reasons",
                 # filled by the executor's segment plan
                 "in_names", "out_names", "state_writes", "op_io",
                 "guard_names", "loop", "plans")

    def __init__(self, kind: str, start: int):
        self.kind = kind
        self.start = start
        self.ops: List[Any] = []
        self.island_reasons: List[Optional[str]] = []

    @property
    def stop(self) -> int:
        return self.start + len(self.ops)

    def __repr__(self):
        kinds = ",".join(o.type for o in self.ops[:4])
        more = "..." if len(self.ops) > 4 else ""
        return (f"<BlockSegment {self.kind} [{self.start}:{self.stop}) "
                f"{kinds}{more}>")


def analyze_block_segments(ops) -> List[BlockSegment]:
    """Partition ``ops`` into maximal compiled and island segments.
    Adjacent ops of the same kind merge, so the kinds alternate; the
    segments cover every op once, in order."""
    segments: List[BlockSegment] = []
    for idx, op in enumerate(ops):
        reason = op_island_reason(op)
        kind = "island" if reason is not None else "compiled"
        if not segments or segments[-1].kind != kind:
            segments.append(BlockSegment(kind, idx))
        segments[-1].ops.append(op)
        if kind == "island":
            segments[-1].island_reasons.append(reason)
    return segments


def segment_summary(segments) -> List[Dict[str, Any]]:
    """A JSON-able view of a partition."""
    return [{"kind": s.kind, "start": s.start, "stop": s.stop,
             "n_ops": len(s.ops), "op_types": [o.type for o in s.ops],
             "island_reasons": list(s.island_reasons),
             "guard_names": list(getattr(s, "guard_names", ()) or ())}
            for s in segments]


# --------------------------------------------------------------------------
# Graph: a live view over one Program block (the TPU package's ir.py:44)
# --------------------------------------------------------------------------
class Graph:
    """Op/var graph over ``program``'s block ``idx``: the block stays the
    source of truth, so a Graph is always its Program again."""

    def __init__(self, program, idx: int = 0, for_test: bool = False):
        self.program = program
        self.block = program.block(idx)
        self.for_test = for_test
        self._attrs: Dict[str, Any] = {}

    def all_op_nodes(self):
        return list(self.block.ops)

    def op_index(self, op) -> int:
        return self.block.ops.index(op)

    def var_producer(self, name: str, before: Optional[int] = None):
        """The last op writing ``name`` (before position ``before``)."""
        ops = self.block.ops if before is None else self.block.ops[:before]
        for op in reversed(ops):
            if name in op.output_arg_names:
                return op
        return None

    def var_consumers(self, name: str) -> List:
        return [op for op in self.block.ops if name in op.input_arg_names]

    def is_internal(self, name: str) -> bool:
        """True for a pure intermediate: produced and consumed here, not
        persistable and not protected. An output no op reads may be a
        fetch target (the fetch list is not part of the program), so it
        is never internal."""
        v = self.block.vars.get(name)
        if v is None or getattr(v, "persistable", False):
            return False
        if name in self.get("protected_vars", ()):
            return False
        if self.var_producer(name) is None:
            return False
        return len(self.var_consumers(name)) > 0

    def insert_op_at(self, index: int, type: str, inputs, outputs, attrs):
        from .framework import Operator
        op = Operator(self.block, type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        self.block.ops.insert(index, op)
        self.program._version += 1
        return op

    def remove_ops(self, ops: Sequence) -> None:
        dead = set(id(o) for o in ops)
        self.block.ops = [o for o in self.block.ops if id(o) not in dead]
        self.program._version += 1

    def fuse(self, matched_ops: Sequence, type: str, inputs, outputs,
             attrs) -> Any:
        """Replace ``matched_ops`` by one op of ``type`` at the position of
        the last of them: every input is defined by then, and the fused
        output's consumers come later."""
        pos = max(self.op_index(o) for o in matched_ops)
        new_op = self.insert_op_at(pos + 1, type, inputs, outputs, attrs)
        self.remove_ops(matched_ops)
        return new_op

    def drop_orphan_vars(self) -> int:
        """Remove the non-persistable, non-data vars no op reads or
        writes."""
        used = set()
        for op in self.block.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
        dead = [n for n, v in self.block.vars.items()
                if n not in used and not getattr(v, "persistable", False)
                and not getattr(v, "is_data", False)]
        for n in dead:
            del self.block.vars[n]
        return len(dead)

    def set(self, key: str, val: Any):
        self._attrs[key] = val

    def get(self, key: str, default: Any = None):
        return self._attrs.get(key, default)

    def to_program(self):
        return self.program


# --------------------------------------------------------------------------
# pattern matching (the TPU package's ir.py:151)
# --------------------------------------------------------------------------
class OpPattern:
    """A DAG of op specs ``(op_type, input_links, output_links)`` whose
    links map a slot to "$sym" (or a list of them); specs sharing a symbol
    connect through that var. ``match`` returns, in program order, one
    dict ``{"$sym": var name, "#i": op, "#ops": [ops]}`` for each
    non-overlapping match. A symbol that is one spec's output and
    another's input must be an internal var read by the match alone,
    unless listed in ``shared``."""

    def __init__(self, specs, shared: Sequence[str] = ()):
        self.specs = specs
        self.shared = set(shared)
        produced, consumed = set(), set()
        for _, ins, outs in specs:
            consumed.update(self._syms(ins))
            produced.update(self._syms(outs))
        self.intermediate = (produced & consumed) - self.shared

    @staticmethod
    def _syms(links):
        for v in (links or {}).values():
            if isinstance(v, (list, tuple)):
                yield from v
            else:
                yield v

    def _bind(self, op, links, env) -> Optional[Dict[str, str]]:
        new = {}
        for slots, side in ((op.inputs, links[0]), (op.outputs, links[1])):
            for slot, sym in (side or {}).items():
                names = slots.get(slot, [])
                syms = sym if isinstance(sym, (list, tuple)) else [sym]
                if len(names) != len(syms):
                    return None
                for s, n in zip(syms, names):
                    bound = env.get(s, new.get(s))
                    if bound is None:
                        new[s] = n
                    elif bound != n:
                        return None
        return new

    def match(self, graph: Graph):
        ops = graph.all_op_nodes()
        taken: set = set()
        results = []
        first_type = self.specs[0][0]
        for anchor in ops:
            if anchor.type != first_type or id(anchor) in taken:
                continue
            env: Dict[str, Any] = {}
            chosen: List = []

            def try_specs(i) -> bool:
                if i == len(self.specs):
                    return True
                op_type, ins, outs = self.specs[i]
                cands = [anchor] if i == 0 else [
                    o for o in ops if o.type == op_type
                    and id(o) not in taken and o not in chosen]
                for cand in cands:
                    new = self._bind(cand, (ins, outs), env)
                    if new is None:
                        continue
                    env.update(new)
                    chosen.append(cand)
                    if try_specs(i + 1):
                        return True
                    chosen.pop()
                    for k in new:
                        env.pop(k, None)
                return False

            if not try_specs(0):
                continue
            ok = True
            for sym in self.intermediate:
                name = env[sym]
                cons = graph.var_consumers(name)
                if not graph.is_internal(name) or len(cons) != 1 \
                        or cons[0] not in chosen:
                    ok = False
                    break
            if not ok:
                continue
            for o in chosen:
                taken.add(id(o))
            m = dict(env)
            for i, o in enumerate(chosen):
                m[f"#{i}"] = o
            m["#ops"] = list(chosen)
            results.append(m)
        return results


# --------------------------------------------------------------------------
# Pass, its registry and the pipeline (the TPU package's ir.py:261-346)
# --------------------------------------------------------------------------
class Pass:
    """apply(graph) -> graph, with Set/Get attrs (``param_scope``, ...);
    orphaned vars are dropped after each pass."""

    name = "pass"

    def __init__(self):
        self._attrs: Dict[str, Any] = {}

    def set(self, key: str, val: Any) -> "Pass":
        self._attrs[key] = val
        return self

    def get(self, key: str, default=None):
        return self._attrs.get(key, default)

    def apply(self, graph: Graph) -> Graph:
        graph = self.apply_impl(graph)
        graph.drop_orphan_vars()
        return graph

    def apply_impl(self, graph: Graph) -> Graph:
        return graph


_PASS_REGISTRY: Dict[str, Callable[[], Pass]] = {}


def register_pass(name: str):
    def deco(cls):
        cls.name = name
        _PASS_REGISTRY[name] = cls
        return cls
    return deco


def get_pass(name: str) -> Pass:
    try:
        return _PASS_REGISTRY[name]()
    except KeyError:
        raise ValueError(f"ir pass '{name}' is not registered") from None


def all_registered_passes() -> List[str]:
    return sorted(_PASS_REGISTRY)


class PassManager:
    """An ordered pass pipeline over one block (reference
    inference/analysis/ir_pass_manager.cc)."""

    def __init__(self, names: Sequence[str], scope=None):
        self.passes = [get_pass(n) for n in names]
        self.scope = scope

    def apply(self, program, idx: int = 0, for_test: bool = False,
              protected: Sequence[str] = ()):
        """``protected``: the names the caller will fetch, which no pass
        may fuse away (the fetch list is not part of the program)."""
        graph = Graph(program, idx, for_test=for_test)
        graph.set("protected_vars", set(protected))
        for p in self.passes:
            if self.scope is not None:
                p.set("param_scope", self.scope)
            graph = p.apply(graph)
        return graph.to_program()


def _scope_get(scope, name: str) -> Optional[np.ndarray]:
    """A weight of the scope as a numpy array on the host."""
    var = scope.find_var(name)
    if var is None or not var.is_initialized():
        return None
    return var.get_tensor().numpy()


def _scope_set(scope, name: str, arr: np.ndarray,
               like: Optional[str] = None) -> None:
    """``arr`` into the scope as ``name``, on the device of the tensor
    ``name`` held, or else of ``like``'s (the host if neither is
    there)."""
    device = torch.device("cpu")
    for n in (name, like):
        var = scope.find_var(n) if n is not None else None
        if var is not None and var.is_initialized():
            device = var.get_tensor().array.device
            break
    from .core import LoDTensor
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    scope.var(name).set_value(LoDTensor(t))


# --------------------------------------------------------------------------
# the training-side fusions BuildStrategy selects (the TPU package's
# ir.py:679-746)
# --------------------------------------------------------------------------
@register_pass("fuse_elewise_add_act_pass")
class FuseElewiseAddActPass(Pass):
    """elementwise_add + {relu, tanh, sigmoid, scale} ->
    fused_elemwise_activation (ir/fuse_elewise_add_act_pass.cc). Where a
    grad op reads the add's output the intermediate is not internal to
    the match, so nothing fuses: a program with backward ops keeps its
    pairs, and its grads."""

    _ACTS = ("relu", "tanh", "sigmoid", "scale")

    def apply_impl(self, graph):
        for act in self._ACTS:
            pat = OpPattern([
                ("elementwise_add", {"X": "$x", "Y": "$y"}, {"Out": "$mid"}),
                (act, {"X": "$mid"}, {"Out": "$out"}),
            ])
            for m in pat.match(graph):
                add_op, act_op = m["#0"], m["#1"]
                axis = add_op.attr("axis")
                if int(-1 if axis is None else axis) != -1:
                    continue
                attrs = {"functor_list": [act, "elementwise_add"],
                         "axis": -1, "save_intermediate_out": False}
                if act == "scale":
                    if act_op.input("ScaleTensor"):
                        continue  # a run-time scale is not an attr
                    b = act_op.attr("bias")
                    if float(0.0 if b is None else b) != 0.0:
                        continue
                    sc = act_op.attr("scale")
                    attrs["scale"] = float(1.0 if sc is None else sc)
                inter = graph.block.create_var(
                    name=m["$out"] + ".fused_intermediate")
                graph.fuse(m["#ops"], "fused_elemwise_activation",
                           {"X": [m["$x"]], "Y": [m["$y"]]},
                           {"Out": [m["$out"]],
                            "IntermediateOut": [inter.name]}, attrs)
        return graph


@register_pass("fuse_bn_act_pass")
class FuseBnActPass(Pass):
    """batch_norm + relu -> fused_batch_norm_act (ir/fuse_bn_act_pass.cc).
    In a training program the grad ops read batch_norm's Y, so it fuses
    only in a program without them (the ``clone(for_test=True)``)."""

    def apply_impl(self, graph):
        pat = OpPattern([
            ("batch_norm",
             {"X": "$x", "Scale": "$scale", "Bias": "$bias",
              "Mean": "$mean", "Variance": "$var"},
             {"Y": "$y"}),
            ("relu", {"X": "$y"}, {"Out": "$out"}),
        ])
        for m in pat.match(graph):
            bn = m["#0"]
            outs = {"Y": [m["$out"]]}
            for slot in ("MeanOut", "VarianceOut", "SavedMean",
                         "SavedVariance", "ReserveSpace"):
                names = bn.output(slot)
                if names:
                    outs[slot] = names
            attrs = {k: bn.attr(k) for k in
                     ("momentum", "epsilon", "data_layout", "is_test",
                      "use_global_stats") if bn.attr(k) is not None}
            attrs["act_type"] = "relu"
            graph.fuse(m["#ops"], "fused_batch_norm_act",
                       {"X": [m["$x"]], "Scale": [m["$scale"]],
                        "Bias": [m["$bias"]], "Mean": [m["$mean"]],
                        "Variance": [m["$var"]]}, outs, attrs)
        return graph


# --------------------------------------------------------------------------
# skip_layernorm and the LoD fusions (the TPU package's ir.py:532-677,
# :1036), outside INFERENCE_PASSES: a pipeline names them
# --------------------------------------------------------------------------
@register_pass("skip_layernorm_fuse_pass")
class SkipLayerNormFusePass(Pass):
    """elementwise_add + layer_norm -> skip_layernorm (residual-add fused
    into the norm; ir/skip_layernorm_fuse_pass.cc)."""

    def apply_impl(self, graph):
        pat = OpPattern([
            ("elementwise_add", {"X": "$x", "Y": "$y"}, {"Out": "$add"}),
            ("layer_norm", {"X": "$add", "Scale": "$s", "Bias": "$b"},
             {"Y": "$out"}),
        ])
        for m in pat.match(graph):
            ln = m["#1"]
            add_var = graph.block._find_var_recursive(m["$add"])
            shape = getattr(add_var, "shape", None) if add_var else None
            if not shape or int(ln.attr("begin_norm_axis") or 1) != \
                    len(shape) - 1:
                continue  # skip_layernorm normalises the last axis only;
                # no shape: legality unproven, no fusion
            graph.fuse(m["#ops"], "skip_layernorm",
                       {"X": [m["$x"]], "Y": [m["$y"]], "Scale": [m["$s"]],
                        "Bias": [m["$b"]]},
                       {"Out": [m["$out"]]},
                       {"epsilon": float(ln.attr("epsilon") or 1e-5),
                        "begin_norm_axis":
                        int(ln.attr("begin_norm_axis") or 1)})
        return graph


@register_pass("seq_concat_fc_fuse_pass")
class SeqConcatFcFusePass(Pass):
    """sequence_expand(x_i, ref) fan-in + concat(axis=1) + fc ->
    fusion_seqexpand_concat_fc (ir/seq_concat_fc_fuse_pass.cc) — the
    reference's fused attention-input block: per-sequence rows broadcast
    to each timestep of the reference sequence, concatenated, projected
    through one fc."""

    _ACTS = {"relu", "tanh", "sigmoid"}

    def apply_impl(self, graph):
        for concat in [op for op in graph.block.ops
                       if op.type == "concat"]:
            xs = list(concat.input("X"))
            if len(xs) < 2 or concat.input("AxisTensor"):
                continue
            if int(concat.attr("axis") or 0) != 1:
                continue
            ref = xs[0]  # the LoD sequence every expand broadcasts to
            expands, raw = [], []
            ok = True
            for n in xs[1:]:
                prods = [op for op in graph.block.ops
                         if n in op.output("Out")
                         and op.type == "sequence_expand"]
                if len(prods) != 1 or not graph.is_internal(n) \
                        or len(graph.var_consumers(n)) != 1 \
                        or prods[0].input("Y") != [ref]:
                    ok = False
                    break
                expands.append(prods[0])
                raw.append(prods[0].input("X")[0])
            cat_out = concat.output("Out")[0]
            consumers = graph.var_consumers(cat_out)
            if not ok or not expands or len(consumers) != 1 \
                    or consumers[0].type != "mul" \
                    or not graph.is_internal(cat_out):
                continue
            mul = consumers[0]
            if int(mul.attr("x_num_col_dims") or 1) != 1:
                continue
            matched = expands + [concat, mul]
            out_name = mul.output("Out")[0]
            bias = None
            act = "identity"
            nxt = graph.var_consumers(out_name)
            if len(nxt) == 1 and nxt[0].type == "elementwise_add" \
                    and graph.is_internal(out_name):
                bv = graph.block._find_var_recursive(nxt[0].input("Y")[0])
                if bv is not None and getattr(bv, "persistable", False):
                    bias = nxt[0].input("Y")[0]
                    matched.append(nxt[0])
                    out_name = nxt[0].output("Out")[0]
                    after = graph.var_consumers(out_name)
                    if len(after) == 1 and after[0].type in self._ACTS \
                            and graph.is_internal(out_name):
                        act = after[0].type
                        matched.append(after[0])
                        out_name = after[0].output("Out")[0]
            inputs = {"X": [ref] + raw,
                      "FCWeight": [mul.input("Y")[0]]}
            if bias is not None:
                inputs["FCBias"] = [bias]
            graph.fuse(matched, "fusion_seqexpand_concat_fc",
                       inputs, {"Out": [out_name]},
                       {"fc_activation": act})
        return graph


@register_pass("seqconv_eltadd_relu_fuse_pass")
class SeqconvEltaddReluFusePass(Pass):
    """sequence_conv + elementwise_add(bias) + relu ->
    fusion_seqconv_eltadd_relu (ir/seqconv_eltadd_relu_fuse_pass.cc) —
    the reference's fused CTR text-conv inference block."""

    def apply_impl(self, graph):
        pat = OpPattern([
            ("sequence_conv", {"X": "$x", "Filter": "$f"}, {"Out": "$c"}),
            ("elementwise_add", {"X": "$c", "Y": "$b"}, {"Out": "$cb"}),
            ("relu", {"X": "$cb"}, {"Out": "$out"}),
        ])
        for m in pat.match(graph):
            conv = m["#0"]
            bias = graph.block._find_var_recursive(m["$b"])
            if bias is None or not getattr(bias, "persistable", False):
                continue
            graph.fuse(list(m["#ops"]), "fusion_seqconv_eltadd_relu",
                       {"X": [m["$x"]], "Filter": [m["$f"]],
                        "Bias": [m["$b"]]},
                       {"Out": [m["$out"]]},
                       {k: conv.attr(k) for k in
                        ("contextLength", "contextStart", "contextStride")
                        if conv.attr(k) is not None})
        return graph


@register_pass("seqpool_concat_fuse_pass")
class SeqpoolConcatFusePass(Pass):
    """N sequence_pool (same SUM/AVERAGE pooltype) feeding one concat ->
    fusion_seqpool_concat (ir/seqpool_concat_fuse_pass.cc). Hand-rolled
    matching: the shape is a FAN-IN (N parallel producers into one
    consumer), which the chain-based OpPattern doesn't express."""

    def apply_impl(self, graph):
        for concat in [op for op in graph.block.ops
                       if op.type == "concat"]:
            xs = list(concat.input("X"))
            if len(xs) < 2:
                continue
            axis = concat.attr("axis")
            if axis is None or int(axis) != 1:
                continue  # the fused kernel concats pooled FEATURES
            if concat.input("AxisTensor"):
                continue  # runtime axis can't fold into a static attr
            pools = []
            ptype = None
            ok = True
            for n in xs:
                prods = [op for op in graph.block.ops
                         if n in op.output("Out")
                         and op.type == "sequence_pool"]
                if len(prods) != 1 or not graph.is_internal(n) \
                        or len(graph.var_consumers(n)) != 1:
                    ok = False
                    break
                p = prods[0]
                pt = (p.attr("pooltype") or "SUM").upper()
                if pt not in ("SUM", "AVERAGE") or \
                        (ptype is not None and pt != ptype):
                    ok = False
                    break
                if float(p.attr("pad_value") or 0.0) != 0.0:
                    # empty sequences pool to pad_value; the fused
                    # kernel has no pad_value leg
                    ok = False
                    break
                ptype = pt
                pools.append(p)
            if not ok or not pools:
                continue
            graph.fuse(pools + [concat], "fusion_seqpool_concat",
                       {"X": [p.input("X")[0] for p in pools]},
                       {"Out": [concat.output("Out")[0]]},
                       {"pooltype": ptype, "axis": 1})
        return graph


# --------------------------------------------------------------------------
# the inference passes (the TPU package's ir.py:349-1120)
# --------------------------------------------------------------------------
@register_pass("is_test_pass")
class IsTestPass(Pass):
    """is_test=True on every op that carries the attr
    (ir/is_test_pass.cc)."""

    def apply_impl(self, graph):
        for op in graph.all_op_nodes():
            if "is_test" in op.attrs:
                op.attrs["is_test"] = True
        return graph


@register_pass("simplify_with_basic_ops_pass")
class SimplifyWithBasicOpsPass(Pass):
    """A dropout at is_test becomes ``assign`` (upscale_in_train) or
    ``scale(1 - p)`` (ir/simplify_with_basic_ops_pass.cc)."""

    def apply_impl(self, graph):
        for op in list(graph.all_op_nodes()):
            if op.type != "dropout" or not op.attr("is_test"):
                continue
            x = op.input("X")[0]
            y = op.output("Out")[0]
            impl = op.attr("dropout_implementation") or "downgrade_in_infer"
            if impl == "upscale_in_train":
                graph.fuse([op], "assign", {"X": [x]}, {"Out": [y]}, {})
            else:
                p = float(op.attr("dropout_prob") or 0.0)
                graph.fuse([op], "scale", {"X": [x]}, {"Out": [y]},
                           {"scale": 1.0 - p, "bias": 0.0,
                            "bias_after_scale": True})
        return graph


@register_pass("identity_scale_op_clean_pass")
class IdentityScaleOpCleanPass(Pass):
    """Drop scale(scale=1, bias=0), its consumers rewired to its input
    (ir/identity_scale_op_clean_pass.cc)."""

    def apply_impl(self, graph):
        for op in list(graph.all_op_nodes()):
            if op.type != "scale" or op.input("ScaleTensor"):
                continue
            s, b = op.attr("scale"), op.attr("bias")
            if float(1.0 if s is None else s) != 1.0 or \
                    float(0.0 if b is None else b) != 0.0:
                continue
            x, y = op.input("X")[0], op.output("Out")[0]
            if not graph.is_internal(y):
                continue  # fetched or persistable: keep the copy
            for c in graph.var_consumers(y):
                c._rename_input(y, x)
            graph.remove_ops([op])
        return graph


@register_pass("delete_quant_dequant_op_pass")
class DeleteQuantDequantOpPass(Pass):
    """Strip the fake quantize-dequantize ops
    (ir/delete_quant_dequant_op_pass.cc)."""

    _TYPES = ("fake_quantize_dequantize_moving_average_abs_max",
              "fake_quantize_dequantize_abs_max")

    def apply_impl(self, graph):
        for op in list(graph.all_op_nodes()):
            if op.type not in self._TYPES:
                continue
            x, y = op.input("X")[0], op.output("Out")[0]
            consumers = graph.var_consumers(y)
            if graph.is_internal(y):
                for c in consumers:
                    c._rename_input(y, x)
                graph.remove_ops([op])
            else:
                graph.fuse([op], "assign", {"X": [x]}, {"Out": [y]}, {})
        return graph


@register_pass("fc_fuse_pass")
class FcFusePass(Pass):
    """mul + elementwise_add(a persistable bias) -> fc, a following relu
    absorbed into activation_type (ir/fc_fuse_pass.cc)."""

    def apply_impl(self, graph):
        pat = OpPattern([
            ("mul", {"X": "$x", "Y": "$w"}, {"Out": "$mm"}),
            ("elementwise_add", {"X": "$mm", "Y": "$b"}, {"Out": "$out"}),
        ])
        for m in pat.match(graph):
            mul_op = m["#0"]
            bias = graph.block._find_var_recursive(m["$b"])
            if bias is None or not getattr(bias, "persistable", False):
                continue
            if int(mul_op.attr("y_num_col_dims") or 1) != 1:
                continue
            matched = list(m["#ops"])
            out_name = m["$out"]
            act = ""
            consumers = graph.var_consumers(out_name)
            if (len(consumers) == 1 and consumers[0].type == "relu"
                    and graph.is_internal(out_name)):
                matched.append(consumers[0])
                out_name = consumers[0].output("Out")[0]
                act = "relu"
            graph.fuse(matched, "fc",
                       {"Input": [m["$x"]], "W": [m["$w"]],
                        "Bias": [m["$b"]]},
                       {"Out": [out_name]},
                       {"in_num_col_dims":
                        int(mul_op.attr("x_num_col_dims") or 1),
                        "activation_type": act})
        return graph


class _FcRecurrentFuseBase(Pass):
    """The input projection mul(X, Wx) feeding a LoD recurrence becomes
    the fused op's WeightX leg, the mul's output its XX output
    (ir/fc_gru_fuse_pass.cc, ir/fc_lstm_fuse_pass.cc)."""

    _recur_type = None
    _fused_type = None
    _extra_outs = ()
    _attr_names = ()

    def apply_impl(self, graph):
        pat = OpPattern([
            ("mul", {"X": "$x", "Y": "$wx"}, {"Out": "$xx"}),
            (self._recur_type, {"Input": "$xx", "Weight": "$wh"},
             {"Hidden": "$h"}),
        ])
        for m in pat.match(graph):
            mul_op, rec_op = m["#0"], m["#1"]
            if int(mul_op.attr("x_num_col_dims") or 1) != 1 or \
                    int(mul_op.attr("y_num_col_dims") or 1) != 1:
                continue
            inputs = {"X": [m["$x"]], "WeightX": [m["$wx"]],
                      "WeightH": [m["$wh"]]}
            for slot in ("Bias", "H0", "C0"):
                names = rec_op.input(slot)
                if names:
                    inputs[slot] = list(names)
            outputs = {"Hidden": [m["$h"]], "XX": [m["$xx"]]}
            for slot in self._extra_outs:
                names = rec_op.output(slot)
                if names:
                    outputs[slot] = list(names)
            attrs = {k: rec_op.attr(k) for k in self._attr_names
                     if rec_op.attr(k) is not None}
            graph.fuse([mul_op, rec_op], self._fused_type, inputs, outputs,
                       attrs)
        return graph


@register_pass("fc_gru_fuse_pass")
class FcGruFusePass(_FcRecurrentFuseBase):
    """mul + dynamic_gru -> fusion_gru (ir/fc_gru_fuse_pass.cc)."""
    _recur_type = "dynamic_gru"
    _fused_type = "fusion_gru"
    _attr_names = ("is_reverse", "origin_mode", "gate_activation",
                   "activation")


@register_pass("fc_lstm_fuse_pass")
class FcLstmFusePass(_FcRecurrentFuseBase):
    """mul + dynamic_lstm -> fusion_lstm (ir/fc_lstm_fuse_pass.cc)."""
    _recur_type = "dynamic_lstm"
    _fused_type = "fusion_lstm"
    _extra_outs = ("Cell",)
    _attr_names = ("use_peepholes", "is_reverse", "gate_activation",
                   "cell_activation", "candidate_activation")


@register_pass("multihead_matmul_fuse_pass_v2")
class MultiheadMatmulFusePassV2(Pass):
    """The decomposed BERT/ERNIE attention of a reference-serialized
    program -> one ``multihead_matmul`` (ir/multihead_matmul_fuse_pass.cc:
    435): three mul/elementwise_add/reshape2/transpose2 projections, the
    Q-side scale, QKᵀ, +BiasQK, softmax, PV and the transpose2 + reshape2
    head merge. Wq/Wk/Wv are packed into [N, 3, H·D] and the biases into
    [3, H·D] (:470), the per-branch weights then erased from the scope.
    Needs ``param_scope``."""

    _PAT = OpPattern([
        ("mul", {"X": "$x", "Y": "$wq"}, {"Out": "$q_mm"}),
        ("elementwise_add", {"X": "$q_mm", "Y": "$bq"}, {"Out": "$q_add"}),
        ("reshape2", {"X": "$q_add"}, {"Out": "$q_rs"}),
        ("transpose2", {"X": "$q_rs"}, {"Out": "$q_tr"}),
        ("scale", {"X": "$q_tr"}, {"Out": "$q_sc"}),
        ("mul", {"X": "$x", "Y": "$wk"}, {"Out": "$k_mm"}),
        ("elementwise_add", {"X": "$k_mm", "Y": "$bk"}, {"Out": "$k_add"}),
        ("reshape2", {"X": "$k_add"}, {"Out": "$k_rs"}),
        ("transpose2", {"X": "$k_rs"}, {"Out": "$k_tr"}),
        ("mul", {"X": "$x", "Y": "$wv"}, {"Out": "$v_mm"}),
        ("elementwise_add", {"X": "$v_mm", "Y": "$bv"}, {"Out": "$v_add"}),
        ("reshape2", {"X": "$v_add"}, {"Out": "$v_rs"}),
        ("transpose2", {"X": "$v_rs"}, {"Out": "$v_tr"}),
        ("matmul", {"X": "$q_sc", "Y": "$k_tr"}, {"Out": "$qk"}),
        ("elementwise_add", {"X": "$qk", "Y": "$mask"}, {"Out": "$qk_b"}),
        ("softmax", {"X": "$qk_b"}, {"Out": "$attn"}),
        ("matmul", {"X": "$attn", "Y": "$v_tr"}, {"Out": "$ctx"}),
        ("transpose2", {"X": "$ctx"}, {"Out": "$ctx_tr"}),
        ("reshape2", {"X": "$ctx_tr"}, {"Out": "$out"}),
    ])

    def apply_impl(self, graph):
        scope = self.get("param_scope")
        if scope is None:
            return graph
        dead_candidates = set()
        for m in self._PAT.match(graph):
            qk_op, pv_op = m["#13"], m["#16"]
            if not qk_op.attr("transpose_Y") or pv_op.attr("transpose_Y"):
                continue
            # only the head split and merge the fused op implements
            if any(list(m[f"#{i}"].attr("axis") or []) != [0, 2, 1, 3]
                   for i in (3, 8, 12, 17)):
                continue
            sm_axis = m["#15"].attr("axis")
            if sm_axis is not None and int(sm_axis) not in (-1, 3):
                continue
            mask_axis = m["#14"].attr("axis")
            if mask_axis is not None and int(mask_axis) not in (-1, 0):
                continue
            scale_op = m["#4"]
            sb = scale_op.attr("bias")
            if float(0.0 if sb is None else sb) != 0.0:
                continue
            alpha = float(scale_op.attr("scale") or 1.0) \
                * float(qk_op.attr("alpha") or 1.0)
            rs_shape = m["#2"].attr("shape") or []
            if len(rs_shape) != 4:
                continue
            head_number = int(rs_shape[2])
            wq, wk, wv = (_scope_get(scope, m[s])
                          for s in ("$wq", "$wk", "$wv"))
            bq, bk, bv = (_scope_get(scope, m[s])
                          for s in ("$bq", "$bk", "$bv"))
            if any(a is None for a in (wq, wk, wv, bq, bk, bv)):
                continue
            comb_w = np.stack([wq, wk, wv], axis=1)          # [N, 3, H·D]
            comb_b = np.stack([bq.reshape(-1), bk.reshape(-1),
                               bv.reshape(-1)], axis=0)      # [3, H·D]
            w_name = m["$out"] + ".multihead_w"
            b_name = m["$out"] + ".multihead_bias"
            graph.block.create_var(name=w_name, shape=list(comb_w.shape),
                                   dtype="float32", persistable=True)
            graph.block.create_var(name=b_name, shape=list(comb_b.shape),
                                   dtype="float32", persistable=True)
            _scope_set(scope, w_name, comb_w, like=m["$wq"])
            _scope_set(scope, b_name, comb_b, like=m["$bq"])
            graph.fuse(m["#ops"], "multihead_matmul",
                       {"Input": [m["$x"]], "W": [w_name],
                        "Bias": [b_name], "BiasQK": [m["$mask"]]},
                       {"Out": [m["$out"]]},
                       {"alpha": alpha, "head_number": head_number,
                        "transpose_Q": False, "transpose_K": True,
                        "transpose_V": False})
            dead_candidates.update(
                m[s] for s in ("$wq", "$wk", "$wv", "$bq", "$bk", "$bv"))
        if dead_candidates:
            still_used = set()
            for op in graph.block.ops:
                still_used.update(op.input_arg_names)
            for name in dead_candidates - still_used:
                scope.erase(name)
                graph.block.vars.pop(name, None)
        return graph


@register_pass("multihead_matmul_fuse_pass")
class MultiheadMatmulFusePass(MultiheadMatmulFusePassV2):
    """The v1 name, the same subgraph (ir/multihead_matmul_fuse_pass.cc:
    46)."""


class _ConvBnFoldBase(Pass):
    """The conv + batch_norm family's weight folding on the host, as
    conv_bn_fuse_pass.cc's ConvBNFuser. Needs ``param_scope``."""

    def _fold(self, graph, conv, bn, extra_bias_name=None):
        scope = self.get("param_scope")
        if scope is None:
            return False
        w = _scope_get(scope, conv.input("Filter")[0])
        scale = _scope_get(scope, bn.input("Scale")[0])
        bias = _scope_get(scope, bn.input("Bias")[0])
        mean = _scope_get(scope, bn.input("Mean")[0])
        var = _scope_get(scope, bn.input("Variance")[0])
        if any(a is None for a in (w, scale, bias, mean, var)):
            return False
        eps = float(bn.attr("epsilon") or 1e-5)
        inv_std = 1.0 / np.sqrt(var + eps)
        alpha = scale * inv_std                         # [C_out]
        _scope_set(scope, conv.input("Filter")[0],
                   (w * alpha[:, None, None, None]).astype(w.dtype))
        prior = np.zeros_like(bias)
        if conv.input("Bias"):
            b0 = _scope_get(scope, conv.input("Bias")[0])
            if b0 is not None:
                prior = b0
        if extra_bias_name is not None:
            eb = _scope_get(scope, extra_bias_name)
            if eb is not None:
                prior = prior + eb.reshape(-1)
        new_bias = (prior - mean) * alpha + bias
        return new_bias.astype(w.dtype)

    def _rewrite(self, graph, conv, bn, matched, out_name, new_bias):
        scope = self.get("param_scope")
        bias_name = conv.output("Output")[0] + ".bn_folded_bias"
        graph.block.create_var(name=bias_name, shape=[len(new_bias)],
                               dtype="float32", persistable=True)
        _scope_set(scope, bias_name, new_bias, like=conv.input("Filter")[0])
        ins = {"Input": conv.input("Input"), "Filter": conv.input("Filter"),
               "Bias": [bias_name]}
        graph.fuse(matched, "conv2d_fusion", ins, {"Output": [out_name]},
                   {**{k: conv.attr(k) for k in
                       ("strides", "paddings", "dilations", "groups",
                        "padding_algorithm", "data_format")
                       if conv.attr(k) is not None},
                    "activation": "identity"})


@register_pass("conv_bn_fuse_pass")
class ConvBnFusePass(_ConvBnFoldBase):
    """conv2d + batch_norm(is_test) -> conv2d_fusion with folded weights
    (ir/conv_bn_fuse_pass.cc)."""

    def apply_impl(self, graph):
        pat = OpPattern([
            ("conv2d", {"Input": "$in", "Filter": "$w"}, {"Output": "$conv"}),
            ("batch_norm", {"X": "$conv"}, {"Y": "$y"}),
        ])
        for m in pat.match(graph):
            conv, bn = m["#0"], m["#1"]
            if not (bn.attr("is_test") or bn.attr("use_global_stats")):
                continue
            new_bias = self._fold(graph, conv, bn)
            if new_bias is False:
                continue
            self._rewrite(graph, conv, bn, m["#ops"], m["$y"], new_bias)
        return graph


@register_pass("conv_eltwiseadd_bn_fuse_pass")
class ConvEltwiseAddBnFusePass(_ConvBnFoldBase):
    """conv2d + elementwise_add(a persistable bias) + batch_norm(is_test)
    -> conv2d_fusion (ir/conv_eltwiseadd_bn_fuse_pass.cc)."""

    def apply_impl(self, graph):
        pat = OpPattern([
            ("conv2d", {"Input": "$in", "Filter": "$w"}, {"Output": "$conv"}),
            ("elementwise_add", {"X": "$conv", "Y": "$b"}, {"Out": "$add"}),
            ("batch_norm", {"X": "$add"}, {"Y": "$y"}),
        ])
        for m in pat.match(graph):
            conv, bn = m["#0"], m["#2"]
            if not (bn.attr("is_test") or bn.attr("use_global_stats")):
                continue
            bvar = graph.block._find_var_recursive(m["$b"])
            if bvar is None or not getattr(bvar, "persistable", False):
                continue
            new_bias = self._fold(graph, conv, bn, extra_bias_name=m["$b"])
            if new_bias is False:
                continue
            self._rewrite(graph, conv, bn, m["#ops"], m["$y"], new_bias)
        return graph


@register_pass("conv_affine_channel_fuse_pass")
class ConvAffineChannelFusePass(_ConvBnFoldBase):
    """conv2d + affine_channel -> conv2d_fusion with folded weights
    (ir/conv_affine_channel_fuse_pass.cc)."""

    def apply_impl(self, graph):
        pat = OpPattern([
            ("conv2d", {"Input": "$in", "Filter": "$w"}, {"Output": "$conv"}),
            ("affine_channel", {"X": "$conv", "Scale": "$s", "Bias": "$b"},
             {"Out": "$y"}),
        ])
        for m in pat.match(graph):
            scope = self.get("param_scope")
            if scope is None:
                break
            conv = m["#0"]
            w = _scope_get(scope, conv.input("Filter")[0])
            scale = _scope_get(scope, m["$s"])
            bias = _scope_get(scope, m["$b"])
            if any(a is None for a in (w, scale, bias)):
                continue
            _scope_set(scope, conv.input("Filter")[0],
                       (w * scale[:, None, None, None]).astype(w.dtype))
            prior = np.zeros_like(bias)
            if conv.input("Bias"):
                b0 = _scope_get(scope, conv.input("Bias")[0])
                if b0 is not None:
                    prior = b0
            self._rewrite(graph, conv, m["#1"], m["#ops"], m["$y"],
                          (prior * scale + bias).astype(w.dtype))
        return graph


@register_pass("fc_elementwise_layernorm_fuse_pass")
class FcElementwiseLayerNormFusePass(Pass):
    """fc + elementwise_add(residual as Y) + layer_norm over the last
    axis -> fused_fc_elementwise_layernorm
    (ir/fc_elementwise_layernorm_fuse_pass.cc). The fc output must be the
    add's X: BERT adds the residual as X, so it does not fuse there."""

    def apply_impl(self, graph):
        pat = OpPattern([
            ("fc", {"Input": "$x", "W": "$w", "Bias": "$b0"},
             {"Out": "$fc"}),
            ("elementwise_add", {"X": "$fc", "Y": "$res"}, {"Out": "$add"}),
            ("layer_norm", {"X": "$add", "Scale": "$s", "Bias": "$b1"},
             {"Y": "$y"}),
        ])
        for m in pat.match(graph):
            fc, ln = m["#0"], m["#2"]
            if fc.attr("activation_type"):
                continue
            add_var = graph.block._find_var_recursive(m["$add"])
            shape = getattr(add_var, "shape", None) if add_var else None
            if not shape or int(ln.attr("begin_norm_axis") or 1) != \
                    len(shape) - 1:
                continue  # the fused op normalises the last axis only
            graph.fuse(m["#ops"], "fused_fc_elementwise_layernorm",
                       {"X": [m["$x"]], "W": [m["$w"]], "Bias0": [m["$b0"]],
                        "Y": [m["$res"]], "Scale": [m["$s"]],
                        "Bias1": [m["$b1"]]},
                       {"Out": [m["$y"]]},
                       {"epsilon": float(ln.attr("epsilon") or 1e-5),
                        "begin_norm_axis":
                        int(ln.attr("begin_norm_axis") or 1),
                        "x_num_col_dims":
                        int(fc.attr("in_num_col_dims") or 1)})
        return graph


@register_pass("embedding_eltwise_layernorm_fuse_pass")
class EmbeddingEltwiseLayerNormFusePass(Pass):
    """k lookups (k = 3 or 2, v1 or v2) + (k - 1) adds + layer_norm over
    the last axis -> fused_embedding_eltwise_layernorm
    (ir/embedding_eltwise_layernorm_fuse_pass.cc): BERT's input stack.
    A lookup with a padding row does not fuse."""

    @staticmethod
    def _patterns():
        for lt in ("lookup_table", "lookup_table_v2"):
            yield OpPattern([
                (lt, {"W": "$w1", "Ids": "$id1"}, {"Out": "$e1"}),
                (lt, {"W": "$w2", "Ids": "$id2"}, {"Out": "$e2"}),
                (lt, {"W": "$w3", "Ids": "$id3"}, {"Out": "$e3"}),
                ("elementwise_add", {"X": "$e1", "Y": "$e2"},
                 {"Out": "$a1"}),
                ("elementwise_add", {"X": "$a1", "Y": "$e3"},
                 {"Out": "$a2"}),
                ("layer_norm", {"X": "$a2", "Scale": "$s", "Bias": "$b"},
                 {"Y": "$y"}),
            ]), 3
            yield OpPattern([
                (lt, {"W": "$w1", "Ids": "$id1"}, {"Out": "$e1"}),
                (lt, {"W": "$w2", "Ids": "$id2"}, {"Out": "$e2"}),
                ("elementwise_add", {"X": "$e1", "Y": "$e2"},
                 {"Out": "$a1"}),
                ("layer_norm", {"X": "$a1", "Scale": "$s", "Bias": "$b"},
                 {"Y": "$y"}),
            ]), 2

    def apply_impl(self, graph):
        for pat, k in self._patterns():
            for m in pat.match(graph):
                lookups = m["#ops"][:k]
                if any(int(op.attr("padding_idx")
                           if op.attr("padding_idx") is not None else -1)
                       >= 0 for op in lookups):
                    continue
                ln = m["#ops"][-1]
                add_name = m["$a2"] if k == 3 else m["$a1"]
                add_var = graph.block._find_var_recursive(add_name)
                shape = getattr(add_var, "shape", None) if add_var else None
                if not shape or int(ln.attr("begin_norm_axis") or 1) != \
                        len(shape) - 1:
                    continue
                graph.fuse(m["#ops"], "fused_embedding_eltwise_layernorm",
                           {"Ids": [m[f"$id{i}"] for i in range(1, k + 1)],
                            "Embs": [m[f"$w{i}"] for i in range(1, k + 1)],
                            "Scale": [m["$s"]], "Bias": [m["$b"]]},
                           {"Out": [m["$y"]]},
                           {"epsilon": float(ln.attr("epsilon") or 1e-5)})
        return graph


# --------------------------------------------------------------------------
# tooling passes (the TPU package's ir.py:1120-1150)
# --------------------------------------------------------------------------
@register_pass("graph_viz_pass")
class GraphVizPass(Pass):
    """Write the graph as graphviz dot (ir/graph_viz_pass.cc) to the
    attr 'graph_viz_path' (default: paddle_tpu_torch_graph.dot in the
    temporary directory)."""

    def apply_impl(self, graph):
        import os
        import tempfile
        path = self.get("graph_viz_path", os.path.join(
            tempfile.gettempdir(), "paddle_tpu_torch_graph.dot"))
        lines = ["digraph G {"]
        for i, op in enumerate(graph.all_op_nodes()):
            lines.append(f'  op{i} [label="{op.type}" shape=box '
                         'style=filled fillcolor=lightskyblue];')
            for n in op.input_arg_names:
                lines.append(f'  "{n}" -> op{i};')
            for n in op.output_arg_names:
                lines.append(f'  op{i} -> "{n}";')
        lines.append("}")
        with open(path, "w") as f:
            f.write("\n".join(lines))
        return graph


@register_pass("graph_to_program_pass")
class GraphToProgramPass(Pass):
    """The identity: a Graph is a live view of its Program (the
    reference's ir/graph_to_program_pass.cc exists because its Graph is a
    structure of its own)."""


# --------------------------------------------------------------------------
# absorbed passes (the TPU package's ir.py:1152-1242): the reference's
# pass names whose work the compiled step does here (one planned step a
# block, one CUDA graph on the card, torch's caching allocator and the
# graphs' shared pool for memory). Registered so that a reference
# pipeline resolves; each is the identity.
# --------------------------------------------------------------------------
class AbsorbedPass(Pass):
    """A pass whose job the compiled step does."""


def _register_absorbed(name: str, note: str):
    cls = type(name.title().replace("_", ""), (AbsorbedPass,),
               {"note": note, "__doc__": note})
    register_pass(name)(cls)


_MEM = "memory planning; the caching allocator and the graphs' pool"
_ONE_STEP = "ordering; one planned step, one CUDA graph"
_MULTI = "multi-device graph building; ROADMAP A8"
_UPDATE = "optimizer-op fusion; the update ops run inside the step's graph"
_FUSE = "a micro-fusion; kernels are launched from the step's graph"
_PLACE = "backend placement; one CUDA device"
_CPU = "CPU-only (mkldnn, int8); not on this build"
for _n, _note in {
    "eager_deletion_pass": _MEM, "reference_count_pass": _MEM,
    "buffer_shared_inplace_pass": _MEM,
    "buffer_shared_cross_op_memory_reuse_pass": _MEM,
    "memory_optimize_pass": _MEM, "inplace_op_pass": _MEM,
    "while_op_eager_deletion_pass": _MEM,
    "recurrent_op_eager_deletion_pass": _MEM,
    "conditional_block_op_eager_deletion_pass": _MEM,
    "all_reduce_deps_pass": _ONE_STEP,
    "backward_optimizer_op_deps_pass": _ONE_STEP,
    "sequential_execution_pass": _ONE_STEP,
    "modify_op_lock_and_record_event_pass": _ONE_STEP,
    "add_reader_dependency_pass": _ONE_STEP,
    "runtime_context_cache_pass": _ONE_STEP,
    "lock_free_optimize_pass": _ONE_STEP,
    "fuse_all_reduce_op_pass": _MULTI, "coalesce_grad_tensor_pass": _MULTI,
    "multi_batch_merge_pass": _MULTI, "multi_devices_check_pass": _MULTI,
    "multi_devices_print_pass": _MULTI, "sync_batch_norm_pass": _MULTI,
    "fuse_adam_op_pass": _UPDATE, "fuse_sgd_op_pass": _UPDATE,
    "fuse_momentum_op_pass": _UPDATE,
    "fuse_relu_depthwise_conv_pass": _FUSE,
    "squared_mat_sub_fuse_pass": _FUSE, "repeated_fc_relu_fuse_pass": _FUSE,
    "seqpool_cvm_concat_fuse_pass": _FUSE,
    "transpose_flatten_concat_fuse_pass": _FUSE,
    "shuffle_channel_detect_pass": _FUSE,
    "matmul_transpose_reshape_fuse_pass": _FUSE,
    "scale_matmul_fuse_pass": _FUSE, "fusion_group_pass": _FUSE,
    "fuse_elewise_add_act_ops_pass_placeholder":
        "see fuse_elewise_add_act_pass",
    "cudnn_placement_pass": _PLACE, "mkldnn_placement_pass": _CPU,
    "mkldnn_inplace_pass": _CPU, "conv_bias_mkldnn_fuse_pass": _CPU,
    "conv3d_bias_mkldnn_fuse_pass": _CPU,
    "conv_activation_mkldnn_fuse_pass": _CPU,
    "conv_relu_mkldnn_fuse_pass": _CPU, "conv_relu6_mkldnn_fuse_pass": _CPU,
    "conv_leaky_relu_mkldnn_fuse_pass": _CPU,
    "conv_swish_mkldnn_fuse_pass": _CPU,
    "conv_concat_relu_mkldnn_fuse_pass": _CPU,
    "conv_elementwise_add_mkldnn_fuse_pass": _CPU,
    "conv_transpose_bias_mkldnn_fuse_pass": _CPU,
    "depthwise_conv_mkldnn_pass": _CPU, "fc_mkldnn_pass": _CPU,
    "reshape_transpose_matmul_mkldnn_fuse_pass": _CPU,
    "cpu_quantize_pass": _CPU, "cpu_quantize_placement_pass": _CPU,
    "cpu_quantize_squash_pass": _CPU,
    "conv_elementwise_add_fuse_pass": _FUSE,
    "conv_elementwise_add_act_fuse_pass": _FUSE,
    "conv_elementwise_add2_act_fuse_pass": _FUSE,
    "conv_eltwiseadd_affine_channel_fuse_pass":
        "covered by conv_affine_channel_fuse_pass",
    "conv_transpose_bn_fuse_pass": _FUSE,
    "conv_transpose_eltwiseadd_bn_fuse_pass": _FUSE,
    "attention_lstm_fuse_pass": _FUSE, "embedding_fc_lstm_fuse_pass": _FUSE,
    "mul_gru_fuse_pass": _FUSE, "mul_lstm_fuse_pass": _FUSE,
    "quant_conv2d_dequant_fuse_pass": _CPU,
}.items():
    _register_absorbed(_n, _note)


@register_pass("block_segmentation_pass")
class BlockSegmentationPass(Pass):
    """Analysis only: the compiled/island partition the executor's
    segmented block would use for this block (``analyze_block_segments``
    over its ops but feed and fetch), stored as the graph attr
    'segments' and the program attr ``_segment_plan`` (a
    ``segment_summary``). Changes nothing."""

    def apply(self, graph: Graph) -> Graph:  # no drop_orphan_vars
        ops = [op for op in graph.block.ops
               if op.type not in ("feed", "fetch")]
        summary = segment_summary(analyze_block_segments(ops))
        graph.set("segments", summary)
        graph.program._segment_plan = summary
        return graph


# --------------------------------------------------------------------------
# the predictor's pipeline (reference: inference/api/paddle_pass_builder.cc
# GpuPassStrategy)
# --------------------------------------------------------------------------
INFERENCE_PASSES = [
    "is_test_pass",
    "simplify_with_basic_ops_pass",
    "delete_quant_dequant_op_pass",
    # before fc_fuse_pass, which would take the projection mul + add pairs
    # the attention pattern anchors on
    "multihead_matmul_fuse_pass_v2",
    "conv_affine_channel_fuse_pass",
    "conv_eltwiseadd_bn_fuse_pass",
    "conv_bn_fuse_pass",
    "embedding_eltwise_layernorm_fuse_pass",
    # before fc_fuse_pass: the recurrences anchor on the raw projection mul
    "fc_gru_fuse_pass",
    "fc_lstm_fuse_pass",
    "fc_fuse_pass",
    "fc_elementwise_layernorm_fuse_pass",
    "identity_scale_op_clean_pass",
]


def apply_inference_passes(program, scope=None, extra: Sequence[str] = ()):
    """The inference pipeline over ``program``'s global block, in place
    (reference AnalysisPredictor::OptimizeInferenceProgram,
    analysis_predictor.cc:497)."""
    pm = PassManager(list(INFERENCE_PASSES) + list(extra), scope=scope)
    return pm.apply(program, for_test=True)
