"""Control-flow layers (counterpart of paddle_tpu/fluid/layers/
control_flow.py; reference: python/paddle/fluid/layers/control_flow.py).
So far: the comparisons, increment, the tensor arrays (create_array,
array_write, array_read, array_length), While, while_loop, cond, case,
switch_case, Switch, Print, Assert, is_empty, StaticRNN, DynamicRNN,
IfElse and the LoD rank-table layers (lod_rank_table, max_sequence_len,
lod_tensor_to_array, array_to_lod_tensor, shrink_memory,
reorder_lod_tensor_by_rank).

A sub-block is built as the reference builds it: ``Program._create_block``
makes it the current block, the layers called inside append to it, and
``_rollback`` returns to its parent, which gets the control-flow op with
the sub-block as its ``sub_block`` attr and the names the sub-block reads
from outside (``X``/``Input``) and writes (``Out``). How the executor runs
them: a conditional runs inside the step's CUDA graph (both branches, the
taken one's writes selected on the device), a ``while`` is a host-driven
loop of body replays, and a random op inside a conditional sends the block
to the segmented path, where the conditional runs in the interpreter
(fluid/executor.py). A ``DynamicRNN``'s ``while`` holds the stateful
tensor-array and rank-table ops: it runs in the interpreter, an island of
the segmented step, each step on the batch still alive; ``IfElse`` splits
and merges rows on the host, an island too."""
from __future__ import annotations

from .. import unique_name
from ..core import VarDesc
from ..framework import Variable, default_main_program
from ..layer_helper import LayerHelper

__all__ = [
    "While", "Switch", "increment", "array_write", "create_array",
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "array_read", "array_length", "cond", "Print", "Assert",
    "is_empty", "case", "switch_case", "while_loop", "array_to_lod_tensor",
    "StaticRNN", "DynamicRNN", "IfElse", "lod_rank_table",
    "max_sequence_len", "lod_tensor_to_array", "shrink_memory",
    "reorder_lod_tensor_by_rank",
]


def _cmp(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference(VarDesc.VarType.BOOL)
        cond.stop_gradient = True
        cond.shape = x.shape
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp("not_equal", x, y, cond)


def increment(x, value=1.0, in_place=True):
    """x + value, into x itself when ``in_place``."""
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def create_array(dtype):
    """A LOD_TENSOR_ARRAY var of the current block."""
    helper = LayerHelper("array")
    return helper.main_program.current_block().create_var(
        name="{}.out".format(helper.name),
        type=VarDesc.VarType.LOD_TENSOR_ARRAY, dtype=dtype)


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i]}, outputs={"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]}, outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference(VarDesc.VarType.INT64)
    out.stop_gradient = True
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def _sub_block_io(sub, inner_out=()):
    """(the names ``sub`` reads before it writes them, the names it
    writes), as sets; ``inner_out`` counts as written before the first
    op."""
    inner = set(inner_out)
    x_names = set()
    for op in sub.ops:
        x_names.update(n for n in op.input_arg_names if n not in inner)
        inner.update(op.output_arg_names)
    return x_names, inner


class While:
    """A loop over a sub-block while ``cond`` (a bool [1] var that the
    body must update) holds (reference control_flow.py While)."""

    def __init__(self, cond, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.is_test = is_test

    class _BlockGuard:
        def __init__(self, while_obj):
            self.w = while_obj

        def __enter__(self):
            self.w._main = default_main_program()
            self.w._block = self.w._main._create_block()
            return self.w._block

        def __exit__(self, exc_type, exc_val, exc_tb):
            if exc_type is not None:
                return False
            main = self.w._main
            sub_block = main.current_block()
            main._rollback()
            parent = main.current_block()
            x_names, inner_outputs = _sub_block_io(
                sub_block, {self.w.cond_var.name})
            out_vars = [n for n in inner_outputs
                        if parent.has_var_recursive(n)]
            step_scope = parent.create_var(
                type=VarDesc.VarType.STEP_SCOPES,
                name=self.w.helper.name + ".step_scopes")
            parent.append_op(
                type="while",
                inputs={"X": sorted(x_names), "Condition": [self.w.cond_var]},
                outputs={"Out": sorted(out_vars),
                         "StepScopes": [step_scope]},
                attrs={"sub_block": sub_block, "is_test": self.w.is_test})
            return True

    def block(self):
        return While._BlockGuard(self)


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """The functional while (reference control_flow.py:3739): ``body``
    maps the loop vars to their next values, which are assigned back to
    them, and ``cond`` of the new values to the condition."""
    from .tensor import assign
    pre_cond = cond(*loop_vars)
    w = While(pre_cond, is_test, name)
    with w.block():
        new_vars = body(*loop_vars)
        if not isinstance(new_vars, (list, tuple)):
            new_vars = [new_vars]
        for old, new in zip(loop_vars, new_vars):
            assign(new, old)
        new_cond = cond(*loop_vars)
        assign(new_cond, pre_cond)
    return loop_vars


def _close_conditional(main, cond_var, scope_name):
    """End the current sub-block and append to its parent the
    ``conditional_block`` op that runs it when ``cond_var`` holds."""
    sub = main.current_block()
    main._rollback()
    parent = main.current_block()
    x_names, inner_out = _sub_block_io(sub)
    scope_var = parent.create_var(type=VarDesc.VarType.STEP_SCOPES,
                                  name=scope_name)
    parent.append_op(
        type="conditional_block",
        inputs={"Cond": [cond_var], "Input": sorted(x_names)},
        outputs={"Out": sorted(inner_out), "Scope": [scope_var]},
        attrs={"sub_block": sub, "is_scalar_condition": True})


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Two branches as ``conditional_block`` ops on ``pred`` and on its
    negation, their outputs joined by ``select_input`` (reference
    control_flow.py cond)."""
    from .nn import logical_not
    from .tensor import cast, fill_constant
    helper = LayerHelper("cond", name=name)
    main = default_main_program()

    def branch(fn, cond_var):
        main._create_block()
        out = fn() if fn is not None else None
        _close_conditional(main, cond_var, helper.name + ".branch_scope")
        return out
    true_out = branch(true_fn, pred)
    false_out = branch(false_fn, logical_not(pred))
    if true_out is None and false_out is None:
        return None

    def _promote(v, like):
        """A Python scalar a branch returns becomes a constant, so that
        select_input can pick between a Variable and a literal."""
        if isinstance(v, Variable) or not isinstance(v, (bool, int, float)):
            return v
        if isinstance(like, Variable):
            dt = like.dtype
        elif isinstance(v, bool):
            dt = VarDesc.VarType.BOOL
        elif isinstance(v, int):
            dt = VarDesc.VarType.INT64
        else:
            dt = VarDesc.VarType.FP32
        return fill_constant([1], dt, v)

    def _select(t, f):
        t = _promote(t, f)
        f = _promote(f, t)
        if not isinstance(t, Variable) and not isinstance(f, Variable):
            return t  # both host-side: the branches agree structurally
        mask = cast(pred, VarDesc.VarType.INT32)
        o = helper.create_variable_for_type_inference(t.dtype)
        o.shape = t.shape
        helper.append_op(type="select_input",
                         inputs={"X": [f, t], "Mask": [mask]},
                         outputs={"Out": [o]})
        return o

    if isinstance(true_out, (list, tuple)):
        return [_select(t, f) for t, f in zip(true_out, false_out)]
    return _select(true_out, false_out)


def case(pred_fn_pairs, default=None, name=None):
    """The first pair whose predicate holds, else ``default``: chained
    ``cond`` (reference control_flow.py case)."""
    pred, fn = pred_fn_pairs[0]
    if len(pred_fn_pairs) == 1:
        return cond(pred, fn, default, name)
    return cond(pred, fn, lambda: case(pred_fn_pairs[1:], default), name)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch keyed by the value of ``branch_index``: ``case`` over
    ``branch_index == key``."""
    from .tensor import fill_constant
    pairs = []
    for idx, fn in (branch_fns.items() if isinstance(branch_fns, dict)
                    else enumerate(branch_fns)):
        c = fill_constant([1], branch_index.dtype, idx)
        pairs.append((equal(branch_index, c), fn))
    return case(pairs, default, name)


class Switch:
    """Cases tried in order, the first that holds runs, else the default
    (reference control_flow.py Switch; the LR schedules' building block).
    Each case is a ``conditional_block`` on its condition and the
    negations of the conditions before it."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.pre_not_conditions = []

    class _CaseGuard:
        def __init__(self, switch, cond_var):
            self.switch = switch
            self.cond_var = cond_var
            self.main = None

        def __enter__(self):
            from .nn import logical_and, logical_not
            self.main = default_main_program()
            s = self.switch
            if self.cond_var is not None:
                c = self.cond_var
                for nc in s.pre_not_conditions:
                    c = logical_and(c, nc)
                s.pre_not_conditions.append(logical_not(self.cond_var))
            else:
                c = None
                for nc in s.pre_not_conditions:
                    c = nc if c is None else logical_and(c, nc)
            self.run_cond = c
            self.block = self.main._create_block()
            return self.block

        def __exit__(self, exc_type, exc_val, exc_tb):
            if exc_type is not None:
                return False
            _close_conditional(self.main, self.run_cond,
                               self.switch.helper.name + ".case_scope")
            return True

    def case(self, condition):
        return Switch._CaseGuard(self, condition)

    def default(self):
        return Switch._CaseGuard(self, None)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """The print op: prints ``input`` when the op runs (a host read, so a
    compiled block runs it as an island) and returns it as a new Variable
    of the same shape."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"first_n": first_n, "message": message or "",
                            "summarize": summarize,
                            "print_tensor_name": print_tensor_name,
                            "print_tensor_type": print_tensor_type,
                            "print_tensor_shape": print_tensor_shape,
                            "print_tensor_lod": print_tensor_lod,
                            "print_phase": print_phase.upper()})
    return out


def Assert(cond, data=None, summarize=20, name=None):
    """Raises when ``cond`` does not hold as the op runs (a host read)."""
    helper = LayerHelper("assert", name=name)
    helper.append_op(type="assert",
                     inputs={"Cond": [cond],
                             "Data": list(data) if data else []},
                     outputs={}, attrs={"summarize": summarize})


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference(VarDesc.VarType.BOOL)
        cond.stop_gradient = True
    helper.append_op(type="is_empty", inputs={"X": [x]},
                     outputs={"Out": [cond]})
    return cond


def array_to_lod_tensor(x, table):
    """The tensor array ``x`` joined into one tensor (reference:
    layers/control_flow.py array_to_lod_tensor). With a ``table`` (a
    LoDRankTable, DynamicRNN's) the sequences that lod_tensor_to_array
    split are put back in their order, with their LoD; ``table=None``
    joins the entries along axis 0."""
    helper = LayerHelper("array_to_lod_tensor")
    tmp = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    if table is not None:
        inputs["RankTable"] = [table]
    helper.append_op(type="array_to_lod_tensor", inputs=inputs,
                     outputs={"Out": [tmp]})
    return tmp


class StaticRNN:
    """Fixed-length RNN over time-major input (reference:
    control_flow.py StaticRNN:336). The reference records a step sub-block
    that the ``recurrent`` op runs; here, as in the TPU package, the
    recorded step ops are unrolled across time, each step's outputs
    renamed (``<name>@t<step>``), so the step is one planned block (one
    CUDA graph on the card) and its grad the ops' own.

    with rnn.step():
        x_t = rnn.step_input(x)          # x: [T, batch, ...]
        prev = rnn.memory(shape=[-1, H], batch_ref=x_t)
        h = some_layers(x_t, prev)
        rnn.update_memory(prev, h)
        rnn.step_output(h)
    out = rnn()                          # [T, batch, ...]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._block = self.helper.main_program.current_block()
        self._step_inputs = []     # (placeholder_var, source_var)
        self._memories = []        # dicts: placeholder, init_name, link
        self._step_outputs = []    # placeholder names
        self._template = None
        self._seq_len = None
        self._outputs = None
        self._in_step = False

    # ------------------------------------------------------------- API
    def step(self):
        rnn = self

        class _Guard:
            def __enter__(self):
                rnn._in_step = True
                rnn._n0 = len(rnn._block.ops)
                return rnn

            def __exit__(self, *exc):
                rnn._in_step = False
                if exc[0] is None:
                    rnn._complete()
                return False
        return _Guard()

    def _check_in_step(self):
        if not self._in_step:
            raise ValueError("StaticRNN: call inside 'with rnn.step():'")

    def step_input(self, x):
        self._check_in_step()
        if self._seq_len is None:
            self._seq_len = int(x.shape[0])
        elif int(x.shape[0]) != self._seq_len:
            raise ValueError("StaticRNN: step inputs disagree on seq_len")
        ph = self._block.create_var(
            name=unique_name.generate("static_rnn_x"),
            dtype=x.dtype, shape=tuple(x.shape[1:]))
        self._step_inputs.append((ph, x))
        return ph

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1):
        self._check_in_step()
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    "StaticRNN.memory: need init or (shape, batch_ref)")
            from .tensor import fill_constant_batch_size_like
            # build the init OUTSIDE the recorded template, referencing the
            # SOURCE sequence var (a step placeholder has no runtime value;
            # the source is time-major so its batch dim is ref_batch_dim_idx)
            src_ref = batch_ref
            dim_idx = 0
            for ph2, src in self._step_inputs:
                if ph2.name == batch_ref.name:
                    src_ref = src
                    dim_idx = ref_batch_dim_idx
                    break
            ops_before = self._block.ops[self._n0:]
            del self._block.ops[self._n0:]
            init = fill_constant_batch_size_like(
                src_ref, [-1] + [int(s) for s in shape if s != -1],
                "float32", init_value, input_dim_idx=dim_idx,
                output_dim_idx=0)
            init_ops = self._block.ops[self._n0:]
            del self._block.ops[self._n0:]
            self._block.ops[self._n0:self._n0] = init_ops
            self._n0 += len(init_ops)
            self._block.ops.extend(ops_before)
        ph = self._block.create_var(
            name=unique_name.generate("static_rnn_mem"),
            dtype=init.dtype, shape=tuple(init.shape))
        self._memories.append({"ph": ph.name, "init": init.name,
                               "link": None})
        return ph

    def update_memory(self, mem, var):
        self._check_in_step()
        for m in self._memories:
            if m["ph"] == mem.name:
                m["link"] = var.name
                return
        raise ValueError("StaticRNN.update_memory: unknown memory")

    def step_output(self, o):
        self._check_in_step()
        self._step_outputs.append(o.name)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    # --------------------------------------------------------- unrolling
    def _complete(self):
        block = self._block
        template = block.ops[self._n0:]
        del block.ops[self._n0:]
        if self._seq_len is None:
            raise ValueError("StaticRNN: no step_input given")
        T = self._seq_len
        from ..framework import Operator
        collected = {name: [] for name in self._step_outputs}
        mem_cur = {m["ph"]: m["init"] for m in self._memories}
        for t in range(T):
            rename = dict(mem_cur)
            # slice step inputs: x[t]
            for ph, src in self._step_inputs:
                st = block.create_var(
                    name=unique_name.generate(f"{ph.name}@{t}"),
                    dtype=ph.dtype, shape=tuple(ph.shape))
                block.append_op(
                    type="slice", inputs={"Input": [src]},
                    outputs={"Out": [st]},
                    attrs={"axes": [0], "starts": [t], "ends": [t + 1],
                           "decrease_axis": [0]})
                rename[ph.name] = st.name
            # clone template ops with per-step output renaming
            for op in template:
                new_out = {}
                for slot, names in op.outputs.items():
                    outs = []
                    for n in names:
                        nn = f"{n}@t{t}"
                        src_v = block.vars.get(n)
                        if src_v is not None and nn not in block.vars:
                            block.create_var(name=nn, dtype=src_v.dtype,
                                             shape=tuple(src_v.shape))
                        rename[n] = nn
                        outs.append(nn)
                    new_out[slot] = outs
                new_in = {slot: [rename.get(n, n) for n in names]
                          for slot, names in op.inputs.items()}
                block.ops.append(Operator(block, op.type, inputs=new_in,
                                          outputs=new_out,
                                          attrs=dict(op.attrs)))
            for name in self._step_outputs:
                collected[name].append(rename.get(name, name))
            mem_cur = {m["ph"]: rename.get(m["link"], m["link"])
                       for m in self._memories if m["link"]}
        # stack step outputs back to [T, ...]
        from .nn import stack
        outs = []
        for name in self._step_outputs:
            vars_t = [block.vars[n] if n in block.vars else
                      self._var_of(n) for n in collected[name]]
            outs.append(stack(vars_t, axis=0))
        self._outputs = outs
        # the step placeholders and the template's original output vars
        # only existed for recording — after the per-step renaming no op
        # references them; drop them so the program carries no dead var
        # descs (the verifier's dead-var rule keys on exactly this)
        used = set()
        for op in block.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
        scratch = {ph.name for ph, _src in self._step_inputs}
        scratch |= {m["ph"] for m in self._memories}
        for op in template:
            scratch.update(op.output_arg_names)
        for name in scratch - used:
            v = block.vars.get(name)
            if v is not None and not v.persistable:
                del block.vars[name]

    def _var_of(self, name):
        v = self._block.vars.get(name)
        if v is None:
            raise KeyError(f"StaticRNN: var {name} missing")
        return v

    def __call__(self, *args):
        if self._outputs is None:
            raise ValueError("StaticRNN: use inside step() first")
        if len(self._outputs) == 1:
            return self._outputs[0]
        return self._outputs


def lod_rank_table(x, level=0):
    """reference control_flow.py lod_rank_table — sort sequences of one
    LoD level by length descending into a LoDRankTable var."""
    helper = LayerHelper("lod_rank_table")
    table = helper.main_program.current_block().create_var(
        name=unique_name.generate("lod_rank_table"),
        type=VarDesc.VarType.LOD_RANK_TABLE)
    table.stop_gradient = True
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [table]}, attrs={"level": level})
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_seqence_length")
    res = helper.create_variable_for_type_inference(VarDesc.VarType.INT64)
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [res]})
    return res


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array")
    array = helper.main_program.current_block().create_var(
        name=unique_name.generate("lod_tensor_to_array"),
        type=VarDesc.VarType.LOD_TENSOR_ARRAY, dtype=x.dtype)
    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [array]})
    return array


def shrink_memory(x, i, table):
    helper = LayerHelper("shrink_memory")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


class DynamicRNN:
    """Variable-length RNN over LoD sequences (reference control_flow.py
    DynamicRNN:2854): sequences are rank-sorted by length, split into
    per-timestep batches, and a While block walks the steps; memories
    shrink to the still-alive prefix each step."""

    BEFORE_RNN, IN_RNN, AFTER_RNN = 0, 1, 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self.lod_rank_table = None
        self.max_seq_len = None
        self.step_idx = None
        self.zero_idx = None
        self.mem_dict = {}
        self.output_array = []
        self.outputs = []
        self.cond = self.helper.create_variable_for_type_inference(
            VarDesc.VarType.BOOL)
        self.cond.stop_gradient = True
        self.while_op = While(self.cond)
        self.input_array = []
        self.mem_link = []

    def _parent_block_(self):
        prog = self.helper.main_program
        return prog.block(prog.current_block().parent_idx)

    def _assert_in_rnn_block_(self, method):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError(f"{method}() must be called inside block()")

    def _init_zero_idx_(self):
        if self.zero_idx is None:
            parent = self._parent_block_()
            self.zero_idx = parent.create_var(
                name=unique_name.generate("zero_idx"),
                dtype=VarDesc.VarType.INT64)
            parent.append_op(type="fill_constant",
                             inputs={}, outputs={"Out": [self.zero_idx]},
                             attrs={"shape": [1], "value": 0.0,
                                    "dtype": VarDesc.VarType.INT64,
                                    "force_cpu": True})

    def step_input(self, x, level=0):
        self._assert_in_rnn_block_("step_input")
        parent = self._parent_block_()
        if self.lod_rank_table is None:
            self.lod_rank_table = parent.create_var(
                name=unique_name.generate("lod_rank_table"),
                type=VarDesc.VarType.LOD_RANK_TABLE)
            self.lod_rank_table.stop_gradient = True
            parent.append_op(type="lod_rank_table", inputs={"X": [x]},
                             outputs={"Out": [self.lod_rank_table]},
                             attrs={"level": level})
            self.max_seq_len = parent.create_var(
                name=unique_name.generate("dynamic_rnn_max_seq_len"),
                dtype=VarDesc.VarType.INT64)
            parent.append_op(type="max_sequence_len",
                             inputs={"RankTable": [self.lod_rank_table]},
                             outputs={"Out": [self.max_seq_len]})
            parent.append_op(type="less_than",
                             inputs={"X": [self.step_idx],
                                     "Y": [self.max_seq_len]},
                             outputs={"Out": [self.cond]},
                             attrs={"force_cpu": True})
        input_array = parent.create_var(
            name=unique_name.generate("dynamic_rnn_input_array"),
            type=VarDesc.VarType.LOD_TENSOR_ARRAY, dtype=x.dtype)
        self.input_array.append((input_array, x.dtype))
        parent.append_op(type="lod_tensor_to_array",
                         inputs={"X": [x],
                                 "RankTable": [self.lod_rank_table]},
                         outputs={"Out": [input_array]})
        return array_read(input_array, self.step_idx)

    def static_input(self, x):
        self._assert_in_rnn_block_("static_input")
        if self.lod_rank_table is None:
            raise RuntimeError("static_input() needs step_input() first")
        parent = self._parent_block_()
        reordered = parent.create_var(
            name=unique_name.generate("dynamic_rnn_static_input_reordered"),
            dtype=x.dtype)
        parent.append_op(type="reorder_lod_tensor_by_rank",
                         inputs={"X": [x],
                                 "RankTable": [self.lod_rank_table]},
                         outputs={"Out": [reordered]})
        return shrink_memory(reordered, self.step_idx, self.lod_rank_table)

    def block(self):
        drnn = self

        class _Guard:
            def __enter__(self):
                if drnn.status != DynamicRNN.BEFORE_RNN:
                    raise ValueError("rnn.block() can only be entered once")
                from .tensor import fill_constant
                drnn.step_idx = fill_constant(shape=[1], dtype="int64",
                                              value=0, force_cpu=True)
                drnn.status = DynamicRNN.IN_RNN
                drnn._while_guard = drnn.while_op.block()
                drnn._while_guard.__enter__()
                return self

            def __exit__(self, et, ev, tb):
                if et is not None:
                    return False
                increment(drnn.step_idx, value=1.0, in_place=True)
                for new_mem, mem_array in drnn.mem_link:
                    array_write(new_mem, i=drnn.step_idx, array=mem_array)
                less_than(drnn.step_idx, drnn.max_seq_len, cond=drnn.cond)
                drnn._while_guard.__exit__(None, None, None)
                drnn.status = DynamicRNN.AFTER_RNN
                for arr in drnn.output_array:
                    drnn.outputs.append(
                        array_to_lod_tensor(arr, drnn.lod_rank_table))
                return False
        return _Guard()

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        self._assert_in_rnn_block_("memory")
        self._init_zero_idx_()
        parent = self._parent_block_()
        if init is not None:
            init_tensor = init
            if need_reorder and self.lod_rank_table is None:
                raise ValueError(
                    "memory(init=..., need_reorder=True) requires "
                    "step_input() to be called first")
            if need_reorder:
                reordered = parent.create_var(
                    name=unique_name.generate("dyn_rnn_mem_init_reordered"),
                    dtype=init.dtype)
                parent.append_op(
                    type="reorder_lod_tensor_by_rank",
                    inputs={"X": [init_tensor],
                            "RankTable": [self.lod_rank_table]},
                    outputs={"Out": [reordered]})
                init_tensor = reordered
            mem_array = parent.create_var(
                name=unique_name.generate("dynamic_rnn_mem_array"),
                type=VarDesc.VarType.LOD_TENSOR_ARRAY, dtype=init.dtype)
            parent.append_op(type="write_to_array",
                             inputs={"X": [init_tensor],
                                     "I": [self.zero_idx]},
                             outputs={"Out": [mem_array]})
        else:
            if not self.input_array:
                raise ValueError("step_input() must precede "
                                 "memory(shape=..., value=...)")
            arr, in_dtype = self.input_array[0]
            in0 = parent.create_var(name=unique_name.generate("in0"),
                                    dtype=in_dtype)
            parent.append_op(type="read_from_array",
                             inputs={"X": [arr], "I": [self.zero_idx]},
                             outputs={"Out": [in0]})
            from ..core import convert_np_dtype_to_dtype_
            init = parent.create_var(
                name=unique_name.generate("mem_init"),
                dtype=convert_np_dtype_to_dtype_(dtype))
            parent.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [in0]}, outputs={"Out": [init]},
                attrs={"shape": [-1] + list(shape), "value": float(value),
                       "dtype": convert_np_dtype_to_dtype_(dtype),
                       "input_dim_idx": 0, "output_dim_idx": 0})
            mem_array = parent.create_var(
                name=unique_name.generate("dynamic_rnn_mem_array"),
                type=VarDesc.VarType.LOD_TENSOR_ARRAY, dtype=init.dtype)
            parent.append_op(type="write_to_array",
                             inputs={"X": [init], "I": [self.zero_idx]},
                             outputs={"Out": [mem_array]})
        retv = array_read(mem_array, self.step_idx)
        retv = shrink_memory(retv, self.step_idx, self.lod_rank_table)
        self.mem_dict[retv.name] = mem_array
        return retv

    def update_memory(self, ex_mem, new_mem):
        self._assert_in_rnn_block_("update_memory")
        mem_array = self.mem_dict.get(ex_mem.name)
        if mem_array is None:
            raise ValueError("update_memory: ex_mem is not a memory()")
        self.mem_link.append((new_mem, mem_array))

    def output(self, *outputs):
        self._assert_in_rnn_block_("output")
        parent = self._parent_block_()
        for o in outputs:
            arr = parent.create_var(
                name=unique_name.generate("dynamic_rnn_output_array"),
                type=VarDesc.VarType.LOD_TENSOR_ARRAY, dtype=o.dtype)
            self.output_array.append(arr)
            array_write(o, i=self.step_idx, array=arr)

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("DynamicRNN outputs are available after "
                             "block() exits")
        return self.outputs[0] if len(self.outputs) == 1 else self.outputs


class IfElse:
    """Row-wise branching on a bool mask (reference control_flow.py IfElse):
    input() splits rows by cond into the active branch, output() records
    branch results, and __call__ merges them back in row order via
    merge_lod_tensor."""

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.input_table = {}
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        # outputs per branch, keyed output position -> {branch: var}
        self._branch_outputs = {True: [], False: []}

    class _Branch:
        def __init__(self, ie, is_true):
            self.ie = ie
            self.is_true = is_true

        def __enter__(self):
            self.ie.status = (IfElse.IN_IF_ELSE_TRUE_BLOCKS if self.is_true
                              else IfElse.IN_IF_ELSE_FALSE_BLOCKS)
            return self

        def __exit__(self, et, ev, tb):
            self.ie.status = IfElse.OUT_IF_ELSE_BLOCKS
            return False

    def true_block(self):
        return IfElse._Branch(self, True)

    def false_block(self):
        return IfElse._Branch(self, False)

    def input(self, x):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input() must be inside true_block/false_block")
        if x.name not in self.input_table:
            helper = self.helper
            t = helper.create_variable_for_type_inference(x.dtype)
            f = helper.create_variable_for_type_inference(x.dtype)
            helper.append_op(type="split_lod_tensor",
                             inputs={"X": [x], "Mask": [self.cond]},
                             outputs={"OutTrue": [t], "OutFalse": [f]},
                             attrs={"level": 0})
            self.input_table[x.name] = (t, f)
        t, f = self.input_table[x.name]
        return t if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS else f

    def output(self, *outs):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output() must be inside a branch block")
        branch = self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS
        self._branch_outputs[branch].extend(outs)

    def __call__(self):
        t_outs = self._branch_outputs[True]
        f_outs = self._branch_outputs[False]
        if len(t_outs) != len(f_outs):
            raise ValueError("true/false branches must output the same "
                             "number of variables")
        rlist = []
        for t, f in zip(t_outs, f_outs):
            o = self.helper.create_variable_for_type_inference(t.dtype)
            self.helper.append_op(
                type="merge_lod_tensor",
                inputs={"X": [self.cond], "Mask": [self.cond],
                        "InTrue": [t], "InFalse": [f]},
                outputs={"Out": [o]}, attrs={"level": 0})
            rlist.append(o)
        return rlist
