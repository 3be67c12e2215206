"""Control-flow layers (counterpart of paddle_tpu/fluid/layers/
control_flow.py; reference: python/paddle/fluid/layers/control_flow.py).
So far: the comparisons, increment, the tensor arrays (create_array,
array_write, array_read, array_length), While, while_loop, cond, case,
switch_case, Switch, Print, Assert and is_empty. StaticRNN, DynamicRNN,
IfElse and the LoD rank-table layers need LoD sequences and come with
ROADMAP A7.

A sub-block is built as the reference builds it: ``Program._create_block``
makes it the current block, the layers called inside append to it, and
``_rollback`` returns to its parent, which gets the control-flow op with
the sub-block as its ``sub_block`` attr and the names the sub-block reads
from outside (``X``/``Input``) and writes (``Out``). How the executor runs
them: a conditional runs inside the step's CUDA graph (both branches, the
taken one's writes selected on the device), a ``while`` is a host-driven
loop of body replays, and a random op inside a conditional sends the block
to the segmented path, where the conditional runs in the interpreter
(fluid/executor.py)."""
from __future__ import annotations

from ..core import VarDesc
from ..framework import Variable, default_main_program
from ..layer_helper import LayerHelper

__all__ = [
    "While", "Switch", "increment", "array_write", "create_array",
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "array_read", "array_length", "cond", "Print", "Assert",
    "is_empty", "case", "switch_case", "while_loop",
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
