"""Legacy decoder API (reference: contrib/decoder/beam_search_decoder.py —
InitState:43, StateCell:159 with @state_updater, TrainingDecoder:384 over
StaticRNN, BeamSearchDecoder:~560 over a while loop with beam_search ops).

Counterpart of paddle_tpu/fluid/contrib/decoder/beam_search_decoder.py:
TrainingDecoder rides the framework's StaticRNN (the whole sequence
unrolled into the step's ops, one CUDA graph on the card);
BeamSearchDecoder's ``decode()`` builds one beam step, which the caller
runs from the host once a step, its beam_search op an island of the
segmented step, and beam_search_decode backtracks at the end.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ... import layers
from ...framework import Variable

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]


class InitState:
    """Initial decoder state spec (reference :43): either a boot Variable
    (e.g. encoder final state) or (shape, value) zeros-like spec."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is not None:
            self._init = layers.fill_constant_batch_size_like(
                init_boot, shape=shape, value=value, dtype=dtype)
        else:
            raise ValueError("init or init_boot must be provided")
        self._shape = shape
        self._need_reorder = need_reorder

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class StateCell:
    """Named-state RNN cell (reference :159). ``inputs`` maps input names
    to (possibly deferred) variables, ``states`` maps state names to
    InitState. The user decorates an updater::

        @cell.state_updater
        def updater(cell):
            h = cell.get_state('h'); x = cell.get_input('x')
            cell.set_state('h', some_layers(x, h))
    """

    def __init__(self, inputs: Dict[str, Optional[Variable]],
                 states: Dict[str, InitState], out_state: str, name=None):
        self._inputs = dict(inputs)
        self._init_states = dict(states)
        self._out_state = out_state
        self._cur_states: Dict[str, Variable] = {}
        self._updater: Optional[Callable] = None

    # -------------------------------------------------------------- wiring
    def state_updater(self, updater: Callable):
        self._updater = updater
        return updater

    def get_input(self, input_name: str) -> Variable:
        if input_name not in self._inputs or \
                self._inputs[input_name] is None:
            raise ValueError(f"input '{input_name}' not set")
        return self._inputs[input_name]

    def get_state(self, state_name: str) -> Variable:
        if state_name not in self._cur_states:
            raise ValueError(f"state '{state_name}' not initialized")
        return self._cur_states[state_name]

    def set_state(self, state_name: str, state_value: Variable):
        self._cur_states[state_name] = state_value

    def compute_state(self, inputs: Dict[str, Variable]):
        """Bind step inputs and run the updater (reference :335)."""
        for k, v in inputs.items():
            self._inputs[k] = v
        if self._updater is None:
            raise RuntimeError("no @state_updater registered")
        self._updater(self)

    def out_state(self) -> Variable:
        return self._cur_states[self._out_state]


class TrainingDecoder:
    """Teacher-forced decoding over StaticRNN (reference :384)::

        decoder = TrainingDecoder(cell)
        with decoder.block():
            x = decoder.step_input(trg_emb)
            cell.compute_state({'x': x})
            decoder.output(cell.out_state())
        outputs = decoder()
    """

    def __init__(self, state_cell: StateCell, name=None):
        self._state_cell = state_cell
        self._rnn = layers.StaticRNN()
        self._outputs: List[Variable] = []
        self._mems: Dict[str, Variable] = {}

    class _Guard:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            self.d._ctx = self.d._rnn.step()
            self.d._ctx.__enter__()
            # materialize states as StaticRNN memories
            for name, init in self.d._state_cell._init_states.items():
                mem = self.d._rnn.memory(init=init.value)
                self.d._mems[name] = mem
                self.d._state_cell._cur_states[name] = mem
            return self.d

        def __exit__(self, et, ev, tb):
            if et is not None:
                return False
            # wire state updates back into the rnn memories
            for name, mem in self.d._mems.items():
                new = self.d._state_cell._cur_states[name]
                if new is not mem:
                    self.d._rnn.update_memory(mem, new)
            return self.d._ctx.__exit__(et, ev, tb)

    def block(self):
        return TrainingDecoder._Guard(self)

    def step_input(self, x):
        return self._rnn.step_input(x)

    def static_input(self, x):
        return self._rnn.static_input(x) if hasattr(
            self._rnn, "static_input") else x

    def output(self, *outputs):
        self._rnn.output(*outputs)
        self._outputs = list(outputs)

    def __call__(self):
        return self._rnn()


class BeamSearchDecoder:
    """Beam decoding (reference :560): repeatedly expand candidates with
    the state cell, prune with the beam_search op, stop at end tokens, and
    backtrack with beam_search_decode.

    The decode loop runs on the host, one run of the step program a step
    (its compiled segments around the beam_search island), in place of
    the reference's while-op loop."""

    def __init__(self, state_cell: StateCell, init_ids, init_scores,
                 target_dict_dim, word_dim, input_var_dict=None,
                 topk_size=50, sparse_emb=True, max_len=100, beam_size=4,
                 end_id=1, name=None):
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._beam_size = beam_size
        self._end_id = end_id
        self._max_len = max_len
        self._word_dim = word_dim
        self._input_var_dict = input_var_dict or {}
        self._embedding_fn: Optional[Callable] = None
        self._scoring_fn: Optional[Callable] = None

    def embedding(self, fn: Callable):
        """Decorator: ids -> word embedding [B, word_dim]."""
        self._embedding_fn = fn
        return fn

    def scoring(self, fn: Callable):
        """Decorator: out_state -> vocab log-probs [B, V]."""
        self._scoring_fn = fn
        return fn

    def decode(self):
        """Build ONE decode step as graph ops: embeds pre_ids, advances the
        state cell, scores, prunes with beam_search. Returns
        (selected_ids, selected_scores, parent_idx) variables; drive it
        from the host loop and finish with beam_search_decode."""
        if self._embedding_fn is None or self._scoring_fn is None:
            raise RuntimeError(
                "register @decoder.embedding and @decoder.scoring first")
        # boot the named states from their InitState specs — overwriting
        # anything a previous TrainingDecoder left behind (its StaticRNN
        # memory placeholders are meaningless outside the training unroll;
        # the reference switches state holders per decoder the same way)
        for name, init in self._state_cell._init_states.items():
            self._state_cell._cur_states[name] = init.value
        pre_ids = self._init_ids
        pre_scores = self._init_scores
        x = self._embedding_fn(pre_ids)
        self._state_cell.compute_state(dict(self._input_var_dict, x=x))
        logits = self._scoring_fn(self._state_cell.out_state())
        probs = layers.softmax(logits)
        topk_scores, topk_ids = layers.topk(probs, k=self._beam_size)
        acc = layers.elementwise_add(
            layers.log(topk_scores),
            layers.reshape(pre_scores, [-1, 1]))
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_scores, topk_ids, acc,
            beam_size=self._beam_size, end_id=self._end_id,
            return_parent_idx=True)
        return sel_ids, sel_scores, parent

    def __call__(self, step_ids_array, step_scores_array):
        """Backtrack full beams (reference beam_search_decode)."""
        return layers.beam_search_decode(step_ids_array, step_scores_array,
                                         beam_size=self._beam_size,
                                         end_id=self._end_id)
