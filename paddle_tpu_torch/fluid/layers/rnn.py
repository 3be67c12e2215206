"""Recurrent layers (counterpart of paddle_tpu/fluid/layers/rnn.py;
reference: python/paddle/fluid/layers/rnn.py — RNNCell:33, GRUCell,
LSTMCell, rnn(), dynamic_decode:865, BeamSearchDecoder:224; layers/nn.py
dynamic_lstm:466, dynamic_lstmp:638, dynamic_gru:837, gru_unit:980,
lstm:1040 and lstm_unit).

The LoD recurrences (dynamic_lstm, dynamic_gru) are one op each over the
LoD batch padded to its longest sequence (ops/rnn_ops.py); ``rnn`` unrolls
a cell over padded input; ``dynamic_decode`` runs a static number of
steps, finished beams frozen by a score mask, and backtracks with
gather_tree, the same ops in the same order as the TPU package builds. The
reference's While + LoD beam search is here too (beam_search,
beam_search_decode: host ops)."""
from __future__ import annotations

__all__ = [
    "RNNCell", "GRUCell", "LSTMCell", "rnn", "Decoder", "BeamSearchDecoder",
    "dynamic_decode", "DecodeHelper", "TrainingHelper",
    "GreedyEmbeddingHelper", "SampleEmbeddingHelper", "BasicDecoder",
    "dynamic_lstm", "dynamic_lstmp", "dynamic_gru",
    "gru_unit", "lstm_unit", "lstm", "beam_search", "beam_search_decode",
    "gather_tree",
]

from .. import unique_name
from ..core import VarDesc
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


def _fixed_attr(attr, fallback_name):
    """Pin a param name so repeated cell calls (unrolled steps) share ONE
    parameter — create_parameter is idempotent per name."""
    if isinstance(attr, ParamAttr) and attr.name:
        return attr
    return ParamAttr(name=unique_name.generate(fallback_name))


def _cell_weight_attrs(attr, fallback_base):
    """TWO pinned names — input- and hidden-projection — for the cell's
    two-input fc: one shared name would tie Wx to Wh, and a copy without
    a name would make a fresh hidden weight at each unrolled step. A user
    list of attrs passes through; a single
    user attr keeps all its fields (initializer, trainable, ...) in both
    derived copies — only the names are suffixed."""
    from ..layer_helper import copy_attr
    if isinstance(attr, (list, tuple)):
        return list(attr)
    if isinstance(attr, ParamAttr):
        base = attr.name or unique_name.generate(fallback_base)
        ax, ah = copy_attr(attr), copy_attr(attr)
        ax.name, ah.name = base + "_x", base + "_h"
        return [ax, ah]
    base = unique_name.generate(fallback_base)
    return [ParamAttr(name=base + "_x"), ParamAttr(name=base + "_h")]


class RNNCell:
    def call(self, inputs, states, **kwargs):
        raise NotImplementedError

    def __call__(self, inputs, states, **kwargs):
        return self.call(inputs, states, **kwargs)

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        from .tensor import fill_constant_batch_size_like
        shape = shape or self.state_shape
        if isinstance(shape[0], (list, tuple)):
            return [fill_constant_batch_size_like(
                batch_ref, [-1] + list(s), dtype, init_value) for s in shape]
        return fill_constant_batch_size_like(
            batch_ref, [-1] + list(shape), dtype, init_value)

    @property
    def state_shape(self):
        raise NotImplementedError


class GRUCell(RNNCell):
    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, dtype="float32",
                 name="GRUCell"):
        self.hidden_size = hidden_size
        self._param_attr = _cell_weight_attrs(param_attr, name + "_w")
        self._bias_attr = (bias_attr if bias_attr is False
                           else _fixed_attr(bias_attr, name + "_b"))
        self._dtype = dtype
        self._name = name

    def call(self, inputs, states):
        from .nn import fc, split
        from . import ops
        h = states
        gates = fc([inputs, h], 3 * self.hidden_size,
                   param_attr=self._param_attr, bias_attr=self._bias_attr)
        r, z, c = split(gates, 3, dim=-1)
        r, z = ops.sigmoid(r), ops.sigmoid(z)
        c = ops.tanh(c)
        new_h = z * h + (1.0 - z) * c
        return new_h, new_h

    @property
    def state_shape(self):
        return [self.hidden_size]


class LSTMCell(RNNCell):
    def __init__(self, hidden_size, param_attr=None, bias_attr=None,
                 gate_activation=None, activation=None, forget_bias=1.0,
                 dtype="float32", name="LSTMCell"):
        self.hidden_size = hidden_size
        self._param_attr = _cell_weight_attrs(param_attr, name + "_w")
        self._bias_attr = (bias_attr if bias_attr is False
                           else _fixed_attr(bias_attr, name + "_b"))
        self._forget_bias = forget_bias
        self._dtype = dtype

    def call(self, inputs, states):
        from .nn import fc, split
        from . import ops
        h, c = states
        gates = fc([inputs, h], 4 * self.hidden_size,
                   param_attr=self._param_attr, bias_attr=self._bias_attr)
        i, f, o, j = split(gates, 4, dim=-1)
        i = ops.sigmoid(i)
        f = ops.sigmoid(f + self._forget_bias)
        o = ops.sigmoid(o)
        j = ops.tanh(j)
        new_c = c * f + i * j
        new_h = ops.tanh(new_c) * o
        return new_h, [new_h, new_c]

    @property
    def state_shape(self):
        return [[self.hidden_size], [self.hidden_size]]


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """Static unrolled RNN over padded input [B, T, D] (or [T, B, D] when
    time_major): the cell's ops once a step. LoD input goes to
    dynamic_lstm/dynamic_gru instead (one op over the whole batch)."""
    from .nn import transpose, stack, unstack
    if initial_states is None:
        initial_states = cell.get_initial_states(inputs)
    if not time_major:
        inputs_t = transpose(inputs,
                             [1, 0] + list(range(2, len(inputs.shape))))
    else:
        inputs_t = inputs
    steps = unstack(inputs_t, axis=0)
    if is_reverse:
        steps = steps[::-1]
    states = initial_states
    outs = []
    for x_t in steps:
        o, states = cell(x_t, states, **kwargs)
        outs.append(o)
    if is_reverse:
        outs = outs[::-1]
    outputs = stack(outs, axis=0)
    if not time_major:
        outputs = transpose(outputs,
                            [1, 0] + list(range(2, len(outputs.shape))))
    return outputs, states


# --------------------------------------------------------------------------
# LoD recurrent layers
# --------------------------------------------------------------------------
def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """input: packed LoD [T, 4H] (pre-projected); size = 4*hidden."""
    helper = LayerHelper("dynamic_lstm", **locals())
    H = size // 4
    weight = helper.create_parameter(attr=param_attr, shape=[H, 4 * H],
                                     dtype=dtype)
    bias_size = [1, 7 * H] if use_peepholes else [1, 4 * H]
    bias = helper.create_parameter(attr=bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    hidden.shape = (-1, H)
    cell.shape = (-1, H)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(type="dynamic_lstm", inputs=inputs,
                     outputs={"Hidden": [hidden], "Cell": [cell]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None, h_0=None, c_0=None,
                  cell_clip=None, proj_clip=None):
    helper = LayerHelper("dynamic_lstmp", **locals())
    H = size // 4
    P = proj_size
    weight = helper.create_parameter(attr=param_attr, shape=[P, 4 * H],
                                     dtype=dtype)
    proj_weight = helper.create_parameter(attr=None, shape=[H, P], dtype=dtype)
    bias_size = [1, 7 * H] if use_peepholes else [1, 4 * H]
    bias = helper.create_parameter(attr=bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    projection = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    projection.shape = (-1, P)
    cell.shape = (-1, H)
    inputs = {"Input": [input], "Weight": [weight],
              "ProjWeight": [proj_weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(type="dynamic_lstmp", inputs=inputs,
                     outputs={"Projection": [projection], "Cell": [cell]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation,
                            "proj_activation": proj_activation})
    return projection, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                name=None):
    """input: packed LoD [T, 3H]; size = hidden."""
    helper = LayerHelper("dynamic_gru", **locals())
    dtype = helper.input_dtype()
    weight = helper.create_parameter(attr=param_attr, shape=[size, 3 * size],
                                     dtype=dtype)
    bias = helper.create_parameter(attr=bias_attr, shape=[1, 3 * size],
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    hidden.shape = (-1, size)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(type="dynamic_gru", inputs=inputs,
                     outputs={"Hidden": [hidden]},
                     attrs={"is_reverse": is_reverse,
                            "origin_mode": origin_mode,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """Single GRU step; size = 3*hidden."""
    helper = LayerHelper("gru_unit", **locals())
    dtype = helper.input_dtype()
    H = size // 3
    weight = helper.create_parameter(attr=param_attr, shape=[H, 3 * H],
                                     dtype=dtype)
    bias = helper.create_parameter(attr=bias_attr, shape=[1, 3 * H],
                                   dtype=dtype, is_bias=True)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden_pre = helper.create_variable_for_type_inference(dtype)
    updated_hidden = helper.create_variable_for_type_inference(dtype)
    updated_hidden.shape = (-1, H)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden],
                "Weight": [weight], "Bias": [bias]},
        outputs={"Gate": [gate], "ResetHiddenPrev": [reset_hidden_pre],
                 "Hidden": [updated_hidden]},
        attrs={"activation": activation, "gate_activation": gate_activation,
               "origin_mode": origin_mode})
    return updated_hidden, reset_hidden_pre, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step over dense [N, D] input: fc([x, h]) + lstm_unit op."""
    from .nn import fc
    helper = LayerHelper("lstm_unit", **locals())
    H = hidden_t_prev.shape[-1]
    gates = fc([x_t, hidden_t_prev], 4 * H, param_attr=param_attr,
               bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    c.shape = tuple(cell_t_prev.shape)
    h.shape = tuple(cell_t_prev.shape)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [gates], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": forget_bias})
    return h, c


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """Dense multi-layer (bi)LSTM over [B, T, D]. Its weight is one flat
    parameter packing, per layer and direction in order, [Wx, Wh, b]
    (ops/rnn_ops.py). → (out [B, T, H·dirs], last_h, last_c)."""
    helper = LayerHelper("lstm", **locals())
    dtype = helper.input_dtype()
    D = input.shape[-1]
    H, L = hidden_size, num_layers
    dirs = 2 if is_bidirec else 1
    total = 0
    in_dim = D
    for _layer in range(L):
        total += dirs * (in_dim * 4 * H + H * 4 * H + 4 * H)
        in_dim = H * dirs
    w = helper.create_parameter(attr=None, shape=[total], dtype=dtype,
                                default_initializer=default_initializer)
    out_v = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    out_v.shape = tuple(input.shape[:-1]) + (H * dirs,)
    helper.append_op(
        type="lstm",
        inputs={"Input": [input], "W": [w], "InitH": [init_h],
                "InitC": [init_c]},
        outputs={"Out": [out_v], "LastH": [last_h], "LastC": [last_c]},
        attrs={"max_len": max_len, "hidden_size": H, "num_layers": L,
               "is_bidirec": is_bidirec, "dropout_prob": dropout_prob,
               "is_test": is_test, "input_size": D,
               "seed": seed if seed and seed > 0 else 0})
    return out_v, last_h, last_c


# --------------------------------------------------------------------------
# beam search (LoD host path)
# --------------------------------------------------------------------------
def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    helper = LayerHelper("beam_search", **locals())
    selected_ids = helper.create_variable_for_type_inference(
        VarDesc.VarType.INT64)
    selected_scores = helper.create_variable_for_type_inference(
        VarDesc.VarType.FP32)
    parent_idx = helper.create_variable_for_type_inference(
        VarDesc.VarType.INT64)
    inputs = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
              "scores": [scores]}
    if ids is not None:
        inputs["ids"] = [ids]
    helper.append_op(
        type="beam_search", inputs=inputs,
        outputs={"selected_ids": [selected_ids],
                 "selected_scores": [selected_scores],
                 "parent_idx": [parent_idx]},
        attrs={"level": level, "beam_size": beam_size, "end_id": end_id,
               "is_accumulated": is_accumulated})
    if return_parent_idx:
        return selected_ids, selected_scores, parent_idx
    return selected_ids, selected_scores


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    helper = LayerHelper("beam_search_decode", **locals())
    sentence_ids = helper.create_variable_for_type_inference(
        VarDesc.VarType.INT64)
    sentence_scores = helper.create_variable_for_type_inference(
        VarDesc.VarType.FP32)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores]},
        outputs={"SentenceIds": [sentence_ids],
                 "SentenceScores": [sentence_scores]},
        attrs={"beam_size": beam_size, "end_id": end_id})
    return sentence_ids, sentence_scores


def gather_tree(ids, parents):
    helper = LayerHelper("gather_tree")
    out = helper.create_variable_for_type_inference(ids.dtype)
    helper.append_op(type="gather_tree",
                     inputs={"Ids": [ids], "Parents": [parents]},
                     outputs={"Out": [out]})
    return out


# --------------------------------------------------------------------------
# decode helpers (reference rnn.py DecodeHelper:1375, TrainingHelper:1444,
# GreedyEmbeddingHelper:1597, SampleEmbeddingHelper:1728, BasicDecoder:1829)
#
# dynamic_decode runs a static number of steps, unrolled, as in the TPU
# package: ``time`` reaches the helpers as a Python int instead of the
# reference's int64 Variable, so their slices are static.
# --------------------------------------------------------------------------
class DecodeHelper:
    """Sampling + next-step-input strategy plugged into BasicDecoder."""

    def initialize(self):
        """-> (initial_inputs, initial_finished)."""
        raise NotImplementedError

    def sample(self, time, outputs, states):
        """-> int64 sample ids for the current step."""
        raise NotImplementedError

    def next_inputs(self, time, outputs, states, sample_ids):
        """-> (finished, next_inputs, next_states)."""
        raise NotImplementedError


class TrainingHelper(DecodeHelper):
    """Teacher-forcing helper: step inputs are slices of the full target
    sequence; sample() is argmax (ids mostly unused)."""

    def __init__(self, inputs, sequence_length, time_major=False):
        self.inputs = inputs
        self.sequence_length = sequence_length
        self.time_major = time_major

    def _slice(self, t):
        from .. import layers as L
        axis = 0 if self.time_major else 1
        T = self.inputs.shape[axis]
        t = min(t, T - 1)  # clamp instead of the reference's pad-by-one
        return L.squeeze(L.slice(self.inputs, axes=[axis], starts=[t],
                                 ends=[t + 1]), [axis])

    def initialize(self):
        from .. import layers as L
        zero = L.fill_constant([1], self.sequence_length.dtype, 0)
        return self._slice(0), L.equal(self.sequence_length, zero)

    def sample(self, time, outputs, states):
        from .. import layers as L
        return L.cast(L.argmax(outputs, axis=-1), "int64")

    def next_inputs(self, time, outputs, states, sample_ids):
        from .. import layers as L
        nxt = L.fill_constant([1], self.sequence_length.dtype,
                              int(time) + 1)
        finished = L.less_equal(self.sequence_length, nxt)
        return finished, self._slice(int(time) + 1), states


class GreedyEmbeddingHelper(DecodeHelper):
    """Inference helper: argmax ids fed back through an embedding."""

    def __init__(self, embedding_fn, start_tokens, end_token):
        from .. import layers as L
        self.embedding_fn = embedding_fn
        self.start_tokens = start_tokens
        self.end_token = L.fill_constant([1], "int64", end_token)

    def initialize(self):
        from .. import layers as L
        finished = L.cast(L.zeros_like(self.start_tokens), "bool")
        return self.embedding_fn(self.start_tokens), finished

    def sample(self, time, outputs, states):
        from .. import layers as L
        return L.cast(L.argmax(outputs, axis=-1), "int64")

    def next_inputs(self, time, outputs, states, sample_ids):
        from .. import layers as L
        finished = L.equal(sample_ids, self.end_token)
        return finished, self.embedding_fn(sample_ids), states


class SampleEmbeddingHelper(GreedyEmbeddingHelper):
    """Like GreedyEmbeddingHelper but draws from softmax(logits/T)."""

    def __init__(self, embedding_fn, start_tokens, end_token,
                 softmax_temperature=None, seed=None):
        super().__init__(embedding_fn, start_tokens, end_token)
        self.softmax_temperature = softmax_temperature
        self.seed = seed

    def sample(self, time, outputs, states):
        from .. import layers as L
        logits = outputs
        if self.softmax_temperature is not None:
            logits = L.scale(logits,
                             scale=1.0 / float(self.softmax_temperature))
        probs = L.softmax(logits)
        probs.stop_gradient = True
        return L.sampling_id(probs, seed=self.seed or 0)


# --------------------------------------------------------------------------
# tensor-based decode
# --------------------------------------------------------------------------
class Decoder:
    """Base decoder interface (reference rnn.py Decoder:132)."""


class BeamSearchDecoder(Decoder):
    """Dense beam-search decoder (reference rnn.py BeamSearchDecoder:224).

    embedding_fn: ids [N, 1] -> embeddings; output_fn: cell output ->
    vocab logits. Used with dynamic_decode below."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


class BasicDecoder(Decoder):
    """Cell + DecodeHelper assembly (reference rnn.py BasicDecoder:1829):
    step = cell.call → output_fn → helper.sample → helper.next_inputs."""
    import collections as _collections
    OutputWrapper = _collections.namedtuple("OutputWrapper",
                                            ("cell_outputs", "sample_ids"))

    def __init__(self, cell, helper, output_fn=None):
        self.cell = cell
        self.helper = helper
        self.output_fn = output_fn

    def initialize(self, initial_cell_states):
        initial_inputs, initial_finished = self.helper.initialize()
        return initial_inputs, initial_cell_states, initial_finished

    def step(self, time, inputs, states, **kwargs):
        cell_outputs, cell_states = self.cell(inputs, states, **kwargs)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        sample_ids = self.helper.sample(time=time, outputs=cell_outputs,
                                        states=cell_states)
        sample_ids.stop_gradient = True
        finished, next_inputs, next_states = self.helper.next_inputs(
            time=time, outputs=cell_outputs, states=cell_states,
            sample_ids=sample_ids)
        return (self.OutputWrapper(cell_outputs, sample_ids), next_states,
                next_inputs, finished)


def _dynamic_decode_generic(decoder, inits, max_step_num,
                            output_time_major, return_length=False,
                            **kwargs):
    """decoder.initialize/step protocol (BasicDecoder et al.) under the
    same static-trip-count inversion: `time` is a Python int, finished
    status latches via logical_or, outputs are stacked over time.
    Returns (outputs_structure, final_states) like the reference, plus
    the decode lengths when return_length (the step emitting the end
    token counts, later steps don't)."""
    from .. import layers as L
    if max_step_num is None:
        max_step_num = 32
    inputs, states, finished = decoder.initialize(inits)
    steps = []
    lengths = None
    for t in range(int(max_step_num)):
        outputs, states, inputs, step_fin = decoder.step(
            t, inputs, states, **kwargs)
        alive = L.cast(L.logical_not(finished), "int64")
        lengths = alive if lengths is None \
            else L.elementwise_add(lengths, alive)
        finished = L.logical_or(finished, step_fin)
        steps.append(outputs)

    def _stack(field_vals):
        s = L.stack(list(field_vals), axis=0)          # [T, B, ...]
        if not output_time_major:
            s = L.transpose(s, [1, 0] + list(range(2, len(s.shape))))
        return s

    first = steps[0]
    if hasattr(first, "_fields"):  # namedtuple of per-step tensors
        final = type(first)(*[_stack([getattr(s, f) for s in steps])
                              for f in first._fields])
    else:
        final = _stack(steps)
    if return_length:
        return final, states, lengths
    return final, states


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, return_length=False, **kwargs):
    """Decode with a static trip count, unrolled (the reference's While
    loop, rnn.py dynamic_decode:865, as the TPU package builds it).
    BeamSearchDecoder: every step extends all beams; finished beams are
    frozen by score masking; gather_tree backtracks at the end; returns
    (predicted_ids [B, T, beam], final_scores [B, beam]). Decoders
    exposing the initialize/step protocol (BasicDecoder) return
    (outputs_structure, final_states[, lengths when return_length])."""
    if not isinstance(decoder, BeamSearchDecoder) and \
            hasattr(decoder, "initialize") and hasattr(decoder, "step"):
        return _dynamic_decode_generic(decoder, inits, max_step_num,
                                       output_time_major, return_length,
                                       **kwargs)
    from .. import layers as L
    from ..layers import (
        topk, reshape, expand, unsqueeze, squeeze, transpose, cast, gather,
        stack, elementwise_add, elementwise_mul, elementwise_sub,
        elementwise_mod, elementwise_floordiv, fill_constant_batch_size_like,
        one_hot, slice, cumsum, zeros_like, equal, fill_constant)
    nn = L
    if max_step_num is None:
        max_step_num = 32
    cell = decoder.cell
    beam = decoder.beam_size
    end = decoder.end_token

    states = inits
    if not isinstance(states, (list, tuple)):
        states = [states]

    def tile(x):
        h = x.shape[-1]
        t = unsqueeze(x, [1])                     # [B, 1, H]
        t = expand(t, [1, beam, 1])               # [B, beam, H]
        return reshape(t, [-1, h])                # [B*beam, H]

    flat_states = [tile(s) for s in states]
    ref = flat_states[0]

    step_ids, step_parents = [], []
    token, scores = None, None
    for t in range(max_step_num):
        if t == 0:
            inp_tok = fill_constant_batch_size_like(
                ref, [-1, 1], "int64", decoder.start_token)
        else:
            inp_tok = reshape(token, [-1, 1])
        emb = decoder.embedding_fn(inp_tok)
        emb = reshape(emb, [-1, emb.shape[-1]])
        packed = flat_states if len(flat_states) > 1 else flat_states[0]
        cell_out, new_states = cell(emb, packed, **kwargs)
        flat_states = (list(new_states)
                       if isinstance(new_states, (list, tuple))
                       else [new_states])
        logits = (decoder.output_fn(cell_out) if decoder.output_fn
                  else cell_out)
        V = logits.shape[-1]
        logp = nn.log(nn.softmax(logits))          # [B*beam, V]
        logp3 = reshape(logp, [-1, beam, V])
        if t == 0:
            first = squeeze(slice(logp3, axes=[1], starts=[0], ends=[1]), [1])
            scores, token = topk(first, beam)      # [B, beam]
            parent = zeros_like(token)
        else:
            fin = cast(equal(token,
                             fill_constant([1], "int64", end)), "float32")
            fin3 = unsqueeze(fin, [2])             # [B, beam, 1]
            end_row = one_hot(
                reshape(fill_constant([1], "int64", end), [1, 1]), V)
            end_mask = elementwise_sub(
                elementwise_mul(end_row, fill_constant([1], "float32", 1e9)),
                fill_constant([1], "float32", 1e9))  # 0 at end, -1e9 else
            step_scores = elementwise_add(
                elementwise_mul(logp3, 1.0 - fin3),
                elementwise_mul(
                    expand(reshape(end_mask, [1, 1, V]),
                           [1, beam, 1]), fin3))
            total = elementwise_add(unsqueeze(scores, [2]), step_scores)
            flat = reshape(total, [-1, beam * V])
            scores, flat_idx = topk(flat, beam)    # [B, beam]
            vconst = fill_constant([1], "int64", V)
            parent = elementwise_floordiv(flat_idx, vconst)
            token = elementwise_mod(flat_idx, vconst)
            # reorder states to follow the selected parents:
            # abs_row = batch_idx * beam + parent
            ones = fill_constant_batch_size_like(scores, [-1, beam],
                                                 "int64", 1)
            batch_pos = elementwise_sub(cumsum(ones, axis=0), ones)
            abs_idx = reshape(
                elementwise_add(
                    elementwise_mul(batch_pos,
                                    fill_constant([1], "int64", beam)),
                    parent), [-1])
            flat_states = [gather(s, abs_idx) for s in flat_states]
        step_ids.append(token)
        step_parents.append(parent)
    ids_t = stack(step_ids, axis=0)                # [T, B, beam]
    parents_t = stack(step_parents, axis=0)
    predicted = gather_tree(ids_t, parents_t)
    if not output_time_major:
        predicted = transpose(predicted, [1, 0, 2])
    return predicted, scores
