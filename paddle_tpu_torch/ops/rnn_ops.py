"""Recurrent ops (counterpart of paddle_tpu/ops/rnn_ops.py; reference:
paddle/fluid/operators/lstm_op.cc, lstmp_op.cc, gru_op.cc,
gru_unit_op.cc, lstm_unit_op.cc, cudnn_lstm_op.cc, gather_tree_op.cc,
beam_search_op.cc, beam_search_decode_op.cc): the LoD recurrences
``dynamic_lstm``, ``dynamic_lstmp``, ``dynamic_gru`` (and the reference's
names ``gru`` and ``lstmp`` for the same kernels), the single steps
``gru_unit`` and ``lstm_unit``, the fused dense multi-layer ``lstm``, the
beam backtrace ``gather_tree`` and the LoD beam search's host ops
``beam_search`` and ``beam_search_decode``.

Gates are ordered [i, f, c̃, o] along the last axis for the LSTMs and
[u, r, c̃] for the GRUs, as in the TPU package. The recurrence is a loop
over time inside the op. A LoD recurrence pads its packed rows to
[N, maxT, ·] by a row gather whose index is made on the host from the LoD
(``sequence_ops._const``: a compiled plan binds it at its first, eager,
run), and a mask freezes each sequence's state past its own end; maxT is
static for a plan, whose key holds the feed's LoD, so a CUDA graph
captures the whole loop. Every row gather goes through
``tensor_ops.take_rows``, whose grad sums in a fixed order. The grads are
the generic ones, torch autograd over the loop.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng
from .registry import register_op, first, out
from .sequence_ops import _const, _once
from .tensor_ops import take_rows


# --------------------------------------------------------------------------
# LoD pack <-> pad (host-made indices)
# --------------------------------------------------------------------------
def _offs_of(attrs, slot):
    vals = (attrs.get("_lod") or {}).get(slot)
    if not vals or vals[0] is None:
        raise ValueError(f"rnn op: input '{slot}' must carry LoD")
    return np.asarray(vals[0][-1], np.int64)


def _pad_index(offs):
    """([N, maxT] packed row of each padded slot, 0 where padded;
    [N, maxT] validity)."""
    lens = offs[1:] - offs[:-1]
    maxlen = int(lens.max()) if len(lens) else 0
    pos = np.arange(maxlen)[None, :]
    valid = pos < lens[:, None]
    return np.where(valid, pos + offs[:-1, None], 0), valid


def _unpad_index(offs, maxlen):
    """The row of the flattened [N·maxT] padded tensor of each packed row,
    in LoD order."""
    lens = offs[1:] - offs[:-1]
    if not len(lens):
        return np.zeros(0, np.int64)
    return np.concatenate([i * maxlen + np.arange(int(n))
                           for i, n in enumerate(lens)]).astype(np.int64)


def _reverse_index(offs):
    """Each sequence's rows in reverse order, in place."""
    n = len(offs) - 1
    if not n:
        return np.zeros(0, np.int64)
    return np.concatenate([np.arange(offs[i + 1] - 1, offs[i] - 1, -1)
                           for i in range(n)]).astype(np.int64)


def _pad_from_lod(attrs, x, offs):
    """packed [T, D] → (padded [N, maxT, D], zero where padded; the
    validity mask [N, maxT], bool, on x's device)."""
    part = _once(lambda: _pad_index(offs))
    idx = _const(attrs, "rnn_pad_idx", lambda: part(0), x.device)
    valid = _const(attrs, "rnn_pad_valid", lambda: part(1), x.device)
    padded = take_rows(x, idx)
    return padded * valid[..., None].to(x.dtype), valid


def _unpad_to_packed(attrs, padded, offs, tag):
    """padded [N, maxT, D] → packed [T, D] in LoD row order."""
    n, maxlen = padded.shape[0], padded.shape[1]
    idx = _const(attrs, tag, lambda: _unpad_index(offs, maxlen),
                 padded.device)
    return take_rows(padded.reshape((n * maxlen,) + tuple(padded.shape[2:])),
                     idx)


def _act(name):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "relu": torch.relu, "identity": (lambda v: v),
            "": torch.tanh}[name or "tanh"]


# --------------------------------------------------------------------------
# the masked loops over padded time (the TPU package's lax.scan cores)
# --------------------------------------------------------------------------
def _lstm_scan(xw, h0, c0, w_rec, bias, mask, gate_act, cell_act, cand_act,
               peephole=None, proj=None, proj_act="tanh"):
    """xw [N, T, 4H] the projected input; w_rec [H, 4H], or [P, 4H] for
    lstmp, whose recurrent state is its P-wide projection (reference
    lstmp_op.h projects inside the recurrence); mask [N, T] bool. A step
    past a sequence's end keeps its state. → padded (the H- or P-wide
    state, C), each [N, T, ·]."""
    H = w_rec.shape[1] // 4
    ga, ca, na = _act(gate_act), _act(cell_act), _act(cand_act)
    pa = _act(proj_act)
    b = bias.reshape(1, -1)[:, :4 * H] if bias is not None else None
    h, c = h0, c0
    hs, cs = [], []
    for t in range(xw.shape[1]):
        g = xw[:, t] + h @ w_rec
        if b is not None:
            g = g + b
        i, f, cc, o = g.chunk(4, dim=-1)
        if peephole is not None:
            w_ic, w_fc, w_oc = peephole
            i = i + c * w_ic
            f = f + c * w_fc
        i, f = ga(i), ga(f)
        c_new = f * c + i * na(cc)
        if peephole is not None:
            o = o + c_new * w_oc
        h_new = ga(o) * ca(c_new)
        if proj is not None:
            h_new = pa(h_new @ proj)
        m = mask[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


def _gru_scan(xw, h0, w, bias, mask, gate_act, cand_act, origin_mode):
    """xw [N, T, 3H]; w [H, 3H]: update and reset in its first 2H columns,
    the candidate in the last H. → the padded state [N, T, H]."""
    H = w.shape[0]
    ga, na = _act(gate_act), _act(cand_act)
    w_ur, w_c = w[:, :2 * H], w[:, 2 * H:]
    b = bias.reshape(1, -1) if bias is not None else None
    h = h0
    hs = []
    for t in range(xw.shape[1]):
        x_t = xw[:, t]
        if b is not None:
            x_t = x_t + b
        u, r = ga(x_t[:, :2 * H] + h @ w_ur).chunk(2, dim=-1)
        c = na(x_t[:, 2 * H:] + (r * h) @ w_c)
        if origin_mode:
            h_new = u * h + (1.0 - u) * c
        else:
            h_new = (1.0 - u) * h + u * c
        h = torch.where(mask[:, t, None], h_new, h)
        hs.append(h)
    return torch.stack(hs, 1)


def _reversed_rows(attrs, x, offs):
    """``x`` with each sequence's rows reversed (``is_reverse``: the
    recurrence starts at a sequence's own last row)."""
    return take_rows(x, _const(attrs, "rnn_rev_idx",
                               lambda: _reverse_index(offs), x.device))


# --------------------------------------------------------------------------
# dynamic_lstm / dynamic_lstmp (reference: lstm_op.cc, lstmp_op.cc)
# --------------------------------------------------------------------------
def _dyn_lstm_common(ins, attrs, proj_weight=None):
    """The LSTM over the LoD sequences of Input (packed [T, 4H], the
    projected input): with ``use_peepholes`` the bias is [1, 7H], its last
    3H the peephole weights. → packed (state, C)."""
    x = first(ins, "Input")
    w, bias = first(ins, "Weight"), first(ins, "Bias")
    h0, c0 = first(ins, "H0"), first(ins, "C0")
    offs = _offs_of(attrs, "Input")
    H = w.shape[1] // 4
    n = len(offs) - 1
    peep = None
    if attrs.get("use_peepholes", False) and bias is not None:
        b = bias.reshape(-1)
        peep = (b[4 * H:5 * H], b[5 * H:6 * H], b[6 * H:7 * H])
    rev = attrs.get("is_reverse", False)
    if rev:
        x = _reversed_rows(attrs, x, offs)
    padded, valid = _pad_from_lod(attrs, x, offs)
    if h0 is None:
        h0 = torch.zeros((n, w.shape[0]), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((n, H), dtype=x.dtype, device=x.device)
    hs, cs = _lstm_scan(
        padded, h0, c0, w, bias, valid,
        attrs.get("gate_activation", "sigmoid"),
        attrs.get("cell_activation", "tanh"),
        attrs.get("candidate_activation", "tanh"), peephole=peep,
        proj=proj_weight, proj_act=attrs.get("proj_activation", "identity"))
    h = _unpad_to_packed(attrs, hs, offs, "rnn_unpad_idx")
    c = _unpad_to_packed(attrs, cs, offs, "rnn_unpad_idx")
    if rev:
        h, c = _reversed_rows(attrs, h, offs), _reversed_rows(attrs, c, offs)
    return h, c


@register_op("dynamic_lstm", needs_lod=True,
             diff_inputs=["Input", "Weight", "Bias", "H0", "C0"],
             attr_defaults={"use_peepholes": True, "is_reverse": False,
                            "gate_activation": "sigmoid",
                            "cell_activation": "tanh",
                            "candidate_activation": "tanh"})
def _dynamic_lstm(ins, attrs):
    h, c = _dyn_lstm_common(ins, attrs)
    lod = attrs["_lod"]["Input"][0]
    return {"Hidden": [h], "Cell": [c],
            "_lod": {"Hidden": [lod], "Cell": [lod]}}


_LSTMP_ATTRS = {"use_peepholes": True, "is_reverse": False,
                "gate_activation": "sigmoid", "cell_activation": "tanh",
                "candidate_activation": "tanh", "proj_activation": "tanh"}


@register_op("dynamic_lstmp", needs_lod=True,
             diff_inputs=["Input", "Weight", "ProjWeight", "Bias", "H0",
                          "C0"], attr_defaults=_LSTMP_ATTRS)
def _dynamic_lstmp(ins, attrs):
    """The LSTM whose recurrent state is its output projected by
    ProjWeight [H, P] through ``proj_activation``."""
    h, c = _dyn_lstm_common(ins, attrs, proj_weight=first(ins, "ProjWeight"))
    lod = attrs["_lod"]["Input"][0]
    return {"Projection": [h], "Cell": [c],
            "_lod": {"Projection": [lod], "Cell": [lod]}}


# --------------------------------------------------------------------------
# dynamic_gru (reference: gru_op.cc)
# --------------------------------------------------------------------------
_GRU_ATTRS = {"is_reverse": False, "origin_mode": False,
              "gate_activation": "sigmoid", "activation": "tanh"}


@register_op("dynamic_gru", needs_lod=True,
             diff_inputs=["Input", "Weight", "Bias", "H0"],
             attr_defaults=_GRU_ATTRS)
def _dynamic_gru(ins, attrs):
    """The GRU over the LoD sequences of Input (packed [T, 3H]); Weight
    [H, 3H]; ``origin_mode`` h = u·h_prev + (1-u)·c̃, else (1-u)·h_prev +
    u·c̃."""
    x = first(ins, "Input")
    w, bias, h0 = first(ins, "Weight"), first(ins, "Bias"), first(ins, "H0")
    offs = _offs_of(attrs, "Input")
    rev = attrs.get("is_reverse", False)
    if rev:
        x = _reversed_rows(attrs, x, offs)
    padded, valid = _pad_from_lod(attrs, x, offs)
    if h0 is None:
        h0 = torch.zeros((len(offs) - 1, w.shape[0]), dtype=x.dtype,
                         device=x.device)
    hs = _gru_scan(padded, h0, w, bias, valid,
                   attrs.get("gate_activation", "sigmoid"),
                   attrs.get("activation", "tanh"),
                   attrs.get("origin_mode", False))
    h = _unpad_to_packed(attrs, hs, offs, "rnn_unpad_idx")
    if rev:
        h = _reversed_rows(attrs, h, offs)
    lod = attrs["_lod"]["Input"][0]
    return {"Hidden": [h], "_lod": {"Hidden": [lod]}}


# the reference's op names for the same kernels (gru_op.cc, lstmp_op.cc):
# serialized reference programs use them
register_op("gru", needs_lod=True, diff_inputs=["Input", "Weight", "Bias",
                                                "H0"],
            attr_defaults=_GRU_ATTRS)(_dynamic_gru)
register_op("lstmp", needs_lod=True,
            diff_inputs=["Input", "Weight", "ProjWeight", "Bias", "H0", "C0"],
            attr_defaults=_LSTMP_ATTRS)(_dynamic_lstmp)


@register_op("gru_unit", diff_inputs=["Input", "HiddenPrev", "Weight",
                                      "Bias"],
             attr_defaults={"activation": "tanh",
                            "gate_activation": "sigmoid",
                            "origin_mode": False})
def _gru_unit(ins, attrs):
    """One GRU step from Input [N, 3H] (projected) and HiddenPrev [N, H]:
    Gate [u, r, c̃], ResetHiddenPrev r·h_prev, Hidden."""
    x, h_prev = first(ins, "Input"), first(ins, "HiddenPrev")
    w, bias = first(ins, "Weight"), first(ins, "Bias")
    H = w.shape[0]
    ga, na = _act(attrs.get("gate_activation")), _act(attrs.get("activation"))
    if bias is not None:
        x = x + bias.reshape(1, -1)
    u, r = ga(x[:, :2 * H] + h_prev @ w[:, :2 * H]).chunk(2, dim=-1)
    reset_h = r * h_prev
    c = na(x[:, 2 * H:] + reset_h @ w[:, 2 * H:])
    if attrs.get("origin_mode", False):
        h = u * h_prev + (1.0 - u) * c
    else:
        h = (1.0 - u) * h_prev + u * c
    return out(Gate=torch.cat([u, r, c], -1), ResetHiddenPrev=reset_h,
               Hidden=h)


def _lstm_layer(xw, h, c, wh, b):
    """One direction of one layer: ``xw`` [B, T, 4H] the projected input,
    ``h``, ``c`` [B, H] the initial state, ``wh`` [H, 4H], ``b`` [4H]. →
    (hs, cs), each [B, T, H]."""
    hs, cs = [], []
    for t in range(xw.shape[1]):
        g = xw[:, t] + h @ wh + b
        i, f, cc, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cc)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


@register_op("lstm", needs_rng=True,
             diff_inputs=["Input", "W", "InitH", "InitC"],
             attr_defaults={"max_len": 0, "hidden_size": 0, "num_layers": 1,
                            "is_bidirec": False, "dropout_prob": 0.0,
                            "input_size": 0, "is_test": False, "seed": 0})
def _lstm(ins, attrs):
    """Dense multi-layer (bi)LSTM over [B, T, D]. The flat W packs, per
    layer and direction in that order, [Wx (in × 4H), Wh (H × 4H), b
    (4H)]; the reverse direction runs on the input flipped in time and
    its output is flipped back. LastH and LastC [L·dirs, B, H] hold each
    direction's state after its last step. Between layers, when
    ``is_test`` is false, dropout at ``dropout_prob`` (upscaled), its
    keep mask drawn from the op's key for each layer."""
    x = first(ins, "Input")
    w = first(ins, "W").reshape(-1)
    init_h, init_c = first(ins, "InitH"), first(ins, "InitC")
    H = int(attrs["hidden_size"])
    L = int(attrs.get("num_layers", 1))
    dirs = 2 if attrs.get("is_bidirec", False) else 1
    p = float(attrs.get("dropout_prob", 0.0))
    ptr = 0
    layer_in = x
    last_h, last_c = [], []
    for layer in range(L):
        outs = []
        d_in = layer_in.shape[-1]
        for d in range(dirs):
            wx = w[ptr:ptr + d_in * 4 * H].reshape(d_in, 4 * H)
            ptr += d_in * 4 * H
            wh = w[ptr:ptr + H * 4 * H].reshape(H, 4 * H)
            ptr += H * 4 * H
            b = w[ptr:ptr + 4 * H]
            ptr += 4 * H
            inp = layer_in.flip(1) if d == 1 else layer_in
            hs, cs = _lstm_layer(inp @ wx, init_h[layer * dirs + d],
                                 init_c[layer * dirs + d], wh, b)
            last_h.append(hs[:, -1])
            last_c.append(cs[:, -1])
            outs.append(hs.flip(1) if d == 1 else hs)
        layer_in = torch.cat(outs, -1) if dirs == 2 else outs[0]
        if p and not attrs.get("is_test", False) and layer < L - 1:
            keep = rng.keep_mask(rng.subkey(attrs["_rng"](), layer),
                                 layer_in.shape, p)
            layer_in = torch.where(keep, layer_in / (1.0 - p),
                                   torch.zeros_like(layer_in))
    return out(Out=layer_in, LastH=torch.stack(last_h),
               LastC=torch.stack(last_c))


@register_op("lstm_unit", diff_inputs=["X", "C_prev"],
             attr_defaults={"forget_bias": 0.0})
def _lstm_unit(ins, attrs):
    """One LSTM step from the pre-projected gates X [N, 4H] and C_prev:
    C = σ(f + forget_bias)·C_prev + σ(i)·tanh(c̃), H = σ(o)·tanh(C)."""
    x, c_prev = first(ins, "X"), first(ins, "C_prev")
    i, f, cc, o = x.chunk(4, dim=-1)
    f = f + attrs.get("forget_bias", 0.0)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(cc)
    return out(C=c, H=torch.sigmoid(o) * torch.tanh(c))


# --------------------------------------------------------------------------
# gather_tree (reference: gather_tree_op.cc, the beam backtrace)
# --------------------------------------------------------------------------
@register_op("gather_tree", no_grad=True)
def _gather_tree(ins, attrs):
    """Ids and Parents [T, batch, beam] → each final beam's tokens, read
    back from the last step through its parents."""
    ids, parents = first(ins, "Ids"), first(ins, "Parents").long()
    parent = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:])
    toks = []
    for t in range(ids.shape[0] - 1, -1, -1):
        toks.append(torch.gather(ids[t], 1, parent))
        parent = torch.gather(parents[t], 1, parent)
    return out(Out=torch.stack(toks[::-1]))


# --------------------------------------------------------------------------
# beam_search / beam_search_decode (reference: beam_search_op.cc,
# beam_search_decode_op.cc, the LoD While-loop decode of v1.6 scripts):
# host ops, stateful, as in the TPU package: how many rows they select
# depends on the values
# --------------------------------------------------------------------------
def _host(t):
    return t.detach().cpu().numpy()


@register_op("beam_search", needs_lod=True, stateful=True, no_grad=True,
             attr_defaults={"level": 0, "beam_size": 1, "end_id": 0,
                            "is_accumulated": True})
def _beam_search(ins, attrs):
    """One beam step: for each source (pre_ids' first LoD level, or one
    source of every branch) the ``beam_size`` best of its branches'
    candidates (a branch whose pre_id is ``end_id`` carries itself on
    with its score), ranked by a stable sort on -score in (branch, k)
    order, then grouped by parent branch, best first. selected_ids and
    selected_scores [n, 1] carry a two-level LoD (sources, then rows of
    each branch), parent_idx each row's branch."""
    pre = first(ins, "pre_ids")
    pre_ids = _host(pre).reshape(-1)
    pre_scores = _host(first(ins, "pre_scores")).reshape(-1)
    ids_in = first(ins, "ids")
    cand_ids = _host(ids_in) if ids_in is not None else None
    cand_scores = _host(first(ins, "scores"))
    beam_size, end_id = int(attrs["beam_size"]), int(attrs["end_id"])
    lods = (attrs.get("_lod") or {}).get("pre_ids")
    if lods and lods[0]:
        src_offs = np.asarray(lods[0][0], np.int64)
    else:
        src_offs = np.asarray([0, len(pre_ids)], np.int64)
    sel_ids, sel_scores, src_counts = [], [], []
    per_branch = np.zeros(len(pre_ids), np.int64)
    for s in range(len(src_offs) - 1):
        cands = []  # (score, token, branch)
        for b in range(int(src_offs[s]), int(src_offs[s + 1])):
            if pre_ids[b] == end_id and pre_ids[b] != -1:
                cands.append((float(pre_scores[b]), end_id, b))
                continue
            for k in range(cand_scores.shape[1]):
                tok = int(cand_ids[b, k]) if cand_ids is not None else k
                cands.append((float(cand_scores[b, k]), tok, b))
        cands.sort(key=lambda c: -c[0])
        top = cands[:beam_size]
        top.sort(key=lambda c: (c[2], -c[0]))
        for sc, tok, b in top:
            sel_ids.append(tok)
            sel_scores.append(sc)
            per_branch[b] += 1
        src_counts.append(len(top))
    lod = (tuple(int(v) for v in np.concatenate([[0], np.cumsum(src_counts)])),
           tuple(int(v) for v in np.concatenate([[0], np.cumsum(per_branch)])))
    dev = pre.device
    return {"selected_ids": [torch.tensor(sel_ids, dtype=torch.int64).reshape(
                -1, 1).to(dev)],
            "selected_scores": [torch.tensor(
                sel_scores, dtype=torch.float32).reshape(-1, 1).to(dev)],
            "parent_idx": [torch.from_numpy(np.repeat(
                np.arange(len(pre_ids)), per_branch)).to(dev)],
            "_lod": {"selected_ids": [lod], "selected_scores": [lod]}}


@register_op("beam_search_decode", needs_lod=True, stateful=True,
             no_grad=True, attr_defaults={"beam_size": 1, "end_id": 0})
def _beam_search_decode(ins, attrs):
    """The tensor arrays Ids and Scores of every step's beam_search
    selections (read from the scope) backtracked into whole hypotheses:
    from each row of the last step through the parent rows of the
    earlier steps' second LoD level, cut after the first ``end_id``.
    SentenceIds and SentenceScores (each token its hypothesis' final
    score) carry a two-level LoD: sources, then hypotheses."""
    op, scope = attrs["_op"], attrs["_scope"]
    end_id = int(attrs.get("end_id", 0))
    ids_arr = scope.find_var(op.input("Ids")[0]).value()
    sc_arr = scope.find_var(op.input("Scores")[0]).value()
    steps = [(_host(it.array).reshape(-1), _host(st.array).reshape(-1),
              [np.asarray(l, np.int64) for l in it.lod()])
             for it, st in zip(ids_arr, sc_arr)]
    if not steps:
        raise ValueError("beam_search_decode: empty Ids array")
    n_src = len(steps[0][2][0]) - 1
    last_scores, last_lod = steps[-1][1], steps[-1][2]
    flat_ids, flat_sc, lens, src_counts = [], [], [], []
    for s in range(n_src):
        rows = range(int(last_lod[0][s]), int(last_lod[0][s + 1]))
        for row in rows:
            toks, r = [], row
            for t in range(len(steps) - 1, -1, -1):
                ids_t, _, lod_t = steps[t]
                toks.append(int(ids_t[r]))
                if t > 0:
                    r = int(np.searchsorted(lod_t[1], r, side="right") - 1)
            toks.reverse()
            if end_id in toks:
                toks = toks[:toks.index(end_id) + 1]
            flat_ids.extend(toks)
            flat_sc.extend([float(last_scores[row])] * len(toks))
            lens.append(len(toks))
        src_counts.append(len(rows))
    lod = (tuple(int(v) for v in np.concatenate([[0], np.cumsum(src_counts)])),
           tuple(int(v) for v in np.concatenate([[0], np.cumsum(lens)])))
    dev = ids_arr[-1].array.device
    return {"SentenceIds": [torch.tensor(flat_ids, dtype=torch.int64).to(dev)],
            "SentenceScores": [torch.tensor(flat_sc,
                                            dtype=torch.float32).to(dev)],
            "_lod": {"SentenceIds": [lod], "SentenceScores": [lod]}}
