"""Sampled and structured losses (counterpart of
paddle_tpu/ops/loss_extra_ops.py; reference: operators/nce_op.cc,
hierarchical_sigmoid_op.cc, linear_chain_crf_op.cc, crf_decoding_op.cc).
So far: nce, hierarchical_sigmoid, linear_chain_crf and crf_decoding.

Row gathers whose grads add repeated rows (a class drawn twice, a tag
pair seen twice) go through ``tensor_ops.take_rows``, whose grad sums
them in an order that does not change from run to run, so a compiled
step is bitwise the interpreter's. The CRF ops pad their LoD sequences
with the index constants of ``sequence_ops`` (made from the plan's
static offsets once, then read from the plan's ``_lodc`` cache).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .registry import register_op, first, out
from .sequence_ops import _const, _padded, _require_lod, _offs
from .tensor_ops import take_rows


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# --------------------------------------------------------------------------
# NCE / hierarchical sigmoid
# --------------------------------------------------------------------------
@register_op("nce", needs_rng=True,
             diff_inputs=["Input", "Weight", "Bias"],
             attr_defaults={"num_total_classes": 2, "num_neg_samples": 10,
                            "sampler": 0, "seed": 0, "is_sparse": False})
def _nce(ins, attrs):
    """Noise-contrastive estimation with uniform noise: a logistic loss on
    the true class and on ``num_neg_samples`` classes drawn uniformly
    from the op's key (``SampleLabels``, their logits ``SampleLogits``),
    each logit shifted by log(k / V)."""
    x, label = first(ins, "Input"), first(ins, "Label")
    w, b = first(ins, "Weight"), first(ins, "Bias")
    V = int(attrs["num_total_classes"])
    k = int(attrs["num_neg_samples"])
    N = x.shape[0]
    neg = rng.randint(attrs["_rng"](), (N, k), 0, V)
    lab = label.reshape(N).long()
    pos_logit = (x * take_rows(w, lab)).sum(-1)
    neg_logit = torch.einsum("nd,nkd->nk", x, take_rows(w, neg))
    if b is not None:
        bias = b.reshape(-1, 1)
        pos_logit = pos_logit + take_rows(bias, lab).reshape(N)
        neg_logit = neg_logit + take_rows(bias, neg).reshape(N, k)
    logq = math.log(k / V)
    cost = _softplus(-(pos_logit - logq)) + _softplus(neg_logit - logq).sum(-1)
    return out(Cost=cost.reshape(N, 1), SampleLogits=neg_logit,
               SampleLabels=neg)


@register_op("hierarchical_sigmoid", diff_inputs=["X", "W", "Bias"],
             attr_defaults={"num_classes": 2, "is_sparse": False})
def _hierarchical_sigmoid(ins, attrs):
    """The sum of binary logistic losses along a label's path in the
    complete binary tree (SimpleCode, matrix_bit_code.h): code c = label
    + num_classes; at depth j the node is (c >> (j+1)) − 1 and the bit
    (c >> j) & 1, a node below 0 ending the path. ``PreOut`` is zeros,
    as the TPU kernel gives it."""
    x, w = first(ins, "X"), first(ins, "W")
    label, bias = first(ins, "Label"), first(ins, "Bias")
    V = int(attrs["num_classes"])
    N = x.shape[0]
    c = label.reshape(N).long() + V
    depth = int(np.ceil(np.log2(max(V, 2)))) + 1
    bias = bias.reshape(-1, 1) if bias is not None else None
    loss = torch.zeros((N,), dtype=x.dtype, device=x.device)
    for j in range(depth):
        node = (c >> (j + 1)) - 1
        bit = (c >> j) & 1
        node_c = torch.clamp(node, 0, w.shape[0] - 1)
        logit = (x * take_rows(w, node_c)).sum(-1)
        if bias is not None:
            logit = logit + take_rows(bias, node_c).reshape(N)
        step = _softplus(torch.where(bit == 1, -logit, logit))
        loss = loss + torch.where(node >= 0, step, torch.zeros_like(step))
    return out(Out=loss.reshape(N, 1),
               PreOut=torch.zeros((N, w.shape[0]), dtype=x.dtype,
                                  device=x.device))


# --------------------------------------------------------------------------
# linear-chain CRF and its Viterbi decode
# --------------------------------------------------------------------------
def _crf_padded(emission, attrs, op):
    """(the emissions padded to [N, Tm, K] with zeros, the lengths as an
    int64 [N] device tensor, the padded row index and validity [N, Tm],
    and the lengths on the host) of Emission's LoD sequences."""
    offs = _offs(_require_lod(attrs, "Emission", op))
    dev = emission.device
    pad = _padded(offs)
    lens = offs[1:] - offs[:-1]
    idx = _const(attrs, "crf_idx", lambda: pad[0], dev)
    valid = _const(attrs, "crf_valid", lambda: pad[1], dev)
    em = torch.where(valid[..., None], take_rows(emission, idx),
                     torch.zeros((), dtype=emission.dtype, device=dev))
    return (em, _const(attrs, "crf_lens", lambda: lens, dev), idx, valid,
            lens)


@register_op("linear_chain_crf", needs_lod=True,
             diff_inputs=["Emission", "Transition"])
def _linear_chain_crf(ins, attrs):
    """The negative log-likelihood of each sequence's Label under a
    linear-chain CRF. Transition [K + 2, K]: row 0 the start weights, row
    1 the end weights, rows 2.. the [from, to] matrix. The log partition
    by the forward recursion over the padded batch, each sequence's alpha
    frozen past its end; the gold path's score by gathers."""
    emission = first(ins, "Emission")
    transition = first(ins, "Transition")
    label = first(ins, "Label")
    K = emission.shape[-1]
    em, lens, idx, valid, lens_h = _crf_padded(emission, attrs,
                                               "linear_chain_crf")
    N, Tm = em.shape[0], em.shape[1]
    dev = em.device
    start_w, end_w, trans = transition[0], transition[1], transition[2:]
    lab = torch.where(
        valid,
        take_rows(label.reshape(-1, 1).long(), idx)[..., 0],
        torch.zeros((), dtype=torch.int64, device=dev))      # [N, Tm]
    alpha = start_w[None, :] + em[:, 0]
    for t in range(1, Tm):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + em[:, t]
        alpha = torch.where((t < lens)[:, None], nxt, alpha)
    logz = torch.logsumexp(alpha + end_w[None], -1)
    last = _const(attrs, "crf_last",
                  lambda: np.maximum(lens_h - 1, 0)[:, None], dev)
    last_lab = torch.gather(lab, 1, last)[:, 0]
    em_gold = torch.gather(em, 2, lab[..., None])[..., 0]
    gold = torch.where(valid, em_gold, torch.zeros_like(em_gold)).sum(-1)
    if Tm > 1:
        pair = lab[:, :-1] * K + lab[:, 1:]
        tr_gold = take_rows(trans.reshape(-1), pair)
        gold = gold + torch.where(valid[:, 1:], tr_gold,
                                  torch.zeros_like(tr_gold)).sum(-1)
    gold = gold + take_rows(start_w, lab[:, 0]) + take_rows(end_w, last_lab)
    ll = gold - logz
    return {"LogLikelihood": [(-ll).reshape(-1, 1)], "Alpha": [alpha],
            "EmissionExps": [torch.exp(em[:, 0])],
            "TransitionExps": [torch.exp(transition)],
            "_lod": {"LogLikelihood": [None]}}


@register_op("crf_decoding", needs_lod=True, no_grad=True)
def _crf_decoding(ins, attrs):
    """The Viterbi path of each sequence (int64, in Emission's LoD): the
    max-product recursion over the padded batch with backpointers, each
    sequence's backtrace anchored at its own end (an argmax's ties go to
    the lower tag). With ``Label``, 1 where the path matches it."""
    emission = first(ins, "Emission")
    transition = first(ins, "Transition")
    label = first(ins, "Label")
    levels = _require_lod(attrs, "Emission", "crf_decoding")
    em, lens, _, _, lens_h = _crf_padded(emission, attrs, "crf_decoding")
    N, Tm = em.shape[0], em.shape[1]
    dev = em.device
    if N == 0 or Tm == 0:
        path = torch.zeros((0, 1), dtype=torch.int64, device=dev)
    else:
        start_w, end_w, trans = transition[0], transition[1], transition[2:]
        score = start_w[None, :] + em[:, 0]
        bps = []
        for t in range(1, Tm):
            cand = score[:, :, None] + trans[None]          # [N, from, to]
            bps.append(torch.argmax(cand, dim=1))
            nxt = cand.amax(dim=1) + em[:, t]
            score = torch.where((t < lens)[:, None], nxt, score)
        last_tag = torch.argmax(score + end_w[None], -1)
        ends = _const(attrs, "crf_ends",
                      lambda: (lens_h - 1)[None, :] == np.arange(Tm)[:, None],
                      dev)                                   # [Tm, N]
        tags = [None] * Tm
        cur = last_tag
        for t in range(Tm - 1, -1, -1):
            cur = torch.where(ends[t], last_tag, cur)
            tags[t] = cur
            if t > 0:
                cur = torch.gather(bps[t - 1], 1, cur[:, None])[:, 0]
        tags = torch.stack(tags, 1)                          # [N, Tm]

        def packed():
            return np.concatenate([i * Tm + np.arange(int(n))
                                   for i, n in enumerate(lens_h)])
        path = tags.reshape(-1)[_const(attrs, "crf_packed", packed, dev)]
        path = path.reshape(-1, 1)
    if label is not None:
        path = (path == label.reshape(-1, 1)).to(torch.int64)
    return {"ViterbiPath": [path], "_lod": {"ViterbiPath": [levels]}}
