"""Sampled and structured losses (counterpart of
paddle_tpu/ops/loss_extra_ops.py: every op type it registers; reference:
operators/nce_op.cc, hierarchical_sigmoid_op.cc, linear_chain_crf_op.cc,
crf_decoding_op.cc, warpctc_op.cc, ctc_align_op.cc, edit_distance_op.cc,
sample_logits_op.cc, center_loss_op.cc, grid_sampler_op.cc,
spectral_norm_op.cc, random_crop_op.cc,
teacher_student_sigmoid_loss_op.cc): nce, hierarchical_sigmoid,
linear_chain_crf, crf_decoding, warpctc, ctc_align, edit_distance,
sampled_softmax_with_cross_entropy, center_loss, grid_sampler,
spectral_norm, random_crop and teacher_student_sigmoid_loss. ctc_align
and edit_distance run on the host, islands of a segmented step.

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
from .math_ops import scalar_as
from .tensor_ops import scatter_rows_add, take_rows


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


# --------------------------------------------------------------------------
# CTC (reference: warpctc_op.cc, ctc_align_op.cc, edit_distance_op.cc)
# --------------------------------------------------------------------------
NEG_INF = -1e30


def _lse(a, b):
    """log(e^a + e^b) with NEG_INF for "unreachable", as the TPU kernel's
    ``lse`` (loss_extra_ops.py:81-85) computes it. Where both are
    unreachable the log's argument is 1, not 0: the value is NEG_INF
    either way, but the grad is 0 where the TPU kernel's is 0/0 = NaN."""
    m = torch.maximum(a, b)
    dead = m <= NEG_INF
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    r = m_safe + torch.log(torch.where(dead, torch.ones_like(s), s))
    return torch.where(dead, torch.full_like(r, NEG_INF), r)


def _lod_offs(attrs, slot):
    levels = (attrs.get("_lod") or {}).get(slot)
    if not levels or levels[0] is None:
        return None
    return _offs(levels[0])


@register_op("warpctc", needs_lod=True, diff_inputs=["Logits"],
             host_inputs=("Label",),
             attr_defaults={"blank": 0, "norm_by_times": False})
def _warpctc(ins, attrs):
    """The CTC loss of each LoD sequence of Logits [T, C] against its
    Label sequence: the log-domain α recursion over the extended labels
    (a blank around each), the sequences padded to [N, Tm] and each one's
    α frozen past its end, Tm steps unrolled here. ``norm_by_times``
    divides by the sequence's length. Label is read on the host (a host
    input: the op runs as an island of a segmented step). A label that
    its sequence cannot hold gives −NEG_INF = 1e30, as the TPU kernel.
    The emissions are gathered by ``take_rows``: a label's repeated
    classes add their grads in a fixed order."""
    logits, label = first(ins, "Logits"), first(ins, "Label")
    blank = int(attrs.get("blank", 0))
    l_offs = _lod_offs(attrs, "Logits")
    lab_offs = _lod_offs(attrs, "Label")
    if l_offs is None or lab_offs is None:
        raise ValueError("warpctc: Logits and Label must carry LoD")
    dev = logits.device
    nc = logits.shape[-1]
    idx, valid = _padded(l_offs)
    n, tm = idx.shape
    t_lens = l_offs[1:] - l_offs[:-1]
    lab_lens = lab_offs[1:] - lab_offs[:-1]
    labels = label.reshape(-1).cpu().numpy()
    lm = int(lab_lens.max()) if n else 0
    s = 2 * lm + 1
    ext = np.full((n, s), blank, np.int64)
    for i in range(n):
        ext[i, 1:2 * int(lab_lens[i]):2] = \
            labels[lab_offs[i]:lab_offs[i + 1]]
    skip = np.zeros((n, s), bool)
    skip[:, 2:] = (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])
    # emission rows: (sequence i, step t, extended label s) -> class row
    rows = ((np.arange(n)[:, None, None] * tm
             + np.arange(tm)[None, :, None]) * nc + ext[:, None, :])
    logp = torch.log_softmax(logits, -1)
    lp = torch.where(torch.from_numpy(valid).to(dev)[..., None],
                     take_rows(logp, torch.from_numpy(idx).to(dev)),
                     torch.zeros((), dtype=logp.dtype, device=dev))
    emit = take_rows(lp.reshape(-1, 1), torch.from_numpy(rows).to(dev))
    emit = emit[..., 0]                                   # [N, Tm, S]
    skip_t = torch.from_numpy(skip).to(dev)
    lens_t = torch.from_numpy(t_lens).to(dev)
    neg = torch.full((n, 1), NEG_INF, dtype=logp.dtype, device=dev)
    has_label = torch.from_numpy(lab_lens > 0).to(dev)[:, None]
    alpha = torch.cat([emit[:, 0, :1],
                       torch.where(has_label, emit[:, 0, 1:2], neg),
                       neg.expand(n, s - 2)], 1)
    for t in range(1, tm):
        prev1 = torch.cat([neg, alpha[:, :-1]], 1)
        prev2 = torch.cat([neg, neg, alpha[:, :-2]], 1)
        a = _lse(alpha, prev1)
        a = torch.where(skip_t, _lse(a, prev2), a)
        alpha = torch.where((t < lens_t)[:, None], a + emit[:, t], alpha)
    last = torch.from_numpy(2 * lab_lens).to(dev)[:, None]
    ll = _lse(torch.gather(alpha, 1, last)[:, 0],
              torch.gather(alpha, 1, torch.clamp(last - 1, min=0))[:, 0])
    loss = -ll
    if attrs.get("norm_by_times", False):
        loss = loss / lens_t.to(loss.dtype)
    return {"Loss": [loss.reshape(-1, 1)], "_lod": {"Loss": [None]}}


def _merge_drop(seq, blank, merge):
    """The ids of ``seq`` with each run of repeats merged (``merge``)
    and the blanks dropped."""
    kept, prev = [], None
    for v in seq:
        if merge and prev is not None and v == prev:
            continue
        prev = v
        if v != blank:
            kept.append(int(v))
    return kept


@register_op("ctc_align", needs_lod=True, no_grad=True, stateful=True,
             host_inputs=("InputLength",),
             attr_defaults={"blank": 0, "merge_repeated": True,
                            "padding_value": 0})
def _ctc_align(ins, attrs):
    """CTC's greedy decode on the host (an island): repeats merged, blanks
    dropped. With InputLength, padded [N, T] in, padded Output and
    OutputLength out; else LoD [T, 1] in and out, an empty result a row
    of −1 (reference: ctc_align_op.cc). Int32 ids, as the TPU kernel
    gives them."""
    x_t = first(ins, "Input")
    dev = x_t.device
    blank = int(attrs.get("blank", 0))
    merge = bool(attrs.get("merge_repeated", True))
    in_len = first(ins, "InputLength")
    x = x_t.cpu().numpy()
    if in_len is not None:
        lens = in_len.reshape(-1).cpu().numpy().astype(np.int64)
        n, t = x.shape[0], x.shape[-1]
        res = np.full((n, t), int(attrs.get("padding_value", 0)), np.int32)
        res_lens = np.zeros((n, 1), np.int64)
        for i, row in enumerate(x.reshape(n, t)):
            kept = _merge_drop(row[:int(lens[i])], blank, merge)
            res[i, :len(kept)] = kept
            res_lens[i, 0] = len(kept)
        return {"Output": [torch.from_numpy(res).to(dev)],
                "OutputLength": [torch.from_numpy(res_lens).to(dev)],
                "_lod": {"Output": [None], "OutputLength": [None]}}
    x = x.reshape(-1)
    offs = _offs(_require_lod(attrs, "Input", "ctc_align"))
    rows, lens = [], []
    for i in range(len(offs) - 1):
        kept = _merge_drop(x[offs[i]:offs[i + 1]], blank, merge) or [-1]
        rows.extend(kept)
        lens.append(len(kept))
    lod0 = tuple(int(v) for v in np.concatenate([[0], np.cumsum(lens)]))
    return {"Output": [torch.from_numpy(np.asarray(rows, np.int32)
                                        .reshape(-1, 1)).to(dev)],
            "_lod": {"Output": [(lod0,)]}}


def _levenshtein(a, b):
    dp = np.arange(len(b) + 1, dtype=np.int64)
    for x in a:
        prev = dp.copy()
        dp[0] = prev[0] + 1
        for j in range(1, len(b) + 1):
            dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                        prev[j - 1] + (x != b[j - 1]))
    return int(dp[-1])


@register_op("edit_distance", needs_lod=True, no_grad=True, stateful=True,
             attr_defaults={"normalized": False})
def _edit_distance(ins, attrs):
    """The Levenshtein distance of each Hyps sequence to its Refs sequence
    on the host (an island), over the reference's length with
    ``normalized`` (reference: edit_distance_op.cc)."""
    hyp_t = first(ins, "Hyps")
    hyp = hyp_t.reshape(-1).cpu().numpy()
    ref = first(ins, "Refs").reshape(-1).cpu().numpy()
    h_offs = _offs(_require_lod(attrs, "Hyps", "edit_distance"))
    r_offs = _offs(_require_lod(attrs, "Refs", "edit_distance"))
    n = len(h_offs) - 1
    dists = np.zeros((n, 1), np.float32)
    for i in range(n):
        b = ref[r_offs[i]:r_offs[i + 1]]
        d = float(_levenshtein(hyp[h_offs[i]:h_offs[i + 1]], b))
        if attrs.get("normalized", False) and len(b):
            d /= len(b)
        dists[i, 0] = d
    dev = hyp_t.device
    return out(Out=torch.from_numpy(dists).to(dev),
               SequenceNum=torch.full((1,), n, dtype=torch.int64,
                                      device=dev))


# --------------------------------------------------------------------------
# sampled softmax and the remaining losses and nn ops of the module
# --------------------------------------------------------------------------
@register_op("sampled_softmax_with_cross_entropy", needs_rng=True,
             diff_inputs=["Logits"],
             attr_defaults={"num_samples": 5, "seed": 0,
                            "use_customized_samples": False})
def _sampled_softmax(ins, attrs):
    """Softmax cross entropy over each row's true class and
    ``num_samples`` classes drawn uniformly from the op's key
    (ops/rng.py; the TPU package draws from jax.random). The columns are
    gathered by ``take_rows``: a class drawn twice adds its grads in a
    fixed order."""
    logits, label = first(ins, "Logits"), first(ins, "Label")
    n, v = logits.shape
    samples = rng.randint(attrs["_rng"](), (n, int(attrs["num_samples"])),
                          0, v)
    cols = torch.cat([label.reshape(n, 1).long(), samples], 1)
    rows = torch.arange(n, device=logits.device)[:, None] * v + cols
    sub = take_rows(logits.reshape(-1, 1), rows)[..., 0]
    return out(Loss=(-torch.log_softmax(sub, -1)[:, 0]).reshape(n, 1))


@register_op("center_loss", diff_inputs=["X"],
             attr_defaults={"cluster_num": 2, "alpha": 0.1,
                            "need_update": True})
def _center_loss(ins, attrs):
    """½‖x − c_label‖² a row, and with ``need_update`` the centers moved by
    rate·Σ diff / (count + 1) (reference: center_loss_op.cc; the rate
    from CenterUpdateRate, else the ``alpha`` attr). The sums over a
    class's rows add in a fixed order (``scatter_rows_add``)."""
    x = first(ins, "X")
    label = first(ins, "Label").reshape(-1).long()
    centers, lr = first(ins, "Centers"), first(ins, "CenterUpdateRate")
    alpha = lr.reshape(-1)[0] if lr is not None \
        else scalar_as(attrs.get("alpha", 0.1), x.dtype)
    diff = x - take_rows(centers, label)
    loss = 0.5 * (diff * diff).sum(-1, keepdim=True)
    new_centers = centers
    if attrs.get("need_update", True):
        c = centers.shape[0]
        counts = scatter_rows_add(c, label, torch.ones_like(diff[:, 0])) \
            + 1.0
        delta = scatter_rows_add(c, label, diff)
        new_centers = centers + alpha * delta / counts[:, None]
    return out(Loss=loss, SampleCenterDiff=diff, CentersOut=new_centers)


@register_op("grid_sampler", diff_inputs=["X", "Grid"],
             attr_defaults={"align_corners": True, "mode": "bilinear",
                            "padding_mode": "zeros"})
def _grid_sampler(ins, attrs):
    """Bilinear sampling of X [N, C, H, W] at Grid [N, Ho, Wo, 2] (x, y in
    [−1, 1], the corners aligned), a neighbour outside X read as 0; the
    other attrs are not read, as in the TPU kernel. The neighbours are
    rows of X as [N·H·W, C] gathered by ``take_rows``, whose grad adds a
    pixel's repeats in a fixed order."""
    x, grid = first(ins, "X"), first(ins, "Grid")
    n, c, h, w = x.shape
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0, y0 = torch.floor(gx), torch.floor(gy)
    lx, ly = gx - x0, gy - y0
    pixels = x.permute(0, 2, 3, 1).reshape(n * h * w, c)
    base = torch.arange(n, device=x.device)[:, None, None] * (h * w)

    def at(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yc = torch.clamp(yy, 0, h - 1).long()
        xc = torch.clamp(xx, 0, w - 1).long()
        return take_rows(pixels, base + yc * w + xc) \
            * inside[..., None].to(x.dtype)

    o = (at(y0, x0) * ((1 - ly) * (1 - lx))[..., None]
         + at(y0, x0 + 1) * ((1 - ly) * lx)[..., None]
         + at(y0 + 1, x0) * (ly * (1 - lx))[..., None]
         + at(y0 + 1, x0 + 1) * (ly * lx)[..., None])
    return out(Output=o.movedim(-1, 1))


@register_op("spectral_norm", diff_inputs=["Weight"],
             attr_defaults={"dim": 0, "power_iters": 1, "eps": 1e-12})
def _spectral_norm(ins, attrs):
    """Weight / σ, σ = uᵀ·W·v after ``power_iters`` power iterations from U
    and V on W with ``dim`` first, flattened to a matrix; u and v carry
    no grad (reference: spectral_norm_op.cc)."""
    w = first(ins, "Weight")
    u, v = first(ins, "U").reshape(-1), first(ins, "V").reshape(-1)
    dim = int(attrs.get("dim", 0))
    eps = float(attrs.get("eps", 1e-12))
    mat = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    with torch.no_grad():
        m = mat.detach()
        for _ in range(int(attrs.get("power_iters", 1))):
            v = m.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = m @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
    return out(Out=w / (u @ mat @ v))


@register_op("random_crop", needs_rng=True, no_grad=True,
             attr_defaults={"shape": [], "startup_seed": 0})
def _random_crop(ins, attrs):
    """A window of ``shape`` over X's last dims at offsets drawn uniformly
    from the op's key (ops/rng.py, one subkey a dim; the TPU package
    draws from jax.random), taken on the device by ``index_select`` so
    no offset is read on the host."""
    x = first(ins, "X")
    shape = [int(s) for s in attrs["shape"]]
    key = attrs["_rng"]()
    lead = x.dim() - len(shape)
    o = x
    for i, s in enumerate(shape):
        d = lead + i
        start = rng.randint(rng.subkey(key, i), (1,), 0, x.shape[d] - s + 1)
        o = o.index_select(d, start + torch.arange(s, device=x.device))
    return out(Out=o)


@register_op("teacher_student_sigmoid_loss", diff_inputs=["X"],
             attr_defaults={"soft_max_up_bound": 15.0,
                            "soft_max_lower_bound": -15.0})
def _teacher_student_sigmoid_loss(ins, attrs):
    """Sigmoid cross entropy against a hard label (label ≥ 0: 1 when it is
    positive) or a teacher's soft score (label < 0 holds −score − 1), x
    clipped to the bounds first (reference:
    teacher_student_sigmoid_loss_op.cc)."""
    x = first(ins, "X").reshape(-1)
    label = first(ins, "Label").reshape(-1)
    lo, hi = (torch.full((), attrs[k], dtype=x.dtype, device=x.device)
              for k in ("soft_max_lower_bound", "soft_max_up_bound"))
    x = torch.minimum(torch.maximum(x, lo), hi)
    hard = _softplus(x) - x * (label > 0).to(x.dtype)
    soft = _softplus(x) - x * (-(label + 1.0))
    return out(Y=torch.where(label < 0, soft, hard).reshape(-1, 1))
