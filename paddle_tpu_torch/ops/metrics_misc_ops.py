"""The metric and misc op batch (counterpart of
paddle_tpu/ops/metrics_misc_ops.py; reference: chunk_eval_op.cc,
precision_recall_op.cc, positive_negative_pair_op.cc, detection_map_op.cc,
modified_huber_loss_op.cc, sample_logits_op.cc, partial_concat_op.cc,
partial_sum_op.cc, batch_fc_op.cc, shuffle_batch_op.cc, fill_op.cc,
fill_zeros_like_op.cc, coalesce_tensor_op.cc, get_places_op.cc,
tdm_child_op.cc, tdm_sampler_op.cc, rank_attention_op.cc, tree_conv_op.cc,
match_matrix_tensor_op.cc, var_conv_2d_op.cc, pyramid_hash_op.cc,
sequence_topk_avg_pooling_op.cc, filter_by_instag_op.cc).

The metric ops and the ops that read a tensor's values to shape their
work (``stateful``: chunk_eval, precision_recall, positive_negative_pair,
detection_map, filter_by_instag, tree_conv's edges, pyramid_hash's
n-grams) run on the host in the TPU package's numpy, and their results go
to the device of their input. The others are torch over the device:
every row gather goes through ``take_rows``, so a grad that adds rows
(rank_attention's and pyramid_hash's parameter blocks, sample_logits'
logits, shuffle_batch's rows) adds in a fixed order. The three LoD ops
over sequence pairs (match_matrix_tensor, var_conv_2d,
sequence_topk_avg_pooling) loop over the sequences of their LoD, which a
plan fixes, slicing each one's rows.

detection_map, PASCAL VOC's mAP: the detections of each image are
matched greedily, best score first, to its ground truths of their class
at ``overlap_threshold`` IoU; each class's (score, hit) records, with
those of the state carried in (HasState, PosCount, TruePos, FalsePos),
give its AP (``integral`` or ``11point``), and their mean is the mAP."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import rng
from .detection_ops import _dev, _host, _lod0, _lod_offs
from .registry import register_op, first, seq, out
from .tensor_ops import take_rows


def _box_iou(a, b):
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
          - inter)
    return inter / ua if ua > 0 else 0.0


def _average_precision(scored, npos, ap_type):
    scored = sorted(scored, key=lambda t: -t[0])
    tps = np.cumsum([t[1] for t in scored]) if scored else np.zeros(0)
    fps = np.cumsum([1 - t[1] for t in scored]) if scored else np.zeros(0)
    rec = tps / npos if len(tps) else np.zeros(0)
    prec = tps / np.maximum(tps + fps, 1e-12) if len(tps) else np.zeros(0)
    if ap_type == "11point":
        return np.mean([max([p for r_, p in zip(rec, prec) if r_ >= t],
                            default=0.0) for t in np.linspace(0, 1, 11)])
    ap, prev_r = 0.0, 0.0
    for r_, p in zip(rec, prec):
        ap += (r_ - prev_r) * p
        prev_r = r_
    return ap


@register_op("detection_map", stateful=True,
             inputs=("DetectRes", "Label", "HasState", "PosCount",
                     "TruePos", "FalsePos"),
             no_grad=True, needs_lod=True,
             attr_defaults={"overlap_threshold": 0.5, "class_num": 1,
                            "background_label": 0, "evaluate_difficult": True,
                            "ap_type": "integral"})
def _detection_map(ins, attrs):
    """DetectRes LoD [M, 6] rows (label, score, x1, y1, x2, y2); Label
    LoD [N, 6] rows (label, difficult, x1, y1, x2, y2) or [N, 5] without
    the difficult flag. → MAP [1] and the accumulated state: PosCount
    [C, 1], and the (score, hit) records of each class as TruePos and
    FalsePos, LoD by class."""
    d_t = first(ins, "DetectRes")
    det = _host(d_t)
    gt = _host(first(ins, "Label"))
    doffs = _lod_offs(attrs, "DetectRes", len(det))
    goffs = _lod_offs(attrs, "Label", len(gt))
    thr = attrs.get("overlap_threshold", 0.5)
    bg = int(attrs.get("background_label", 0))
    ap_type = attrs.get("ap_type", "integral")
    eval_diff = attrs.get("evaluate_difficult", True)
    C = int(attrs.get("class_num", 1))
    has_diff = gt.shape[1] == 6
    box_col = 2 if has_diff else 1
    npos_c = np.zeros(C, np.int64)
    scored_c = {c: [] for c in range(C)}
    pc_in = first(ins, "PosCount")
    hs_in = first(ins, "HasState")
    if pc_in is not None and hs_in is not None \
            and int(_host(hs_in).reshape(-1)[0]):
        npos_c += _host(pc_in).reshape(-1)[:C].astype(np.int64)
        for slot, hit in (("TruePos", 1), ("FalsePos", 0)):
            arr = first(ins, slot)
            if arr is None:
                continue
            a = _host(arr).reshape(-1, 2)
            o = _lod_offs(attrs, slot, len(a))
            for c in range(min(C, len(o) - 1)):
                for row in a[o[c]:o[c + 1]]:
                    scored_c[c].append((float(row[0]), hit))
    for i in range(len(doffs) - 1):
        d = det[doffs[i]:doffs[i + 1]]
        g_raw = gt[goffs[i]:goffs[i + 1]]
        for c in set(int(v) for v in g_raw[:, 0]) | \
                set(int(v) for v in d[:, 0]):
            if c == bg or c < 0 or c >= C:
                continue
            gc = g_raw[g_raw[:, 0] == c]
            diff = (gc[:, 1].astype(bool) if has_diff
                    else np.zeros(len(gc), bool))
            g = gc[:, box_col:box_col + 4]
            npos_c[c] += int(len(g) if eval_diff else (~diff).sum())
            dc = d[d[:, 0] == c]
            used = np.zeros(len(g), bool)
            for row in dc[np.argsort(-dc[:, 1])]:
                best, bi = 0.0, -1
                for j in range(len(g)):
                    o = _box_iou(row[2:6], g[j])
                    if o > best:
                        best, bi = o, j
                if best >= thr and bi >= 0:
                    if not eval_diff and diff[bi]:
                        continue   # a difficult ground truth: not counted
                    scored_c[c].append((float(row[1]), 0 if used[bi] else 1))
                    used[bi] = True
                else:
                    scored_c[c].append((float(row[1]), 0))
    aps = [_average_precision(scored_c[c], npos_c[c], ap_type)
           for c in range(C) if c != bg and npos_c[c] != 0]
    m = float(np.mean(aps)) if aps else 0.0
    tp_rows, fp_rows, tp_lens, fp_lens = [], [], [], []
    for c in range(C):
        tps = [(s, h) for s, h in scored_c[c] if h == 1]
        fps = [(s, h) for s, h in scored_c[c] if h == 0]
        tp_rows.extend(tps)
        fp_rows.extend(fps)
        tp_lens.append(len(tps))
        fp_lens.append(len(fps))
    tp_arr = (np.asarray(tp_rows, np.float32).reshape(-1, 2)
              if tp_rows else np.zeros((0, 2), np.float32))
    fp_arr = (np.asarray(fp_rows, np.float32).reshape(-1, 2)
              if fp_rows else np.zeros((0, 2), np.float32))
    dev = d_t.device
    return {"MAP": [torch.tensor([m], dtype=torch.float32).to(dev)],
            "AccumPosCount": [_dev(npos_c[:, None].astype(np.int32), dev)],
            "AccumTruePos": [_dev(tp_arr, dev)],
            "AccumFalsePos": [_dev(fp_arr, dev)],
            "_lod": {"AccumTruePos": [_lod0(tp_lens)],
                     "AccumFalsePos": [_lod0(fp_lens)]}}


# --------------------------------------------------------------------------
# chunk_eval (reference chunk_eval_op.h): IOB / IOE / IOBES / plain
# --------------------------------------------------------------------------
_TAG_NUM = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}


def _extract_chunks(tags, scheme, num_types, excluded):
    """The set of (begin, end, type) chunks of an int tag sequence: tag =
    type · tag_num + position (B, I[, E, S] by scheme); a tag outside
    [0, num_types · tag_num) is O and closes the open chunk."""
    tag_num = _TAG_NUM[scheme]
    o_tag = num_types * tag_num
    chunks, start, ctype = [], None, None

    def flush(end):
        if start is not None and ctype not in excluded:
            chunks.append((start, end, ctype))
    for i, t in enumerate(tags):
        t = int(t)
        if t < 0 or t >= o_tag:
            flush(i - 1)
            start = None
            continue
        ty, pos = t // tag_num, t % tag_num
        if scheme == "plain":
            begins = True
        elif scheme == "IOB":
            begins = pos == 0 or start is None or ty != ctype
        elif scheme == "IOE":
            begins = start is None or ty != ctype
        else:  # IOBES: B 0, I 1, E 2, S 3
            begins = pos in (0, 3) or start is None or ty != ctype
        if begins:
            flush(i - 1)
            start, ctype = i, ty
        if scheme == "plain" or (scheme == "IOE" and pos == 1) or \
                (scheme == "IOBES" and pos in (2, 3)):
            flush(i)
            start = None
    flush(len(tags) - 1)
    return set(chunks)


@register_op("chunk_eval", stateful=True,
             inputs=("Inference", "Label", "SeqLength"),
             no_grad=True, needs_lod=True,
             attr_defaults={"num_chunk_types": 1, "chunk_scheme": "IOB",
                            "excluded_chunk_types": []})
def _chunk_eval(ins, attrs):
    """Precision, recall and F1 of the chunks of Inference against those
    of Label, sequence by sequence: by Inference's LoD, else by SeqLength
    over a padded [N, T] layout, else one sequence. The three counts are
    int32, as the TPU kernel gives them."""
    inf_t = first(ins, "Inference")
    inf_raw = _host(inf_t)
    inf = inf_raw.reshape(-1)
    lab = _host(first(ins, "Label")).reshape(-1)
    lods = (attrs.get("_lod") or {}).get("Inference")
    seq_len = first(ins, "SeqLength")
    if lods and lods[0]:
        offs = np.asarray(lods[0][-1], np.int64)
        spans = list(zip(offs[:-1].tolist(), offs[1:].tolist()))
    elif seq_len is not None and inf_raw.ndim >= 2:
        T = inf_raw.shape[1]
        spans = [(i * T, i * T + int(n))
                 for i, n in enumerate(_host(seq_len).reshape(-1))]
    else:
        spans = [(0, len(inf))]
    scheme = attrs.get("chunk_scheme", "IOB")
    nt = int(attrs.get("num_chunk_types", 1))
    excl = set(attrs.get("excluded_chunk_types") or [])
    n_inf = n_lab = n_cor = 0
    for s, e in spans:
        ci = _extract_chunks(inf[s:e], scheme, nt, excl)
        cl = _extract_chunks(lab[s:e], scheme, nt, excl)
        n_inf += len(ci)
        n_lab += len(cl)
        n_cor += len(ci & cl)
    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    dev = inf_t.device
    f32 = lambda v: _dev(np.asarray([v], np.float32), dev)
    i32 = lambda v: _dev(np.asarray([v], np.int32), dev)
    return {"Precision": [f32(p)], "Recall": [f32(r)], "F1-Score": [f32(f1)],
            "NumInferChunks": [i32(n_inf)], "NumLabelChunks": [i32(n_lab)],
            "NumCorrectChunks": [i32(n_cor)]}


# --------------------------------------------------------------------------
# precision_recall, positive_negative_pair: host metrics with state
# --------------------------------------------------------------------------
def _prf(tp, fp, fn):
    """Macro precision, recall, F1, then micro ones, as float32."""
    prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1e-12), 0)
    rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1e-12), 0)
    f1 = np.where(prec + rec > 0,
                  2 * prec * rec / np.maximum(prec + rec, 1e-12), 0)
    stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
    mp = stp / (stp + sfp) if stp + sfp else 0.0
    mr = stp / (stp + sfn) if stp + sfn else 0.0
    mf = 2 * mp * mr / (mp + mr) if mp + mr else 0.0
    return np.asarray([prec.mean(), rec.mean(), f1.mean(), mp, mr, mf],
                      np.float32)


@register_op("precision_recall", stateful=True,
             inputs=("MaxProbs", "Indices", "Labels", "Weights",
                     "StatesInfo"),
             no_grad=True, attr_defaults={"class_number": 1})
def _precision_recall(ins, attrs):
    """BatchMetrics and AccumMetrics [6] (macro then micro P, R, F1) of
    the predicted Indices against Labels (weighted), and
    AccumStatesInfo [C, 4] (TP, FP, TN = 0, FN) with StatesInfo's added."""
    idx_t = first(ins, "Indices")
    idx = _host(idx_t).reshape(-1)
    lab = _host(first(ins, "Labels")).reshape(-1)
    w = first(ins, "Weights")
    w = (_host(w).reshape(-1) if w is not None
         else np.ones_like(lab, np.float32))
    C = int(attrs.get("class_number", 1))
    tp, fp, fn = np.zeros(C), np.zeros(C), np.zeros(C)
    for p_, l_, wi in zip(idx, lab, w):
        if p_ == l_:
            tp[l_] += wi
        else:
            fp[p_] += wi
            fn[l_] += wi
    batch = _prf(tp, fp, fn)
    st = first(ins, "StatesInfo")
    if st is not None:
        sa = _host(st).reshape(C, 4).astype(np.float64)
        tp, fp, fn = tp + sa[:, 0], fp + sa[:, 1], fn + sa[:, 3]
    states = np.stack([tp, fp, np.zeros(C), fn], axis=1)
    dev = idx_t.device
    return {"BatchMetrics": [_dev(batch, dev)],
            "AccumMetrics": [_dev(_prf(tp, fp, fn), dev)],
            "AccumStatesInfo": [_dev(states.astype(np.float32), dev)]}


@register_op("positive_negative_pair", stateful=True,
             inputs=("Score", "Label", "QueryID", "AccumulatePositivePair",
                     "AccumulateNegativePair", "AccumulateNeutralPair",
                     "Weight"),
             no_grad=True, attr_defaults={"column": -1})
def _positive_negative_pair(ins, attrs):
    """Within each query, the pairs of differently labelled items ordered
    by Score's ``column`` as their labels (positive), against them
    (negative) or tied (neutral), each count plus its accumulator."""
    score_t = first(ins, "Score")
    s = _host(score_t)[:, int(attrs.get("column", -1))]
    lab = _host(first(ins, "Label")).reshape(-1)
    qid = _host(first(ins, "QueryID")).reshape(-1)
    counts = [0.0, 0.0, 0.0]   # positive, negative, neutral
    for q in np.unique(qid):
        sel = np.where(qid == q)[0]
        for a in range(len(sel)):
            for b in range(a + 1, len(sel)):
                i, j = sel[a], sel[b]
                if lab[i] == lab[j]:
                    continue
                hi, lo = (i, j) if lab[i] > lab[j] else (j, i)
                counts[0 if s[hi] > s[lo] else 1 if s[hi] < s[lo] else 2] \
                    += 1
    res, dev = {}, score_t.device
    for k, (slot, acc) in enumerate((
            ("PositivePair", "AccumulatePositivePair"),
            ("NegativePair", "AccumulateNegativePair"),
            ("NeutralPair", "AccumulateNeutralPair"))):
        v = counts[k]
        prev = first(ins, acc)
        if prev is not None:
            v += float(_host(prev).reshape(()))
        res[slot] = [_dev(np.asarray([v], np.float32), dev)]
    return res


# --------------------------------------------------------------------------
# small compute ops
# --------------------------------------------------------------------------
@register_op("modified_huber_loss", inputs=("X", "Y"), diff_inputs=("X",))
def _modified_huber_loss(ins, attrs):
    """z = (2y − 1)·x; −4z where z < −1, else max(1 − z, 0)²."""
    x, y = first(ins, "X"), first(ins, "Y")
    z = (2.0 * y.to(x.dtype) - 1.0) * x
    loss = torch.where(z < -1.0, -4.0 * z,
                       torch.square(torch.clamp(1.0 - z, min=0.0)))
    return {"Out": [loss.reshape(-1, 1)], "IntermediateVal": [z]}


def _columns(xs, attrs):
    s = int(attrs.get("start_index", 0))
    if s < 0:
        s += xs[0].shape[1]
    ln = int(attrs.get("length", -1))
    return [x[:, s:(None if ln < 0 else s + ln)] for x in xs]


@register_op("partial_concat", inputs=("X",), diff_inputs=("X",),
             attr_defaults={"start_index": 0, "length": -1})
def _partial_concat(ins, attrs):
    """Columns [start_index, start_index + length) of each X, joined."""
    return out(Out=torch.cat(_columns(seq(ins, "X"), attrs), dim=1))


@register_op("partial_sum", inputs=("X",), diff_inputs=("X",),
             attr_defaults={"start_index": 0, "length": -1})
def _partial_sum(ins, attrs):
    """Columns [start_index, start_index + length) of the X summed in
    order."""
    acc = None
    for v in _columns(seq(ins, "X"), attrs):
        acc = v if acc is None else acc + v
    return out(Out=acc)


@register_op("batch_fc", inputs=("Input", "W", "Bias"),
             diff_inputs=("Input", "W", "Bias"))
def _batch_fc(ins, attrs):
    """relu(Input[s] · W[s] + Bias[s]) for each slot s: Input [S, B, in],
    W [S, in, out], Bias [S, 1, out]; one batched product."""
    x, w, b = first(ins, "Input"), first(ins, "W"), first(ins, "Bias")
    o = torch.bmm(x, w)
    if b is not None:
        o = o + b
    return out(Out=torch.clamp(o, min=0))


@register_op("shuffle_batch", inputs=("X", "Seed"), needs_rng=True,
             host_inputs=("Seed",), attr_defaults={"startup_seed": 0})
def _shuffle_batch(ins, attrs):
    """X's rows in a random order: the indices that sort a draw a row
    (stably), from the op's key or, when Seed holds a nonzero value, from
    that seed. ShuffleIdx is the order (Out = X[ShuffleIdx]); SeedOut 0."""
    x = first(ins, "X")
    seed_in = first(ins, "Seed")
    seed = int(seed_in.reshape(()).item()) if seed_in is not None else 0
    key = rng.fixed_key(seed, x.device) if seed else attrs["_rng"]()
    perm = torch.argsort(rng.bits24(key, (x.shape[0],)), stable=True)
    return {"Out": [take_rows(x, perm)], "ShuffleIdx": [perm.to(torch.int32)],
            "SeedOut": [torch.zeros(1, dtype=torch.int32, device=x.device)]}


@register_op("fill", no_grad=True, needs_device=True,
             attr_defaults={"value": [], "shape": [], "dtype": 5,
                            "force_cpu": False})
def _fill(ins, attrs):
    """Out of ``shape`` and ``dtype`` holding ``value`` (row-major)."""
    from ..fluid.core import dtype_to_torch
    vals = np.asarray(attrs.get("value", []), np.float64)
    shape = [int(v) for v in attrs.get("shape", [])]
    return out(Out=torch.from_numpy(vals.reshape(shape)).to(
        dtype_to_torch(attrs.get("dtype", 5))).to(attrs["_device"]))


@register_op("fill_zeros_like2", inputs=("X",), no_grad=True,
             attr_defaults={"dtype": 5})
def _fill_zeros_like2(ins, attrs):
    return out(Out=torch.zeros_like(first(ins, "X")))


@register_op("get_places", no_grad=True, needs_device=True,
             attr_defaults={"device_count": 0, "device_type": "CPU"})
def _get_places(ins, attrs):
    """0 .. n − 1 (int32): n is ``device_count``, else the number of
    devices of the executor's kind (the TPU kernel counts jax's)."""
    dev = attrs["_device"]
    n = int(attrs.get("device_count", 0)) or (
        torch.cuda.device_count() if dev.type == "cuda" else 1)
    return out(Out=torch.arange(n, dtype=torch.int32, device=dev))


@register_op("coalesce_tensor", inputs=("Input",),
             attr_defaults={"copy_data": True, "set_constant": False,
                            "constant": 0.0, "dtype": 5})
def _coalesce_tensor(ins, attrs):
    """Output: the Input tensors as they are; FusedOutput: them flattened
    and joined (or ``constant`` throughout, with ``set_constant``)."""
    xs = seq(ins, "Input")
    flat = torch.cat([x.reshape(-1) for x in xs])
    if attrs.get("set_constant", False):
        flat = torch.full_like(flat, attrs.get("constant", 0.0))
    return {"Output": list(xs), "FusedOutput": [flat]}


@register_op("sample_logits",
             inputs=("Logits", "Labels", "CustomizedSamples",
                     "CustomizedProbabilities"),
             diff_inputs=("Logits",), needs_rng=True,
             attr_defaults={"num_samples": 1, "uniq": True,
                            "remove_accidental_hits": True,
                            "use_customized_samples": False, "seed": 0})
def _sample_logits(ins, attrs):
    """Sampled softmax's inputs: each row's true-label logits and
    ``num_samples`` log-uniform negative classes, less log Q(class); a
    negative equal to one of the row's labels (an accidental hit) set to
    −1e20. The samples are drawn from the op's key (``seed`` pins it), or
    taken from CustomizedSamples and CustomizedProbabilities."""
    logits, labels = first(ins, "Logits"), first(ins, "Labels")
    n, K = logits.shape
    nt = labels.shape[1]
    dev = logits.device
    if attrs.get("use_customized_samples", False):
        samples = first(ins, "CustomizedSamples").to(torch.int32)
        probs = first(ins, "CustomizedProbabilities")
    else:
        u = rng.uniform(attrs["_rng"](), (n, int(attrs.get("num_samples",
                                                            1))))
        logk = torch.log(torch.tensor(K + 1.0, dtype=torch.float32,
                                      device=dev))
        neg = torch.clamp((torch.exp(u * logk) - 1.0).to(torch.int32),
                          0, K - 1)
        samples = torch.cat([labels.to(torch.int32), neg], dim=1)
        sf = samples.to(torch.float32)
        probs = torch.log((sf + 2.0) / (sf + 1.0)) / logk
    rows = torch.arange(n, device=dev)[:, None] * K
    gathered = take_rows(logits.reshape(-1, 1),
                         rows + samples.long())[..., 0]
    sampled = gathered - torch.log(probs + 1e-20)
    if attrs.get("remove_accidental_hits", True):
        hit = (samples[:, nt:, None] == labels[:, None, :]).any(-1)
        mask = torch.cat([torch.zeros((n, nt), dtype=torch.bool,
                                      device=dev), hit], dim=1)
        sampled = torch.where(mask, torch.full((), -1e20, dtype=sampled.dtype,
                                               device=dev), sampled)
    return {"Samples": [samples],
            "Probabilities": [probs],
            "SampledLogits": [sampled],
            "SampledLabels": [torch.arange(nt, dtype=torch.int32,
                                           device=dev).expand(n, nt)
                              .contiguous()]}


@register_op("filter_by_instag", stateful=True,
             inputs=("Ins", "Ins_tag", "Filter_tag"),
             diff_inputs=("Ins",), needs_lod=True,
             attr_defaults={"is_lod": True, "out_val_if_empty": 0})
def _filter_by_instag(ins, attrs):
    """The TPU kernel's static-shape form: the rows whose tag is in
    Filter_tag kept, the others zeroed (every row ``out_val_if_empty``
    when none matches); LossWeight [n, 1] 1 on a kept row; IndexMap [n, 2]
    the row index twice (int32, as the TPU kernel's)."""
    x = first(ins, "Ins")
    tags = _host(first(ins, "Ins_tag")).reshape(-1)
    filt = set(_host(first(ins, "Filter_tag")).reshape(-1).tolist())
    keep = np.asarray([1.0 if t in filt else 0.0 for t in tags], np.float32)
    k = _dev(keep[:, None], x.device)
    if keep.sum() == 0:
        o = torch.full_like(x, attrs.get("out_val_if_empty", 0))
    else:
        o = x * k.to(x.dtype)
    idx = np.arange(len(tags), dtype=np.int32)
    return {"Out": [o], "LossWeight": [k],
            "IndexMap": [_dev(np.stack([idx, idx], axis=1), x.device)]}


# --------------------------------------------------------------------------
# TDM tree ops (reference tdm_child_op.h: a TreeInfo row is [item_id,
# layer_id, parent_id, child_0 .. child_{n-1}]; child 0 is none)
# --------------------------------------------------------------------------
@register_op("tdm_child", inputs=("X", "TreeInfo"), no_grad=True,
             attr_defaults={"child_nums": 1, "dtype": 2})
def _tdm_child(ins, attrs):
    """Child [.., child_nums]: each node's children (0 for node 0 or a
    leaf), LeafMask: 1 where the child is an item (int32)."""
    x, info = first(ins, "X"), first(ins, "TreeInfo")
    cn = int(attrs.get("child_nums", 1))
    ids = x.reshape(-1).long()
    rows = info[ids]
    kids = rows[:, 3:3 + cn].long()
    has_child = ((ids != 0) & (rows[:, 3] != 0))[:, None]
    kids = torch.where(has_child, kids, torch.zeros_like(kids))
    is_item = (info[kids.reshape(-1), 0] != 0).reshape(kids.shape)
    mask = has_child & is_item
    shape = (tuple(x.shape[:-1]) + (cn,) if x.shape[-1] == 1
             else tuple(x.shape) + (cn,))
    return {"Child": [kids.reshape(shape).to(torch.int32)],
            "LeafMask": [mask.reshape(shape).to(torch.int32)]}


@register_op("tdm_sampler", inputs=("X", "Travel", "Layer"), needs_rng=True,
             attr_defaults={"neg_samples_num_list": [], "layer_offset_lod": [],
                            "output_positive": True, "output_list": True,
                            "seed": 0, "dtype": 2})
def _tdm_sampler(ins, attrs):
    """For each item and each layer: its node on the tree path (Travel)
    and ``neg_samples_num_list[layer]`` nodes drawn uniformly from the
    layer's span of Layer (``layer_offset_lod``), one key a layer from the
    op's; Labels 1 for the path node, 0 for the draws; Mask 0 where the
    path has no node in the layer. As the TPU kernel, a draw may hit the
    path node."""
    x, travel, layer = first(ins, "X"), first(ins, "Travel"), \
        first(ins, "Layer")
    negs = [int(v) for v in attrs.get("neg_samples_num_list", [])]
    offs = [int(v) for v in attrs.get("layer_offset_lod", [])]
    ids = x.reshape(-1).long()
    n = ids.shape[0]
    key = attrs["_rng"]()
    flat = layer.reshape(-1)
    outs, labs, masks = [], [], []
    for li, neg in enumerate(negs):
        pos = travel[ids, li][:, None]
        samp = rng.randint(rng.subkey(key, li), (n, neg), offs[li],
                           offs[li + 1])
        negv = flat[samp].to(pos.dtype)
        valid = (pos != 0).to(torch.int32)
        outs.append(torch.cat([pos, negv], dim=1))
        labs.append(torch.cat([torch.ones_like(pos), torch.zeros_like(negv)],
                              dim=1))
        masks.append(torch.cat([valid, valid.expand(n, neg)], dim=1))
    return {"Out": [torch.cat(outs, 1).to(torch.int32)[..., None]],
            "Labels": [torch.cat(labs, 1).to(torch.int32)[..., None]],
            "Mask": [torch.cat(masks, 1)[..., None]]}


@register_op("rank_attention", inputs=("X", "RankOffset", "RankParam"),
             diff_inputs=("X", "RankParam"),
             attr_defaults={"MaxRank": 3, "MaxSize": 0})
def _rank_attention(ins, attrs):
    """Sample i of rank r_i combines X[i] with the RankParam block
    (r_i − 1)·MaxRank + (rank_k − 1) of each valid neighbour rank k of
    RankOffset; an invalid one adds nothing. The blocks are gathered by
    ``take_rows``: their grad adds in a fixed order."""
    x, ro, p = first(ins, "X"), first(ins, "RankOffset"), \
        first(ins, "RankParam")
    mr = int(attrs.get("MaxRank", 3))
    n, d = x.shape
    ocol = p.shape[1]
    pb = p.reshape(mr * mr, d, ocol)
    ins_rank = ro[:, 0].long()
    o = torch.zeros((n, ocol), dtype=x.dtype, device=x.device)
    for k in range(mr):
        fea_rank = ro[:, 2 * k + 1].long()
        valid = (ins_rank > 0) & (fea_rank > 0)
        block = torch.clamp((ins_rank - 1) * mr + (fea_rank - 1), 0,
                            mr * mr - 1)
        contrib = torch.bmm(x[:, None, :], take_rows(pb, block))[:, 0]
        o = o + torch.where(valid[:, None], contrib,
                            torch.zeros((), dtype=x.dtype, device=x.device))
    return {"Out": [o], "InputHelp": [x],
            "InsRank": [ins_rank.to(x.dtype)[:, None]]}


@register_op("tree_conv", stateful=True,
             inputs=("NodesVector", "EdgeSet", "Filter"),
             diff_inputs=("NodesVector", "Filter"),
             attr_defaults={"max_depth": 2})
def _tree_conv(ins, attrs):
    """The TPU kernel's one-hop tree conv: each tree's adjacency from its
    (parent, child) edges (read on the host; an edge (0, 0) is padding),
    then tanh(max over out_size of x·W_self + (A·x)·W_down + (Aᵀ·x)·W_up)."""
    nodes, filt = first(ins, "NodesVector"), first(ins, "Filter")
    edges = _host(first(ins, "EdgeSet"))
    b, n, f = nodes.shape
    _, _, osz, nf = filt.shape
    w_self = filt[:, 0].reshape(f, osz * nf)
    w_down = filt[:, 1].reshape(f, osz * nf)
    w_up = filt[:, 2].reshape(f, osz * nf)
    res = []
    for bi in range(b):
        adj = np.zeros((n, n), np.float32)
        for pa, ch in edges[bi]:
            if pa > 0 or ch > 0:
                adj[int(pa), int(ch)] = 1.0
        a = _dev(adj, nodes.device).to(nodes.dtype)
        x = nodes[bi]
        h = x @ w_self + (a @ x) @ w_down + (a.T @ x) @ w_up
        res.append(torch.tanh(h.reshape(n, osz, nf).amax(dim=1)))
    return out(Out=torch.stack(res))


# --------------------------------------------------------------------------
# the LoD ops over sequence pairs (the text-match models')
# --------------------------------------------------------------------------
def _offsets(attrs, slot):
    return np.asarray((attrs.get("_lod") or {})[slot][0][-1], np.int64)


@register_op("match_matrix_tensor", inputs=("X", "Y", "W"),
             diff_inputs=("X", "Y", "W"), needs_lod=True,
             attr_defaults={"dim_t": 1})
def _match_matrix_tensor(ins, attrs):
    """For each sequence pair i, out[t, a, b] = x_a · W_t · y_b over X's
    and Y's i-th sequences, flattened and joined: Out [Σ lenx·leny·dim_t,
    1], its LoD one sequence a pair. Tmp is Out."""
    x, y, w = first(ins, "X"), first(ins, "Y"), first(ins, "W")
    xo, yo = _offsets(attrs, "X"), _offsets(attrs, "Y")
    dim_t = w.shape[1] if w.dim() == 3 else int(attrs.get("dim_t", 1))
    wt = w if w.dim() == 3 else w.reshape(x.shape[1], dim_t, y.shape[1])
    pieces, lens = [], []
    for i in range(len(xo) - 1):
        xs = x[int(xo[i]):int(xo[i + 1])]
        ys = y[int(yo[i]):int(yo[i + 1])]
        m = torch.einsum("id,dte,ke->tik", xs, wt, ys)
        pieces.append(m.reshape(-1))
        lens.append(m.numel())
    o = torch.cat(pieces)[:, None]
    return {"Out": [o], "Tmp": [o], "_lod": {"Out": [_lod0(lens)]}}


@register_op("var_conv_2d", inputs=("X", "ROW", "COLUMN", "W"),
             diff_inputs=("X", "W"), needs_lod=True,
             attr_defaults={"InputChannel": 1, "OutputChannel": 1,
                            "StrideH": 1, "StrideW": 1, "KernelH": 3,
                            "KernelW": 3})
def _var_conv_2d(ins, attrs):
    """Sequence i of X is an image [InputChannel, rows_i, cols_i] (rows
    and columns from ROW's and COLUMN's LoD), convolved on its own with W
    [OutputChannel, InputChannel·KernelH·KernelW], padded by (k − 1) / 2,
    on cuDNN under the conv pin (``nn_ops._Conv``); the outputs
    flattened and joined, their LoD one sequence an image. An image
    without rows or columns gives an empty piece."""
    from .nn_ops import _Conv
    x, w = first(ins, "X"), first(ins, "W")
    ro, co = _offsets(attrs, "ROW"), _offsets(attrs, "COLUMN")
    ic = int(attrs.get("InputChannel", 1))
    oc = int(attrs.get("OutputChannel", 1))
    kh, kw = int(attrs.get("KernelH", 3)), int(attrs.get("KernelW", 3))
    sh, sw = int(attrs.get("StrideH", 1)), int(attrs.get("StrideW", 1))
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    wk = w.reshape(oc, ic, kh, kw)
    flat = x.reshape(-1)
    pos, pieces, lens = 0, [], []
    for i in range(len(ro) - 1):
        r, c = int(ro[i + 1] - ro[i]), int(co[i + 1] - co[i])
        oh = max((r + 2 * ph - kh) // sh + 1, 0)
        ow = max((c + 2 * pw - kw) // sw + 1, 0)
        if r * c == 0 or oh * ow == 0:
            o = flat.new_zeros(oc * oh * ow)
        else:
            img = flat[pos:pos + ic * r * c].reshape(1, ic, r, c)
            o = _Conv.apply(img, wk, [sh, sw], [ph, pw], [1, 1], False,
                            1).reshape(-1)
        pos += ic * r * c
        pieces.append(o)
        lens.append(o.numel())
    res = torch.cat(pieces)[:, None]
    return {"Out": [res], "Col": [res], "_lod": {"Out": [_lod0(lens)]}}


@register_op("pyramid_hash", stateful=True,
             inputs=("X", "W", "WhiteList", "BlackList"),
             diff_inputs=("W",), needs_lod=True,
             attr_defaults={"num_emb": 8, "space_len": 1000,
                            "pyramid_layer": 2, "rand_len": 8,
                            "drop_out_percent": 0, "is_training": False,
                            "use_filter": False, "white_list_len": 0,
                            "black_list_len": 0, "seed": 0, "lr": 1.0,
                            "distribute_update_vars": ""})
def _pyramid_hash(ins, attrs):
    """The TPU kernel's pyramid hash embedding: at each position the
    n-grams (n = 2 .. pyramid_layer + 1) that stay in its sequence, each
    hashed on the host (numpy uint64, the TPU kernel's mix) to
    ``num_emb / rand_len`` windows of ``rand_len`` rows of the flat W,
    gathered (``take_rows``) and summed. As the TPU kernel, WhiteList,
    BlackList and the dropout attrs are not read."""
    x, w = first(ins, "X"), first(ins, "W")
    lods = (attrs.get("_lod") or {}).get("X")
    offs = (np.asarray(lods[0][-1], np.int64) if lods and lods[0]
            else np.asarray([0, x.shape[0]], np.int64))
    num_emb = int(attrs.get("num_emb", 8))
    rand_len = int(attrs.get("rand_len", 8))
    space = int(attrs.get("space_len", 1000))
    layers = int(attrs.get("pyramid_layer", 2))
    ids = _host(x).reshape(-1)
    T = len(ids)
    wflat = w.reshape(-1, 1)
    acc = torch.zeros((T, num_emb), dtype=w.dtype, device=w.device)
    for n_ in range(2, layers + 2):
        keys = np.zeros(T, np.uint64)   # the n-gram keys wrap modulo 2^64
        valid = np.zeros(T, np.float32)
        for t in range(T):
            s_i = np.searchsorted(offs, t, side="right") - 1
            if t + n_ <= offs[s_i + 1]:
                k = np.uint64(0)
                with np.errstate(over="ignore"):
                    for g in range(n_):
                        k = k * np.uint64(1000003) + np.uint64(ids[t + g])
                keys[t] = k
                valid[t] = 1.0
        cols = []
        for c in range(num_emb // rand_len):
            salt = np.uint64(0x9E3779B97F4A7C15 + c * 0x2545F4914F6CDD1D)
            v = (keys ^ salt) & np.uint64(0xFFFFFFFF)
            v = (v * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
            base = (v % np.uint64(max(space - rand_len, 1))).astype(np.int64)
            idx = base[:, None] + np.arange(rand_len)[None, :]
            cols.append(take_rows(wflat, _dev(idx, w.device))[..., 0])
        acc = acc + torch.cat(cols, dim=1) * _dev(valid, w.device)[:, None]
    return {"Out": [acc], "X_Temp_Out": [x],
            "_lod": {"Out": [lods[0]] if lods else []}}


@register_op("sequence_topk_avg_pooling", inputs=("X", "ROW", "COLUMN"),
             diff_inputs=("X",), needs_lod=True,
             attr_defaults={"topks": [1], "channel_num": 1})
def _sequence_topk_avg_pooling(ins, attrs):
    """Sequence i of X is [channel_num, rows_i, cols_i]; each row's
    ``k``-largest columns summed over k, for each k of ``topks`` (fewer
    when the row is shorter), joined as [rows_i, channel_num · |topks|];
    the rows of every sequence joined, their LoD by sequence."""
    x = first(ins, "X")
    topks = [int(t) for t in attrs.get("topks", [1])]
    ch = int(attrs.get("channel_num", 1))
    ro, co = _offsets(attrs, "ROW"), _offsets(attrs, "COLUMN")
    flat = x.reshape(-1)
    pos, pieces, lens = 0, [], []
    for i in range(len(ro) - 1):
        r, c = int(ro[i + 1] - ro[i]), int(co[i + 1] - co[i])
        m = flat[pos:pos + ch * r * c].reshape(ch, r, c)
        pos += ch * r * c
        srt = torch.sort(m, dim=2, descending=True).values
        feats = []
        for k in topks:
            kk = min(k, c)
            feats.append(srt[:, :, :kk].sum(dim=2) / k if kk
                         else x.new_zeros((ch, r)))
        pieces.append(torch.stack(feats, dim=2).permute(1, 0, 2)
                      .reshape(r, ch * len(topks)))
        lens.append(r)
    return {"Out": [torch.cat(pieces, dim=0)],
            "pos": [torch.zeros(1, dtype=torch.int32, device=x.device)],
            "_lod": {"Out": [_lod0(lens)]}}
