"""Metric ops (counterpart of paddle_tpu/ops/metrics_misc_ops.py; so far
its detection_map, PASCAL VOC's mAP; reference: detection_map_op.cc).

A host op (``stateful``), the TPU package's numpy: the detections of
each image are matched greedily, best score first, to its ground truths
of their class at ``overlap_threshold`` IoU; each class's (score, hit)
records, with those of the state carried in (HasState, PosCount,
TruePos, FalsePos), give its AP (``integral`` or ``11point``), and their
mean is the mAP."""
from __future__ import annotations

import numpy as np
import torch

from .detection_ops import _dev, _host, _lod0, _lod_offs
from .registry import register_op, first


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
