"""Host-side metrics over fetched numpy values (counterpart of
paddle_tpu/fluid/metrics.py; reference: python/paddle/fluid/metrics.py):
MetricBase, CompositeMetric, Precision, Recall, Accuracy, ChunkEvaluator,
EditDistance, Auc, and DetectionMAP, which raises until the detection
ops are ported (ROADMAP A7), as in the TPU package.

A training script fetches a batch's value (``fluid.layers.accuracy``'s
output, the chunk counts, the distances) and ``update``s the metric with
it; ``eval`` gives the running result. Nothing here touches the device."""
from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Precision", "Recall", "Accuracy",
           "ChunkEvaluator", "EditDistance", "Auc", "DetectionMAP"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k in list(self.__dict__):
            if not k.startswith("_"):
                v = self.__dict__[k]
                if isinstance(v, (int,)):
                    self.__dict__[k] = 0
                elif isinstance(v, float):
                    self.__dict__[k] = 0.0

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no data updated into Accuracy metric")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        for p, l in zip(preds, labels):
            if p == 1:
                if l == 1:
                    self.tp += 1
                else:
                    self.fp += 1

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        for p, l in zip(preds, labels):
            if l == 1:
                if p == 1:
                    self.tp += 1
                else:
                    self.fn += 1

    def eval(self):
        rec = self.tp + self.fn
        return float(self.tp) / rec if rec else 0.0


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(num_thresholds + 1, np.int64)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        for i, l in enumerate(labels):
            b = min(int(preds[i, 1] * self._num_thresholds),
                    self._num_thresholds)
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        from ..utils.metrics import auc_from_histograms
        return auc_from_histograms(self._stat_pos, self._stat_neg)


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).reshape(-1)[0])
        self.num_label_chunks += int(np.asarray(num_label_chunks).reshape(-1)[0])
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).reshape(-1)[0])

    def eval(self):
        p = self.num_correct_chunks / self.num_infer_chunks \
            if self.num_infer_chunks else 0.0
        r = self.num_correct_chunks / self.num_label_chunks \
            if self.num_label_chunks else 0.0
        f1 = 2 * p * r / (p + r) if self.num_correct_chunks else 0.0
        return p, r, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances != 0))

    def eval(self):
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class DetectionMAP:
    """Raises, as the TPU package's DetectionMAP does (its metrics.py:170),
    with its reason. The op is ported: ``layers.detection_map`` appends
    detection_map with its accumulated state."""

    def __init__(self, *a, **k):
        raise NotImplementedError(
            "DetectionMAP: detection batch pending (the TPU package's "
            "DetectionMAP raises the same; use layers.detection_map)")
