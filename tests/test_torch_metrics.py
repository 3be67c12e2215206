"""fluid.metrics and fluid.average of the port (paddle_tpu_torch/fluid/
metrics.py, average.py) against the TPU package's (paddle_tpu/fluid/
metrics.py, average.py): each class's ``eval()`` on the same values,
seeded with numpy, equal to the TPU package's (exactly: the same host
arithmetic over the same numbers), across several updates and after a
``reset``; and Accuracy over a program's fetched batch accuracies equal
to the sample-weighted mean of them.
"""
import numpy as np
import pytest

from paddle_tpu.fluid import average as javerage
from paddle_tpu.fluid import metrics as jmetrics
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import average as taverage
from paddle_tpu_torch.fluid import metrics as tmetrics


def _updates(name, rng):
    """Three updates' arguments for metric ``name``."""
    out = []
    for _ in range(3):
        n = int(rng.randint(5, 40))
        if name == "Accuracy":
            out.append((np.array([rng.rand()], np.float32), n))
        elif name in ("Precision", "Recall"):
            out.append((rng.rand(n, 1).astype(np.float32),
                        rng.randint(0, 2, (n, 1)).astype(np.int64)))
        elif name == "Auc":
            p = rng.rand(n, 1).astype(np.float32)
            out.append((np.concatenate([1 - p, p], axis=1),
                        rng.randint(0, 2, (n, 1)).astype(np.int64)))
        elif name == "ChunkEvaluator":
            infer, label = rng.randint(1, 20, 2)
            out.append((np.array([infer]), np.array([label]),
                        np.array([min(infer, label, rng.randint(0, 20))])))
        elif name == "EditDistance":
            out.append((rng.randint(0, 3, (n, 1)).astype(np.float32), n))
    return out


NAMES = ["Accuracy", "Precision", "Recall", "Auc", "ChunkEvaluator",
         "EditDistance"]


@pytest.mark.parametrize("name", NAMES)
def test_metric_eval_equals_the_tpu_package(name):
    rng = np.random.RandomState(NAMES.index(name))
    ups = _updates(name, rng)
    t, j = getattr(tmetrics, name)(), getattr(jmetrics, name)()
    for args in ups:
        t.update(*args)
        j.update(*args)
        assert t.eval() == j.eval()
    t.reset()
    j.reset()
    if name in ("Precision", "Recall", "ChunkEvaluator"):
        assert t.eval() == j.eval()
    t.update(*ups[0])
    j.update(*ups[0])
    assert t.eval() == j.eval()


def test_accuracy_without_data_raises_as_the_tpu_package():
    for m in (tmetrics.Accuracy(), jmetrics.Accuracy()):
        with pytest.raises(ValueError, match="no data"):
            m.eval()


def test_composite_metric_and_names():
    rng = np.random.RandomState(9)
    preds = rng.rand(30, 1).astype(np.float32)
    labels = rng.randint(0, 2, (30, 1)).astype(np.int64)
    got = []
    for mod in (tmetrics, jmetrics):
        c = mod.CompositeMetric()
        c.add_metric(mod.Precision())
        c.add_metric(mod.Recall())
        c.update(preds, labels)
        got.append(c.eval())
    assert got[0] == got[1]
    assert tmetrics.Accuracy("acc")._name == "acc"
    assert tmetrics.__all__ == jmetrics.__all__
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tmetrics.DetectionMAP()


def test_weighted_average_equals_the_tpu_package():
    rng = np.random.RandomState(3)
    t, j = taverage.WeightedAverage(), javerage.WeightedAverage()
    for _ in range(5):
        v = rng.rand(int(rng.randint(1, 6))).astype(np.float32)
        w = int(rng.randint(1, 10))
        t.add(v, w)
        j.add(v, w)
        assert t.eval() == j.eval()
    for avg in (t, j):
        avg.reset()
        with pytest.raises(ValueError):
            avg.eval()
        with pytest.raises(ValueError):
            avg.add([1.0, 2.0], 1)


def test_accuracy_accumulates_fetched_batch_accuracies():
    """The training-script idiom: fetch ``layers.accuracy`` per batch,
    ``update(value, weight=batch size)``; eval() is the sample-weighted
    mean of the fetched values, and the accuracy over all the rows."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.data("x", shape=[6], dtype="float32")
        y = tfluid.data("y", shape=[1], dtype="int64")
        pred = tfluid.layers.fc(x, 4, act="softmax")
        acc = tfluid.layers.accuracy(pred, y)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(5)
    metric = tmetrics.Accuracy()
    vals, weights, hits = [], [], 0
    for n in (8, 5, 11):
        feed = {"x": rng.randn(n, 6).astype(np.float32),
                "y": rng.randint(0, 4, (n, 1)).astype(np.int64)}
        a, p = exe.run(main, feed=feed, fetch_list=[acc, pred], scope=scope)
        metric.update(a, n)
        vals.append(float(a.reshape(-1)[0]))
        weights.append(n)
        hits += int((p.argmax(1) == feed["y"].ravel()).sum())
    want = sum(v * w for v, w in zip(vals, weights)) / sum(weights)
    assert metric.eval() == pytest.approx(want, rel=1e-12)
    assert metric.eval() == pytest.approx(hits / sum(weights), rel=1e-6)
