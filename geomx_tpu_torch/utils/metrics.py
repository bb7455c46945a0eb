"""Evaluation metrics with streaming (update/get/reset) semantics, plus
a process-wide system-metrics registry (counters/gauges).

Mirrors the reference metric surface (ref: python/mxnet/metric.py —
EvalMetric base with update/get/reset, Accuracy, TopKAccuracy, F1, MAE,
MSE/RMSE, CrossEntropy, CompositeEvalMetric, and ``create`` by name).
Host-side numpy: metrics consume per-batch (labels, predictions) after
device readback, matching how the examples report accuracy per step.

System metrics are the runtime-health side: named counters (failover
events, fenced replication rejects) and gauges (replication lag) that
subsystems register by dotted name — ``<node>.<metric>`` — and tests or
operators read back with :func:`system_snapshot`.  Registration is
get-or-create, so readers and writers need no setup ordering.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np


class Counter:
    """Monotonic system counter (thread-safe)."""

    def __init__(self):
        self._v = 0
        self._mu = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._mu:
            self._v += n

    @property
    def value(self) -> int:
        with self._mu:
            return self._v


class Gauge:
    """Last-value system gauge (thread-safe)."""

    def __init__(self):
        self._v = float("nan")
        self._mu = threading.Lock()

    def set(self, v: float) -> None:
        with self._mu:
            self._v = float(v)

    @property
    def value(self) -> float:
        with self._mu:
            return self._v


_SYS_MU = threading.Lock()
_SYSTEM: Dict[str, Union[Counter, Gauge]] = {}


def _system(name: str, cls):
    with _SYS_MU:
        m = _SYSTEM.get(name)
        if m is None:
            m = _SYSTEM[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(f"system metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m


def system_counter(name: str) -> Counter:
    """Get-or-create a named counter (e.g. ``global_server:0.failover``)."""
    return _system(name, Counter)


def system_gauge(name: str) -> Gauge:
    """Get-or-create a named gauge (e.g. ``...replication_lag_s``)."""
    return _system(name, Gauge)


def system_snapshot(prefix: str = "",
                    skip_unset: bool = False) -> Dict[str, float]:
    """Current values of every registered system metric under ``prefix``.

    ``skip_unset`` drops never-set gauges (value NaN): NaN is invalid
    JSON and poisons any serialized dump that includes it, so every
    wire/exposition boundary (the metrics pump, the Prometheus dump)
    snapshots with it on.
    """
    import math

    with _SYS_MU:
        out = {k: m.value for k, m in _SYSTEM.items()
               if k.startswith(prefix)}
    if skip_unset:
        out = {k: v for k, v in out.items()
               if not (isinstance(v, float) and math.isnan(v))}
    return out


def reset_system_metrics() -> None:
    """Clear the process-global registry.

    The registry deliberately outlives any one deployment (readers and
    writers need no setup ordering), which means counters bleed across
    sequential ``Simulation``s in one pytest process.  Tests reset
    between cases for a clean slate; handles already held by live
    objects keep working, they are simply no longer visible to new
    :func:`system_snapshot` readers (a fresh ``system_counter(name)``
    after the reset returns a fresh zeroed instance).
    """
    with _SYS_MU:
        _SYSTEM.clear()


class EvalMetric:
    name = "metric"

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.sum_metric = 0.0
        self.num_inst = 0

    def update(self, labels: np.ndarray, preds: np.ndarray) -> None:
        raise NotImplementedError

    def get(self) -> Tuple[str, float]:
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst


class Accuracy(EvalMetric):
    name = "accuracy"

    def update(self, labels, preds):
        preds = np.asarray(preds)
        if preds.ndim > 1:
            preds = np.argmax(preds, axis=-1)
        labels = np.asarray(labels).reshape(preds.shape)
        self.sum_metric += float((preds == labels).sum())
        self.num_inst += labels.size


class TopKAccuracy(EvalMetric):
    def __init__(self, top_k: int = 5):
        self.top_k = top_k
        self.name = f"top_{top_k}_accuracy"
        super().__init__()

    def update(self, labels, preds):
        preds = np.asarray(preds)
        if preds.ndim != 2:
            raise ValueError("TopKAccuracy needs [batch, classes] scores")
        labels = np.asarray(labels).reshape(len(preds))
        k = min(self.top_k, preds.shape[1])  # top-k over <k classes: all hit
        top = np.argpartition(preds, -k, axis=-1)[:, -k:]
        self.sum_metric += float((top == labels[:, None]).any(-1).sum())
        self.num_inst += len(labels)


class F1(EvalMetric):
    """Binary F1 (ref: metric.py class F1 — positive class = 1)."""

    name = "f1"

    def reset(self):
        self.tp = self.fp = self.fn = 0

    def update(self, labels, preds):
        preds = np.asarray(preds)
        if preds.ndim > 1:
            preds = np.argmax(preds, axis=-1)
        labels = np.asarray(labels).reshape(preds.shape)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def get(self):
        prec = self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0
        rec = self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return self.name, f1


class MAE(EvalMetric):
    name = "mae"

    def update(self, labels, preds):
        labels = np.asarray(labels, np.float64)
        preds = np.asarray(preds, np.float64).reshape(labels.shape)
        self.sum_metric += float(np.abs(labels - preds).sum())
        self.num_inst += labels.size


class MSE(EvalMetric):
    name = "mse"

    def update(self, labels, preds):
        labels = np.asarray(labels, np.float64)
        preds = np.asarray(preds, np.float64).reshape(labels.shape)
        self.sum_metric += float(np.square(labels - preds).sum())
        self.num_inst += labels.size


class RMSE(MSE):
    name = "rmse"

    def get(self):
        name, mse = super().get()
        return self.name, float(np.sqrt(mse))


class CrossEntropy(EvalMetric):
    """NLL of the label under per-class probabilities
    (ref: metric.py class CrossEntropy)."""

    name = "cross-entropy"

    def __init__(self, eps: float = 1e-12):
        self.eps = eps
        super().__init__()

    def update(self, labels, preds):
        preds = np.asarray(preds, np.float64)
        labels = np.asarray(labels).reshape(len(preds)).astype(np.int64)
        p = preds[np.arange(len(preds)), labels]
        self.sum_metric += float(-np.log(np.maximum(p, self.eps)).sum())
        self.num_inst += len(labels)


class CompositeEvalMetric(EvalMetric):
    """Aggregate several metrics over one update stream
    (ref: metric.py CompositeEvalMetric)."""

    name = "composite"

    def __init__(self, metrics: Sequence[EvalMetric]):
        self.metrics = list(metrics)
        super().__init__()

    def reset(self):
        for m in self.metrics:
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self) -> Tuple[List[str], List[float]]:
        pairs = [m.get() for m in self.metrics]
        return [n for n, _ in pairs], [v for _, v in pairs]


_REGISTRY = {
    "acc": Accuracy, "accuracy": Accuracy, "top_k_accuracy": TopKAccuracy,
    "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE,
    "ce": CrossEntropy, "cross-entropy": CrossEntropy,
}


def create(name: str, **kwargs) -> EvalMetric:
    """Metric by name (ref: metric.py ``create``)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; choose from {sorted(_REGISTRY)}"
        ) from None
    return cls(**kwargs)
