"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (the reference's
``python/mxnet/metric.py``): the ``EvalMetric`` base, ``Accuracy``,
``F1``, ``MAE``/``MSE``/``RMSE``, ``TopKAccuracy``, ``CrossEntropy``,
``Loss``, ``CustomMetric``, ``Torch``, the ``np`` decorator helper, the
``create`` factory and ``check_label_shapes``. Labels and predictions
are NDArrays, torch tensors (on any device; they are read on the host)
or numpy arrays; the values are the JAX package's on the same inputs.
"""
from __future__ import annotations

import numpy
import torch

from .base import MXNetError

__all__ = ["Torch", "check_label_shapes", "EvalMetric", "Accuracy", "F1",
           "MAE", "MSE", "RMSE", "CrossEntropy", "TopKAccuracy", "Loss",
           "CustomMetric", "create", "np"]


def _as_numpy(x):
    if hasattr(x, "asnumpy"):  # an NDArray
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return numpy.asarray(x)


class EvalMetric:
    """Base metric accumulating (sum_metric, num_inst)."""

    def __init__(self, name):
        self.name = name
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst


class Accuracy(EvalMetric):
    """Classification accuracy (argmax over axis 1)."""

    def __init__(self):
        super().__init__("accuracy")

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise MXNetError("labels and preds length mismatch")
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(numpy.int32)
            pred_label = numpy.argmax(pred, axis=1)
            self.sum_metric += int((pred_label.flat == label.flat).sum())
            self.num_inst += len(pred_label.flat)


class F1(EvalMetric):
    """Binary F1 score (reference metric.py:83)."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).astype(numpy.int32)
            pred_label = numpy.argmax(pred, axis=1)
            if len(numpy.unique(label)) > 2:
                raise MXNetError("F1 currently only supports binary"
                                 " classification.")
            tp = numpy.sum((pred_label == 1) & (label == 1))
            fp = numpy.sum((pred_label == 1) & (label == 0))
            fn = numpy.sum((pred_label == 0) & (label == 1))
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            if precision + recall > 0:
                self.sum_metric += 2 * precision * recall \
                    / (precision + recall)
            self.num_inst += 1


def _regression(name, per_batch):
    class _Metric(EvalMetric):
        def __init__(self):
            super().__init__(name)

        def update(self, labels, preds):
            for label, pred in zip(labels, preds):
                label = _as_numpy(label)
                pred = _as_numpy(pred)
                if len(label.shape) == 1:
                    label = label.reshape(label.shape[0], 1)
                self.sum_metric += per_batch(label, pred)
                self.num_inst += 1
    return _Metric


class MAE(_regression("mae", lambda l, p: numpy.abs(l - p).mean())):
    """Mean absolute error, averaged over batches."""


class MSE(_regression("mse", lambda l, p: ((l - p) ** 2.0).mean())):
    """Mean squared error, averaged over batches."""


class RMSE(_regression(
        "rmse", lambda l, p: numpy.sqrt(((l - p) ** 2.0).mean()))):
    """Root mean squared error, averaged over batches."""


class TopKAccuracy(EvalMetric):
    """Top-k classification accuracy: correct if the true label is among
    the k highest-scoring classes (k=1 is Accuracy)."""

    def __init__(self, top_k=5):
        if top_k < 1:
            raise ValueError("top_k must be >= 1")
        self.top_k = int(top_k)
        super().__init__("top_k_accuracy_%d" % self.top_k)

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise MXNetError("labels and preds length mismatch")
        for label, pred in zip(labels, preds):
            pred = _as_numpy(pred)
            label = _as_numpy(label).ravel().astype(numpy.int64)
            if pred.shape[1] <= self.top_k:
                raise MXNetError(
                    "top_k_accuracy_%d is meaningless for %d classes "
                    "(every label is trivially in the top %d) — use a "
                    "smaller top_k" % (self.top_k, pred.shape[1],
                                       self.top_k))
            k = self.top_k
            topk = numpy.argpartition(pred, -k, axis=1)[:, -k:]
            self.sum_metric += int((topk == label[:, None]).any(axis=1)
                                   .sum())
            self.num_inst += label.shape[0]


class CrossEntropy(EvalMetric):
    """Summed -log p[label] over the rows of probability outputs."""

    def __init__(self):
        super().__init__("cross-entropy")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            if label.shape[0] != pred.shape[0]:
                raise MXNetError("cross-entropy: %d labels for %d rows"
                                 % (label.shape[0], pred.shape[0]))
            prob = pred[numpy.arange(label.shape[0]),
                        label.astype(numpy.int64)]
            self.sum_metric += (-numpy.log(numpy.maximum(prob, 1e-30))).sum()
            self.num_inst += label.shape[0]


class Loss(EvalMetric):
    """Mean of the monitored outputs themselves: for loss-emitting heads
    (``SoftmaxCELoss``) whose output IS the per-example loss."""

    def __init__(self):
        super().__init__("loss")

    def update(self, labels, preds):
        for pred in preds:
            pred = _as_numpy(pred)
            self.sum_metric += pred.sum()
            self.num_inst += pred.size


class CustomMetric(EvalMetric):
    """Wrap a ``feval(label, pred) -> float`` over numpy arrays."""

    def __init__(self, feval, name=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            self.sum_metric += self._feval(_as_numpy(label),
                                           _as_numpy(pred))
            self.num_inst += 1


def np(numpy_feval, name=None):
    """Create a CustomMetric from a numpy feval (reference metric.np)."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name)


def create(metric):
    """Create by name or pass through callables (reference
    metric.create)."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    metrics = {"acc": Accuracy, "accuracy": Accuracy, "f1": F1, "mae": MAE,
               "mse": MSE, "rmse": RMSE, "ce": CrossEntropy,
               "cross-entropy": CrossEntropy, "loss": Loss,
               "top_k_accuracy": TopKAccuracy, "top_k_acc": TopKAccuracy,
               "torch": lambda: Torch()}
    try:
        return metrics[metric.lower()]()
    except KeyError:
        raise ValueError("Metric must be either callable or in %s"
                         % sorted(metrics))


def check_label_shapes(labels, preds, shape=0):
    """Check that label/pred collections agree in size (reference
    metric.py:9-19)."""
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}"
            .format(label_shape, pred_shape))


class Torch(EvalMetric):
    """Dummy metric for torch criterions (reference metric.py:188): the
    criterion's forward already IS the loss, so just average it."""

    def __init__(self):
        super().__init__('torch')

    def update(self, _, preds):
        for pred in preds:
            self.sum_metric += float(_as_numpy(pred).mean())
        self.num_inst += 1
