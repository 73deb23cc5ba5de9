# copied from mxnet_tpu/metric.py (backend-free: numpy on the host)
"""Evaluation metrics.

Counterpart of the reference's python/mxnet/metric.py:22-427 (EvalMetric base,
Accuracy/TopKAccuracy/F1/Perplexity/MAE/MSE/RMSE/CrossEntropy, CustomMetric,
CompositeEvalMetric, np() wrapper, create registry). Metrics accumulate on
host numpy — the single host↔device sync point of the training loop, exactly
where the reference also blocks (executor_group.py:511 update_metric →
asnumpy).
"""
from __future__ import annotations

import numpy

__all__ = [
    "EvalMetric",
    "Accuracy",
    "TopKAccuracy",
    "F1",
    "Perplexity",
    "MAE",
    "MSE",
    "RMSE",
    "CrossEntropy",
    "Torch",
    "Caffe",
    "CustomMetric",
    "CompositeEvalMetric",
    "Loss",
    "np",
    "create",
]


def check_label_shapes(labels, preds, shape=False):
    if shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape[0], preds.shape[0]
    if label_shape != pred_shape:
        raise ValueError(
            "Shape of labels %d does not match shape of predictions %d" % (label_shape, pred_shape)
        )


class EvalMetric:
    """Base accumulator (reference: metric.py EvalMetric)."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def get(self):
        if self.num is None:
            if self.num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.sum_metric / self.num_inst)
        names = ["%s_%d" % (self.name, i) for i in range(self.num)]
        values = [
            x / y if y != 0 else float("nan") for x, y in zip(self.sum_metric, self.num_inst)
        ]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    """Manage multiple metrics as one (reference: CompositeEvalMetric)."""

    def __init__(self, metrics=None, **kwargs):
        # before super(): EvalMetric.__init__ calls reset(), which iterates
        # self.metrics (the reference instead swallowed the AttributeError)
        self.metrics = [create(m) if isinstance(m, str) else m for m in (metrics or [])]
        super().__init__("composite", **kwargs)

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str) else metric)

    def get_metric(self, index):
        if not 0 <= index < len(self.metrics):
            # unlike the reference (which RETURNED the exception), raise it
            raise ValueError("metric index %d out of range [0, %d)"
                             % (index, len(self.metrics)))
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in self.metrics:
            m.reset()

    def get(self):
        pairs = [m.get() for m in self.metrics]
        names, values = zip(*pairs) if pairs else ((), ())
        return (list(names), list(values))


def _asnumpy(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else numpy.asarray(x)


class Accuracy(EvalMetric):
    def __init__(self):
        super().__init__("accuracy")

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred_label in zip(labels, preds):
            pred_label = _asnumpy(pred_label)
            label = _asnumpy(label)
            if pred_label.ndim > label.ndim:
                pred_label = numpy.argmax(pred_label, axis=1)
            pred_label = pred_label.astype("int32").ravel()
            label = label.astype("int32").ravel()
            check_label_shapes(label, pred_label)
            self.sum_metric += (pred_label == label).sum()
            self.num_inst += len(pred_label)


class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, **kwargs):
        super().__init__("top_k_accuracy")
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred_label in zip(labels, preds):
            pred_label = _asnumpy(pred_label)
            label = _asnumpy(label).astype("int32")
            assert len(pred_label.shape) <= 2, "Predictions should be no more than 2 dims"
            pred_label = numpy.argsort(pred_label.astype("float32"), axis=1)
            check_label_shapes(label, pred_label)
            num_samples = pred_label.shape[0]
            num_dims = len(pred_label.shape)
            if num_dims == 1:
                self.sum_metric += (pred_label.ravel() == label.ravel()).sum()
            elif num_dims == 2:
                num_classes = pred_label.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (pred_label[:, num_classes - 1 - j].ravel() == label.ravel()).sum()
            self.num_inst += num_samples


class F1(EvalMetric):
    """Binary-classification F1 (reference: metric.py F1)."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            pred = _asnumpy(pred)
            label = _asnumpy(label).astype("int32")
            pred_label = numpy.argmax(pred, axis=1)
            check_label_shapes(label, pred)
            if len(numpy.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary classification.")
            true_positives, false_positives, false_negatives = 0.0, 0.0, 0.0
            for y_pred, y_true in zip(pred_label, label):
                if y_pred == 1 and y_true == 1:
                    true_positives += 1.0
                elif y_pred == 1 and y_true == 0:
                    false_positives += 1.0
                elif y_pred == 0 and y_true == 1:
                    false_negatives += 1.0
            if true_positives + false_positives > 0:
                precision = true_positives / (true_positives + false_positives)
            else:
                precision = 0.0
            if true_positives + false_negatives > 0:
                recall = true_positives / (true_positives + false_negatives)
            else:
                recall = 0.0
            if precision + recall > 0:
                f1_score = 2 * precision * recall / (precision + recall)
            else:
                f1_score = 0.0
            self.sum_metric += f1_score
            self.num_inst += 1


class Perplexity(EvalMetric):
    """exp(mean NLL) with optional ignored label (reference: Perplexity)."""

    def __init__(self, ignore_label, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            assert label.size == pred.size / pred.shape[-1], (
                "shape mismatch: %s vs. %s" % (label.shape, pred.shape)
            )
            label = label.reshape((label.size,)).astype("int32")
            probs = pred.reshape(-1, pred.shape[-1])[numpy.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= int(numpy.sum(ignore))
                probs = probs * (1 - ignore) + ignore
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label.size
        if num > 0:
            self.sum_metric += numpy.exp(loss / num)
            self.num_inst += 1
        # num == 0 (every label ignored, e.g. an all-padding bucket batch)
        # contributes nothing rather than poisoning the epoch with NaN



def _align_regression(label, pred):
    """Shape-align a (label, pred) pair for elementwise error metrics: lift a
    rank-1 label to (B, 1) (reference layout) and reshape a same-size pred to
    match — otherwise (B,1)-(B,) broadcasts into a (B,B) matrix and the
    metric reports a constant ~sqrt(var(label)+var(pred))."""
    if len(label.shape) == 1:
        label = label.reshape(label.shape[0], 1)
    if pred.shape != label.shape and pred.size == label.size:
        pred = pred.reshape(label.shape)
    return label, pred


class MAE(EvalMetric):
    def __init__(self):
        super().__init__("mae")

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            label, pred = _align_regression(label, pred)
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1


class MSE(EvalMetric):
    def __init__(self):
        super().__init__("mse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            label, pred = _align_regression(label, pred)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


class RMSE(EvalMetric):
    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            label, pred = _align_regression(label, pred)
            self.sum_metric += numpy.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds, shape=True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


class Loss(EvalMetric):
    """Mean of raw outputs — for MakeLoss-style nets (later mxnet parity)."""

    def __init__(self):
        super().__init__("loss")

    def update(self, _, preds):
        for pred in preds:
            pred = _asnumpy(pred)
            self.sum_metric += pred.sum()
            self.num_inst += pred.size


class Torch(Loss):
    def __init__(self, name="torch"):
        super(Loss, self).__init__(name)


class Caffe(Torch):
    def __init__(self):
        super(Loss, self).__init__("caffe")


class CustomMetric(EvalMetric):
    """Wrap feval(label, pred) (reference: CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds, shape=True)
        for pred, label in zip(preds, labels):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Lift a numpy feval into a metric (reference: metric.np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, **kwargs):
    """Create by name/callable/list (reference: metric.create)."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite_metric = CompositeEvalMetric()
        for child_metric in metric:
            composite_metric.add(create(child_metric, **kwargs))
        return composite_metric
    metrics = {
        "acc": Accuracy,
        "accuracy": Accuracy,
        "ce": CrossEntropy,
        "f1": F1,
        "mae": MAE,
        "mse": MSE,
        "rmse": RMSE,
        "top_k_accuracy": TopKAccuracy,
        "perplexity": Perplexity,
        "loss": Loss,
    }
    try:
        return metrics[metric.lower()](**kwargs)
    except Exception:
        raise ValueError("Metric must be either callable or in %s" % sorted(metrics))
