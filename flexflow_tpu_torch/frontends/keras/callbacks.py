"""Keras callbacks; counterpart of
``flexflow_tpu/frontends/keras/callbacks.py`` (reference:
python/flexflow/keras/callbacks.py and the accuracy-assert callback used
by tests/accuracy_tests.sh). They read the logs dict of the port's
``FFModel.fit`` (``loss``, ``accuracy``, ``throughput``, ``epoch``)."""

from __future__ import annotations


class Callback:
    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", min_delta=0.0, patience=0,
                 mode="min"):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stopped_epoch = None

    def on_train_begin(self, logs=None):
        self.best = None
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        better = (self.best is None
                  or (self.mode == "min" and cur < self.best - self.min_delta)
                  or (self.mode == "max" and cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped_epoch = epoch
                self.model.stop_training = True


class VerifyMetrics(Callback):
    """Assert a final metric threshold (the accuracy_tests.sh pattern:
    examples/python/keras/accuracy.py)."""

    def __init__(self, metric="accuracy", threshold=0.9):
        self.metric = metric
        self.threshold = threshold
        self.last = None

    def on_epoch_end(self, epoch, logs=None):
        self.last = (logs or {}).get(self.metric)

    def on_train_end(self, logs=None):
        if self.last is None or self.last < self.threshold:
            raise AssertionError(f"{self.metric}={self.last} below "
                                 f"threshold {self.threshold}")


class LearningRateScheduler(Callback):
    """Per-epoch LR schedule (reference:
    python/flexflow/keras/callbacks.py:49-62, which rewrote the
    config's learning rate each epoch). Here `schedule(epoch) -> lr`
    rescales the staged lr input of the train programs — a captured
    step is never captured anew."""

    def __init__(self, schedule):
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        self.model.ffmodel.set_learning_rate(self.schedule(epoch))


class EpochVerifyMetrics(Callback):
    """Assert a metric threshold at EVERY epoch end (reference:
    python/flexflow/keras/callbacks.py:75-87; the per-epoch form of
    VerifyMetrics)."""

    def __init__(self, metric="accuracy", threshold=0.9):
        self.metric = metric
        self.threshold = threshold

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.metric)
        if cur is None or cur < self.threshold:
            raise AssertionError(f"epoch {epoch}: {self.metric}={cur} "
                                 f"below threshold {self.threshold}")
