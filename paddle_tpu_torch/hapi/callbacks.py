"""hapi callbacks: the port of ``paddle_tpu/hapi/callbacks.py`` (the
``Callback`` base, ``CallbackList``, ``ProgBarLogger``,
``ModelCheckpoint``, ``EarlyStopping``, ``LRScheduler``), invoked by
``Model.fit`` in the JAX order.  Pure Python, as there."""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]], model, params):
        self.callbacks = list(callbacks or [])
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def call(self, name, *args, **kwargs):
        for c in self.callbacks:
            getattr(c, name)(*args, **kwargs)


class ProgBarLogger(Callback):
    """(hapi ProgBarLogger analog) periodic step/epoch logging."""

    def __init__(self, log_freq: int = 10, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                             if isinstance(v, (int, float)))
            print(f"Epoch {self._epoch + 1} step {step} {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            items = " ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                             if isinstance(v, (int, float)))
            print(f"Epoch {epoch + 1} done ({time.time() - self._t0:.1f}s) {items}")


class ModelCheckpoint(Callback):
    """(hapi ModelCheckpoint analog) periodic save."""

    def __init__(self, save_freq: int = 1, save_dir: str = "checkpoint"):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/epoch{epoch + 1}")


class EarlyStopping(Callback):
    """(hapi EarlyStopping analog) stop when a monitored metric stalls."""

    def __init__(self, monitor: str = "loss", mode: str = "min",
                 patience: int = 0, min_delta: float = 0.0,
                 baseline: Optional[float] = None, save_best_model: bool = False):
        super().__init__()
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best = baseline if baseline is not None else (
            np.inf if mode == "min" else -np.inf)
        self.wait = 0
        self.stopped_epoch = -1

    def _improved(self, value) -> bool:
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        value = (logs or {}).get(self.monitor)
        if value is None:
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped_epoch = epoch
                if self.model is not None:
                    self.model.stop_training = True


class LRScheduler(Callback):
    """(hapi LRScheduler analog) step the optimizer's LR schedule."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()
