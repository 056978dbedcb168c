"""The high-level ``paddle.Model``: the port of ``paddle_tpu/hapi/model.py``
(``prepare``, ``fit``, ``evaluate``, ``predict``, the ``*_batch`` calls,
``save`` / ``load``, ``summary``).

The loop is the JAX one, step for step: eager (no ``to_static``), one
``loss.item()`` a step (a sync with the card), the metrics computed on the
host after each step, the callbacks in the JAX order (``ProgBarLogger``
when ``verbose``, and an ``LRScheduler`` stepping the optimizer's schedule
each step unless the caller gave one).  ``prepare``'s ``amp_configs`` is
accepted and ignored, as there.  A ``Dataset`` given to ``fit``,
``evaluate`` or ``predict`` becomes a :class:`~paddle_tpu_torch.io.DataLoader`
on the device of the network's parameters; ``evaluate`` and ``predict``
run under ``torch.no_grad()``.

``save(path)`` writes ``path.pdparams`` (and ``path.pdopt`` with the
optimizer's state) in the JAX package's format and layout
(``convert.to_paddle_tpu``, ``convert.optimizer_state_to_paddle_tpu``), so
``paddle_tpu``'s ``Model.load`` reads them; ``load`` reads what either
package's ``save`` wrote.  A key that does not match the network raises
(the JAX ``set_state_dict`` skips it).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from .. import convert, framework
from ..metric import Metric


class Model:
    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        return self

    def _device(self) -> torch.device:
        p = next(self.network.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def _loader(self, data, batch_size, num_workers, **kwargs):
        from ..io import DataLoader
        from ..io.dataset import Dataset

        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size,
                              num_workers=num_workers, places=self._device(),
                              **kwargs)
        return data

    def _run_batch(self, inputs, labels, train: bool):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        with torch.set_grad_enabled(train):
            preds = self.network(*inputs)
            preds_list = preds if isinstance(preds, (list, tuple)) else [preds]
            loss = self._loss(*preds_list, *labels) if self._loss else None
        if train:
            loss.backward()
            self._optimizer.step()
            self._optimizer.clear_grad()
        metric_out = []
        for m in self._metrics:
            res = m.compute(preds_list[0], labels[0])
            metric_out.append(m.update(res))
        return loss, metric_out

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        loss, metrics = self._run_batch(inputs, labels, train=update)
        return [loss.item()] if loss is not None else [], metrics

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        loss, metrics = self._run_batch(inputs, labels, train=False)
        return [loss.item()] if loss is not None else [], metrics

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        preds = self.network(*inputs)
        preds_list = preds if isinstance(preds, (list, tuple)) else [preds]
        return [p.detach().cpu().numpy() for p in preds_list]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None, **kwargs):
        from .callbacks import CallbackList, LRScheduler, ProgBarLogger

        train_loader = self._loader(train_data, batch_size, num_workers,
                                    shuffle=shuffle, drop_last=drop_last)
        cbs = list(callbacks or [])
        if not any(isinstance(c, ProgBarLogger) for c in cbs) and verbose:
            cbs.append(ProgBarLogger(log_freq, verbose))
        if not any(isinstance(c, LRScheduler) for c in cbs):
            cbs.append(LRScheduler(by_step=True))
        cb = CallbackList(cbs, self, {"epochs": epochs, "verbose": verbose})

        self.stop_training = False
        cb.call("on_train_begin")
        for epoch in range(epochs):
            self.network.train()
            for m in self._metrics:
                m.reset()
            cb.call("on_epoch_begin", epoch)
            losses = []
            for step, batch in enumerate(train_loader):
                cb.call("on_train_batch_begin", step)
                inputs, labels = batch[:-1], batch[-1:]
                loss, metrics = self._run_batch(list(inputs), list(labels), train=True)
                losses.append(loss.item())
                logs = {"loss": losses[-1]}
                for m in self._metrics:
                    name = m.name() if isinstance(m.name(), str) else m.name()[0]
                    acc = m.accumulate()
                    logs[name] = acc[0] if isinstance(acc, (list, tuple)) else acc
                cb.call("on_train_batch_end", step, logs)
            epoch_logs = {"loss": float(np.mean(losses))} if losses else {}
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                result = self.evaluate(eval_data, batch_size=batch_size,
                                       verbose=verbose)
                for k, v in result.items():
                    val = v[0] if isinstance(v, (list, tuple)) and v else v
                    if isinstance(val, (int, float)):
                        epoch_logs[f"eval_{k}"] = val
            cb.call("on_epoch_end", epoch, epoch_logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/epoch{epoch + 1}")
            if self.stop_training:
                break
        cb.call("on_train_end")
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, **kwargs):
        loader = self._loader(eval_data, batch_size, num_workers)
        self.network.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            inputs, labels = batch[:-1], batch[-1:]
            loss, _ = self._run_batch(list(inputs), list(labels), train=False)
            if loss is not None:
                losses.append(loss.item())
        result = {"loss": [float(np.mean(losses))] if losses else []}
        for m in self._metrics:
            name = m.name() if isinstance(m.name(), str) else m.name()[0]
            result[name] = m.accumulate()
        if verbose:
            print("Eval:", result)
        return result

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                callbacks=None, verbose=1):
        loader = self._loader(test_data, batch_size, num_workers)
        outputs = []
        for batch in loader:
            inputs = batch[:-1] if isinstance(batch, (list, tuple)) and len(batch) > 1 else (
                batch if not isinstance(batch, (list, tuple)) else batch[:1])
            outputs.append(self.predict_batch(list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]))
        return outputs

    def save(self, path, training=True):
        framework.save(convert.to_paddle_tpu(self.network), path + ".pdparams")
        if training and self._optimizer is not None:
            framework.save(convert.optimizer_state_to_paddle_tpu(
                self._optimizer.state_dict(), self.network), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        state = framework.load(path + ".pdparams", device="cpu")
        convert.load_paddle_tpu_state(self.network, state)
        if not reset_optimizer and self._optimizer is not None and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(convert.optimizer_state_from_paddle_tpu(
                framework.load(path + ".pdopt", device="cpu"), self.network))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        n_params = sum(p.numel() for p in self.network.parameters())
        lines = [repr(self.network), f"Total params: {n_params:,}"]
        out = "\n".join(lines)
        print(out)
        return {"total_params": n_params}
