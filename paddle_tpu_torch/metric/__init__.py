"""``paddle.metric``: the port of ``paddle_tpu/metric/__init__.py``
(``Accuracy``, ``Precision``, ``Recall``, ``Auc``, ``accuracy``).

Every metric reads its inputs on the host, as the JAX one does (a sync
with the card each call).  ``Accuracy.compute`` and ``accuracy`` rank the
classes with the JAX code's ``np.argsort(-p)`` on the same float32 values,
so tied logits break the same way in both packages (a bf16 input is read
as float32 first: numpy has no bf16).  ``Accuracy.compute`` returns its
0/1 matrix as a CPU tensor, ``accuracy`` a 0-d tensor on its input's
device.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p = _host(pred)
        l = _host(label)
        if l.ndim == p.ndim and l.shape[-1] == 1:
            l = l.squeeze(-1)
        idx = np.argsort(-p, axis=-1)[..., : self.maxk]
        correct = idx == l[..., None]
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _host(correct)
        for i, k in enumerate(self.topk):
            hit = c[..., :k].sum(-1).mean()
            self.total[i] += float(c[..., :k].sum())
            self.count[i] += int(np.prod(c.shape[:-1]))
        accs = [self.total[i] / max(self.count[i], 1) for i in range(len(self.topk))]
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        accs = [self.total[i] / max(self.count[i], 1) for i in range(len(self.topk))]
        return accs[0] if len(accs) == 1 else accs

    def name(self):
        return [f"{self._name}_top{k}" if k > 1 else self._name for k in self.topk] \
            if len(self.topk) > 1 else [self._name]


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _host(preds)
        l = _host(labels)
        pred_pos = (p > 0.5).astype(np.int64).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_pos == 1) & (l == 1)).sum())
        self.fp += int(((pred_pos == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _host(preds)
        l = _host(labels)
        pred_pos = (p > 0.5).astype(np.int64).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_pos == 1) & (l == 1)).sum())
        self.fn += int(((pred_pos == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _host(preds)
        l = _host(labels).reshape(-1)
        if p.ndim == 2:
            p = p[:, 1]
        bins = np.clip((p * self.num_thresholds).astype(int), 0, self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        area = 0.0
        pos = neg = 0.0
        for i in range(self.num_thresholds, -1, -1):
            area += self._stat_pos[i] * (neg + self._stat_neg[i] / 2)
            pos += self._stat_pos[i]
            neg += self._stat_neg[i]
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    p = _host(input)
    l = _host(label)
    if l.ndim == 2 and l.shape[-1] == 1:
        l = l.squeeze(-1)
    idx = np.argsort(-p, axis=-1)[..., :k]
    hit = (idx == l[..., None]).any(-1).mean()
    return torch.tensor(np.float32(hit), device=input.device)
