"""The port's ``Model``, callbacks, metrics, ``summary`` and ``flops`` held
to the JAX package's on the CPU (mirroring ``tests/test_extras.py:224-270``).

* ``Model.fit`` on LeNet and the synthetic MNIST (64 images, B=16, Adam,
  ``Accuracy(topk=(1, 2))``, shuffled under one ``np.random.seed``, 2
  epochs with ``evaluate`` each epoch) from the JAX model's weights: every
  step's loss within 1e-5 relative of the JAX run's, its accuracies equal,
  the epochs' losses and evaluate's results too; with ``num_workers`` 0
  and 2 (the ring) in the port.
* ``EarlyStopping`` stops both at the same epoch; the ``LRScheduler``
  callback steps a ``PolynomialDecay`` each step in both (the learning
  rates equal); ``ModelCheckpoint`` and ``save_dir`` write each epoch.
* ``train_batch`` / ``eval_batch`` / ``predict_batch`` and ``predict``
  within 1e-5.
* A ``.pdparams`` / ``.pdopt`` pair written by either package's
  ``Model.save`` loads in the other's ``Model.load``: weights bit-equal,
  and the next step's loss within 1e-5 relative.
* ``Accuracy`` (top-1 and top-k, on tied logits too), ``Precision``,
  ``Recall``, ``Auc`` and ``accuracy``: equal to the JAX values.
* ``summary`` and ``flops`` totals equal to JAX's on LeNet and a small
  ViT (convolutions, and linear layers over 2-D and 3-D inputs).
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.hapi.callbacks import Callback as JCallback
from paddle_tpu.hapi.callbacks import EarlyStopping as JEarlyStopping
from paddle_tpu.hapi.callbacks import ModelCheckpoint as JModelCheckpoint
from paddle_tpu.io import Subset as JSubset
from paddle_tpu.vision import datasets as jdatasets
from paddle_tpu.vision import models as jmodels
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.hapi.callbacks import Callback as PCallback
from paddle_tpu_torch.hapi.callbacks import EarlyStopping as PEarlyStopping
from paddle_tpu_torch.hapi.callbacks import ModelCheckpoint as PModelCheckpoint
from paddle_tpu_torch.io import Subset as PSubset
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.vision import datasets as pdatasets
from paddle_tpu_torch.vision import models as pmodels


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.steps, self.epochs = [], []

        def on_train_batch_end(self, step, logs=None):
            self.steps.append(dict(logs))

        def on_epoch_end(self, epoch, logs=None):
            self.epochs.append(dict(logs))

    return Recorder()


@pytest.fixture(scope="module")
def lenet_state():
    paddle.seed(13)
    jm = jmodels.LeNet()
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _jax_model(state, lr=1e-3):
    jm = jmodels.LeNet()
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    m = paddle.Model(jm)
    m.prepare(paddle.optimizer.Adam(learning_rate=lr,
                                    parameters=m.parameters()),
              paddle.nn.CrossEntropyLoss(),
              paddle.metric.Accuracy(topk=(1, 2)))
    return m


def _port_model(state, lr=1e-3):
    net = convert.lenet_from_paddle_tpu(state, device="cpu")
    m = pt.Model(net)
    m.prepare(Adam(learning_rate=lr, parameters=m.parameters()),
              pnn.CrossEntropyLoss(), pt.metric.Accuracy(topk=(1, 2)))
    return m


def _mnist(mod, sub, mode, n):
    return sub(mod.MNIST(mode=mode), range(n))


@pytest.fixture(scope="module")
def jax_fit(lenet_state):
    m = _jax_model(lenet_state)
    rec = _recorder(JCallback)
    np.random.seed(17)
    m.fit(_mnist(jdatasets, JSubset, "train", 64),
          eval_data=_mnist(jdatasets, JSubset, "test", 32), batch_size=16,
          epochs=2, verbose=0, callbacks=[rec])
    return rec, m.evaluate(_mnist(jdatasets, JSubset, "test", 32),
                           batch_size=16, verbose=0)


def _close(a, b, tol=1e-5):
    return abs(a - b) <= tol * abs(b)


@pytest.mark.parametrize("workers", [0, 2])
def test_fit_losses_and_accuracy_match_jax(lenet_state, jax_fit, workers):
    want, want_eval = jax_fit
    m = _port_model(lenet_state)
    rec = _recorder(PCallback)
    np.random.seed(17)
    m.fit(_mnist(pdatasets, PSubset, "train", 64),
          eval_data=_mnist(pdatasets, PSubset, "test", 32), batch_size=16,
          epochs=2, verbose=0, callbacks=[rec], num_workers=workers)
    got_eval = m.evaluate(_mnist(pdatasets, PSubset, "test", 32),
                          batch_size=16, verbose=0)
    assert len(rec.steps) == len(want.steps) == 8
    for g, w in zip(rec.steps + rec.epochs, want.steps + want.epochs):
        assert g.keys() == w.keys()
        for k in w:
            assert (g[k] == w[k] if k.endswith(("acc", "acc_top2"))
                    else _close(g[k], w[k])), (k, g[k], w[k])
    assert _close(got_eval["loss"][0], want_eval["loss"][0])
    assert got_eval["acc"] == want_eval["acc"]


def _tiny_ds(mod):
    class DS(mod.Dataset):
        def __len__(self):
            return 16

        def __getitem__(self, i):
            x = np.zeros((1, 28, 28), "float32")
            x[0, i % 10] = 1.0
            return x, np.int64(i % 10)

    return DS()


def test_fit_with_early_stopping(lenet_state):
    import paddle_tpu.io as jio

    stopped = []
    for model, es, io in (
            (_jax_model(lenet_state), JEarlyStopping, jio),
            (_port_model(lenet_state), PEarlyStopping, pt.io)):
        cb = es(monitor="loss", patience=0, baseline=-1.0)
        model.fit(_tiny_ds(io), batch_size=8, epochs=4, verbose=0,
                  callbacks=[cb])
        assert model.stop_training
        stopped.append(cb.stopped_epoch)
    assert stopped == [0, 0]


def test_lr_scheduler_callback_steps():
    import paddle_tpu.io as jio

    class JDS(jio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return np.full((4,), i / 8, "float32"), np.int64(i % 2)

    class PDS(pt.io.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return JDS()[i]

    paddle.seed(3)
    jlin = paddle.nn.Linear(4, 2)
    state = {k: np.asarray(v.numpy()) for k, v in jlin.state_dict().items()}
    plin = pnn.Linear(4, 2, device="cpu")
    convert.load_paddle_tpu_state(plin, state)
    jsched = paddle.optimizer.lr.PolynomialDecay(0.1, decay_steps=4)
    psched = plr.PolynomialDecay(0.1, decay_steps=4)
    jm = paddle.Model(jlin)
    jm.prepare(paddle.optimizer.SGD(learning_rate=jsched,
                                    parameters=jm.parameters()),
               paddle.nn.CrossEntropyLoss())
    pm = pt.Model(plin)
    pm.prepare(SGD(learning_rate=psched, parameters=pm.parameters()),
               pnn.CrossEntropyLoss())
    recs = [_recorder(JCallback), _recorder(PCallback)]
    jm.fit(JDS(), batch_size=4, epochs=1, verbose=0, shuffle=False,
           callbacks=[recs[0]])
    pm.fit(PDS(), batch_size=4, epochs=1, verbose=0, shuffle=False,
           callbacks=[recs[1]])
    assert psched.last_lr == jsched.last_lr < 0.1   # stepped by the callback
    for g, w in zip(recs[1].steps, recs[0].steps):
        assert _close(g["loss"], w["loss"])


def test_checkpoint_callback_and_save_dir(lenet_state, tmp_path):
    m = _port_model(lenet_state)
    m.fit(_tiny_ds(pt.io), batch_size=8, epochs=2, verbose=0,
          save_dir=str(tmp_path / "dir"),
          callbacks=[PModelCheckpoint(save_dir=str(tmp_path / "cb"))])
    for d in ("dir", "cb"):
        for e in (1, 2):
            for ext in (".pdparams", ".pdopt"):
                assert (tmp_path / d / f"epoch{e}{ext}").exists()
    assert JModelCheckpoint(save_freq=2).save_freq == 2


def test_batch_calls_and_predict_match(lenet_state):
    jm, pm = _jax_model(lenet_state), _port_model(lenet_state)
    ds = [_mnist(mod, sub, "test", 24) for mod, sub in
          ((jdatasets, JSubset), (pdatasets, PSubset))]
    x = np.stack([ds[1][i][0] for i in range(8)])
    y = np.stack([ds[1][i][1] for i in range(8)])
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    px, py = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(2):
        jl, _ = jm.train_batch([jx], [jy])
        pl, _ = pm.train_batch([px], [py])
        assert _close(pl[0], jl[0])
    jl, jmet = jm.eval_batch([jx], [jy])
    pl, pmet = pm.eval_batch([px], [py])
    assert _close(pl[0], jl[0]) and pmet == jmet
    np.testing.assert_allclose(pm.predict_batch([px])[0],
                               jm.predict_batch([jx])[0], rtol=0, atol=1e-5)
    jp = jm.predict(ds[0], batch_size=8)
    pp = pm.predict(ds[1], batch_size=8)
    assert len(pp) == len(jp) == 3
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a[0], b[0], rtol=0, atol=1e-5)


def _assert_state_equal(got, want):
    assert got.keys() == want.keys() and len(want) == 10
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_the_packages(lenet_state, tmp_path, writer):
    """``Model.save`` in one package, ``Model.load`` in the other into a
    model and optimizer of other weights: weights equal, next loss equal."""
    x = np.stack([pdatasets.MNIST(mode="test")[i][0] for i in range(16)])
    y = np.stack([pdatasets.MNIST(mode="test")[i][1] for i in range(16)])
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    px, py = torch.from_numpy(x), torch.from_numpy(y)
    path = str(tmp_path / "ck")
    paddle.seed(99)
    other = {k: np.asarray(v.numpy())
             for k, v in jmodels.LeNet().state_dict().items()}
    if writer == "jax":
        src, dst = _jax_model(lenet_state), _port_model(other)
        for _ in range(2):
            src.train_batch([jx], [jy])
        src.save(path)
        dst.load(path)
        want = {k: np.asarray(v.numpy())
                for k, v in src.network.state_dict().items()}
        _assert_state_equal(convert.to_paddle_tpu(dst.network), want)
        nxt = (dst.train_batch([px], [py])[0][0],
               src.train_batch([jx], [jy])[0][0])
    else:
        src, dst = _port_model(lenet_state), _jax_model(other)
        for _ in range(2):
            src.train_batch([px], [py])
        src.save(path)
        dst.load(path)
        _assert_state_equal({k: np.asarray(v.numpy()) for k, v in
                             dst.network.state_dict().items()},
                            convert.to_paddle_tpu(src.network))
        nxt = (dst.train_batch([jx], [jy])[0][0],
               src.train_batch([px], [py])[0][0])
    assert os.path.exists(path + ".pdopt")
    assert _close(*nxt)


def _logits(seed, shape=(12, 7), ties=False):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.round(a, 0) if ties else a


@pytest.mark.parametrize("ties", [False, True], ids=["plain", "tied"])
def test_accuracy_matches_including_tie_order(ties):
    p = _logits(1, ties=ties)
    y = np.random.default_rng(2).integers(0, 7, (12, 1))
    if ties:       # many tied maxima: the order among them decides
        assert (p == p.max(-1, keepdims=True)).sum() > 12
    out = []
    for mod, to in ((paddle.metric, paddle.to_tensor),
                    (pt.metric, torch.from_numpy)):
        acc = mod.Accuracy(topk=(1, 3))
        correct = acc.compute(to(p), to(y))
        c = np.asarray(correct.numpy())
        r1 = acc.update(c)
        r2 = acc.update(acc.compute(to(p[::-1].copy()), to(y)))
        out.append((c, r1, r2, acc.accumulate(), acc.name(),
                    float(mod.accuracy(to(p), to(y), k=2).numpy())))
    (jc, *jrest), (pc, *prest) = out
    assert np.array_equal(pc, jc)
    assert prest == jrest


def test_precision_recall_auc_match():
    rng = np.random.default_rng(4)
    preds = rng.random((40, 1)).astype(np.float32)
    labels = rng.integers(0, 2, (40, 1))
    two = np.concatenate([1 - preds, preds], 1)
    out = []
    for mod, to in ((paddle.metric, paddle.to_tensor),
                    (pt.metric, torch.from_numpy)):
        res = []
        for cls, p in ((mod.Precision, preds), (mod.Recall, preds),
                       (mod.Auc, two)):
            m = cls()
            m.update(to(p[:25]), to(labels[:25]))
            m.update(to(p[25:]), to(labels[25:]))
            res.append((m.accumulate(), m.name()))
        out.append(res)
    assert out[0] == out[1]


def _vit(mod, **kw):
    return mod.VisionTransformer(img_size=16, patch_size=8, embed_dim=16,
                                 depth=1, num_heads=2, class_num=10, **kw)


@pytest.mark.parametrize("name,size", [("LeNet", (1, 1, 28, 28)),
                                       ("vit", (1, 3, 16, 16))])
def test_summary_and_flops_totals_match(name, size, capsys):
    paddle.seed(5)
    if name == "vit":
        jnet, pnet = _vit(jmodels), _vit(pmodels, device="cpu")
    else:
        jnet = getattr(jmodels, name)()
        pnet = getattr(pmodels, name)(device="cpu")
    jinfo = paddle.summary(jnet, input_size=size)
    jout = capsys.readouterr().out
    pinfo = pt.summary(pnet, input_size=size)
    pout = capsys.readouterr().out
    assert pinfo == jinfo
    assert pinfo["total_params"] == sum(p.numel() for p in pnet.parameters())
    assert pout.splitlines()[-3:] == jout.splitlines()[-3:]
    assert pt.flops(pnet, size) == paddle.flops(jnet, size) > 0
    assert (pt.Model(pnet).summary()["total_params"]
            == pinfo["total_params"])
