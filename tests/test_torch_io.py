"""The port's ``io`` held to the JAX package's on the CPU.

* Samplers and batch orders under one ``np.random.seed``: sequence,
  random (with and without replacement, a sample count), subset,
  weighted, batch (``drop_last`` both ways), ``DistributedBatchSampler``
  over 3 ranks at epoch 0 and after ``set_epoch(2)``, ``random_split`` by
  counts and by fractions: the same index lists exactly.
* Collate trees (arrays, numbers, tuples, lists, dicts nested): the same
  structure, types and arrays exactly; the loader's batches on the CPU
  equal the JAX loader's.
* The shared-memory ring: ``_pack`` byte for byte against the JAX
  ``_pack`` over dtypes, shapes, 0-d and non-contiguous arrays, the
  worker frame too; ``_unpack`` and the port's tensor unpack bit-equal to
  the JAX ``_unpack``; a port ring's frames popped by a JAX ring attached
  to it, and back.  A ring larger than ``/dev/shm``'s free space raises
  naming both sizes and leaves no segment.
* Worker processes (mirroring ``tests/test_native.py:159-195``): ordered
  ``num_workers=2`` batches, a worker's exception raised in the
  consumer, a worker that dies raises instead of hanging, an epoch left
  early shuts its workers down; the ring builds or raises (no thread
  fallback) and ``use_shared_memory=False`` is the thread pool; a broken
  host source raises carrying g++'s error.
* The workers are not seeded, in either package: each starts from the
  parent's numpy generator state, so worker w's k-th draw equals worker
  w''s (ROADMAP C5).
* No file leaves a worker process or a ring segment behind.
"""

import gc
import multiprocessing as mp
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu.io import dataloader as jdl
from paddle_tpu.io import shm_ring as jring
from paddle_tpu.io import worker_pool as jpool
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.io import dataloader as pdl
from paddle_tpu_torch.io import shm_ring as pring
from paddle_tpu_torch.io import worker_pool as ppool
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.ops import _build


def _rings(prefix):
    return [f for f in os.listdir("/dev/shm")
            if f.startswith(f"{prefix}_{os.getpid()}_")]


@pytest.fixture(autouse=True)
def _no_leftovers():
    yield
    gc.collect()
    assert _rings("ptt_dl") == []
    assert [p for p in mp.active_children()
            if p.name.startswith("ForkProcess")] == []


def _both(fn):
    """``fn`` under the same seed in each package: (jax, port)."""
    np.random.seed(21)
    a = fn(jio)
    np.random.seed(21)
    b = fn(pio)
    return a, b


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("make", [
    lambda m: list(m.SequenceSampler(_Range(7))),
    lambda m: list(m.RandomSampler(_Range(11))),
    lambda m: list(m.RandomSampler(_Range(11), replacement=True,
                                   num_samples=20)),
    lambda m: list(m.RandomSampler(_Range(11), num_samples=5)),
    lambda m: list(m.SubsetRandomSampler([3, 9, 4, 1, 7])),
    lambda m: list(m.WeightedRandomSampler([0.1, 0.5, 0.2, 0.2], 12)),
    lambda m: list(m.WeightedRandomSampler([1, 2, 3, 4, 5], 3,
                                           replacement=False)),
    lambda m: list(m.BatchSampler(_Range(10), shuffle=True, batch_size=3)),
    lambda m: list(m.BatchSampler(_Range(10), shuffle=True, batch_size=3,
                                  drop_last=True)),
    lambda m: list(m.BatchSampler(sampler=m.SequenceSampler(_Range(5)),
                                  batch_size=2)),
], ids=["sequence", "random", "replacement", "num_samples", "subset",
        "weighted", "weighted_no_replacement", "batch", "batch_drop_last",
        "batch_of_sampler"])
def test_sampler_orders_match(make):
    a, b = _both(make)
    assert a == b and len(a) > 0


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                                (True, True)])
def test_distributed_batch_sampler_by_rank_and_epoch(shuffle, drop_last):
    def run(m):
        out = []
        for rank in range(3):
            s = m.DistributedBatchSampler(_Range(20), batch_size=3,
                                          num_replicas=3, rank=rank,
                                          shuffle=shuffle,
                                          drop_last=drop_last)
            out.append((list(s), len(s)))
            s.set_epoch(2)
            out.append((list(s), len(s)))
        return out

    a, b = _both(run)
    assert a == b
    assert a[0] != a[1] or not shuffle     # epoch 2 reshuffles


def test_distributed_batch_sampler_defaults_to_one_rank():
    s = pio.DistributedBatchSampler(_Range(8), batch_size=4)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert list(s) == [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.mark.parametrize("lengths", [[3, 4, 5], [0.5, 0.25, 0.25]])
def test_random_split_matches(lengths):
    a, b = _both(lambda m: [list(s.indices)
                            for s in m.random_split(_Range(12), lengths)])
    assert a == b and sum(map(len, b)) == 12


def test_datasets_compose_concat_subset_tensor():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = np.arange(6)
    for m in (jio, pio):
        t = m.TensorDataset([x, y])
        c = m.ConcatDataset([t, m.Subset(t, [5, 0])])
        assert len(c) == 8
        got = [c[i] for i in range(-1, 8)]
        assert np.array_equal(got[0][0], x[0]) and got[0][1] == 0
        comp = m.ComposeDataset([t, t])
        assert len(comp[2]) == 4
        chain = [v for v in m.ChainDataset([[1, 2], [3]])]
        assert chain == [1, 2, 3]
    pt = pio.TensorDataset([torch.arange(6), torch.ones(6, 2)])
    assert len(pt) == 6 and pt[3][0].item() == 3


def _assert_tree_equal(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        assert a == b


def _sample(i):
    rng = np.random.default_rng(i)
    return {"img": rng.standard_normal((2, 3)).astype(np.float32),
            "meta": (np.int64(i), float(i) / 2, [i, np.float32(i)]),
            "mask": rng.integers(0, 2, (4,)).astype(bool),
            "name": f"s{i}"}


def test_collate_trees_match():
    batch = [_sample(i) for i in range(5)]
    _assert_tree_equal(jdl.default_collate_fn(batch),
                       pdl.default_collate_fn(batch))
    stacked = pdl.default_collate_fn([torch.ones(2) * i for i in range(3)])
    assert torch.equal(stacked, torch.tensor([[0.0, 0], [1, 1], [2, 2]]))


class _Pairs(jio.Dataset):
    def __len__(self):
        return 23

    def __getitem__(self, i):
        return (np.full((3,), i, np.float32),
                np.asarray([i % 4], np.int64))


class _PortPairs(pio.Dataset):
    def __len__(self):
        return 23

    def __getitem__(self, i):
        return _Pairs()[i]


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_match_the_jax_loader(workers):
    np.random.seed(5)
    want = [tuple(t.numpy() for t in b) for b in jio.DataLoader(
        _Pairs(), batch_size=4, shuffle=True)]
    np.random.seed(5)
    loader = pio.DataLoader(_PortPairs(), batch_size=4, shuffle=True,
                            num_workers=workers, places="cpu")
    got = [tuple(t.numpy() for t in b) for b in loader]
    loader.shutdown()
    assert len(got) == len(want) == 6
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype and np.array_equal(gx, wx)
        assert np.array_equal(gy, wy)


def test_loader_metrics_keep_their_names():
    reg = get_registry()
    before = reg.counter("dataloader_batches_total").value
    n = len(list(pio.DataLoader(_PortPairs(), batch_size=8, places="cpu")))
    assert reg.counter("dataloader_batches_total").value == before + n == \
        before + 3
    assert reg.gauge("dataloader_queue_depth").samples >= 3


def test_loader_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pio.DataLoader(_PortPairs())


_ARRAYS = [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.asarray(7, np.int64),
    np.asarray([True, False, True]),
    np.arange(24, dtype=np.uint8).reshape(2, 3, 4)[:, ::2],   # strided
    np.linspace(0, 1, 5).astype(np.float16),
    np.zeros((0, 3), np.int32),
    np.random.default_rng(0).standard_normal((2, 2, 2)),
]


def test_ring_framing_is_byte_for_byte_the_jax_framing():
    assert pring._pack(_ARRAYS) == jring._pack(_ARRAYS)
    buf = jring._pack(_ARRAYS)
    want = jring._unpack(memoryview(buf))
    for got in (pring._unpack(memoryview(buf)),
                [t.numpy() for t in pring.unpack_tensors(memoryview(buf))]):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
    batch = (_ARRAYS[0], {"k": [_ARRAYS[1], 3]}, "x")
    assert ppool._frame(4, batch) == jpool._frame(4, batch)
    seq, back = ppool._unframe(memoryview(jpool._frame(4, batch)))
    assert seq == 4 and back[2] == "x" and back[1]["k"][1] == 3
    assert torch.equal(back[0], torch.from_numpy(_ARRAYS[0]))


def test_ring_crosses_the_packages():
    name = f"ptt_dl_{os.getpid()}_cross"
    ring = pring.ShmRing(name, n_slots=2, slot_size=1 << 16)
    try:
        peer = jring.ShmRing(name, create=False)
        ring.push_arrays(_ARRAYS[:3])
        got = peer.pop_arrays(timeout_ms=2000)
        peer.push_arrays(_ARRAYS[3:])
        back = ring.pop_arrays(timeout_ms=2000)
        assert ring.pop_view(timeout_ms=10) is None
        peer.close()
    finally:
        ring.close()
    for g, w in zip(got + back, _ARRAYS):
        assert g.tobytes() == np.ascontiguousarray(w).tobytes()


def test_ring_larger_than_dev_shm_raises(monkeypatch):
    monkeypatch.setattr(pring, "shm_free_bytes", lambda: 1 << 20)
    with pytest.raises(OSError, match=r"needs \d+ bytes \(8 slots of "
                                      r"67108864\) and /dev/shm has 1048576"):
        ppool.ShmWorkerPool(_PortPairs(), pdl.default_collate_fn, 2)


class _Bad(pio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.zeros(2, "float32")


class _Dies(pio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 3:
            os._exit(7)
        return np.zeros(2, "float32")


def test_multiprocess_loader_order_and_content():
    class DS(pio.Dataset):
        def __len__(self):
            return 32

        def __getitem__(self, i):
            return np.full((3,), i, "float32"), np.int64(i)

    seen = []
    for x, y in pio.DataLoader(DS(), batch_size=4, num_workers=2,
                               shuffle=False, places="cpu"):
        assert tuple(x.shape) == (4, 3) and x.dtype == torch.float32
        assert torch.equal(x[:, 0].long(), y)
        seen.extend(y.tolist())
    assert seen == list(range(32))  # sampler order preserved


def test_worker_exception_propagates():
    with pytest.raises(ValueError, match="boom"):
        list(pio.DataLoader(_Bad(), batch_size=2, num_workers=2,
                            places="cpu"))


def test_unpicklable_worker_exception_arrives_with_its_traceback():
    class Local(Exception):     # a local class does not pickle
        pass

    class DS(pio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise Local("local failure")

    with pytest.raises(RuntimeError, match="(?s)cannot be pickled.*"
                                           "local failure"):
        list(pio.DataLoader(DS(), batch_size=2, num_workers=2,
                            places="cpu"))


def test_dead_worker_raises_instead_of_hanging():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="exited unexpectedly"):
        list(pio.DataLoader(_Dies(), batch_size=2, num_workers=2,
                            places="cpu"))
    assert time.perf_counter() - t0 < 20


def test_unfinished_epoch_shuts_its_workers_down():
    loader = pio.DataLoader(_PortPairs(), batch_size=2, num_workers=2,
                            places="cpu")
    for i, _ in enumerate(loader):
        if i == 1:
            break
    assert loader._pool._closed and _rings("ptt_dl") == []
    assert len(list(loader)) == 12     # the next epoch forks anew
    loader.shutdown()


def test_oversize_batches_ride_the_control_queue(monkeypatch):
    monkeypatch.setattr(ppool.ShmWorkerPool.__init__, "__defaults__",
                        (8, 64, None, False))       # 64-byte slots
    got = [y.tolist() for _, y in pio.DataLoader(
        _PortPairs(), batch_size=4, num_workers=2, places="cpu")]
    assert sum(got, []) == [[i % 4] for i in range(23)]


def test_ring_builds_or_raises_with_no_thread_fallback(monkeypatch):
    def broken(name):
        raise _build.HostBuildFailed("g++ failed on csrc/shm_ring.cpp")

    monkeypatch.setattr(_build, "load_host", broken)
    with pytest.raises(_build.HostBuildFailed):
        list(pio.DataLoader(_PortPairs(), batch_size=4, num_workers=2,
                            places="cpu"))
    threads = pio.DataLoader(_PortPairs(), batch_size=4, num_workers=2,
                             places="cpu", use_shared_memory=False)
    assert len(list(threads)) == 6
    threads.shutdown()


def test_failed_host_build_carries_gxx_stderr(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f() { return undeclared; }\n")
    monkeypatch.setattr(_build, "HOST_CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.HostBuildFailed, match="undeclared"):
        _build.load_host("broken")
    assert not list((tmp_path / "build").glob("*.so"))


def test_shm_ring_library_lands_in_the_ignored_build_directory():
    path = _build.host_library_path("shm_ring")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libshm_ring-host-")
    assert _build.load_host("shm_ring") is _build.load_host("shm_ring")
    assert path.exists()


def _draws(m, barrier_dir):
    """(worker id, draws of that worker so far, the draw) per sample.  A
    worker's first sample waits until both workers have started one (a
    barrier of marker files in ``barrier_dir``), so both always draw; the
    wait draws nothing."""
    class Draws(m.Dataset):
        calls = 0

        def __len__(self):
            return 8

        def __getitem__(self, i):
            info = m.get_worker_info()
            if Draws.calls == 0:
                (barrier_dir / f"started_{info.id}").touch()
                deadline = time.monotonic() + 60
                while len(list(barrier_dir.glob("started_*"))) < 2:
                    if time.monotonic() > deadline:
                        raise TimeoutError("the other worker never started")
                    time.sleep(0.005)
            Draws.calls += 1
            return np.asarray([info.id, Draws.calls - 1, np.random.rand()])

    return Draws()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_workers_start_from_the_parents_generator_state(package, tmp_path):
    """ROADMAP C5: neither pool seeds its workers, so worker w's k-th draw
    is the parent's k-th draw after the fork, whatever w."""
    m = jio if package == "jax" else pio
    kw = {} if package == "jax" else {"places": "cpu"}
    np.random.seed(9)
    want = np.random.RandomState(9).rand(8)
    loader = m.DataLoader(_draws(m, tmp_path), batch_size=1, num_workers=2,
                          **kw)
    rows = [np.asarray(b.numpy() if package == "jax" else b)[0]
            for b in loader]
    if package == "jax":
        loader._pool.shutdown()     # the JAX pool lives as long as its loader
    else:
        loader.shutdown()
    workers = {int(r[0]) for r in rows}
    assert workers == {0, 1}
    for w, k, draw in rows:
        assert draw == want[int(k)]
