"""``jit.to_static`` on the card: CUDA-graph capture against eager.

Marked ``cuda``: each test skips where there is no CUDA device (the CPU
runs ``to_static`` eagerly; ``tests/test_torch_jit.py`` holds it to the
JAX package there).  This file imports no JAX, so it runs on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_jit_cuda.py``.

* A train step's calls (eager first call, capture + one replay, replays)
  equal the same steps run eagerly on a copy, losses and parameters bit
  for bit, with SGD, Momentum and BatchNorm (buffers too), and with AdamW
  under a ``LinearWarmup`` scheduler stepped outside the function (the
  host scalars refilled before each replay).
* The first call takes one step, not two; so does the capturing call.
* Returned tensors are copies: a later replay leaves them alone.
* A ``float(loss)`` inside the step is a graph break: one warning,
  ``jit_graph_breaks_total`` + 1, the right results eagerly, no capture;
  another signature still captures; ``full_graph=True`` raises.
* The flash kernels' launch counters advance on every replay.
* A capture that fails (invalidated by a live earlier step's autograd
  graph, or by a host read made only while capturing) falls back to
  eager on the caller's stream, with the random generator out of capture
  mode: the losses of that call and of the later ones equal eager steps
  on a copy, finite, bit for bit.
* A graph break's trace (``jit/partial.py``): both segments around a
  ``float(x.max())`` captured as CUDA graphs at the second call, the
  Python body never run again, replays equal to eager bit for bit, a
  batch on the other side of the guard recording a second trace, the
  flash forward launched inside a segment counted at every replay, and a
  kernel launched through ctypes outside a registered op (the scale
  kernel) keeping the function eager.
* ``jit.save`` / ``jit.load`` of a narrow ViT on the card: the exported
  graph holds ``paddle_tpu_torch::flash_fwd``, the loaded program
  launches the forward kernel once a layer a call, and its outputs equal
  the eager module's within 1e-5.
"""

import copy
import warnings

import pytest
import torch

from paddle_tpu_torch import jit, nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.ops import flash
from paddle_tpu_torch.optimizer import SGD, AdamW, Momentum
from paddle_tpu_torch.optimizer.lr import LinearWarmup


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CPU runs to_static eagerly")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


def _net(dev, seed=0, bn=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = [nn.Linear(8, 16, device=dev, generator=gen)]
    if bn:
        layers.append(nn.BatchNorm1D(16, device=dev))
    layers += [nn.ReLU(), nn.Linear(16, 4, device=dev, generator=gen)]
    return nn.Sequential(*layers)


def _step_fn(model, opt):
    def step(x, y):
        loss = F.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def _batches(dev, n, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(32, 8, device=dev, generator=gen),
             torch.randn(32, 4, device=dev, generator=gen))
            for _ in range(n)]


def _assert_same(a, b):
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert torch.equal(pa, pb), na


@pytest.mark.cuda
@pytest.mark.parametrize("opt_cls", [SGD, Momentum])
@pytest.mark.parametrize("bn", [False, True])
def test_replays_equal_eager_steps(cuda, opt_cls, bn):
    eager = _net(cuda, bn=bn)
    graphed = copy.deepcopy(eager)
    kw = dict(learning_rate=0.05)
    if opt_cls is Momentum:
        kw.update(momentum=0.9, weight_decay=1e-4)
    e_step = _step_fn(eager, opt_cls(parameters=eager.parameters(), **kw))
    g_step = jit.to_static(_step_fn(graphed,
                                    opt_cls(parameters=graphed.parameters(),
                                            **kw)))
    for i, (x, y) in enumerate(_batches(cuda, 6)):
        le, lg = e_step(x, y), g_step(x, y)
        assert torch.equal(le.detach(), lg), i
        _assert_same(eager, graphed)
    assert g_step.captures == 1 and g_step.replays == 5


@pytest.mark.cuda
def test_adamw_with_a_scheduler_refills_host_scalars(cuda):
    """N replays equal N eager steps with a LinearWarmup learning rate and
    AdamW's bias corrections, both computed on the host each step."""
    eager = _net(cuda, seed=3)
    graphed = copy.deepcopy(eager)
    opts, scheds = [], []
    for m in (eager, graphed):
        sched = LinearWarmup(1e-2, 4, 0.0, 1e-2)
        opts.append(AdamW(learning_rate=sched, parameters=m.parameters(),
                          weight_decay=0.01))
        scheds.append(sched)
    e_step = _step_fn(eager, opts[0])
    g_step = jit.to_static(_step_fn(graphed, opts[1]))
    for x, y in _batches(cuda, 8, seed=4):
        assert torch.equal(e_step(x, y).detach(), g_step(x, y))
        for s in scheds:
            s.step()
        _assert_same(eager, graphed)
    assert opts[1]._step_count == 8
    assert opts[1]._state[id(graphed[0].weight)]["t"] == 8


@pytest.mark.cuda
def test_first_and_capturing_calls_take_one_step_each(cuda):
    model = _net(cuda, seed=5)
    ref = copy.deepcopy(model)
    step = jit.to_static(_step_fn(model, SGD(learning_rate=0.1,
                                             parameters=model.parameters())))
    ref_step = _step_fn(ref, SGD(learning_rate=0.1,
                                 parameters=ref.parameters()))
    (x, y), = _batches(cuda, 1)
    for _ in range(2):
        step(x, y)
        ref_step(x, y)
        _assert_same(model, ref)
    assert step.captures == 1


@pytest.mark.cuda
def test_outputs_are_copies(cuda):
    lin = nn.Linear(8, 4, device=cuda)
    fn = jit.to_static(lin.forward)
    xs = [torch.randn(2, 8, device=cuda) for _ in range(4)]
    outs = [fn(x) for x in xs]
    for x, out in zip(xs, outs):
        torch.testing.assert_close(out, lin(x).detach(), rtol=0, atol=0)


@pytest.mark.cuda
def test_host_sync_is_a_graph_break(cuda):
    model = _net(cuda, seed=6)
    ref = copy.deepcopy(model)
    opt = SGD(learning_rate=0.1, parameters=model.parameters())
    seen = []

    def step(x, y):
        loss = F.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        seen.append(float(loss))           # a host read
        return loss

    fn = jit.to_static(step)
    ref_step = _step_fn(ref, SGD(learning_rate=0.1,
                                 parameters=ref.parameters()))
    counter = get_registry().counter("jit_graph_breaks_total", "")
    before = counter.value
    batches = _batches(cuda, 3)
    with pytest.warns(UserWarning, match="graph break") as rec:
        fn(*batches[0])
    assert sum("graph break" in str(w.message) for w in rec) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for x, y in batches[1:]:
            fn(x, y)
    for x, y in batches:
        ref_step(x, y)
    _assert_same(model, ref)
    assert counter.value == before + 1
    assert fn.captures == 0 and len(fn._eager_keys) == 1
    assert len(seen) == 3

    strict = jit.to_static(step, full_graph=True)
    with pytest.raises(jit.api.GraphBreak):
        strict(*batches[0])


@pytest.mark.cuda
def test_a_break_keeps_other_keys_captured(cuda):
    def f(x):
        if x.shape[0] == 2 and float(x.sum()) > 1e9:
            return x * 0
        return x * 3

    fn = jit.to_static(f)
    ok = torch.ones(5, device=cuda)
    for _ in range(3):
        torch.testing.assert_close(fn(ok), ok * 3)
    entry = fn._cache[next(iter(fn._cache))]
    with pytest.warns(UserWarning, match="graph break"):
        fn(torch.ones(2, device=cuda))
    assert fn._cache[next(iter(fn._cache))] is entry
    torch.testing.assert_close(fn(ok), ok * 3)
    assert fn.captures == 1


@pytest.mark.cuda
def test_flash_launch_counters_advance_on_replays(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    mha = nn.MultiHeadAttention(128, 2, device=cuda, generator=gen)
    opt = SGD(learning_rate=0.01, parameters=mha.parameters())

    def step(x):
        loss = mha(x).square().mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    fn = jit.to_static(step)
    x = torch.randn(2, 197, 128, device=cuda, generator=gen)
    flash.fwd_launches = flash.dq_launches = flash.dkv_launches = 0
    for _ in range(4):
        fn(x)
    assert (flash.fwd_launches, flash.dq_launches,
            flash.dkv_launches) == (4, 4, 4)
    assert fn.captures == 1


class _KeepsActivation(torch.nn.Module):
    """Keeps its hidden activation, and so the step's autograd graph, in
    an attribute until the next forward."""

    def __init__(self, dev):
        super().__init__()
        self.net = _net(dev, seed=8)
        self.kept = None

    def forward(self, x):
        h = self.net[0](x)
        self.kept = h
        return self.net[2](self.net[1](h))


@pytest.mark.cuda
@pytest.mark.parametrize("plant", ["live_activation", "read_in_capture"])
def test_failed_capture_falls_back_on_the_callers_stream(cuda, plant):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import Adam

    models = [_KeepsActivation(cuda) for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    steps = []
    for model in models:
        opt = Adam(learning_rate=1e-2, parameters=model.parameters(),
                   grad_clip=ClipGradByGlobalNorm(0.5))

        def step(x, y, model=model, opt=opt):
            loss = F.mse_loss(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            if (plant == "read_in_capture"
                    and torch.cuda.is_current_stream_capturing()):
                float(loss)                # a host read: invalidates it
            return loss
        steps.append(step)
    fn = jit.to_static(steps[1])
    counter = get_registry().counter("jit_graph_breaks_total", "")
    before = counter.value
    caller = torch.cuda.current_stream()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i, (x, y) in enumerate(_batches(cuda, 8, seed=9)):
            want = steps[0](x, y).detach()
            got = fn(x, y)
            assert torch.cuda.current_stream() == caller, i
            torch.rand(4, device=cuda)     # the generator out of capture
            assert torch.isfinite(got) and torch.equal(want, got), (i, want,
                                                                    got)
            _assert_same(*models)
    assert counter.value == before + 1 and fn.captures == 0


def _scaled_net(dev):
    """Conv + BatchNorm + ReLU + pool + Linear, eval: a classifier behind
    the input-scale idiom."""
    gen = torch.Generator(device=dev).manual_seed(11)
    return nn.Sequential(
        nn.Conv2D(3, 8, 3, padding=1, device=dev, generator=gen),
        nn.BatchNorm2D(8, device=dev), nn.ReLU(),
        nn.AdaptiveAvgPool2D(1), nn.Flatten(),
        nn.Linear(8, 5, device=dev, generator=gen)).eval()


@pytest.mark.cuda
def test_partial_segments_are_captured_graphs(cuda):
    net = _scaled_net(cuda)
    runs = []

    def predict(x):
        runs.append(1)
        if float(x.max()) > 1.0:
            x = x / 255.0
        return net(x)

    fn = jit.to_static(predict)
    gen = torch.Generator(device=cuda).manual_seed(12)
    # 0-255 images: every batch's largest value is 255, the guard's value
    batches = [torch.randint(0, 256, (4, 3, 16, 16), device=cuda,
                             generator=gen).float() for _ in range(4)]
    with torch.no_grad():
        want = [net(b / 255.0) for b in batches]
        with pytest.warns(UserWarning, match="graph break"):
            got = [fn(batches[0])]
        store = fn._partial[next(iter(fn._partial))]
        assert len(store.traces) == 1
        assert len(store.traces[0].segments) == 2
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got += [fn(b) for b in batches[1:]]
        assert len(runs) == 1
        assert all(seg.graph is not None
                   for seg in store.traces[0].segments)
        assert fn.segment_captures == 2
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        unit = batches[0] / 255.0            # already in [0, 1]
        assert torch.equal(fn(unit), net(unit))
        assert len(store.traces) == 2 and len(runs) == 2
        assert torch.equal(fn(batches[1]), want[1])


@pytest.mark.cuda
def test_flash_in_a_segment_counts_every_replay(cuda):
    gen = torch.Generator(device=cuda).manual_seed(13)
    mha = nn.MultiHeadAttention(128, 2, device=cuda, generator=gen).eval()

    def attend(x):
        if float(x.abs().max()) > 100.0:
            x = x / 100.0
        return mha(x)

    fn = jit.to_static(attend)
    x = torch.randn(2, 197, 128, device=cuda, generator=gen)
    flash.fwd_launches = 0
    with torch.no_grad():
        want = mha(x)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            outs = [fn(x) for _ in range(4)]
    assert flash.fwd_launches == 1 + 4       # the eager call above, then 4
    for o in outs:
        assert torch.equal(o, want)


@pytest.mark.cuda
def test_a_ctypes_launch_keeps_a_broken_function_eager(cuda):
    from paddle_tpu_torch.ops import scaled as sc

    def f(x):
        y = sc.scaled(x, 3.0)
        if float(y.sum()) > 1e9:
            return y * 0
        return y + 1

    fn = jit.to_static(f)
    x = torch.ones(1024, device=cuda)
    with pytest.warns(RuntimeWarning, match="dispatcher"):
        fn(x)
    assert fn._partial[next(iter(fn._partial))].dead is not None
    assert torch.equal(fn(x * 2), x * 7)


@pytest.mark.cuda
def test_loaded_vit_launches_the_flash_kernel(cuda, tmp_path):
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision.models import VisionTransformer

    gen = torch.Generator(device=cuda).manual_seed(14)
    vit = VisionTransformer(img_size=32, patch_size=8, embed_dim=128,
                            depth=2, num_heads=2, class_num=5, device=cuda,
                            generator=gen).eval()
    x = torch.randn(2, 3, 32, 32, device=cuda, generator=gen)
    with torch.no_grad():
        want = vit(x)
    path = str(tmp_path / "vit")
    jit.save(vit, path, input_spec=[InputSpec([2, 3, 32, 32])])
    loaded = jit.load(path)
    targets = [str(n.target) for n in loaded.program.graph.nodes]
    assert targets.count("paddle_tpu_torch.flash_fwd.default") == 2
    flash.fwd_launches = 0
    for _ in range(3):
        got = loaded(x)
    assert flash.fwd_launches == 3 * 2
    assert got.device.type == "cuda"
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
