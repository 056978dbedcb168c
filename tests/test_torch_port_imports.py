"""Boundaries of the PyTorch port.

* No module of ``paddle_tpu_torch``, not ``chip_smoke.py`` and not
  ``chip_ab.py`` imports
  ``jax``, ``jaxlib`` or ``paddle_tpu`` (an AST walk over every import).
* The package imports with no ``nvcc`` and no ``triton``, builds nothing
  and loads no JAX while doing so.
* Without a CUDA device and without ``device="cpu"``, building the model
  raises instead of running on the CPU, and ``chip_smoke.py`` exits
  nonzero with no result line — as it does beside no package.
* Every ``EngineConfig`` setting the port does not implement raises
  ``NotImplementedError`` naming its ROADMAP item, as do MoE layers,
  pipeline micro-batches and sep > 1 (gradient clipping, which raised
  naming A12 until the port had ``nn/clip.py``, clips); the legacy
  families, decode bursts, the auditor, a shared lifecycle tracker,
  speculative decoding, the prefill/decode roles and an AOT artifact
  (``aot_path`` and ``aot``) build and serve.  A process fleet's spec
  decoding at mp > 1 raises naming A11, and its AOT settings are checked,
  before any worker process starts.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.observability import AuditConfig, LifecycleTracker
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel.ring_attention import ring_flash_attention
from paddle_tpu_torch.serving import (
    AotArtifact,
    AotError,
    EngineConfig,
    EngineCore,
    SamplingParams,
    SchedulerConfig,
    SpecConfig,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "paddle_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu"}
# modules whose JAX counterparts reach into the JAX package's core (run_op,
# Tensor, pure_callback) or into jax.jit itself (serving/graphs.py): they
# must be among the files checked
MUST_CHECK = ("utils/__init__.py", "utils/extension.py",
              "utils/cpp_extension.py", "utils/host_build.py",
              "ops/scaled.py", "version.py", "serving/graphs.py",
              # the observability modules: their JAX counterparts import
              # no JAX, and the port keeps its own copies of them
              "observability/__init__.py", "observability/metrics.py",
              "observability/tracer.py", "observability/export.py",
              "observability/lifecycle.py", "observability/stepprof.py",
              "observability/cachestat.py", "observability/audit.py",
              "observability/flight.py", "observability/history.py",
              "observability/alerts.py", "observability/httpd.py",
              "observability/push.py",
              # the fleet and its server: their JAX counterparts import no
              # JAX either (handoff.py does), and the port keeps its own
              "serving/spec.py", "serving/handoff.py", "serving/wire.py",
              "serving/faultinject.py", "serving/fleet.py",
              "serving/resilience.py", "serving/protocol.py",
              "serving/server.py", "distributed/__init__.py",
              "distributed/watchdog.py",
              # the cross-process fleet: the JAX worker imports JAX only
              # for its platform pin, procfleet.py and distrib.py none
              "serving/worker.py", "serving/procfleet.py",
              "observability/distrib.py",
              # the AOT artifacts: the JAX module lowers through
              # jax.export; the port's records signatures instead
              "serving/aot.py",
              # the GPT, BERT and ERNIE training paths with their nn
              # layers, checkpoints and train telemetry
              "framework.py", "convert.py", "observability/telemetry.py",
              "distributed/auto_tuner.py", "nn/initializer.py",
              "nn/container.py", "nn/common.py", "nn/norm.py",
              "nn/functional/common.py", "nn/functional/norm.py",
              "nn/functional/activation.py", "nn/functional/attention.py",
              "models/gpt.py", "models/bert.py", "models/ernie.py",
              # image classification: conv, pooling, the norms, the
              # activation and loss layers, the transformer layers, the
              # vision models, jit.to_static, AMP and the regularizers
              "nn/functional/conv.py", "nn/functional/pooling.py",
              "nn/functional/loss.py", "nn/conv.py", "nn/pooling.py",
              "nn/activation.py", "nn/loss.py", "nn/transformer.py",
              "vision/__init__.py", "vision/models/__init__.py",
              "vision/models/resnet.py", "vision/models/vit.py",
              "jit/__init__.py", "jit/api.py", "amp/__init__.py",
              "amp/auto_cast.py", "amp/grad_scaler.py", "regularizer.py",
              "optimizer/optimizer.py",
              # the input pipeline and the high-level trainer: the JAX
              # DataLoader and Resize reach into jax, the JAX metrics and
              # hapi into the JAX package's core
              "io/__init__.py", "io/dataset.py", "io/sampler.py",
              "io/shm_ring.py", "io/worker_pool.py", "io/dataloader.py",
              "metric/__init__.py", "hapi/__init__.py", "hapi/callbacks.py",
              "hapi/model.py", "hapi/summary.py",
              "vision/transforms/__init__.py",
              "vision/datasets/__init__.py", "vision/models/lenet.py",
              # the sequence models: clipping, the RNNs, beam search, the
              # vision functionals and the text datasets (the JAX RNNs and
              # decoder reach into jax and the JAX package's core)
              "nn/clip.py", "nn/rnn.py", "nn/decode.py",
              "nn/functional/vision.py", "text/__init__.py",
              "text/datasets.py",
              # the op bus, the eager Paddle API and AMP O2: the JAX core,
              # tensor ops and Layer are jax code
              "__init__.py", "core/__init__.py", "core/flags.py",
              "core/dtype.py", "core/dispatch.py", "core/autograd.py",
              "core/tensor.py", "core/random.py", "tensor/__init__.py",
              "tensor/creation.py", "tensor/math.py",
              "tensor/manipulation.py", "tensor/linalg.py",
              "tensor/logic.py", "tensor/search.py", "tensor/random.py",
              "nn/layers.py", "base/__init__.py", "base/param_attr.py",
              "amp/debugging.py",
              # dp x mp training: the JAX collectives, topology, launcher,
              # DataParallel, fleet and mp layers are jax code
              "distributed/env.py", "distributed/collective.py",
              "distributed/communication/__init__.py",
              "distributed/communication/stream.py",
              "distributed/topology.py", "distributed/spawn.py",
              "distributed/parallel.py", "distributed/launch/main.py",
              "distributed/fleet/__init__.py",
              "distributed/fleet/distributed_strategy.py",
              "distributed/fleet/meta_parallel.py",
              "distributed/fleet/utils.py", "parallel/__init__.py",
              "parallel/mp_layers.py", "parallel/random.py",
              "parallel/utils.py")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "chip_ab.py",
                                          REPO / "chip_mp.py"]
    assert len(files) > 20 and all(f.exists() for f in files)
    assert {PORT / m for m in MUST_CHECK} <= set(files)
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_never_imports_jax_or_the_jax_package():
    offenders = {str(f.relative_to(REPO)): sorted(FORBIDDEN & set(
        _imported_roots(f))) for f in _port_files()}
    assert {k: v for k, v in offenders.items() if v} == {}


def test_package_imports_without_nvcc_triton_or_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        "sys.modules['triton'] = None\n"   # any import of it would raise
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from paddle_tpu_torch.ops import _build\n"
        "assert not _build._libs\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.argv) and 'ok')\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path, alone):
    """chip_smoke.py exits nonzero and prints no result where there is no
    CUDA device, and in a directory holding it and nothing of the repo."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        cwd = tmp_path
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_ab_fails_without_a_card(tmp_path):
    """chip_ab.py exits nonzero and prints no summary where there is no
    CUDA device, before it starts any run."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_ab.py", str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"summary"' not in out.stdout


def test_model_without_a_card_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1))
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


@pytest.mark.parametrize("name", [
    "GPTForCausalLM", "BertModel", "BertForQuestionAnswering",
    "BertForSequenceClassification", "ErnieModel",
    "ErnieForSequenceClassification"])
def test_training_models_without_a_card_raise(monkeypatch, name):
    """The GPT, BERT and ERNIE entry points, like Llama's: the card unless
    the caller passes the CPU."""
    from paddle_tpu_torch import models

    cls = getattr(models, name)
    cfg = (models.ErnieConfig if "Ernie" in name else models.BertConfig
           if "Bert" in name else models.GPTConfig).tiny(num_hidden_layers=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(cfg)
    model = cls(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_checkpoint_load_without_a_card_raises(monkeypatch, tmp_path):
    from paddle_tpu_torch import framework

    path = str(tmp_path / "ck.pdparams")
    framework.save({"w": torch.ones(2)}, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        framework.load(path)
    assert framework.load(path, device="cpu")["w"].device.type == "cpu"


def test_moe_layers_raise_at_construction():
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        LlamaForCausalLM(LlamaConfig.tiny_moe(num_hidden_layers=1),
                         device="cpu")


# ROADMAP items already ported: their settings build and serve
PORTED = ("A7", "A8", "A9")
# settings ported ahead of the rest of their item (A12's op bus carries
# profile_ops): they build and serve too
PORTED_SETTINGS = ("profile_ops",)
# stand-ins for an artifact the test saves first: its path, or it loaded
_SAVED, _LOADED = "<saved artifact>", "<loaded artifact>"


@pytest.mark.parametrize("fields, item", [
    (dict(unified_step=False), "A7"),
    (dict(burst_steps=4), "A7"),
    (dict(audit=AuditConfig(enabled=True, sample_every=1)), "A8"),
    (dict(profile_ops=True), "A12"),
    (dict(lifecycle=LifecycleTracker()), "A8"),
    (dict(spec=SpecConfig(k=4),
          scheduler=SchedulerConfig(max_tokens_per_step=16)), "A9"),
    # explicit ids keep these cases' names stable
    pytest.param(dict(aot_path=_SAVED), "A9", id="fields6-A9"),
    pytest.param(dict(aot=_LOADED), "A9", id="fields7-A9"),
    (dict(role="prefill"), "A9"),
    (dict(role="decode"), "A9"),
    # mp=2 serves since tensor-parallel serving was ported; the auditor at
    # mp > 1 still waits for the rest of A11
    pytest.param(dict(mp=2, audit=AuditConfig(enabled=True, sample_every=1)),
                 "A11", id="fields10-A11"),
])
def test_unported_engine_settings_raise(fields, item, tmp_path):
    """A setting of an item not ported yet raises naming the item; those of
    a ported item (A7: the legacy families, decode bursts; A8: the
    auditor, a shared lifecycle tracker; A9: speculative decoding, the
    prefill and decode roles, an AOT artifact by path or loaded) build an
    engine that serves a request to its end."""
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    cfg = dict(num_blocks=16, block_size=4, unified_step=True)
    if _SAVED in fields.values() or _LOADED in fields.values():
        path = str(tmp_path / "artifact")
        AotArtifact.save(EngineCore(model, config=EngineConfig(**cfg)), path)
        fields = ({"aot_path": path} if "aot_path" in fields
                  else {"aot": AotArtifact.load(path)})
    cfg.update(fields)
    if item not in PORTED and not set(fields) & set(PORTED_SETTINGS):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            EngineCore(model, config=EngineConfig(**cfg))
        return
    eng = EngineCore(model, config=EngineConfig(**cfg))
    req = eng.add_request([5, 6, 7, 8, 9], SamplingParams(max_new_tokens=6))
    eng.run(max_steps=100)
    assert req.finished and len(req.output_tokens) == 6
    assert eng.kv.occupancy() == 0.0


def test_unported_training_settings_raise():
    """Pipeline micro-batches, 1F1B and ring attention over sep > 1 raise
    naming ROADMAP A11; gradient clipping, ported from A12, clips."""
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    ids = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        model(ids, pp_microbatches=2)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        model.train_batch_1f1b(ids, ids, n_microbatch=2)
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        ring_flash_attention(q, q, q, sep=2)
    opt = AdamW(parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1e-3))
    model(ids).sum().backward()
    before = [p.detach().clone() for p in model.parameters()]
    opt.step()
    moved = max(float((p.detach() - b).abs().max())
                for p, b in zip(model.parameters(), before))
    assert 0 < moved <= 2e-3     # Adam's first step: lr, whatever the norm
    assert model(ids).shape == (2, 4, 256)


def test_supported_settings_build():
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    eng = EngineCore(model, config=EngineConfig(
        num_blocks=16, block_size=4, unified_step=True, mp=1,
        burst_steps=1, use_pallas_paged=False, dtype=torch.bfloat16))
    assert eng._k_pools[0].dtype == torch.bfloat16
    assert eng._k_pools[0].shape == (16, 4, 2, 16)
    with pytest.raises(ValueError, match="role"):
        EngineCore(model, config=EngineConfig(unified_step=True,
                                              role="router"))


# explicit ids keep the cases' names from when the AOT settings raised
# naming ROADMAP A9 rest
@pytest.mark.parametrize("fields, error, message", [
    pytest.param(dict(aot_path="artifact"), AotError,
                 "manifest.json missing", id="fields0-A9 rest"),
    pytest.param(dict(warm_boot=True), ValueError, "needs aot_path",
                 id="fields1-A9 rest"),
    pytest.param(dict(mp=2, unified=True, max_tokens_per_step=16,
                      spec={"enabled": True, "k": 2}),
                 NotImplementedError, "ROADMAP A11", id="fields2-A11"),
])
def test_unported_process_fleet_settings_raise(fields, error, message):
    """Speculative decoding in workers at mp > 1 raises naming A11 (workers
    at mp > 1 serve since the process fleet was ported there), an artifact
    path with no artifact and a warm boot with no artifact are refused:
    all before any worker process is spawned."""
    from paddle_tpu_torch.serving import ProcessFleet, ProcessFleetConfig

    with pytest.raises(error, match=message):
        ProcessFleet(ProcessFleetConfig(dp=1, device="cpu", **fields))


@pytest.mark.parametrize("name", ["resnet18", "resnet50",
                                  "vit_base_patch16_224"])
def test_vision_models_without_a_card_raise(monkeypatch, name):
    """The image-classification entry points: the card unless the caller
    passes the CPU."""
    from paddle_tpu_torch.vision import models

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(models, name)()
    kw = ({"img_size": 32} if name.startswith("vit")
          else {"num_classes": 10})
    model = getattr(models, name)(device="cpu", **kw)
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_unported_amp_and_jit_parts_raise_naming_their_items():
    """A pipeline degree needs the pipeline (A11); a weight decay of
    L1Decay is not ported (A12).  jit.save (ported since A13 item 3)
    raises as the JAX one does without an input_spec.  (AMP O2 raised
    here until the op bus, ``tests/test_torch_amp_o2.py`` holds it;
    SyncBatchNorm raised naming A11 until the port had collectives, and on
    one rank it is a BatchNorm, ``tests/test_torch_mp_layers.py`` holds it
    at dp=4.)"""
    from paddle_tpu_torch import jit, nn, regularizer
    from paddle_tpu_torch.distributed import topology
    from paddle_tpu_torch.optimizer import Momentum

    with pytest.raises(NotImplementedError, match="A11"):
        topology.init_mesh(pp=2)
    x = torch.randn(4, 4, 3, 3)
    sync, plain = nn.SyncBatchNorm(4, device="cpu"), nn.BatchNorm2D(4)
    torch.testing.assert_close(sync(x), plain(x), rtol=0, atol=0)
    torch.testing.assert_close(sync._variance, plain._variance, rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="input_spec"):
        jit.save(nn.Linear(2, 2), "x")
    lin = nn.Linear(2, 2)
    opt = Momentum(parameters=lin.parameters(),
                   weight_decay=regularizer.L1Decay(1e-4))
    lin(torch.ones(1, 2)).sum().backward()
    with pytest.raises(NotImplementedError, match="A12"):
        opt.step()
