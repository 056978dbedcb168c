"""The port's AOT serving artifacts (``paddle_tpu_torch/serving/aot.py``),
case for case with ``tests/test_zzzzz_aot.py`` (CPU, fp32,
``LlamaConfig.tiny`` at 2 layers on the JAX model's weights through
``convert.llama_from_paddle_tpu``).

The contract: a port engine bound to a port artifact (``EngineConfig.aot``
or ``aot_path``) serves the preempting shared-prefix stream with the JAX
traced engine's tokens, every trace counter at 0, across
preemption-with-recompute, warm prefix forks and chunked prefill; after
``AotArtifact.warm`` it captures nothing more; the mismatch matrix and
the load-time checks refuse each listed edit (a real JAX-saved artifact
included); ``enumerate_buckets`` equals the JAX lattice for every tested
configuration; a supervised dp=2 chaos rerun rebinds the fleet's ONE
artifact onto the rebuilt replica.  The JAX test's mp=2 round trip waits
for tensor-parallel serving (ROADMAP A11).
"""

import asyncio
import json
import os
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import AotArtifact as JaxAotArtifact
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu.serving import aot as jax_aot
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.observability import stepprof as stepprof_mod
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.observability.stepprof import StepProfiler
from paddle_tpu_torch.serving import (
    AotArtifact,
    AotBucketMissing,
    AotError,
    AotManifestMismatch,
    EngineConfig,
    EngineCore,
    FaultPlan,
    FaultSpec,
    FleetConfig,
    FleetRouter,
    FleetSupervisor,
    SamplingParams,
    SchedulerConfig,
    SpecConfig,
    SupervisorConfig,
)
from paddle_tpu_torch.serving import aot as aot_mod
from paddle_tpu_torch.serving.aot import enumerate_buckets, model_config_hash

_RNG = np.random.default_rng(0)
PREFIX = _RNG.integers(0, 256, 8).tolist()   # 2 full blocks shared
PROMPTS = [PREFIX + _RNG.integers(0, 256, 8).tolist() for _ in range(6)]

# 14 usable blocks of 4 cannot hold 4 concurrent 16+10-token sequences:
# the stream preempts + recomputes, shares warm prefix forks, and the
# 8-token budget chunks every prefill — the full serving surface
POOL = dict(num_blocks=15, block_size=4)
SCHED = dict(max_num_seqs=4, max_prefill_tokens_per_step=8)
LAYERS = 2


def _jax_model(layers=LAYERS, seed=0):
    paddle.seed(seed)
    return JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=layers))


def _port_model(jax_model, layers=LAYERS):
    state = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    return llama_from_paddle_tpu(
        state, LlamaConfig.tiny(num_hidden_layers=layers), device="cpu")


@pytest.fixture(scope="module")
def models():
    jm = _jax_model()
    return jm, _port_model(jm)


def _engine(model, aot=None, registry=None, labels=None, aot_path=None,
            sched=None, **fields):
    pool = dict(POOL)
    for k in ("num_blocks", "block_size"):
        if k in fields:
            pool[k] = fields.pop(k)
    return EngineCore(model, config=EngineConfig(
        **pool, scheduler=SchedulerConfig(**(sched or SCHED)), aot=aot,
        aot_path=aot_path, **fields),
        registry=registry, metrics_labels=labels)


def _serve(eng, max_new=10, sp=SamplingParams, prompts=PROMPTS):
    reqs = [eng.add_request(p, sp(max_new_tokens=max_new)) for p in prompts]
    eng.run(max_steps=4000)
    assert all(r.finished for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _traces(eng) -> int:
    return (eng.prefill_trace_count + eng.decode_trace_count
            + eng.ragged_trace_count + eng.burst_trace_count)


@pytest.fixture(scope="module")
def artifact_dir(models, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("aot_artifact") / "art")
    AotArtifact.save(_engine(models[1]), d)
    return d


@pytest.fixture(scope="module")
def artifact(artifact_dir):
    return AotArtifact.load(artifact_dir)


@pytest.fixture(scope="module")
def traced_ref(models):
    """The JAX traced engine's tokens on the preempting shared-prefix
    stream (the surface the contract covers)."""
    eng = JaxEngineCore(models[0], config=JaxEngineConfig(
        **POOL, scheduler=JaxSchedulerConfig(**SCHED)))
    outs = _serve(eng, sp=JaxSamplingParams)
    assert eng.metrics.counters["preemptions"] > 0
    assert eng.metrics.counters["prefix_cache_hit_tokens"] > 0
    assert eng.metrics.counters["chunked_prefill_steps"] > 0
    return outs


class TestArtifact:
    def test_manifest_fields(self, artifact):
        m = artifact.manifest
        for key in ("artifact_version", "framework", "framework_version",
                    "torch_version", "cuda_version", "platform",
                    "device_capability", "model_hash", "mp", "dtype",
                    "num_blocks", "block_size", "num_layers", "max_seq_len",
                    "scheduler", "burst_steps", "autotune", "spec",
                    "kernels", "programs", "save_seconds"):
            assert key in m, key
        assert m["framework"] == "paddle_tpu_torch"
        assert m["torch_version"] == torch.__version__
        assert m["platform"] == "cpu" and m["device_capability"] is None
        assert m["mp"] == 1 and m["block_size"] == 4
        assert m["dtype"] == "float32" and m["num_layers"] == LAYERS
        assert m["autotune"]["unified_step"] is False
        # the CPU engine launches no kernel: nothing to carry
        assert m["kernels"] == {}
        assert artifact.program_count == len(m["programs"])
        assert set(artifact.bucket_sets) == {"prefill", "chunk", "decode"}
        # each program's argument signature: the engine's own inputs
        meta = m["programs"]["chunk_8x4"]
        assert meta["args"][:7] == [
            [[1, 8], "int64"], [[], "int32"], [[], "int32"],
            [[1, 4], "int32"], [[1], "int32"], [[1, 8], "int64"],
            [[1, 8], "int64"]]
        assert len(artifact.graph_keys()) == 2 * artifact.program_count

    @pytest.mark.parametrize("fields,sched,max_seq", [
        ({}, SCHED, None),
        ({}, dict(max_num_seqs=4), None),
        ({}, dict(max_num_seqs=4), 24),
        (dict(unified_step=True), SCHED, None),
        (dict(unified_step=True), dict(max_num_seqs=4), 24),
        (dict(unified_step=True), dict(max_num_seqs=4,
                                       max_tokens_per_step=16), None),
        (dict(burst_steps=4), SCHED, None),
        (dict(burst_steps=8), dict(max_num_seqs=4), 24),
        (dict(burst_steps=8, unified_step=True),
         dict(max_num_seqs=4, max_tokens_per_step=16), None),
    ], ids=["legacy_budget", "legacy", "legacy_seq24", "unified_budget",
            "unified_seq24", "unified_packed", "burst4_budget",
            "burst8_seq24", "unified_burst8_packed"])
    def test_enumeration_equals_the_jax_lattice(self, models, fields, sched,
                                                max_seq):
        jm, model = models
        jax_eng = JaxEngineCore(jm, config=JaxEngineConfig(
            **POOL, scheduler=JaxSchedulerConfig(**sched), **fields))
        eng = _engine(model, sched=sched, **fields)
        want = jax_aot.enumerate_buckets(jax_eng, max_seq)
        assert enumerate_buckets(eng, max_seq) == want and want

    def test_enumeration_is_the_closed_universe(self, models, artifact):
        required = {(p,) + tuple(b) for p, b in enumerate_buckets(
            _engine(models[1]),
            max_seq_len=artifact.manifest["max_seq_len"])}
        assert required == set(artifact._programs)

    def test_torn_save_refuses_to_load(self, artifact_dir, tmp_path):
        torn = str(tmp_path / "torn")
        shutil.copytree(artifact_dir, torn)
        os.remove(os.path.join(torn, "manifest.json"))
        with pytest.raises(AotError, match="manifest.json missing"):
            AotArtifact.load(torn)

    def test_failed_resave_preserves_old_artifact(self, models, artifact_dir,
                                                  tmp_path, monkeypatch):
        """A re-save stages next to the destination and swaps only after
        the manifest commit: a save that dies midway leaves the previous
        artifact loadable and no staging directory behind."""
        d = str(tmp_path / "resave")
        shutil.copytree(artifact_dir, d)
        before = AotArtifact.load(d).program_count
        monkeypatch.setattr(
            aot_mod, "_signature",
            lambda *a: (_ for _ in ()).throw(RuntimeError("boom")))
        with pytest.raises(RuntimeError, match="boom"):
            AotArtifact.save(_engine(models[1]), d)
        assert AotArtifact.load(d).program_count == before
        assert not os.path.exists(d + ".staging")


class TestZeroTraceServing:
    def test_token_identity_and_zero_traces(self, models, artifact,
                                            traced_ref):
        """Preemption + warm prefix forks + chunked prefill: the JAX
        traced engine's tokens, every trace counter at 0."""
        eng = _engine(models[1], aot=artifact)
        assert _serve(eng) == traced_ref
        assert _traces(eng) == 0
        for name in ("preemptions", "prefix_cache_hit_tokens",
                     "chunked_prefill_steps"):
            assert eng.metrics.counters[name] > 0, name
        snap = eng.stepprof.aot_snapshot()
        assert snap["loaded"] and sum(snap["hits"].values()) > 0
        assert eng.stepprof.compile_table() == []
        # the lazy captures of saved keys count in the graphs alone
        assert eng.graphs.captures > 0
        assert all(eng.graphs.artifact.check_key(k) is None
                   for k in eng.graphs.programs)

    def test_aot_path_config_form(self, models, artifact_dir, traced_ref):
        eng = _engine(models[1], aot_path=artifact_dir)
        assert eng.aot_artifact is not None
        assert _serve(eng) == traced_ref and _traces(eng) == 0

    def test_aot_metrics_on_registry(self, models, artifact):
        eng = _engine(models[1], aot=artifact)
        _serve(eng)
        page = eng.metrics.registry.prometheus_text()
        assert "serving_aot_load_seconds" in page
        assert "serving_aot_hits_total" in page
        assert sum(eng.stepprof.aot_snapshot()["hits"].values()) > 0

    def test_mp2_round_trip_waits_for_a11(self, models, artifact):
        """The JAX test's mp=2 mesh-spanning round trip: tensor-parallel
        serving is ROADMAP A11, and asking for it still raises."""
        with pytest.raises(NotImplementedError, match="ROADMAP A11"):
            _engine(models[1], aot=artifact, mp=2)

    def test_no_capture_after_warm(self, models, artifact, traced_ref):
        """``warm`` captures every key of the universe (2 a saved bucket)
        and records its seconds; serving then captures nothing."""
        reg = MetricsRegistry()
        eng = _engine(models[1], aot=artifact, registry=reg)
        wall = artifact.warm(eng, registry=reg, labels={"replica": "0"})
        assert wall > 0
        assert eng.graphs.captures == 2 * artifact.program_count
        assert "serving_aot_warm_seconds" in reg.prometheus_text()
        assert _serve(eng) == traced_ref
        assert eng.graphs.captures == 2 * artifact.program_count
        assert _traces(eng) == 0

    def test_bind_and_warm_write_the_null_page_only(self, models, artifact):
        """The pad convention: every page but the null page 0 is left as it
        was by a bind and a warm."""
        eng = _engine(models[1])
        gen = torch.Generator().manual_seed(3)
        for pool in eng._k_pools + eng._v_pools:
            pool.copy_(torch.randn(pool.shape, generator=gen))
        before = [p.clone() for p in eng._k_pools + eng._v_pools]
        eng.bind_aot(artifact)
        artifact.warm(eng)
        after = eng._k_pools + eng._v_pools
        assert all(torch.equal(a[1:], b[1:]) for a, b in zip(after, before))
        assert any(not torch.equal(a[0], b[0])
                   for a, b in zip(after, before))


class TestMismatchMatrix:
    """Every way a stale or foreign artifact must fail loudly at boot."""

    def _tampered(self, artifact_dir, **edits):
        art = AotArtifact.load(artifact_dir)
        for dotted, val in edits.items():
            obj = art.manifest
            *path, leaf = dotted.split(".")
            for p in path:
                obj = obj[p]
            obj[leaf] = val
        return art

    @pytest.mark.parametrize("edits,match", [
        ({"mp": 7}, "mp degree"),
        ({"model_hash": "0" * 64}, "model-config hash"),
        ({"num_blocks": 99}, "pool geometry"),
        ({"block_size": 8}, "pool geometry"),
        ({"num_layers": 5}, "layer count"),
        ({"dtype": "bfloat16"}, "pool dtype"),
        ({"autotune.unified_step": True}, "program family"),
        ({"autotune.use_pallas_paged": True}, "kernel routing"),
        ({"platform": "cuda"}, "platform"),
        ({"device_capability": "sm_90"}, "device capability"),
    ])
    def test_validate_mismatches(self, models, artifact_dir, edits, match):
        art = self._tampered(artifact_dir, **edits)
        eng = _engine(models[1])
        with pytest.raises(AotManifestMismatch, match=match):
            art.validate(eng)
        with pytest.raises(AotManifestMismatch):
            eng.bind_aot(art)
        assert eng.aot_artifact is None and eng.graphs.artifact is None

    def test_bucket_set_mismatch_scheduler_drift(self, models, artifact):
        # caps outgrew the saved universe: max_num_seqs 4 -> 8 needs an
        # 8-row decode bucket that was never saved
        eng = _engine(models[1], sched=dict(max_num_seqs=8,
                                            max_prefill_tokens_per_step=8))
        with pytest.raises(AotManifestMismatch, match="bucket set"):
            artifact.validate(eng)

    @pytest.mark.parametrize("key,val,match", [
        ("torch_version", "0.0.1", "stale artifact"),
        ("artifact_version", 999, "artifact_version"),
        ("platform", "cuda", "platform"),
        ("device_capability", "sm_90", "device capability"),
        ("framework", "paddle_tpu", "framework"),
        ("kernels", {"paged_decode_attention": {
            "file": "kernels/x.so", "hash": "0" * 16}},
         "kernel 'paged_decode_attention'"),
        ("kernels", {"no_such_kernel": {"file": "kernels/x.so",
                                        "hash": "0" * 16}},
         "no csrc/no_such_kernel.cu"),
    ])
    def test_load_time_mismatches(self, artifact_dir, tmp_path, key, val,
                                  match):
        copy = str(tmp_path / "copy")
        shutil.copytree(artifact_dir, copy)
        mpath = os.path.join(copy, "manifest.json")
        with open(mpath) as f:
            m = json.load(f)
        m[key] = val
        with open(mpath, "w") as f:
            json.dump(m, f)
        with pytest.raises(AotManifestMismatch, match=match):
            AotArtifact.load(copy, device="cpu")

    def test_a_cpu_artifact_loads_with_a_card_visible(self, models,
                                                      artifact_dir,
                                                      monkeypatch):
        """Platform and card are held against the target device, not the
        process: with a card visible a CPU artifact loads and binds to a
        CPU engine, and is refused for the card."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda device=None: (9, 0))
        for art in (AotArtifact.load(artifact_dir),
                    AotArtifact.load(artifact_dir, device="cpu")):
            eng = _engine(models[1], aot=art)
            assert eng.aot_artifact is art
        with pytest.raises(AotManifestMismatch,
                           match="platform: artifact 'cpu', device 'cuda'"):
            AotArtifact.load(artifact_dir, device="cuda")

    def test_a_kernel_that_fails_to_load_is_not_rebuilt(self, artifact_dir,
                                                         tmp_path,
                                                         monkeypatch):
        """A library with the right hash that does not load raises
        AotError naming the kernel; nvcc is never asked."""
        from paddle_tpu_torch.ops import _build

        name = "paged_decode_attention"
        copy = str(tmp_path / "copy")
        shutil.copytree(artifact_dir, copy)
        with open(os.path.join(copy, "kernels", "lib.so"), "wb") as f:
            f.write(b"not a shared library")
        mpath = os.path.join(copy, "manifest.json")
        with open(mpath) as f:
            m = json.load(f)
        m["kernels"] = {name: {"file": "kernels/lib.so",
                               "hash": _build.source_hash(name)}}
        with open(mpath, "w") as f:
            json.dump(m, f)
        monkeypatch.setattr(_build, "build", lambda names: (
            _ for _ in ()).throw(AssertionError("nvcc asked")))
        with pytest.raises(AotError, match=f"kernel {name!r} failed to "
                                           "load"):
            AotArtifact.load(copy)
        assert name not in _build._libs

    def test_a_jax_saved_artifact_is_refused(self, models, tmp_path):
        """A real artifact of the JAX package (StableHLO programs) is
        refused, naming its framework."""
        d = str(tmp_path / "jax_art")
        JaxAotArtifact.save(JaxEngineCore(models[0], config=JaxEngineConfig(
            **POOL, scheduler=JaxSchedulerConfig(
                max_num_seqs=1, max_prefill_tokens_per_step=4))), d,
            max_seq_len=4)
        assert JaxAotArtifact.load(d).program_count > 0
        with pytest.raises(AotManifestMismatch, match="framework"):
            AotArtifact.load(d)

    def test_model_hash_ignores_weights_not_architecture(self, models):
        a = _engine(models[1])
        b = _engine(_port_model(_jax_model(seed=123)))
        c = _engine(_port_model(_jax_model(layers=3), layers=3))
        assert model_config_hash(a) == model_config_hash(b)
        assert model_config_hash(a) != model_config_hash(c)


class TestBucketMissing:
    def test_oversize_request_rejected_at_admission(self, models, tmp_path):
        """A request whose target outgrows the saved max_seq_len finishes
        at admission (abort, an error naming the bound); the engine
        survives, a request within the bound serves, nothing traced."""
        d = str(tmp_path / "small")
        AotArtifact.save(_engine(models[1]), d, max_seq_len=16)
        eng = _engine(models[1], aot=AotArtifact.load(d))
        assert eng.scheduler.seq_len_cap == 16
        big = eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=10))
        ok = eng.add_request(PROMPTS[0][:8], SamplingParams(max_new_tokens=4))
        eng.run(max_steps=4000)
        assert big.finished and big.finish_reason.value == "abort"
        assert "max_seq_len=16" in big.error
        assert ok.finished and len(ok.output_tokens) == 4
        assert _traces(eng) == 0

    def test_bucket_outside_universe_backstop(self, models, artifact):
        """The dispatch-level backstop: a bucket the artifact never saved
        raises AotBucketMissing — at the artifact's check and at a sealed
        engine's step graphs, which capture nothing for it."""
        with pytest.raises(AotBucketMissing, match="saved universe"):
            artifact.call("decode", (64, 64))
        eng = _engine(models[1], aot=artifact)
        with pytest.raises(AotBucketMissing, match="saved universe"):
            eng.graphs.run(("decode", 64, 64, False),
                           lambda *a: (torch.zeros(1),), [np.zeros(1)])
        assert eng.graphs.captures == 0 and not eng.graphs.programs
        # a saved bucket with a drifted signature is refused too
        inputs = eng.program_inputs("decode", (1, 1))
        inputs[0] = np.zeros((1, 2), np.int64)
        with pytest.raises(AotError, match="argument 0"):
            artifact.call("decode", (1, 1), *inputs)


class TestStepprofAttribution:
    def test_compile_rows_flag_aot(self):
        sp = StepProfiler(registry=MetricsRegistry())
        sp.record_compile("decode", (2, 4), 0.5)
        assert sp.compile_table()[0]["aot"] is False
        assert sp.aot_snapshot() == {"loaded": False}
        sp.record_aot_load(0.123, 39)
        sp.record_aot_hit("decode")
        sp.record_aot_hit("decode")
        sp.record_aot_hit("chunk")
        snap = sp.aot_snapshot()
        assert snap["loaded"] and snap["programs"] == 39
        assert snap["hits"] == {"decode": 2, "chunk": 1}
        sp.record_compile("decode", (4, 4), 0.4)
        assert sp.compile_table()[-1]["aot"] is True
        assert sp.utilization_report()["aot"]["hits"] == snap["hits"]

    def test_one_load_sample_per_registry(self, models, artifact_dir):
        """dp replicas binding the SAME loaded artifact into one registry
        give one serving_aot_load_seconds sample: one load happened."""
        def load_samples(reg):
            return sum(v["count"] for k, v in reg.snapshot().items()
                       if k.startswith("serving_aot_load_seconds"))

        art = AotArtifact.load(artifact_dir)
        reg = MetricsRegistry()
        for i in range(2):
            _engine(models[1], aot=art, registry=reg,
                    labels={"replica": str(i)})
        assert load_samples(reg) == 1
        reg2 = MetricsRegistry()
        _engine(models[1], aot=art, registry=reg2)
        assert load_samples(reg2) == 1

    def test_rebind_skips_load_histogram_sample(self):
        reg = MetricsRegistry()
        sp = StepProfiler(registry=reg)
        sp.record_aot_load(0.1, 5, observe=False)
        assert sp.aot_snapshot()["loaded"]
        sp.record_aot_hit("decode")
        page = reg.prometheus_text()
        assert "serving_aot_hits_total" in page
        assert "serving_aot_load_seconds" not in page

    def test_disabled_profiler_keeps_registry_clean(self):
        reg = MetricsRegistry()
        sp = StepProfiler(registry=reg, enabled=False)
        sp.record_aot_load(0.1, 5)
        sp.record_aot_hit("decode")
        assert "serving_aot" not in reg.prometheus_text()
        assert sp.aot_snapshot()["loaded"] is True

    def test_metric_names_match_the_jax_module(self):
        assert aot_mod.METRIC_NAMES == jax_aot.METRIC_NAMES
        assert {"serving_aot_hits_total", "serving_aot_load_seconds"} <= \
            set(stepprof_mod.METRIC_NAMES)


class TestUnifiedFamily:
    def test_unified_round_trip_zero_traces(self, models, tmp_path):
        """The one packed ragged family: the artifact holds only ``ragged``
        buckets and serves the JAX unified engine's tokens with zero
        traces; a legacy engine refuses it."""
        jm, model = models
        jax_eng = JaxEngineCore(jm, config=JaxEngineConfig(
            **POOL, scheduler=JaxSchedulerConfig(**SCHED),
            unified_step=True))
        want = _serve(jax_eng, sp=JaxSamplingParams)
        d = str(tmp_path / "unified")
        AotArtifact.save(_engine(model, unified_step=True), d)
        art = AotArtifact.load(d)
        assert set(art.bucket_sets) == {"ragged"}
        assert art.manifest["autotune"]["unified_step"] is True
        eng = _engine(model, aot=art, unified_step=True)
        assert _serve(eng) == want and _traces(eng) == 0
        with pytest.raises(AotManifestMismatch, match="program family"):
            _engine(model, aot=art)

    def test_spec_on_an_artifact_saved_with_spec_off(self, models,
                                                     tmp_path):
        """Speculative decoding packs into the same ragged lattice: an
        engine with spec on serves from an artifact saved with spec off,
        with the spec-off tokens and zero traces."""
        model = models[1]
        sched = dict(max_num_seqs=4, max_tokens_per_step=16)
        d = str(tmp_path / "spec")
        AotArtifact.save(_engine(model, unified_step=True, sched=sched,
                                 num_blocks=64), d)
        art = AotArtifact.load(d)
        assert art.manifest["spec"] is None
        off = _serve(_engine(model, unified_step=True, sched=sched,
                             num_blocks=64), max_new=16)
        eng = _engine(model, aot=art, unified_step=True, sched=sched,
                      num_blocks=64, spec=SpecConfig(k=4))
        assert _serve(eng, max_new=16) == off
        assert _traces(eng) == 0 and eng.spec.drafted_total > 0

    def test_burst4_artifact_served_by_a_burst0_engine(self, models,
                                                       tmp_path,
                                                       traced_ref):
        """A burst-off engine binds a burst-on artifact (a superset of its
        universe) and serves the JAX tokens with zero traces."""
        d = str(tmp_path / "burst4")
        AotArtifact.save(_engine(models[1], burst_steps=4), d)
        art = AotArtifact.load(d)
        assert art.manifest["burst_steps"] == 4 and "burst" in \
            art.bucket_sets
        eng = _engine(models[1], aot=art)
        assert _serve(eng) == traced_ref and _traces(eng) == 0


class TestFleetAndRestart:
    def test_fleet_refuses_per_replica_loads(self, models, artifact_dir):
        with pytest.raises(ValueError, match="ONE loaded AotArtifact"):
            FleetRouter.build(
                lambda i, registry: _engine(
                    models[1], aot=AotArtifact.load(artifact_dir),
                    registry=registry, labels={"replica": str(i)}),
                dp=2)

    def test_chaos_rerun_rebuilt_replica_reuses_artifact(
            self, models, artifact, traced_ref):
        """Injected engine death at dp=2: the supervisor rebuilds the
        replica onto the fleet's ONE artifact (the rebuild factory
        'forgets' it) — zero traces anywhere, the JAX tokens."""
        from paddle_tpu_torch.serving.fleet import affinity_replica_index

        target = affinity_replica_index(PROMPTS[0], dp=2, block_size=4)
        assert target is not None
        builds = []

        def factory(i, registry):
            builds.append(i)
            return _engine(models[1],
                           aot=artifact if len(builds) <= 2 else None,
                           registry=registry, labels={"replica": str(i)})

        plan = FaultPlan(faults=(
            FaultSpec(point="engine_step_raise", step=6,
                      replica=str(target)),))
        fleet = FleetRouter.build(factory, dp=2,
                                  config=FleetConfig(fault_plan=plan))
        assert fleet.aot_artifact is artifact
        sup = FleetSupervisor(fleet, config=SupervisorConfig(
            poll_interval_s=0.01, backoff_initial_s=0.02,
            backoff_max_s=0.5)).start()
        fleet.start()
        try:
            hs = [fleet.submit_request(
                p, SamplingParams(max_new_tokens=10),
                request_id=f"aot-{i}", retryable=True)
                for i, p in enumerate(PROMPTS)]
            fleet.wait(hs, timeout=300)
            lost = [h.rid for h in hs if h.finish_reason != "length"]
            assert not lost, f"requests lost under chaos: {lost}"
            assert [list(h.output_tokens) for h in hs] == traced_ref
            import time as _t
            t0 = _t.monotonic()
            while _t.monotonic() - t0 < 300:
                if all(r.healthy for r in fleet.replicas) \
                        and len(builds) >= 3:
                    break
                _t.sleep(0.02)
            assert len(builds) >= 3, "replica was never rebuilt"
            rebuilt = fleet.replicas[target].engine
            assert rebuilt.aot_artifact is artifact
            assert rebuilt.stepprof.aot_snapshot()["loaded"]
            for eng in fleet.engines:
                assert _traces(eng) == 0
                assert eng.stepprof.compile_table() == []
            assert int(sup._restarts["engine_death"].value) == 1
            # one load on the fleet's registry: the rebind took no sample
            assert sum(v["count"] for k, v in
                       fleet.registry.snapshot().items()
                       if k.startswith("serving_aot_load_seconds")) == 1
        finally:
            fleet.shutdown(drain_timeout=5.0)


    def test_rebuilt_replica_of_a_warmed_fleet_captures_nothing_serving(
            self, models, artifact, traced_ref):
        """A fleet warmed with ``warm_aot``: the replica the supervisor
        rebuilds after an injected death is warmed before it serves, so no
        engine of the fleet captures while serving, before or after the
        heal."""
        from paddle_tpu_torch.serving.fleet import affinity_replica_index

        target = affinity_replica_index(PROMPTS[0], dp=2, block_size=4)
        builds = []

        def factory(i, registry):
            builds.append(i)
            return _engine(models[1], aot=artifact, registry=registry,
                           labels={"replica": str(i)})

        plan = FaultPlan(faults=(
            FaultSpec(point="engine_step_raise", step=6,
                      replica=str(target)),))
        fleet = FleetRouter.build(factory, dp=2,
                                  config=FleetConfig(fault_plan=plan))
        warm = 2 * artifact.program_count
        assert set(fleet.warm_aot()) == {0, 1} and fleet.aot_warmed
        assert [e.graphs.captures for e in fleet.engines] == [warm, warm]
        FleetSupervisor(fleet, config=SupervisorConfig(
            poll_interval_s=0.01, backoff_initial_s=0.02,
            backoff_max_s=0.5)).start()
        fleet.start()
        try:
            for wave in range(2):
                hs = [fleet.submit_request(
                    p, SamplingParams(max_new_tokens=10),
                    request_id=f"warm-{wave}-{i}", retryable=True)
                    for i, p in enumerate(PROMPTS)]
                fleet.wait(hs, timeout=300)
                assert [list(h.output_tokens) for h in hs] == traced_ref
                import time as _t
                t0 = _t.monotonic()
                while _t.monotonic() - t0 < 300 and not (
                        len(builds) >= 3
                        and all(r.healthy for r in fleet.replicas)):
                    _t.sleep(0.02)
                assert len(builds) == 3, "replica was never rebuilt"
                assert [e.graphs.captures for e in fleet.engines] \
                    == [warm, warm]
            assert all(_traces(e) == 0 for e in fleet.engines)
        finally:
            fleet.shutdown(drain_timeout=5.0)


class TestHttpSurface:
    def test_debug_compiles_aot_block(self, models, artifact):
        from paddle_tpu_torch.serving.server import (
            CompletionServer,
            ServerConfig,
            _http,
        )

        eng = _engine(models[1], aot=artifact)

        async def main():
            loop = asyncio.get_running_loop()
            server = CompletionServer(eng, ServerConfig(port=0))
            await server.start()
            try:
                status, data = await loop.run_in_executor(
                    None, _http, server.port, "POST", "/v1/completions",
                    {"prompt": PROMPTS[0], "max_tokens": 4})
                assert status == 200, data
                status, data = await loop.run_in_executor(
                    None, _http, server.port, "GET",
                    "/v1/debug/compiles", None)
                assert status == 200
                obj = json.loads(data)
                assert obj["data"] == [] and obj["totals"] == {}
                aot = obj["aot"]["0"]
                assert aot["loaded"] and sum(aot["hits"].values()) > 0
                assert aot["programs"] == artifact.program_count
            finally:
                await server.shutdown(drain_timeout=2.0)

        asyncio.run(main())
        assert _traces(eng) == 0
