"""The port's numerics auditor (``paddle_tpu_torch/observability/audit.py``)
held to the JAX package's (``tests/test_numerics_audit.py``'s
engine-level classes), on the CPU.

* ``TestUnits``: ``logit_stats`` equals the JAX reductions on the same
  rows (non-finite entries included), a 1-D row is one row, the config
  is validated, and the compact snapshot's page set and remap.
* ``TestCleanAudit``: the auditor on (every step sampled) vs off gives
  the same tokens and the same captures on the legacy, burst and unified
  families, with graphs and eagerly, and audits clean: the shadow
  oracle's logits equal the primary's within 1e-4, no oracle failure; the
  series are on the page only when on; the sampling schedule and the
  audited launch counts equal the JAX auditor's on the same run; the
  snapshot copies only the pages a step names; the shadow re-run moves no
  kernel wrapper's launch counter and no graph's static buffer.
* ``TestForcedCorruption``: the wrappers the engine calls are patched to
  negate (decode and ragged) or to emit NaNs — the plain twins the
  oracle calls are untouched.  Each run degrades the auditor with the
  right kind, writes exactly one repro under ``max_repro_bytes``, and
  ``replay_repro`` on a clean engine reproduces it; a size cap drops the
  pools and still reproduces from the stored logits; without a repro
  directory the auditor still degrades and counts; a bound flight
  recorder dumps one divergence bundle.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability.audit import AuditConfig as JaxAuditConfig
from paddle_tpu.observability.audit import logit_stats as jax_logit_stats
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu_torch.observability import (
    AuditConfig,
    FlightConfig,
    FlightRecorder,
    load_repro,
    logit_stats,
    replay_repro,
)
from paddle_tpu_torch.observability import audit as port_audit
from paddle_tpu_torch.ops import paged_decode, ragged_paged
from paddle_tpu_torch.serving import (
    EngineConfig,
    EngineCore,
    SamplingParams,
    SchedulerConfig,
)
from paddle_tpu_torch.serving.graphs import disable_graphs

import torch_obs_pairs as tp

ON = AuditConfig(enabled=True, sample_every=1)


@pytest.fixture(scope="module")
def model():
    return tp.port_model(tp.jax_model())


def _engine(model, family, audit, num_blocks=64, **fields):
    return EngineCore(model, config=EngineConfig(
        num_blocks=num_blocks, block_size=tp.BS, audit=audit,
        scheduler=SchedulerConfig(max_num_seqs=4,
                                  max_prefill_tokens_per_step=8),
        **tp.FAMILIES[family], **fields))


def _run(eng, n=2, max_new=4):
    return tp.run(eng, SamplingParams, tp.prompts(n=n), max_new=max_new)


def _corrupt(wrapper_mod, name, how):
    """The wrapper the engine calls, with its output corrupted; a call
    that pins the plain twin (``use_pallas=False``, the oracle's) is
    left alone."""
    real = getattr(wrapper_mod, name)

    def corrupted(*args, use_pallas=None):
        out = real(*args, use_pallas=use_pallas)
        return out if use_pallas is False else how(out)

    return corrupted


@pytest.fixture
def corrupt_kernel(monkeypatch):
    """Negate the decode and ragged wrappers' output: a drastic,
    deterministic drift that flips greedy tokens."""
    monkeypatch.setattr(paged_decode, "paged_attention_decode",
                        _corrupt(paged_decode, "paged_attention_decode",
                                 torch.neg))
    monkeypatch.setattr(ragged_paged, "ragged_paged_attention",
                        _corrupt(ragged_paged, "ragged_paged_attention",
                                 torch.neg))
    yield


@pytest.fixture
def nan_kernel(monkeypatch):
    nan = lambda out: torch.full_like(out, float("nan"))  # noqa: E731
    monkeypatch.setattr(paged_decode, "paged_attention_decode",
                        _corrupt(paged_decode, "paged_attention_decode",
                                 nan))
    monkeypatch.setattr(ragged_paged, "ragged_paged_attention",
                        _corrupt(ragged_paged, "ragged_paged_attention",
                                 nan))
    yield


class TestUnits:
    def test_logit_stats_rows_equal_jax(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((5, 64)).astype(np.float32) * 4
        x[1, 3] = np.nan
        x[2, 7] = np.inf
        x[2, 9] = -np.inf
        got = logit_stats(torch.from_numpy(x)).numpy()
        want = np.asarray(jax_logit_stats(x))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert got[0, 0] == 0 and got[1, 0] == 1 and got[2, 0] == 2

    def test_logit_stats_1d_row(self):
        row = torch.tensor([1.0, 5.0, 3.0])
        np.testing.assert_allclose(logit_stats(row).numpy(),
                                   [[0.0, 5.0, 2.0]])

    def test_config_validation(self):
        with pytest.raises(ValueError):
            AuditConfig(sample_every=0)
        with pytest.raises(ValueError):
            AuditConfig(max_repros=0)
        a, b = AuditConfig(), JaxAuditConfig()
        for f in ("enabled", "sample_every", "logit_atol", "logit_rtol",
                  "max_repro_bytes", "repro_dir", "max_repros"):
            assert getattr(a, f) == getattr(b, f), f

    def test_compact_pages_and_remap(self):
        inputs = {"tables": np.array([[7, 3, 0], [9, 0, 0]], np.int32),
                  "slot_blocks": np.array([3, 12], np.int64)}
        pages = port_audit.compact_pages(inputs)
        assert pages.tolist() == [0, 3, 7, 9, 12]
        out = port_audit.remap_pages(inputs, pages)
        assert out["tables"].tolist() == [[2, 1, 0], [3, 0, 0]]
        assert out["slot_blocks"].tolist() == [1, 4]
        assert out["tables"].dtype == np.int32
        assert pages[out["tables"]].tolist() == inputs["tables"].tolist()


class TestCleanAudit:
    @pytest.mark.parametrize("family", list(tp.FAMILIES))
    def test_on_vs_off_token_identical_equal_captures(self, model, family):
        runs = {}
        for name, audit, eager in (("on", ON, False), ("off", None, False),
                                   ("on_eager", ON, True)):
            eng = _engine(model, family, audit, num_blocks=15)
            n0 = (paged_decode.launches, ragged_paged.launches)
            if eager:
                with disable_graphs():
                    tokens = tp.run(eng, SamplingParams, tp.prompts())
            else:
                tokens = tp.run(eng, SamplingParams, tp.prompts())
            runs[name] = (eng, tokens, (paged_decode.launches - n0[0],
                                        ragged_paged.launches - n0[1]))
        on, off = runs["on"][0], runs["off"][0]
        assert runs["on"][1] == runs["off"][1] == runs["on_eager"][1]
        for f in ("decode", "burst", "ragged"):
            assert getattr(on, f"{f}_trace_count") == \
                getattr(off, f"{f}_trace_count"), f
        assert on.graphs.captures == off.graphs.captures
        # the wrappers' launch counters move alike (the shadow re-runs go
        # through the plain twins and count nothing)
        assert runs["on"][2] == runs["off"][2] == runs["on_eager"][2]
        assert on.metrics.counters["preemptions"] > 0
        for eng in (on, runs["on_eager"][0]):
            snap = eng.audit.snapshot()
            assert snap["status"] == "ok"
            assert sum(snap["divergences"].values()) == 0
            assert sum(snap["audited_launches"].values()) > 0
            assert snap["oracle_failures"] == 0
            # the oracle and the primary agree within the default 1e-4
            assert eng.audit.max_abs_diff <= 1e-4
            assert eng.audit._absdiff_h.count > 0

    def test_metrics_present_when_on_absent_when_off(self, model):
        on = _engine(model, "legacy", ON)
        _run(on, n=1, max_new=3)
        text = on.metrics.prometheus_text()
        for name in port_audit.METRIC_NAMES:
            assert name in text, name
        off = _engine(model, "legacy", None)
        _run(off, n=1, max_new=3)
        text = off.metrics.prometheus_text()
        assert "serving_audit" not in text and "serving_logit" not in text

    def test_sample_schedule_matches_jax(self, model):
        cfg = dict(enabled=True, sample_every=3)
        eng = _engine(model, "legacy", AuditConfig(**cfg))
        _run(eng, n=2, max_new=6)
        paddle.seed(0)
        jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=tp.LAYERS))
        jax = JaxEngineCore(jm, config=JaxEngineConfig(
            num_blocks=64, block_size=tp.BS,
            audit=JaxAuditConfig(**cfg),
            scheduler=JaxSchedulerConfig(max_num_seqs=4,
                                         max_prefill_tokens_per_step=8)))
        tp.run(jax, JaxSamplingParams, tp.prompts(n=2), max_new=6)
        snap, jsnap = eng.audit.snapshot(), jax.audit.snapshot()
        assert 0 < sum(snap["audited_launches"].values()) < snap["steps"]
        for key in ("status", "steps", "audited_launches", "divergences",
                    "oracle_failures", "sample_every"):
            assert snap[key] == jsnap[key], key

    def test_snapshot_copies_only_the_named_pages(self, model):
        eng = _engine(model, "unified", ON)
        seen = []
        real = eng.audit.snapshot_pools

        def spy(k, v, inputs):
            pre, remapped = real(k, v, inputs)
            seen.append((pre[0][0].shape[0], remapped["pages"]))
            return pre, remapped

        eng.audit.snapshot_pools = spy
        _run(eng)
        assert seen
        for n, pages in seen:
            assert n == len(pages) < eng.num_blocks and pages[0] == 0
        assert eng.audit.snapshot_bytes_max > 0


class TestForcedCorruption:
    @pytest.mark.parametrize("family, program", [("legacy", "decode"),
                                                 ("unified", "ragged")])
    def test_token_divergence_one_repro_replayable(
            self, model, tmp_path, corrupt_kernel, family, program):
        eng = _engine(model, family, AuditConfig(
            enabled=True, sample_every=1, repro_dir=str(tmp_path)))
        _run(eng)
        snap = eng.audit.snapshot()
        assert snap["status"] == "degraded"
        assert snap["divergences"]["token"] > 0
        assert snap["divergences"]["nonfinite"] == 0
        assert len(snap["repros"]) == 1
        path = snap["repros"][0]
        assert os.path.getsize(path) <= eng.audit.cfg.max_repro_bytes
        r = load_repro(path)
        assert r["meta"]["kind"] == "token"
        assert r["meta"]["program"] == program
        for key in ("ids", "tables", "lens", "k_pools", "v_pools", "pages",
                    "primary_logits", "reference_logits"):
            assert key in r["arrays"], key
        clean = _engine(model, family, None)
        verdict = replay_repro(path, clean)
        assert verdict["reproduced"] and verdict["replayed"]
        assert verdict["max_abs_diff"] > 0
        assert snap["last_divergence"]["program"] == program

    def test_nan_injection_one_repro_nonfinite_kind(self, model, tmp_path,
                                                    nan_kernel):
        eng = _engine(model, "legacy", AuditConfig(
            enabled=True, sample_every=1, repro_dir=str(tmp_path)))
        _run(eng)
        snap = eng.audit.snapshot()
        assert snap["status"] == "degraded"
        assert snap["divergences"]["nonfinite"] > 0
        assert snap["divergences"]["token"] == 0
        assert snap["nonfinite_values"] > 0
        assert len(snap["repros"]) == 1
        r = load_repro(snap["repros"][0])
        assert r["meta"]["kind"] == "nonfinite"
        assert replay_repro(snap["repros"][0], eng)["reproduced"]
        assert not np.isfinite(r["arrays"]["primary_logits"]).all()

    def test_repro_size_cap_drops_pools(self, model, tmp_path,
                                        corrupt_kernel):
        full = _engine(model, "legacy", AuditConfig(
            enabled=True, sample_every=1, repro_dir=str(tmp_path / "a")))
        _run(full)
        r = load_repro(full.audit.snapshot()["repros"][0])
        # a cap between the bundle without its pools and the whole one
        # (the compact snapshot is small, so the cap is measured)
        buf = io.BytesIO()
        np.savez_compressed(buf, meta=np.array(json.dumps(r["meta"])),
                            **{k: v for k, v in r["arrays"].items()
                               if k not in ("k_pools", "v_pools")})
        cap = buf.tell() + 512
        assert cap < os.path.getsize(full.audit.snapshot()["repros"][0])
        eng = _engine(model, "legacy", AuditConfig(
            enabled=True, sample_every=1, repro_dir=str(tmp_path / "b"),
            max_repro_bytes=cap))
        _run(eng)
        path = eng.audit.snapshot()["repros"][0]
        assert os.path.getsize(path) <= cap
        r = load_repro(path)
        assert "v_pools" in r["meta"]["dropped"]
        verdict = replay_repro(path, eng)
        assert verdict["reproduced"] and not verdict["replayed"]

    def test_no_repro_dir_still_degrades_and_counts(self, model,
                                                    corrupt_kernel):
        eng = _engine(model, "legacy", ON)
        _run(eng)
        snap = eng.audit.snapshot()
        assert snap["status"] == "degraded"
        assert snap["divergences"]["token"] > 0 and snap["repros"] == []

    def test_flight_recorder_dumps_one_divergence_bundle(
            self, model, tmp_path, corrupt_kernel):
        eng = _engine(model, "unified", ON)
        fr = FlightRecorder(registry=eng.metrics.registry,
                            lifecycle=eng.lifecycle,
                            config=FlightConfig(dump_dir=str(tmp_path)))
        eng.audit.bind_flight(fr)
        _run(eng)
        names = os.listdir(tmp_path)
        assert len([n for n in names
                    if n.startswith("flight_divergence_")]) == 1
        # the repro lands next to the bundles when no repro_dir is set
        assert len([n for n in names if n.endswith(".npz")]) == 1
