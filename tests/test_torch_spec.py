"""The port's speculative decoding (``serving/spec.py`` and the verify rows
of the unified step), held to the JAX package on the same weights (CPU,
fp32, ``LlamaConfig.tiny`` at 1 layer, weights through
``convert.llama_from_paddle_tpu``).

* The n-gram proposer and ``SpecConfig`` agree with the JAX ones case for
  case; ``plan_drafts`` upgrades the same rows with the same drafts.
* Spec on gives the JAX spec engine's tokens, drafted and accepted counts,
  engine steps and bucket set, greedy and seeded sampled, with the step
  graphs and under ``disable_graphs()``; those tokens equal spec off's and
  take strictly fewer steps.
* A pool small enough to preempt (the count is asserted > 0 first:
  ``tests/test_zzzzzzzz_spec_sampling.py:368`` sizes its pool at 12
  blocks, where the spec run finishes its cyclic stream early and never
  preempts) recomputes token-identically, as the JAX engine does.
* After every spec step the pool invariant holds and no chain hash names
  a block the rollback freed.

The JAX reference runs are built once per module.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu.serving.spec import NgramProposer as JaxNgramProposer
from paddle_tpu.serving.spec import SpecConfig as JaxSpecConfig
from paddle_tpu.serving.spec import SpecDecoder as JaxSpecDecoder
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.serving import (
    EngineConfig,
    EngineCore,
    SamplingParams,
    SchedulerConfig,
    graphs,
)
from paddle_tpu_torch.serving.spec import NgramProposer, SpecConfig, SpecDecoder

LAYERS = 1
_RNG = np.random.default_rng(7)
LOOP_PROMPT = [5, 6, 7, 8] * 3
MID_PROMPT = [5, 6, 7, 8] * 2 + [5, 6, 7]
PROMPTS = [LOOP_PROMPT, [40, 2, 11, 40, 2, 11, 40, 2],
           _RNG.integers(0, 256, 8).tolist()]
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, seed=1234)
# (name, prompts, max_new, sampling, num_blocks, spec)
SCENARIOS = {
    # one cyclic stream: spec on finishes in strictly fewer steps
    "loop": ([LOOP_PROMPT], 16, None, 64),
    "greedy": (PROMPTS, 12, None, 64),
    "sampled": ([MID_PROMPT] + PROMPTS[1:], 12, SAMPLED, 64),
    # 8 blocks preempt with spec on (12 do not: C3(b))
    "tight": (PROMPTS, 8, None, 8),
}


def _jax_engine(model, num_blocks, spec):
    return JaxEngineCore(model, config=JaxEngineConfig(
        num_blocks=num_blocks, block_size=4,
        scheduler=JaxSchedulerConfig(max_num_seqs=4, max_tokens_per_step=16),
        unified_step=True, spec=JaxSpecConfig(k=4) if spec else None))


def _port_engine(model, num_blocks, spec):
    return EngineCore(model, config=EngineConfig(
        num_blocks=num_blocks, block_size=4,
        scheduler=SchedulerConfig(max_num_seqs=4, max_tokens_per_step=16),
        unified_step=True, spec=SpecConfig(k=4) if spec else None))


def _run(eng, params_cls, prompts, max_new, sampling):
    reqs = [eng.add_request(p, params_cls(max_new_tokens=max_new,
                                          **(sampling or {})))
            for p in prompts]
    eng.run(max_steps=4000)
    assert all(r.finished for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _summary(eng, tokens):
    return {"tokens": tokens,
            "steps": eng.metrics.counters["engine_steps"],
            "preemptions": eng.metrics.counters["preemptions"],
            "drafted": eng.spec.drafted_total if eng.spec else 0,
            "accepted": eng.spec.accepted_total if eng.spec else 0,
            "buckets": sorted(eng.ragged_buckets)}


@pytest.fixture(scope="module")
def weights():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=LAYERS))
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, state


@pytest.fixture(scope="module")
def port_model(weights):
    return llama_from_paddle_tpu(
        weights[1], LlamaConfig.tiny(num_hidden_layers=LAYERS), device="cpu")


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX engine's runs, once: every scenario spec on, and the plain
    greedy and sampled ones spec off."""
    jm = weights[0]
    out = {}
    for name, (prompts, max_new, sampling, nb) in SCENARIOS.items():
        for spec in ((True, False) if name != "tight" else (True,)):
            eng = _jax_engine(jm, nb, spec)
            toks = _run(eng, JaxSamplingParams, prompts, max_new, sampling)
            out[name, spec] = _summary(eng, toks)
    return out


def _port_run(model, name, spec=True):
    prompts, max_new, sampling, nb = SCENARIOS[name]
    eng = _port_engine(model, nb, spec)
    toks = _run(eng, SamplingParams, prompts, max_new, sampling)
    return eng, _summary(eng, toks)


# --- host-side pieces ---------------------------------------------------------

CONTEXTS = [[], [1], [1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 7, 8] * 3,
            [9, 9, 9, 9, 9], [1, 2, 3, 4, 5, 6, 7, 8],
            [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4, 6, 2,
             6, 4, 3, 3, 8, 3, 2, 7, 9, 5, 3, 1, 4, 1, 5]]


@pytest.mark.parametrize("ngram,min_ngram,window", [(3, 1, 256), (2, 2, 8),
                                                    (1, 1, 4), (4, 2, 16)])
@pytest.mark.parametrize("k", [0, 1, 4])
def test_ngram_proposer_matches_jax(ngram, min_ngram, window, k):
    mine = NgramProposer(ngram, min_ngram, window)
    ref = JaxNgramProposer(ngram, min_ngram, window)
    for ctx in CONTEXTS:
        assert mine.propose(ctx, k) == ref.propose(ctx, k), ctx


@pytest.mark.parametrize("kw", [dict(k=-1), dict(min_ngram=0),
                                dict(ngram=1, min_ngram=2),
                                dict(ngram=4, window=4)])
def test_spec_config_refuses_like_jax(kw):
    with pytest.raises(ValueError):
        JaxSpecConfig(**kw)
    with pytest.raises(ValueError):
        SpecConfig(**kw)


def test_spec_config_manifest_matches_jax():
    cfg = dict(k=3, ngram=2, min_ngram=1, window=64)
    assert SpecConfig(**cfg).manifest_json() == \
        JaxSpecConfig(**cfg).manifest_json()


class _KV:
    """A pool that grants the first ``grants`` draft allocations."""

    def __init__(self, grants=99):
        self.grants = grants
        self.calls = []

    def allocate(self, rid, n, cause="other"):
        self.calls.append((rid, n, cause))
        self.grants -= 1
        return self.grants >= 0


class _Req:
    def __init__(self, rid, prompt, out, max_new=16):
        self.request_id, self.prompt_ids = rid, prompt
        self.output_tokens = list(out)
        self.sampling = SamplingParams(max_new_tokens=max_new)

    @property
    def last_token(self):
        return self.output_tokens[-1]


def _rows():
    return [{"req": _Req("a", [5, 6, 7, 8] * 2, [5, 6, 7]), "kind": "decode",
             "start": 11, "n": 1, "tokens": [7]},
            {"req": _Req("b", [1, 2, 1, 2, 1], [2], max_new=3),
             "kind": "decode", "start": 6, "n": 1, "tokens": [2]},
            {"req": _Req("c", [9, 8, 7], [6]), "kind": "decode", "start": 4,
             "n": 1, "tokens": [6]}]


@pytest.mark.parametrize("budget,grants", [(0, 9), (3, 9), (16, 9), (16, 1)])
def test_plan_drafts_matches_jax(budget, grants):
    mine, ref = _rows(), _rows()
    kv_m, kv_r = _KV(grants), _KV(grants)
    n_m = SpecDecoder(SpecConfig(k=4)).plan_drafts(kv_m, mine, budget)
    n_r = JaxSpecDecoder(JaxSpecConfig(k=4)).plan_drafts(kv_r, ref, budget)
    assert n_m == n_r
    assert kv_m.calls == kv_r.calls
    for a, b in zip(mine, ref):
        assert {k: a[k] for k in ("kind", "n", "tokens")} == \
            {k: b[k] for k in ("kind", "n", "tokens")}
        assert a.get("drafts") == b.get("drafts")


def test_spec_needs_unified_and_a_budget(port_model):
    with pytest.raises(ValueError, match="unified_step"):
        EngineCore(port_model, config=EngineConfig(
            num_blocks=16, block_size=4, spec=SpecConfig(k=4),
            scheduler=SchedulerConfig(max_tokens_per_step=16)))
    with pytest.raises(ValueError, match="max_tokens_per_step"):
        EngineCore(port_model, config=EngineConfig(
            num_blocks=16, block_size=4, unified_step=True,
            spec=SpecConfig(k=4)))
    off = EngineCore(port_model, config=EngineConfig(
        num_blocks=16, block_size=4, unified_step=True,
        spec=SpecConfig(enabled=False),
        scheduler=SchedulerConfig(max_tokens_per_step=16)))
    assert off.spec is None


# --- engines against the JAX package -----------------------------------------

@pytest.mark.parametrize("eager", [False, True], ids=["graphs", "eager"])
@pytest.mark.parametrize("name", ["loop", "greedy", "sampled"])
def test_spec_matches_jax_and_spec_off(port_model, jax_runs, name, eager):
    ref, ref_off = jax_runs[name, True], jax_runs[name, False]
    if eager:
        with graphs.disable_graphs():
            eng, got = _port_run(port_model, name)
    else:
        eng, got = _port_run(port_model, name)
    # the JAX contract first: spec on == spec off (in fewer steps on the
    # lone cyclic stream)
    assert ref["tokens"] == ref_off["tokens"] and ref["drafted"] > 0
    if name == "loop":
        assert ref["accepted"] > 0 and ref["steps"] < ref_off["steps"]
    assert got == ref
    assert eng.kv.occupancy() == 0.0
    if not eager:
        # the verify rows ride the plain lattice: one capture per bucket
        assert eng.ragged_trace_count == len(eng.ragged_buckets)
        assert eng.decode_trace_count == eng.burst_trace_count == 0


def test_spec_off_matches_jax_spec_off(port_model, jax_runs):
    _, got = _port_run(port_model, "greedy", spec=False)
    assert got == jax_runs["greedy", False]


def test_spec_preemption_recompute_identity(port_model, jax_runs):
    eng, got = _port_run(port_model, "tight")
    assert got["preemptions"] > 0          # the premise, first
    assert got == jax_runs["tight", True]
    calm = jax_runs["greedy", True]
    # the same prompts in a roomy pool: identical streams (max_new differs,
    # so compare the shared prefix)
    assert [t[:8] for t in calm["tokens"]] == got["tokens"]
    assert eng.kv.occupancy() == 0.0


def test_pool_invariant_and_hashes_after_every_spec_step(port_model):
    prompts, max_new, _, _ = SCENARIOS["tight"]
    eng = _port_engine(port_model, 8, True)
    for p in prompts:
        eng.add_request(p, SamplingParams(max_new_tokens=max_new))
    kv = eng.kv
    steps = 0
    while eng.scheduler.has_work():
        eng.step()
        steps += 1
        assert steps < 400
        allocated = {b for t in kv._tables.values() for b in t}
        assert (len(kv._free) + len(kv._reuse) + len(allocated)
                == kv.num_blocks - 1)
        free = set(kv._free)
        # a rolled-back draft block is never named by the prefix cache
        assert not free & set(kv._hash_index.values())
        assert not free & set(kv._block_hash)
    assert eng.spec.drafted_total > eng.spec.accepted_total > 0


def test_spec_telemetry(port_model):
    eng, got = _port_run(port_model, "greedy")
    page = eng.metrics.registry.prometheus_text()
    for series in ("serving_spec_draft_tokens_total",
                   "serving_spec_accepted_tokens_total",
                   "serving_spec_verify_rows_total",
                   "serving_spec_accept_ratio",
                   "serving_spec_accept_length"):
        assert series in page
    assert eng.spec.accept_ratio == pytest.approx(
        got["accepted"] / got["drafted"])
    verify = [e for tl in eng.lifecycle.recent()
              for e in tl.to_dict()["events"] if e["name"] == "spec_verify"]
    assert verify and sum(e["accepted"] for e in verify) \
        == got["accepted"]
    # the scheduler's ledger counts the packed drafts as decode work, so
    # the step profiler's scheduled tokens still equal it
    assert eng.stepprof.scheduled_tokens() == eng.scheduler.tokens_planned
