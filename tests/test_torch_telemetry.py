"""The port's ``TrainStepTelemetry`` (``observability/telemetry.py``) held
to the JAX class on the CPU.

* ``train_flops_per_token`` hand-computed as ``tests/test_mfu_accounting.py``
  computes it, and equal to the JAX function on the 6.7B GPT's geometry.
* The same steps through both classes, each on its own registry and
  tracer: the Prometheus text byte for byte, the returned numbers, and the
  ``train_step`` instants' names, categories and attributes.
"""

import numpy as np

from paddle_tpu.distributed.auto_tuner import \
    train_flops_per_token as jax_flops
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import SpanTracer as JaxTracer
from paddle_tpu.observability.telemetry import \
    TrainStepTelemetry as JaxTelemetry
from paddle_tpu_torch.distributed.auto_tuner import train_flops_per_token
from paddle_tpu_torch.observability import (
    MetricsRegistry,
    SpanTracer,
    TrainStepTelemetry,
)


def test_flops_per_token_hand_computed():
    # 6N = 600,000,000;  12*L*S*H = 12*6*2048*1024 = 150,994,944
    assert train_flops_per_token(100_000_000, 6, 2048, 1024) == \
        600_000_000 + 150_994_944
    assert train_flops_per_token(1e9) == 6e9
    for args in ((6.7e9, 32, 2048, 4096), (110e6, 12, 384, 768)):
        assert train_flops_per_token(*args) == jax_flops(*args)


def _steps():
    rng = np.random.default_rng(0)
    return [(int(rng.integers(1000, 9000)), float(rng.uniform(0.05, 0.3)))
            for _ in range(5)] + [(128, 0.0)]


def test_series_and_instants_equal_the_jax_class():
    geometry = dict(n_params=6.7e9, num_layers=4, seq_len=2048, hidden=4096,
                    peak_flops=989e12)
    jreg, jtr = JaxRegistry(), JaxTracer()
    treg, ttr = MetricsRegistry(), SpanTracer()
    jtel = JaxTelemetry(registry=jreg, tracer=jtr, **geometry)
    ttel = TrainStepTelemetry(registry=treg, tracer=ttr, **geometry)
    assert ttel.flops_per_token == jtel.flops_per_token
    for tokens, seconds in _steps():
        assert ttel.step(tokens, seconds) == jtel.step(tokens, seconds)
    assert ttel.steps == jtel.steps == 6
    text = treg.prometheus_text()
    assert text == jreg.prometheus_text()
    assert "train_mfu" in text and "train_step_seconds_count 6" in text
    jspans, tspans = jtr.spans(), ttr.spans()
    assert [(s.name, s.cat, s.attrs) for s in tspans] == \
        [(s.name, s.cat, s.attrs) for s in jspans]
    assert all(s.name == "train_step" and s.cat == "train" for s in tspans)


def test_without_a_peak_the_mfu_is_zero():
    tel = TrainStepTelemetry(n_params=1e6, registry=MetricsRegistry(),
                             tracer=SpanTracer())
    out = tel.step(tokens=100, seconds=0.5)
    assert out == {"tokens_per_sec": 200.0, "mfu": 0.0, "seconds": 0.5}
