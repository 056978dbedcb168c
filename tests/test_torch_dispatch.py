"""The port's op bus (``paddle_tpu_torch/core/dispatch.py``) held to the
JAX package's (``paddle_tpu/core/dispatch.py``), as
``tests/test_observability.py``'s ``TestDispatchBus`` holds the JAX bus,
on the CPU: the same ops in both packages give the same stream of op
names to every subscriber; a subscriber that raises is dropped with a
message and the ops go on; the legacy ``_set_op_timer`` slot; the NaN/Inf
check raising ``FloatingPointError`` naming the op, or warning at
``check_nan_inf_level`` 1; ``eager_log_ops``; the flags (unknown names
raise ``ValueError``, the JAX flags the port does not act on raise naming
their ROADMAP item); the gate off when nothing is attached; an op inside
an op's body is not dispatched again; ``quiet()`` passes; ``trace_dispatch``
spans; ``EngineConfig(profile_ops=True)``'s host-op table beside the
JAX engine's.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.core import dispatch as jax_dispatch
from paddle_tpu.observability import subscribe_ops as jax_subscribe
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.observability import (
    SpanTracer,
    subscribe_ops,
    trace_dispatch,
)


@pytest.fixture(autouse=True)
def _cpu_and_clean():
    pt.set_device("cpu")
    yield
    pt.set_device(None)
    dispatch._set_op_timer(None)
    pt.set_flags({"check_nan_inf": False, "check_nan_inf_level": 0,
                  "eager_log_ops": False})
    assert dispatch._op_timer is None and not dispatch._hooked


def _port_ops(n=3):
    a = pt.to_tensor(np.ones((4, 4), np.float32))
    for _ in range(n):
        a = pt.add(a, a)
    a = pt.matmul(a, a, transpose_y=True)
    return pt.tensor.sum(pt.nn.functional.relu(a))


def _jax_ops(n=3):
    a = paddle.to_tensor(np.ones((4, 4), np.float32))
    for _ in range(n):
        a = paddle.add(a, a)
    a = paddle.matmul(a, a, transpose_y=True)
    return paddle.tensor.sum(paddle.nn.functional.relu(a))


def test_subscribers_see_the_jax_op_stream():
    seen1, seen2, jax_seen = [], [], []
    rm1 = subscribe_ops(lambda name, dt: seen1.append(name))
    rm2 = subscribe_ops(lambda name, dt: seen2.append((name, dt)))
    rmj = jax_subscribe(lambda name, dt: jax_seen.append(name))
    try:
        out = _port_ops()
        ref = _jax_ops()
    finally:
        rm1()
        rm2()
        rmj()
    assert seen1 == jax_seen == ["add"] * 3 + ["matmul", "relu", "sum"]
    assert [n for n, _ in seen2] == seen1
    assert all(dt >= 0.0 for _, dt in seen2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.numpy()))
    n = len(seen1)
    _port_ops()
    assert len(seen1) == n           # removed: no more callbacks
    assert dispatch._op_timer is None and jax_dispatch._op_timer is None


def test_broken_subscriber_is_dropped_not_fatal(capsys):
    good = []

    def bad(name, dt):
        raise RuntimeError("broken subscriber")

    rm_bad = subscribe_ops(bad)
    rm_good = subscribe_ops(lambda name, dt: good.append(name))
    try:
        assert _port_ops() is not None        # must not raise
        assert good
        assert "unsubscribed" in capsys.readouterr().err
        assert bad not in dispatch._op_timer_subs
    finally:
        rm_bad()
        rm_good()


def test_legacy_set_op_timer_single_slot():
    calls1, calls2, bus = [], [], []
    rm = subscribe_ops(lambda n, d: bus.append(n))
    try:
        dispatch._set_op_timer(lambda n, d: calls1.append(n))
        _port_ops(1)
        # replacing the legacy slot leaves the bus subscribers
        dispatch._set_op_timer(lambda n, d: calls2.append(n))
        _port_ops(1)
        dispatch._set_op_timer(None)
        _port_ops(1)
        assert calls1 == calls2 == ["add", "matmul", "relu", "sum"]
        assert len(bus) == 3 * len(calls1)
    finally:
        dispatch._set_op_timer(None)
        rm()
    assert dispatch._op_timer is None


def _nan_op(pkg):
    x = pkg.to_tensor(np.array([1.0, -1.0], np.float32))
    return pkg.tensor.log(x)            # log(-1) = NaN


def test_nan_check_raises_naming_the_op_in_both_packages():
    for pkg in (pt, paddle):
        pkg.set_flags({"check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError, match="op 'log'"):
                _nan_op(pkg)
            # finite outputs and integer outputs pass
            pkg.tensor.exp(pkg.to_tensor(np.ones(2, np.float32)))
            pkg.tensor.argmax(pkg.to_tensor(np.ones(2, np.float32)))
        finally:
            pkg.set_flags({"check_nan_inf": False})
    assert not dispatch._hooked


def test_nan_check_level_one_warns():
    pt.set_flags({"check_nan_inf": True, "check_nan_inf_level": 1})
    with pytest.warns(RuntimeWarning, match="op 'log'"):
        out = _nan_op(pt)
    assert torch.isnan(out).any()
    # the debugging module's switch is the same flag
    pt.amp.debugging.disable_tensor_checker()
    assert not pt.get_flags("check_nan_inf")["check_nan_inf"]
    pt.amp.debugging.enable_tensor_checker(
        pt.amp.debugging.TensorCheckerConfig(
            debug_mode=pt.amp.debugging.DebugMode.CHECK_NAN_INF))
    assert pt.get_flags(["FLAGS_check_nan_inf", "check_nan_inf_level"]) == {
        "FLAGS_check_nan_inf": True, "check_nan_inf_level": 1}


def test_nan_check_skips_inside_a_to_static_function():
    """The JAX check skips tracers; the port skips the check inside a
    ``to_static`` function (no host read there)."""
    pt.set_flags({"check_nan_inf": True})

    @pt.jit.to_static
    def f(x):
        return pt.tensor.log(x)

    x = pt.to_tensor(np.array([1.0, -1.0], np.float32))
    for _ in range(2):
        assert torch.isnan(f(x)).any()
    with pytest.raises(FloatingPointError):
        pt.tensor.log(x)


def test_eager_log_ops(capsys):
    pt.set_flags({"eager_log_ops": True})
    _port_ops(1)
    pt.set_flags({"eager_log_ops": False})
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"[paddle_tpu_torch eager] {n}"
                     for n in ("add", "matmul", "relu", "sum")]
    pt.amp.debugging.enable_operator_stats_collection()
    assert dispatch._hooked
    pt.amp.debugging.disable_operator_stats_collection()
    assert not dispatch._hooked


_ENV_FLAG = textwrap.dedent("""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import dispatch
    pt.set_device("cpu")
    assert dispatch._hooked
    x = pt.to_tensor(np.array([1.0, -1.0], np.float32))
    try:
        pt.tensor.log(x)
    except FloatingPointError as e:
        print("raised:", e)
    else:
        print("no raise")
""")


@pytest.mark.parametrize("env,want", [
    ({"FLAGS_check_nan_inf": "1"},
     ["raised: NaN/Inf detected in output 0 of op 'log'"]),
    ({"FLAGS_eager_log_ops": "1"},
     ["[paddle_tpu_torch eager] log", "no raise"]),
])
def test_flags_from_the_environment_act_from_import(env, want):
    """A flag set as ``FLAGS_<name>`` before the port is imported acts on
    the first op, with no ``set_flags`` call (as in the JAX package)."""
    out = subprocess.run([sys.executable, "-c", _ENV_FLAG],
                         capture_output=True, text=True, check=True,
                         cwd=str(pt.__path__[0] + "/.."),
                         env={**os.environ, **env})
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith(("raised", "no raise", "[paddle_tpu_torch"))]
    assert lines == want, out.stdout


@pytest.mark.parametrize("name,err,match", [
    ("no_such_flag", ValueError, "Unknown flag"),
    ("FLAGS_matmul_precision", NotImplementedError, "A12"),
    ("sync_collectives", NotImplementedError, "A11"),
])
def test_flags_the_port_does_not_have_raise(name, err, match):
    with pytest.raises(err, match=match):
        pt.set_flags({name: 1})
    with pytest.raises(err, match=match):
        pt.get_flags(name)


def test_flag_values_parse_as_the_jax_flags_do():
    for pkg in (pt, paddle):
        pkg.set_flags({"FLAGS_check_nan_inf_level": "1",
                       "low_precision_op_list": "true"})
        got = pkg.get_flags(["check_nan_inf_level", "low_precision_op_list"])
        assert got == {"check_nan_inf_level": 1,
                       "low_precision_op_list": True}
        pkg.set_flags({"check_nan_inf_level": 0,
                       "low_precision_op_list": False})
    assert pt.get_default_dtype() == torch.float32


def test_nested_ops_dispatch_once():
    """An op called inside another op's body is a plain call: the JAX op's
    body dispatches nothing."""
    seen = []
    rm = subscribe_ops(lambda n, d: seen.append(n))
    try:
        outer = dispatch.defop("outer", lambda a: pt.add(a, a))
        outer(pt.to_tensor([1.0]))
    finally:
        rm()
    assert seen == ["outer"]
    assert outer.raw is not None and outer.__name__ == "outer"


def test_quiet_pass_keeps_casts_and_drops_rows():
    seen = []
    rm = subscribe_ops(lambda n, d: seen.append(n))
    pt.set_flags({"low_precision_op_list": True})
    pt.amp.debugging.clear_low_precision_op_list()
    x = pt.to_tensor(np.ones((2, 2), np.float32))
    try:
        with pt.amp.auto_cast(level="O1"), dispatch.quiet():
            out = pt.matmul(x, x)
    finally:
        rm()
        pt.set_flags({"low_precision_op_list": False})
    assert out.dtype == torch.bfloat16
    assert seen == [] and pt.amp.debugging.low_precision_op_list() == {}


def test_trace_dispatch_records_spans():
    tr = SpanTracer()
    rm = trace_dispatch(tr)
    try:
        _port_ops(2)
    finally:
        rm()
    spans = [s for s in tr.spans() if s.cat == "dispatch"]
    assert [s.name for s in spans] == ["add", "add", "matmul", "relu", "sum"]
    assert all(s.duration >= 0 for s in spans)


def test_the_gate_is_off_with_nothing_attached():
    assert not dispatch._hooked
    with pt.amp.auto_cast():
        assert dispatch._hooked
        with pt.amp.auto_cast(level="O2"):
            assert dispatch._hooked
        assert dispatch._hooked
    assert not dispatch._hooked
    rm = subscribe_ops(lambda n, d: None)
    assert dispatch._hooked
    rm()
    assert not dispatch._hooked


def test_profile_ops_host_operator_summary_beside_jax():
    """``EngineConfig(profile_ops=True)``: each step's dispatches land in
    "Host operator summary" under the JAX engine's op names, and the timer
    is released after each step."""
    from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu.serving import EngineConfig as JaxEngineConfig
    from paddle_tpu.serving import EngineCore as JaxEngine
    from paddle_tpu.serving import SamplingParams as JaxSP
    from paddle_tpu_torch import convert
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.serving import EngineConfig, EngineCore
    from paddle_tpu_torch.serving import SamplingParams

    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=1))
    state = {k: np.array(np.asarray(v.numpy()), copy=True)
             for k, v in jm.state_dict().items()}
    pm = convert.llama_from_paddle_tpu(
        state, LlamaConfig.tiny(num_hidden_layers=1), device="cpu")
    prompt = [3, 5, 7, 9, 11]
    kw = dict(num_blocks=16, block_size=4, profile_ops=True)
    eng = EngineCore(pm, config=EngineConfig(**kw))
    jeng = JaxEngine(jm, config=JaxEngineConfig(**kw))
    eng.add_request(prompt, SamplingParams(max_new_tokens=3),
                    request_id="a")
    jeng.add_request(prompt, JaxSP(max_new_tokens=3), request_id="a")
    for _ in range(4):
        eng.step()
        assert dispatch._op_timer is None
    jeng.run(max_steps=4)
    rows = set(eng.metrics._host_ops.stats)
    jrows = set(jeng.metrics._host_ops.stats)
    assert "Host operator summary" in eng.metrics.summary()
    assert rows and rows <= jrows | {"getitem"}
    assert {"linear", "rms_norm", "embedding"} <= rows
