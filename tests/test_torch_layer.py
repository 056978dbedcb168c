"""The port's ``nn.Layer`` (``paddle_tpu_torch/nn/layers.py``) and
``ParamAttr`` held to the JAX package's on the CPU: one user-defined
``Layer`` subclass, written once over a package, built in both and
carried across by ``convert.state_from_paddle_tpu`` — its
``state_dict`` keys and order (parameters breadth first, then the
persistent buffers), its parameter and sub-layer walks, its forward, its
forward pre/post hooks, ``set_state_dict``'s ``(missing, unexpected)``,
``ParamAttr``'s learning rate and trainability, ``add_parameter``
/ ``add_sublayer``, ``clear_gradients`` and ``to(dtype=)`` / ``astype``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")
    yield
    pt.set_device(None)


def _user_net(pkg):
    """A user's model, written once: what a Paddle script defines."""
    nn, F = pkg.nn, pkg.nn.functional

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.scale = self.create_parameter(
                [3], default_initializer=nn.initializer.Constant(1.5))
            self.norm = nn.LayerNorm(3)
            self.register_buffer("steps", pkg.zeros([1]))

        def forward(self, x):
            return self.norm(pkg.multiply(x, self.scale))

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter(
                [4, 3], attr=pkg.ParamAttr(
                    name="w0", learning_rate=0.5,
                    initializer=nn.initializer.Normal(0.0, 0.1)))
            self.b = self.create_parameter([3], is_bias=True)
            self.frozen = self.create_parameter(
                [3], attr=pkg.ParamAttr(trainable=False),
                default_initializer=nn.initializer.Constant(0.25))
            self.block = Block()
            self.fc = nn.Linear(3, 2)
            self.head = nn.Sequential(nn.ReLU(), nn.Linear(2, 2))
            self.register_buffer("count", pkg.ones([2]), persistable=True)
            self.register_buffer("scratch", pkg.zeros([2]),
                                 persistable=False)

        def forward(self, x):
            h = pkg.add(pkg.matmul(x, self.w), self.b)
            h = pkg.add(F.relu(h), self.frozen)
            return self.head(self.fc(self.block(h)))

    return Net()


def _pair():
    paddle.seed(3)
    jnet = _user_net(paddle)
    net = _user_net(pt)
    missing, unexpected = net.set_state_dict(
        convert.state_from_paddle_tpu(jnet))
    assert missing == [] and unexpected == []
    return jnet, net


X = np.random.default_rng(0).standard_normal((5, 4)).astype("float32")


def _fwd(net, pkg):
    out = net(pkg.to_tensor(X))
    return np.asarray(out.numpy()) if pkg is paddle else out.detach().numpy()


def test_state_dict_keys_order_and_walks_equal_jax():
    jnet, net = _pair()
    assert list(net.state_dict()) == list(jnet.state_dict())
    assert [n for n, _ in net.named_parameters()] == \
        [n for n, _ in jnet.named_parameters()]
    assert [n for n, _ in net.named_sublayers()] == \
        [n for n, _ in jnet.named_sublayers()]
    assert [n for n, _ in net.named_buffers()] == \
        [n for n, _ in jnet.named_buffers()]
    assert "scratch" not in net.state_dict()
    assert len(net.parameters()) == len(jnet.parameters())
    assert len(net.sublayers(include_self=True)) == len(
        jnet.sublayers(include_self=True))
    assert convert.paddle_parameter_order(net) == \
        [n for n, _ in net.named_parameters()]


def test_forward_equals_jax_on_the_carried_weights():
    jnet, net = _pair()
    np.testing.assert_allclose(_fwd(net, pt), _fwd(jnet, paddle),
                               rtol=1e-5, atol=1e-6)
    # the values crossed: the Linear weights transposed into the port's
    # layout, everything else as it is
    js = convert.state_from_paddle_tpu(jnet)
    for k, v in net.state_dict().items():
        want = js[k].T if k.endswith("fc.weight") or k == "head.1.weight" \
            else js[k]
        np.testing.assert_array_equal(v.detach().numpy(), want, err_msg=k)


def test_forward_hooks_equal_jax():
    jnet, net = _pair()
    hooks = []
    for n in (jnet, net):
        hooks.append(n.register_forward_pre_hook(
            lambda layer, inputs: tuple(i * 2.0 for i in inputs)))
        hooks.append(n.register_forward_post_hook(
            lambda layer, inputs, out: out + 1.0))
    np.testing.assert_allclose(_fwd(net, pt), _fwd(jnet, paddle),
                               rtol=1e-5, atol=1e-6)
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(_fwd(net, pt), _fwd(jnet, paddle),
                               rtol=1e-5, atol=1e-6)


def test_set_state_dict_partial_and_extra_keys_equal_jax():
    jnet, net = _pair()
    state = convert.state_from_paddle_tpu(jnet)
    part = {k: v for k, v in state.items() if not k.startswith("block")}
    part["nope"] = np.zeros(1, np.float32)
    jstate = {k: paddle.to_tensor(v) for k, v in part.items()}
    assert net.set_state_dict(part) == jnet.set_state_dict(jstate)
    with pytest.raises(ValueError, match="shape"):
        net.set_state_dict({"w": np.zeros((2, 2), np.float32)})
    # the port's own state dict loads back as it is
    own = {k: v.detach().clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        net.w.zero_()
    assert net.load_dict(own) == ([], [])
    np.testing.assert_allclose(_fwd(net, pt), _fwd(jnet, paddle),
                               rtol=1e-5, atol=1e-6)


def test_param_attr_and_registration():
    jnet, net = _pair()
    assert net.w.optimize_attr == {"learning_rate": 0.5} == \
        jnet.w.optimize_attr
    assert not net.frozen.requires_grad and jnet.frozen.stop_gradient
    assert net.frozen.stop_gradient
    assert float(net.b.abs().sum()) == 0.0          # a bias starts at 0
    extra = pt.nn.Layer()
    p = extra.add_parameter("p", torch.nn.Parameter(torch.ones(2)))
    sub = extra.add_sublayer("lin", pt.nn.Linear(2, 2, device="cpu"))
    assert extra.p is p and extra.lin is sub
    assert [n for n, _ in extra.named_parameters()] == ["p", "lin.weight",
                                                       "lin.bias"]
    extra.p = torch.zeros(2)                  # a tensor sets the value
    assert extra.p is p and float(p.sum()) == 0.0
    assert extra.full_name() == "layer"


def test_clear_gradients_and_dtype_moves():
    _, net = _pair()
    net(pt.to_tensor(X)).sum().backward()
    assert net.w.grad is not None
    net.clear_gradients()
    assert all(p.grad is None for p in net.parameters())
    net.to(dtype="bfloat16")
    assert net.w.dtype == torch.bfloat16 and net.count.dtype == torch.bfloat16
    net.astype("float32")
    assert net.w.dtype == torch.float32
    net.to("float16")
    assert net.fc.weight.dtype == torch.float16
    net.to(device="cpu", dtype=torch.float32)
    assert net.w.dtype == torch.float32 and net.w.device.type == "cpu"


def test_a_layer_inside_a_torch_module_uses_torch_state_dict():
    """A parent ``torch.nn.Module`` calls a child's ``state_dict`` with
    torch's arguments; a ``Layer`` child answers as torch does."""
    _, net = _pair()
    outer = torch.nn.Module()
    outer.inner = net
    keys = list(outer.state_dict())
    assert "inner.w" in keys and "inner.count" in keys
    assert "inner.scratch" not in keys
