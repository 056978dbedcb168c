"""The port's vision datasets, transforms and LeNet held to the JAX
package's on the CPU (mirroring ``tests/test_vision_ops.py:267-460``).

* Every transform, class and function, on the same seeded numpy image
  under one ``np.random.seed``: the output equal to the JAX one exactly
  where neither resizes, within 1e-5 where one does (``Resize``,
  ``RandomResizedCrop``); the generator left in the same state.
* ``Resize`` against ``jax.image.resize(method="bilinear")`` within 1e-5
  on [0, 1] images: downsampling, upsampling, mixed, one axis, 2-D.  The
  port's weights equal JAX's ``compute_weight_mat`` cast to float32
  within 6e-8; the JAX package computes them in float64 (it enables
  ``jax_enable_x64``), and so does the port (ROADMAP C4).
* The synthetic datasets (MNIST, FashionMNIST, Cifar10/100, Flowers,
  VOC2012, train and test) bit-equal, samples with a transform too;
  ``DatasetFolder`` and ``ImageFolder`` over ``.npy`` files: the same
  sample lists and samples.
* LeNet through ``convert.lenet_from_paddle_tpu``: logits within 1e-5,
  the weights back bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

import paddle_tpu as paddle
import paddle_tpu.vision.datasets as JD
import paddle_tpu.vision.transforms as JT
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import convert
from paddle_tpu_torch.nn.functional.common import resize_weight_mat
from paddle_tpu_torch.vision import datasets as PD
from paddle_tpu_torch.vision import models as pmodels
from paddle_tpu_torch.vision import transforms as PT


def _img(shape, seed=0, dtype=np.float32):
    a = np.random.default_rng(seed).random(shape)
    return (a * 255).astype(np.uint8) if dtype == np.uint8 else a.astype(dtype)


CHW = _img((3, 20, 24), 1)
HWC8 = _img((20, 24, 3), 2, np.uint8)

# (name, factory(module) -> callable, input, tolerance: 0 = exact)
CASES = [
    ("compose", lambda m: m.Compose([m.ToTensor(), m.Normalize(0.5, 0.5)]),
     HWC8, 0),
    ("to_tensor_uint8_hwc", lambda m: m.ToTensor(), HWC8, 0),
    ("to_tensor_2d", lambda m: m.ToTensor(), CHW[0], 0),
    ("normalize", lambda m: m.Normalize([0.4, 0.5, 0.6], [0.2, 0.3, 0.4]),
     CHW, 0),
    ("resize_down", lambda m: m.Resize((12, 10)), CHW, 1e-5),
    ("resize_int", lambda m: m.Resize(16), CHW, 1e-5),
    ("hflip", lambda m: m.RandomHorizontalFlip(0.5), CHW, 0),
    ("random_crop_pad", lambda m: m.RandomCrop(16, padding=2), CHW, 0),
    ("center_crop", lambda m: m.CenterCrop((11, 13)), CHW, 0),
    ("transpose", lambda m: m.Transpose(), HWC8, 0),
    ("pad_constant", lambda m: m.Pad((1, 2, 3, 4), fill=0.5), CHW, 0),
    ("pad_reflect", lambda m: m.Pad(2, padding_mode="reflect"), CHW, 0),
    ("pad_edge", lambda m: m.Pad((1, 3), padding_mode="edge"), CHW, 0),
    ("vflip", lambda m: m.RandomVerticalFlip(0.5), CHW, 0),
    ("brightness", lambda m: m.BrightnessTransform(0.4), CHW, 0),
    ("contrast", lambda m: m.ContrastTransform(0.4), CHW, 0),
    ("saturation", lambda m: m.SaturationTransform(0.4), CHW, 0),
    ("hue", lambda m: m.HueTransform(0.2), CHW, 0),
    ("color_jitter", lambda m: m.ColorJitter(0.3, 0.3, 0.3, 0.1), CHW, 0),
    ("grayscale", lambda m: m.Grayscale(3), CHW, 0),
    ("rotation", lambda m: m.RandomRotation(30), CHW, 0),
    ("affine", lambda m: m.RandomAffine(20, translate=(0.1, 0.2),
                                        scale=(0.8, 1.2), shear=10), CHW, 0),
    ("perspective", lambda m: m.RandomPerspective(prob=1.0), CHW, 0),
    ("resized_crop", lambda m: m.RandomResizedCrop(16), CHW, 1e-5),
    ("resized_crop_ratio", lambda m: m.RandomResizedCrop(
        (14, 18), scale=(0.5, 1.0), ratio=(0.5, 2.0)), CHW, 1e-5),
    ("erasing", lambda m: m.RandomErasing(prob=1.0, value=0.3), CHW, 0),
    ("erasing_random", lambda m: m.RandomErasing(prob=1.0, value="random"),
     CHW, 0),
    ("f_hflip", lambda m: m.hflip, CHW, 0),
    ("f_vflip", lambda m: m.vflip, CHW, 0),
    ("f_crop", lambda m: lambda x: m.crop(x, 2, 3, 9, 7), CHW, 0),
    ("f_center_crop", lambda m: lambda x: m.center_crop(x, 9), CHW, 0),
    ("f_pad_symmetric", lambda m: lambda x: m.pad(x, 2, padding_mode=
                                                  "symmetric"), CHW, 0),
    ("f_brightness_uint8", lambda m: lambda x: m.adjust_brightness(x, 1.5),
     _img((3, 8, 8), 3, np.uint8), 0),
    ("f_contrast", lambda m: lambda x: m.adjust_contrast(x, 0.6), CHW, 0),
    ("f_saturation", lambda m: lambda x: m.adjust_saturation(x, 1.7), CHW, 0),
    ("f_hue", lambda m: lambda x: m.adjust_hue(x, -0.3), CHW, 0),
    ("f_grayscale", lambda m: m.to_grayscale, CHW, 0),
    ("f_erase", lambda m: lambda x: m.erase(x, 1, 2, 5, 6, [0.1, 0.2, 0.3]),
     CHW, 0),
    ("f_affine", lambda m: lambda x: m.affine(x, 15, (2, -1), 0.9, (5, 3)),
     CHW, 0),
    ("f_rotate_expand", lambda m: lambda x: m.rotate(x, 40, expand=True),
     CHW, 0),
    ("f_perspective", lambda m: lambda x: m.perspective(
        x, [(0, 0), (23, 0), (23, 19), (0, 19)],
        [(2, 1), (21, 3), (22, 18), (1, 17)]), CHW, 0),
    ("f_to_tensor", lambda m: m.to_tensor, HWC8, 0),
    ("f_normalize", lambda m: lambda x: m.normalize(x, 0.3, 0.7), CHW, 0),
    ("f_resize_up", lambda m: lambda x: m.resize(x, (31, 45)), CHW, 1e-5),
]


@pytest.mark.parametrize("name,factory,x,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_transform_matches_jax(name, factory, x, tol):
    outs, states = [], []
    for m in (JT, PT):
        np.random.seed(31)
        fn = factory(m)
        outs.append(np.asarray([fn(x) for _ in range(3)]))
        states.append(np.random.get_state()[1].copy())
    want, got = outs
    assert got.shape == want.shape and got.dtype == want.dtype
    if tol:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    else:
        assert np.array_equal(got, want)
    assert np.array_equal(states[0], states[1])


RESIZE = [((3, 256, 256), (224, 224)), ((3, 50, 70), (224, 224)),
          ((3, 100, 40), (60, 90)), ((3, 300, 200), (224, 224)),
          ((3, 17, 9), (17, 30)), ((32, 48), (7, 5)), ((1, 28, 28), (56, 56))]


@pytest.mark.parametrize("shape,size", RESIZE,
                         ids=["down", "up", "mixed", "mixed_large",
                              "one_axis", "2d", "x2"])
def test_resize_matches_jax_image_resize(shape, size):
    a = _img(shape, 4)
    target = (shape[0],) + size if len(shape) == 3 else size
    want = np.asarray(jax.image.resize(jnp.asarray(a), target,
                                       method="bilinear"))
    got = PT.Resize(size)(a)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(300, 224), (256, 224), (200, 224),
                                        (50, 224), (70, 224), (9, 30),
                                        (48, 5)])
def test_resize_weights_equal_jax_weights(n_in, n_out):
    assert jax.config.jax_enable_x64     # paddle_tpu turns it on
    want = np.asarray(jax.jit(lambda: jax_scale.compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, jax_scale._fill_triangle_kernel,
        True))()).astype(np.float32)
    got = resize_weight_mat(n_in, n_out, "linear").astype(np.float32)
    assert got.dtype == np.float32 and got.shape == (n_in, n_out)
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-8)


@pytest.mark.parametrize("cls,kw", [
    ("MNIST", {"mode": "train"}), ("MNIST", {"mode": "test"}),
    ("FashionMNIST", {}), ("Cifar10", {"mode": "train"}),
    ("Cifar10", {"mode": "test"}), ("Cifar100", {}),
    ("Flowers", {"mode": "train"}), ("Flowers", {"mode": "test"}),
    ("VOC2012", {"mode": "train"}), ("VOC2012", {"mode": "test"})])
def test_synthetic_datasets_are_bit_equal(cls, kw):
    j, p = getattr(JD, cls)(**kw), getattr(PD, cls)(**kw)
    assert len(j) == len(p)
    for attr in ("images", "labels", "masks"):
        if hasattr(j, attr):
            a, b = getattr(j, attr), getattr(p, attr)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for i in (0, 7, len(j) - 1):
        for x, y in zip(j[i], p[i]):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            assert np.array_equal(x, y)


def test_dataset_transform_applies_in_both():
    tf = [m.Compose([m.Normalize(0.5, 0.25), m.CenterCrop(20)])
          for m in (JT, PT)]
    j = JD.MNIST(mode="test", transform=tf[0])
    p = PD.MNIST(mode="test", transform=tf[1])
    for i in (0, 3):
        assert np.array_equal(j[i][0], p[i][0]) and p[i][0].shape == (1, 20, 20)


def test_folders_list_and_load_the_same_samples(tmp_path):
    rng = np.random.default_rng(6)
    for c in ("b_cls", "a_cls"):
        (tmp_path / c / "sub").mkdir(parents=True)
        for i in range(3):
            np.save(tmp_path / c / f"{i}.npy",
                    rng.integers(0, 256, (6, 5, 3), np.uint8))
        np.save(tmp_path / c / "sub" / "x.npy", rng.random((2, 2)))
        (tmp_path / c / "notes.txt").write_text("skipped")
    tf = [m.ToTensor() for m in (JT, PT)]
    j = JD.DatasetFolder(str(tmp_path), transform=tf[0])
    p = PD.DatasetFolder(str(tmp_path), transform=tf[1])
    assert j.classes == p.classes == ["a_cls", "b_cls"]
    assert j.samples == p.samples and len(p) == 8
    for i in range(len(p)):
        assert np.array_equal(j[i][0], p[i][0]) and j[i][1] == p[i][1]
    ji = JD.ImageFolder(str(tmp_path))
    pi = PD.ImageFolder(str(tmp_path))
    assert ji.samples == pi.samples
    assert np.array_equal(ji[2][0], pi[2][0])
    with pytest.raises(RuntimeError, match="no class folders"):
        PD.DatasetFolder(str(tmp_path / "a_cls" / "sub"))


def test_lenet_logits_through_convert():
    paddle.seed(13)
    jm = jmodels.LeNet()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    pm = convert.lenet_from_paddle_tpu(state, device="cpu")
    x = np.random.default_rng(14).standard_normal((4, 1, 28, 28)).astype(
        np.float32)
    want = np.asarray(jm(paddle.to_tensor(x)).numpy())
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    back = convert.to_paddle_tpu(pm)
    assert back.keys() == state.keys()
    assert all(np.array_equal(back[k], state[k]) for k in state)
    assert convert.paddle_parameter_order(pm) == [
        n for n, _ in jm.named_parameters()]


def test_lenet_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmodels.LeNet()
    net = pmodels.LeNet(device="cpu", num_classes=0)
    assert net(torch.zeros(2, 1, 28, 28)).shape == (2, 16, 5, 5)
