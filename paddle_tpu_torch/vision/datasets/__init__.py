"""Vision datasets: the port of ``paddle_tpu/vision/datasets`` (``MNIST``,
``FashionMNIST``, ``Cifar10`` / ``Cifar100``, ``DatasetFolder``,
``ImageFolder``, ``Flowers``, ``VOC2012``).  Samples are numpy arrays, as
there.

Nothing is downloaded: with no archive on disk each dataset is the JAX
package's deterministic synthetic sample (the same seeds and draws, so
the arrays are bit-equal), with the real shapes and dtypes; pass
``image_path`` / ``label_path`` (MNIST) to read real data.
``DatasetFolder`` and ``ImageFolder`` read ``.npy`` files with numpy and
other images through PIL, imported only when such a file is read.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io.dataset import Dataset


class MNIST(Dataset):
    """MNIST (vision/datasets/mnist.py analog): 28x28 grayscale digits."""

    def __init__(self, image_path=None, label_path=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.images, self.labels = self._load(image_path, label_path, mode)

    def _load(self, image_path, label_path, mode):
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                labels = np.frombuffer(f.read(), np.uint8)
            return images.astype(np.float32) / 255.0, labels.astype(np.int64)
        # synthetic fallback: deterministic, label-correlated patterns
        n = 6000 if mode == "train" else 1000
        rng = np.random.RandomState(0 if mode == "train" else 1)
        labels = rng.randint(0, 10, n).astype(np.int64)
        images = rng.rand(n, 28, 28).astype(np.float32) * 0.1
        for i, l in enumerate(labels):
            images[i, (l * 2) : (l * 2 + 4), 4:24] += 0.8  # label-dependent bar
        return np.clip(images, 0, 1), labels

    def __getitem__(self, idx):
        img = self.images[idx][None]  # CHW
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]])

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None, download=True,
                 backend=None):
        self.transform = transform
        n = 5000 if mode == "train" else 1000
        rng = np.random.RandomState(2 if mode == "train" else 3)
        self.labels = rng.randint(0, 10, n).astype(np.int64)
        self.images = rng.rand(n, 3, 32, 32).astype(np.float32) * 0.2
        for i, l in enumerate(self.labels):
            self.images[i, l % 3, (l * 3) : (l * 3 + 2), :] += 0.7

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]])

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    pass


def _default_loader(path):
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f)
        return img.convert("RGB")


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                  ".tif", ".tiff", ".webp", ".npy")


class DatasetFolder(Dataset):
    """(``vision/datasets/folder.py`` DatasetFolder) generic
    class-per-subfolder dataset: root/class_x/xxx.ext -> (sample, label)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        import os

        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS

        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise RuntimeError(f"no class folders found under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}

        def valid(path):
            if is_valid_file is not None:
                return is_valid_file(path)
            return path.lower().endswith(tuple(extensions))

        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fn in sorted(files):
                    p = os.path.join(dirpath, fn)
                    if valid(p):
                        self.samples.append((p, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"no valid files found under {root}")

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        if path.endswith(".npy"):
            sample = np.load(path)
        else:
            sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, label

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """(``folder.py`` ImageFolder) flat/recursive image listing — samples
    only, no labels."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        import os

        self.loader = loader or _default_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS

        def valid(path):
            if is_valid_file is not None:
                return is_valid_file(path)
            return path.lower().endswith(tuple(extensions))

        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                p = os.path.join(dirpath, fn)
                if valid(p):
                    self.samples.append(p)
        if not self.samples:
            raise RuntimeError(f"no valid files found under {root}")

    def __getitem__(self, idx):
        path = self.samples[idx]
        sample = np.load(path) if path.endswith(".npy") else self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)


class Flowers(Dataset):
    """Oxford-102 Flowers (``vision/datasets/flowers.py`` analog): 102
    classes; with no archive on disk, a deterministic label-correlated
    synthetic fallback (the suite's no-download contract, like MNIST)."""

    NUM_CLASSES = 102

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        n = 1020 if mode == "train" else 102
        rng = np.random.RandomState(2 if mode == "train" else 3)
        self.labels = (np.arange(n) % self.NUM_CLASSES).astype(np.int64)
        base = rng.rand(n, 3, 32, 32).astype(np.float32) * 0.1
        # label-correlated hue so classifiers can actually learn
        base[np.arange(n), self.labels % 3] += 0.5
        self.images = base

    def __getitem__(self, idx):
        img, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.labels)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation (``vision/datasets/voc2012.py`` analog):
    (image, label-mask) pairs; synthetic fallback when the archive is
    absent — masks are blocky label-correlated regions."""

    NUM_CLASSES = 21

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        n = 200 if mode == "train" else 40
        rng = np.random.RandomState(4 if mode == "train" else 5)
        self.images = rng.rand(n, 3, 64, 64).astype(np.float32)
        self.masks = np.zeros((n, 64, 64), np.int64)
        for i in range(n):
            cls = i % (self.NUM_CLASSES - 1) + 1
            r0, c0 = rng.randint(0, 32, 2)
            self.masks[i, r0:r0 + 32, c0:c0 + 32] = cls
            self.images[i, 0, r0:r0 + 32, c0:c0 + 32] += cls / 21.0

    def __getitem__(self, idx):
        img, mask = self.images[idx], self.masks[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return len(self.images)
