"""Vision datasets.

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py`` (reference
parity: python/mxnet/gluon/data/vision/datasets.py, MNIST, FashionMNIST,
CIFAR10/100, ImageRecordDataset, ImageFolderDataset, ImageListDataset).

Nothing is downloaded: datasets load from local files when present (the
reference's binary formats) and otherwise fall back to the reference's
deterministic synthetic sample (the same numpy seeds, so the same images
and labels as the JAX package) with the right shapes and dtypes. The
image arrays are host ``mx.np`` arrays: a sample is fetched on the host
and moves to the card with its batch.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as onp

from ....base import MXNetError
from ....numpy.multiarray import array as _array
from ..dataset import Dataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)


def _synthetic_images(n, shape, num_classes, seed):
    """Deterministic class-separable synthetic data: class k images have a
    distinct mean pattern, so small models actually converge on it."""
    rng = onp.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(onp.int32)
    protos = rng.rand(num_classes, *shape).astype(onp.float32)
    imgs = protos[labels] * 160 + rng.rand(n, *shape).astype(onp.float32) * 95
    return imgs.astype(onp.uint8), labels


class MNIST(_DownloadedDataset):
    """Reference: datasets.py MNIST (idx-ubyte files)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._namepair = (
            ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")
            if train else
            ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"))
        super().__init__(root, train, transform)

    def _get_data(self):
        img_path = os.path.join(self._root, self._namepair[0])
        lbl_path = os.path.join(self._root, self._namepair[1])
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            with gzip.open(lbl_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = onp.frombuffer(f.read(), dtype=onp.uint8) \
                    .astype(onp.int32)
            with gzip.open(img_path, "rb") as f:
                _, _, rows, cols = struct.unpack(">IIII", f.read(16))
                data = onp.frombuffer(f.read(), dtype=onp.uint8) \
                    .reshape(len(label), rows, cols, 1)
        else:
            n = 8192 if self._train else 1024
            data, label = _synthetic_images(n, (28, 28, 1), 10,
                                            seed=42 if self._train else 43)
        self._data = _array(data, dtype="uint8", device="cpu")
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """Reference: datasets.py CIFAR10 (binary batches)."""

    _num_classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                 if self._train else ["test_batch.bin"])
        paths = [os.path.join(self._root, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            data, label = [], []
            for p in paths:
                raw = onp.fromfile(p, dtype=onp.uint8).reshape(-1, 3073)
                label.append(raw[:, 0].astype(onp.int32))
                data.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                            .transpose(0, 2, 3, 1))
            data = onp.concatenate(data)
            label = onp.concatenate(label)
        else:
            n = 8192 if self._train else 1024
            data, label = _synthetic_images(n, (32, 32, 3),
                                            self._num_classes,
                                            seed=44 if self._train else 45)
        self._data = _array(data, dtype="uint8", device="cpu")
        self._label = label


class CIFAR100(CIFAR10):
    _num_classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"), fine_label=False,
                 train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)


class ImageRecordDataset(Dataset):
    """Reference: datasets.py ImageRecordDataset over RecordIO image packs."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....image import imdecode
        from ....recordio import unpack
        record = self._record[idx]
        header, img_bytes = unpack(record)
        img = imdecode(img_bytes, flag=self._flag)
        label = _array(header.label)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._record)


class ImageFolderDataset(Dataset):
    """Reference: datasets.py ImageFolderDataset (folder-per-class)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if fname.lower().endswith((".jpg", ".jpeg", ".png", ".npy")):
                    self.items.append((os.path.join(path, fname), label))

    def __getitem__(self, idx):
        from ....image import imread
        path, label = self.items[idx]
        img = imread(path, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageListDataset(Dataset):
    """Images named by a .lst file or an in-memory list.

    Reference: datasets.py:365 ImageListDataset — entries are either
    tab-separated ``index\\tlabel...\\trelpath`` lines (the im2rec .lst
    format, tools/im2rec.py) or ``[label, relpath]`` pairs; multi-value
    labels come back as float arrays, scalar labels as python floats.
    """

    def __init__(self, root=".", imglist=None, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.items = []  # (relpath, label) in list order
        if isinstance(imglist, str):
            with open(os.path.join(self._root, imglist), "rt") as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 3:
                        raise MXNetError(
                            f"malformed .lst line (need idx\\tlabel\\t"
                            f"path): {line!r}")
                    label = [float(v) for v in parts[1:-1]]
                    self.items.append((parts[-1], label))
        else:
            for entry in imglist or []:
                label, path = entry[:-1], entry[-1]
                if len(label) == 1 and isinstance(label[0], (list, tuple)):
                    label = label[0]  # [[l0, l1], path] nested form
                self.items.append((path, [float(v) for v in label]))

    def __getitem__(self, idx):
        from ....image import imread
        relpath, label = self.items[idx]
        img = imread(os.path.join(self._root, relpath), self._flag)
        lab = label[0] if len(label) == 1 else onp.array(label, "float32")
        if self._transform is not None:
            return self._transform(img, lab)
        return img, lab

    def __len__(self):
        return len(self.items)
