"""gluon.data.vision (reference: python/mxnet/gluon/data/vision/)."""
from . import transforms  # noqa: F401
from .datasets import (  # noqa: F401
    MNIST, FashionMNIST, CIFAR10, CIFAR100, ImageRecordDataset,
    ImageFolderDataset, ImageListDataset,
)
