"""gluon.data (reference: python/mxnet/gluon/data/__init__.py)."""
from .dataset import (  # noqa: F401
    Dataset, SimpleDataset, ArrayDataset, RecordFileDataset,
)
from .sampler import (  # noqa: F401
    Sampler, SequentialSampler, RandomSampler, BatchSampler, FilterSampler,
    IntervalSampler,
)
from .dataloader import DataLoader, default_batchify_fn  # noqa: F401
from . import vision  # noqa: F401
