"""gluon.contrib (reference: python/mxnet/gluon/contrib/): the estimator
and ``contrib.nn``."""
from . import estimator, nn  # noqa: F401
