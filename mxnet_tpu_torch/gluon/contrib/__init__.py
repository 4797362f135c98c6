"""gluon.contrib (reference: python/mxnet/gluon/contrib/): the estimator."""
from . import estimator  # noqa: F401
