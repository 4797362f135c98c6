"""gluon.contrib.estimator — keras-like fit loop.

Counterpart of ``mxnet_tpu/gluon/contrib/estimator/`` (reference parity:
python/mxnet/gluon/contrib/estimator/, the Estimator with its event
handlers; CheckpointHandler at event_handler.py:336, EarlyStopping :614,
ValidationHandler :160), with the JAX package's ``ResilienceHandler`` and
``TelemetryHandler``.
"""
from .batch_processor import BatchProcessor  # noqa: F401
from .estimator import Estimator  # noqa: F401
from .event_handler import (  # noqa: F401
    EventHandler, TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
    BatchEnd, StoppingHandler, MetricHandler, ValidationHandler,
    LoggingHandler, CheckpointHandler, EarlyStoppingHandler,
    GradientUpdateHandler, TelemetryHandler, ResilienceHandler,
)
