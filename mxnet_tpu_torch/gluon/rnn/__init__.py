"""``gluon.rnn``: recurrent cells, convolutional cells and the fused
``RNN`` / ``LSTM`` / ``GRU`` layers.

Counterpart of ``mxnet_tpu/gluon/rnn/__init__.py``, with the 1.x names
``HybridRecurrentCell`` and ``HybridSequentialRNNCell`` for the cells
(every cell is a ``HybridBlock`` here, as there).
"""
from .conv_rnn_cell import (  # noqa: F401
    Conv1DGRUCell, Conv1DLSTMCell, Conv1DRNNCell, Conv2DGRUCell,
    Conv2DLSTMCell, Conv2DRNNCell, Conv3DGRUCell, Conv3DLSTMCell,
    Conv3DRNNCell)
from .rnn_cell import (  # noqa: F401
    BidirectionalCell, DropoutCell, GRUCell, LSTMCell, LSTMPCell,
    ModifierCell, RecurrentCell, ResidualCell, RNNCell, SequentialRNNCell,
    VariationalDropoutCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN  # noqa: F401

HybridRecurrentCell = RecurrentCell
HybridSequentialRNNCell = SequentialRNNCell
