"""RNN toolkit: composable recurrent cells + bucketing data iterator.

Counterpart of ``mxnet_tpu/rnn/`` and the reference's python/mxnet/rnn
package (rnn_cell.py:90 BaseRNNCell, :497 FusedRNNCell; io.py:61
BucketSentenceIter)."""
from .rnn_cell import (
    RNNParams,
    BaseRNNCell,
    RNNCell,
    LSTMCell,
    GRUCell,
    FusedRNNCell,
    SequentialRNNCell,
    BidirectionalCell,
    DropoutCell,
    ModifierCell,
    ZoneoutCell,
    ResidualCell,
)
from .io import BucketSentenceIter

__all__ = [
    "RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
    "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
    "ModifierCell", "ZoneoutCell", "ResidualCell", "BucketSentenceIter",
]
