"""LSTM language model over the fused RNN op.

Counterpart of ``mxnet_tpu/models/lstm.py`` and the reference's
example/rnn/lstm_bucketing.py network: embed → multi-layer LSTM → per-timestep
FC → softmax. Where the reference unrolls LSTMCell timesteps into seq_len
graph nodes (rnn_cell.py:90 unroll) or uses the cuDNN ``RNN`` op, this model
runs the registry's fused ``RNN`` op (``ops/rnn.py``): one input projection
a layer, then a loop over time.

Layout: data is (batch, seq_len) int tokens; RNN runs time-major (T, N, I).
"""
from .. import symbol as sym
from ..ops.rnn import rnn_param_size


def get_symbol(num_classes=10000, num_embed=256, num_hidden=512, num_layers=2,
               seq_len=32, batch_size=32, dropout=0.0, **kwargs):
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data=data, input_dim=num_classes, output_dim=num_embed,
                          name="embed")
    tm = sym.SwapAxis(data=embed, dim1=0, dim2=1, name="time_major")  # (T,N,E)
    from ..initializer import Uniform

    params = sym.Variable(
        "lstm_parameters",
        shape=(rnn_param_size(num_layers, num_embed, num_hidden, False, "lstm"),),
        # the fused blob has no weight/bias suffix for the initializer's
        # dispatch; pin the classic LSTM uniform init on the variable
        # (reference pattern: Variable(init=mx.init.FusedRNN(...)))
        init=Uniform(0.1))
    # initial states carry the batch dimension explicitly, like the reference's
    # lstm_bucketing init_states entries in provide_data (example/rnn/lstm.py)
    init_h = sym.Variable("lstm_init_h", shape=(num_layers, batch_size, num_hidden))
    init_c = sym.Variable("lstm_init_c", shape=(num_layers, batch_size, num_hidden))
    out = sym.RNN(data=tm, parameters=params, state=init_h, state_cell=init_c,
                  mode="lstm", state_size=num_hidden, num_layers=num_layers,
                  p=dropout, state_outputs=False, name="lstm")
    out = sym.Reshape(data=out, shape=(-1, num_hidden), name="reshape_out")
    pred = sym.FullyConnected(data=out, num_hidden=num_classes, name="pred")
    label_flat = sym.Reshape(data=sym.SwapAxis(data=label, dim1=0, dim2=1), shape=(-1,),
                             name="label_flat")
    return sym.SoftmaxOutput(data=pred, label=label_flat, name="softmax")
