"""Recurrent cells over the Symbol layer.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (the reference's
python/mxnet/rnn/rnn_cell.py), class for class. The unfused cells
(RNNCell/LSTMCell/GRUCell) build one timestep of symbol graph and ``unroll``
composes seq_len of them — the reference's unrolled-in-time strategy
(rnn_cell.py:90-316). ``FusedRNNCell`` instead lowers the whole sequence to
the registry's ``RNN`` op (``ops/rnn.py``), as the reference's FusedRNNCell
lowered to the cuDNN RNN op (rnn_cell.py:497), and ``unfuse()`` converts
back. Gate orders match the fused op's packed layout (LSTM i,f,g,o; GRU
r,z,n), so ``unpack_weights`` / ``pack_weights`` round-trip between the two
layouts. ``unpack_weights``/``pack_weights`` make their arrays on the
context of the blob (or of the first weight) they were given.
"""
from __future__ import annotations

import numpy as np

from .. import symbol as sym
from ..base import MXNetError
from ..ops.rnn import rnn_param_size

__all__ = [
    "RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
    "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
    "ModifierCell", "ZoneoutCell", "ResidualCell",
]


class RNNParams:
    """Container for cell parameter variables (reference: rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract cell (reference: rnn_cell.py:90)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_shape(self):
        """Per-state shapes with 0 for the batch axis."""
        raise NotImplementedError

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=None, batch_size=0, **kwargs):
        """Initial state symbols. With ``batch_size`` > 0 these are concrete
        zeros; otherwise they are input Variables (the bucketing iterators
        feed them as data, example/rnn/lstm_bucketing.py init_states).

        Contract note (deliberate deviation from the reference): the zeros
        are shaped with batch extent **1**, not ``batch_size``, so one symbol
        serves any global batch — per-device slicing and sharded SPMD traces
        both split the batch after graph construction, and a baked batch
        extent would pin the graph to one world size. The cells consume
        states only through broadcasting ops, so the math is unchanged. If
        you need full-batch initial states in a non-broadcasting op (concat
        with the batch axis, etc.), pass ``batch_size=0`` and feed the state
        Variables as data instead."""
        assert not self._modified, "After applying modifier cells the base cell cannot be called directly."
        states = []
        for shape in self.state_shape:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if func is not None:
                states.append(func(name=name, **kwargs))
            elif batch_size:
                # batch axis 1, not batch_size: the zeros only enter the cell
                # through broadcasting elementwise ops, and a baked batch
                # extent would pin the symbol to one global batch — breaking
                # per-device slicing and sharded SPMD traces alike
                full = (1,) + tuple(shape[1:])
                states.append(sym._zeros(shape=full, name=name))
            else:
                states.append(sym.Variable(name))
        return states

    # ---------------------------------------------------- weight conversion
    def unpack_weights(self, args):
        """Split fused parameter blobs into per-gate weights (reference:
        rnn_cell.py unpack_weights). Base cells store weights unfused: no-op."""
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    # --------------------------------------------------------------- unroll
    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=False):
        """Unroll the cell ``length`` timesteps (reference: rnn_cell.py:90
        BaseRNNCell.unroll)."""
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            inputs = [sym.Variable("%st%d_data" % (input_prefix, i)) for i in range(length)]
        elif isinstance(inputs, sym.Symbol):
            if len(inputs) != 1:
                raise MXNetError("unroll expects a single-output Symbol or a list")
            inputs = list(sym.SliceChannel(inputs, axis=axis, num_outputs=length, squeeze_axis=1))
        else:
            inputs = list(inputs)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [sym.expand_dims(o, axis=axis) for o in outputs]
            outputs = sym.Concat(*outputs, dim=axis, num_args=length)
        return outputs, states


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell, tanh or relu (reference: rnn_cell.py:317 RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden, name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW, bias=self._hB,
                                 num_hidden=self._num_hidden, name="%sh2h" % name)
        if self._activation == "relu":
            output = sym.Activation(i2h + h2h, act_type="relu", name="%sout" % name)
        else:
            output = sym.Activation(i2h + h2h, act_type="tanh", name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference: rnn_cell.py:365 LSTMCell). Gate order i,f,g,o —
    identical to the fused RNN op's packed layout."""

    def __init__(self, num_hidden, prefix="lstm_", params=None, forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        from ..initializer import LSTMBias

        self._iB = self.params.get("i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden), (0, self._num_hidden)]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden * 4, name="%si2h" % name)
        h2h = sym.FullyConnected(data=states[0], weight=self._hW, bias=self._hB,
                                 num_hidden=self._num_hidden * 4, name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = sym.SliceChannel(gates, num_outputs=4, name="%sslice" % name)
        in_gate = sym.Activation(slice_gates[0], act_type="sigmoid", name="%si" % name)
        forget_gate = sym.Activation(slice_gates[1], act_type="sigmoid", name="%sf" % name)
        in_transform = sym.Activation(slice_gates[2], act_type="tanh", name="%sc" % name)
        out_gate = sym.Activation(slice_gates[3], act_type="sigmoid", name="%so" % name)
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * sym.Activation(next_c, act_type="tanh", name="%sstate" % name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference: rnn_cell.py:430 GRUCell). Gate order r,z,n with
    separate i2h/h2h biases — the fused (cuDNN-convention) layout."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_shape(self):
        return [(0, self._num_hidden)]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = sym.FullyConnected(data=inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden * 3, name="%si2h" % name)
        h2h = sym.FullyConnected(data=prev_h, weight=self._hW, bias=self._hB,
                                 num_hidden=self._num_hidden * 3, name="%sh2h" % name)
        i2h_r, i2h_z, i2h_n = list(sym.SliceChannel(i2h, num_outputs=3, name="%si2h_slice" % name))
        h2h_r, h2h_z, h2h_n = list(sym.SliceChannel(h2h, num_outputs=3, name="%sh2h_slice" % name))
        reset_gate = sym.Activation(i2h_r + h2h_r, act_type="sigmoid", name="%sr" % name)
        update_gate = sym.Activation(i2h_z + h2h_z, act_type="sigmoid", name="%sz" % name)
        next_h_tmp = sym.Activation(i2h_n + reset_gate * h2h_n, act_type="tanh", name="%sh" % name)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence fused cell over the registry's RNN op
    (reference: rnn_cell.py:497 FusedRNNCell → cuDNN RNN)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm", bidirectional=False,
                 dropout=0.0, get_next_state=False, forget_bias=1.0,
                 prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._forget_bias = forget_bias
        self._parameter = self.params.get("parameters")
        self._directions = ["l", "r"] if bidirectional else ["l"]

    @property
    def state_shape(self):
        d = 2 if self._bidirectional else 1
        n = self._num_layers * d
        shapes = [(n, 0, self._num_hidden)]
        if self._mode == "lstm":
            shapes.append((n, 0, self._num_hidden))
        return shapes

    @property
    def _gate_names(self):
        return {"rnn_relu": ("",), "rnn_tanh": ("",),
                "lstm": ("_i", "_f", "_c", "_o"), "gru": ("_r", "_z", "_o")}[self._mode]

    def _num_gates(self):
        return len(self._gate_names)

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped — use unroll, or unfuse()")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=True):
        self.reset()
        axis = layout.find("T")
        if inputs is None:
            raise MXNetError("FusedRNNCell.unroll requires inputs")
        if isinstance(inputs, (list, tuple)):
            inputs = sym.Concat(*[sym.expand_dims(i, axis=axis) for i in inputs],
                                dim=axis, num_args=length)
        if layout == "NTC":
            inputs = sym.SwapAxis(inputs, dim1=0, dim2=1, name="%sttmajor" % self._prefix)
        elif layout != "TNC":
            raise MXNetError("unknown layout %r" % layout)
        if begin_state is None:
            begin_state = self.begin_state()
        states = list(begin_state)
        kw = {"state": states[0]}
        if self._mode == "lstm":
            kw["state_cell"] = states[1]
        rnn = sym.RNN(data=inputs, parameters=self._parameter,
                      mode=self._mode, state_size=self._num_hidden,
                      num_layers=self._num_layers,
                      bidirectional=self._bidirectional, p=self._dropout,
                      state_outputs=self._get_next_state,
                      name="%srnn" % self._prefix, **kw)
        if self._get_next_state:
            outputs = rnn[0]
            states = [rnn[1], rnn[2]] if self._mode == "lstm" else [rnn[1]]
        else:
            outputs, states = rnn, []
        if layout == "NTC":
            outputs = sym.SwapAxis(outputs, dim1=0, dim2=1, name="%sntmajor" % self._prefix)
        if not merge_outputs:
            outputs = list(sym.SliceChannel(outputs, axis=axis, num_outputs=length,
                                            squeeze_axis=1))
        return outputs, states

    # ---------------------------------------------------- weight conversion
    def _slice_layout(self, input_size):
        """Yield (name, slice, shape) over the flat parameter blob —
        exactly the fused op's layout (ops/rnn.py:_unpack_params)."""
        g = self._num_gates()
        H = self._num_hidden
        d = len(self._directions)
        off = 0
        for layer in range(self._num_layers):
            in_sz = input_size if layer == 0 else H * d
            for di, dname in enumerate(self._directions):
                pre = "%s%s%d_" % (self._prefix, dname, layer)
                yield pre + "i2h_weight", slice(off, off + g * H * in_sz), (g * H, in_sz)
                off += g * H * in_sz
                yield pre + "h2h_weight", slice(off, off + g * H * H), (g * H, H)
                off += g * H * H
        for layer in range(self._num_layers):
            for dname in self._directions:
                pre = "%s%s%d_" % (self._prefix, dname, layer)
                yield pre + "i2h_bias", slice(off, off + g * H), (g * H,)
                off += g * H
                yield pre + "h2h_bias", slice(off, off + g * H), (g * H,)
                off += g * H

    def unpack_weights(self, args):
        """Fused blob → per-layer i2h/h2h arrays (reference:
        rnn_cell.py FusedRNNCell.unpack_weights)."""
        args = dict(args)
        blob = args.pop(self._prefix + "parameters")
        flat = blob.asnumpy() if hasattr(blob, "asnumpy") else np.asarray(blob)
        input_size = self._infer_input_size(flat)
        from ..ndarray import array

        ctx = getattr(blob, "context", None)
        for name, sl, shape in self._slice_layout(input_size):
            args[name] = array(flat[sl].reshape(shape), ctx=ctx)
        return args

    def pack_weights(self, args):
        args = dict(args)
        input_size = None
        g, H, d = self._num_gates(), self._num_hidden, len(self._directions)
        w0 = args["%s%s0_i2h_weight" % (self._prefix, self._directions[0])]
        input_size = (w0.shape if hasattr(w0, "shape") else np.shape(w0))[1]
        total = rnn_param_size(self._num_layers, input_size, H,
                               self._bidirectional, self._mode)
        flat = np.zeros((total,), dtype="float32")
        for name, sl, shape in self._slice_layout(input_size):
            v = args.pop(name)
            v = v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
            flat[sl] = v.reshape(-1)
        from ..ndarray import array

        args[self._prefix + "parameters"] = array(flat, ctx=getattr(w0, "context", None))
        return args

    def _infer_input_size(self, flat):
        g, H, d = self._num_gates(), self._num_hidden, len(self._directions)
        L = self._num_layers
        total = len(flat)
        # solve rnn_param_size for input_size
        rest = total - L * d * 2 * g * H  # biases
        for layer in range(1, L):
            rest -= d * g * H * (H * d + H)
        # rest = d*g*H*(input+H)
        return rest // (d * g * H) - H

    def unfuse(self):
        """Equivalent stack of unfused cells (reference: rnn_cell.py unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden, activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden, activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p, forget_bias=0.0),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout, prefix="%s_dropout%d_" % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells applied layer by layer (reference: rnn_cell.py
    SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_shape(self):
        return [s for c in self._cells for s in c.state_shape]

    def begin_state(self, **kwargs):
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unpack_weights(self, args):
        for c in self._cells:
            args = c.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for c in self._cells:
            args = c.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        next_states = []
        pos = 0
        for cell in self._cells:
            n = len(cell.state_shape)
            cell_states = states[pos : pos + n]
            pos += n
            inputs, cell_states = cell(inputs, cell_states)
            next_states.extend(cell_states)
        return inputs, next_states

    def reset(self):
        super().reset()
        for c in getattr(self, "_cells", []):
            c.reset()


class BidirectionalCell(BaseRNNCell):
    """Forward + backward cells over the sequence (reference: rnn_cell.py
    BidirectionalCell). Only supports unroll."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._l_cell = l_cell
        self._r_cell = r_cell
        self._output_prefix = output_prefix

    @property
    def state_shape(self):
        return self._l_cell.state_shape + self._r_cell.state_shape

    def begin_state(self, **kwargs):
        return self._l_cell.begin_state(**kwargs) + self._r_cell.begin_state(**kwargs)

    def unpack_weights(self, args):
        return self._r_cell.unpack_weights(self._l_cell.unpack_weights(args))

    def pack_weights(self, args):
        return self._r_cell.pack_weights(self._l_cell.pack_weights(args))

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped — use unroll")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=False):
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, sym.Symbol):
            inputs = list(sym.SliceChannel(inputs, axis=axis, num_outputs=length,
                                           squeeze_axis=1))
        if begin_state is None:
            begin_state = self.begin_state()
        n_l = len(self._l_cell.state_shape)
        l_outputs, l_states = self._l_cell.unroll(
            length, inputs=inputs, begin_state=begin_state[:n_l], layout=layout,
            merge_outputs=False)
        r_outputs, r_states = self._r_cell.unroll(
            length, inputs=list(reversed(inputs)), begin_state=begin_state[n_l:],
            layout=layout, merge_outputs=False)
        outputs = [
            sym.Concat(l, r, dim=1, num_args=2,
                       name="%st%d" % (self._output_prefix, i))
            for i, (l, r) in enumerate(zip(l_outputs, reversed(r_outputs)))
        ]
        if merge_outputs:
            outputs = [sym.expand_dims(o, axis=axis) for o in outputs]
            outputs = sym.Concat(*outputs, dim=axis, num_args=length)
        return outputs, l_states + r_states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference: rnn_cell.py
    ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_shape(self):
        return self.base_cell.state_shape

    def begin_state(self, func=None, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class DropoutCell(BaseRNNCell):
    """Applies dropout to the input (reference: rnn_cell.py DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._dropout = dropout

    @property
    def state_shape(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = sym.Dropout(data=inputs, p=self._dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference: rnn_cell.py ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None
        if hasattr(self, "base_cell"):
            self.base_cell.reset()

    def __call__(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        mask = lambda p, like: sym.Dropout(data=sym.ones_like(like), p=p) if hasattr(sym, "ones_like") else None
        prev_output = self.prev_output if self.prev_output is not None else next_output * 0.0
        if self.zoneout_outputs > 0:
            m = sym.Dropout(data=next_output - next_output + 1.0, p=self.zoneout_outputs)
            output = sym.where(m, next_output, prev_output) if hasattr(sym, "where") else \
                m * 0.0 + next_output  # fallback: plain output
        else:
            output = next_output
        if self.zoneout_states > 0:
            zs = []
            for new_s, old_s in zip(next_states, states):
                m = sym.Dropout(data=new_s - new_s + 1.0, p=self.zoneout_states)
                zs.append(sym.where(m, new_s, old_s) if hasattr(sym, "where") else new_s)
            next_states = zs
        self.prev_output = output
        return output, next_states


class ResidualCell(ModifierCell):
    """Adds the input to the output (residual connection)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=False):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state,
            input_prefix=input_prefix, layout=layout, merge_outputs=False)
        self.base_cell._modified = True
        if isinstance(inputs, sym.Symbol):
            axis = layout.find("T")
            inputs = list(sym.SliceChannel(inputs, axis=axis, num_outputs=length,
                                           squeeze_axis=1))
        outputs = [o + i for o, i in zip(outputs, inputs)]
        if merge_outputs:
            axis = layout.find("T")
            outputs = [sym.expand_dims(o, axis=axis) for o in outputs]
            outputs = sym.Concat(*outputs, dim=axis, num_args=length)
        return outputs, states
