"""LSTM language model built by explicit unrolling (reference
``example/rnn/lstm.py:17-107``): per-timestep FullyConnected i2h/h2h with
shared weight Variables, gates split with SliceChannel, per-step softmax
heads grouped into one Symbol.

Counterpart of ``mxnet_tpu/models/lstm.py``: the same graph, node names
and arguments.
"""
from collections import namedtuple

from .. import symbol as sym

LSTMState = namedtuple("LSTMState", ["c", "h"])
LSTMParam = namedtuple("LSTMParam", ["i2h_weight", "i2h_bias",
                                     "h2h_weight", "h2h_bias"])


def lstm_cell(num_hidden, indata, prev_state, param, seqidx, layeridx,
              dropout=0.0):
    """One LSTM step (lstm.py:17-40): gates = i2h(x) + h2h(h); split 4-way
    → in/transform/forget/out."""
    if dropout > 0.0:
        indata = sym.Dropout(indata, p=dropout)
    i2h = sym.FullyConnected(indata, weight=param.i2h_weight,
                             bias=param.i2h_bias, num_hidden=num_hidden * 4,
                             name="t%d_l%d_i2h" % (seqidx, layeridx))
    h2h = sym.FullyConnected(prev_state.h, weight=param.h2h_weight,
                             bias=param.h2h_bias, num_hidden=num_hidden * 4,
                             name="t%d_l%d_h2h" % (seqidx, layeridx))
    gates = i2h + h2h
    sliced = sym.SliceChannel(gates, num_outputs=4,
                              name="t%d_l%d_slice" % (seqidx, layeridx))
    in_gate = sym.Activation(sliced[0], act_type="sigmoid")
    in_transform = sym.Activation(sliced[1], act_type="tanh")
    forget_gate = sym.Activation(sliced[2], act_type="sigmoid")
    out_gate = sym.Activation(sliced[3], act_type="sigmoid")
    next_c = (forget_gate * prev_state.c) + (in_gate * in_transform)
    next_h = out_gate * sym.Activation(next_c, act_type="tanh")
    return LSTMState(c=next_c, h=next_h)


def lstm_unroll(num_lstm_layer, seq_len, input_size, num_hidden, num_embed,
                num_label, dropout=0.0):
    """Unrolled LSTM LM (lstm.py:44-107). Inputs: ``data`` (batch, seq_len)
    int tokens, per-layer ``l%d_init_c/h``, label ``t%d_label`` per step.
    Returns a Group of per-step softmax heads."""
    embed_weight = sym.Variable("embed_weight")
    cls_weight = sym.Variable("cls_weight")
    cls_bias = sym.Variable("cls_bias")
    param_cells = []
    last_states = []
    for i in range(num_lstm_layer):
        param_cells.append(LSTMParam(
            i2h_weight=sym.Variable("l%d_i2h_weight" % i),
            i2h_bias=sym.Variable("l%d_i2h_bias" % i),
            h2h_weight=sym.Variable("l%d_h2h_weight" % i),
            h2h_bias=sym.Variable("l%d_h2h_bias" % i)))
        last_states.append(LSTMState(c=sym.Variable("l%d_init_c" % i),
                                     h=sym.Variable("l%d_init_h" % i)))

    data = sym.Variable("data")
    embed = sym.Embedding(data, weight=embed_weight, input_dim=input_size,
                          output_dim=num_embed, name="embed")
    wordvec = sym.SliceChannel(embed, num_outputs=seq_len, axis=1,
                               squeeze_axis=True, name="wordvec")

    outputs = []
    for t in range(seq_len):
        hidden = wordvec[t]
        for l in range(num_lstm_layer):
            dp = 0.0 if l == 0 else dropout
            state = lstm_cell(num_hidden, hidden, last_states[l],
                              param_cells[l], t, l, dropout=dp)
            hidden = state.h
            last_states[l] = state
        if dropout > 0.0:
            hidden = sym.Dropout(hidden, p=dropout)
        fc = sym.FullyConnected(hidden, weight=cls_weight, bias=cls_bias,
                                num_hidden=num_label,
                                name="t%d_cls" % t)
        label = sym.Variable("t%d_label" % t)
        outputs.append(sym.SoftmaxOutput(fc, label,
                                         name="t%d_sm" % t))
    return sym.Group(outputs)
