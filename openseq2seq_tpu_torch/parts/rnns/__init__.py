"""Recurrent layers (port of ``openseq2seq_tpu/parts/rnns``)."""
from .rnn import LSTM, GRU, BiRNN, GLSTM, make_rnn
