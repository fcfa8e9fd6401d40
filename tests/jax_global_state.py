"""Autouse fixtures that put back the JAX package's process-global
dropout and recurrence settings around the port's parity tests.

Building a JAX ``Model`` sets the global dropout mask width, remat flag
and fused-dropout flag from its config (``models/model.py:210-217``), and
some tests set ``dropout_pallas.FORCE_INTERPRET``, the fused-RNN switch
``parts/rnns/rnn._FUSED_RNN`` or the RNN kernels' ``FORCE_INTERPRET``
(``lstm_pallas``, ``gru_pallas``). Those values would leak
into later test files of the same worker (``tests/test_dropout.py``
expects the default width of 32). A test file that builds JAX models or
touches these settings imports both fixtures:

    from jax_global_state import jax_globals, jax_globals_module  # noqa

``jax_globals_module`` saves the values before the module's first fixture
(module fixtures that build JAX models included) and restores them after
its last test; ``jax_globals`` does the same around each test."""
import contextlib

import pytest

from openseq2seq_tpu.ops import dropout_pallas, gru_pallas, lstm_pallas
from openseq2seq_tpu.parts import dropout as jax_dropout
from openseq2seq_tpu.parts.rnns import rnn as jax_rnn

# (module, attribute) of every global the fixtures put back
_GLOBALS = tuple((jax_dropout, k) for k in (
    "_DROPOUT_BITS", "_DROPOUT_REMAT", "_FUSED_DROPOUT")) + (
    (jax_rnn, "_FUSED_RNN"), (dropout_pallas, "FORCE_INTERPRET"),
    (lstm_pallas, "FORCE_INTERPRET"), (gru_pallas, "FORCE_INTERPRET"))


@contextlib.contextmanager
def restored():
    saved = [getattr(m, k) for m, k in _GLOBALS]
    try:
        yield
    finally:
        for (m, k), v in zip(_GLOBALS, saved):
            setattr(m, k, v)


@pytest.fixture(scope="module", autouse=True)
def jax_globals_module():
    with restored():
        yield


@pytest.fixture(autouse=True)
def jax_globals():
    with restored():
        yield
