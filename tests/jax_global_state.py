"""Autouse fixtures that put back the JAX package's process-global
dropout settings around the port's parity tests.

Building a JAX ``Model`` sets the global dropout mask width, remat flag
and fused-dropout flag from its config (``models/model.py:210-217``), and
some tests set ``dropout_pallas.FORCE_INTERPRET``. Those values would leak
into later test files of the same worker (``tests/test_dropout.py``
expects the default width of 32). A test file that builds JAX models or
touches these settings imports both fixtures:

    from jax_global_state import jax_globals, jax_globals_module  # noqa

``jax_globals_module`` saves the values before the module's first fixture
(module fixtures that build JAX models included) and restores them after
its last test; ``jax_globals`` does the same around each test."""
import contextlib

import pytest

from openseq2seq_tpu.ops import dropout_pallas
from openseq2seq_tpu.parts import dropout as jax_dropout

_DROPOUT_KEYS = ("_DROPOUT_BITS", "_DROPOUT_REMAT", "_FUSED_DROPOUT")


@contextlib.contextmanager
def restored():
    saved = {k: getattr(jax_dropout, k) for k in _DROPOUT_KEYS}
    interpret = dropout_pallas.FORCE_INTERPRET
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(jax_dropout, k, v)
        dropout_pallas.FORCE_INTERPRET = interpret


@pytest.fixture(scope="module", autouse=True)
def jax_globals_module():
    with restored():
        yield


@pytest.fixture(autouse=True)
def jax_globals():
    with restored():
        yield
