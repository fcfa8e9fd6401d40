"""The port's CTC (ops/ctc.py, and ops/ctc_cuda.py on the CPU, where it
runs its plain version) against the JAX package's: the XLA-scan
``ctc_loss``, the Pallas kernel ``ctc_loss_pallas`` in interpret mode,
and ``torch.nn.functional.ctc_loss`` as a third, independent oracle.

Tolerance: fp32 on both sides, rtol 1e-5 and atol 1e-5 on the per-row
negative log likelihood; the greedy decode must match exactly."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from openseq2seq_tpu.ops.ctc import ctc_greedy_decode as jax_greedy_decode
from openseq2seq_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from openseq2seq_tpu.ops.ctc_pallas import ctc_loss_pallas
from openseq2seq_tpu_torch.ops import ctc, ctc_cuda
from test_torch_text_data import one_thread  # noqa: F401

RTOL = ATOL = 1e-5


def _case(T, B=6, L=10, V=29, seed=0):
    """Variable lengths plus the edge rows: an empty label (row 1),
    labels that are all one repeated symbol (row 2) and an infeasible
    row (row 3)."""
    rng = np.random.RandomState(seed + T)
    logits = (2.0 * rng.randn(B, T, V)).astype(np.float32)
    logit_lens = rng.randint(T // 2 + 1, T + 1, size=B).astype(np.int32)
    logit_lens[0] = T
    labels = rng.randint(0, V - 1, size=(B, L)).astype(np.int32)
    label_lens = rng.randint(1, L + 1, size=B).astype(np.int32)
    label_lens[1] = 0
    labels[2, :] = labels[2, 0]
    label_lens[2] = 5
    logit_lens[3], label_lens[3] = 3, L
    return logits, logit_lens, labels, label_lens


def _port_nll(logits, logit_lens, labels, label_lens):
    return ctc_cuda.ctc_loss_cuda(
        torch.from_numpy(logits), torch.from_numpy(logit_lens),
        torch.from_numpy(labels), torch.from_numpy(label_lens),
        average_across_batch=False).numpy()


def _jax_scan(logits, logit_lens, labels, label_lens):
    return np.asarray(jax_ctc_loss(
        jnp.asarray(logits), jnp.asarray(logit_lens), jnp.asarray(labels),
        jnp.asarray(label_lens), average_across_batch=False))


def _jax_pallas_interpret(logits, logit_lens, labels, label_lens):
    return np.asarray(ctc_loss_pallas(
        jnp.asarray(logits), jnp.asarray(logit_lens), jnp.asarray(labels),
        jnp.asarray(label_lens), average_across_batch=False,
        interpret=True))


def _torch_builtin(logits, logit_lens, labels, label_lens):
    lp = F.log_softmax(torch.from_numpy(logits), dim=-1).transpose(0, 1)
    return F.ctc_loss(lp, torch.from_numpy(labels).long(),
                      torch.from_numpy(logit_lens).long(),
                      torch.from_numpy(label_lens).long(),
                      blank=logits.shape[2] - 1, reduction="none",
                      zero_infinity=True).numpy()


ORACLES = {"jax_scan": _jax_scan,
           "jax_pallas_interpret": _jax_pallas_interpret,
           "torch_builtin": _torch_builtin}


# T=130 spans two of the Pallas kernel's 128-frame chunks
@pytest.mark.parametrize("T", [37, 130])
@pytest.mark.parametrize("oracle", sorted(ORACLES))
def test_ctc_nll_matches_oracle(oracle, T):
    case = _case(T)
    got = _port_nll(*case)
    want = ORACLES[oracle](*case)
    assert got[3] == 0.0 and want[3] == 0.0         # infeasible row
    assert np.all(got[[0, 1, 2, 4, 5]] > 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ctc_loss_batch_mean_matches_jax():
    case = _case(37, seed=1)
    got = ctc.ctc_loss(*map(torch.from_numpy, case)).item()
    want = float(jax_ctc_loss(*map(jnp.asarray, case)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("V", [5, 29])
def test_greedy_decode_matches_jax(V):
    # V=5 makes repeated argmaxes common, so merging is exercised
    rng = np.random.RandomState(V)
    B, T = 5, 41
    logits = rng.randn(B, T, V).astype(np.float32)
    lengths = rng.randint(1, T + 1, size=B).astype(np.int32)
    ids, lens = ctc.ctc_greedy_decode(torch.from_numpy(logits),
                                      torch.from_numpy(lengths))
    jids, jlens = jax_greedy_decode(jnp.asarray(logits), jnp.asarray(lengths))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))

