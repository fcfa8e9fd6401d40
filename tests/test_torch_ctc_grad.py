"""The port's CTC gradient (ops/ctc_cuda.py on the CPU, where it runs the
plain backward ``ctc_nll_grad``) against the JAX package's: ``jax.grad``
of the Pallas kernel ``ctc_loss_pallas`` in interpret mode (its chunked
beta backward, as tests/test_ctc_pallas.py runs it), and of the XLA-scan
``ctc_loss``; and against ``torch.autograd`` through the port's plain
forward, a third oracle.

Cases: T=37 and T=130 (two of the Pallas kernel's 128-frame chunks), with
an empty label (row 1), a label of one repeated symbol (row 2) and an
infeasible row (row 3), whose gradient must be exactly 0.

Tolerance: fp32, rtol 1e-4 and atol 1e-6 on d loss / d logits (the batch
mean's gradient) against the XLA scan and torch autograd. The Pallas
backward computes ``-exp(alpha + beta - logZ)`` without dividing each
frame by its posterior mass as the port does (see ``ctc_nll_grad``); in
fp32 its frames' masses drift from 1 by up to about 2e-4 at T=130, so
against it d logits agree to atol 5e-5, and d log-probs, once each of
its frames is divided by its mass, to rtol 1e-4 and atol 1e-6. The
port's posteriors of a frame sum to 1 within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from openseq2seq_tpu.ops import ctc_pallas
from openseq2seq_tpu.ops.ctc_pallas import ctc_loss_pallas
from openseq2seq_tpu_torch.ops import ctc, ctc_cuda
from test_torch_ctc import _case
from test_torch_text_data import one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-6


def _port_grad(logits, logit_lens, labels, label_lens):
    x = torch.from_numpy(logits).requires_grad_()
    loss = ctc_cuda.ctc_loss_cuda(x, *map(torch.from_numpy, (
        logit_lens, labels, label_lens)))
    loss.backward()
    return x.grad.numpy()


def _jax_pallas_interpret(logits, logit_lens, labels, label_lens):
    return np.asarray(jax.grad(lambda x: ctc_loss_pallas(
        x, jnp.asarray(logit_lens), jnp.asarray(labels),
        jnp.asarray(label_lens), interpret=True))(jnp.asarray(logits)))


def _jax_scan(logits, logit_lens, labels, label_lens):
    return np.asarray(jax.grad(lambda x: jax_ctc_loss(
        x, jnp.asarray(logit_lens), jnp.asarray(labels),
        jnp.asarray(label_lens)))(jnp.asarray(logits)))


def _torch_autograd_plain(logits, logit_lens, labels, label_lens):
    x = torch.from_numpy(logits).requires_grad_()
    ctc.ctc_loss(x, *map(torch.from_numpy, (logit_lens, labels,
                                            label_lens))).backward()
    return x.grad.numpy()


# oracle -> (function, atol)
ORACLES = {"jax_pallas_interpret": (_jax_pallas_interpret, 5e-5),
           "jax_scan": (_jax_scan, ATOL),
           "torch_autograd_plain": (_torch_autograd_plain, ATOL)}


@pytest.mark.parametrize("T", [37, 130])
@pytest.mark.parametrize("oracle", sorted(ORACLES))
def test_ctc_grad_matches_oracle(oracle, T):
    case = _case(T)
    got = _port_grad(*case)
    fn, atol = ORACLES[oracle]
    want = fn(*case)
    assert np.all(got[3] == 0.0)                     # infeasible row
    assert np.all(np.isfinite(got)) and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("T", [37, 130])
def test_ctc_dlogprobs_match_pallas_backward(T):
    """d NLL / d log-probs of the Pallas kernels (interpret mode), each
    live frame divided by its posterior mass, against ``ctc_nll_grad``."""
    logits, logit_lens, labels, label_lens = _case(T)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    want = np.asarray(jax.grad(lambda x: jnp.sum(
        ctc_pallas._ctc_nll_from_logprobs(
            x, jnp.asarray(logit_lens), jnp.asarray(labels),
            jnp.asarray(label_lens), 28, True)))(jnp.asarray(lp)))
    nll, got = ctc.ctc_nll_grad(*map(torch.from_numpy, (
        lp, logit_lens, labels, label_lens)), 28)
    got = got.numpy()
    feasible = ctc.feasible_rows(*map(torch.from_numpy, (
        logit_lens, labels, label_lens))).numpy()
    for b in np.flatnonzero(feasible):
        n = logit_lens[b]
        frames = want[b, :n] / -want[b, :n].sum(axis=1, keepdims=True)
        np.testing.assert_allclose(got[b, :n], frames, rtol=RTOL, atol=ATOL)
        assert np.all(got[b, n:] == 0.0)
    assert np.all(got[~feasible] == 0.0)


@pytest.mark.parametrize("T", [37, 130])
def test_ctc_nll_grad_posterior_sums_to_one(T):
    logits, logit_lens, labels, label_lens = map(torch.from_numpy, _case(T))
    lp = ctc.log_probs(logits)
    nll, dlp = ctc.ctc_nll_grad(lp, logit_lens, labels, label_lens, 28)
    torch.testing.assert_close(
        nll, ctc.ctc_nll(lp, logit_lens, labels, label_lens, 28),
        rtol=0, atol=0)
    feasible = ctc.feasible_rows(logit_lens, labels, label_lens)
    sums = dlp.sum(dim=2)
    for b in range(dlp.shape[0]):
        n = int(logit_lens[b])
        if feasible[b]:
            torch.testing.assert_close(sums[b, :n], torch.full((n,), -1.0),
                                       rtol=0, atol=1e-6)
        else:
            assert torch.all(dlp[b] == 0)
        assert torch.all(dlp[b, n:] == 0)                # t >= length


def test_ctc_grad_is_zero_beyond_lengths_and_labels():
    """Frames past a row's length and vocabulary entries that are neither
    the blank nor one of the row's labels get exactly 0."""
    logits, logit_lens, labels, label_lens = map(torch.from_numpy, _case(37))
    _, dlp = ctc.ctc_nll_grad(ctc.log_probs(logits), logit_lens, labels,
                              label_lens, 28)
    for b in range(dlp.shape[0]):
        used = set(labels[b, :int(label_lens[b])].tolist()) | {28}
        unused = [v for v in range(29) if v not in used]
        assert torch.all(dlp[b][:, unused] == 0)
