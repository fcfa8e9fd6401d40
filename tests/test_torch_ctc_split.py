"""The CTC backward's plain versions, split as the CUDA backward's two
launches: ``ctc_posteriors`` (the beta recursion's per-state posteriors)
and ``ctc_scatter`` (their vocabulary scatter), and the check that the
card runs hold the kernels to (``ctc_cuda.readings``), on the CPU:

* ``ctc_nll_grad``, now their composition, gives the bits of the
  unsplit ``ctc_nll_grad`` (frozen below as ``_unsplit_nll_grad``);
* ``ctc_scatter(ctc_posteriors(...))`` against the JAX package's
  ``_beta_chunk_kernel`` in interpret mode, each live frame divided by its
  posterior mass, as ``test_torch_ctc_grad.py`` holds ``ctc_nll_grad``:
  fp32, rtol 1e-4, atol 1e-6;
* the plain versions read 0 against themselves, and every planted fault
  of ``ctc_cuda.planted_faults`` reads above 1.

Cases from ``test_torch_ctc._case`` (B 6, L 10: an empty label, a label of
one repeated symbol and an infeasible row) at T 37, and lengths on either
side of the kernels' chunk edges (B 8, T 40, L 6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.ops import ctc_pallas
from openseq2seq_tpu_torch.ops import ctc, ctc_cuda
from test_torch_ctc import _case
from test_torch_text_data import one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-6


def _unsplit_nll_grad(logprobs, logit_lengths, labels, label_lengths,
                      blank_id):
    """``ops/ctc.py:ctc_nll_grad`` as it was before the split, verbatim
    but for the lattice, taken from ``ctc_nll_lattice``."""
    B, T, V = logprobs.shape
    nll, alphas = ctc.ctc_nll_lattice(logprobs.detach(), logit_lengths,
                                      labels, label_lengths, blank_id)
    ext, can_skip, valid_s, ext_len, _ = ctc._extended(
        labels.long(), label_lengths.long(), blank_id)
    S = ext.shape[1]
    dev = logprobs.device
    emit = torch.gather(logprobs.detach(), 2,
                        ext[:, None, :].expand(B, T, S))
    lens = torch.clamp(logit_lengths.long(), max=T)
    logz = -nll
    s_idx = torch.arange(S, device=dev)
    end_mask = (s_idx[None, :] >= ext_len[:, None] - 2) & \
        (s_idx[None, :] <= ext_len[:, None] - 1)
    neg = torch.full((B, S), ctc.NEG, dtype=logprobs.dtype, device=dev)
    beta_last = torch.where(end_mask, torch.zeros_like(neg), neg)
    can_skip_fwd = torch.cat([can_skip[:, 2:], torch.zeros(
        (B, 2), dtype=torch.bool, device=dev)], dim=1)
    grads = torch.zeros((B, T, S), dtype=logprobs.dtype, device=dev)
    z = None
    for t in range(T - 1, -1, -1):
        if z is None:
            beta = neg
        else:
            shift1 = torch.cat([z[:, 1:], neg[:, :1]], dim=1)
            shift2 = torch.cat([z[:, 2:], neg[:, :2]], dim=1)
            cand = ctc._logaddexp(z, shift1)
            cand = torch.where(can_skip_fwd, ctc._logaddexp(cand, shift2),
                               cand)
            beta = torch.where(valid_s, cand, neg)
        beta = torch.where((t == lens - 1)[:, None], beta_last, beta)
        live = (t < lens)[:, None]
        beta = torch.where(live, beta, neg)
        gamma = alphas[:, t] + beta - logz[:, None]
        post = torch.exp(torch.clamp(gamma, min=-80.0))
        grads[:, t] = torch.where(valid_s & live, post, 0.0)
        z = beta + emit[:, t]
    feasible = ctc.feasible_rows(logit_lengths, labels, label_lengths)
    grads = torch.where(feasible[:, None, None], grads, 0.0)
    onehot = (ext[:, :, None] == torch.arange(V, device=dev)).to(grads.dtype)
    mass = torch.einsum("bts,bsv->btv", grads, onehot)
    total = mass.sum(dim=2, keepdim=True)
    return nll, torch.where(total > 0, -mass / total, 0.0)


def _chunk_case():
    """Lengths 40, 33, 32, 31, 17, 16, 15, 9 (the forward's chunks of 32
    frames start at frames 1, 33, the backward's at len - 1, len - 33,
    ...), row 2 a repeated symbol."""
    rng = np.random.RandomState(40)
    logit_lens = np.array([40, 33, 32, 31, 17, 16, 15, 9], dtype=np.int32)
    logits = (2.0 * rng.randn(8, 40, 29)).astype(np.float32)
    labels = rng.randint(0, 28, size=(8, 6)).astype(np.int32)
    label_lens = rng.randint(1, 5, size=8).astype(np.int32)
    labels[2, :] = labels[2, 0]
    label_lens[2] = 4
    return logits, logit_lens, labels, label_lens


CASES = {"T=37": lambda: _case(37), "chunk edges": _chunk_case}


def _torch_case(name):
    logits, lens, labels, label_lens = map(torch.from_numpy, CASES[name]())
    return ctc.log_probs(logits), lens, labels, label_lens


@pytest.mark.parametrize("name", sorted(CASES))
def test_composition_is_the_unsplit_gradient(name):
    args = _torch_case(name) + (28,)
    nll, dlp = ctc.ctc_nll_grad(*args)
    want_nll, want = _unsplit_nll_grad(*args)
    assert torch.equal(nll, want_nll) and torch.equal(dlp, want)
    assert dlp.abs().max() > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_matches_pallas_backward(name):
    """d NLL / d log-probs of the Pallas kernels (interpret mode), each
    live frame divided by its posterior mass, against the scatter of the
    posteriors."""
    logits, logit_lens, labels, label_lens = CASES[name]()
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    want = np.asarray(jax.grad(lambda x: jnp.sum(
        ctc_pallas._ctc_nll_from_logprobs(
            x, jnp.asarray(logit_lens), jnp.asarray(labels),
            jnp.asarray(label_lens), 28, True)))(jnp.asarray(lp)))
    args = tuple(map(torch.from_numpy, (lp, logit_lens, labels,
                                        label_lens))) + (28,)
    nll, lattice = ctc.ctc_nll_lattice(*args)
    post = ctc.ctc_posteriors(*args, nll, lattice)
    got = ctc.ctc_scatter(post, args[2], args[3], 28, 29).numpy()
    feasible = ctc.feasible_rows(*args[1:4]).numpy()
    for b in np.flatnonzero(feasible):
        n = logit_lens[b]
        frames = want[b, :n] / -want[b, :n].sum(axis=1, keepdims=True)
        np.testing.assert_allclose(got[b, :n], frames, rtol=RTOL, atol=ATOL)
        assert np.all(got[b, n:] == 0.0)
    assert np.all(got[~feasible] == 0.0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_readings_refuse_planted_faults(name):
    args = _torch_case(name) + (28,)
    plain = ctc_cuda.plain_results(*args)
    reads = ctc_cuda.readings(plain, plain, *args[1:4])
    assert set(reads) == {"nll", "dlp", "zeros", "sums", "post"}
    assert all(v <= 1 for v in reads.values()), reads
    faults = ctc_cuda.planted_faults(*args, plain)
    assert len(faults) == 4
    for fault, got in faults.items():
        worst = max(ctc_cuda.readings(got, plain, *args[1:4]).values())
        assert worst > 1, fault
