"""The port's flash attention (kernel B7's plain version and the routing
around it) against the JAX package's attention on the CPU.

Off the TPU the JAX package attends through ``_attend`` (see
test_flash_attention.py), so ``flash_attention_plain`` and the port's
``_attend_flash`` (the bias rule of the JAX package's ``_attend_flash``)
are held against ``_attend`` with the same additive -1e9 masks: key
padding, causal, Tq != Tk, head dims 64 and 128, and a row with no valid
key. Tolerance: fp32, rtol 1e-5 and atol 1e-6. On a CPU tensor the op
runs the plain version and launches nothing; tests/test_torch_cuda.py
holds the kernel against the plain version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.parts.transformer.attention import _attend as jax_attend
from openseq2seq_tpu_torch.ops import flash_attention as fa
from openseq2seq_tpu_torch.parts.transformer import attention

NEG_INF = -1e9


def _inputs(B, Tq, Tk, H, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32)
               for T in (Tq, Tk, Tk))
    lengths = rng.randint(1, Tk + 1, size=B)
    lengths[0] = Tk
    valid = np.arange(Tk)[None, :] < lengths[:, None]
    return q, k, v, valid


def _jax(q, k, v, bias):
    out = jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     None if bias is None else jnp.asarray(bias), 0.0,
                     False, jnp.float32, lambda w: w)
    return np.asarray(out)


def _padding_bias(valid):
    return np.where(valid, 0.0, NEG_INF).astype(np.float32)[:, None,
                                                              None, :]


def _causal_bias(T):
    return (np.triu(np.ones((T, T), np.float32), 1) *
            NEG_INF)[None, None]


CASES = [  # B, Tq, Tk, H, D, causal
    (3, 7, 11, 2, 64, False),
    (2, 9, 9, 2, 64, True),
    (2, 5, 13, 2, 128, False),
    (2, 10, 10, 1, 128, True),
]


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", CASES)
def test_plain_matches_jax_attend(B, Tq, Tk, H, D, causal):
    q, k, v, valid = _inputs(B, Tq, Tk, H, D, seed=Tq + D)
    bias = _causal_bias(Tq) if causal else _padding_bias(valid)
    want = _jax(q, k, v, bias)
    got = fa.flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)),
        None if causal else torch.from_numpy(valid), causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal", CASES)
def test_attend_flash_bias_rule_matches_jax(B, Tq, Tk, H, D, causal):
    """The port's ``_attend_flash`` takes the JAX package's biases: the
    causal triangle is replaced by the causal flag, a key-padding bias
    becomes the key-valid mask by ``bias > -1``."""
    q, k, v, valid = _inputs(B, Tq, Tk, H, D, seed=Tk + D)
    bias = _causal_bias(Tq) if causal else _padding_bias(valid)
    got = attention._attend_flash(*map(torch.from_numpy, (q, k, v)),
                                  torch.from_numpy(bias), causal)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, bias), rtol=1e-5,
                               atol=1e-6)


def test_broadcast_padding_bias_and_row_without_valid_key():
    """A (1, 1, 1, Tk) bias broadcasts over the batch; a row whose keys
    are all masked degrades as ``_attend`` does (uniform weights)."""
    q, k, v, valid = _inputs(2, 6, 8, 2, 64, seed=3)
    row = np.ones((1, 8), bool)
    row[0, 5:] = False
    bias = _padding_bias(row)
    got = attention._attend_flash(*map(torch.from_numpy, (q, k, v)),
                                  torch.from_numpy(bias), False)
    np.testing.assert_allclose(got.numpy(), _jax(q, k, v, bias), rtol=1e-5,
                               atol=1e-6)
    none = np.zeros((2, 8), bool)
    got = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   torch.from_numpy(none))
    want = _jax(q, k, v, _padding_bias(none))
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_other_bias_shapes_raise():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 6, 6, 2, 64, 0))
    for bias in (torch.zeros(1, 1, 6, 6), torch.zeros(2, 2, 1, 6)):
        with pytest.raises(ValueError, match="key-padding"):
            attention._attend_flash(q, k, v, bias, False)
    # under causal the bias is ignored, as in the JAX package
    out = attention._attend_flash(q, k, v, torch.zeros(1, 1, 6, 6), True)
    torch.testing.assert_close(out, fa.flash_attention_plain(q, k, v,
                                                             None, True))


def test_cpu_tensor_runs_plain_without_launch():
    q, k, v, valid = (torch.from_numpy(x)
                      for x in _inputs(2, 5, 7, 2, 64, seed=1))
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, valid, False)
    assert fa.LAUNCHES == before
    torch.testing.assert_close(got, fa.flash_attention_plain(q, k, v, valid),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="no flash attention kernel"):
        fa.flash_attention_cuda(q, k, v, valid)


def test_forward_only():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 4, 4, 1, 64, 2))
    q.requires_grad_()
    with pytest.raises(NotImplementedError, match="forward only"):
        fa._check(q, k, v, None)
    with torch.no_grad():
        fa._check(q, k, v, None)


def test_bf16_plain_rounds_once():
    """bf16 inputs: fp32 math on the exact upcast, one rounding of the
    output to bf16."""
    q, k, v, valid = (torch.from_numpy(x)
                      for x in _inputs(2, 6, 9, 2, 64, seed=4))
    qb, kb, vb = (x.bfloat16() for x in (q, k, v))
    got = fa.flash_attention_plain(qb, kb, vb, valid)
    assert got.dtype == torch.bfloat16
    want = fa.flash_attention_plain(qb.float(), kb.float(), vb.float(),
                                    valid)
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)
