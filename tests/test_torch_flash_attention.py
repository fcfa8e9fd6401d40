"""The port's flash attention (kernel B7's plain version and the routing
around it) against the JAX package's attention on the CPU.

Off the TPU the JAX package attends through ``_attend`` (see
test_flash_attention.py), so ``flash_attention_plain`` and the port's
``_attend_flash`` (the bias rule of the JAX package's ``_attend_flash``)
are held against ``_attend`` with the same additive -1e9 masks: key
padding, causal, Tq != Tk, head dims 64 and 128, and a row with no valid
key. Tolerance: fp32, rtol 1e-5 and atol 1e-6. On a CPU tensor the op
runs the plain version and launches nothing; tests/test_torch_cuda.py
holds the kernel against the plain version on the card.

The rounding plain versions (``round_weights=True``, which the card holds
the bf16 kernels to) are held against the JAX package's ``_attend_flash``
itself, JAX's stock Pallas TPU kernel run in TPU interpret mode, forward
and ``jax.vjp``, on bf16 inputs (tolerances in the test); with the
argument off both plain versions stay the fp32 math above, bit for
bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.parts.transformer.attention import _attend as jax_attend
from openseq2seq_tpu_torch.ops import flash_attention as fa
from openseq2seq_tpu_torch.parts.transformer import attention
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_text_data import one_thread  # noqa: F401

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
    """Without a gradient to take the op is the forward alone (no graph,
    no lse); with one it is the autograd Function, and ``_check`` no
    longer refuses inputs that need a gradient."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 4, 4, 1, 64, 2))
    q.requires_grad_()
    fa._check(q, k, v, None)
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    torch.testing.assert_close(out.detach(), fa.flash_attention_plain(
        q.detach(), k, v), rtol=0, atol=0)


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


# -- the backward ---------------------------------------------------------

BWD_CASES = [  # B, Tq, Tk, H, D, causal, batch row 1 without a valid key
    (3, 7, 11, 2, 64, False, False),
    (2, 9, 9, 2, 64, True, False),
    (2, 5, 13, 2, 128, False, False),
    (2, 10, 10, 1, 128, True, False),
    (3, 6, 8, 2, 64, False, True),
]


def _bwd_case(B, Tq, Tk, H, D, causal, empty, seed):
    """The cotangent has scale 0.1: on a row with a single valid key (a
    causal row 0, a padded row of length 1) ds = p (dp - di) is an exact
    cancellation that di = rowsum(dO * O) leaves at rounding level, about
    1e-6 of the gradient's scale, which atol 1e-6 then covers."""
    q, k, v, valid = _inputs(B, Tq, Tk, H, D, seed)
    if empty:
        valid[1] = False
    do = 0.1 * np.random.RandomState(seed + 1).randn(B, Tq, H, D).astype(
        np.float32)
    kv = None if causal else valid
    bias = _causal_bias(Tq) if causal else _padding_bias(valid)
    return q, k, v, do, kv, bias


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal,empty", BWD_CASES)
def test_backward_plain_matches_autograd_and_jax(B, Tq, Tk, H, D, causal,
                                                 empty):
    """``flash_attention_bwd_plain`` from the forward's lse against torch
    autograd of ``flash_attention_plain`` and against ``jax.vjp`` of the
    JAX package's ``_attend`` with the bias built from the mask."""
    import jax
    q, k, v, do, kv, bias = _bwd_case(B, Tq, Tk, H, D, causal, empty,
                                      seed=Tq + Tk + D)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    tkv = None if kv is None else torch.from_numpy(kv)
    out, lse = fa.flash_attention_plain(tq, tk, tv, tkv, causal,
                                        return_lse=True)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, tkv,
                                       causal)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    fa.flash_attention_plain(*leaves, tkv, causal).backward(tdo)
    _, vjp = jax.vjp(lambda a, b, c: jax_attend(
        a, b, c, jnp.asarray(bias), 0.0, False, jnp.float32, lambda w: w),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for g, leaf, w in zip(got, leaves, want):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    if empty:
        assert np.all(np.isfinite(got[0].numpy())) and \
            np.any(got[2].numpy()[1] != 0)


@pytest.mark.parametrize("B,Tq,Tk,H,D,causal,empty", BWD_CASES)
def test_lse_is_the_logsumexp_of_the_masked_scores(B, Tq, Tk, H, D, causal,
                                                   empty):
    """On a row with a valid key lse is the log-sum-exp of the scaled
    scores plus the -1e9 mask. On a row without one every score rounds to
    -1e9 in fp32, the weights are uniform, and lse is log(Tk) taken
    relative to the mask value (fp32 cannot add log(Tk) to -1e9)."""
    q, k, _, _, kv, bias = _bwd_case(B, Tq, Tk, H, D, causal, empty, seed=5)
    _, lse = fa.flash_attention_plain(
        *map(torch.from_numpy, (q, k, k)),
        None if kv is None else torch.from_numpy(kv), causal,
        return_lse=True)
    scores = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                       k.astype(np.float64)) * D ** -0.5 + bias
    m = scores.max(-1, keepdims=True)
    want = (m + np.log(np.exp(scores - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (B, H, Tq) and lse.dtype == torch.float32
    has_key = m[..., 0] > NEG_INF / 2
    np.testing.assert_allclose(lse.numpy()[has_key], want[has_key],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy()[~has_key], np.log(Tk),
                               rtol=1e-5, atol=1e-6)
    assert has_key.all() != empty


def test_autograd_on_cpu_runs_the_plain_backward_without_launch():
    q, k, v, do, kv, _ = _bwd_case(2, 6, 9, 2, 64, False, False, seed=8)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(kv))
    out.backward(torch.from_numpy(do))
    assert (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == before
    plain, lse = fa.flash_attention_plain(*(x.detach() for x in (tq, tk, tv)),
                                          torch.from_numpy(kv),
                                          return_lse=True)
    want = fa.flash_attention_bwd_plain(
        *(x.detach() for x in (tq, tk, tv)), plain, lse,
        torch.from_numpy(do), torch.from_numpy(kv))
    for leaf, w in zip((tq, tk, tv), want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no flash attention kernel"):
        fa.flash_attention_bwd_cuda(tq, tk, tv, plain, lse,
                                    torch.from_numpy(do))


# -- the rounding plain versions against JAX's stock TPU kernel -----------

STOCK_CASES = [  # Tq, Tk, causal; B=2, H=2, D=64; key padding unless causal
    (63, 63, False),
    (63, 63, True),
    (63, 64, False),
]


def _bf16_ulp(x):
    """One bf16 ulp of each value (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _stock_case(Tq, Tk, causal):
    """bf16 q, k, dO ~ N(0, 1) and v ~ U(-1, 1) from numpy, and for key
    padding a (B, Tk) mask with batch row 1 of length 20 and its additive
    bias for the JAX package."""
    rng = np.random.RandomState(Tq + Tk + causal)
    q, k, do = (torch.from_numpy(rng.randn(2, T, 2, 64).astype(
        np.float32)).bfloat16() for T in (Tq, Tk, Tq))
    v = torch.from_numpy(rng.uniform(-1, 1, (2, Tk, 2, 64)).astype(
        np.float32)).bfloat16()
    if causal:
        return q, k, v, do, None, None
    valid = np.arange(Tk)[None, :] < np.array([Tk, 20])[:, None]
    return q, k, v, do, torch.from_numpy(valid), _padding_bias(valid)


@pytest.mark.parametrize("Tq,Tk,causal", STOCK_CASES)
def test_rounding_plain_matches_the_stock_tpu_kernel(Tq, Tk, causal):
    """``round_weights=True`` against the JAX package's ``_attend_flash``,
    which runs JAX's stock Pallas TPU flash attention (here in TPU
    interpret mode), and ``jax.vjp`` of it, on the same bf16 inputs; the
    port's backward takes its own forward's output and lse. At these
    shapes the stock kernel holds each row's keys in one block: it rounds
    p / l for P.V, and p^T, ds^T and ds for the backward's products, all
    sums in fp32. Tolerance: the output within one bf16 ulp of each value
    (both round the same fp32 math once, sums in another order); each
    gradient within one bf16 ulp plus 2^-10 of its largest magnitude, for
    a p or ds that rounds the other way (the stock kernel recomputes p as
    exp(s - m) / l, the port as exp(s - lse)), and each gradient within
    ``flash_attention_bwd_bound``, the bound the card holds the bf16
    kernels to."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from openseq2seq_tpu.parts.transformer.attention import (
        _attend_flash as jax_attend_flash)
    q, k, v, do, valid, bias = _stock_case(Tq, Tk, causal)

    def jx(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a, b, c: jax_attend_flash(
            a, b, c, None if bias is None else jnp.asarray(bias), causal,
            jnp.bfloat16), jx(q), jx(k), jx(v))
        want_grads = vjp(jx(do))
    out, lse = fa.flash_attention_plain(q, k, v, valid, causal,
                                        return_lse=True, round_weights=True)
    grads = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, valid,
                                         causal, round_weights=True)
    assert out.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    assert np.all(np.abs(out.float().numpy() - w) <= _bf16_ulp(w))
    bounds = fa.flash_attention_bwd_bound(q, k, v, out, lse, do, valid,
                                          causal)
    for g, w, bound in zip(grads, want_grads, bounds):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        assert np.all(np.abs(g.float().numpy() - w) <=
                      _bf16_ulp(w) + 2.0 ** -10 * np.abs(w).max())
        assert np.all(np.abs(g.float().numpy() - w) <= bound.numpy())


def _one_rounding_tolerance(q, k, v, valid, want):
    """One bf16 ulp of each output plus its fp32 sums in another order,
    2 Tk 2^-24 of the sizes of its terms w v: no room for a weight that
    rounds the other way."""
    logits, _ = fa._scores(q, k, valid, False, q.shape[-1] ** -0.5)
    w, l = fa.block_weights(logits, torch.bfloat16)
    terms = torch.einsum("bhqk,bkhd->bqhd", w, v.float().abs()) / \
        l.transpose(1, 2)
    return torch.from_numpy(_bf16_ulp(want.numpy())) + \
        2 * k.shape[1] * 2.0 ** -24 * terms


def _past_one_tile_case(Tq, Tk):
    """The rounding plain version and the JAX package's ``_attend_flash``
    (the stock kernel in TPU interpret mode) on one key-padding case: the
    port's output, lse and gradients on the stock output, the stock
    output and gradients, and the inputs."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    from openseq2seq_tpu.parts.transformer.attention import (
        _attend_flash as jax_attend_flash)
    q, k, v, do, valid, bias = _stock_case(Tq, Tk, False)

    def jx(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(lambda a, b, c: jax_attend_flash(
            a, b, c, jnp.asarray(bias), False, jnp.bfloat16), jx(q), jx(k),
            jx(v))
        want_grads = vjp(jx(do))
    out, lse = fa.flash_attention_plain(q, k, v, valid, False,
                                        return_lse=True, round_weights=True)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    stock_o = want.bfloat16()
    grads = fa.flash_attention_bwd_plain(q, k, v, stock_o, lse, do, valid,
                                         False, round_weights=True)
    bounds = fa.flash_attention_bwd_bound(q, k, v, stock_o, lse, do, valid,
                                          False)
    assert torch.all((out.float() - want).abs() <=
                     _one_rounding_tolerance(q, k, v, valid, want))
    for g, w, bound in zip(grads, want_grads, bounds):
        w = torch.from_numpy(np.asarray(w.astype(jnp.float32)))
        assert torch.all((g.float() - w).abs() <= bound)


def test_rounding_plain_past_one_key_tile_matches_the_stock_kernel():
    """Past the kernel's 64-key tile, up to ``ROUND_BLOCK`` (128) keys,
    the stock kernel still takes its single step, o = round(p / l) v, and
    so does the rounding plain version: the output within one bf16 ulp
    plus fp32 sums in another order, with no room for a weight that
    rounds the other way. The backward takes the stock forward's output
    (the gradients recompute p from lse, as the kernels do; a p that
    rounds the other way from exp(s - m) / l is the bound's to cover): on
    the same o they stay within ``flash_attention_bwd_bound``."""
    assert 64 < 100 <= fa.ROUND_BLOCK
    _past_one_tile_case(63, 100)


def test_rounding_plain_past_one_block_matches_the_stock_kernel():
    """Past ``ROUND_BLOCK`` keys (200, two blocks) the stock kernel's
    multi-step variant rounds p = exp(s - m) against the running maximum
    of its 128-key blocks and scales by 1 / l, and so does the rounding
    plain version: the tolerances of the 100-key case."""
    assert 200 > fa.ROUND_BLOCK
    _past_one_tile_case(63, 200)


def test_bounds_hold_fp32_math_and_refuse_a_planted_fault():
    """The bf16 bounds against what they must take and what they must
    refuse: the plain versions' fp32 math (the weights and ds unrounded,
    half an ulp from the rounded ones) lies within them; an output or a
    dv zeroed on every batch row but the one with a single valid key (whose
    dv, the sum of dO over all queries, is the largest) lies far outside."""
    q, k, v, do, valid, _ = _stock_case(63, 64, False)
    out, lse = fa.flash_attention_plain(q, k, v, valid, return_lse=True,
                                        round_weights=True)
    bound = fa.flash_attention_bound(q, k, v, valid)
    assert torch.all((fa.flash_attention_plain(q, k, v, valid).float() -
                      out.float()).abs() <= bound)
    rounded = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, valid,
                                           round_weights=True)
    bounds = fa.flash_attention_bwd_bound(q, k, v, out, lse, do, valid)
    for g, w, b in zip(fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                    valid), rounded, bounds):
        assert torch.all((g.float() - w.float()).abs() <= b)
    valid[1, 1:] = False
    out, lse = fa.flash_attention_plain(q, k, v, valid, return_lse=True,
                                        round_weights=True)
    dv = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, valid,
                                      round_weights=True)[2]
    for bad, good, b in (
            (out.clone(), out, fa.flash_attention_bound(q, k, v, valid)),
            (dv.clone(), dv, fa.flash_attention_bwd_bound(
                q, k, v, out, lse, do, valid)[2])):
        bad[0] = 0
        assert torch.any((bad.float() - good.float()).abs() > 10 * b)


def test_rounding_off_is_the_fp32_plain_version():
    """Without ``round_weights`` both plain versions compute as before it
    existed, bit for bit: softmax and fp32 products, the scale applied
    after dq's and dk's sums."""
    q, k, v, do, valid, _ = _stock_case(63, 64, False)
    out, lse = fa.flash_attention_plain(q, k, v, valid, return_lse=True)
    logits, off = fa._scores(q, k, valid, False, 64 ** -0.5)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1),
                        v.float()).to(q.dtype)
    assert torch.equal(out, want)
    assert torch.equal(lse, torch.logsumexp(logits - off, dim=-1))
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, valid)
    p = torch.exp((logits - off) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    di = (do.float() * out.float()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - di)
    assert torch.equal(dv, torch.einsum("bhqk,bqhd->bkhd", p,
                                        do.float()).to(v.dtype))
    assert torch.equal(dq, (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) *
                            64 ** -0.5).to(q.dtype))
    assert torch.equal(dk, (torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) *
                            64 ** -0.5).to(k.dtype))
