"""The port's rel-pos flash attention (``ops/flash_relpos.py``, kernel B5's
plain version) against the JAX package's ``ops/flash_relpos.py`` with its
Pallas kernel in interpret mode: the fold (angles and augmented q~, k~),
the attention's context and lse, its backward under autograd against
``jax.vjp``, and ``RelPosSelfAttention`` on both of its paths with weights
carried by ``convert.py``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: fp32 rtol and atol 1e-5 (fp32 sums in another order). bf16:
the fold's products and sums are rounded to bf16 after each operation in
torch, where XLA may keep an fp32 intermediate in a fused expression, so
an element of q~ may differ by one bf16 rounding (2^-8 of its value); the
context then within 2^-7 of max(1, |value|), and lse within 1e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from openseq2seq_tpu.encoders import conformer_encoder as jce
from openseq2seq_tpu.ops import flash_relpos as jfr
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.encoders.conformer_encoder import \
    RelPosSelfAttention
from openseq2seq_tpu_torch.ops import flash_relpos as fr
from test_torch_text_data import one_thread  # noqa: F401

B, H, Dh, D = 3, 2, 16, 32
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(T, seed=0):
    rng = np.random.RandomState(seed)
    q_u, q_w, k, v = (rng.randn(B, T, H, Dh).astype(np.float32)
                      for _ in range(4))
    r_kernel = (rng.randn(D, H, Dh) / np.sqrt(D)).astype(np.float32)
    lengths = np.array([T, 1, 0], np.int32)
    return q_u, q_w, k, v, r_kernel, lengths


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(got - want) <=
                      2.0 ** -7 * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fold_matches_build_aug(dtype):
    jdt, tdt = DTYPES[dtype]
    T = 37
    q_u, q_w, k, _, r_kernel, _ = _inputs(T)
    si, ci, k_pos = jfr._angles(T, D)
    got_si, got_ci, got_kpos = fr.angles(T, D)
    for got, want in ((got_si, si), (got_ci, ci), (got_kpos, k_pos)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_q, want_k = jfr._build_aug(
        *(jnp.asarray(a, jdt) for a in (q_u, q_w, k)), jnp.asarray(r_kernel),
        si, ci, k_pos, 0)
    got_q, got_k = fr.build_aug(
        *(torch.from_numpy(a).to(tdt) for a in (q_u, q_w, k)),
        torch.from_numpy(r_kernel))
    assert got_q.shape == (B, H, T, Dh + D) and got_q.dtype == tdt
    np.testing.assert_array_equal(got_k.float().numpy(),
                                  np.asarray(want_k, np.float32))
    want_q = np.asarray(want_q, np.float32)
    tol = 1e-5 if dtype == "fp32" else 2.0 ** -8
    assert np.all(np.abs(got_q.float().numpy() - want_q) <=
                  tol * np.maximum(1.0, np.abs(want_q)))


@pytest.mark.parametrize("T", [20, 37])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_kernel(dtype, T):
    """Context and lse against ``_rel_fwd_res`` (the Pallas forward in
    interpret mode, T padded to its 128-row blocks there); lengths T, 1
    and 0 (clamped to 1)."""
    jdt, tdt = DTYPES[dtype]
    q_u, q_w, k, v, r_kernel, lengths = _inputs(T, seed=T)
    scale = Dh ** -0.5
    want, (_, want_lse, _) = jfr._rel_fwd_res(
        *(jnp.asarray(a, jdt) for a in (q_u, q_w, k, v)),
        jnp.asarray(r_kernel), jnp.asarray(lengths), scale, 128, 128, True)
    got, lse = fr.rel_flash_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q_u, q_w, k, v)),
        torch.from_numpy(r_kernel), torch.from_numpy(lengths), scale)
    assert got.shape == (B, T, H, Dh) and got.dtype == tdt
    _close(got, want, dtype)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(want_lse)[:, :, :T, 0],
        rtol=1e-5, atol=1e-5 if dtype == "fp32" else 1e-2)
    # the module-facing entry takes the same path on CPU tensors
    again = fr.rel_flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q_u, q_w, k, v)),
        torch.from_numpy(r_kernel), torch.from_numpy(lengths), scale)
    assert torch.equal(again, got)


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_module_matches_jax(flash, monkeypatch):
    """``RelPosSelfAttention`` on weights carried over by ``convert.py``
    (random u and w biases), fp32, on its plain path (reversed table and
    relative shift) and on its flash path (the Pallas kernel in interpret
    mode on the JAX side, the plain version of B5 on the port's)."""
    T, dim, heads = 13, 32, 2
    rng = np.random.RandomState(3)
    x = rng.randn(B, T, dim).astype(np.float32)
    lengths = np.array([T, 7, 1], np.int32)
    pad_mask = np.arange(T)[None, :] < lengths[:, None]
    jmod = jce.RelPosSelfAttention(num_heads=heads, dropout=0.0,
                                   use_flash=flash)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), x, pad_mask,
                                      False))["params"]
    params = dict(params, u_bias=rng.randn(heads, dim // heads)
                  .astype(np.float32),
                  w_bias=rng.randn(heads, dim // heads).astype(np.float32))
    monkeypatch.setattr(jfr, "FORCE_INTERPRET", flash)
    want = jmod.apply({"params": params}, x, pad_mask, False)

    port = nn.ModuleDict({"attn": RelPosSelfAttention(
        dim, heads, torch.float32, flash, torch.Generator().manual_seed(0))})
    port.load_state_dict(state_dict_from_flax({"params": {"attn": params}}))
    with torch.no_grad():
        got = port["attn"](torch.from_numpy(x), torch.from_numpy(lengths),
                           torch.from_numpy(pad_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_backward_matches_jax_vjp(dtype):
    """``rel_flash_attention`` under autograd on CPU tensors (the plain
    forward and backward) against ``jax.vjp`` of the JAX op with its Pallas
    kernels in interpret mode, all five gradients (dq_u, dq_w, dk, dv,
    dK_r), lengths T, 1 and 0 (clamped to 1). Each gradient within 1e-5 of
    its largest magnitude in fp32 (sums in another order); in bf16 within
    2^-8 of it, one rounding: both sides round p, ds and dq~ at the same
    points, but XLA may keep an fp32 intermediate in the fold's fused
    elementwise backward where torch rounds each operation."""
    jdt, tdt = DTYPES[dtype]
    T = 21
    q_u, q_w, k, v, r_kernel, lengths = _inputs(T, seed=7)
    g = np.random.RandomState(8).randn(B, T, H, Dh).astype(np.float32)
    scale = Dh ** -0.5
    want_out, vjp = jax.vjp(
        lambda *a: jfr.rel_flash_attention(*a, jnp.asarray(lengths), scale,
                                           128, 128, True),
        *(jnp.asarray(a, jdt) for a in (q_u, q_w, k, v)),
        jnp.asarray(r_kernel, jdt))
    want = vjp(jnp.asarray(g, jdt))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_()
              for a in (q_u, q_w, k, v, r_kernel)]
    out = fr.rel_flash_attention(*leaves, torch.from_numpy(lengths), scale)
    out.backward(torch.from_numpy(g).to(tdt))
    _close(out.detach(), want_out, dtype)
    tol = 1e-5 if dtype == "fp32" else 2.0 ** -8
    for name, leaf, w in zip(("dq_u", "dq_w", "dk", "dv", "dK_r"), leaves,
                             want):
        w = np.asarray(w, np.float32)
        assert leaf.grad.dtype == tdt and leaf.grad.shape == w.shape, name
        err = np.abs(leaf.grad.float().numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (name, err)


def _bf16_ulp(x):
    """One bf16 ulp of each value (8 significant bits)."""
    return 2.0 ** (torch.floor(torch.log2(x.abs().clamp(min=1e-30))) - 7)


def _two_block_case():
    """bf16 q~, k~ (B, H, T, Dh + D) built once by the port's ``build_aug``
    and v (B, H, T, Dh) at T = 200, two of the TPU kernel's 128-key
    blocks, with lengths 200, 150 and 0 (clamped to 1)."""
    T = 200
    q_u, q_w, k, v, r_kernel, _ = _inputs(T, seed=T)
    q_aug, k_aug = fr.build_aug(
        *(torch.from_numpy(a).bfloat16() for a in (q_u, q_w, k)),
        torch.from_numpy(r_kernel))
    v = torch.from_numpy(v).bfloat16().transpose(1, 2)
    return q_aug, k_aug, v, torch.tensor([T, 150, 0], dtype=torch.int32)


def test_rounding_matches_the_pallas_kernel_over_two_blocks():
    """The plain forward at T = 200 against ``_fwd`` (the Pallas forward in
    interpret mode, 128-query and 128-key blocks) on the same bf16 q~, k~
    and v, padded as ``_rel_fwd_res`` pads them (T to 256, Dh + D to 128
    lanes). The TPU kernel rounds p = exp(s - m) against the running
    maximum m after each 128-key block and divides by l at the end; so
    does the plain version. Tolerance: one bf16 ulp of each output plus
    its fp32 sums in another order (2 T 2^-24 of the sizes of its terms w
    v), with no room for a weight that rounds the other way: rounding
    against the row's final maximum instead fails it."""
    q_aug, k_aug, v, lengths = _two_block_case()
    B_, H_, T, dqk = q_aug.shape
    scale = Dh ** -0.5

    def padded(x, lanes):
        x = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.pad(x, ((0, 0), (0, 0), (0, 256 - T),
                           (0, -x.shape[-1] % lanes)))

    o, lse = jfr._fwd(padded(q_aug, 128), padded(k_aug, 128), padded(v, 1),
                      jnp.maximum(jnp.asarray(lengths.numpy()),
                                  1).reshape(-1, 1), scale, 128, 128, True)
    want = torch.from_numpy(np.array(o.astype(jnp.float32))[:, :, :T])
    got, got_lse = fr.flash_attention_plain(q_aug, k_aug, v, lengths, scale)
    assert got.dtype == torch.bfloat16
    s = fr._masked_scores(q_aug, k_aug, lengths, scale)
    w, l = fr.block_weights(s, torch.bfloat16)
    tol = _bf16_ulp(want) + 2 * T * 2.0 ** -24 * torch.einsum(
        "bhqk,bhkd->bhqd", w, v.float().abs()) / l
    assert torch.all((got.float() - want).abs() <= tol)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse)[:, :, :T, 0], rtol=1e-5,
                               atol=1e-5)
    # the whole-row rounding, p = exp(s - max over the row), differs
    p = torch.exp(s - s.amax(-1, keepdim=True))
    whole_row = (torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                              v.float()) / p.sum(-1, keepdim=True)
                 ).bfloat16()
    assert torch.any((whole_row.float() - want).abs() > tol)


def _bf16_case(T, lengths, seed):
    q_u, q_w, k, v, r_kernel, _ = _inputs(T, seed=seed)
    qu, qp, kk, kp = fr._operands(
        *(torch.from_numpy(a).bfloat16() for a in (q_u, q_w, k)),
        torch.from_numpy(r_kernel).bfloat16())
    return (qu, qp, kk, kp, torch.from_numpy(v).bfloat16(),
            torch.tensor(lengths, dtype=torch.int32), Dh ** -0.5)


def _reading(got, want, bound):
    err = (got.float() - want.float()).abs()
    return float(torch.where(err > 0, err / bound, 0.0).max())


def _zero_but_row_1(x):
    bad = x.clone()
    bad[:1] = 0
    bad[2:] = 0
    return bad


@pytest.mark.parametrize("T", [37, 200])
def test_bounds_hold_fp32_math_and_refuse_a_planted_fault(T):
    """``relpos_attention_bound`` and ``relpos_attention_bwd_bound``, the
    element-wise bounds the card holds the bf16 kernels to, against what
    they must take and what they must refuse: the plain versions' fp32
    math (no weight or ds rounded, half an ulp from the rounded ones) lies
    within them; the context or dv zeroed on every batch row but row 1
    (one valid key) lies far outside."""
    args = _bf16_case(T, [T, 1, T // 2], T + 1)
    o, lse = fr.relpos_attention_plain(*args)
    up = [x.float() for x in args[:5]] + list(args[5:])
    fp32_o, _ = fr.relpos_attention_plain(*up)
    bound = fr.relpos_attention_bound(*args)
    assert bound.shape == o.shape
    assert _reading(fp32_o, o, bound) <= 1.0
    do = torch.from_numpy(np.random.RandomState(T).randn(
        *o.shape).astype(np.float32)).bfloat16()
    bwd = args[:6] + (o, lse, do, args[6])
    grads = fr.relpos_attention_bwd_plain(*bwd)
    bounds = fr.relpos_attention_bwd_bound(*bwd)
    fp32_grads = fr.relpos_attention_bwd_plain(
        *up[:6], o.float(), lse, do.float(), args[6])
    for g, w, b in zip(fp32_grads, grads, bounds):
        assert b.shape == w.shape and _reading(g, w, b) <= 1.0
    assert _reading(_zero_but_row_1(o), o, bound) > 10
    assert _reading(_zero_but_row_1(grads[3]), grads[3], bounds[3]) > 10


def test_cuda_entry_refuses_cpu_tensors():
    q_u, q_w, k, v, r_kernel, lengths = _inputs(8)
    t = [torch.from_numpy(a) for a in (q_u, q_w, k, v, r_kernel, lengths)]
    qu, qp, kk, kp = fr._operands(*t[:3], t[4])
    before = fr.LAUNCHES, fr.BWD_DQ_LAUNCHES, fr.BWD_DKV_LAUNCHES
    with pytest.raises(ValueError, match="device cpu"):
        fr.relpos_attention_cuda(qu, qp, kk, kp, t[3], t[5], 0.25)
    o, lse = fr.relpos_attention_plain(qu, qp, kk, kp, t[3], t[5], 0.25)
    with pytest.raises(ValueError, match="device cpu"):
        fr.relpos_attention_bwd_cuda(qu, qp, kk, kp, t[3], t[5], o, lse, o,
                                     0.25)
    assert (fr.LAUNCHES, fr.BWD_DQ_LAUNCHES, fr.BWD_DKV_LAUNCHES) == before
