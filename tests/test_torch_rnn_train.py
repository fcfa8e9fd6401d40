"""The gradients of the port's fused recurrences against the JAX
package's, on the CPU: the plain backward versions of the scan kernels
(``gru_scan_bwd_plain``, ``lstm_scan_bwd_plain``, reached through the
autograd Functions of ``gru_scan`` and ``lstm_scan``) against ``jax.vjp``
of the Pallas kernels in interpret mode, then the layers' gradients
against ``jax.grad`` of the JAX layers.

The two faults the port's backward avoids are held here:

* C15 (a reference fault): the Pallas LSTM backward takes the cell state
  before a reverse row's first valid step from the unmasked ``cs`` of the
  padded step beside it (``lstm_pallas.py:190-192``), which is not the
  carried c0 once the input projection has a bias. A reverse LSTM is
  therefore held against ``jax.grad`` of the JAX scan path, and the test
  asserts that the Pallas VJP differs from the scan there.
* C16: the port's ys is 0 past each length, so a backward that read the
  state before a reverse row's first valid step from ys would get 0, not
  h0. The reverse cells run with a non-zero initial state.

The cotangent of ys past each length must be dropped (ys is the constant
0 there): every case draws it non-zero everywhere.

Sizes: B = 8, T = 37, H = 128 (the smallest the kernels take), lengths
from 1 to T.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 (sums in another order). bf16,
the plain versions against the Pallas kernels on the same inputs: each
output within 3 bf16 ulps of max(1, |value|) (3 * 2^-7) and on average
within 1e-3 of it, as ``test_torch_rnn.py`` holds the forward: a sum in
another order can flip one rounding of the forward's carried h, the
recurrence carries it into the residuals, and the backward reads them
(measured: at most 3 ulps on dW_h, 2 on dx_proj, means under 1e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.ops import gru_pallas, lstm_pallas
from openseq2seq_tpu.parts.rnns import rnn as jax_rnn
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.ops import gru_scan, lstm_scan
from openseq2seq_tpu_torch.parts.rnns import rnn
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_text_data import one_thread  # noqa: F401

B, T, D, H = 8, 37, 16, 128
LENGTHS = np.array([37, 1, 19, 30, 5, 37, 12, 26], np.int32)
ATOL = RTOL = 1e-5
BF16_MAX, BF16_MEAN = 3 * 2.0 ** -7, 1e-3
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MASK = (np.arange(T)[None, :] < LENGTHS[:, None]).astype(np.float32)


def _close(got, want, dtype="float32"):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        return
    rel = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert rel.max() <= BF16_MAX and rel.mean() <= BF16_MEAN, (
        rel.max(), rel.mean())


def _inputs(kind, seed):
    """x_proj, W_h, b_h, h0, c0 and the cotangents of ys, h_last, c_last,
    as fp32 numpy arrays."""
    G = 4 if kind == "lstm" else 3
    rng = np.random.RandomState(seed)
    return {"x_proj": rng.randn(B, T, G * H).astype(np.float32),
            "wh": (rng.randn(H, G * H) / np.sqrt(H)).astype(np.float32),
            "bh": (0.3 * rng.randn(G * H)).astype(np.float32),
            "h0": (0.5 * rng.randn(B, H)).astype(np.float32),
            "c0": rng.randn(B, H).astype(np.float32),
            "dys": rng.randn(B, T, H).astype(np.float32),
            "dh": rng.randn(B, H).astype(np.float32),
            "dc": rng.randn(B, H).astype(np.float32)}


def _jax_vjp(kind, a, dtype, reverse):
    """Cotangents of (x_proj, W_h, b_h or c0, h0) through the Pallas
    kernel in interpret mode, with the layer's flips and output mask."""
    jdt = DTYPES[dtype][0]
    lengths = jnp.asarray(LENGTHS)
    flip = (lambda v: jnp.flip(v, axis=1)) if reverse else (lambda v: v)
    mask = jnp.asarray(MASK)[:, :, None]

    if kind == "gru":
        def f(xp, wh, bh, h0):
            ys, h = gru_pallas.gru_scan(flip(xp), wh, bh, h0, lengths, True,
                                        reverse)
            return flip(ys) * mask.astype(ys.dtype), h
        primals = (a["x_proj"], a["wh"], a["bh"], a["h0"])
        cot = (a["dys"], a["dh"])
    else:
        def f(xp, wh, c0, h0):
            ys, (h, c) = lstm_pallas.lstm_scan(flip(xp), wh, h0, c0, lengths,
                                               1.0, True, reverse)
            return flip(ys) * mask.astype(ys.dtype), (h, c)
        primals = (a["x_proj"], a["wh"], a["c0"], a["h0"])
        cot = (a["dys"], (a["dh"], a["dc"]))
    cast = [jnp.asarray(p).astype(jdt) if i in (0, 3) else jnp.asarray(p)
            for i, p in enumerate(primals)]
    out, vjp = jax.vjp(f, *cast)
    cot = jax.tree_util.tree_map(
        lambda c, o: jnp.asarray(c).astype(o.dtype), cot, out)
    return vjp(cot)


def _port_grads(kind, a, dtype, reverse, dys=None):
    """The same cotangents through the port's autograd Function (the
    plain versions on the CPU)."""
    tdt = DTYPES[dtype][1]
    keys = ("x_proj", "wh", "bh", "h0") if kind == "gru" else \
        ("x_proj", "wh", "c0", "h0")
    leaves = [torch.from_numpy(a[k]).to(tdt if k in ("x_proj", "h0")
                                        else torch.float32)
              .requires_grad_() for k in keys]
    lengths = torch.from_numpy(LENGTHS)
    dys = torch.from_numpy(a["dys"] if dys is None else dys).to(tdt)
    if kind == "gru":
        ys, h = gru_scan.gru_scan(leaves[0], leaves[1], leaves[2], leaves[3],
                                  lengths, reverse)
        outs, cots = (ys, h), (dys, torch.from_numpy(a["dh"]).to(tdt))
    else:
        ys, (h, c) = lstm_scan.lstm_scan(leaves[0], leaves[1], leaves[3],
                                         leaves[2], lengths, 1.0, reverse)
        outs = (ys, h, c)
        cots = (dys, torch.from_numpy(a["dh"]).to(tdt),
                torch.from_numpy(a["dc"]))
    return torch.autograd.grad(outs, leaves, cots)


@pytest.mark.parametrize("kind,reverse,dtype", [
    ("gru", False, "float32"), ("gru", False, "bfloat16"),
    ("gru", True, "float32"), ("gru", True, "bfloat16"),
    ("lstm", False, "float32"), ("lstm", False, "bfloat16")])
def test_plain_backward_matches_pallas_vjp(kind, reverse, dtype):
    """dx_proj, dW_h, db_h (GRU) or dc0 (LSTM), and dh0, with h0 and c0
    non-zero. The reverse LSTM is not here: its Pallas VJP is C15's."""
    a = _inputs(kind, seed=1 + reverse)
    want = _jax_vjp(kind, a, dtype, reverse)
    before = (gru_scan.BWD_LAUNCHES, lstm_scan.BWD_LAUNCHES)
    got = _port_grads(kind, a, dtype, reverse)
    assert (gru_scan.BWD_LAUNCHES, lstm_scan.BWD_LAUNCHES) == before
    assert got[0].dtype == DTYPES[dtype][1]
    for g, w in zip(got, want):
        _close(g, w, dtype)
    # frames past a row's length take no gradient
    assert not got[0][1, 1:].any() and not got[0][4, 5:].any()


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_cotangent_past_the_lengths_is_dropped(kind):
    a = _inputs(kind, seed=3)
    full = _port_grads(kind, a, "float32", True)
    masked = _port_grads(kind, a, "float32", True,
                         dys=a["dys"] * MASK[:, :, None])
    for g, m in zip(full, masked):
        assert torch.equal(g, m)


def _layer_pair(kind, bidirectional=False, bias_std=0.0):
    """(JAX layer, its variables, the port's fused layer on them); the
    input projection's bias drawn from N(0, bias_std^2)."""
    if bidirectional:
        jmod = jax_rnn.BiRNN(H, cell_type="cudnn_" + kind)
        tmod = rnn.BiRNN(D, H, "cudnn_" + kind, fused=True)
    else:
        jmod = {"lstm": jax_rnn.LSTM, "gru": jax_rnn.GRU}[kind](
            H, reverse=True)
        tmod = {"lstm": rnn.LSTM, "gru": rnn.GRU}[kind](D, H, reverse=True,
                                                        fused=True)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.zeros((B, T, D)),
                          jnp.asarray(LENGTHS))
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(np.asarray, dict(variables["params"]))
    for cell in ([params["fw"], params["bw"]] if bidirectional
                 else [params]):
        bias = cell["input_proj"]["bias"]
        cell["input_proj"]["bias"] = (bias_std * rng.randn(*bias.shape)
                                      ).astype(np.float32)
        if "recurrent_bias" in cell:
            cell["recurrent_bias"] = (0.3 * rng.randn(
                *cell["recurrent_bias"].shape)).astype(np.float32)
    variables = {"params": params}
    tmod.load_state_dict(state_dict_from_flax(variables))
    return jmod, variables, tmod


def _jax_layer_grads(jmod, variables, x, cot, initial, fused):
    """jax.grad of sum(out * cot) for the parameters, x and the initial
    state, on the scan (``fused`` False) or the Pallas kernels in
    interpret mode (the fixtures put the globals back)."""
    gru_pallas.FORCE_INTERPRET = lstm_pallas.FORCE_INTERPRET = fused
    lengths = jnp.asarray(LENGTHS)

    def loss(params, x, initial):
        args = (x, lengths) if initial is None else (x, lengths, initial)
        out = jmod.apply({"params": params}, *args)
        out = out[0] if isinstance(out, tuple) else out
        return jnp.sum(out * cot)

    with jax_rnn.fused_rnn_config(fused):
        return jax.grad(loss, argnums=(0, 1, 2))(variables["params"], x,
                                                 initial)


def _port_layer_grads(tmod, x, cot, initial):
    x = torch.from_numpy(x).requires_grad_()
    leaves = [x]
    init = None
    if initial is not None:
        init = tuple(torch.from_numpy(np.asarray(v)).requires_grad_()
                     for v in (initial if isinstance(initial, tuple)
                               else (initial,)))
        leaves += list(init)
        init = init if len(init) > 1 else init[0]
    tmod.zero_grad()
    out = tmod(x, torch.from_numpy(LENGTHS)) if init is None else \
        tmod(x, torch.from_numpy(LENGTHS), init)
    out = out[0] if isinstance(out, tuple) else out
    (out * torch.from_numpy(cot)).sum().backward()
    return {n: p.grad for n, p in tmod.named_parameters()}, \
        [v.grad for v in leaves]


def _assert_params_close(got, want_tree, prefix=""):
    for k, v in want_tree.items():
        if isinstance(v, dict):
            _assert_params_close(got, v, prefix + k + ".")
            continue
        name = prefix + {"kernel": "weight"}.get(k, k)
        g = got[name].numpy()
        w = np.asarray(v)
        _close(g.T if g.ndim == 2 and name.endswith("weight") else g, w)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_reverse_cell_gradients_match_the_jax_scan(kind):
    """A reverse cell with an input-projection bias from N(0, 0.5^2) and a
    non-zero initial state (C16), against jax.grad of the JAX scan path:
    the parameters', the input's and the initial state's gradients. For
    the LSTM the Pallas VJP differs from the scan there (C15); for the GRU
    it agrees."""
    jmod, variables, tmod = _layer_pair(kind, bias_std=0.5)
    rng = np.random.RandomState(5)
    x = (rng.randn(B, T, D) * MASK[:, :, None]).astype(np.float32)
    cot = rng.randn(B, T, H).astype(np.float32)
    h0 = (0.5 * rng.randn(B, H)).astype(np.float32)
    initial = (h0, rng.randn(B, H).astype(np.float32)) if kind == "lstm" \
        else h0
    want_p, want_x, want_init = _jax_layer_grads(
        jmod, variables, jnp.asarray(x), jnp.asarray(cot),
        jax.tree_util.tree_map(jnp.asarray, initial), False)
    got_p, got_leaves = _port_layer_grads(tmod, x, cot, initial)
    _assert_params_close(got_p, want_p)
    _close(got_leaves[0], want_x)
    for g, w in zip(got_leaves[1:], jax.tree_util.tree_leaves(want_init)):
        _close(g, w)
    _, pallas_x, _ = _jax_layer_grads(
        jmod, variables, jnp.asarray(x), jnp.asarray(cot),
        jax.tree_util.tree_map(jnp.asarray, initial), True)
    gap = float(np.abs(np.asarray(pallas_x) - np.asarray(want_x)).max())
    if kind == "lstm":
        assert gap > 1e-2, gap        # C15: the reference's Pallas VJP
    else:
        assert gap <= 1e-4, gap


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_birnn_gradients_match_jax_fused(kind):
    """BiRNN with ``fused_rnn`` on both sides, inputs zero past each
    length and a zero input-projection bias (as DS2 feeds it at init), so
    the Pallas LSTM's C15 does not show: the parameters' and the input's
    gradients; the discarded last states' cotangents arrive as None."""
    jmod, variables, tmod = _layer_pair(kind, bidirectional=True)
    rng = np.random.RandomState(6)
    x = (rng.randn(B, T, D) * MASK[:, :, None]).astype(np.float32)
    cot = rng.randn(B, T, 2 * H).astype(np.float32)
    want_p, want_x, _ = _jax_layer_grads(jmod, variables, jnp.asarray(x),
                                         jnp.asarray(cot), None, True)
    got_p, got_leaves = _port_layer_grads(tmod, x, cot, None)
    _assert_params_close(got_p, want_p)
    _close(got_leaves[0], want_x)
