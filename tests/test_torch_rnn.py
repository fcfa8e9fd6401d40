"""The port's recurrent layers against the JAX package's, on the same
converted weights: ``LSTM``, ``GRU`` and ``BiRNN``, forward and reverse
cells with varied lengths, on both paths (the scan with ``fused_rnn``
off; the fused path with it on, where the JAX side runs its Pallas
kernels in interpret mode and the port its kernels' plain versions).
Then the plain versions of the scan kernels against ``gru_scan`` and
``lstm_scan`` in interpret mode, residual outputs and last states
included, and the fused-path gate against ``supported``.

Sizes are the smallest the kernels take: B = 8, H = 128, T <= 37.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 (sums in another order). bf16
("mixed"): mean abs error 1e-3 and max abs error 3 bf16 ulps of 1
(3 * 2^-7): the frameworks round h to bf16 at the same places, but a sum
in another order can flip one rounding, and the recurrence carries it
(the layers' bf16 input projections also round apart). The plain kernel
versions against the Pallas kernels, which share their inputs: mean abs
error 1e-4, since only such a rare flip differs; a version that carried
h in fp32 (C14) is off by 1e-4 to 7e-4 on average."""
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
LENGTHS = np.array([37, 30, 13, 1, 37, 7, 22, 36], np.int32)
ATOL = RTOL = 1e-5
BF16_MEAN, BF16_MAX = 1e-3, 3 * 2.0 ** -7
BF16_KERNEL_MEAN = 1e-4

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(JAX_DTYPES[dtype])


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(TORCH_DTYPES[dtype])


def _close(got, want, dtype, bf16_mean=BF16_MEAN):
    got = np.asarray(got.float().detach().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        err = np.abs(got - want)
        assert err.mean() <= bf16_mean and err.max() <= BF16_MAX, (
            err.mean(), err.max())


def _random_biases(variables, seed):
    """Biases (zero at init) drawn at random, so a wrong mapping shows."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (0.3 * rng.randn(*v.shape)).astype(np.float32)
                if k in ("bias", "recurrent_bias") else np.asarray(v)
                for k, v in tree.items()}
    return {"params": walk(jax.tree_util.tree_map(
        np.asarray, dict(variables["params"])))}


def _pair(kind, reverse, dtype, fused, bidirectional=False):
    """(JAX module, its variables, the port's module on them)."""
    jdt, tdt = JAX_DTYPES[dtype], TORCH_DTYPES[dtype]
    if bidirectional:
        jmod = jax_rnn.BiRNN(H, cell_type="cudnn_" + kind, dtype=jdt)
        tmod = rnn.BiRNN(D, H, "cudnn_" + kind, dtype=tdt, fused=fused)
    else:
        jcls, tcls = {"lstm": (jax_rnn.LSTM, rnn.LSTM),
                      "gru": (jax_rnn.GRU, rnn.GRU)}[kind]
        jmod = jcls(H, reverse=reverse, dtype=jdt)
        tmod = tcls(D, H, reverse=reverse, dtype=tdt, fused=fused)
    x = jnp.zeros((B, T, D), jdt)
    variables = _random_biases(
        jmod.init(jax.random.PRNGKey(0), x, jnp.asarray(LENGTHS)), seed=1)
    tmod.load_state_dict(state_dict_from_flax(variables))
    return jmod, variables, tmod


def _run_both(kind, reverse, dtype, fused, bidirectional=False):
    jmod, variables, tmod = _pair(kind, reverse, dtype, fused, bidirectional)
    x = np.random.RandomState(2).randn(B, T, D).astype(np.float32)
    lengths = jnp.asarray(LENGTHS)
    # the fixtures put these globals back
    gru_pallas.FORCE_INTERPRET = lstm_pallas.FORCE_INTERPRET = fused
    with jax_rnn.fused_rnn_config(fused):
        want = jmod.apply(variables, _to_jax(x, dtype), lengths)
    with torch.no_grad():
        got = tmod(_to_torch(x, dtype), torch.from_numpy(LENGTHS))
    return got, want


@pytest.mark.parametrize("path", ["scan", "fused"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_cell_matches_jax_fp32(kind, reverse, path):
    (out, last), (jout, jlast) = _run_both(kind, reverse, "float32",
                                           path == "fused")
    _close(out, jout, "float32")
    for got, want in zip(jax.tree_util.tree_leaves(last),
                         jax.tree_util.tree_leaves(jlast)):
        _close(got, want, "float32")
    # zero past each length (the output mask)
    assert not out[3, 1:].any() and not out[5, 7:].any()


@pytest.mark.parametrize("path", ["scan", "fused"])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_cell_matches_jax_mixed(kind, path):
    """bf16 compute: each path against its JAX twin (the fused path adds
    x_proj + h W_h in fp32, the scan rounds it to bf16 first, C13)."""
    (out, last), (jout, jlast) = _run_both(kind, True, "bfloat16",
                                           path == "fused")
    assert out.dtype == torch.bfloat16
    _close(out, jout, "bfloat16")
    _close(jax.tree_util.tree_leaves(last)[0],
           jax.tree_util.tree_leaves(jlast)[0], "bfloat16")


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_birnn_matches_jax(kind):
    got, want = _run_both(kind, False, "float32", True, bidirectional=True)
    assert got.shape == (B, T, 2 * H)
    _close(got, want, "float32")


def _scan_inputs(kind, dtype, seed=3):
    G = 4 if kind == "lstm" else 3
    rng = np.random.RandomState(seed)
    return {"x_proj": rng.randn(B, T, G * H).astype(np.float32),
            "wh": (rng.randn(H, G * H) / np.sqrt(H)).astype(np.float32),
            "bh": (0.3 * rng.randn(G * H)).astype(np.float32),
            "h0": (0.5 * rng.randn(B, H)).astype(np.float32),
            "c0": rng.randn(B, H).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_plain_kernel_matches_pallas_interpret(kind, reverse, dtype):
    """The port's plain kernel versions against the Pallas kernels run in
    interpret mode: ys (masked, as the JAX layer masks them), the last
    states and the residuals. The JAX kernel walks reverse cells over the
    flipped input with the suffix mask; its residuals are in that flipped
    order."""
    a = _scan_inputs(kind, dtype)
    flip = (lambda v: jnp.flip(v, axis=1)) if reverse else (lambda v: v)
    xp = flip(_to_jax(a["x_proj"], dtype))
    lengths = jnp.asarray(LENGTHS)
    h0 = _to_jax(a["h0"], dtype)
    if kind == "lstm":
        (ys, last), res = lstm_pallas._lstm_fwd_res(
            xp, jnp.asarray(a["wh"]), h0, jnp.asarray(a["c0"]), lengths, 1.0,
            True, reverse)
        want_res = (res[1], res[2])                  # acts, cs (T, B, .)
        got_ys, got_last, got_res = lstm_scan.lstm_scan_plain(
            _to_torch(a["x_proj"], dtype), torch.from_numpy(a["wh"]),
            _to_torch(a["h0"], dtype), torch.from_numpy(a["c0"]),
            torch.from_numpy(LENGTHS), 1.0, reverse, residuals=True)
    else:
        (ys, last), res = gru_pallas._gru_fwd_res(
            xp, jnp.asarray(a["wh"]), jnp.asarray(a["bh"]), h0, lengths,
            True, reverse)
        want_res = (res[1], res[2])                  # acts, hn (T, B, .)
        last = (last,)
        got_ys, got_last, got_res = gru_scan.gru_scan_plain(
            _to_torch(a["x_proj"], dtype), torch.from_numpy(a["wh"]),
            torch.from_numpy(a["bh"]), _to_torch(a["h0"], dtype),
            torch.from_numpy(LENGTHS), reverse, residuals=True)
        got_last = (got_last,)
    mask = (np.arange(T)[None, :] < LENGTHS[:, None])[:, :, None]
    _close(got_ys, np.asarray(flip(ys), np.float32) * mask, dtype,
           BF16_KERNEL_MEAN)
    for got, want in zip(got_last, last):
        _close(got, want, dtype, BF16_KERNEL_MEAN)
    for got, want in zip(got_res, want_res):
        want = np.moveaxis(np.asarray(want, np.float32), 0, 1)
        _close(got, want[:, ::-1] if reverse else want, dtype,
               BF16_KERNEL_MEAN)
    assert got_res[0].dtype == TORCH_DTYPES[dtype]


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_supported_is_the_jax_gate(kind):
    port, jax_kernel = {"lstm": (lstm_scan, lstm_pallas),
                        "gru": (gru_scan, gru_pallas)}[kind]
    for b in (4, 8, 12, 16, 32, 48, 64, 256):
        for h in (64, 128, 384, 512, 800, 1024, 1152, 1280, 1408):
            assert port.supported(b, 100, h, torch.bfloat16) == \
                jax_kernel.supported(b, 100, h, interpret=True), (b, h)
    # DeepSpeech2-medium takes the kernel, DeepSpeech2-large (H = 800) not
    assert port.supported(32, 500, 1024, torch.bfloat16) and \
        not port.supported(32, 500, 800, torch.bfloat16)


def test_cpu_wrapper_runs_the_plain_version_with_gradients():
    a = _scan_inputs("gru", "float32")
    x = torch.from_numpy(a["x_proj"]).requires_grad_()
    args = (torch.from_numpy(a["wh"]), torch.from_numpy(a["bh"]),
            torch.from_numpy(a["h0"]), torch.from_numpy(LENGTHS))
    before = gru_scan.LAUNCHES, lstm_scan.LAUNCHES
    ys, h_last = gru_scan.gru_scan(x, *args, reverse=True)
    want_ys, want_h = gru_scan.gru_scan_plain(x, *args, reverse=True)
    assert torch.equal(ys, want_ys) and torch.equal(h_last, want_h)
    ys.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert not x.grad[3, 1:].any()       # frames past the length: no effect
    b = _scan_inputs("lstm", "float32")
    ys, (h, c) = lstm_scan.lstm_scan(
        torch.from_numpy(b["x_proj"]), torch.from_numpy(b["wh"]),
        torch.from_numpy(b["h0"]), torch.from_numpy(b["c0"]),
        torch.from_numpy(LENGTHS))
    assert c.dtype == torch.float32 and ys.shape == (B, T, H)
    assert (gru_scan.LAUNCHES, lstm_scan.LAUNCHES) == before


def test_make_rnn_maps_the_recipes_types():
    assert isinstance(rnn.make_rnn("cudnn_gru", D, H, True, torch.float32),
                      rnn.GRU)
    assert isinstance(rnn.make_rnn("layernorm_lstm", D, H, True,
                                   torch.float32), rnn.LSTM)
    bi = rnn.make_rnn("cudnn_lstm", D, H, False, torch.float32)
    assert isinstance(bi.fw, rnn.LSTM) and bi.bw.reverse
    with pytest.raises(ValueError, match="rnn type"):
        rnn.make_rnn("rnn_tanh", D, H, True, torch.float32)
    # the LM cells are built (their numbers are held in
    # test_torch_lm_cells.py); the causal TCN is held against flax's
    # CAUSAL conv in test_torch_centaur.py
    assert isinstance(rnn.GLSTM(D, 2 * H, num_groups=2).group2, rnn.LSTM)
    for cell in (rnn.SLSTM(D, H), rnn.FLSTM(D, H, 4),
                 rnn.LayerNormLSTM(D, H)):
        assert sum(p.numel() for p in cell.parameters()) > 0
    tcn = rnn.TemporalConvolutionalLayer(D, H, 3, dilation=2)
    assert tcn.conv.weight.shape == (H, D, 3)
    assert tcn(torch.zeros(2, 7, D)).shape == (2, 7, H)
